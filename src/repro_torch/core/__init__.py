"""Problem algebra, step algebra and the fused two-pass solver."""
