"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT (stub patch embeddings) + InternLM2/qwen2-class LM
backbone.  [arXiv:2404.16821; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151655, qkv_bias=True,
    vision_tokens=256, frontend="vision_stub", tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b-smoke", family="vlm",
        n_layers=2, d_model=56, n_heads=7, n_kv_heads=1,
        d_ff=128, vocab=256, qkv_bias=True,
        vision_tokens=8, frontend="vision_stub", tie_embeddings=True,
    )
