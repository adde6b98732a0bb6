"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (GQA kv=1, MQA)
d_ff=7680 — RG-LRU + local attention, (rec, rec, attn) 1:2 pattern,
window 2048, vocab=256000.  [arXiv:2402.19427; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000,
    rglru_pattern=3, local_window=2048, rglru_width=2560,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=128, vocab=256,
        rglru_pattern=3, local_window=32, rglru_width=64,
        tie_embeddings=True,
    )
