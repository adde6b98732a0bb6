"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936 — GQA, QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
    d_ff=11008, vocab=151936, qkv_bias=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab=256, qkv_bias=True,
    )
