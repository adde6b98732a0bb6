"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, n_experts=8, top_k=2,
    sliding_window=4096,
)


def smoke() -> ModelConfig:
    # capacity_factor 8 => no token drops at smoke sizes, so teacher-forced
    # and incremental decode agree exactly (capacity-drop MoE is otherwise
    # inconsistent between the two — DESIGN.md §5)
    return ModelConfig(
        name="mixtral-8x7b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, n_experts=4, top_k=2, sliding_window=64,
        capacity_factor=8.0,
    )
