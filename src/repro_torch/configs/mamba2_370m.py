"""mamba2-370m [ssm]: 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, conv_kernel=4,
    ssm_chunk=256, tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=256,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2, conv_kernel=4,
        ssm_chunk=32, tie_embeddings=True,
    )
