"""whisper-tiny [audio]: 4L d_model=384 6H d_ff=1536 vocab=51865 —
enc-dec, conv frontend (stub: precomputed frame embeddings).
[arXiv:2212.04356; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865,
    encoder_layers=4, encoder_seq=1500, frontend="audio_stub",
    tie_embeddings=True, use_rope=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny-smoke", family="encdec",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256,
        encoder_layers=2, encoder_seq=64, frontend="audio_stub",
        tie_embeddings=True, use_rope=False,
    )
