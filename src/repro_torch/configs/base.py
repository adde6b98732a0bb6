"""Config dataclasses: model architecture, training and serving shapes.

A copy of ``repro.configs.base`` (plain dataclasses, no JAX).  One
``ModelConfig`` per assigned architecture lives in
``repro_torch/configs/<arch>.py`` with the exact public-literature
dimensions; each also exposes ``smoke()`` — a reduced same-family config
for CPU tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None       # default d_model // n_heads
    qkv_bias: bool = False               # qwen-style attention bias
    use_rope: bool = True                # whisper uses absolute sinusoidal
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25

    # attention locality
    sliding_window: int = 0              # 0 = full causal attention

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    ssm_chunk: int = 256

    # hybrid (recurrentgemma): (rec, rec, attn) repeating pattern
    rglru_pattern: int = 0               # 3 => 1 attention per 3 layers
    local_window: int = 2048
    rglru_width: Optional[int] = None    # recurrence width (default d_model)

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500              # precomputed frame embeddings (stub)

    # VLM
    vision_tokens: int = 0               # stub patch embeddings prepended

    # modality frontend stub
    frontend: str = "none"               # none | audio_stub | vision_stub

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (harness rule)."""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window > 0)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for rooflines."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads \
            + self.n_heads * hd * d
        mlp = 3 * d * f
        if self.family == "moe":
            mlp = mlp * self.n_experts + d * self.n_experts  # + router
        ssm = 0
        if self.family == "ssm":
            di = self.ssm_expand * d
            ssm = (d * 2 * di                # in_proj (x, z)
                   + di * 2 * self.ssm_state  # B, C proj
                   + di * self.conv_kernel + di  # conv + dt
                   + di * d)                 # out_proj
            attn = 0
            mlp = 0
        blocks = self.n_layers * (attn + mlp + ssm + 2 * d)
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "encdec":
            blocks += self.encoder_layers * (attn + mlp + 2 * d)
            blocks += self.n_layers * (attn + 2 * d)  # cross-attn
        return blocks + emb


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One harness input-shape cell."""

    name: str                        # train_4k | prefill_32k | ...
    kind: str                        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4_096, 256),
    ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    ShapeConfig("decode_32k", "decode", 32_768, 128),
    ShapeConfig("long_500k", "decode", 524_288, 1),
)


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-step configuration (the hillclimb knobs live here)."""

    seq_len: int = 4_096
    global_batch: int = 256
    microbatches: int = 1            # gradient accumulation steps
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    accum_dtype: str = "bfloat16"    # gradient accumulation buffer
    remat: str = "full"              # none | full | selective
    # "inside_grad": scan microbatches inside the differentiated loss, so
    # cross-data gradient reductions defer to one per step (§Perf grok
    # hillclimb); "outside": per-microbatch value_and_grad + manual
    # accumulation (baseline; reduces grads every microbatch).
    accum_mode: str = "inside_grad"
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    optimizer: str = "adamw"         # adamw | adafactor | sgdm
    compress_grads: bool = False     # int8 + error feedback all-reduce


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    seq_len: int = 32_768            # KV cache / state horizon
    batch: int = 128
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    kv_dtype: str = "bfloat16"
