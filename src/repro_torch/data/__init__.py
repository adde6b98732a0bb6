"""Data pipeline of the port (``repro.data``): the deterministic synthetic
token stream."""

from repro_torch.data.tokens import SyntheticTokens, shard_batch, to_device

__all__ = ["SyntheticTokens", "shard_batch", "to_device"]
