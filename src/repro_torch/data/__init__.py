"""Data pipeline of the port (``repro.data``): the deterministic synthetic
token stream."""

from repro_torch.data.tokens import SyntheticTokens, to_device

__all__ = ["SyntheticTokens", "to_device"]
