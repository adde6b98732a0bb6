"""Carry a reference model's weights across.

:func:`params_from_numpy` takes the reference's parameter tree of any
ported family (``DenseParams``, ``MoEModelParams``, ``SSMParams``) with
every leaf passed through ``np.asarray`` (stacked ``(L, ...)`` blocks,
``None`` for absent biases and for the tied unembedding) and returns the
port's tree of the same name.  The port keeps the reference's layouts, so
each leaf is copied as it is; this is the one place where a layout change
would go.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe, ssm
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_module

# each family's parameter tree: its kind and the kinds of its named
# subtrees
_DENSE = (T.DenseParams, {"blocks": T.BlockParams, "attn": L.AttnParams,
                          "mlp": L.MLPParams})
_KINDS = {
    "dense": _DENSE, "vlm": _DENSE,
    "moe": (moe.MoEModelParams, {"blocks": moe.MoEBlockParams,
                                 "attn": L.AttnParams, "moe": moe.MoEParams}),
    "ssm": (ssm.SSMParams, {"blocks": ssm.SSMBlockParams}),
}


def _tree(tree, kind, subs):
    """The reference's NamedTuple ``tree`` rebuilt as the port's ``kind``,
    field by field (by name, so no reference type is imported)."""
    fields = {}
    for name in kind._fields:
        value = getattr(tree, name)
        sub = subs.get(name)
        fields[name] = _tree(value, sub, subs) if sub is not None else value
    return kind(**fields)


def params_from_numpy(cfg, tree, *, device=None, dtype=None):
    """The port's parameters from a reference parameter tree of numpy
    arrays.  ``dtype`` defaults to each array's own; ``device`` defaults
    to the CUDA card and raises without one.  The leaves' shapes are
    checked against the family's ``param_shapes(cfg)``."""
    mod = get_module(cfg)
    dev = resolve_device(device)

    def leaf(a):
        t = torch.from_numpy(np.array(a)).to(dev)
        return t if dtype is None else t.to(dtype)

    params = L.tree_map(leaf, _tree(tree, *_KINDS[cfg.family]))
    got = L.tree_map(lambda t: tuple(t.shape), params)
    want = mod.param_shapes(cfg)
    if got != want:
        raise ValueError(f"parameter shapes {got} do not match {cfg.name}'s "
                         f"{want}")
    return params
