"""Carry a reference model's weights across.

:func:`params_from_numpy` takes the reference's parameter tree of any
family (``DenseParams``, ``MoEModelParams``, ``SSMParams``,
``GriffinParams``, ``EncDecParams``) with every leaf passed through
``np.asarray`` (stacked ``(L, ...)`` blocks, ``None`` for absent biases,
for the hybrid's tail when it has none and for the tied unembedding) and
returns the port's tree of the same name.  The port keeps the reference's
layouts, so each leaf is copied as it is; this is the one place where a
layout change would go.
"""

from __future__ import annotations

import functools
import typing

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.registry import get_module


@functools.lru_cache(maxsize=None)
def _subtrees(kind) -> dict:
    """The fields of the NamedTuple ``kind`` that hold a NamedTuple, each
    with its kind, from the field annotations.  A name can mean two kinds
    (the hybrid's triple has an ``attn`` attention block that has an
    ``attn`` of ``AttnParams``), so the lookup is by the parent's kind."""
    out = {}
    for name, hint in typing.get_type_hints(kind).items():
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        sub = args[0] if typing.get_origin(hint) is typing.Union else hint
        if isinstance(sub, type) and hasattr(sub, "_fields"):
            out[name] = sub
    return out


def _tree(tree, kind):
    """The reference's NamedTuple ``tree`` rebuilt as the port's ``kind``,
    field by field (by name, so no reference type is imported); a ``None``
    subtree stays ``None``."""
    subs = _subtrees(kind)
    fields = {}
    for name in kind._fields:
        value = getattr(tree, name)
        sub = subs.get(name)
        fields[name] = _tree(value, sub) if sub and value is not None \
            else value
    return kind(**fields)


def params_from_numpy(cfg, tree, *, device=None, dtype=None):
    """The port's parameters from a reference parameter tree of numpy
    arrays.  ``dtype`` defaults to each array's own; ``device`` defaults
    to the CUDA card and raises without one.  The leaves' shapes are
    checked against the family's ``param_shapes(cfg)``."""
    want = get_module(cfg).param_shapes(cfg)
    dev = resolve_device(device)

    def leaf(a):
        t = torch.from_numpy(np.array(a)).to(dev)
        return t if dtype is None else t.to(dtype)

    params = L.tree_map(leaf, _tree(tree, type(want)))
    got = L.tree_map(lambda t: tuple(t.shape), params)
    if got != want:
        raise ValueError(f"parameter shapes {got} do not match {cfg.name}'s "
                         f"{want}")
    return params
