"""Logical-axis sharding rules (MaxText-style), divisibility-aware.

The port of ``repro.sharding.rules``.  Every parameter, cache leaf and
activation is annotated with *logical* axis names; a rule table maps
logical names to mesh axes.  :func:`spec_for` drops a rule when the
concrete dimension is not divisible by the mesh axes' size (qwen2's 14
query heads on a 16-way ``model`` axis fall back to replication while
its d_ff = 4864 still shards), so one table serves every
(arch x shape x mesh) cell.

Default layout (production mesh (data=16, model=16), + pod for multi-pod):

    batch   -> ('pod', 'data')   data parallel over pods x data
    embed   -> 'data'            FSDP: params + optimizer state sharded
    heads/kv_heads/mlp/vocab/expert -> 'model'   Megatron TP / EP
    seq/state/layers -> replicated

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names``, or anything with a ``shape`` dict of axis sizes (the
reference's functions read only ``mesh.shape``; a stub serves the spec
tables).  :func:`spec_for` returns a :class:`PartitionSpec`, a tuple of
``None``, a mesh-axis name or a tuple of names, element for element the
reference's ``jax.sharding.PartitionSpec``.  :func:`placements_for` turns
a spec into DTensor placements, ``Shard(d)`` or ``Replicate()`` for each
mesh dimension.

**Block order of a dimension sharded over two axes.**  ``moe_ff ->
('model', 'data')`` splits the expert FFN dimension over both axes, in
that order: in JAX the block of device (data=i, model=j) is ``j * n_data +
i``.  Plain ``Shard`` placements split a dimension in the mesh's own
dimension order (``data`` first, then ``model`` within each ``data``
block), so that device holds block ``i * n_model + j``.  The port keeps
plain ``Shard``: every device's shard has the reference's shape and the
union of the shards is the same tensor, so memory, FLOPs and the
collectives' bytes are the reference's; only which device holds which
block differs, and nothing in the port depends on that.  The private
``_StridedShard`` placement would give JAX's order, at the cost of ops
that DTensor propagates for ``Shard`` only.

:func:`constrain` is ``jax.lax.with_sharding_constraint`` by logical
names: under :func:`axis_rules`, a DTensor is redistributed to the
placements of :func:`spec_for`; outside it, or for a plain tensor, it
returns its argument unchanged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]
Rules = Tuple[Tuple[str, MeshAxes], ...]

DEFAULT_RULES: Rules = (
    ("batch", ("pod", "data")),
    ("embed", "data"),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("mlp", "model"),
    ("vocab", "model"),
    ("expert", "model"),
    # the expert FFN hidden dim shards over model x data jointly: with few
    # experts (8) against wide axes (16) expert sharding is indivisible,
    # and sharding f keeps the parameters fully distributed
    ("moe_ff", ("model", "data")),
    ("conv", None),
    ("state", None),
    ("seq", None),
    ("kv_seq", None),
    ("layers", None),
    ("head_dim", None),
)

LONG_DECODE_RULES: Rules = DEFAULT_RULES


class PartitionSpec(tuple):
    """A tensor's mesh axes, one entry a dimension: ``None``
    (replicated), an axis name, or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (by its
    ``mesh_dim_names``) or of a stub with a ``shape`` dict."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise ValueError("a mesh needs axis names (mesh_dim_names)")
    return dict(zip(names, tuple(shape)))


def _lookup(rules: Rules, name: Optional[str]) -> MeshAxes:
    if name is None:
        return None
    for key, axes in rules:
        if key == name:
            return axes
    raise KeyError(f"no sharding rule for logical axis {name!r}")


def spec_for(shape: Sequence[int], names: Sequence[Optional[str]],
             mesh, rules: Rules = DEFAULT_RULES) -> PartitionSpec:
    """PartitionSpec for a concrete shape annotated with logical names.

    Rules whose mesh axes are absent from the mesh, already used by an
    earlier dimension, or do not divide the dimension size are dropped
    (replicated), never an error."""
    assert len(shape) == len(names), (shape, names)
    sizes = mesh_shape(mesh)
    used: set = set()
    out = []
    for dim, name in zip(shape, names):
        axes = _lookup(rules, name)
        if axes is None:
            out.append(None)
            continue
        axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
        axes_t = tuple(a for a in axes_t if a in sizes and a not in used)
        size = 1
        for a in axes_t:
            size *= sizes[a]
        if size <= 1 or dim % size != 0:
            out.append(None)
            continue
        used.update(axes_t)
        out.append(axes_t[0] if len(axes_t) == 1 else axes_t)
    return PartitionSpec(*out)


@dataclasses.dataclass(frozen=True)
class logical:
    """Logical annotation carried in spec trees: shape dims -> names."""

    names: Tuple[Optional[str], ...]

    def __init__(self, *names: Optional[str]):
        object.__setattr__(self, "names", tuple(names))


def _shape_of(x) -> tuple:
    """A leaf's shape: a tensor's, or a shape tuple itself."""
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def map_logical(fn, logical_tree, other):
    """``fn(lg, leaf)`` on each ``logical`` (or :class:`NamedSharding`)
    of ``logical_tree`` and the leaf in its place in ``other`` (a tensor
    or a shape tuple: shape tuples are leaves here, unlike in
    :mod:`repro_torch.tree`); ``None`` stays ``None``.  The result has
    ``logical_tree``'s structure."""
    if logical_tree is None:
        return None
    if isinstance(logical_tree, (logical, NamedSharding)):
        return fn(logical_tree, other)
    if isinstance(logical_tree, dict):
        return {k: map_logical(fn, v, other[k])
                for k, v in logical_tree.items()}
    kids = [map_logical(fn, a, b) for a, b in zip(logical_tree, other)]
    if hasattr(logical_tree, "_fields"):
        return type(logical_tree)(*kids)
    return type(logical_tree)(kids)


def tree_specs(logical_tree: Any, shape_tree: Any, mesh,
               rules: Rules = DEFAULT_RULES):
    """Map a tree of ``logical`` + a matching tree of shapes (tensors or
    shape tuples) to PartitionSpecs."""
    return map_logical(
        lambda lg, sd: spec_for(_shape_of(sd), lg.names, mesh, rules),
        logical_tree, shape_tree)


def placements_for(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh
    dimension, ``Shard(d)`` where tensor dimension ``d`` names that axis,
    else ``Replicate()`` (the block order of a dimension over two axes is
    the mesh's; see the module docstring)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_shape(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry,) if isinstance(entry, str) else entry:
            out[names.index(a)] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's place on a mesh: the mesh, its spec and the DTensor
    placements of that spec (the counterpart of
    ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, self.mesh)


def tree_shardings(logical_tree: Any, shape_tree: Any, mesh,
                   rules: Rules = DEFAULT_RULES):
    """A :class:`NamedSharding` for every leaf of ``logical_tree``."""
    return map_logical(
        lambda lg, sd: NamedSharding(
            mesh, spec_for(_shape_of(sd), lg.names, mesh, rules)),
        logical_tree, shape_tree)


def mesh_size(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor.  A plain tensor, the one-device path,
    is answered by its type alone: the models' DTensor branches cost it
    no import and no ``isinstance``."""
    if type(x) is torch.Tensor or x is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def place(x, sharding: NamedSharding):
    """``x`` (the same full tensor on every rank) on its sharding.

    On a one-device mesh every placement is ``Replicate``, and the leaf
    stays a plain tensor on the mesh's device: that computes exactly what
    a replicated sharding computes, without DTensor's dispatch on the
    host.  On a larger mesh
    each rank keeps its own shard of ``x``, cut locally, with no
    communication (``src_data_rank=None``), so the shards are ``x``'s
    bytes."""
    from torch.distributed.tensor import distribute_tensor
    mesh = sharding.mesh
    if is_dtensor(x):
        return x.redistribute(mesh, sharding.placements)
    dev = x.device if x.device.type == mesh.device_type \
        else _mesh_device(mesh)
    if mesh_size(mesh) == 1:
        return x.to(dev)
    return distribute_tensor(x.to(dev), mesh, sharding.placements,
                             src_data_rank=None)


def _mesh_device(mesh):
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def place_tree(tree, shardings):
    """:func:`place` on every leaf of ``tree`` with its sharding in
    ``shardings`` (same structure; ``None`` stays ``None``)."""
    return map_logical(lambda s, x: None if x is None else place(x, s),
                       shardings, tree)


def full(x):
    """A DTensor's full tensor (a collective: every rank calls it); any
    other tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def local_call(fn, mesh, in_placements, out_placements, *args,
               grad_placements=None):
    """``fn`` on each rank's shards: every DTensor in ``args`` is first
    redistributed to its entry of ``in_placements`` and handed to ``fn``
    as its local tensor (other arguments pass as they are); each tensor
    ``fn`` returns (one, or a tuple) comes back as a DTensor on its entry
    of ``out_placements``.  For functions that are independent over the
    sharded dimensions (batch rows, heads), where DTensor has no sharding
    rule for an op inside or mispropagates one; autograd runs through
    the redistributions.  ``grad_placements`` gives, argument by
    argument, where its gradient's local values lie when that differs
    from ``in_placements``: a weight replicated over a mesh dimension
    that shards the batch gets a ``Partial`` gradient there (each rank's
    rows contribute their share)."""
    from torch.distributed.tensor import DTensor
    grads = grad_placements or (None,) * len(args)
    loc = [a.redistribute(mesh, pl).to_local(grad_placements=g)
           if isinstance(a, DTensor) else a
           for a, pl, g in zip(args, in_placements, grads)]
    out = fn(*loc)
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o, mesh, pl, run_check=False)
                     for o, pl in zip(out, out_placements))
    return DTensor.from_local(out, mesh, out_placements, run_check=False)


class _Env:
    """The active rules, process-wide: autograd runs a CUDA backward (and
    the recompute of a checkpointed block in it) on threads of its own,
    which must see the rules the forward saw."""

    env = None


_CTX = _Env()


@contextlib.contextmanager
def axis_rules(mesh, rules: Rules = DEFAULT_RULES):
    """Context under which :func:`constrain` resolves logical names.

    The launchers and the dry-run run their steps in it; the one-device
    tests simply don't, making every ``constrain`` a no-op.  On a
    ``DeviceMesh`` it also lets plain tensors meet DTensors as replicated
    ones (``implicit_replication``): the positions, masks, RoPE tables and
    one-hots the models build are the same on every rank."""
    prev = _CTX.env
    _CTX.env = (mesh, rules)
    try:
        with contextlib.ExitStack() as stack:
            if hasattr(mesh, "mesh_dim_names"):
                from torch.distributed.tensor.experimental import \
                    implicit_replication
                stack.enter_context(implicit_replication())
            yield
    finally:
        _CTX.env = prev


def current_rules():
    return _CTX.env


def constrain(x, *names: Optional[str]):
    """Activation sharding constraint by logical names: ``x``
    redistributed to the placements of :func:`spec_for` under an active
    :func:`axis_rules`; ``x`` itself outside one or when it is not a
    DTensor (a plain tensor is the one-device path)."""
    env = current_rules()
    if env is None or not is_dtensor(x):
        return x
    mesh, rules = env
    want = placements_for(spec_for(x.shape, names, mesh, rules), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)
