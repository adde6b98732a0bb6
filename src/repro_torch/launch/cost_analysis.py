"""Per-device cost of a traced step: FLOPs, bytes, collectives.

The port's counterpart of ``repro.launch.hlo_analysis``.  PyTorch has no
HLO module to parse, so the count is taken at dispatch:
:class:`CostMode` is a ``TorchDispatchMode`` that records every aten op
run on *local* tensors.  An op on DTensors it hands on untouched
(``NotImplemented``), so DTensor runs it, its redistributions' collectives
and its ops on this rank's shards with the mode still active, and those
are what it counts: a count is per device, never the global op plus its
local share (which ``torch.utils.flop_counter.FlopCounterMode`` adds up
on DTensors).  DTensor's sharding propagation runs ops on fake tensors
of its own; under ``FakeTensorMode`` (the dry-run) the mode counts only
the fakes of the ``fake_mode`` it is given, and ignores every fake tensor
without one.

* ``flops``: ``torch.utils.flop_counter``'s formulas (matmuls,
  convolutions, SDPA forward and backward), applied to the local ops;
  matrix-vector and dot products (2 FLOPs a multiply-add) and SDPA's CPU
  kernel, which the library has no formula for, are added, the latter
  counted as its CUDA kernels are.
* ``bytes``: each op's operand and output bytes.  Views and other
  metadata ops move nothing and count nothing.  Eager PyTorch does not
  fuse elementwise chains, so this counts more traffic than the
  reference's count at HLO fusion boundaries does: an upper estimate of
  what a fused program would move.
* ``collective_bytes`` and ``collectives`` / ``collective_counts`` by the
  reference's five kinds (all-reduce, all-gather, reduce-scatter,
  all-to-all, collective-permute): the operand bytes of every
  ``_c10d_functional`` op (what DTensor's redistributions issue) and of
  every ``c10d`` op (what ``torch.distributed.all_reduce`` and friends
  issue, as ``core/sharded.py`` does).

``HloCost``'s ``loops`` (the trip counts of HLO while loops) has no
counterpart here: the port's layer and microbatch loops are Python loops,
so every trip is traced and counted, and the dry-run records the trips it
set up (``dryrun.loops``).

Use::

    with CostMode() as cm:
        step(...)
    cost = cm.cost          # a Cost
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# op name (the overload packet's last part) -> collective kind
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
    "permute_tensor": "collective-permute",
}

_FREE = {"wait_tensor", "detach", "alias", "lift_fresh", "empty",
         "empty_strided", "empty_like", "set_", "resize_"}


@dataclasses.dataclass
class Cost:
    """``repro.launch.hlo_analysis.HloCost``'s fields but ``loops``."""

    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    collective_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _tensor_bytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _flop_formulas():
    from torch.utils import flop_counter as fc
    reg = dict(fc.flop_registry)
    aten = torch.ops.aten
    # matrix-vector and vector products (the sharded solver's kernel rows)
    reg[aten.mv] = lambda a, v, *args, out_val=None, **kw: \
        2 * a.shape[0] * a.shape[1]
    reg[aten.dot] = lambda a, b, *args, out_val=None, **kw: 2 * a.shape[0]
    cpu_fwd = getattr(aten, "_scaled_dot_product_flash_attention_for_cpu",
                      None)
    if cpu_fwd is not None:
        def fwd(q, k, v, *args, out_val=None, **kw):
            return fc.sdpa_flop_count(q.shape, k.shape, v.shape)
        reg[cpu_fwd] = fwd
    cpu_bwd = getattr(
        aten, "_scaled_dot_product_flash_attention_for_cpu_backward", None)
    if cpu_bwd is not None:
        def bwd(grad_out, q, k, v, *args, out_val=None, **kw):
            return fc.sdpa_backward_flop_count(grad_out.shape, q.shape,
                                               k.shape, v.shape)
        reg[cpu_bwd] = bwd
    return reg


class CostMode(TorchDispatchMode):
    """Counts the per-device cost of the aten ops on local tensors (see
    the module docstring); ``cost`` holds the running :class:`Cost`."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.cost = Cost()
        self.fake_mode = fake_mode
        self._flops = _flop_formulas()

    def _counted(self, flat) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor
        return all(a.fake_mode is self.fake_mode for a in flat
                   if isinstance(a, FakeTensor))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        flat_in = tree_flatten((args, kwargs))[0]
        if any(isinstance(a, DTensor) for a in flat_in):
            return NotImplemented   # DTensor runs it on the shards, here
        out = func(*args, **kwargs)
        if not self._counted(flat_in):
            return out
        packet = func._overloadpacket
        name = packet.__name__
        kind = _COLLECTIVE_OPS.get(name)
        in_bytes = sum(_tensor_bytes(a) for a in flat_in)
        if kind is not None:
            self.cost.collectives[kind] += in_bytes
            self.cost.collective_counts[kind] += 1
            self.cost.collective_bytes += in_bytes
            return out
        if name in _FREE or func.is_view or packet.__name__.endswith("view"):
            return out
        if packet in self._flops:
            if func._overloadname.startswith("dtype"):
                # ``bmm.dtype(a, b, out_dtype)``: the formula takes shapes
                args = tuple(a for a in args if isinstance(a, torch.Tensor))
            self.cost.flops += float(
                self._flops[packet](*args, **kwargs, out_val=out))
        self.cost.bytes += in_bytes + sum(
            _tensor_bytes(o) for o in tree_flatten(out)[0])
        return out
