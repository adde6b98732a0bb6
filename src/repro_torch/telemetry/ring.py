"""Device-tier telemetry: bounded per-lane ring buffers for the fused loop
(``repro.telemetry.ring``).

The batched fused solver (:mod:`repro_torch.core.solver_fused`) advances
a whole grid of lanes in one loop and, without help, only final values
leave it.  :class:`TelemetryRing` holds small bounded per-lane buffers
carried through the loop state that sample the iteration dynamics:

* every ``sample_every`` iterations (and on the iteration a lane freezes):
  the KKT gap, the active-set size under shrinking and the running
  unshrink counter;
* on every *accepted* planning (or conjugate) step: the mu/mu* ratio, the
  classic engine's Fig. 3 ``record_trace`` channel for B lanes.

Overflow keeps the oldest samples: the write slot is ``min(count, cap -
1)``, so the first ``cap - 1`` samples stay verbatim and the last slot
holds the newest, while the count runs on past the cap (``n_samples >
cap`` shows the overflow).

On the card the loop body is replayed as a CUDA graph, which cannot
branch on the host, so a write is not skipped but masked: the loop
carries every buffer with one scratch column past its cap
(:func:`ring_buffers`), a lane that does not write aims at that column,
and each buffer takes one unconditional ``index_put_``.  The scratch
column never leaves :func:`ring_view`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class RingConfig:
    """Ring geometry (hashable).

    ``sample_every`` is the sampling period in loop iterations; ``cap``
    bounds the sampled channels and ``ratio_cap`` the planning-ratio event
    channel (both per lane).
    """

    sample_every: int = 64
    cap: int = 128
    ratio_cap: int = 128

    def __post_init__(self):
        assert self.sample_every >= 1
        assert self.cap >= 1 and self.ratio_cap >= 1


@dataclasses.dataclass(frozen=True)
class TelemetryRing:
    """Per-lane ring buffers (every field lane-leading).

    Sampled channels (written every ``sample_every`` iterations and on
    lane freeze): ``t`` (iteration stamp), ``gap`` (KKT gap),
    ``n_active`` (active-set size; the full width when shrinking is off),
    ``n_unshrink`` (running unshrink counter).  Event channel (written on
    accepted planning steps): ``ratio`` = mu/mu* with its ``ratio_t``
    stamp.  ``n_samples``/``n_ratio`` count every write and may exceed the
    caps.
    """

    t: torch.Tensor           # (B, cap) int32
    gap: torch.Tensor         # (B, cap) solver dtype
    n_active: torch.Tensor    # (B, cap) int32
    n_unshrink: torch.Tensor  # (B, cap) int32
    n_samples: torch.Tensor   # (B,) int32
    ratio: torch.Tensor       # (B, ratio_cap) solver dtype
    ratio_t: torch.Tensor     # (B, ratio_cap) int32
    n_ratio: torch.Tensor     # (B,) int32


FIELDS = tuple(f.name for f in dataclasses.fields(TelemetryRing))


class RingBuffers(NamedTuple):
    """The loop's form of a ring: the :class:`TelemetryRing` fields, each
    (B, cap + 1) buffer with its scratch column last."""

    t: torch.Tensor
    gap: torch.Tensor
    n_active: torch.Tensor
    n_unshrink: torch.Tensor
    n_samples: torch.Tensor
    ratio: torch.Tensor
    ratio_t: torch.Tensor
    n_ratio: torch.Tensor


def ring_init(cfg: RingConfig, B: int, dtype,
              device=None) -> TelemetryRing:
    """An empty ring of ``B`` lanes (values in ``dtype``, counters int32)."""
    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    i32 = torch.int32
    return TelemetryRing(
        t=z((B, cfg.cap), i32), gap=z((B, cfg.cap), dtype),
        n_active=z((B, cfg.cap), i32), n_unshrink=z((B, cfg.cap), i32),
        n_samples=z((B,), i32), ratio=z((B, cfg.ratio_cap), dtype),
        ratio_t=z((B, cfg.ratio_cap), i32), n_ratio=z((B,), i32))


def ring_buffers(ring: TelemetryRing) -> RingBuffers:
    """``ring`` with a scratch column appended to every (B, cap) buffer."""
    def pad(x):
        return (torch.cat([x, x.new_zeros((x.shape[0], 1))], dim=1)
                if x.ndim == 2 else x.clone())

    return RingBuffers(*(pad(getattr(ring, f)) for f in FIELDS))


def ring_view(bufs) -> TelemetryRing:
    """The :class:`TelemetryRing` of loop buffers (scratch columns cut)."""
    return TelemetryRing(*(x[:, :-1] if x.ndim == 2 else x for x in bufs))


def flat_bases(cfg: RingConfig, B: int, device) -> tuple:
    """Each lane's first flat index and its scratch column's flat index in
    the sampled and in the ratio buffers, for :func:`ring_write`."""
    lanes = torch.arange(B, device=device)
    base, rbase = lanes * (cfg.cap + 1), lanes * (cfg.ratio_cap + 1)
    return base, base + cfg.cap, rbase, rbase + cfg.ratio_cap


def ring_write(bufs: RingBuffers, cfg: RingConfig, *, t, active, newly_done,
               gap, n_active, n_unshrink, plan_event=None, ratio=None,
               bases=None) -> RingBuffers:
    """One in-loop telemetry step on the loop buffers, in place.

    ``t`` is the loop counter (a 0-d or (1,) int tensor on the device, or
    an int); every other argument is (B,).  ``active`` marks lanes live
    *entering* the iteration, ``newly_done`` lanes that froze on it (a
    forced sample, so the convergence point is always kept), ``plan_event``
    accepted planning steps.  Without ``plan_event`` the ratio channel is
    left as it is (no step of the run plans).  ``bases`` is what
    :func:`flat_bases` returns, which a loop computes once.  No value is
    read to the host: the writes are masked onto the scratch column.
    """
    B = bufs.n_samples.shape[0]
    device = bufs.n_samples.device
    base, scratch, rbase, rscratch = (flat_bases(cfg, B, device)
                                      if bases is None else bases)
    ti = torch.as_tensor(t, device=device).to(torch.int32).reshape(())
    write = active & ((ti % cfg.sample_every == 0) | newly_done)
    # the scratch column as a tensor: a Python scalar there would cost a
    # fill kernel an iteration
    flat = torch.where(write, base + bufs.n_samples.clamp_max(cfg.cap - 1),
                       scratch)
    for buf, val in ((bufs.t, ti.expand(B)), (bufs.gap, gap),
                     (bufs.n_active, n_active),
                     (bufs.n_unshrink, n_unshrink)):
        buf.view(-1).index_put_((flat,), val.to(buf.dtype))
    bufs.n_samples.add_(write)
    if plan_event is not None:
        ev = plan_event & active
        rflat = torch.where(
            ev, rbase + bufs.n_ratio.clamp_max(cfg.ratio_cap - 1), rscratch)
        bufs.ratio.view(-1).index_put_((rflat,), ratio.to(bufs.ratio.dtype))
        bufs.ratio_t.view(-1).index_put_((rflat,), ti.expand(B))
        bufs.n_ratio.add_(ev)
    return bufs


def ring_update(ring: TelemetryRing, cfg: RingConfig, *, t, active,
                newly_done, gap, n_active, n_unshrink, plan_event,
                ratio) -> TelemetryRing:
    """One telemetry step on a :class:`TelemetryRing` (a new ring; the
    argument is not changed), with the reference's semantics:
    ``write = active & ((t % sample_every == 0) | newly_done)``, the write
    slot ``min(count, cap - 1)``, the ratio channel on ``plan_event &
    active``.  The loop itself runs :func:`ring_write` on its buffers."""
    bufs = ring_write(ring_buffers(ring), cfg, t=t, active=active,
                      newly_done=newly_done, gap=gap, n_active=n_active,
                      n_unshrink=n_unshrink, plan_event=plan_event,
                      ratio=ratio)
    view = ring_view(bufs)
    return TelemetryRing(*(getattr(view, f).contiguous() for f in FIELDS))


def ring_slice(ring: TelemetryRing, idx) -> TelemetryRing:
    """Lane-subset view (every field is lane-leading)."""
    return TelemetryRing(*(getattr(ring, f)[idx] for f in FIELDS))
