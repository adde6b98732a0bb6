"""Read a ``torch.profiler`` window: device busy time, idle gaps by what
the host was doing, and device time and launches by kernel.

The raw events of the profiler's result are read once
(``prof.profiler.kineto_results.events()``), without building PyTorch's
event tree, which takes minutes at the millions of events of a traced
solve.  Device events are those on a CUDA device that are not user
annotations (the ``pb.*`` ranges mirrored onto the device timeline).
"""

from __future__ import annotations

import re
from types import SimpleNamespace

import torch

_IDENT = re.compile(r"(?:void )?([A-Za-z_][\w:]*)")
# the harness's own ranges (``harness.FIT``, ``harness.DECIDE``)
SPAN_PREFIX = "pb."


def kernel_name(name: str) -> str:
    """A device event's function name without namespaces, template
    arguments or parameters (``void repro::gram_kernel<double, true>(...)``
    is ``gram_kernel``); copies and fills keep their whole name, and an
    event without a name is ``unnamed``."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    m = _IDENT.match(name.replace("(anonymous namespace)::", ""))
    return m.group(1).rsplit("::", 1)[-1] if m else (name or "unnamed")


def is_kernel(short: str) -> bool:
    """Whether a device event (by :func:`kernel_name`) is a kernel, not a
    copy or a fill."""
    return not short.startswith(("Memcpy", "Memset"))


def read(prof) -> SimpleNamespace:
    """The window (from the first ``pb.*`` range's start to the last one's
    end on the host), its device busy seconds, per-kernel (count,
    seconds), the kernels launched and the idle gaps by host activity;
    ``None`` when the trace holds no range or no device event."""
    cuda = torch.autograd.DeviceType.CUDA
    names: dict = {}
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if e.is_user_annotation():
                continue
            name = e.name()
            short = names.get(name)
            if short is None:
                short = names[name] = kernel_name(name)
            start = e.start_ns()
            dev.append((start, start + e.duration_ns(), short))
        else:
            start = e.start_ns()
            host.append((start, start + e.duration_ns(), e.name(),
                         e.start_thread_id()))
    spans = [h for h in host if h[2].startswith(SPAN_PREFIX)]
    if not spans or not dev:
        return None
    w0 = min(h[0] for h in spans)
    w1 = max(h[1] for h in spans)
    main = spans[0][3]
    kernels = {}
    busy_ns, gaps, t = 0, [], w0
    for s, e, k in sorted(dev):
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        c, d = kernels.get(k, (0, 0))
        kernels[k] = (c + 1, d + (e - s))
        if s > t:
            gaps.append((t, s))
        if e > t:
            busy_ns += e - max(s, t)
            t = e
    if w1 > t:
        gaps.append((t, w1))
    return SimpleNamespace(
        window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
        kernels={k: (c, ns / 1e9) for k, (c, ns) in kernels.items()},
        kernel_launches=sum(c for k, (c, _) in kernels.items()
                            if is_kernel(k)),
        idle=_label_gaps(gaps, [h for h in host if h[3] == main]))


def _label_gaps(gaps, host):
    """{label: idle seconds}: each gap is put under the harness range and
    the innermost host event open at its middle (``pb.fit/aten::item``;
    ``python`` where no event was open, the interpreter between calls)."""
    evs = sorted(host, key=lambda h: (h[0], -h[1]))
    out, stack, i = {}, [], 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while i < len(evs) and evs[i][0] <= mid:
            e = evs[i]
            while stack and stack[-1][1] < e[0]:
                stack.pop()
            stack.append(e)
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        outer = next((h[2] for h in stack if h[2].startswith(SPAN_PREFIX)),
                     "outside")
        inner = stack[-1][2] if stack and stack[-1][2] != outer else "python"
        label = f"{outer}/{inner}"
        out[label] = out.get(label, 0) + (g1 - g0) / 1e9
    return out
