"""Host-tier telemetry: JSONL event sink, phase scopes, env fingerprint
(``repro.telemetry.sink``).

The device tier (:mod:`repro_torch.telemetry.ring`) samples iteration
dynamics inside the fused loop; this module is what happens on the host
around it:

* :func:`env_fingerprint`, the machine and runtime identity stamped into
  every telemetry artifact and benchmark record, so a change of runner
  can be told from a change of code;
* :class:`JsonlSink`, an append-only structured event stream (one JSON
  object per line) that also keeps the events in memory;
* :func:`phase_scope`, a wall-clock timer that emits a ``phase`` event,
  and a span of the active recorder (:mod:`repro_torch.telemetry.spans`)
  when one records.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import platform
import socket
import time

import numpy as np
import torch

from repro_torch.telemetry import spans

FINGERPRINT_KEYS = ("torch_version", "cuda_version", "backend",
                    "device_kind", "device_count", "cpu_count", "host")


def env_fingerprint() -> dict:
    """Runtime identity for telemetry artifacts and benchmark records.

    ``backend`` is ``"cuda"`` where a card is visible and ``"cpu"``
    otherwise; ``device_kind`` and ``device_count`` then describe the
    cards or the CPU.  The hostname is hashed: records are committed and
    shared, so the raw name stays out of them.  Never raises.
    """
    try:
        cuda = torch.cuda.is_available()
        if cuda:
            kind = torch.cuda.get_device_name(0)
            count = torch.cuda.device_count()
        else:
            kind = platform.processor() or platform.machine() or "cpu"
            count = 1
    except Exception:  # pragma: no cover - driver init failure
        cuda, kind, count = False, "unknown", 0
    host = hashlib.sha256(socket.gethostname().encode()).hexdigest()[:12]
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_kind": kind,
        "device_count": count,
        "cpu_count": os.cpu_count() or 0,
        "host": host,
        "python": platform.python_version(),
        "machine": platform.machine(),
    }


def fingerprint_diff(stored: dict | None, current: dict | None) -> list:
    """Human-readable stored-vs-current mismatch lines (empty = match)."""
    stored = stored or {}
    current = current or {}
    lines = []
    for k in FINGERPRINT_KEYS:
        a, b = stored.get(k), current.get(k)
        if a != b:
            lines.append(f"{k}: recorded={a!r} current={b!r}")
    return lines


def _to_plain(v):
    """JSON-safe coercion of tensors and numpy values (arrays to lists)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().tolist()
    if isinstance(v, (np.ndarray, np.generic)):
        return np.asarray(v).tolist()
    if isinstance(v, dict):
        return {k: _to_plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_to_plain(x) for x in v]
    return v


class JsonlSink:
    """Append-only JSONL event stream, mirrored in memory.

    ``path=None`` keeps the events in memory only (:attr:`events`).
    """

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = os.fspath(path) if path is not None else None
        self.events: list[dict] = []
        self._fh = open(self.path, "a") if self.path is not None else None

    def emit(self, event: str, **payload) -> dict:
        rec = {"event": event, "ts": time.time()}
        rec.update({k: _to_plain(v) for k, v in payload.items()})
        return self._append(rec)

    def emit_plain(self, event: str, payload: dict) -> dict:
        """:meth:`emit` without the coercion walk, for a payload that is
        JSON-safe already (the per-lane ring drain: ``tolist()`` output
        and Python scalars)."""
        rec = {"event": event, "ts": time.time()}
        rec.update(payload)
        return self._append(rec)

    def _append(self, rec: dict) -> dict:
        self.events.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@contextlib.contextmanager
def phase_scope(name: str, sink: JsonlSink | None = None, **meta):
    """Wall-clock scope around a solver phase.

    Emits a ``phase`` event with the host ``seconds`` on exit (nothing
    with ``sink=None``); while a recorder is active
    (:func:`repro_torch.telemetry.spans.active`) the phase is also one of
    its spans, and so a ``torch.profiler`` range.
    """
    rec = spans.active()
    t0 = time.perf_counter()
    with (spans._NULL if rec is None else rec.span(name)):
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if sink is not None:
                sink.emit("phase", name=name, seconds=dt, **meta)


def read_jsonl(path) -> list[dict]:
    """Load a JSONL artifact back into event dicts (blank lines skipped)."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
