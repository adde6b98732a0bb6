"""Launch tallies of the kernel wrappers, exact across host threads.

A wrapper counts its launches in its ``launches`` attribute, the tally of
the whole process, through :func:`count`.  The lane-sharded engine
(:mod:`repro_torch.core.sharded_lanes`) drives one host thread a device,
so several threads count at once: :func:`count` adds under :data:`LOCK`
(``+=`` on an attribute is a read and a write, which two threads can
interleave), and keeps the calling thread's own tally beside the shared
one (:func:`mine`).  A CUDA graph capture reads the launches of its chunk
from the capturing thread's tally, before and after: launches that
another thread made in that window are not the graph's
(:func:`repro_torch.core.solver_fused._capture`).
"""

from __future__ import annotations

import collections
import threading

LOCK = threading.Lock()
_LOCAL = threading.local()


def mine() -> collections.Counter:
    """The calling thread's launches by wrapper (never reset: a capture
    reads its difference)."""
    counts = getattr(_LOCAL, "counts", None)
    if counts is None:
        counts = _LOCAL.counts = collections.Counter()
    return counts


def count(wrapper, n: int = 1, attr: str = "launches") -> None:
    """Add ``n`` to ``wrapper``'s counter ``attr`` (``launches``, or the
    Gram's ``symmetric_launches``), and its launches to the calling
    thread's tally."""
    with LOCK:
        setattr(wrapper, attr, getattr(wrapper, attr) + n)
    if attr == "launches":
        mine()[wrapper] += n
