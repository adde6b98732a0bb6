"""Bytes and operations that each of the port's kernel families needs for
one launch, and the least work a whole solve needs (``solve.py``).

One file a kernel family, each naming the device kernel it covers
(``KERNEL``, the function name in a profiler trace) and the launch
counters of ``repro_torch.kernels.WRAPPERS`` that count its launches
(``WRAPPERS``).  The arithmetic is a frozen copy of ``chip_smoke.py``'s
(its ``cases`` tables), so the shares it gives are those ``PERF.md``'s
kernel table holds.
"""
