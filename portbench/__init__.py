"""The benchmark of ``repro_torch`` on one CUDA card (``run.py``).

It measures the PyTorch and CUDA port only and imports nothing of JAX or
of the JAX package.  Every configuration, cell, solve driver, data
generator, kernel's work count and metric reader is a file of its own,
found by the name ``BENCHMARK.json`` or a cell file gives
(:mod:`portbench.spec`).
"""
