"""PyTorch/CUDA port of the planning-ahead SMO system.

A second package beside the JAX reference (``repro``), with the same
layout and names where the meaning matches.  It imports ``torch`` and
numpy and nothing of JAX or of the reference.  Its entry points run on the
CUDA card unless the caller passes ``device="cpu"``; there the kernels'
plain PyTorch versions run.
"""
