"""The plain reference that decides ``correct``.

Plain PyTorch in float64, in blocks of rows.  It imports nothing of the
program (``repro_torch``), of JAX or of the JAX package, and takes
nothing the program made: from the benchmark's inputs (the training and
held-out points, the labels or targets) and the configuration's
hyper-parameters it works out again each lane's QP, the kernel's width
(scikit-learn's ``gamma="scale"``), the kernel-matrix products, the
gradient, the KKT gap, the bias, the objective and the decision values.
The program's outputs are read only to be judged (:mod:`.judge`).
"""

from portbench.reference.judge import judge, judge_all  # noqa: F401
