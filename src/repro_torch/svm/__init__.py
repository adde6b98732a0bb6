"""sklearn-style facades of the port."""

from repro_torch.svm.convert import grid_from_numpy, svc_from_numpy
from repro_torch.svm.svc import SVC

__all__ = ["SVC", "grid_from_numpy", "svc_from_numpy"]
