"""sklearn-style facades of the port."""

from repro_torch.svm.convert import svc_from_numpy
from repro_torch.svm.svc import SVC

__all__ = ["SVC", "svc_from_numpy"]
