"""sklearn-style facades of the port."""

from repro_torch.svm.convert import (grid_from_numpy, oneclass_from_numpy,
                                     svc_from_numpy, svr_from_numpy)
from repro_torch.svm.model import (SVMModel, decision_function, predict,
                                   train_svm)
from repro_torch.svm.oneclass import OneClassSVM
from repro_torch.svm.svc import SVC
from repro_torch.svm.svr import SVR

__all__ = ["SVC", "SVR", "OneClassSVM", "SVMModel", "decision_function",
           "grid_from_numpy", "oneclass_from_numpy", "predict",
           "svc_from_numpy", "svr_from_numpy", "train_svm"]
