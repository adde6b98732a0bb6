"""The port's ``engine="batched"`` facades (``SVC``, ``SVR``,
``OneClassSVM``), ``engine="auto"``'s choice and ``svm/model.py`` against
the reference's, on the CPU in f64: objectives rtol 1e-6, predictions and
decision values of fits run to a tight eps, and the CPU path launching no
kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.svm import SVC as JSVC
from repro.svm import SVR as JSVR
from repro.svm import OneClassSVM as JOneClass
from repro.svm import model as jmodel
from repro.core.solver import SolverConfig as JConfig
from repro.svm.data import multiclass_blobs, ring
from repro_torch import kernels
from repro_torch.core.solver import SolveResult, SolverConfig
from repro_torch.svm import SVC, SVR, OneClassSVM
from repro_torch.svm import model as tmodel

EPS = 1e-3
F64 = dict(device="cpu", dtype=torch.float64)


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def _regression(n=48, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(n, 2))
    return X, np.sinc(X[:, 0]) + 0.05 * rng.normal(size=n)




def test_train_svm_matches_reference():
    X, y = ring(60, seed=0)
    C, gamma = 10.0, 1.0
    cfg = dict(eps=EPS, algorithm="pasmo")
    mj, rj = jmodel.train_svm(X, y, C, gamma, JConfig(**cfg))
    mt, rt = tmodel.train_svm(X, y, C, gamma, SolverConfig(**cfg),
                              device="cpu")
    assert bool(rt.converged)
    np.testing.assert_allclose(float(rt.objective), float(rj.objective),
                               rtol=1e-6)
    Xq = np.random.default_rng(5).uniform(-2.5, 2.5, size=(40, 2))
    # the same model through both decision functions
    same = jmodel.SVMModel(X=jnp.asarray(X), alpha=jnp.asarray(_np(mt.alpha)),
                           b=jnp.asarray(float(mt.b)), gamma=jnp.asarray(
                               gamma))
    np.testing.assert_allclose(_np(tmodel.decision_function(mt, Xq)),
                               np.asarray(jmodel.decision_function(
                                   same, jnp.asarray(Xq))), rtol=1e-10,
                               atol=1e-12)
    pt, pj = _np(tmodel.predict(mt, Xq)), np.asarray(
        jmodel.predict(mj, jnp.asarray(Xq)))
    assert set(np.unique(pt)) <= {-1.0, 1.0}
    assert np.mean(pt == pj) >= 0.95
    assert int(mt.n_sv()) == int(mj.n_sv())
    assert int(mt.n_bounded_sv(C)) == int(mj.n_bounded_sv(C))


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("precompute", [True, False])
def test_svc_batched_matches_reference(k, precompute):
    X, y = multiclass_blobs(72, seed=1, k=k, d=3, sep=3.0)
    kw = dict(C=2.0, gamma=0.5, engine="batched", precompute=precompute,
              algorithm="pasmo_simple")
    ct = SVC(**kw, **F64).fit(X, y)
    cj = JSVC(**kw).fit(X, y)
    assert ct.engine_ == cj.engine_ == "batched"
    assert isinstance(ct.fit_result_, SolveResult)
    np.testing.assert_allclose(_np(ct.fit_result_.objective),
                               np.asarray(cj.fit_result_.objective),
                               rtol=1e-6)
    assert ct.alpha_.shape == cj.alpha_.shape
    assert np.mean(ct.predict(X) == cj.predict(X)) >= 0.99


def test_svc_auto_resolves_to_batched_for_non_fusable_configs():
    X, y = multiclass_blobs(60, seed=2, k=3, d=3, sep=3.0)
    for kw in (dict(algorithm="pasmo_simple"), dict(algorithm="overshoot"),
               dict(plan_candidates=2), dict(algorithm="smo")):
        ct = SVC(C=1.0, gamma=0.5, **kw, **F64).fit(X, y)
        cj = JSVC(C=1.0, gamma=0.5, **kw).fit(X, y)
        want = "fused" if kw == dict(algorithm="smo") else "batched"
        assert ct.engine_ == cj.engine_ == want, kw
        np.testing.assert_allclose(_np(ct.fit_result_.objective),
                                   np.asarray(cj.fit_result_.objective),
                                   rtol=1e-6)


def test_svc_batched_class_weight_matches_reference():
    X, y = multiclass_blobs(66, seed=3, k=3, d=3, sep=3.0)
    kw = dict(C=2.0, gamma=0.5, engine="batched", class_weight="balanced")
    ct = SVC(**kw, **F64).fit(X, y)
    cj = JSVC(**kw).fit(X, y)
    np.testing.assert_allclose(_np(ct.fit_result_.objective),
                               np.asarray(cj.fit_result_.objective),
                               rtol=1e-6)


@pytest.mark.parametrize("precompute", [True, False])
def test_svr_oneclass_batched_match_reference(precompute):
    X, y = _regression()
    # a tight eps: the facades' predictions are compared, not only
    # objectives
    kw = dict(gamma=0.5, engine="batched", precompute=precompute, eps=1e-7)
    rt = SVR(C=4.0, epsilon=0.1, **kw, **F64).fit(X, y)
    rj = JSVR(C=4.0, epsilon=0.1, **kw).fit(X, y)
    assert rt.engine_ == rj.engine_ == "batched"
    np.testing.assert_allclose(float(rt.fit_result_.objective),
                               float(rj.fit_result_.objective), rtol=1e-6)
    assert abs(float(rt.alpha_.sum())) <= 1e-8
    np.testing.assert_allclose(_np(rt.predict(X[:10])),
                               np.asarray(rj.predict(X[:10])), atol=1e-5)
    ot = OneClassSVM(nu=0.2, **kw, **F64).fit(X)
    oj = JOneClass(nu=0.2, **kw).fit(X)
    assert ot.engine_ == "batched"
    np.testing.assert_allclose(float(ot.fit_result_.objective),
                               float(oj.fit_result_.objective), rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(ot.rho_, oj.rho_, rtol=1e-6, atol=1e-9)
    # training points on the boundary make predict's sign a coin toss:
    # compare the decision values
    np.testing.assert_allclose(_np(ot.decision_function(X)),
                               np.asarray(oj.decision_function(X)),
                               atol=1e-5)


def test_classic_cpu_path_launches_no_kernel():
    before = kernels.launches()
    X, y = multiclass_blobs(48, seed=4, k=3, d=3, sep=3.0)
    for precompute in (True, False):
        SVC(gamma=0.5, engine="batched", precompute=precompute,
            **F64).fit(X, y).predict(X[:5])
        SVR(gamma=0.5, engine="batched", precompute=precompute,
            **F64).fit(X, X[:, 0]).predict(X[:5])
        OneClassSVM(gamma=0.5, engine="batched", precompute=precompute,
                    **F64).fit(X).predict(X[:5])
    m, _ = tmodel.train_svm(X, np.where(y == 0, 1.0, -1.0), 1.0, 0.5,
                            device="cpu")
    tmodel.predict(m, X[:5])
    assert kernels.launches() == before
