"""The port's SVC facade against ``repro.svm.SVC(impl="jnp")``, state
carried across with ``svc_from_numpy``, and the port's copy of the
dataset generators.

Decision functions agree to 1e-6 of their scale in f64 (1e-3 in f32) and
predictions are equal; both fits stop at eps = 1e-7 (f64) or 1e-4 (f32),
since two eps-optimal solutions differ by O(eps).  A dual carried across
predicts to 1e-10 (f64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import multiclass as jmc
from repro.svm import SVC as JSVC
from repro.svm import data as jdata
from repro_torch.core import multiclass as mc
from repro_torch.svm import SVC, data, svc_from_numpy

DF_RTOL = {torch.float64: 1e-6, torch.float32: 1e-3}
EPS = {torch.float64: 1e-7, torch.float32: 1e-4}


def _binary(n=120, seed=2):
    X, y = data.gaussian_blobs(n, seed=seed, d=4, sep=2.0)
    return X, np.where(y > 0, "pos", "neg")


def _multiclass(n=150, seed=3):
    return data.multiclass_blobs(n, seed=seed, k=3, d=2, sep=4.0)


def _pair(X, y, dtype, **kw):
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    kw.setdefault("eps", EPS[dtype])
    j = JSVC(impl="jnp", dtype=jdtype, **kw).fit(X, y)
    t = SVC(device="cpu", dtype=dtype, **kw).fit(X, y)
    return j, t


def _check_decisions(j, t, Xq, dtype):
    df_j = np.asarray(j.decision_function(Xq), np.float64)
    df_t = t.decision_function(Xq)
    assert df_t.dtype == dtype
    df_t = df_t.numpy().astype(np.float64)
    scale = float(np.abs(df_j).max())
    np.testing.assert_allclose(df_t, df_j, rtol=0,
                               atol=DF_RTOL[dtype] * scale)
    np.testing.assert_array_equal(t.predict(Xq), j.predict(Xq))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["binary", "ovr"])
@pytest.mark.parametrize("class_weight", [None, "balanced"])
def test_svc_matches_reference(kind, class_weight, dtype):
    X, y = _binary() if kind == "binary" else _multiclass()
    C = 1.0 if kind == "binary" else np.array([0.5, 1.0, 2.0])
    if class_weight is not None:
        C = 1.0
    j, t = _pair(X, y, dtype, C=C, gamma="scale", class_weight=class_weight)
    assert t.gamma_ == pytest.approx(j.gamma_, rel=1e-12)
    np.testing.assert_array_equal(t.classes_, j.classes_)
    assert bool(t.fit_result_.converged.all())
    rng = np.random.default_rng(5)
    Xq = X[rng.permutation(len(X))[:40]] + rng.normal(scale=0.3,
                                                      size=(40, X.shape[1]))
    _check_decisions(j, t, Xq, dtype)


@pytest.mark.parametrize("alg", ["smo", "pasmo"])
def test_svc_algorithms_reach_the_same_optimum(alg):
    X, y = _multiclass(seed=4)
    j, t = _pair(X, y, torch.float64, C=2.0, gamma=0.5, algorithm=alg,
                 eps=1e-3)
    np.testing.assert_allclose(t.fit_result_.objective.numpy(),
                               np.asarray(j.fit_result_.objective),
                               rtol=1e-6)
    assert t.score(X, y) == j.score(X, y)


@pytest.mark.parametrize("kind", ["binary", "ovr"])
def test_svc_from_numpy_predicts_like_the_reference(kind):
    X, y = _binary() if kind == "binary" else _multiclass()
    j = JSVC(C=1.0, gamma=0.7, impl="jnp", dtype=jnp.float64).fit(X, y)
    t = svc_from_numpy(np.asarray(j.X_), np.asarray(j.alpha_),
                       np.asarray(j.b_), j.gamma_, j.classes_,
                       device="cpu", dtype=torch.float64)
    Xq = np.random.default_rng(6).normal(size=(30, X.shape[1]))
    np.testing.assert_allclose(t.decision_function(Xq).numpy(),
                               np.asarray(j.decision_function(Xq)),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(t.predict(Xq), j.predict(Xq))
    np.testing.assert_array_equal(t.n_support_, j.n_support_)
    assert t.decision_function(Xq[0]).shape == \
        np.asarray(j.decision_function(Xq[0])).shape


def test_ovr_helpers_match_reference():
    rng = np.random.default_rng(8)
    y = rng.choice(np.array(["b", "a", "c", "d"]), size=60)
    classes, y_idx = mc.class_index(y)
    j_classes, j_idx = jmc.class_index(y)
    np.testing.assert_array_equal(classes, j_classes)
    np.testing.assert_array_equal(y_idx, j_idx)
    np.testing.assert_array_equal(
        mc.ovr_labels(y_idx, 4).numpy(), np.asarray(jmc.ovr_labels(j_idx, 4)))
    Kq, alpha, b = (rng.normal(size=s) for s in ((25, 60), (4, 60), (4,)))
    df = mc.ovr_decision(*map(torch.as_tensor, (Kq, alpha, b)))
    np.testing.assert_allclose(
        df.numpy(), np.asarray(jmc.ovr_decision(*map(jnp.asarray,
                                                     (Kq, alpha, b)))),
        rtol=1e-12)
    pred = mc.ovr_predict(*map(torch.as_tensor, (Kq, alpha, b)))
    assert pred.dtype == torch.int32
    np.testing.assert_array_equal(
        pred.numpy(), np.asarray(jmc.ovr_predict(*map(jnp.asarray,
                                                      (Kq, alpha, b)))))


@pytest.mark.parametrize("name,kw", [
    ("chessboard", dict(noise=0.1)), ("gaussian_blobs", dict(d=5)),
    ("ring", {}), ("xor_gaussians", {}),
    ("multiclass_blobs", dict(k=4, d=3))])
def test_data_generators_equal_the_reference_bitwise(name, kw):
    for seed in (0, 7):
        X_t, y_t = getattr(data, name)(50, seed=seed, **kw)
        X_j, y_j = getattr(jdata, name)(50, seed=seed, **kw)
        np.testing.assert_array_equal(X_t, X_j)
        np.testing.assert_array_equal(y_t, y_j)
        assert X_t.dtype == X_j.dtype and y_t.dtype == y_j.dtype


def test_make_dataset_equals_the_reference():
    for name in data.DATASETS:
        got, want = data.make_dataset(name, 40, 3), jdata.make_dataset(
            name, 40, 3)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
