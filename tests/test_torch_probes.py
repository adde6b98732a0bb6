"""The port's SVM probe on LM features (``repro_torch.svm.probes``)
against the reference's (``repro.svm.probes``) on the CPU in float64.

Tolerances: ``median_gamma`` to rtol 1e-12; per-head objectives to rtol
1e-6 (the repo's solver parity rule: the two engines may part at rounding
ties), each head's KKT gap at most eps, and held-out predictions equal
wherever the port's top-2 score margin exceeds 1e-6; features to rtol
1e-4 (float32 forwards summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, get_smoke as jget_smoke
from repro.kernels import ops as jops
from repro.models import registry as JR
from repro.svm import probes as jprobes
from repro_torch.configs import get_smoke
from repro_torch.core.solver import SolverConfig, solve_batched
from repro_torch.kernels import ops
from repro_torch.models import registry as R
from repro_torch.models.convert import params_from_numpy
from repro_torch.svm import probes

EPS = 1e-3
CFG = SolverConfig(algorithm="pasmo", eps=EPS)


def _data():
    """``tests/test_probes.py``'s problem: 66 points, 16 features, 3
    classes; the first 48 train."""
    rng = np.random.default_rng(0)
    n, d, k = 66, 16, 3
    labels = rng.integers(0, k, size=n)
    centers = rng.normal(size=(k, d)) * 3.0
    feats = centers[labels] + rng.normal(size=(n, d))
    return feats, labels, k


@pytest.mark.parametrize("n", [12, 11])
def test_median_gamma_matches_reference(n):
    """An even n (n^2 even: the two middle values averaged) and an odd."""
    X = np.random.default_rng(n).normal(size=(n, 5))
    got = probes.median_gamma(torch.as_tensor(X))
    want = jprobes.median_gamma(jnp.asarray(X, jnp.float64))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def _objectives(alphas, labels, k, K):
    """Each head's dual objective ``y.a - a.K.a / 2`` (signed duals)."""
    ys = np.where(labels[None, :] == np.arange(k)[:, None], 1.0, -1.0)
    return np.array([ys[c] @ alphas[c] - 0.5 * alphas[c] @ K @ alphas[c]
                     for c in range(k)])


def test_train_probe_matches_reference():
    feats, labels, k = _data()
    tr, te = slice(0, 48), slice(48, None)
    want = jprobes.train_probe(jnp.asarray(feats[tr]),
                               jnp.asarray(labels[tr]), k, C=10.0)
    got = probes.train_probe(feats[tr], labels[tr], k, C=10.0, cfg=CFG,
                             device="cpu")
    assert got.gamma == pytest.approx(want.gamma, rel=1e-12)
    K = np.asarray(jops.gram(jnp.asarray(feats[tr]), None, want.gamma))
    jobj = _objectives(np.asarray(want.alphas), labels[tr], k, K)
    np.testing.assert_allclose(got.objective.numpy(), jobj, rtol=1e-6)
    np.testing.assert_allclose(
        _objectives(got.alphas.numpy(), labels[tr], k, K),
        got.objective.numpy(), rtol=1e-10)
    assert bool(got.converged.all())
    assert float(got.kkt_gap.max()) <= EPS
    assert int(got.iterations.min()) > 0
    # held-out predictions, where the port's scores are not near a tie
    Kq = ops.gram(feats[te], got.X, got.gamma, device="cpu",
                  dtype=torch.float64)
    scores = np.sort((Kq @ got.alphas.T + got.biases).numpy(), axis=1)
    clear = scores[:, -1] - scores[:, -2] > 1e-6
    pred = probes.predict_probe(got, feats[te]).numpy()
    jpred = np.asarray(jprobes.predict_probe(want, jnp.asarray(feats[te])))
    assert clear.sum() >= 15
    np.testing.assert_array_equal(pred[clear], jpred[clear])
    assert (pred == labels[te]).mean() >= 0.85


def test_shared_gram_equals_k_copies_bitwise():
    """The probe's one Gram matrix, read by every lane through a stacked
    kernel, gives the result of k broadcast copies (``solve_batched``, as
    the reference solves it), field for field."""
    feats, labels, k = _data()
    got = probes.train_probe(feats, labels, k, C=10.0, cfg=CFG,
                             device="cpu")
    X = torch.as_tensor(feats)
    K = ops.gram(X, None, got.gamma, device="cpu")
    ys = torch.where(torch.as_tensor(labels)[None, :]
                     == torch.arange(k)[:, None], 1.0, -1.0).double()
    ref = solve_batched(K.expand(k, -1, -1).clone(), ys, 10.0, CFG,
                        device="cpu")
    for name, want in (("alphas", ref.alpha), ("biases", ref.b),
                       ("iterations", ref.iterations),
                       ("objective", ref.objective),
                       ("kkt_gap", ref.kkt_gap),
                       ("converged", ref.converged)):
        assert torch.equal(getattr(got, name), want), name


@pytest.mark.parametrize("arch", ARCHS)
def test_extract_features_matches_reference(arch):
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    jp = JR.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    jb = JR.demo_batch(jcfg, batch=4, seq=16)
    tb = R.demo_batch(cfg, batch=4, seq=16, device="cpu")
    for pool in ("mean", "last"):
        got = probes.extract_features(tp, cfg, tb, pool)
        want = jprobes.extract_features(jp, jcfg, jb, pool)
        assert got.shape == (4, cfg.d_model) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6)


def test_probe_on_lm_features_end_to_end():
    """Features of a smoke model, then heads, then predictions, all on the
    port (the reference's own end-to-end case, which it runs in its slow
    tier): low against high token ids separate."""
    cfg = get_smoke("qwen2-0.5b")
    params = R.init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(1)
    lo = rng.integers(0, cfg.vocab // 4, size=(16, 24))
    hi = rng.integers(3 * cfg.vocab // 4, cfg.vocab, size=(16, 24))
    tokens = torch.as_tensor(np.concatenate([lo, hi]), dtype=torch.int32)
    labels = np.array([0] * 16 + [1] * 16)
    feats = probes.extract_features(params, cfg, {"tokens": tokens})
    probe = probes.train_probe(feats, labels, 2, C=10.0, cfg=CFG,
                               device="cpu")
    pred = probes.predict_probe(probe, feats).numpy()
    assert (pred == labels).mean() >= 0.9
    assert int(probe.iterations.max()) > 0
