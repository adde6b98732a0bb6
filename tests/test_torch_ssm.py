"""The port's Mamba2 SSM family (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``) on the CPU in float32, smoke config:
the causal conv, the chunked SSD scan (against the reference, against a
per-step recurrence, with a state handoff, and its gradient at
full-width decay), the forward, prefill, decode and their state, the loss
and its gradients, a training step, a checkpoint of the training state
and both launchers.  Weights are the reference's random init carried
across by ``params_from_numpy``; inputs come from
``np.random.default_rng``.

Tolerances: the conv and the SSD scan against the reference to rtol =
atol = 1e-5; the scan against the recurrence to 1e-4 and the state
handoff to rtol 1e-4 / atol 1e-5, the reference's own bounds
(``tests/test_models_smoke.py``); the full-decay gradient against the
float64 recurrence's to rtol 1e-4 (atol 1e-4 of each gradient's max);
logits, hidden states and the decode state to 1e-5; prefill plus decode
against the full forward to 2e-3; the loss to rtol 1e-5 and each gradient
leaf to 1e-5 of that leaf's max |g|."""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _path_str
from repro.configs import get_smoke as jget_smoke
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import registry as JR
from repro.models import ssm as jssm
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke
from repro_torch.configs.base import TrainConfig
from repro_torch.data import SyntheticTokens
from repro_torch.models import registry as R
from repro_torch.models import ssm
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (TrainState, init_state,
                                          make_train_step)
from repro_torch.tree import leaves, leaves_with_path, tree_map

CPU = dict(device="cpu")
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
ARCH = "mamba2-370m"
F32 = np.float32


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _weights():
    jp = JR.init_params(jax.random.PRNGKey(0), jget_smoke(ARCH), jnp.float32)
    return jp, params_from_numpy(get_smoke(ARCH),
                                 jax.tree.map(np.asarray, jp), **CPU)


def _by_path(ref_tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    return {_path_str(p): np.asarray(x) for p, x in flat}


def _close_by_leaf(got: dict, want: dict, rel):
    for k, w in want.items():
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got[k], w, rtol=0.0,
                                   atol=rel * max(scale, 1e-30), err_msg=k)


# ---------------------------------------------------------------------------
# the conv and the SSD scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,S", [(4, 24), (4, 3), (2, 9)])
def test_causal_conv_matches_reference(K, S):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, S, 12)).astype(F32)
    w = rng.normal(size=(K, 12)).astype(F32)
    b = rng.normal(size=(12,)).astype(F32)
    np.testing.assert_allclose(
        ssm._causal_conv(_t(x), _t(w), _t(b)).numpy(),
        np.asarray(jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b))), **MODEL_TOL)


def _scan_inputs(seed, B=2, S=64, H=3, P=4, N=8, decay=0.1):
    """The reference oracle's inputs (``tests/test_models_smoke.py``)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, P)).astype(F32),
            (-np.abs(rng.normal(size=(B, S, H))) * decay).astype(F32),
            rng.normal(size=(B, S, N)).astype(F32),
            rng.normal(size=(B, S, N)).astype(F32))


def _recurrence(xdt, dA, Bm, Cm, h=None):
    """The per-step recurrence (numpy, float64): h <- h e^{dA} + x B,
    y = h C."""
    B, S, H, P = xdt.shape
    h = np.zeros((B, H, P, Bm.shape[-1])) if h is None else h
    ys = np.zeros((B, S, H, P))
    for t in range(S):
        h = h * np.exp(dA[:, t])[..., None, None] + np.einsum(
            "bhp,bn->bhpn", xdt[:, t], Bm[:, t])
        ys[:, t] = np.einsum("bhpn,bn->bhp", h, Cm[:, t])
    return ys, h


# chunk sizes, and S = 40 with chunk 16 (16 does not divide 40: one chunk)
SCAN_CASES = {"q8": (64, 8), "q16": (64, 16), "q64": (64, 64),
              "undivided": (40, 16)}


@pytest.mark.parametrize("case", SCAN_CASES)
def test_ssd_chunked_matches_reference(case):
    S, chunk = SCAN_CASES[case]
    args = _scan_inputs(0, S=S)
    h0 = np.random.default_rng(9).normal(size=(2, 3, 4, 8)).astype(F32)
    for init in (None, h0):
        y, h = ssm.ssd_chunked(*map(_t, args), chunk,
                               None if init is None else _t(init))
        jy, jh = jssm.ssd_chunked(*map(jnp.asarray, args), chunk,
                                  None if init is None else jnp.asarray(init))
        assert y.dtype == torch.float32 and h.shape == (2, 3, 4, 8)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MODEL_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **MODEL_TOL)


@pytest.mark.parametrize("case", SCAN_CASES)
def test_ssd_chunked_matches_recurrence(case):
    """The reference's oracle (``tests/test_models_smoke.py:91-113``,
    slow there), in tier-1 here."""
    S, chunk = SCAN_CASES[case]
    args = _scan_inputs(0, S=S)
    y, h = ssm.ssd_chunked(*map(_t, args), chunk)
    ys, hs = _recurrence(*[a.astype(np.float64) for a in args])
    np.testing.assert_allclose(y.numpy(), ys, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h.numpy(), hs, rtol=1e-4, atol=1e-4)


def test_ssd_chunked_with_initial_state():
    """Two halves with the state handed over equal one pass
    (``tests/test_models_smoke.py:116-133``)."""
    xdt, dA, Bm, Cm = map(_t, _scan_inputs(1, B=1, S=32, H=2))
    y_full, h_full = ssm.ssd_chunked(xdt, dA, Bm, Cm, 8)
    y1, h1 = ssm.ssd_chunked(xdt[:, :16], dA[:, :16], Bm[:, :16],
                             Cm[:, :16], 8)
    y2, h2 = ssm.ssd_chunked(xdt[:, 16:], dA[:, 16:], Bm[:, 16:],
                             Cm[:, 16:], 8, h0=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), rtol=1e-4,
                               atol=1e-5)


def _full_decay_inputs(seed=0, B=1, S=256, H=32, P=4, N=8):
    """mamba2-370m's decay: 32 heads, dA from -0.5 to -3.2 a step
    (A = -(1..32) at dt 0.1), one chunk of 256 steps."""
    rng = np.random.default_rng(seed)
    dA = np.broadcast_to(-np.linspace(0.5, 3.2, H), (B, S, H))
    dA = (dA * rng.uniform(0.8, 1.0, size=(B, S, H))).astype(F32)
    return (rng.normal(size=(B, S, H, P)).astype(F32), dA,
            rng.normal(size=(B, S, N)).astype(F32),
            rng.normal(size=(B, S, N)).astype(F32),
            rng.normal(size=(B, S, H, P)).astype(F32),
            rng.normal(size=(B, H, P, N)).astype(F32))


def test_ssd_gradient_is_finite_at_full_width_decay():
    """The gradient of ``ssd_chunked`` where the reference's is NaN: every
    element finite and equal to the gradient of the per-step recurrence
    in float64 through autograd."""
    xdt, dA, Bm, Cm, gy, gh = _full_decay_inputs()

    def grads(fn, dtype):
        ins = [_t(a).to(dtype).requires_grad_(True) for a in (xdt, dA, Bm,
                                                              Cm)]
        y, h = fn(*ins)
        out = (y * _t(gy).to(dtype)).sum() + (h * _t(gh).to(dtype)).sum()
        return [g.detach().double().numpy()
                for g in torch.autograd.grad(out, ins)]

    def steps(x, a, b, c):
        h = torch.zeros((x.shape[0], x.shape[2], x.shape[3], b.shape[-1]),
                        dtype=x.dtype)
        ys = []
        for t in range(x.shape[1]):
            h = (h * torch.exp(a[:, t])[..., None, None]
                 + x[:, t, :, :, None] * b[:, t, None, None, :])
            ys.append(torch.einsum("bhpn,bn->bhp", h, c[:, t]))
        return torch.stack(ys, 1), h

    got = grads(lambda *a: ssm.ssd_chunked(*a, 256), torch.float32)
    want = grads(steps, torch.float64)
    for name, g, w in zip(("xdt", "dA", "Bm", "Cm"), got, want):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
    # the reference's own gradient of dA at these inputs is NaN
    # (its _segsum_exp; ROADMAP queue 3, reference drift)
    jdA = jax.grad(lambda a: jnp.sum(jssm.ssd_chunked(
        jnp.asarray(xdt), a, jnp.asarray(Bm), jnp.asarray(Cm), 256)[0]
        * jnp.asarray(gy)))(jnp.asarray(dA))
    assert np.isnan(np.asarray(jdA)).any()


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_init_params_leaf_shapes_and_distributions():
    cfg = get_smoke(ARCH)
    want = jax.eval_shape(lambda: JR.init_params(jax.random.PRNGKey(0),
                                                 jget_smoke(ARCH)))
    got = R.init_params(0, cfg, **CPU)
    shapes = tree_map(lambda t: tuple(t.shape), got)
    assert shapes == jax.tree.map(
        lambda s: None if s is None else tuple(s.shape), want,
        is_leaf=lambda s: s is None)
    assert ssm.param_shapes(cfg) == shapes and got.unembed is None
    jp, _ = _weights()
    b = got.blocks
    np.testing.assert_allclose(b.A_log.numpy(), np.asarray(jp.blocks.A_log),
                               rtol=1e-6)
    assert bool((b.D == 1).all()) and not b.conv_b.any()
    dt = torch.nn.functional.softplus(b.dt_bias)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    din = cfg.ssm_expand * cfg.d_model
    std = 1.0 / np.sqrt(din)
    assert float(b.w_out.abs().max()) <= 2 * std * (1 + 1e-6)
    again = R.init_params(torch.Generator().manual_seed(0), cfg, **CPU)
    assert torch.equal(again.blocks.dt_bias, b.dt_bias)


def test_forward_logits_and_hidden_match_reference():
    jcfg, cfg = jget_smoke(ARCH), get_smoke(ARCH)
    jp, tp = _weights()
    jb = JR.demo_batch(jcfg, batch=2, seq=40, seed=1)
    tb = R.demo_batch(cfg, batch=2, seq=40, seed=1, **CPU)
    got, aux = R.forward_logits(tp, cfg, tb)
    want, _ = JR.forward_logits(jp, jcfg, jb)
    assert got.shape == (2, 40, cfg.vocab) and aux == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    hid = ssm.apply(tp, cfg, tb["tokens"], return_hidden=True)
    jhid = jssm.apply(jp, jcfg, jb["tokens"], return_hidden=True)
    assert hid.shape == (2, 40, cfg.d_model)
    np.testing.assert_allclose(hid.numpy(), np.asarray(jhid), **MODEL_TOL)


@pytest.mark.parametrize("S", [16, 64])
def test_prefill_decode_and_state_match_reference(S):
    """Prefill (one chunk, and two of 32) and three decode steps: logits,
    the SSD state h and the conv ring against the reference's."""
    jcfg, cfg = jget_smoke(ARCH), get_smoke(ARCH)
    jp, tp = _weights()
    jb = JR.demo_batch(jcfg, batch=2, seq=S + 3, seed=5)
    tb = R.demo_batch(cfg, batch=2, seq=S + 3, seed=5, **CPU)
    jl, jc = JR.prefill(jp, jcfg, {"tokens": jb["tokens"][:, :S]}, S + 3,
                        kv_dtype=jnp.float32)
    tl, tc = R.prefill(tp, cfg, {"tokens": tb["tokens"][:, :S]}, S + 3,
                       kv_dtype=torch.float32)

    def same(tl, jl, tc, jc):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
        for name in ("h", "conv"):
            got, want = getattr(tc, name), np.asarray(getattr(jc, name))
            assert tuple(got.shape) == want.shape
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)

    same(tl, jl, tc, jc)
    empty = R.init_cache(cfg, 2, S + 3, torch.float32, **CPU)
    jempty = JR.init_cache(jcfg, 2, S + 3, jnp.float32)
    for name in ("h", "conv"):
        np.testing.assert_array_equal(getattr(empty, name).numpy(),
                                      np.asarray(getattr(jempty, name)))
    for t in range(S, S + 3):
        jl, jc = JR.decode_step(jp, jcfg, jc, jb["tokens"][:, t:t + 1],
                                jnp.asarray(t, jnp.int32))
        tl, tc = R.decode_step(tp, cfg, tc, tb["tokens"][:, t:t + 1], t)
        same(tl, jl, tc, jc)


@pytest.mark.parametrize("S", [16, 40])
def test_prefill_decode_matches_full_forward(S):
    """Prefill of S tokens plus 4 decode steps against the full forward on
    all of them, at the reference's bound (S = 40: prefill in one chunk,
    the forward in one chunk of 44)."""
    cfg = get_smoke(ARCH)
    _, tp = _weights()
    extra = 4
    tb = R.demo_batch(cfg, batch=2, seq=S + extra, seed=2, **CPU)
    full, _ = R.forward_logits(tp, cfg, tb)
    lpre, cache = R.prefill(tp, cfg, {"tokens": tb["tokens"][:, :S]},
                            S + extra, kv_dtype=torch.float32)
    np.testing.assert_allclose(lpre.numpy(), full[:, :S].numpy(),
                               **DECODE_TOL)
    for t in range(extra):
        lt, cache = R.decode_step(tp, cfg, cache,
                                  tb["tokens"][:, S + t:S + t + 1], S + t)
        np.testing.assert_allclose(lt[:, 0].numpy(), full[:, S + t].numpy(),
                                   **DECODE_TOL)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_loss_and_gradient_match_reference():
    jcfg, cfg = jget_smoke(ARCH), get_smoke(ARCH)
    jp, tp = _weights()
    jb = JR.demo_batch(jcfg, 4, 40, seed=4)
    tb = {k: _t(v) for k, v in jb.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JR.loss_fn(p, jcfg, b), has_aux=True))(jp, jb)
    want = _by_path(jg)
    assert all(np.isfinite(w).all() for w in want.values())
    live = tree_map(lambda p: p.clone().requires_grad_(True), tp)
    tl, tm = R.loss_fn(live, cfg, tb)
    tg = torch.autograd.grad(tl, leaves(live))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    got = {p: g.numpy() for (p, _), g in zip(leaves_with_path(tp), tg)}
    assert sorted(got) == sorted(want)
    _close_by_leaf(got, want, 1e-5)
    for name in ("blocks/A_log", "blocks/dt_bias", "blocks/w_dt"):
        assert float(np.abs(got[name]).max()) > 0, name


TC = dict(param_dtype="float32", compute_dtype="float32",
          accum_dtype="float32", learning_rate=1e-2, remat="none",
          grad_clip=1.0)
# SGDM, as in tests/test_torch_moe.py: AdamW's first steps move an
# element whose gradient is rounding noise by about lr in either package
# (one w_out element in 16384 lands 1.2% of the leaf's movement apart)
STEP_CASES = {"m1": dict(microbatches=1, optimizer="sgdm"),
              "m2_inside_remat": dict(microbatches=2,
                                      accum_mode="inside_grad",
                                      remat="full", optimizer="sgdm")}


@pytest.mark.parametrize("case", STEP_CASES)
def test_train_step_matches_reference(case):
    """Three SGDM steps from step 150 on SyntheticTokens batches from the
    same weights and zero state, as
    ``tests/test_torch_train.py::test_train_step_matches_reference``
    holds the dense model: loss, gradient norm and lr to rtol 1e-5;
    parameters within 1% of each leaf's largest movement, moments to 1e-4
    of their largest."""
    kw = {**TC, **STEP_CASES[case]}
    tc_j, tc_t = JTrainConfig(**kw), TrainConfig(**kw)
    jcfg, cfg = jget_smoke(ARCH), get_smoke(ARCH)
    jp, tp = _weights()
    s0 = jts.init_state(jax.random.PRNGKey(0), jcfg, tc_j)
    js = s0._replace(params=jp, opt=jopt.init(jp, tc_j),
                     step=jnp.int32(150))
    ts = TrainState(params=tp, opt=opt.init(tp, tc_t), ef=None,
                    step=torch.tensor(150, dtype=torch.int32))
    jstep = jax.jit(jts.make_train_step(jcfg, tc_j))
    tstep = make_train_step(cfg, tc_t)
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=16, global_batch=4)
    for s in range(150, 153):
        b = data.batch_at(s)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, {k: _t(v) for k, v in b.items()})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=f"{k} at {s}")
        assert float(tm["aux"]) == 0.0
    want, got = _by_path(js), {p: x.detach().numpy() for p, x in
                               leaves_with_path(ts)}
    assert sorted(got) == sorted(want)
    before = _by_path(jp)
    for k, w in want.items():
        if k.startswith("params/"):
            moved = w - before[k[len("params/"):]]
            np.testing.assert_allclose(
                got[k], w, rtol=0.0,
                atol=1e-2 * float(np.abs(moved).max()), err_msg=k)
        elif k.startswith("opt/") and k != "opt/step":
            np.testing.assert_allclose(
                got[k], w, rtol=0.0, atol=1e-4 * float(np.abs(w).max()),
                err_msg=k)


def test_train_state_checkpoint_round_trip(tmp_path):
    """An SSM training state (AdamW) after a step, saved and restored
    bitwise, its keys the reference's ``_path_str`` keys."""
    cfg = get_smoke(ARCH)
    tc = TrainConfig(param_dtype="float32", compute_dtype="float32")
    state = init_state(0, cfg, tc, **CPU)
    state, _ = make_train_step(cfg, tc)(
        state, {k: _t(v) for k, v in SyntheticTokens(
            vocab=cfg.vocab, seq_len=8, global_batch=2).batch_at(0).items()})
    save_checkpoint(str(tmp_path), 1, state)
    back = restore_checkpoint(str(tmp_path), 1,
                              tree_map(torch.zeros_like, state), **CPU)
    for (p, a), (_, b) in zip(leaves_with_path(state),
                              leaves_with_path(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    ref = jax.eval_shape(lambda: jts.init_state(
        jax.random.PRNGKey(0), jget_smoke(ARCH), JTrainConfig(
            param_dtype="float32", compute_dtype="float32")))
    assert sorted(p for p, _ in leaves_with_path(state)) == sorted(
        _by_path(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), ref)))


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_launchers_run_mamba2_smoke(tmp_path, capsys):
    from repro_torch.launch import serve, train
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                "2", "--prompt-len", "8", "--tokens", "6"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "arch=mamba2-370m-smoke batch=2"
    assert re.fullmatch(r"prefill 8 tok: \d+\.\d\ds; decode 6 tok: "
                        r"\d+\.\d\ds \(\d+\.\d tok/s\)", lines[1]), lines[1]
    assert re.fullmatch(r"first sequence: \[[\d ]+\] \.\.\.", lines[2])
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--microbatches", "2", "--save-every", "2",
            "--ckpt", str(tmp_path / "ck")]
    run = train.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "arch: mamba2-370m-smoke" in out and "step    2  loss" in out
    assert out.rstrip().endswith("done")
    assert np.isfinite(run.losses + run.grad_norms).all()
    run2 = train.main(argv + ["--steps", "4"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert run2.start == 3 and int(run2.state.step) == 4
