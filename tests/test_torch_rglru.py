"""The port's hybrid family (``repro_torch.models.rglru``, RecurrentGemma:
RG-LRU blocks and local MQA) against the reference's
(``repro.models.rglru``) on the CPU in float32, smoke config (5 layers:
one triple and a tail of two; window 32): the RG-LRU scan (against the
reference, against the per-step recurrence, and its gradient), the
forward and hidden states with and without remat, prefill and decode
with the attention ring wrapped and their caches, the loss and its
gradients, a 6-layer config without a tail (convert, forward, a
checkpoint, each optimizer's step) and both launchers.  Weights are the
reference's random init carried across by ``params_from_numpy``; inputs
come from ``np.random.default_rng``.

Tolerances: the scan against the reference to rtol = atol = 1e-5 and
against the recurrence to 2e-4 (the reference's own bound,
``tests/test_models_smoke.py``); the scan's gradient against the float64
recurrence's to 1e-4 of each gradient's max; logits, hidden states and
the caches to 1e-5; prefill plus decode against the full forward to
2e-3; the loss to rtol 1e-5 and each gradient leaf to 1e-4 of that
leaf's max |g| (a bias's gradient sums float32 products over every
token through the scan: one element in 128 lands 1.04e-5 of the max
apart)."""

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
from repro.models import registry as JR
from repro.models import rglru as jrg
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke
from repro_torch.configs.base import TrainConfig
from repro_torch.data import SyntheticTokens
from repro_torch.models import registry as R
from repro_torch.models import rglru
from repro_torch.models.convert import params_from_numpy
from repro_torch.train.train_step import init_state, make_train_step
from repro_torch.tree import leaves, leaves_with_path, tree_map

CPU = dict(device="cpu")
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
ARCH = "recurrentgemma-2b"
F32 = np.float32


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _weights(n_layers=None):
    """The reference's init of the smoke config (``n_layers`` replaced
    when given) and the port's copy, once a module."""
    jcfg, cfg = _cfgs(n_layers)
    jp = JR.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    return jp, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), **CPU)


def _cfgs(n_layers=None):
    jcfg, cfg = jget_smoke(ARCH), get_smoke(ARCH)
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return jcfg, cfg


def _by_path(ref_tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    return {_path_str(p): np.asarray(x) for p, x in flat}


def _close_by_leaf(got: dict, want: dict, rel):
    for k, w in want.items():
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got[k], w, rtol=0.0,
                                   atol=rel * max(scale, 1e-30), err_msg=k)


# ---------------------------------------------------------------------------
# the RG-LRU scan
# ---------------------------------------------------------------------------

def _scan_inputs(S, seed=2, B=2, W=8):
    """The reference oracle's inputs (``tests/test_models_smoke.py``)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, W)).astype(F32),
            rng.uniform(size=(B, S, W)).astype(F32),
            rng.uniform(size=(B, S, W)).astype(F32),
            rng.normal(size=(W,)).astype(F32),
            rng.normal(size=(B, W)).astype(F32))


def _recurrence(xb, r, i, lam, h0=None):
    """The per-step recurrence in float64 (numpy): the reference oracle's
    loop, from ``h0`` when given."""
    xb, r, i, lam = (np.asarray(a, np.float64) for a in (xb, r, i, lam))
    log_a = -8.0 * np.log1p(np.exp(lam)) * r
    a = np.exp(log_a)
    b = np.sqrt(1 - np.exp(2 * log_a)) * i * xb
    h = np.zeros(xb.shape[::2]) if h0 is None else np.asarray(h0, np.float64)
    ys = np.zeros(xb.shape)
    for t in range(xb.shape[1]):
        h = a[:, t] * h + b[:, t]
        ys[:, t] = h
    return ys, h


# S = 1 (the decode step's direct form), odd lengths and powers of two:
# the odd/even recursion has its edge cases at odd lengths
SCAN_LENGTHS = [1, 2, 7, 16, 33, 40]


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("S", SCAN_LENGTHS)
def test_rglru_matches_reference(S, with_h0):
    xb, r, i, lam, h0 = _scan_inputs(S)
    h0 = h0 if with_h0 else None
    y, h = rglru._rglru(_t(xb), _t(r), _t(i), _t(lam),
                        None if h0 is None else _t(h0))
    jy, jh = jrg._rglru(*map(jnp.asarray, (xb, r, i, lam)),
                        None if h0 is None else jnp.asarray(h0))
    assert y.dtype == torch.float32 and h.shape == (2, 8)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MODEL_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **MODEL_TOL)


@pytest.mark.parametrize("S", SCAN_LENGTHS + [64])
def test_rglru_matches_recurrence(S):
    """The reference's oracle (``tests/test_models_smoke.py:136-157``),
    from zero and from a given state."""
    xb, r, i, lam, h0 = _scan_inputs(S)
    for init in (None, h0):
        y, h = rglru._rglru(_t(xb), _t(r), _t(i), _t(lam),
                            None if init is None else _t(init))
        ys, hs = _recurrence(xb, r, i, lam, init)
        np.testing.assert_allclose(y.numpy(), ys, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(h.numpy(), hs, rtol=2e-4, atol=2e-4)


def test_rglru_bf16_input_keeps_float32_state():
    xb, r, i, lam, h0 = (_t(a) for a in _scan_inputs(9))
    y, h = rglru._rglru(xb.bfloat16(), r.bfloat16(), i.bfloat16(), lam,
                        h0)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32


@pytest.mark.parametrize("S", [7, 32])
def test_rglru_gradient_matches_recurrence(S):
    """Gradients of every input through the recursion against autograd of
    the per-step recurrence in float64."""
    args = _scan_inputs(S, seed=3)
    gy = np.random.default_rng(4).normal(size=args[0].shape)
    gh = np.random.default_rng(5).normal(size=args[4].shape)

    def steps(xb, r, i, lam, h):
        log_a = -8.0 * torch.nn.functional.softplus(lam) * r
        a = torch.exp(log_a)
        b = torch.sqrt(1 - torch.exp(2 * log_a)) * i * xb
        ys = []
        for t in range(xb.shape[1]):
            h = a[:, t] * h + b[:, t]
            ys.append(h)
        return torch.stack(ys, 1), h

    def grads(fn, dtype):
        ins = [_t(a).to(dtype).requires_grad_(True) for a in args]
        y, h = fn(*ins)
        out = ((y * _t(gy).to(dtype)).sum()
               + (h.to(dtype) * _t(gh).to(dtype)).sum())
        return [g.double().numpy() for g in torch.autograd.grad(out, ins)]

    got = grads(rglru._rglru, torch.float32)
    want = grads(steps, torch.float64)
    for name, g, w in zip(("xb", "r", "i", "lam", "h0"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers", [None, 6], ids=["tail2", "no_tail"])
def test_init_params_leaf_shapes_and_distributions(n_layers):
    jcfg, cfg = _cfgs(n_layers)
    want = jax.eval_shape(lambda: JR.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    got = R.init_params(0, cfg, **CPU)
    shapes = tree_map(lambda t: tuple(t.shape), got)
    assert shapes == jax.tree.map(
        lambda s: None if s is None else tuple(s.shape), want,
        is_leaf=lambda s: s is None)
    assert rglru.param_shapes(cfg) == shapes and got.unembed is None
    assert (got.tail is None) == (n_layers == 6)
    rec = got.triples.rec1
    # a^c = exp(-c softplus(lam)) starts in [0.9, 0.999]
    ac = torch.exp(-8.0 * torch.nn.functional.softplus(rec.lam))
    assert 0.9 * (1 - 1e-5) <= float(ac.min())
    assert float(ac.max()) <= 0.999 * (1 + 1e-5)
    assert not rec.conv_b.any() and not rec.b_a.any()
    std = 1.0 / np.sqrt(cfg.rglru_width)
    assert float(rec.w_a.abs().max()) <= 2 * std * (1 + 1e-6)
    assert 0.8 * std < float(rec.w_a.std()) < 0.95 * std
    again = R.init_params(torch.Generator().manual_seed(0), cfg, **CPU)
    assert torch.equal(again.triples.attn.attn.wq, got.triples.attn.attn.wq)
    n_params = sum(t.numel() for t in leaves(got))
    assert n_params == sum(int(np.prod(s.shape)) for s in
                           jax.tree.leaves(want))


@pytest.mark.parametrize("n_layers", [None, 6], ids=["tail2", "no_tail"])
def test_convert_round_trip(n_layers):
    """``params_from_numpy`` puts every reference leaf at its own path,
    with the triple's ``attn`` block and that block's ``attn`` apart."""
    jp, tp = _weights(n_layers)
    want = _by_path(jp)
    got = {p: t.numpy() for p, t in leaves_with_path(tp)}
    assert sorted(got) == sorted(want)
    assert "triples/attn/attn/wq" in got
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("n_layers", [None, 6], ids=["tail2", "no_tail"])
def test_forward_logits_and_hidden_match_reference(n_layers):
    jcfg, cfg = _cfgs(n_layers)
    jp, tp = _weights(n_layers)
    jb = JR.demo_batch(jcfg, batch=2, seq=40, seed=1)
    tb = R.demo_batch(cfg, batch=2, seq=40, seed=1, **CPU)
    got, aux = R.forward_logits(tp, cfg, tb)
    want, _ = JR.forward_logits(jp, jcfg, jb)
    assert got.shape == (2, 40, cfg.vocab) and aux == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    hid = rglru.apply(tp, cfg, tb["tokens"], return_hidden=True)
    jhid = jrg.apply(jp, jcfg, jb["tokens"], return_hidden=True)
    assert hid.shape == (2, 40, cfg.d_model)
    np.testing.assert_allclose(hid.numpy(), np.asarray(jhid), **MODEL_TOL)


def test_remat_full_equals_none():
    """``remat="full"`` recomputes each triple in the backward: the same
    loss and gradients, bitwise."""
    _, cfg = _cfgs()
    _, tp = _weights()
    tb = R.demo_batch(cfg, batch=2, seq=24, seed=3, **CPU)
    out = {}
    for remat in ("none", "full"):
        live = tree_map(lambda p: p.clone().requires_grad_(True), tp)
        loss, _ = R.loss_fn(live, cfg, tb, remat=remat)
        out[remat] = (loss, torch.autograd.grad(loss, leaves(live)))
    assert torch.equal(out["full"][0], out["none"][0])
    for a, b in zip(out["full"][1], out["none"][1]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="remat"):
        R.loss_fn(tp, cfg, tb, remat="some")


def _cache_close(tc, jc):
    """The port's GriffinCache against the reference's, leaf by leaf."""
    want = _by_path(jc)
    got = {p: t.numpy() for p, t in leaves_with_path(tc)}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        if k.endswith("kpos"):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, **MODEL_TOL, err_msg=k)


def test_prefill_decode_and_cache_match_reference():
    """Prefill of 24 tokens, then 16 decode steps (to position 39, past the
    32-token window, so the attention ring wraps and the conv ring
    carries across steps): logits and every cache leaf (h, conv, k, v,
    kpos) against the reference's after the prefill and after each
    step."""
    jcfg, cfg = _cfgs()
    jp, tp = _weights()
    S, T_ = 24, 40
    jb = JR.demo_batch(jcfg, batch=2, seq=T_, seed=5)
    tb = R.demo_batch(cfg, batch=2, seq=T_, seed=5, **CPU)
    jl, jc = JR.prefill(jp, jcfg, {"tokens": jb["tokens"][:, :S]}, T_,
                        kv_dtype=jnp.float32)
    tl, tc = R.prefill(tp, cfg, {"tokens": tb["tokens"][:, :S]}, T_,
                       kv_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    _cache_close(tc, jc)
    assert tc.attn.k.shape[2] == cfg.local_window
    assert tc.rec1.h.dtype == torch.float32
    empty = R.init_cache(cfg, 2, T_, torch.float32, **CPU)
    _cache_close(empty, JR.init_cache(jcfg, 2, T_, jnp.float32))
    jstep = jax.jit(lambda p, c, tok, pos: JR.decode_step(p, jcfg, c, tok,
                                                          pos))
    for t in range(S, T_):
        jl, jc = jstep(jp, jc, jb["tokens"][:, t:t + 1],
                       jnp.asarray(t, jnp.int32))
        tl, tc = R.decode_step(tp, cfg, tc, tb["tokens"][:, t:t + 1], t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    _cache_close(tc, jc)


def test_bf16_cache_keeps_float32_state():
    _, cfg = _cfgs()
    _, tp = _weights()
    tb = R.demo_batch(cfg, batch=2, seq=8, seed=6, **CPU)
    _, cache = R.prefill(tp, cfg, {"tokens": tb["tokens"]}, 8,
                         kv_dtype=torch.bfloat16)
    assert cache.rec1.h.dtype == torch.float32
    assert cache.rec1.conv.dtype == torch.bfloat16
    assert cache.attn.k.dtype == torch.bfloat16
    assert cache.attn.k.shape[2] == 8          # min(horizon, window)
    R.decode_step(tp, cfg, cache, tb["tokens"][:, :1], 8)
    assert cache.tail.h.dtype == torch.float32


@pytest.mark.parametrize("S", [16, 36])
def test_prefill_decode_matches_full_forward(S):
    """Prefill of S tokens plus teacher-forced decode steps to position
    47 against the full forward on all 48 tokens, at the reference's
    bound.  The window is 32: S = 36 wraps the ring in the prefill, S =
    16 while decoding."""
    _, cfg = _cfgs()
    _, tp = _weights()
    T_ = 48
    tb = R.demo_batch(cfg, batch=2, seq=T_, seed=2, **CPU)
    full, _ = R.forward_logits(tp, cfg, tb)
    lpre, cache = R.prefill(tp, cfg, {"tokens": tb["tokens"][:, :S]}, T_,
                            kv_dtype=torch.float32)
    np.testing.assert_allclose(lpre.numpy(), full[:, :S].numpy(),
                               **DECODE_TOL)
    for t in range(S, T_):
        lt, cache = R.decode_step(tp, cfg, cache, tb["tokens"][:, t:t + 1],
                                  t)
        np.testing.assert_allclose(lt[:, 0].numpy(), full[:, t].numpy(),
                                   **DECODE_TOL)
    cap = cfg.local_window
    live = torch.arange(T_ - cap, T_, dtype=torch.int32)
    assert torch.equal(cache.attn.kpos[0][live % cap], live)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers", [None, 6], ids=["tail2", "no_tail"])
def test_loss_and_gradient_match_reference(n_layers):
    jcfg, cfg = _cfgs(n_layers)
    jp, tp = _weights(n_layers)
    jb = JR.demo_batch(jcfg, 4, 24, seed=4)
    tb = {k: _t(v) for k, v in jb.items()}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JR.loss_fn(p, jcfg, b), has_aux=True))(jp, jb)
    want = _by_path(jg)
    live = tree_map(lambda p: p.clone().requires_grad_(True), tp)
    tl, _ = R.loss_fn(live, cfg, tb)
    tg = torch.autograd.grad(tl, leaves(live))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    got = {p: g.numpy() for (p, _), g in zip(leaves_with_path(tp), tg)}
    assert sorted(got) == sorted(want)
    _close_by_leaf(got, want, 1e-4)
    for name in ("triples/rec1/lam", "triples/rec2/w_a",
                 "triples/attn/attn/wk"):
        assert float(np.abs(got[name]).max()) > 0, name


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
def test_no_tail_train_step_and_checkpoint(tmp_path, name):
    """The 6-layer config (two triples, no tail): a training step with each
    optimizer changes every parameter and keeps the tail ``None``, and the
    state saves and restores bitwise under the reference's key names."""
    _, cfg = _cfgs(6)
    tc = TrainConfig(param_dtype="float32", compute_dtype="float32",
                     optimizer=name, learning_rate=1e-2, microbatches=2)
    # past the learning-rate warmup, whose step 0 has lr 0
    state = init_state(0, cfg, tc, **CPU)._replace(
        step=torch.tensor(150, dtype=torch.int32))
    assert state.params.tail is None
    batch = {k: _t(v) for k, v in SyntheticTokens(
        vocab=cfg.vocab, seq_len=12, global_batch=4).batch_at(0).items()}
    new, m = make_train_step(cfg, tc)(state, batch)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert new.params.tail is None
    same = [p for (p, a), b in zip(leaves_with_path(new.params),
                                   leaves(state.params)) if torch.equal(a, b)]
    assert not same, same
    save_checkpoint(str(tmp_path), 1, new)
    back = restore_checkpoint(str(tmp_path), 1,
                              tree_map(torch.zeros_like, new), **CPU)
    for (p, a), (_, b) in zip(leaves_with_path(new), leaves_with_path(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    ref = _by_path(_weights(6)[0])
    assert sorted(p[len("params/"):] for p, _ in leaves_with_path(new)
                  if p.startswith("params/")) == sorted(ref)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_launchers_run_recurrentgemma_smoke(tmp_path, capsys):
    from repro_torch.launch import serve, train
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                "2", "--prompt-len", "24", "--tokens", "12"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "arch=recurrentgemma-2b-smoke batch=2"
    assert re.fullmatch(r"prefill 24 tok: \d+\.\d\ds; decode 12 tok: "
                        r"\d+\.\d\ds \(\d+\.\d tok/s\)", lines[1]), lines[1]
    assert re.fullmatch(r"first sequence: \[[\d ]+\] \.\.\.", lines[2])
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--microbatches", "2", "--save-every", "2",
            "--ckpt", str(tmp_path / "ck")]
    run = train.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "arch: recurrentgemma-2b-smoke" in out and "step    2  loss" in out
    assert out.rstrip().endswith("done")
    assert np.isfinite(run.losses + run.grad_norms).all()
    run2 = train.main(argv + ["--steps", "4"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert run2.start == 3 and int(run2.state.step) == 4
