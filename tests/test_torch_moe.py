"""The port's MoE family (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``) on the CPU in float32, smoke configs:
``capacity``, the router and the capacity dispatch (with and without
drops, and on tied router columns), the forward, prefill and decode,
the loss and its gradients, a training step, a checkpoint of the training
state and both launchers.  Weights are the reference's random init
carried across by ``params_from_numpy``; inputs come from
``np.random.default_rng``.

Tolerances, those of ``tests/test_torch_models.py``: outputs, logits,
hidden states and the aux to rtol = atol = 1e-5 (float32 sums in
another order); prefill plus decode against the full forward to 2e-3,
the reference's own bound; the routing (expert indices, which (token, k)
picks are dropped, the cache's positions) exactly; the loss to rtol 1e-5
and each gradient leaf to 1e-5 of that leaf's max |g|."""

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
from repro.models import moe as jmoe
from repro.models import registry as JR
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke
from repro_torch.configs.base import TrainConfig
from repro_torch.data import SyntheticTokens
from repro_torch.models import moe
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (TrainState, init_state,
                                          make_train_step)
from repro_torch.tree import leaves, leaves_with_path, tree_map

CPU = dict(device="cpu")
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
ARCHS = ("mixtral-8x7b", "grok-1-314b")


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference's init of ``arch``'s smoke config and the port's copy
    of it (once a module: the reference's init is the slow part)."""
    jp = JR.init_params(jax.random.PRNGKey(0), jget_smoke(arch), jnp.float32)
    return jp, params_from_numpy(get_smoke(arch),
                                 jax.tree.map(np.asarray, jp), **CPU)


def _configs(arch, **overrides):
    return (dataclasses.replace(jget_smoke(arch), **overrides),
            dataclasses.replace(get_smoke(arch), **overrides))


# ---------------------------------------------------------------------------
# capacity and the MoE layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [0.5, 1.0, 1.25, 2.0, 8.0])
@pytest.mark.parametrize("top_k", [1, 2])
def test_capacity_matches_reference(capacity_factor, top_k):
    for n_experts in (4, 8, 16):
        for seq in (1, 7, 8, 24, 100, 512, 4096):
            jcfg, cfg = _configs("mixtral-8x7b", top_k=top_k,
                                 n_experts=n_experts,
                                 capacity_factor=capacity_factor)
            assert moe.capacity(cfg, seq) == jmoe.capacity(jcfg, seq), \
                (n_experts, seq)


def _layer(seed=0, d=16, f=24, E=4, tie=False):
    """Random MoE weights (numpy), scaled like the reference's init; with
    ``tie`` router columns 1 and 2 are equal, so every token's experts 1
    and 2 have equal probabilities."""
    rng = np.random.default_rng(seed)
    router = rng.normal(size=(d, E)) / np.sqrt(d)
    if tie:
        router[:, 2] = router[:, 1]
    w = dict(router=router, w_gate=rng.normal(size=(E, d, f)) / np.sqrt(d),
             w_up=rng.normal(size=(E, d, f)) / np.sqrt(d),
             w_down=rng.normal(size=(E, f, d)) / np.sqrt(f))
    w = {k: v.astype(np.float32) for k, v in w.items()}
    return (moe.MoEParams(**{k: _t(v) for k, v in w.items()}),
            jmoe.MoEParams(**{k: jnp.asarray(v) for k, v in w.items()}))


def _dropped(p, cfg, x):
    """Which (token, k) picks the port's dispatch drops: (B, S, K) bool."""
    _, _, idx = moe.route(p, cfg, x)
    B, S, K = idx.shape
    onehot = torch.nn.functional.one_hot(idx, cfg.n_experts).reshape(
        B, S * K, -1)
    pos = (torch.cumsum(onehot, 1) - onehot).reshape(B, S, K, -1)
    slot = torch.take_along_dim(pos, idx[..., None], dim=-1)[..., 0]
    return slot >= moe.capacity(cfg, S)


@pytest.mark.parametrize("capacity_factor", [0.5, 1.0, 8.0])
def test_moe_apply_matches_reference(capacity_factor):
    """y and aux against the reference's, with drops (0.5, 1.0) and
    without (8.0); the top-k indices equal ``lax.top_k``'s."""
    jcfg, cfg = _configs("mixtral-8x7b", d_model=16, d_ff=24,
                         capacity_factor=capacity_factor)
    tp, jp = _layer()
    x = np.random.default_rng(1).normal(size=(2, 40, 16)).astype(np.float32)
    y, aux = moe.moe_apply(tp, cfg, _t(x))
    jy, jaux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MODEL_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **MODEL_TOL)
    probs, gates, idx = moe.route(tp, cfg, _t(x))
    jprobs = jax.nn.softmax(jnp.einsum("bsd,de->bse", jnp.asarray(x),
                                       jp.router), axis=-1)
    jvals, jidx = jax.lax.top_k(jprobs, cfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    drops = int(_dropped(tp, cfg, _t(x)).sum())
    assert (drops > 0) == (capacity_factor < 2.0), drops
    # a token both of whose picks were dropped gets an all-zero row
    zero = ~y.abs().amax(-1).bool()
    np.testing.assert_array_equal(zero.numpy(),
                                  ~np.abs(np.asarray(jy)).max(-1).astype(
                                      bool))
    np.testing.assert_array_equal(
        zero.numpy(), _dropped(tp, cfg, _t(x)).all(-1).numpy())


@pytest.mark.parametrize("capacity_factor", [0.5, 1.0])
def test_tied_router_columns_drop_the_reference_s_tokens(capacity_factor):
    """Two equal router columns: every token ties experts 1 and 2, the
    lower index goes first as in ``lax.top_k``, so the cumsum order and
    the dropped tokens (the all-zero rows of y) are the reference's
    exactly."""
    jcfg, cfg = _configs("mixtral-8x7b", d_model=16, d_ff=24,
                         capacity_factor=capacity_factor)
    tp, jp = _layer(seed=2, tie=True)
    x = np.random.default_rng(3).normal(size=(2, 48, 16)).astype(np.float32)
    probs, _, idx = moe.route(tp, cfg, _t(x))
    assert torch.equal(probs[..., 1], probs[..., 2])
    both = ((idx == 1).any(-1) & (idx == 2).any(-1))
    assert bool(both.any())        # the tie decides the order of the picks
    assert bool((idx[both][:, 0] == 1).all())
    y, aux = moe.moe_apply(tp, cfg, _t(x))
    jy, jaux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    jzero = ~np.abs(np.asarray(jy)).max(-1).astype(bool)
    zero = (~y.abs().amax(-1).bool()).numpy()
    assert zero.any()
    np.testing.assert_array_equal(zero, jzero)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MODEL_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **MODEL_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_leaf_shapes_match_reference(arch):
    cfg = get_smoke(arch)
    want = jax.eval_shape(lambda: JR.init_params(jax.random.PRNGKey(0),
                                                 jget_smoke(arch)))
    got = R.init_params(0, cfg, **CPU)
    shapes = tree_map(lambda t: tuple(t.shape), got)
    assert shapes == jax.tree.map(
        lambda s: None if s is None else tuple(s.shape), want,
        is_leaf=lambda s: s is None)
    assert moe.param_shapes(cfg) == shapes
    std = 1.0 / np.sqrt(cfg.d_model)
    router = got.blocks.moe.router
    assert float(router.abs().max()) <= 2 * std * (1 + 1e-6)
    assert not got.blocks.ln2.any()
    again = R.init_params(torch.Generator().manual_seed(0), cfg, **CPU)
    assert torch.equal(again.blocks.moe.w_down, got.blocks.moe.w_down)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_hidden_and_aux_match_reference(arch):
    jcfg, cfg = _configs(arch)
    jp, tp = _weights(arch)
    jb = JR.demo_batch(jcfg, batch=2, seq=24, seed=1)
    tb = R.demo_batch(cfg, batch=2, seq=24, seed=1, **CPU)
    got, aux = R.forward_logits(tp, cfg, tb)
    want, jaux = JR.forward_logits(jp, jcfg, jb)
    assert got.shape == (2, 24, cfg.vocab) and aux.dim() == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **MODEL_TOL)
    hid, haux = moe.apply(tp, cfg, tb["tokens"], return_hidden=True)
    jhid, jhaux = jmoe.apply(jp, jcfg, jb["tokens"], return_hidden=True)
    assert hid.shape == (2, 24, cfg.d_model)
    np.testing.assert_allclose(hid.numpy(), np.asarray(jhid), **MODEL_TOL)
    np.testing.assert_allclose(float(haux), float(jhaux), **MODEL_TOL)


WINDOW_CASES = {"full": {}, "ring_wraps": {"sliding_window": 8}}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("window", WINDOW_CASES)
def test_prefill_decode_matches_full_forward(arch, window):
    """Prefill of 16 tokens plus 4 teacher-forced decode steps against the
    full forward on all 20, drop-free (the smoke configs' capacity factor
    is 8); with ``sliding_window = 8`` the ring wraps."""
    _, cfg = _configs(arch, **WINDOW_CASES[window])
    _, tp = _weights(arch)
    S, extra = 16, 4
    tb = R.demo_batch(cfg, batch=2, seq=S + extra, seed=2, **CPU)
    full, _ = R.forward_logits(tp, cfg, tb)
    lpre, cache = R.prefill(tp, cfg, {"tokens": tb["tokens"][:, :S]},
                            S + extra, kv_dtype=torch.float32)
    assert cache.kv.k.shape[2] == T.cache_capacity(cfg, S + extra)
    np.testing.assert_allclose(lpre.numpy(), full[:, :S].numpy(),
                               **DECODE_TOL)
    for t in range(extra):
        tok = tb["tokens"][:, S + t:S + t + 1]
        lt, cache = R.decode_step(tp, cfg, cache, tok, S + t)
        np.testing.assert_allclose(lt[:, 0].numpy(), full[:, S + t].numpy(),
                                   **DECODE_TOL)


@pytest.mark.parametrize("window", WINDOW_CASES)
def test_prefill_cache_and_decode_match_reference(window):
    """The prefill's cache in the reference's layout (positions and slots
    exactly, keys and values to the model tolerance) and its logits, then
    decode steps' logits, against the reference's."""
    arch = "mixtral-8x7b"
    jcfg, cfg = _configs(arch, **WINDOW_CASES[window])
    jp, tp = _weights(arch)
    S = 12
    jb = JR.demo_batch(jcfg, batch=2, seq=S + 3, seed=5)
    tb = R.demo_batch(cfg, batch=2, seq=S + 3, seed=5, **CPU)
    jl, jc = JR.prefill(jp, jcfg, {"tokens": jb["tokens"][:, :S]}, S + 3,
                        kv_dtype=jnp.float32)
    tl, tc = R.prefill(tp, cfg, {"tokens": tb["tokens"][:, :S]}, S + 3,
                       kv_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    np.testing.assert_array_equal(tc.kv.kpos.numpy(), np.asarray(jc.kv.kpos))
    for name in ("k", "v"):
        got, want = getattr(tc.kv, name), np.asarray(getattr(jc.kv, name))
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy() == 0, want == 0)
        np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)
    for t in range(S, S + 3):
        jl, jc = JR.decode_step(jp, jcfg, jc, jb["tokens"][:, t:t + 1],
                                jnp.asarray(t, jnp.int32))
        tl, tc = R.decode_step(tp, cfg, tc, tb["tokens"][:, t:t + 1], t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    np.testing.assert_array_equal(tc.kv.kpos.numpy(), np.asarray(jc.kv.kpos))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _by_path(ref_tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    return {_path_str(p): np.asarray(x) for p, x in flat}


def _close_by_leaf(got: dict, want: dict, rel):
    for k, w in want.items():
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got[k], w, rtol=0.0,
                                   atol=rel * max(scale, 1e-30), err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradient_match_reference(arch):
    """The loss (nll + 0.01 aux) and every gradient leaf, the router's
    included, against ``jax.value_and_grad`` of the reference's."""
    jcfg, cfg = _configs(arch)
    jp, tp = _weights(arch)
    jb = JR.demo_batch(jcfg, 4, 16, seed=4)
    tb = {k: _t(v) for k, v in jb.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JR.loss_fn(p, jcfg, b), has_aux=True))(jp, jb)
    live = tree_map(lambda p: p.clone().requires_grad_(True), tp)
    tl, tm = R.loss_fn(live, cfg, tb)
    tg = torch.autograd.grad(tl, leaves(live))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tl.detach()),
                               float(tm["nll"]) + 0.01 * float(tm["aux"]),
                               rtol=1e-6)
    got = {p: g.numpy() for (p, _), g in zip(leaves_with_path(tp), tg)}
    want = _by_path(jg)
    assert sorted(got) == sorted(want)
    _close_by_leaf(got, want, 1e-5)
    assert float(np.abs(got["blocks/moe/router"]).max()) > 0


TC = dict(param_dtype="float32", compute_dtype="float32",
          accum_dtype="float32", learning_rate=1e-2, remat="none",
          grad_clip=1.0)


# SGDM: AdamW's first steps move every element by about lr whatever the
# size of its gradient, so an element whose gradient is rounding noise
# (the smoke model's idle experts have many) moves by +-lr in either
# package, and the routing of the next step then flips on near-ties
STEP_CASES = {"m1": dict(microbatches=1, optimizer="sgdm"),
              "m2_outside_remat": dict(microbatches=2, accum_mode="outside",
                                       remat="full", optimizer="sgdm")}


@pytest.mark.parametrize("case", STEP_CASES)
def test_train_step_matches_reference(case):
    """Three SGDM steps from step 150 on SyntheticTokens batches, from the
    same weights and zero state, as
    ``tests/test_torch_train.py::test_train_step_matches_reference``
    holds the dense model: loss, gradient norm and lr to rtol 1e-5 (the
    port's ``aux`` against the mean of the reference's loss_fn aux over
    the same microbatches);
    parameters within 1% of each leaf's largest movement, moments to 1e-4
    of their largest."""
    arch = "mixtral-8x7b"
    kw = {**TC, **STEP_CASES[case]}
    tc_j, tc_t = JTrainConfig(**kw), TrainConfig(**kw)
    jcfg, cfg = _configs(arch)
    jp, tp = _weights(arch)
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
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        M = tc_t.microbatches
        jaux = np.mean([float(JR.loss_fn(js.params, jcfg, {
            k: v.reshape(M, -1, *v.shape[1:])[m]
            for k, v in jb.items()})[1]["aux"]) for m in range(M)])
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, {k: _t(v) for k, v in b.items()})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=f"{k} at {s}")
        np.testing.assert_allclose(float(tm["aux"]), jaux, rtol=1e-5)
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
            assert float(np.abs(moved).max()) > 0, k
        elif k.startswith("opt/") and k != "opt/step":
            np.testing.assert_allclose(
                got[k], w, rtol=0.0, atol=1e-4 * float(np.abs(w).max()),
                err_msg=k)


def test_train_state_checkpoint_round_trip(tmp_path):
    """A MoE training state (Adafactor, error feedback on) saved and
    restored bitwise, its keys the reference's ``_path_str`` keys."""
    cfg = get_smoke("mixtral-8x7b")
    kw = dict(param_dtype="float32", compute_dtype="float32",
              optimizer="adafactor", compress_grads=True)
    state = init_state(0, cfg, TrainConfig(**kw), **CPU)
    state, _ = make_train_step(cfg, TrainConfig(**kw))(
        state, {k: _t(v) for k, v in SyntheticTokens(
            vocab=cfg.vocab, seq_len=8, global_batch=2).batch_at(0).items()})
    save_checkpoint(str(tmp_path), 1, state)
    like = tree_map(torch.zeros_like, state)
    back = restore_checkpoint(str(tmp_path), 1, like, **CPU)
    for (p, a), (_, b) in zip(leaves_with_path(state),
                              leaves_with_path(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    ref = jax.eval_shape(lambda: jts.init_state(
        jax.random.PRNGKey(0), jget_smoke("mixtral-8x7b"),
        JTrainConfig(**kw)))
    assert sorted(p for p, _ in leaves_with_path(state)) == sorted(
        _by_path(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), ref)))


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_launchers_run_mixtral_smoke(tmp_path, capsys):
    from repro_torch.launch import serve, train
    serve.main(["--arch", "mixtral-8x7b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "8", "--tokens", "6"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "arch=mixtral-8x7b-smoke batch=2"
    assert re.fullmatch(r"prefill 8 tok: \d+\.\d\ds; decode 6 tok: "
                        r"\d+\.\d\ds \(\d+\.\d tok/s\)", lines[1]), lines[1]
    assert re.fullmatch(r"first sequence: \[[\d ]+\] \.\.\.", lines[2])
    argv = ["--arch", "mixtral-8x7b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--microbatches", "2",
            "--save-every", "2", "--ckpt", str(tmp_path / "ck")]
    run = train.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "arch: mixtral-8x7b-smoke" in out and "step    2  loss" in out
    assert out.rstrip().endswith("done")
    assert np.isfinite(run.losses + run.grad_norms).all()
    run2 = train.main(argv + ["--steps", "4"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert run2.start == 3 and int(run2.state.step) == 4
