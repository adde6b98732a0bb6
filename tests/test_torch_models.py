"""The port's LM layers and dense/VLM models (``repro_torch.models``)
against the reference's (``repro.models``) on the CPU in float32, smoke
configs.  Weights are the reference's random init carried across by
``params_from_numpy``; inputs come from ``np.random.default_rng``.

Tolerances: elementwise layers and the cache layout to rtol 1e-6 / atol
1e-6 (bitwise for the cache); attention and model logits and hidden states
to rtol 1e-5 / atol 1e-5 (float32 sums in another order); prefill plus
decode against the full forward to rtol = atol = 2e-3, the reference's own
bound (``tests/test_models_smoke.py``)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, get_smoke as jget_smoke
from repro.models import layers as JL
from repro.models import registry as JR
from repro_torch.configs import get_smoke
from repro_torch.models import layers as L
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy

CPU = dict(device="cpu")
LAYER_TOL = dict(rtol=1e-6, atol=1e-6)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
SERVED = ("qwen2-0.5b", "deepseek-7b", "internvl2-1b")
# the forward test's models: the served ones, the hybrid and the
# encoder-decoder
FORWARD = SERVED + ("recurrentgemma-2b", "whisper-tiny")
# the input beside the tokens that each family's ``apply`` takes
EXTRA = {"vlm": "patches", "encdec": "frames"}


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference's init of ``arch``'s smoke config and the port's copy
    of it (once a module: the reference's init is the slow part)."""
    jp = JR.init_params(jax.random.PRNGKey(0), jget_smoke(arch), jnp.float32)
    return jp, params_from_numpy(get_smoke(arch),
                                 jax.tree.map(np.asarray, jp), **CPU)


def _ref_params(arch, **overrides):
    """Both configs of ``arch`` (with ``overrides``, none of which changes
    a parameter shape) and both parameter trees."""
    return (dataclasses.replace(jget_smoke(arch), **overrides),
            dataclasses.replace(get_smoke(arch), **overrides),
            *_weights(arch))


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32) * 0.1
    for eps in (1e-6, 1e-5):
        np.testing.assert_allclose(
            L.rms_norm(_t(x), _t(scale), eps).numpy(),
            np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), eps)),
            **LAYER_TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 3, 8)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32) + 5
    np.testing.assert_allclose(
        L.rope(_t(x), L.rope_tables(_t(pos), 8, theta)).numpy(),
        np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), theta)),
        **LAYER_TOL)


# (B, Sq, T, H, KH, D, q offset, causal, window): causal and windowed,
# GQA with G = 7 and G = 1, Sq != T, and S = 1024 (two 512-chunks, so
# the reference takes flash_attention)
ATTN_CASES = {
    "causal_g2": (2, 32, 32, 4, 2, 8, 0, True, 0),
    "window_g2": (2, 32, 32, 4, 2, 8, 0, True, 8),
    "causal_g7": (1, 24, 24, 7, 1, 8, 0, True, 0),
    "window_g1": (2, 24, 24, 4, 4, 8, 0, True, 5),
    "full_g1": (1, 16, 16, 4, 4, 8, 0, False, 0),
    "sq_ne_t": (2, 24, 40, 4, 2, 8, 16, True, 0),
    "sq_ne_t_window": (2, 24, 40, 4, 2, 8, 16, True, 6),
    "two_chunks": (1, 1024, 1024, 2, 1, 8, 0, True, 0),
    "two_chunks_window": (1, 1024, 1024, 2, 1, 8, 0, True, 300),
}


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_matches_reference(case):
    B, Sq, T_, H, KH, D, off, causal, window = ATTN_CASES[case]
    rng = np.random.default_rng(2)
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T_, KH, D)).astype(np.float32)
    v = rng.normal(size=(B, T_, KH, D)).astype(np.float32)
    kp = np.arange(T_, dtype=np.int32)
    qp = kp[off:off + Sq] if Sq != T_ else kp
    want = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(qp), jnp.asarray(kp), causal=causal,
                        window=window)
    # the same positions tensor twice (self-attention) and two equal ones
    kpt = _t(kp)
    qpt = kpt if Sq == T_ else _t(qp)
    for qpos in (qpt, qpt.clone()):
        got = L.attention(_t(q), _t(k), _t(v), qpos, kpt, causal=causal,
                          window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MODEL_TOL)


def test_mlp_matches_reference():
    rng = np.random.default_rng(3)
    x, wg, wu, wd = (rng.normal(size=s).astype(np.float32) * 0.3 for s in
                     ((2, 5, 16), (16, 24), (16, 24), (24, 16)))
    got = L.mlp_apply(L.MLPParams(_t(wg), _t(wu), _t(wd)), _t(x))
    want = JL.mlp_apply(JL.MLPParams(*map(jnp.asarray, (wg, wu, wd))),
                        jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("S,capacity", [(6, 10), (10, 10), (23, 8)])
def test_kv_cache_from_prefill_matches_reference(S, capacity):
    rng = np.random.default_rng(4)
    k = rng.normal(size=(2, S, 3, 4)).astype(np.float32)
    v = rng.normal(size=(2, S, 3, 4)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    got = L.kv_cache_from_prefill(_t(k), _t(v), _t(pos), capacity,
                                  torch.float32)
    want = JL.kv_cache_from_prefill(jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(pos), capacity, jnp.float32)
    for name in ("k", "v", "kpos"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


# (H, KH, capacity, filled positions, new position, window, cache dtype):
# G = 2, 7 and 1, empty slots, a ring that wraps under a window, and a
# bfloat16 cache (queries and probabilities cast to it, dots in float32)
DECODE_CASES = {
    "g2": (4, 2, 10, range(6), 6, 0, "float32"),
    "g7": (7, 1, 12, range(9), 9, 0, "float32"),
    "g1_window_wraps": (4, 4, 5, range(4, 9), 9, 5, "float32"),
    "g2_bf16": (4, 2, 10, range(6), 6, 0, "bfloat16"),
}


@pytest.mark.parametrize("case", DECODE_CASES)
def test_attn_decode_matches_reference(case):
    """One decode step against a filled ring cache: the output and the
    updated cache, to the model tolerance in both cache dtypes."""
    H, KH, Tc, filled, pos, window, dt = DECODE_CASES[case]
    B, d, D = 2, 16, 8
    rng = np.random.default_rng(5)
    w = [rng.normal(size=s).astype(np.float32) * 0.3 for s in
         ((d, H, D), (d, KH, D), (d, KH, D), (H, D, d), (H, D), (KH, D),
          (KH, D))]
    x = rng.normal(size=(B, 1, d)).astype(np.float32)
    kc = rng.normal(size=(B, Tc, KH, D)).astype(np.float32)
    vc = rng.normal(size=(B, Tc, KH, D)).astype(np.float32)
    kpos = np.full((Tc,), -1, np.int32)
    for p in filled:
        kpos[p % Tc] = p
    cfg = dataclasses.replace(get_smoke("qwen2-0.5b"), rope_theta=10_000.0)
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    want_y, want_c = JL.attn_decode(
        JL.AttnParams(*map(jnp.asarray, w)), cfg, jnp.asarray(x),
        JL.KVCache(jnp.asarray(kc, jdt), jnp.asarray(vc, jdt),
                   jnp.asarray(kpos)), jnp.int32(pos), window=window)
    got_y, got_c = L.attn_decode(
        L.AttnParams(*map(_t, w)), cfg, _t(x),
        L.KVCache(_t(kc).to(tdt), _t(vc).to(tdt), _t(kpos)), pos,
        L.rope_tables(torch.full((1,), pos, dtype=torch.int32), D,
                      cfg.rope_theta), window=window)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               **MODEL_TOL)
    np.testing.assert_array_equal(got_c.kpos.numpy(),
                                  np.asarray(want_c.kpos))
    for name in ("k", "v"):
        np.testing.assert_allclose(
            getattr(got_c, name).float().numpy(),
            np.asarray(getattr(want_c, name), np.float32), **MODEL_TOL)


@pytest.mark.parametrize("arch", FORWARD)
def test_forward_logits_and_hidden_match_reference(arch):
    jcfg, cfg, jp, tp = _ref_params(arch)
    jb = JR.demo_batch(jcfg, batch=2, seq=24, seed=1)
    tb = R.demo_batch(cfg, batch=2, seq=24, seed=1, **CPU)
    got, aux = R.forward_logits(tp, cfg, tb)
    want, _ = JR.forward_logits(jp, jcfg, jb)
    assert got.shape == (2, 24, cfg.vocab) and aux == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    key = EXTRA.get(cfg.family)
    extra = [tb[key]] if key else []
    jextra = [jb[key]] if key else []
    hid = R.get_module(cfg).apply(tp, cfg, tb["tokens"], *extra,
                                  return_hidden=True)
    jhid = JR.get_module(jcfg).apply(jp, jcfg, jb["tokens"], *jextra,
                                     return_hidden=True)
    assert hid.shape == (2, 24, cfg.d_model)
    np.testing.assert_allclose(hid.numpy(), np.asarray(jhid), **MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_demo_batch_is_the_references_bitwise(arch):
    jb = JR.demo_batch(jget_smoke(arch), batch=3, seq=7, seed=5)
    tb = R.demo_batch(get_smoke(arch), batch=3, seq=7, seed=5, **CPU)
    assert set(tb) == set(jb)
    for key, want in jb.items():
        want = np.asarray(want)
        assert tb[key].numpy().dtype == want.dtype, key
        np.testing.assert_array_equal(tb[key].numpy(), want)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-7b",
                                  "internvl2-1b", "stablelm-12b",
                                  "qwen2.5-3b"])
def test_init_params_leaf_shapes_match_reference(arch):
    cfg = get_smoke(arch)
    want = jax.eval_shape(lambda: JR.init_params(jax.random.PRNGKey(0),
                                                 jget_smoke(arch)))
    got = R.init_params(0, cfg, **CPU)
    assert L.tree_map(lambda t: tuple(t.shape), got) == jax.tree.map(
        lambda s: None if s is None else tuple(s.shape), want,
        is_leaf=lambda s: s is None)
    assert T.param_shapes(cfg) == L.tree_map(lambda t: tuple(t.shape), got)
    # the reference's distributions: zeros for norms and biases, dense
    # weights within 2 std of 1/sqrt(fan_in), embeddings within 2 * 0.02
    blk = got.blocks
    for zero in (blk.ln1, blk.ln2, got.ln_f, blk.attn.bq):
        assert zero is None or not zero.any()
    std = 1.0 / np.sqrt(cfg.d_model)
    assert float(blk.attn.wq.abs().max()) <= 2 * std * (1 + 1e-6)
    assert 0.8 * std < float(blk.attn.wq.std()) < 0.95 * std
    assert float(got.embed.abs().max()) <= 0.04 * (1 + 1e-6)
    # a seed gives the same draws; another seed others
    again = R.init_params(torch.Generator().manual_seed(0), cfg, **CPU)
    assert torch.equal(again.blocks.mlp.w_down, blk.mlp.w_down)
    assert not torch.equal(R.init_params(1, cfg, **CPU).embed, got.embed)


WINDOW_CASES = {"full": {}, "ring_wraps": {"sliding_window": 8}}


@pytest.mark.parametrize("arch", SERVED)
@pytest.mark.parametrize("window", WINDOW_CASES)
def test_prefill_decode_matches_full_forward(arch, window):
    """Prefill of S tokens plus teacher-forced decode steps against the
    full forward on all of them, at the reference's bound (the decode
    logits against the reference's are in ``test_torch_serve.py``).  With
    ``sliding_window = 8`` the cache holds 8 slots, so the ring wraps
    during the prefill and again while decoding."""
    _, cfg, _, tp = _ref_params(arch, **WINDOW_CASES[window])
    S, extra = 16, 4
    tb = R.demo_batch(cfg, batch=2, seq=S + extra, seed=2, **CPU)
    full, _ = R.forward_logits(tp, cfg, tb)
    head = {k: (v[:, :S] if k in ("tokens", "labels") else v)
            for k, v in tb.items()}
    lpre, cache = R.prefill(tp, cfg, head, S + extra, kv_dtype=torch.float32)
    cap = T.cache_capacity(cfg, S + extra)
    assert cache.kv.k.shape[2] == cap
    np.testing.assert_allclose(lpre.numpy(), full[:, :S].numpy(),
                               **DECODE_TOL)
    for t in range(extra):
        tok = tb["tokens"][:, S + t:S + t + 1]
        lt, cache = R.decode_step(tp, cfg, cache, tok, S + t)
        np.testing.assert_allclose(lt[:, 0].numpy(), full[:, S + t].numpy(),
                                   **DECODE_TOL)
    # the ring holds the last ``cap`` positions, each in slot p % cap
    kpos = cache.kv.kpos[0]
    live = torch.arange(S + extra - cap, S + extra, dtype=torch.int32)
    assert torch.equal(kpos[live % cap], live)


def test_init_cache_matches_reference():
    for overrides in ({}, {"sliding_window": 8}):
        jcfg = dataclasses.replace(jget_smoke("qwen2-0.5b"), **overrides)
        cfg = dataclasses.replace(get_smoke("qwen2-0.5b"), **overrides)
        got = R.init_cache(cfg, 3, 20, torch.float32, **CPU)
        want = JR.init_cache(jcfg, 3, 20, jnp.float32)
        for name in ("k", "v", "kpos"):
            np.testing.assert_array_equal(getattr(got.kv, name).numpy(),
                                          np.asarray(getattr(want.kv, name)))


@pytest.mark.parametrize("arch", ARCHS)
def test_every_config_has_a_model(arch):
    """``get_module`` takes every config; the module's ``param_shapes`` are
    the shapes of its ``init_params`` and of the reference's init."""
    cfg = get_smoke(arch)
    mod = R.get_module(cfg)
    got = L.tree_map(lambda t: tuple(t.shape), R.init_params(0, cfg, **CPU))
    want = jax.eval_shape(lambda: JR.init_params(jax.random.PRNGKey(0),
                                                 jget_smoke(arch)))
    assert mod.param_shapes(cfg) == got
    assert got == jax.tree.map(lambda s: None if s is None else
                               tuple(s.shape), want,
                               is_leaf=lambda s: s is None)
