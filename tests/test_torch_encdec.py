"""The port's encoder-decoder family (``repro_torch.models.encdec``,
whisper) against the reference's (``repro.models.encdec``) on the CPU in
float32, smoke config (2 + 2 layers, 64 frames): the sinusoidal
positions, the forward and the decoder's hidden states with and without
remat, prefill and decode and their caches, the loss and its gradients,
each optimizer's step and a checkpoint, and both launchers.  Weights are
the reference's random init carried across by ``params_from_numpy``;
inputs come from ``np.random.default_rng``.

Tolerances: the position tables within 1 ulp (float32 ``sin`` and
``cos`` of the same angles; the angles themselves bitwise); logits,
hidden states and the caches to rtol = atol = 1e-5; prefill plus decode
against the full forward to 2e-3; the loss to rtol 1e-5 and each
gradient leaf to 1e-4 of that leaf's max |g|."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _path_str
from repro.configs import get_smoke as jget_smoke
from repro.models import encdec as jed
from repro.models import registry as JR
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke
from repro_torch.configs.base import TrainConfig
from repro_torch.data import SyntheticTokens
from repro_torch.launch.train import batch_at
from repro_torch.models import encdec
from repro_torch.models import registry as R
from repro_torch.models.convert import params_from_numpy
from repro_torch.train.train_step import init_state, make_train_step
from repro_torch.tree import leaves, leaves_with_path, tree_map

CPU = dict(device="cpu")
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
ARCH = "whisper-tiny"


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


def _batches(B, S, seed):
    jb = JR.demo_batch(jget_smoke(ARCH), B, S, seed=seed)
    tb = R.demo_batch(get_smoke(ARCH), B, S, seed=seed, **CPU)
    return jb, tb


def _head(b, S):
    """The prompt of a batch: its first S tokens and all its frames."""
    return {"tokens": b["tokens"][:, :S], "frames": b["frames"]}


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------

# whisper-tiny's encoder (1500 frames of 384), the smoke config's, an odd
# width and a long table
TABLES = [(1500, 384), (64, 64), (9, 10), (4096, 2560)]


@pytest.mark.parametrize("S,d", TABLES)
def test_sinusoidal_matches_reference(S, d):
    got = encdec.sinusoidal(S, d).numpy()
    want = np.asarray(jed.sinusoidal(S, d))
    assert got.shape == want.shape == (S, d // 2 * 2)
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    for pos in (0, 1, S // 2, S - 1, 3 * S):
        row = encdec.sinusoidal_at(pos, d, torch.float32).numpy()
        np.testing.assert_array_max_ulp(
            row, np.asarray(jed.sinusoidal_at(jnp.asarray(pos, jnp.int32),
                                              d, jnp.float32)), maxulp=1)
    np.testing.assert_array_equal(encdec.sinusoidal_at(S - 1, d,
                                                       torch.float32),
                                  encdec.sinusoidal(S, d)[-1])
    assert encdec.sinusoidal(S, d, torch.bfloat16).dtype == torch.bfloat16


def test_inverse_frequencies_are_the_reference_s_bitwise():
    """The angles' divisors, ``10000 ** (2 i / d)``, bitwise (float32
    ``torch.pow`` is one ulp off at d = 384, i = 80)."""
    for d in (64, 384, 2560):
        dim = jnp.arange(d // 2, dtype=jnp.float32)
        np.testing.assert_array_equal(
            encdec._inv_freq(d, None).numpy(),
            np.asarray(jnp.power(10_000.0, 2.0 * dim / d)))


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
    assert encdec.param_shapes(cfg) == shapes and got.unembed is None
    for zero in (got.enc_blocks.ln1, got.dec_blocks.ln_x, got.enc_ln_f):
        assert not zero.any()
    std = 1.0 / np.sqrt(cfg.d_model)
    wq = got.dec_blocks.cross_attn.wq
    assert float(wq.abs().max()) <= 2 * std * (1 + 1e-6)
    assert 0.8 * std < float(wq.std()) < 0.95 * std
    again = R.init_params(torch.Generator().manual_seed(0), cfg, **CPU)
    assert torch.equal(again.dec_blocks.mlp.w_down, got.dec_blocks.mlp.w_down)


def test_convert_round_trip():
    jp, tp = _weights()
    want = _by_path(jp)
    got = {p: t.numpy() for p, t in leaves_with_path(tp)}
    assert sorted(got) == sorted(want)
    assert "dec_blocks/cross_attn/wk" in got and "enc_blocks/attn/wo" in got
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_forward_logits_and_hidden_match_reference():
    jcfg, cfg = jget_smoke(ARCH), get_smoke(ARCH)
    jp, tp = _weights()
    jb, tb = _batches(2, 24, seed=1)
    np.testing.assert_array_equal(tb["frames"].numpy(),
                                  np.asarray(jb["frames"]))
    got, aux = R.forward_logits(tp, cfg, tb)
    want, _ = JR.forward_logits(jp, jcfg, jb)
    assert got.shape == (2, 24, cfg.vocab) and aux == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    hid = encdec.apply(tp, cfg, tb["tokens"], tb["frames"],
                       return_hidden=True)
    jhid = jed.apply(jp, jcfg, jb["tokens"], jb["frames"],
                     return_hidden=True)
    assert hid.shape == (2, 24, cfg.d_model)
    np.testing.assert_allclose(hid.numpy(), np.asarray(jhid), **MODEL_TOL)
    enc = encdec.encode(tp, cfg, tb["frames"])
    np.testing.assert_allclose(
        enc.numpy(), np.asarray(jed.encode(jp, jcfg, jb["frames"])),
        **MODEL_TOL)


def test_remat_full_equals_none():
    cfg = get_smoke(ARCH)
    _, tp = _weights()
    _, tb = _batches(2, 16, seed=3)
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


def test_frames_take_the_parameters_dtype():
    """float32 frames against bfloat16 weights: the encoder runs in
    bfloat16 (PyTorch's matmul takes no mixed dtypes)."""
    cfg = get_smoke(ARCH)
    _, tp = _weights()
    _, tb = _batches(2, 8, seed=7)
    p16 = tree_map(lambda t: t.bfloat16(), tp)
    logits, _ = R.forward_logits(p16, cfg, tb)
    assert logits.dtype == torch.bfloat16 and torch.isfinite(logits).all()


def _cache_close(tc, jc):
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
    """Prefill of 12 tokens over the frames and 6 decode steps: logits and
    every cache leaf (the decoder ring, ``cross_k``, ``cross_v``) against
    the reference's."""
    jcfg, cfg = jget_smoke(ARCH), get_smoke(ARCH)
    jp, tp = _weights()
    S, T_ = 12, 18
    jb, tb = _batches(2, T_, seed=5)
    jl, jc = JR.prefill(jp, jcfg, _head(jb, S), T_, kv_dtype=jnp.float32)
    tl, tc = R.prefill(tp, cfg, _head(tb, S), T_, kv_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    _cache_close(tc, jc)
    assert tc.cross_k.shape == (cfg.n_layers, 2, cfg.encoder_seq,
                                cfg.n_kv_heads, cfg.head_dim)
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


def test_prefill_decode_matches_full_forward():
    cfg = get_smoke(ARCH)
    _, tp = _weights()
    S, T_ = 16, 24
    _, tb = _batches(2, T_, seed=2)
    full, _ = R.forward_logits(tp, cfg, tb)
    lpre, cache = R.prefill(tp, cfg, _head(tb, S), T_, kv_dtype=torch.float32)
    np.testing.assert_allclose(lpre.numpy(), full[:, :S].numpy(),
                               **DECODE_TOL)
    cross = cache.cross_k.clone()
    for t in range(S, T_):
        lt, cache = R.decode_step(tp, cfg, cache, tb["tokens"][:, t:t + 1],
                                  t)
        np.testing.assert_allclose(lt[:, 0].numpy(), full[:, t].numpy(),
                                   **DECODE_TOL)
    assert torch.equal(cache.cross_k, cross)
    assert torch.equal(cache.self_kv.kpos[0],
                       torch.arange(T_, dtype=torch.int32))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_loss_and_gradient_match_reference():
    jcfg, cfg = jget_smoke(ARCH), get_smoke(ARCH)
    jp, tp = _weights()
    jb = JR.demo_batch(jcfg, 4, 16, seed=4)
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
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0.0,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=k)
    for name in ("enc_blocks/attn/wq", "dec_blocks/cross_attn/wk",
                 "enc_ln_f"):
        assert float(np.abs(got[name]).max()) > 0, name


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
def test_train_step_and_checkpoint(tmp_path, name):
    """A training step on the launcher's batch (tokens and frames) in two
    microbatches with each optimizer changes every parameter; the state
    saves and restores bitwise under the reference's key names."""
    cfg = get_smoke(ARCH)
    tc = TrainConfig(param_dtype="float32", compute_dtype="float32",
                     optimizer=name, learning_rate=1e-2, microbatches=2)
    # past the learning-rate warmup, whose step 0 has lr 0
    state = init_state(0, cfg, tc, **CPU)._replace(
        step=torch.tensor(150, dtype=torch.int32))
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=12, global_batch=4)
    batch = batch_at(data, cfg, 0, torch.device("cpu"))
    assert batch["frames"].shape == (4, cfg.encoder_seq, cfg.d_model)
    new, m = make_train_step(cfg, tc)(state, batch)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    same = [p for (p, a), b in zip(leaves_with_path(new.params),
                                   leaves(state.params)) if torch.equal(a, b)]
    assert not same, same
    save_checkpoint(str(tmp_path), 1, new)
    back = restore_checkpoint(str(tmp_path), 1,
                              tree_map(torch.zeros_like, new), **CPU)
    for (p, a), (_, b) in zip(leaves_with_path(new), leaves_with_path(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    assert sorted(p[len("params/"):] for p, _ in leaves_with_path(new)
                  if p.startswith("params/")) == sorted(_by_path(_weights()[0]))


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_launchers_run_whisper_smoke(tmp_path, capsys):
    from repro_torch.launch import serve, train
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                "2", "--prompt-len", "8", "--tokens", "6"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "arch=whisper-tiny-smoke batch=2"
    assert re.fullmatch(r"prefill 8 tok: \d+\.\d\ds; decode 6 tok: "
                        r"\d+\.\d\ds \(\d+\.\d tok/s\)", lines[1]), lines[1]
    assert re.fullmatch(r"first sequence: \[[\d ]+\] \.\.\.", lines[2])
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--microbatches", "2", "--save-every", "2",
            "--ckpt", str(tmp_path / "ck")]
    run = train.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "arch: whisper-tiny-smoke" in out and "step    2  loss" in out
    assert out.rstrip().endswith("done")
    assert np.isfinite(run.losses + run.grad_norms).all()
    run2 = train.main(argv + ["--steps", "4"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert run2.start == 3 and int(run2.state.step) == 4
