"""The port's training path (``repro_torch.train``, ``models.registry.
loss_fn``, ``data``, ``launch.train``) against the reference's on the CPU,
smoke configs, float32, inputs from ``np.random.default_rng``; both
packages start from the reference's weights (carried across by
``params_from_numpy``) and from zero optimizer state.

Tolerances: the optimizers, clipping, the global norm, the schedule and
the compression to rtol 1e-6 (quantized codes exactly); the loss to rtol
1e-5 and each gradient leaf to 1e-5 of that leaf's max |g|; attention's
gradient against ``jax.vjp`` of the reference's ``flash_attention`` to
1e-5 of each gradient's max |g|; three training steps to rtol 1e-5 in
loss and gradient norm, the parameters, moments and error-feedback
residuals as the comment above ``STEP_CASES`` says;
``remat="full"`` against ``"none"`` and the token stream bitwise."""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _path_str
from repro.configs import get_smoke as jget_smoke
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.models import registry as JR
from repro.models.flash import flash_attention
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import get_smoke
from repro_torch.configs.base import TrainConfig
from repro_torch.data import SyntheticTokens
from repro_torch.models import layers as L
from repro_torch.models import registry as R
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import TrainState, make_train_step
from repro_torch.tree import leaves, leaves_with_path, tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")
OPT_TOL = dict(rtol=1e-6, atol=0.0)
TC = dict(param_dtype="float32", compute_dtype="float32",
          accum_dtype="float32", learning_rate=1e-2, remat="none",
          grad_clip=1.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _by_path(ref_tree) -> dict:
    """The reference tree's leaves by ``_path_str``, as numpy arrays."""
    flat = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    return {_path_str(p): np.asarray(x) for p, x in flat}


def _port_by_path(tree) -> dict:
    return {p: x.detach().float().numpy() if x.is_floating_point()
            else x.numpy() for p, x in leaves_with_path(tree)}


# ---------------------------------------------------------------------------
# optimizers, clipping, schedule
# ---------------------------------------------------------------------------

SHAPES = {"a": (7,), "b": (4, 5), "c": (2, 3, 6), "s": ()}


def _opt_tree(rng, scale=1.0):
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
def test_optimizer_updates_match_reference(name, state_dtype):
    """Three updates on identical parameters and gradients (the first at
    the config's learning rate, the others at a scheduled 0-d one); every
    parameter and state leaf to rtol 1e-6.  A bf16 state holds the same
    float32 arithmetic rounded to bf16."""
    tc = dict(optimizer=name, learning_rate=3e-2, weight_decay=0.1,
              opt_state_dtype=state_dtype)
    jtc, ttc = JTrainConfig(**tc), TrainConfig(**tc)
    rng = np.random.default_rng(0)
    p = _opt_tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, p), tree_map(_t, p)
    js, ts = jopt.init(jp, jtc), opt.init(tp, ttc)
    jupdate = jax.jit(jopt.update, static_argnums=(3,))
    for i in range(3):
        g = _opt_tree(rng, scale=10.0 ** (i - 1))
        lr = None if i == 0 else 1e-2 * (i + 1)
        jp, js = jupdate(jax.tree.map(jnp.asarray, g), js, jp, jtc,
                         None if lr is None else jnp.float32(lr))
        tp, ts = opt.update(tree_map(_t, g), ts, tp, ttc,
                            None if lr is None else torch.tensor(
                                lr, dtype=torch.float32))
    want, got = _by_path((jp, js)), _port_by_path((tp, ts))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k], np.float32),
                                   err_msg=k, **OPT_TOL)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 3


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_and_global_norm_match_reference(max_norm):
    rng = np.random.default_rng(1)
    g = _opt_tree(rng, scale=3.0)
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                      max_norm)
    tc_, tn = opt.clip_by_global_norm(tree_map(_t, g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), **OPT_TOL)
    np.testing.assert_allclose(float(opt.global_norm(tree_map(_t, g))),
                               float(jopt.global_norm(g)), **OPT_TOL)
    want, got = _by_path(jc), _port_by_path(tc_)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **OPT_TOL)


def test_lr_schedule_matches_reference():
    tc = dict(learning_rate=3e-4)
    for step in (0, 1, 50, 99, 100, 150, 5000, 9999, 10_000, 12_000):
        want = float(jopt.lr_schedule(JTrainConfig(**tc),
                                      jnp.int32(step)))
        got = opt.lr_schedule(TrainConfig(**tc),
                              torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, **OPT_TOL)
    assert float(opt.lr_schedule(TrainConfig(**tc),
                                 torch.tensor(0, dtype=torch.int32))) == 0.0


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def test_quantize_int8_matches_reference():
    """Random values and exact halves (scale 1 with amax 127): codes equal,
    rounded half to even as ``jnp.round`` rounds."""
    rng = np.random.default_rng(2)
    for x in (rng.normal(size=(33, 7)).astype(np.float32),
              np.array([127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 3.5, 126.5],
                       np.float32)):
        jq, js = jcomp.quantize_int8(jnp.asarray(x))
        tq, ts = comp.quantize_int8(_t(x))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(float(ts), float(js), **OPT_TOL)
        np.testing.assert_allclose(
            comp.dequantize_int8(tq, ts).numpy(),
            np.asarray(jcomp.dequantize_int8(jq, js)), **OPT_TOL)
    q, _ = comp.quantize_int8(_t(np.array([127.0, 0.5, 1.5, 2.5],
                                          np.float32)))
    assert q.tolist() == [127, 0, 2, 2]


def test_ef_compress_grads_matches_reference():
    rng = np.random.default_rng(3)
    jres = jax.tree.map(jnp.zeros_like, _opt_tree(rng))
    tres = tree_map(torch.zeros_like, tree_map(_t, _opt_tree(rng)))
    for _ in range(3):
        g = _opt_tree(rng)
        jg, jres = jcomp.ef_compress_grads(jax.tree.map(jnp.asarray, g),
                                           jres)
        tg, tres = comp.ef_compress_grads(tree_map(_t, g), tres)
        for want, got in ((_by_path(jg), _port_by_path(tg)),
                          (_by_path(jres), _port_by_path(tres))):
            for k in want:
                np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                           rtol=1e-6, atol=1e-7)


PSUM_RANK = textwrap.dedent("""
    import datetime, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.train.compression import compressed_psum

    rank, world, store, out = sys.argv[1:5]
    rank, world = int(rank), int(world)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    x = np.random.default_rng(10 + rank).normal(size=(5, 9)) * (rank + 1)
    y = compressed_psum(torch.as_tensor(x, dtype=torch.float32))
    np.save(out + f".{rank}.npy", y.numpy())
    dist.destroy_process_group()
""")


def test_compressed_psum_over_two_gloo_ranks(tmp_path):
    """Two gloo ranks, one subprocess each, against the reference's
    ``compressed_psum`` over a vmapped axis of the same two inputs."""
    world = 2
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (os.path.join(ROOT, "src"),
                               os.environ.get("PYTHONPATH")) if p))
    store, out = str(tmp_path / "store"), str(tmp_path / "y")
    procs = [subprocess.Popen(
        [sys.executable, "-c", PSUM_RANK, str(r), str(world), store, out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=60)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    xs = np.stack([(np.random.default_rng(10 + r).normal(size=(5, 9))
                    * (r + 1)).astype(np.float32) for r in range(world)])
    want = jax.vmap(lambda x: jcomp.compressed_psum(x, "i"),
                    axis_name="i")(jnp.asarray(xs))
    for r in range(world):
        np.testing.assert_allclose(np.load(out + f".{r}.npy"),
                                   np.asarray(want[r]), **OPT_TOL)


# ---------------------------------------------------------------------------
# loss, gradients, attention
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _weights(arch):
    jp = JR.init_params(jax.random.PRNGKey(0), jget_smoke(arch),
                        jnp.float32)
    return jp, params_from_numpy(get_smoke(arch), _np_tree(jp), **CPU)


def _batches(arch, seed=4, B=4, S=16):
    jb = JR.demo_batch(jget_smoke(arch), B, S, seed=seed)
    return jb, {k: _t(v) for k, v in jb.items()}


def _close_by_leaf(got: dict, want: dict, rel):
    for k, w in want.items():
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got[k], w, rtol=0.0,
                                   atol=rel * max(scale, 1e-30),
                                   err_msg=k)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "internvl2-1b"])
def test_loss_and_gradient_match_reference(arch):
    jp, tp = _weights(arch)
    jb, tb = _batches(arch)
    cfg = get_smoke(arch)
    jcfg = jget_smoke(arch)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JR.loss_fn(p, jcfg, b), has_aux=True))(jp, jb)
    live = tree_map(lambda p: p.clone().requires_grad_(True), tp)
    tl, tm = R.loss_fn(live, cfg, tb)
    tg = torch.autograd.grad(tl, leaves(live))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]),
                               rtol=1e-5)
    got = {p: g.numpy() for (p, _), g in zip(leaves_with_path(tp), tg)}
    want = _by_path(jg)
    assert sorted(got) == sorted(want)
    _close_by_leaf(got, want, 1e-5)


# (B, S, H, KH, D, window): causal and windowed, G = 2 and 3, in chunks
# of 8 so the reference takes its flash path (4 query chunks)
FLASH_CASES = {
    "causal_g2": (2, 32, 4, 2, 8, 0),
    "causal_g3": (1, 32, 6, 2, 16, 0),
    "window_g2": (2, 32, 4, 2, 8, 11),
    "window_g3": (1, 32, 6, 2, 16, 5),
}


@pytest.mark.parametrize("case", FLASH_CASES)
def test_attention_gradient_matches_flash_attention(case):
    """The port's attention gradient (SDPA's backward) against ``jax.vjp``
    of the reference's ``flash_attention`` (its triangle-scheduled
    custom_vjp) on the same cotangent."""
    B, S, H, KH, D, window = FLASH_CASES[case]
    G = H // KH
    rng = np.random.default_rng(5)
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KH, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KH, D)).astype(np.float32)
    do = rng.normal(size=(B, S, H, D)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)

    def ref(q_, k_, v_):
        out = flash_attention(q_.reshape(B, S, KH, G, D), k_, v_,
                              jnp.asarray(pos), jnp.asarray(pos), True,
                              window, 8, 8)
        return out.reshape(B, S, H, D)

    want, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    wq, wk, wv = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    tpos = _t(pos)
    out = L.attention(tq, tk, tv, tpos, tpos, causal=True, window=window)
    gq, gk, gv = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    _close_by_leaf({"out": out.detach().numpy(), "dq": gq.numpy(),
                    "dk": gk.numpy(), "dv": gv.numpy()},
                   {"out": np.asarray(want), "dq": np.asarray(wq),
                    "dk": np.asarray(wk), "dv": np.asarray(wv)}, 1e-5)


def test_remat_full_gradients_bitwise_equal_none():
    _, tp = _weights("qwen2-0.5b")
    _, tb = _batches("qwen2-0.5b")
    cfg = get_smoke("qwen2-0.5b")
    grads = {}
    for remat in ("none", "full", "selective"):
        live = tree_map(lambda p: p.clone().requires_grad_(True), tp)
        loss, _ = R.loss_fn(live, cfg, tb, remat=remat)
        grads[remat] = (loss, torch.autograd.grad(loss, leaves(live)))
    for remat in ("full", "selective"):
        assert torch.equal(grads[remat][0], grads["none"][0])
        for a, b in zip(grads[remat][1], grads["none"][1]):
            assert torch.equal(a, b), remat
    with pytest.raises(ValueError, match="remat"):
        R.loss_fn(tp, cfg, tb, remat="some")


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

# Parameters after the steps, per leaf: each element within 1% of the
# furthest the reference's own three steps moved any element of that leaf
# (measured: 0.22% under AdamW, 0.43% compressed), and the difference's
# norm within 0.1% of the movement's norm (3.5e-5 and 3.3e-4 measured), so
# a missing or halved update fails wherever it falls.  The compressed cases
# run SGDM.  Between the packages a gradient element that lands within
# rounding of an int8 code boundary can take the neighbouring code, one
# code step apart: of the 72104 elements of the smoke model at most 5 did
# so in three steps.  So ``ef/*`` and ``opt/m`` are held to a tight bound
# (``EF_REL`` of a code step, ``STEP_OPT_REL`` of the leaf's largest
# moment) everywhere but at ``MAX_FLIPS`` elements of the tree, and those
# within ``FLIP_STEPS`` code steps.  A code step is 1/127 of a leaf's
# largest quantized element: for a moment leaf 1/127 of its largest
# moment stands in for it, and as the residual never exceeds half a step,
# ``2 * max|ef|`` for a residual leaf (measured: residuals within 1e-3 of
# a step, flips at 2.00003 max|ef|, moments at 5.1e-3 of max|m|).  The
# gradient norm holds rtol 1e-5 in every case (8.5e-6 measured compressed,
# the same at 1, 3 and 8 threads).
STEP_PARAM_REL = 1e-2
STEP_PARAM_NORM_REL = 1e-3
STEP_OPT_REL = 1e-4
EF_REL = 1e-3
MAX_FLIPS = 16
FLIP_STEPS = 1.25
STEP_CASES = {
    "m1": dict(microbatches=1),
    "m1_compressed": dict(microbatches=1, compress_grads=True,
                          optimizer="sgdm"),
    "m2_inside_compressed": dict(microbatches=2, accum_mode="inside_grad",
                                 compress_grads=True, optimizer="sgdm"),
    "m2_outside": dict(microbatches=2, accum_mode="outside"),
}


def _count_flips(got, want, tight, flip, name) -> int:
    """How many elements of a leaf lie beyond ``tight`` of the reference;
    none may lie beyond ``flip``."""
    d = np.abs(got - want)
    assert float(d.max()) <= flip, (name, float(d.max()), flip)
    return int((d > tight).sum())


def _ref_state(cfg_j, tc_j, jp, step):
    s = jts.init_state(jax.random.PRNGKey(0), cfg_j, tc_j)
    return s._replace(params=jp, opt=jopt.init(jp, tc_j),
                      ef=None if s.ef is None else jax.tree.map(
                          jnp.zeros_like, jp),
                      step=jnp.int32(step))


@pytest.mark.parametrize("case", STEP_CASES)
def test_train_step_matches_reference(case):
    """Three steps from step 150 (past the warmup: the lr at step 0 is 0)
    on SyntheticTokens batches, from the same weights and zero state."""
    arch = "qwen2-0.5b"
    kw = {**TC, **STEP_CASES[case]}
    tc_j, tc_t = JTrainConfig(**kw), TrainConfig(**kw)
    cfg_j, cfg_t = jget_smoke(arch), get_smoke(arch)
    jp, tp = _weights(arch)
    js = _ref_state(cfg_j, tc_j, jp, 150)
    ts = TrainState(params=tp, opt=opt.init(tp, tc_t),
                    ef=tree_map(lambda p: torch.zeros_like(p), tp)
                    if tc_t.compress_grads else None,
                    step=torch.tensor(150, dtype=torch.int32))
    jstep = jax.jit(jts.make_train_step(cfg_j, tc_j))
    tstep = make_train_step(cfg_t, tc_t)
    data = SyntheticTokens(vocab=cfg_t.vocab, seq_len=16, global_batch=4)
    for s in range(150, 153):
        b = data.batch_at(s)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, {k: _t(v) for k, v in b.items()})
        for k in ("loss", "grad_norm", "lr"):
            assert tm[k].dim() == 0
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=f"{k} at {s}")
    assert int(ts.step) == 153
    want, got = _by_path(js), _port_by_path(ts)
    assert sorted(got) == sorted(want)
    before = _by_path(jp)
    flips = 0
    for k, w in want.items():
        if k.startswith("params/"):
            moved = w - before[k[len("params/"):]]
            np.testing.assert_allclose(
                got[k], w, rtol=0.0,
                atol=STEP_PARAM_REL * float(np.abs(moved).max()), err_msg=k)
            assert (np.linalg.norm(got[k] - w)
                    <= STEP_PARAM_NORM_REL * np.linalg.norm(moved)), k
        elif k in ("step", "opt/step"):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        elif k.startswith("ef/"):
            code_step = 2.0 * float(np.abs(w).max())
            flips += _count_flips(got[k], w, EF_REL * code_step,
                                  FLIP_STEPS * code_step, k)
        elif k.startswith("opt/"):
            top = float(np.abs(w).max())
            flips += _count_flips(got[k], w, STEP_OPT_REL * top,
                                  FLIP_STEPS / 127.0 * top, k)
    assert flips <= MAX_FLIPS, flips
    if not tc_t.compress_grads:
        assert flips == 0
    # the state the step was given is not written
    assert torch.equal(tp.embed, params_from_numpy(
        cfg_t, _np_tree(jp), **CPU).embed)


def test_train_step_reads_nothing_back_and_rejects_uneven_splits():
    cfg = get_smoke("qwen2-0.5b")
    tc = TrainConfig(**{**TC, "microbatches": 3})
    _, tp = _weights("qwen2-0.5b")
    st = TrainState(params=tp, opt=opt.init(tp, tc), ef=None,
                    step=torch.tensor(0, dtype=torch.int32))
    b = {k: _t(v) for k, v in SyntheticTokens(
        vocab=cfg.vocab, seq_len=8, global_batch=4).batch_at(0).items()}
    with pytest.raises(ValueError, match="microbatches=3"):
        make_train_step(cfg, tc)(st, b)
    with pytest.raises(ValueError, match="accum_mode"):
        make_train_step(cfg, TrainConfig(**{**TC, "accum_mode": "x"}))


# ---------------------------------------------------------------------------
# data and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1000, 64, 4, 7), (256, 16, 3, 0),
                                   (151936, 33, 2, 5)])
def test_synthetic_tokens_bitwise_equal_reference(shape):
    vocab, seq, batch, seed = shape
    mine = SyntheticTokens(vocab=vocab, seq_len=seq, global_batch=batch,
                           seed=seed)
    ref = JSyntheticTokens(vocab=vocab, seq_len=seq, global_batch=batch,
                           seed=seed)
    for step in (0, 1, 123, 10_000):
        a, b = mine.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "internvl2-1b",
                                  "recurrentgemma-2b", "whisper-tiny"])
def test_launch_train_smoke_and_resume(tmp_path, capsys, arch):
    from repro_torch.launch import train
    ck = str(tmp_path / "ck")
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--microbatches", "2", "--save-every", "2",
            "--ckpt", ck]
    run = train.main(argv + ["--steps", "4"])
    out = capsys.readouterr().out
    assert out.startswith("mesh: ") and f"arch: {arch}-smoke" in out
    assert "step    0  loss" in out and "step    3  loss" in out
    assert out.rstrip().endswith("done")
    assert run.start == 0 and len(run.losses) == 4
    assert np.isfinite(run.losses + run.grad_norms).all()
    assert int(run.state.step) == 4 and run.state.params.embed.dtype == \
        torch.float32
    run2 = train.main(argv + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and out.rstrip().endswith("done")
    assert run2.start == 4 and len(run2.losses) == 2
    assert int(run2.state.step) == 6
    # the production mesh needs 256 ranks; this world has one
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        train.main(argv + ["--production-mesh"])


def test_launch_train_resume_equals_one_run(tmp_path):
    """4 steps, then a resume to 6, end bitwise where 6 steps in one run
    end (the data is replayed by step index)."""
    from repro_torch.launch import train
    base = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "8",
            "--save-every", "3"]
    one = train.main(base + ["--steps", "6", "--ckpt", str(tmp_path / "a")])
    train.main(base + ["--steps", "4", "--ckpt", str(tmp_path / "b")])
    two = train.main(base + ["--steps", "6", "--ckpt", str(tmp_path / "b")])
    for a, b in zip(leaves(one.state), leaves(two.state)):
        assert torch.equal(a, b)
    assert json.load(open(tmp_path / "b" / "step_0000000006" /
                          "manifest.json"))["format"] == "torch/v1"


def test_train_config_is_the_reference_s():
    assert [f.name for f in dataclasses.fields(TrainConfig)] == \
        [f.name for f in dataclasses.fields(JTrainConfig)]
    assert TrainConfig() == TrainConfig(**dataclasses.asdict(JTrainConfig()))
