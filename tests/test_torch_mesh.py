"""Real sharding on the CPU: four gloo ranks on a (2, 2) ``("data",
"model")`` host mesh run every family at smoke width, against the
one-process port.

One spawn a module (the ``ranks`` fixture): four subprocesses, a
``FileStore`` under a temporary directory, a timeout of their own.  Each
rank draws the same seeded weights and batches, places them by the
logical-axis rules (``shard_state``, ``shard_batch``) and runs, under
``axis_rules``, the forward, ``TRAIN_STEPS`` ``make_train_step`` steps
for each optimizer case, greedy prefill and decode, and two checkpoint
re-partitions; rank 0 writes the full tensors.

Training starts at step ``START``, past the warmup (the learning rate at
step 0 is 0, and nothing would move).  Tolerances: the forward's logits
to ROADMAP's rtol = atol = 1e-5 (float32 sums in another order on the
shards); each step's loss, gradient norm and learning rate to rtol 1e-5;
after the steps, each parameter leaf within ``PARAM_REL`` of its largest
move from the initial weights, elementwise, and within ``PARAM_NORM_REL``
of that move's norm as a whole; each optimizer moment within
``OPT_REL`` of the leaf's largest value (SGDM's first moment after its
first step is the clipped gradient itself, so this holds the sharded
gradient's scale); error-feedback residuals as ``tests/
test_torch_train.py`` holds them against the reference: within
``EF_REL`` of a code step but at ``MAX_FLIPS`` elements whose int8 code
rounded the other way at a tie, and those within ``FLIP_STEPS`` code
steps.  Two cases may flip, and only they: the compressed one, whose
later gradient norms may move by the norm of ``MAX_FLIPS`` flipped code
steps (measured on the smoke qwen2: 3 flips, 3.6e-5 of the norm), and
AdamW, whose update at an element with a gradient within a few eps of 0
follows the sign of float32 noise (measured on the smoke mixtral: one
element of ``wo`` 8% of its move apart).  Greedy tokens equal;
re-partitioned checkpoints bitwise.
"""

import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import registry as JR
from repro.sharding import spec_for as jspec_for
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ServeConfig, TrainConfig
from repro_torch.models import registry as R
from repro_torch.train.serve_step import greedy_generate
from repro_torch.train.train_step import init_state, make_train_step
from repro_torch.tree import leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TIMEOUT = 300
ARCHS = ("qwen2-0.5b", "internvl2-1b", "mixtral-8x7b", "mamba2-370m",
         "recurrentgemma-2b", "whisper-tiny")
B, S, PROMPT, STEPS = 4, 16, 8, 6
START, TRAIN_STEPS = 100, 2
TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_REL = 1e-2
PARAM_NORM_REL = 1e-3
OPT_REL = 1e-4
EF_REL = 1e-3
MAX_FLIPS = 16
FLIP_STEPS = 1.25
TC = dict(seq_len=S, global_batch=B, microbatches=2, param_dtype="float32",
          compute_dtype="float32", accum_dtype="float32", remat="none",
          learning_rate=1e-3, optimizer="sgdm")
# the optimizer cases beyond SGDM: AdamW's moments, Adafactor's factored
# moments (reduced over dimensions the mesh shards) and int8 error
# feedback (a scale per tensor, the max over every shard)
CASES = {"sgdm": {}, "adamw": dict(optimizer="adamw"),
         "adafactor": dict(optimizer="adafactor"),
         "sgdm_compressed": dict(compress_grads=True)}
# SGDM runs on every family; the other cases on the dense, MoE (3-D
# expert weights, ``moe_ff`` over both axes) and SSM (1-D and conv
# weights) parameter trees, which keeps the file near a minute
CASE_ARCHS = ("qwen2-0.5b", "mixtral-8x7b", "mamba2-370m")
PLAN = {arch: {c: kw for c, kw in CASES.items()
               if c == "sgdm" or arch in CASE_ARCHS} for arch in ARCHS}

RANK_SCRIPT = textwrap.dedent("""
    import datetime, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import sharding as SH
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import ServeConfig, TrainConfig
    from repro_torch.data import shard_batch
    from repro_torch.launch.cost_analysis import CostMode
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry as R
    from repro_torch.train.serve_step import greedy_generate
    from repro_torch.train.train_step import (init_state, make_train_step,
                                              shard_state, state_shardings)
    from repro_torch.tree import leaves_with_path

    rank, store, out, ckpt = sys.argv[1:5]
    archs, tc_kw, plan = (eval(a) for a in sys.argv[5:8])
    B, S, PROMPT, STEPS, START, TRAIN_STEPS = eval(sys.argv[8])
    rank = int(rank)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, {world}), rank=rank,
        world_size={world}, timeout=datetime.timedelta(seconds=60))
    mesh = make_host_mesh(2, 2, device="cpu")
    res = {{}}
    for arch in archs:
        cfg = get_smoke(arch)
        with SH.axis_rules(mesh):
            state = init_state(0, cfg, TrainConfig(**tc_kw), device="cpu")
            dstate = shard_state(state, cfg, mesh)
            hosts = [{{k: v.numpy() for k, v in R.demo_batch(
                cfg, B, S, seed=s, device="cpu").items()}}
                for s in range(TRAIN_STEPS)]
            batches = [shard_batch(h, mesh) for h in hosts]
            r = res[arch] = {{"train": {{}}}}
            r["local"] = {{k: tuple(v.to_local().shape)
                          for k, v in batches[0].items()}}
            with torch.no_grad():
                logits, _ = R.forward_logits(dstate.params, cfg, batches[0])
            r["logits"] = SH.full(logits)
            if arch == archs[0]:
                # the loss's collectives, logits onwards
                lg = logits.detach().requires_grad_(True)
                with CostMode() as cm:
                    logz, gold = R._logz_and_gold_on_shards(
                        lg, batches[0]["labels"].long(),
                        R._vocab_mesh_dims(lg))
                    torch.mean(logz - gold).backward()
                r["loss_comm"] = (cm.cost.collective_bytes,
                                  [repr(p) for p in logits.placements])
            for case, kw in plan[arch].items():
                tc = TrainConfig(**{{**tc_kw, **kw}})
                st = init_state(0, cfg, tc, device="cpu")
                st = shard_state(st._replace(step=torch.tensor(
                    START, dtype=torch.int32)), cfg, mesh)
                step, metrics = make_train_step(cfg, tc), []
                for b in batches:
                    st, m = step(st, b)
                    metrics.append({{k: float(SH.full(m[k]))
                                    for k in ("loss", "grad_norm", "lr")}})
                r["train"][case] = (metrics, {{
                    p: SH.full(t) for p, t in leaves_with_path(st)}})
            prompt = shard_batch({{k: v[:, :PROMPT] if k == "tokens" else v
                                 for k, v in hosts[0].items()
                                 if k != "labels"}}, mesh)
            sc = ServeConfig(seq_len=PROMPT + STEPS, batch=B,
                             param_dtype="float32", compute_dtype="float32",
                             kv_dtype="float32")
            with torch.no_grad():
                r["tokens"] = SH.full(greedy_generate(
                    cfg, sc, dstate.params, prompt, STEPS, device="cpu"))
            if arch == archs[0]:
                # one-device checkpoint -> the mesh, and the mesh -> a file
                back = restore_checkpoint(
                    ckpt, 1, state, shardings=state_shardings(state, cfg,
                                                              mesh))
                r["restored_sharded"] = all(
                    isinstance(t, torch.distributed.tensor.DTensor)
                    for _, t in leaves_with_path(back.params))
                r["restored_equal"] = all(
                    torch.equal(SH.full(a), b) for (_, a), (_, b) in
                    zip(leaves_with_path(back), leaves_with_path(state)))
                save_checkpoint(ckpt, 2, back)
    if rank == 0:
        torch.save(res, out)
    dist.destroy_process_group()
""").format(world=WORLD)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Rank 0's results of the four-rank run, and the checkpoint folder
    (step 1 written here from one device, step 2 by the ranks)."""
    tmp = tmp_path_factory.mktemp("mesh")
    ckpt = str(tmp / "ckpt")
    cfg = get_smoke(ARCHS[0])
    save_checkpoint(ckpt, 1, init_state(0, cfg, TrainConfig(**TC),
                                        device="cpu"))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (os.path.join(ROOT, "src"),
                               os.environ.get("PYTHONPATH")) if p))
    store, out = str(tmp / "store"), str(tmp / "rank0.pt")
    args = [out, ckpt, repr(ARCHS), repr(TC), repr(PLAN),
            repr((B, S, PROMPT, STEPS, START, TRAIN_STEPS))]
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(r), store] + args, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
    return torch.load(out, weights_only=False), ckpt


@functools.lru_cache(maxsize=None)
def _one_process(arch):
    """The one-process port on the same weights and batches: logits, for
    each case its metrics and final state leaves by path, the initial
    parameters by path, and the greedy tokens."""
    cfg = get_smoke(arch)
    batches = [R.demo_batch(cfg, B, S, seed=s, device="cpu")
               for s in range(TRAIN_STEPS)]
    state = init_state(0, cfg, TrainConfig(**TC), device="cpu")
    with torch.no_grad():
        logits, _ = R.forward_logits(state.params, cfg, batches[0])
    train = {}
    for case, kw in PLAN[arch].items():
        tc = TrainConfig(**{**TC, **kw})
        st = init_state(0, cfg, tc, device="cpu")._replace(
            step=torch.tensor(START, dtype=torch.int32))
        step, metrics = make_train_step(cfg, tc), []
        for b in batches:
            st, m = step(st, b)
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                                     "lr")})
        train[case] = (metrics, dict(leaves_with_path(st)))
    prompt = {k: v[:, :PROMPT] if k == "tokens" else v
              for k, v in batches[0].items() if k != "labels"}
    sc = ServeConfig(seq_len=PROMPT + STEPS, batch=B, param_dtype="float32",
                     compute_dtype="float32", kv_dtype="float32")
    with torch.no_grad():
        toks = greedy_generate(cfg, sc, state.params, prompt, STEPS,
                               device="cpu")
    return logits, train, dict(leaves_with_path(state.params)), toks


def _count_flips(got, want, tight, flip, name) -> int:
    """How many elements of a leaf lie beyond ``tight`` of the one-process
    run; none may lie beyond ``flip``."""
    d = np.abs(got - want)
    assert float(d.max()) <= flip, (name, float(d.max()), flip)
    return int((d > tight).sum())


def _check_steps(ranks, arch, case):
    """``case``'s steps on the mesh against one process (module
    docstring): metrics, parameters, moments, residuals, counters."""
    _, train, before, _ = _one_process(arch)
    want_m, want = train[case]
    got_m, got = ranks[0][arch]["train"][case]
    compressed = bool(CASES[case].get("compress_grads"))
    adamw = CASES[case].get("optimizer") == "adamw"
    # the norm a residual's flipped codes may add to a later step's
    # gradient: MAX_FLIPS codes of the largest code step
    code_step = max((2.0 * float(w.abs().max()) for k, w in want.items()
                     if k.startswith("ef/")), default=0.0)
    for s, (g, w) in enumerate(zip(got_m, want_m)):
        for k in ("loss", "grad_norm", "lr"):
            extra = code_step * FLIP_STEPS * MAX_FLIPS ** 0.5 \
                if k == "grad_norm" and s > 0 else 0.0
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=extra,
                                       err_msg=f"{k} at step {s}")
    assert sorted(got) == sorted(want)
    flips = 0
    for k, w in want.items():
        g, w = got[k].numpy(), w.numpy()
        if not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k.startswith("params/"):
            moved = w - before[k[len("params/"):]].numpy()
            top = float(np.abs(moved).max())
            assert top > 0, k
            if adamw:
                # AdamW's first updates are g / (|g| + eps): an element
                # whose gradient lies within a few eps of 0 moves by the
                # sign of float32 noise, so it counts as a flip (at most
                # a move reversed)
                flips += _count_flips(g, w, PARAM_REL * top, 2.0 * top, k)
            else:
                np.testing.assert_allclose(g, w, rtol=0.0,
                                           atol=PARAM_REL * top, err_msg=k)
            assert (np.linalg.norm(g - w)
                    <= PARAM_NORM_REL * np.linalg.norm(moved)), k
        elif k.startswith("ef/"):
            step = 2.0 * float(np.abs(w).max())
            flips += _count_flips(g, w, EF_REL * step, FLIP_STEPS * step, k)
        else:
            top = float(np.abs(w).max())
            flips += _count_flips(g, w, OPT_REL * top,
                                  FLIP_STEPS / 127.0 * top, k)
    assert flips <= MAX_FLIPS, flips
    if not (compressed or adamw):
        assert flips == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_one_process(ranks, arch):
    logits = _one_process(arch)[0]
    np.testing.assert_allclose(ranks[0][arch]["logits"].numpy(),
                               logits.numpy(), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_one_process(ranks, arch):
    """SGDM, the first moment of which is the clipped gradient."""
    _check_steps(ranks, arch, "sgdm")


@pytest.mark.parametrize("case", [c for c in CASES if c != "sgdm"])
@pytest.mark.parametrize("arch", CASE_ARCHS)
def test_optimizer_state_matches_one_process(ranks, arch, case):
    _check_steps(ranks, arch, case)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_one_process(ranks, arch):
    toks = _one_process(arch)[3]
    assert torch.equal(ranks[0][arch]["tokens"], toks)


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_batch_local_shapes_follow_the_reference_specs(ranks, arch):
    """Rank 0's rows of each batch array: the global shape cut by the
    reference's ``spec_for`` on a (2, 2) mesh."""

    class Stub:
        shape = {"data": 2, "model": 2}

    specs = JR.train_input_specs(jget_smoke(arch), _shape())
    host = R.demo_batch(get_smoke(arch), B, S, device="cpu")
    assert sorted(specs) == sorted(host)
    for k, v in host.items():
        assert tuple(specs[k].shape) == tuple(v.shape)
        spec = jspec_for(v.shape, ("batch",) + (None,) * (v.ndim - 1),
                         Stub())
        want = [n // (np.prod([Stub.shape[a] for a in
                               ((e,) if isinstance(e, str) else e)])
                      if e else 1) for n, e in zip(v.shape, spec)]
        assert ranks[0][arch]["local"][k] == tuple(want), k


def _shape():
    from repro.configs.base import ShapeConfig
    return ShapeConfig("mesh_test", "train", S, B)


def test_loss_keeps_the_vocabulary_sharded(ranks):
    """The loss reduces (batch, seq) values over the vocabulary shards,
    forward and backward, and gathers no logits: a handful of (B, S)
    float32 reductions, against one rank's (B/2, S, V/2) logits shard."""
    comm, placements = ranks[0][ARCHS[0]]["loss_comm"]
    assert placements == ["Shard(dim=0)", "Shard(dim=2)"]
    assert comm <= 8 * B * S * 4
    assert comm < (B // 2) * S * (get_smoke(ARCHS[0]).vocab // 2) * 4 / 8


def test_checkpoint_repartitions_bitwise_both_ways(ranks, tmp_path):
    res, ckpt = ranks
    r = res[ARCHS[0]]
    assert r["restored_sharded"] and r["restored_equal"]
    cfg = get_smoke(ARCHS[0])
    state = init_state(0, cfg, TrainConfig(**TC), device="cpu")
    back = restore_checkpoint(ckpt, 2, state, device="cpu")
    for (p, a), (_, b) in zip(leaves_with_path(back),
                              leaves_with_path(state)):
        assert type(a) is torch.Tensor and torch.equal(a, b), p
