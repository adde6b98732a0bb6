"""The port's row-sharded PA-SMO (``repro_torch.core.sharded``) against
``repro.core.sharded`` and the reference's single-device solver, on the
CPU with gloo.

One rank runs in this process, in a one-rank group on a ``FileStore``
under ``tmp_path``, against the reference's ``solve_sharded`` on a
one-device mesh (objective to rtol 1e-6, planning steps taken).  Two and
four ranks run as subprocesses, one a rank, on a ``FileStore`` under
``tmp_path`` (so parallel test workers never share a port or a file),
each with a timeout; the parent holds rank 0's result against the
reference: objective to rtol 1e-6, feasibility, ``|sum(y alpha)| <
1e-6`` and an inert padded tail.
"""

import datetime
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
import torch.distributed as dist

from repro.core import qp as jqp
from repro.core.sharded import solve_sharded as j_solve_sharded
from repro.core.solver import SolverConfig as JConfig
from repro.core.solver import solve as j_solve
from repro_torch.core import sharded as sharded_mod
from repro_torch.core.sharded import solve_sharded
from repro_torch.core.solver import SolverConfig
from repro_torch.svm.data import ring, xor_gaussians

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
RANK_TIMEOUT = 60


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group (the default group), destroyed after."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("alg", ["smo", "pasmo"])
def test_one_rank_matches_the_reference(one_rank, alg):
    X, y = xor_gaussians(64, seed=0)
    cfg = SolverConfig(algorithm=alg, eps=1e-4, max_iter=100_000)
    r = solve_sharded(X, y, 100.0, 0.5, None, cfg, device="cpu",
                      dtype=torch.float64)
    rj = j_solve_sharded(jnp.asarray(X), jnp.asarray(y), 100.0, 0.5,
                         jax.make_mesh((1,), ("data",)),
                         JConfig(algorithm=alg, eps=1e-4, max_iter=100_000))
    assert bool(r.converged) and bool(rj.converged)
    np.testing.assert_allclose(float(r.objective), float(rj.objective),
                               rtol=1e-6)
    assert float(r.kkt_gap) <= 1e-4
    assert r.alpha.shape == (64,)
    if alg == "pasmo":
        assert int(r.n_planning) > 0
    else:
        assert int(r.n_planning) == 0


def test_one_rank_result_is_the_single_device_solve(one_rank):
    X, y = ring(50, seed=1)
    cfg = SolverConfig(algorithm="pasmo", eps=1e-4, max_iter=100_000)
    r = solve_sharded(X, y, 10.0, 1.0, None, cfg, device="cpu",
                      dtype=torch.float64)
    rj = j_solve(jqp.make_rbf(jnp.asarray(X), 1.0), jnp.asarray(y), 10.0,
                 JConfig(algorithm="pasmo", eps=1e-4, max_iter=100_000))
    np.testing.assert_allclose(float(r.objective), float(rj.objective),
                               rtol=1e-6)
    # the bias from the gap's ends, as the reference's solver gives it
    np.testing.assert_allclose(float(r.b), float(rj.b), rtol=0, atol=1e-3)
    # the host's cadence changes nothing returned
    r1 = solve_sharded(X, y, 10.0, 1.0, None, cfg, device="cpu",
                       dtype=torch.float64, check_every=1)
    for f in r._fields:
        assert torch.equal(getattr(r, f), getattr(r1, f)), f


def test_the_graph_path_is_bitwise_the_eager_loop(one_rank):
    """On the cards the loop's chunks replay as CUDA graphs, collectives
    included; through the capture guard's stand-in graphs (a replay reruns
    the captured chunk on the state buffers) the result is bitwise the
    eager loop's, with one capture of the 32-iteration chunk."""
    from repro_torch.analysis import capture_guard
    X, y = xor_gaussians(64, seed=0)
    cfg = SolverConfig(algorithm="pasmo", eps=1e-4, max_iter=100_000)

    def run():
        return solve_sharded(X, y, 100.0, 0.5, None, cfg, device="cpu",
                             dtype=torch.float64)

    want = run()
    with capture_guard.stand_in_graphs(), \
            capture_guard.CaptureLog() as log:
        got = run()
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(got.iterations) > 64
    assert len(log.captures) == log.expected_fit() == 1


def test_the_loop_body_reads_nothing_on_the_host(one_rank, monkeypatch):
    """A CUDA graph freezes a value its body reads on the host (and a
    capture refuses the read): one call of the body, recorded by the
    dispatch audit's recorder, reads the host nowhere; the picks are
    taken and gathered on the device, never indexed by a 0-d tensor."""
    from repro_torch.analysis.dispatch_audit import OpRecorder
    from repro_torch.core import solver_fused
    got = {}

    class Stop(Exception):
        pass

    def spy(body, s, *args, **kw):
        got.update(body=body, state=s)
        raise Stop

    monkeypatch.setattr(solver_fused, "_drive", spy)
    X, y = xor_gaussians(32, seed=0)
    with pytest.raises(Stop):
        solve_sharded(X, y, 10.0, 0.5, None, SolverConfig(algorithm="pasmo"),
                      device="cpu", dtype=torch.float64)
    rec = OpRecorder()
    with rec:
        got["body"](got["state"], False)
    assert rec.host_reads == [] and len(rec.ops) > 100
    assert not [op for op, _ in rec.ops if op == "aten.lift_fresh"]


def test_solve_sharded_validates():
    X, y = xor_gaussians(16, seed=0)
    with pytest.raises(ValueError, match="smo or pasmo"):
        solve_sharded(X, y, 1.0, 0.5, None,
                      SolverConfig(algorithm="overshoot"), device="cpu")
    with pytest.raises(ValueError, match="one candidate"):
        solve_sharded(X, y, 1.0, 0.5, None,
                      SolverConfig(plan_candidates=2), device="cpu")


@pytest.mark.parametrize("local_rank", [None, "3"])
def test_a_subgroup_rank_keeps_its_own_card(one_rank, monkeypatch,
                                            local_rank):
    """The default card is the process's (``LOCAL_RANK``, else the current
    device), not the rank in the group: the one rank of a subgroup is rank
    0 there, and must not move to ``cuda:0``."""
    sub = dist.new_group([0])
    assert dist.get_rank(sub) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    want = 2 if local_rank is None else int(local_rank)
    assert sharded_mod._rank_device(None) == torch.device("cuda", want)
    assert sharded_mod._rank_device("cpu") == torch.device("cpu")


def test_solve_sharded_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = xor_gaussians(16, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_sharded(X, y, 1.0, 0.5)


RANK_SCRIPT = textwrap.dedent("""
    import datetime, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.sharded import solve_sharded
    from repro_torch.core.solver import SolverConfig
    from repro_torch.svm import data

    rank, world, store, out, case = sys.argv[1:6]
    rank, world = int(rank), int(world)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    name, n, seed, C, gamma = json.loads(case)
    X, y = getattr(data, name)(n, seed=seed)
    r = solve_sharded(X, y, C, gamma, None,
                      SolverConfig(algorithm="pasmo", eps=1e-4,
                                   max_iter=100_000),
                      device="cpu", dtype=torch.float64)
    if rank == 0:
        np.savez(out, alpha=r.alpha.numpy(), objective=float(r.objective),
                 iterations=int(r.iterations), converged=bool(r.converged),
                 n_planning=int(r.n_planning), kkt_gap=float(r.kkt_gap))
    dist.destroy_process_group()
""")


def _run_ranks(tmp_path, world, case):
    """Rank 0's result of ``case`` on ``world`` gloo ranks, one subprocess
    a rank."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (os.path.join(ROOT, "src"),
                               os.environ.get("PYTHONPATH")) if p))
    store, out = str(tmp_path / "store"), str(tmp_path / "rank0.npz")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(r), str(world), store, out,
         json.dumps(case)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    return dict(np.load(out))


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ranks_match_the_reference(tmp_path, world):
    X, y = xor_gaussians(96, seed=3)
    r = _run_ranks(tmp_path, world, ["xor_gaussians", 96, 3, 100.0, 0.5])
    rj = j_solve(jqp.make_rbf(jnp.asarray(X), 0.5), jnp.asarray(y), 100.0,
                 JConfig(algorithm="pasmo", eps=1e-4, max_iter=100_000))
    assert bool(r["converged"]) and bool(rj.converged)
    np.testing.assert_allclose(float(r["objective"]), float(rj.objective),
                               rtol=1e-6)
    assert int(r["n_planning"]) > 0
    a = r["alpha"][:96]
    L, U = np.minimum(0.0, y * 100.0), np.maximum(0.0, y * 100.0)
    assert np.all(a >= L - 1e-9) and np.all(a <= U + 1e-9)
    assert abs(a.sum()) < 1e-6


def test_padded_tail_is_inert(tmp_path):
    # 50 rows over 4 ranks pad to 52: the tail never enters a working set
    X, y = ring(50, seed=1)
    r = _run_ranks(tmp_path, 4, ["ring", 50, 1, 10.0, 1.0])
    rj = j_solve(jqp.make_rbf(jnp.asarray(X), 1.0), jnp.asarray(y), 10.0,
                 JConfig(algorithm="pasmo", eps=1e-4, max_iter=100_000))
    assert r["alpha"].shape == (52,)
    assert np.all(r["alpha"][50:] == 0.0)
    np.testing.assert_allclose(float(r["objective"]), float(rj.objective),
                               rtol=1e-6)
