"""The port's dry-run machinery: the cost counter
(``repro_torch.launch.cost_analysis``), the H100 roofline
(``repro_torch.launch.roofline``) and three dry-run cells on a fake
(2, 2, 2) mesh, the reference's own test cells (``tests/test_dryrun.py``).

A fake process group is process-global, so everything that starts one
runs in a subprocess with a timeout of its own.  ``repro.launch.dryrun``
is never imported here: it forces XLA's host device count when imported.
"""

import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import get_shape as jget_shape
from repro.launch import roofline as jrf
from repro.models import registry as JR
from repro.sharding import logical as jlg, spec_for as jspec_for
from repro_torch.configs import ARCHS, get_config, get_shape
from repro_torch.launch import roofline as rf
from repro_torch.launch.cost_analysis import CostMode
from repro_torch.launch.dryrun import active_params, choose_microbatches

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240


def _env(**extra):
    return dict(os.environ, OMP_NUM_THREADS="1", **extra,
                PYTHONPATH=os.pathsep.join(
                    p for p in (os.path.join(ROOT, "src"),
                                os.environ.get("PYTHONPATH")) if p))


def _run(code, **env):
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       env=_env(**env), text=True, capture_output=True,
                       timeout=TIMEOUT)
    assert r.returncode == 0, (r.stdout + r.stderr)[-6000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


class TestCostMode:
    def test_matmul_flops_exact(self):
        a, b = torch.ones(128, 256), torch.ones(256, 64)
        with CostMode() as cm:
            a @ b
        assert cm.cost.flops == 2 * 128 * 256 * 64
        # operands and output, float32
        assert cm.cost.bytes == 4 * (128 * 256 + 256 * 64 + 128 * 64)
        assert cm.cost.collective_bytes == 0

    def test_matmul_with_an_output_dtype(self):
        """``bmm(a, b, out_dtype=)`` (decode's float32 dots of bfloat16
        operands on the card) is counted as the plain product."""
        a = torch.ones(2, 3, 4, dtype=torch.bfloat16, device="meta")
        b = torch.ones(2, 4, 5, dtype=torch.bfloat16, device="meta")
        with CostMode() as cm:
            torch.bmm(a, b, out_dtype=torch.float32)
        assert cm.cost.flops == 2 * 2 * 3 * 4 * 5

    @pytest.mark.parametrize("L", [4, 8])
    def test_python_loop_counts_every_trip(self, L):
        x, ws = torch.ones(64, 64), torch.ones(L, 64, 64)
        with CostMode() as cm:
            for w in ws.unbind(0):
                x = x @ w
        assert cm.cost.flops == L * 2 * 64 ** 3
        assert cm.cost.bytes == L * 4 * 3 * 64 * 64

    def test_views_move_nothing(self):
        x = torch.ones(32, 32)
        with CostMode() as cm:
            x.reshape(-1)[:5]
            x.T.unsqueeze(0).expand(3, 32, 32)
        assert cm.cost.bytes == 0 and cm.cost.flops == 0
        with CostMode() as cm:      # a transpose made contiguous is a copy
            x.T.reshape(-1)
        assert cm.cost.bytes == 2 * 32 * 32 * 4

    def test_sharded_matmul_and_redistribute_count_one_device(self):
        """On a fake (2, 2) mesh: a matmul sharded over both axes counts
        its local share (not the global op plus it), and a redistribute
        to replicated counts its all-gather's operand bytes."""
        got = _run("""
            import json, torch, torch.distributed as dist
            from torch.testing._internal.distributed.fake_pg import FakeStore
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.tensor import (Replicate, Shard,
                                                  distribute_tensor)
            from repro_torch.launch.cost_analysis import CostMode
            dist.init_process_group("fake", rank=0, world_size=4,
                                    store=FakeStore())
            mesh = init_device_mesh("cpu", (2, 2),
                                    mesh_dim_names=("data", "model"))
            def put(shape, pl):
                return distribute_tensor(torch.ones(shape), mesh, pl,
                                         src_data_rank=None)
            a = put((64, 4096), [Shard(0), Replicate()])
            b = put((4096, 512), [Replicate(), Shard(1)])
            with CostMode() as cm:
                c = a @ b
            mm = cm.cost.flops
            x = put((64, 128), [Shard(0), Replicate()])
            with CostMode() as cm:
                x.redistribute(mesh, [Replicate(), Replicate()])
            print(json.dumps({"mm": mm, "placements": str(c.placements),
                              "coll": cm.cost.collectives,
                              "counts": cm.cost.collective_counts,
                              "total": cm.cost.collective_bytes}))
        """)
        assert got["mm"] == 2 * 32 * 4096 * 256
        assert got["coll"]["all-gather"] == 32 * 128 * 4 == got["total"]
        assert got["counts"]["all-gather"] == 1


def test_roofline_matches_the_reference_formulas(monkeypatch):
    """The same properties as the reference's ``Roofline`` on the same
    inputs, once the reference's v5e constants are swapped for the
    H100's."""
    assert (rf.PEAK_FLOPS, rf.HBM_BW, rf.LINK_BW) == (989e12, 3.35e12, 450e9)
    monkeypatch.setattr(jrf, "PEAK_FLOPS", rf.PEAK_FLOPS)
    monkeypatch.setattr(jrf, "HBM_BW", rf.HBM_BW)
    monkeypatch.setattr(jrf, "ICI_BW", rf.LINK_BW)
    for flops, byts, coll in [(4e14, 3e11, 1e9), (1e12, 9e12, 2e10),
                              (1e10, 1e9, 8e11), (0.0, 0.0, 0.0)]:
        kw = dict(arch="a", shape="s", mesh="m", chips=256,
                  hlo_flops_per_device=flops, hlo_bytes_per_device=byts,
                  collective_bytes_per_device=coll,
                  model_flops_global=6e16, bytes_per_device_peak=None)
        assert rf.Roofline(**kw).to_dict() == jrf.Roofline(**kw).to_dict()
    for kind in ("train", "prefill", "decode"):
        assert rf.model_flops(7, 3, 11, kind) == \
            jrf.model_flops(7, 3, 11, kind)
    row = rf.Roofline(**kw).to_dict()
    assert rf.render_table([row]) == jrf.render_table([row])


@pytest.mark.parametrize("arch", ARCHS)
def test_active_params(arch):
    """A MoE's active parameters are the config with ``top_k`` experts
    (their gated MLPs and router columns); every other family's are all
    of them."""
    cfg = get_config(arch)
    if cfg.family != "moe":
        assert active_params(cfg) == cfg.param_count()
        return
    d, f, n = cfg.d_model, cfg.d_ff, cfg.n_layers
    dropped = (cfg.n_experts - cfg.top_k) * (3 * d * f + d) * n
    assert active_params(cfg) == cfg.param_count() - dropped


@pytest.mark.parametrize("dp", [1, 4, 16, 32])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "grok-1-314b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_choose_microbatches(arch, shape, dp):
    """The smallest divisor of the rows a device holds that keeps a
    microbatch near 16k tokens (4k for d_model >= 4096)."""
    cfg, sh = get_config(arch), get_shape(shape)
    rows = max(1, sh.global_batch // dp)
    per_mb = max(1, (4096 if cfg.d_model >= 4096 else 16384) // sh.seq_len)
    want = next(m for m in range(1, rows + 1)
                if rows % m == 0 and m >= math.ceil(rows / per_mb))
    assert choose_microbatches(sh, cfg, dp) == want


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-tiny"])
@pytest.mark.parametrize("microbatches", [1, 4])
def test_cell_loops_are_the_trips_the_cell_set_up(arch, microbatches):
    """A record's loops: the layer stacks (an encoder's as well) and,
    above one, a train step's microbatches."""
    from repro_torch.launch.dryrun import cell_loops
    cfg = get_config(arch)
    want = [("layers", cfg.n_layers)]
    if cfg.family == "encdec":
        want.append(("encoder_layers", cfg.encoder_layers))
    if microbatches > 1:
        want.append(("microbatches", microbatches))
    assert cell_loops(cfg, {"microbatches": microbatches}) == want
    assert cell_loops(cfg, {}) == want[:1 + (cfg.family == "encdec")]


class Stub:
    shape = {"pod": 2, "data": 2, "model": 2}


def _shard_bytes(shape, names, itemsize):
    spec = jspec_for(shape, names, Stub())
    n = 1
    for size, entry in zip(shape, spec):
        div = 1
        for a in (() if entry is None else
                  (entry,) if isinstance(entry, str) else entry):
            div *= Stub.shape[a]
        n *= size // div
    return n * itemsize


def _tree_bytes(logical_tree, shapes, itemsize_of):
    lgs = jax.tree.leaves(logical_tree, is_leaf=lambda x: isinstance(x, jlg))
    sds = jax.tree.leaves(shapes)
    assert len(lgs) == len(sds)
    return sum(_shard_bytes(s.shape, lg.names, itemsize_of(s))
               for lg, s in zip(lgs, sds))


def _reckoned_input_bytes(arch, shape_name):
    """Per-device bytes of the cell's inputs from the reference's specs on
    a (2, 2, 2) mesh: bfloat16 parameters, the cache (decode) and the
    batch (the port's decode takes its position as an int)."""
    cfg, shape = jget_config(arch), jget_shape(shape_name)
    size = lambda s: jnp.dtype(s.dtype).itemsize  # noqa: E731
    params = jax.eval_shape(lambda: JR.init_params(jax.random.PRNGKey(0),
                                                   cfg, jnp.bfloat16))
    total = _tree_bytes(JR.param_logical(cfg), params, lambda s: 2)
    if shape.kind == "decode":
        total += _tree_bytes(JR.cache_logical(cfg), JR.cache_specs(
            cfg, shape.global_batch, shape.seq_len), size)
        total += _shard_bytes((shape.global_batch, 1), ("batch", None), 4)
    else:
        lg, specs = JR.train_input_logical(cfg), JR.train_input_specs(cfg,
                                                                      shape)
        if shape.kind == "prefill":
            lg.pop("labels"), specs.pop("labels")
        total += _tree_bytes(lg, specs, size)
    return float(total)


CELLS = [("mixtral-8x7b", "long_500k"), ("mamba2-370m", "decode_32k"),
         ("whisper-tiny", "prefill_32k")]


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    return _run(f"""
        import json
        from repro_torch.launch.dryrun import make_mesh_by_name, run_cell
        mesh = make_mesh_by_name("2x2x2")
        print(json.dumps([run_cell(a, s, mesh, "2x2x2", out_dir={out!r})
                          for a, s in {CELLS!r}], default=str))
    """, REPRO_DRYRUN_DEVICES="8")


@pytest.mark.parametrize("i", range(len(CELLS)),
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_dryrun_cell_small_mesh(cells, i):
    arch, shape = CELLS[i]
    rec = cells[i]
    assert rec.get("ok") and not rec.get("skipped"), rec.get("traceback")
    assert (rec["arch"], rec["shape"], rec["chips"]) == (arch, shape, 8)
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
    assert rec["collectives"]["total"] > 0
    assert 0 < rec["roofline"]["roofline_fraction"] <= 1
    assert rec["memory_analysis"] is None
    assert dict(rec["loops"])["layers"] == get_config(arch).n_layers
    assert rec["input_bytes_per_device"] == _reckoned_input_bytes(arch,
                                                                  shape)


def test_dryrun_refuses_a_world_the_mesh_does_not_fit():
    code = textwrap.dedent("""
        from repro_torch.launch.dryrun import make_mesh_by_name
        try:
            make_mesh_by_name("2x2x2")
        except RuntimeError as e:
            print(str(e))
    """)
    r = subprocess.run([sys.executable, "-c", code],
                       env=_env(REPRO_DRYRUN_DEVICES="4"), text=True,
                       capture_output=True, timeout=TIMEOUT)
    assert "needs 8 ranks" in r.stdout and "has 4" in r.stdout, r.stderr
    np.testing.assert_equal(r.returncode, 0)


def test_dryrun_solver_one_iteration(tmp_path):
    """One traced iteration of the sharded solver on a fake (2, 2, 2)
    mesh: l shards over all 8 ranks; the iteration's five collectives (3
    all-reduces, 2 all-gathers) and its three local kernel rows (a
    matrix-vector product and a dot each)."""
    l, d = 4096, 32
    got = _run(f"""
        import json
        from repro_torch.launch.dryrun_solver import main
        main(["--l", "{l}", "--d", "{d}", "--mesh", "2x2x2",
              "--out", {str(tmp_path)!r}])
        print(json.dumps(json.load(open(
            {str(tmp_path / f"2x2x2__pasmo-solver__l{l}.json")!r}))))
    """, REPRO_DRYRUN_DEVICES="8")
    nloc = l // 8
    p = got["per_iteration"]
    assert got["ok"] and got["chips"] == 8
    assert p["flops_per_device"] == 3 * (2 * nloc * d + 2 * d)
    assert got["collectives"]["counts"]["all-reduce"] == 3
    assert got["collectives"]["counts"]["all-gather"] == 2
    assert p["collective_bytes_per_device"] > 0
    assert p["memory_us"] == p["bytes_per_device"] / rf.HBM_BW * 1e6


def test_report_renders_the_cells_and_skips_the_solver(cells, tmp_path):
    """``launch.report`` renders both tables from the records; a solver
    record in the same folder is not a cell and is left out."""
    from repro_torch.launch import report
    for i, rec in enumerate(cells):
        (tmp_path / f"c{i}.json").write_text(json.dumps(rec))
    (tmp_path / "solver.json").write_text(json.dumps(
        {"arch": "pasmo-solver", "shape": "l4096-d32", "mesh": "2x2x2",
         "ok": True, "per_iteration": {}}))
    rows = report.load(str(tmp_path))
    assert sorted(r["arch"] for r in rows) == sorted(a for a, _ in CELLS)
    for table in (report.roofline_table(rows), report.dryrun_table(rows)):
        assert all(a in table for a, _ in CELLS)
        assert "pasmo-solver" not in table and "FAIL" not in table
