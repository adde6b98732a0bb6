"""The port stands alone: no JAX and nothing of the reference in
``src/repro_torch`` or ``chip_smoke.py``; entry points default to the
CUDA card and raise without one; ``impl="cuda"`` never runs on CPU
tensors; the kernel build is set up for Hopper with IEEE arithmetic."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import grid
from repro_torch.core.solver import SolverConfig
from repro_torch.core.solver_fused import solve_fused, solve_fused_batched
from repro_torch.kernels import build, ops
from repro_torch.svm import SVC, SVR, OneClassSVM
from repro_torch.svm.data import xor_gaussians

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


def test_importing_the_port_loads_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    code = ("import sys, repro_torch.svm, repro_torch.kernels.ops, "
            "repro_torch.core.grid, repro_torch.core.solver_fused; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_svc_fit_without_a_card_raises(no_cuda):
    X, y = xor_gaussians(32, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SVC().fit(X, y)
    assert SVC(device="cpu").fit(X, y).alpha_.device.type == "cpu"


def test_entry_points_without_a_card_raise(no_cuda):
    X, y = xor_gaussians(32, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_fused_batched(X, y[None], 1.0, 0.5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.gram(X, X, 0.5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.gram(X, X, 0.5, device="cuda")


def test_slice_3_entry_points_without_a_card_raise(no_cuda):
    X, y = xor_gaussians(32, seed=0)
    for call in (lambda: solve_fused(X, y, 1.0, 0.5),
                 lambda: SVR().fit(X, y),
                 lambda: OneClassSVM().fit(X),
                 lambda: grid.solve_grid_svr(X, y, [1.0], [0.1], [0.5])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert solve_fused(X, y, 1.0, 0.5, device="cpu").alpha.device.type == \
        "cpu"
    assert SVR(device="cpu").fit(X, y).beta_.device.type == "cpu"
    assert OneClassSVM(device="cpu").fit(X).alpha_.device.type == "cpu"


def test_slice_3_impl_cuda_on_cpu_tensors_raises():
    X, y = xor_gaussians(32, seed=0)
    with pytest.raises(ValueError, match="impl='cuda'"):
        solve_fused(X, y, 1.0, 0.5, impl="cuda", device="cpu")
    for est in (SVR(impl="cuda", device="cpu"),
                OneClassSVM(impl="cuda", device="cpu")):
        with pytest.raises(ValueError, match="impl='cuda'"):
            est.fit(X, y)
    for precompute in (None, False):
        with pytest.raises(ValueError, match="impl='cuda'"):
            grid.solve_grid_svr(X, y, [1.0], [0.1], [0.5], impl="cuda",
                                precompute=precompute, device="cpu")


@pytest.mark.parametrize("cls", [SVR, OneClassSVM])
@pytest.mark.parametrize("kw", [dict(engine="sharded"),
                                dict(devices=("cuda:0",))])
def test_svr_oneclass_later_slices_raise_not_implemented(cls, kw):
    """The sharded engine's knobs, once a later slice, are ported: the
    sharded fit runs on the CPU's one slab, bitwise the fused fit, and a
    slab on a card that is not there raises; nothing falls back."""
    X, y = xor_gaussians(32, seed=0)
    est = cls(gamma=0.5, device="cpu", dtype=torch.float64, **kw)
    if "devices" in kw:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            est.fit(X, y)
        return
    est.fit(X, y)
    ref = cls(gamma=0.5, engine="fused", device="cpu",
              dtype=torch.float64).fit(X, y)
    assert est.engine_ == "sharded"
    assert torch.equal(est.alpha_, ref.alpha_)


def test_impl_cuda_on_cpu_tensors_raises():
    X, y = xor_gaussians(32, seed=0)
    with pytest.raises(ValueError, match="impl='cuda'"):
        solve_fused_batched(X, y[None], 1.0, 0.5, SolverConfig(),
                            impl="cuda", device="cpu")
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.gram(X, X, 0.5, impl="cuda", device="cpu")
    with pytest.raises(ValueError, match="impl='cuda'"):
        SVC(impl="cuda", device="cpu").fit(X, y)
    assert ops.resolve_impl("auto", "cpu") == "torch"
    assert ops.resolve_impl("torch", "cpu") == "torch"
    with pytest.raises(ValueError):
        ops.resolve_impl("triton", "cpu")


@pytest.mark.parametrize("kw", [dict(engine="sharded"),
                                dict(devices=("cuda:0",))])
def test_later_slices_raise_not_implemented(kw):
    """``engine="sharded"`` and ``devices`` are ported (no
    ``NotImplementedError``): the SVC shards on the CPU, and a mesh over a
    card that is not there raises rather than falling back."""
    X, y = xor_gaussians(32, seed=0)
    clf = SVC(gamma=0.5, device="cpu", dtype=torch.float64, **kw)
    if "devices" in kw:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            clf.fit(X, y)
        return
    assert clf.fit(X, y).engine_ == "sharded"
    assert np.isfinite(clf.decision_function(X[:5]).numpy()).all()


def test_default_dtype_follows_torch():
    X, y = xor_gaussians(32, seed=0)
    assert SVC(device="cpu").dtype == torch.get_default_dtype()
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        clf = SVC(device="cpu").fit(X, y)
    finally:
        torch.set_default_dtype(prev)
    assert clf.alpha_.dtype == torch.float64


def test_build_targets_hopper_with_ieee_math(tmp_path):
    cmds = build.compile_commands("nvcc", tmp_path)
    assert {pathlib.Path(c[c.index("-c") + 1]).name for c in cmds} == {
        "rbf_row_wss.cu", "rbf_row_wss_f32.cu", "rbf_update_wss.cu",
        "rbf_update_wss_f32.cu", "rbf_row_wss_single.cu",
        "rbf_update_wss_single.cu", "gram_block.cu", "row_wss_rows.cu",
        "update_wss_rows.cu"}
    for c in cmds:
        assert "arch=compute_90a,code=sm_90a" in c
        assert not any("fast_math" in a or "fast-math" in a for a in c)
    assert build.library_path().parent == ROOT / "build" / \
        "repro_torch_kernels"
    assert build.source_hash() == build.source_hash()
    common = (build.CSRC / "common.cuh").read_text()
    assert f"kBlockL = {build.BLOCK_L};" in common


def test_gitignore_lists_the_build_directory():
    lines = (ROOT / ".gitignore").read_text().split()
    assert "build/" in lines


def test_cpu_path_launches_no_kernel():
    from repro_torch import kernels
    before = kernels.launches()
    X, y = xor_gaussians(48, seed=2)
    clf = SVC(C=10.0, gamma=0.5, device="cpu",
              dtype=torch.float64).fit(X, y)
    clf.predict(X[:5])
    assert kernels.launches() == before
    assert np.isfinite(clf.decision_function(X[:5]).numpy()).all()


def _grid_problem():
    X, y = xor_gaussians(32, seed=0)
    return X, np.stack([y, -y])


def test_grid_entry_points_without_a_card_raise(no_cuda):
    X, Y = _grid_problem()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        grid.solve_grid(X, Y, [1.0], [0.5], impl="auto")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        grid.solve_grid_oneclass(X, [0.2], [0.5])
    r = grid.solve_grid(X, Y, [1.0], [0.5], impl="auto", device="cpu")
    assert r.alpha.device.type == "cpu"


def test_grid_impl_cuda_on_cpu_tensors_raises():
    X, Y = _grid_problem()
    for precompute in (True, False):
        with pytest.raises(ValueError, match="impl='cuda'"):
            grid.solve_grid(X, Y, [1.0], [0.5], impl="cuda",
                            precompute=precompute, device="cpu")
        with pytest.raises(ValueError, match="impl='cuda'"):
            grid.solve_grid_oneclass(X, [0.2], [0.5], impl="cuda",
                                     precompute=precompute, device="cpu")


# mesh/devices, once a later slice (step 12), are ported: a mesh that is
# not a LaneMesh and a card that is not there raise, naming neither a
# slice nor a step
BAD_MESH = [(dict(mesh=object()), TypeError),
            (dict(devices=("cuda:0",)), RuntimeError)]


@pytest.mark.parametrize("kw,step", BAD_MESH)
def test_grid_later_slices_raise_not_implemented(kw, step):
    X, Y = _grid_problem()
    kw = {"impl": "auto", **kw}
    calls = (lambda: grid.solve_grid(X, Y, [1.0], [0.5], device="cpu", **kw),
             lambda: grid.solve_grid_oneclass(X, [0.2], [0.5], device="cpu",
                                              **kw),
             lambda: grid.solve_grid_svr(X, Y[0], [1.0], [0.1], [0.5],
                                         device="cpu", **kw))
    for call in calls:
        with pytest.raises(step) as err:
            call()
        assert "step 12" not in str(err.value)


@pytest.mark.parametrize("kw,step", BAD_MESH)
def test_grid_compacted_later_slices_raise_not_implemented(kw, step):
    X, Y = _grid_problem()
    kw = {"impl": "auto", **kw}
    with pytest.raises(step) as err:
        grid.solve_grid_compacted(X, Y, [1.0], [0.5], device="cpu", **kw)
    assert "step 12" not in str(err.value)


def _block_knob_call(entry, knobs):
    """One call of ``entry`` on the CPU, with the tile ``knobs`` or none."""
    from repro_torch.core import multiclass
    from repro_torch.core.solver_fused import (solve_fused_batched_qp,
                                               solve_fused_chunked_qp)
    X, y = xor_gaussians(32, seed=3)
    Xt = torch.as_tensor(X, dtype=torch.float64)
    Y = torch.as_tensor(np.stack([y, -y]), dtype=torch.float64)
    L, U = torch.clamp_max(2.0 * Y, 0.0), torch.clamp_min(2.0 * Y, 0.0)
    cfg = SolverConfig(eps=1e-3, max_iter=400)
    kw = dict(block_l=128) if knobs else {}
    call = {
        "solve_fused": lambda: solve_fused(Xt, Y[0], 2.0, 0.5, cfg,
                                           device="cpu", **kw),
        "solve_fused_batched_qp": lambda: solve_fused_batched_qp(
            Xt, Y, L, U, 0.5, cfg, **kw),
        "solve_fused_batched": lambda: solve_fused_batched(
            Xt, Y, 2.0, 0.5, cfg, device="cpu", **kw),
        "solve_fused_chunked_qp": lambda: solve_fused_chunked_qp(
            Xt, Y, L, U, 0.5, cfg, chunk=16, shrinking=True, **kw),
        "solve_ovr_fused": lambda: multiclass.solve_ovr_fused(
            Xt, Y, 2.0, 0.5, cfg, device="cpu", **kw),
        "gram": lambda: ops.gram(
            Xt, Xt[:7], 0.5, device="cpu",
            **(dict(block_i=64, block_j=32) if knobs else {})),
    }[entry]
    return call()


@pytest.mark.parametrize("entry", ["solve_fused", "solve_fused_batched_qp",
                                   "solve_fused_batched",
                                   "solve_fused_chunked_qp",
                                   "solve_ovr_fused", "gram"])
def test_tile_knobs_are_accepted_and_ignored(entry):
    """The reference's tile knobs (``block_l``; ``block_i``/``block_j`` on
    the Gram) are accepted at every entry point and change no bit: the
    CUDA kernels fix their tiles when they are built."""
    got, want = _block_knob_call(entry, True), _block_knob_call(entry, False)
    if torch.is_tensor(want):
        assert torch.equal(got, want)
        return
    for f in dataclasses.fields(want):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), \
            f.name


def _pass_inputs(seed=0, B=3, l=40, d=3):
    """Small f64 pass inputs: X, two gammas' bank, and lane state."""
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(seed)
    X = torch.randn((l, d), generator=g, dtype=torch.float64)
    gammas = torch.tensor([0.3, 0.7, 0.3], dtype=torch.float64)
    bank = torch.stack([ref.gram_cross(X, X, 0.3), ref.gram_cross(X, X, 0.7)])
    C = 2.0
    y = torch.where(torch.rand((B, l), generator=g) < 0.5, -1.0, 1.0).double()
    L, U = torch.clamp_max(C * y, 0.0), torch.clamp_min(C * y, 0.0)
    alpha = L + (U - L) * torch.rand((B, l), generator=g, dtype=torch.float64)
    G = torch.randn((B, l), generator=g, dtype=torch.float64)
    i_idx = torch.tensor([1, 7, 30], dtype=torch.int32)
    j_idx = torch.tensor([5, 0, 12], dtype=torch.int32)
    lanes = torch.arange(B)
    return dict(X=X, sqn=(X * X).sum(-1), gammas=gammas, bank=bank,
                gidx=torch.tensor([0, 1, 0]), G=G, alpha=alpha, L=L, U=U,
                i_idx=i_idx, j_idx=j_idx, a_i=alpha[lanes, i_idx.long()],
                L_i=L[lanes, i_idx.long()], U_i=U[lanes, i_idx.long()],
                g_i=G[lanes, i_idx.long()] + 1.0,
                use_exact=torch.tensor([True, False, True]),
                mu=torch.tensor([0.0, 0.2, -0.1], dtype=torch.float64))


def _pass_call(wrapper, kw):
    """One call of an ``ops`` pass wrapper on :func:`_pass_inputs`."""
    from repro_torch.kernels import ref, row_source
    s = _pass_inputs()
    X, sqn, gm = s["X"], s["sqn"], s["gammas"]
    lane_a = [s[k] for k in ("a_i", "L_i", "U_i", "g_i")]
    state = [s[k] for k in ("G", "alpha", "L", "U")]
    iq, jq = s["i_idx"].long(), s["j_idx"].long()
    rows_i = ref.bank_rows(s["bank"], s["gidx"], s["i_idx"])
    rows_j = ref.bank_rows(s["bank"], s["gidx"], s["j_idx"])
    one = [t[0] for t in state]
    if wrapper == "rbf_row_wss":
        return ops.rbf_row_wss(X, sqn, *one, X[1], *[t[0] for t in lane_a],
                               s["i_idx"][0], s["use_exact"][0], 0.3, **kw)
    if wrapper == "rbf_update_wss":
        k_i = ref.rbf_row(X, sqn, X[1], 0.3)
        return ops.rbf_update_wss(X, sqn, one[0], k_i, *one[1:], X[5],
                                  s["mu"][1], 0.3, **kw)
    if wrapper == "rbf_row_wss_batched":
        return ops.rbf_row_wss_batched(X, sqn, *state, X[iq], sqn[iq],
                                       *lane_a, s["i_idx"], s["use_exact"],
                                       gm, **kw)
    if wrapper == "rbf_update_wss_batched":
        return ops.rbf_update_wss_batched(X, sqn, *state, X[iq], sqn[iq],
                                          X[jq], sqn[jq], s["mu"], gm, **kw)
    if wrapper == "source_row_wss":
        src = row_source.bank_source(s["bank"], s["gidx"])
        return ops.source_row_wss(src, *state, s["i_idx"], *lane_a,
                                  s["use_exact"], **kw)
    if wrapper == "source_update_wss":
        src = row_source.rbf_source(X, gm, 3)
        return ops.source_update_wss(src, *state, s["i_idx"], s["j_idx"],
                                     s["mu"], **kw)
    if wrapper == "row_wss_batched_rows":
        return ops.row_wss_batched_rows(rows_i, *state, *lane_a, s["i_idx"],
                                        s["use_exact"], **kw)
    assert wrapper == "update_wss_batched_rows"
    return ops.update_wss_batched_rows(rows_i, rows_j, *state, s["mu"], **kw)


@pytest.mark.parametrize("wrapper", [
    "rbf_row_wss", "rbf_update_wss", "rbf_row_wss_batched",
    "rbf_update_wss_batched", "source_row_wss", "source_update_wss",
    "row_wss_batched_rows", "update_wss_batched_rows"])
def test_pass_wrappers_take_the_reference_s_arguments(wrapper):
    """Every ``ops`` pass wrapper accepts the reference's ``block_l`` and
    ignores it; the rows forms take the reference's pre-gathered rows and
    agree bitwise with the bank forms reading the same rows in place."""
    got = _pass_call(wrapper, dict(block_l=256))
    want = _pass_call(wrapper, {})
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if wrapper in ("row_wss_batched_rows", "update_wss_batched_rows"):
        s = _pass_inputs()
        state = [s[k] for k in ("G", "alpha", "L", "U")]
        if wrapper == "row_wss_batched_rows":
            bank = ops.row_wss_batched_bank(
                s["bank"], s["gidx"], *state,
                *[s[k] for k in ("a_i", "L_i", "U_i", "g_i", "i_idx",
                                 "use_exact")])
        else:
            bank = ops.update_wss_batched_bank(
                s["bank"], s["gidx"], *state, s["i_idx"], s["j_idx"],
                s["mu"])
        for a, b in zip(want, bank):
            assert torch.equal(a, b)


def test_no_error_names_the_multi_gpu_step():
    """The lane-sharded engine and the row-sharded solver are ported:
    nothing in the package still refuses them as a later slice."""
    for path in PORT_FILES:
        text = path.read_text()
        assert "step 12" not in text and "later slice" not in text, path


def test_no_error_names_the_telemetry_step():
    """The flight recorder is ported: nothing in the package still refuses
    it as a later slice."""
    for path in PORT_FILES:
        assert "step 9" not in path.read_text(), path


@pytest.mark.parametrize("entry", ["svc", "svr", "oneclass", "grid",
                                   "compacted", "solve", "ovr", "batched",
                                   "train_svm"])
def test_classic_entry_points_without_a_card_raise(no_cuda, entry):
    from repro_torch.core import multiclass, qp, solver
    from repro_torch.svm import train_svm
    X, Y = _grid_problem()
    K = qp.PrecomputedKernel(torch.as_tensor(X @ X.T))
    call = {
        "svc": lambda: SVC(engine="batched").fit(X, Y[0]),
        "svr": lambda: SVR(engine="batched").fit(X, Y[0]),
        "oneclass": lambda: OneClassSVM(engine="batched").fit(X),
        "grid": lambda: grid.solve_grid(X, Y, [1.0], [0.5]),
        "compacted": lambda: grid.solve_grid_compacted(X, Y, [1.0], [0.5]),
        "solve": lambda: solver.solve(K, Y[0], 1.0),
        "ovr": lambda: multiclass.solve_ovr(K, Y, 1.0),
        "batched": lambda: solver.solve_batched(K.K[None], Y[:1], 1.0),
        "train_svm": lambda: train_svm(X, Y[0], 1.0, 0.5),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_grid_cpu_path_launches_no_kernel():
    from repro_torch import kernels
    before = kernels.launches()
    X, Y = _grid_problem()
    for precompute in (True, False):
        r = grid.solve_grid(X, Y, [1.0, 4.0], [0.5, 1.0], impl="auto",
                            precompute=precompute, device="cpu",
                            dtype=torch.float64)
        grid.grid_decision(X[:5], X, [0.5, 1.0], r.alpha, r.b)
        grid.solve_grid_oneclass(X, [0.2], [0.5], precompute=precompute,
                                 device="cpu", dtype=torch.float64)
        grid.solve_grid_svr(X, Y[0], [1.0], [0.1], [0.5],
                            precompute=precompute, device="cpu",
                            dtype=torch.float64)
        grid.solve_grid_compacted(X, Y, [1.0, 4.0], [0.5], chunk=16,
                                  impl="auto", precompute=precompute,
                                  shrinking=True, device="cpu",
                                  dtype=torch.float64)
        grid.solve_grid_svr(X, Y[0], [1.0], [0.1], [0.5],
                            precompute=precompute, shrinking=True,
                            device="cpu", dtype=torch.float64)
        grid.solve_grid_svr(X, Y[0], [1.0], [0.1], [0.5],
                            SolverConfig(algorithm="smo", step="conjugate"),
                            precompute=precompute, shrinking=True,
                            device="cpu", dtype=torch.float64)
        grid.solve_grid(X, Y, [1.0, 4.0], [0.5],
                        SolverConfig(algorithm="smo", step="conjugate"),
                        impl="auto", precompute=precompute, device="cpu",
                        dtype=torch.float64)
    assert kernels.launches() == before
    assert set(before) == {"rbf_row_wss_batched", "rbf_update_wss_batched",
                           "gram_block", "row_wss_batched_rows",
                           "update_wss_batched_rows", "rbf_row_wss",
                           "rbf_update_wss", "rbf_row_wss_batched_h2",
                           "rbf_update_wss_batched_h2",
                           "row_wss_batched_rows_h2",
                           "update_wss_batched_rows_h2",
                           "rbf_row_wss_batched_act",
                           "rbf_update_wss_batched_act",
                           "row_wss_batched_rows_act",
                           "update_wss_batched_rows_act",
                           "rbf_update_wss_batched_conj",
                           "update_wss_batched_rows_conj"}


def test_slice_3_cpu_path_launches_no_kernel():
    from repro_torch import kernels
    before = kernels.launches()
    X, y = xor_gaussians(48, seed=2)
    for alg in ("smo", "pasmo"):
        solve_fused(X, y, 10.0, 0.5, SolverConfig(algorithm=alg),
                    device="cpu", dtype=torch.float64)
    for precompute in (True, False):
        SVR(C=2.0, gamma=0.5, precompute=precompute, device="cpu",
            dtype=torch.float64).fit(X, y).predict(X[:5])
        OneClassSVM(nu=0.2, gamma=0.5, precompute=precompute, device="cpu",
                    dtype=torch.float64).fit(X).predict(X[:5])
    assert kernels.launches() == before


def test_importing_the_lm_serving_path_loads_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    code = ("import sys, repro_torch.models, repro_torch.models.registry, "
            "repro_torch.models.convert, repro_torch.train.serve_step, "
            "repro_torch.launch.serve, repro_torch.svm.probes, "
            "repro_torch.configs; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_importing_the_hybrid_and_encdec_families_loads_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    code = ("import sys, repro_torch.models.rglru, repro_torch.models.encdec;"
            " bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-tiny"])
@pytest.mark.parametrize("entry", ["init_params", "init_cache"])
def test_hybrid_and_encdec_entry_points_without_a_card_raise(no_cuda, arch,
                                                             entry):
    from repro_torch.configs import get_smoke
    from repro_torch.models import registry
    from repro_torch.tree import leaves
    cfg = get_smoke(arch)
    call = {"init_params": lambda **kw: registry.init_params(0, cfg, **kw),
            "init_cache": lambda **kw: registry.init_cache(cfg, 1, 8,
                                                           **kw)}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(device="cuda")
    assert all(t.device.type == "cpu" for t in leaves(call(device="cpu")))


def _lm_entry_call(entry, device):
    """One call of an LM-path entry point on the qwen2 smoke config."""
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import ServeConfig
    from repro_torch.models import registry
    from repro_torch.svm import probes
    from repro_torch.train.serve_step import greedy_generate
    cfg = get_smoke("qwen2-0.5b")
    kw = {} if device is None else {"device": device}
    if entry == "init_params":
        return registry.init_params(0, cfg, **kw)
    if entry == "greedy_generate":
        params = registry.init_params(0, cfg, device="cpu")
        prompt = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
        sc = ServeConfig(seq_len=6, batch=1, param_dtype="float32",
                         compute_dtype="float32", kv_dtype="float32")
        return greedy_generate(cfg, sc, params, prompt, 2, **kw)
    X, y = xor_gaussians(24, seed=0)
    return probes.train_probe(X, (y > 0).astype(int), 2, **kw)


@pytest.mark.parametrize("entry", ["init_params", "greedy_generate",
                                   "train_probe"])
def test_lm_entry_points_without_a_card_raise(no_cuda, entry):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _lm_entry_call(entry, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _lm_entry_call(entry, "cuda")
    out = _lm_entry_call(entry, "cpu")
    leaf = out.X if entry == "train_probe" else (
        out.embed if entry == "init_params" else out)
    assert leaf.device.type == "cpu"


def test_serve_production_mesh_raises_not_implemented():
    """``--production-mesh`` builds the (16, 16) mesh: on a one-rank world
    that raises ``RuntimeError`` naming the 256 ranks it needs, and the
    one-rank group the launcher started is gone afterwards."""
    import torch.distributed as dist
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        serve.main(["--smoke", "--device", "cpu", "--production-mesh"])
    assert not dist.is_initialized()


def test_production_mesh_shapes_on_a_fake_world(tmp_path):
    """In a fake group of 256 (and 512) ranks the production meshes have
    the reference's shapes and axis names; a 4-rank world refuses them."""
    code = textwrap.dedent("""
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.launch.mesh import make_host_mesh, \
            make_production_mesh
        dist.init_process_group("fake", rank=0, world_size=256,
                                store=FakeStore())
        m = make_production_mesh()
        assert m.mesh_dim_names == ("data", "model"), m
        assert tuple(m.shape) == (16, 16)
        try:
            make_production_mesh(multi_pod=True)
        except RuntimeError as e:
            assert "needs 512 ranks" in str(e) and "has 256" in str(e)
        else:
            raise SystemExit("the two-pod mesh on 256 ranks did not raise")
        h = make_host_mesh(128, 2)
        assert tuple(h.shape) == (128, 2)
        dist.destroy_process_group()
        dist.init_process_group("fake", rank=0, world_size=512,
                                store=FakeStore())
        m = make_production_mesh(multi_pod=True)
        assert m.mesh_dim_names == ("pod", "data", "model")
        assert tuple(m.shape) == (2, 16, 16)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                       capture_output=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), \
        r.stdout + r.stderr


def test_importing_the_mesh_path_loads_no_jax():
    """The sharding rules, the meshes, the cost counter, the roofline,
    the dry-runs and the report load neither jax nor the reference."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    code = ("import sys, repro_torch.sharding, repro_torch.launch.mesh, "
            "repro_torch.launch.cost_analysis, repro_torch.launch.roofline, "
            "repro_torch.launch.dryrun, repro_torch.launch.dryrun_solver, "
            "repro_torch.launch.report; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_importing_the_training_path_loads_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    code = ("import sys, repro_torch.tree, repro_torch.train.optimizer, "
            "repro_torch.train.compression, repro_torch.train.train_step, "
            "repro_torch.data, repro_torch.checkpoint, repro_torch.runtime, "
            "repro_torch.launch.train; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _train_entry_call(entry, device, tmp_path):
    """One call of a training entry point on the qwen2 smoke config."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import train
    from repro_torch.train.train_step import init_state
    cfg = get_smoke("qwen2-0.5b")
    tc = TrainConfig(param_dtype="float32", compute_dtype="float32")
    kw = {} if device is None else {"device": device}
    if entry == "init_state":
        return init_state(0, cfg, tc, **kw).params.embed
    if entry == "restore_checkpoint":
        like = {"w": torch.zeros(3)}
        save_checkpoint(str(tmp_path), 1, like)
        return restore_checkpoint(str(tmp_path), 1, like, **kw)["w"]
    argv = ["--smoke", "--steps", "1", "--batch", "2", "--seq", "8",
            "--ckpt", str(tmp_path / "ck")]
    return train.main(argv + ([] if device is None else
                              ["--device", device])).state.params.embed


@pytest.mark.parametrize("entry", ["init_state", "restore_checkpoint",
                                   "launch_train"])
def test_train_entry_points_without_a_card_raise(no_cuda, entry, tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _train_entry_call(entry, None, tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _train_entry_call(entry, "cuda", tmp_path)
    assert _train_entry_call(entry, "cpu", tmp_path).device.type == "cpu"


def test_train_production_mesh_raises_not_implemented():
    """``--production-mesh`` builds the (16, 16) mesh: on a one-rank world
    that raises ``RuntimeError`` naming the 256 ranks it needs."""
    import torch.distributed as dist
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        train.main(["--smoke", "--device", "cpu", "--production-mesh"])
    assert not dist.is_initialized()


def test_launchers_take_the_one_device_path(tmp_path, capsys):
    """Alone, each launcher serves or trains on a (1, 1) host mesh whose
    leaves stay plain tensors, and leaves no process group behind."""
    import torch.distributed as dist
    from repro_torch.launch import serve, train
    serve.main(["--smoke", "--device", "cpu", "--tokens", "4"])
    assert "first sequence" in capsys.readouterr().out
    run = train.main(["--smoke", "--device", "cpu", "--steps", "2",
                      "--ckpt", str(tmp_path)])
    assert "mesh: {'data': 1, 'model': 1} (cpu)" in capsys.readouterr().out
    assert type(run.state.params.embed) is torch.Tensor
    assert not dist.is_initialized()
