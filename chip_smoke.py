#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

from the root of a checkout.  Phases, each printing its own lines; any
failure raises and the script exits non-zero without a result line:

1. env    — the card (``nvidia-smi`` name and power limit), torch and CUDA.
2. build  — ``nvcc`` builds the kernels from ``src/repro_torch/kernels/csrc``.
3. kernels vs plain — pass A, pass B, the Gram kernel and the two Gram-bank
   passes against their plain PyTorch versions on the same inputs on the
   card, at the main paths' shapes and at odd ones, in float64 and
   float32, with the edge cases of the CPU tests (all-masked lane, ties
   across blocks, a mu = 0 lane, per-lane gammas, lanes spread over the
   bank's entries, both gain rules).  Tolerance: values to rtol 1e-12
   (f64) / 1e-5 (f32); indices exactly, except that in f32 an argmax may
   differ where the plain version's gains at both picks agree to 1e-6
   relative (the kernel sums its products in another order).
4. end to end, small — binary and 3-class SVC, smo and pasmo, and a
   3-class 2 x 2 (C, gamma) grid through both row sources, f64,
   ``impl="cuda"`` against ``impl="torch"``.
5. SVC, full width (slice 1's main path) — a 10-class one-vs-rest SVC at
   l = 16384, d = 128 in f64 and f32: convergence, gradient drift, KKT
   gap, held-out agreement, launch counts, and each kernel's device time
   beside its bound and its plain version's time; then a
   ``torch.profiler`` window over a capped fit: device kernels an
   iteration and the device's busy share of the iteration's wall time.
6. grid, full width (slice 2's main path) — the (C, gamma) grid of the
   same data, 3 gammas x 10 classes x 3 Cs = 90 lanes, through the Gram
   bank (f64 and f32) and through the rbf passes (f64): convergence, bank
   against rbf objectives, gradient drift and KKT gap, launch counts,
   held-out accuracy per (gamma, C), peak memory, wall time an iteration,
   a ``torch.profiler`` window, kernels 1, 2, 4 and 5 timed at B = 90 and
   the bank build timed; then the one-class grid (3 nus x the 3 gammas)
   through both row sources.

The line before the last is the kernels' JSON record; the last is the
contract line ``{"ok": true, "device": {...}}``.  No JAX and nothing of the
reference package is imported.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402


# Published H100 SXM peaks (NVIDIA data sheet) used for the bounds: HBM3 at
# 3.35 TB/s; 67 TFLOP/s for float32 outside the tensor cores and for
# float64 on the tensor cores (the fastest the card does either type).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float64: 67e12, torch.float32: 67e12}
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
TIE_RTOL_F32 = 1e-6
# Main path: repo's kernel-bench shape, 10 one-vs-rest lanes.
N_TRAIN, N_TEST, D, K = 16384, 4096, 128, 10
# Slice 2's grid: gamma_scale times these, C values, one-class nus.
GRID_GAMMA_FACTORS = (0.5, 1.0, 2.0)
GRID_CS = (0.5, 2.0, 8.0)
GRID_NUS = (0.05, 0.1, 0.2)
GRID_B = len(GRID_GAMMA_FACTORS) * K * len(GRID_CS)
SOURCES = {
    "rbf_row_wss_batched": ("src/repro_torch/kernels/csrc/rbf_row_wss.cu",
                            "src/repro/kernels/rbf_row_wss.py:193"),
    "rbf_update_wss_batched": (
        "src/repro_torch/kernels/csrc/rbf_update_wss.cu",
        "src/repro/kernels/rbf_update_wss.py:196"),
    "gram_block": ("src/repro_torch/kernels/csrc/gram_block.cu",
                   "src/repro/kernels/gram_block.py:33"),
    "row_wss_batched_rows": ("src/repro_torch/kernels/csrc/row_wss_rows.cu",
                             "src/repro/kernels/rbf_row_wss.py:247"),
    "update_wss_batched_rows": (
        "src/repro_torch/kernels/csrc/update_wss_rows.cu",
        "src/repro/kernels/rbf_update_wss.py:261"),
}
BANK_PASSES = ("row_wss_batched_rows", "update_wss_batched_rows")
RBF_PASSES = ("rbf_row_wss_batched", "rbf_update_wss_batched")


def say(*parts):
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


class DeviceTimer:
    """Device time of a call, from CUDA events around ``reps`` calls queued
    behind a spin kernel: the host enqueues them all while the card spins,
    so the events bracket back-to-back device work and not the host's
    Python overhead."""

    def __init__(self):
        self.ms_per_cycle = self._calibrate()

    @staticmethod
    def _calibrate() -> float:
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(1000)
        s.record()
        torch.cuda._sleep(10_000_000)
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / 10_000_000

    def ms(self, fn, reps: int = 50) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(int((2.0 * host_ms + 2.0) / self.ms_per_cycle))
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / reps


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1 + 2
# ---------------------------------------------------------------------------


def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say(smi)
    say(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()}")
    # the plain versions' products in full float32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    path = build.build(verbose=True)
    build.load()
    say(f"[build] {path.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------


def kernel_state(l, d, B, seed, dtype, device):
    """Pass A and pass B inputs with the CPU tests' edge cases: points 5
    and l-3 are duplicates with equal state (an exact gain tie across
    blocks, best in every lane), the last lane of B > 1 is all-masked in
    pass A and has an empty I_up in pass B, lane 0 takes mu = 0, lanes
    alternate the gain rule and every lane has its own gamma."""
    rng = np.random.default_rng(seed)
    ta, tb = 5, l - 3
    X = rng.normal(size=(l, d))
    X[tb] = X[ta]
    C = rng.choice([0.5, 1.0, 10.0], size=(B, 1))
    y = rng.choice([-1.0, 1.0], size=(B, l))
    L, U = np.minimum(0.0, y * C), np.maximum(0.0, y * C)
    frac = rng.uniform(size=(B, l))
    frac = np.where(rng.uniform(size=(B, l)) < 0.4, np.round(frac), frac)
    frac[:, [ta, tb]] = 0.5
    alpha = L + (U - L) * frac
    G = rng.normal(size=(B, l))
    G[:, ta] = G.min(axis=1) - 50.0
    for arr in (G, alpha, L, U):
        arr[:, tb] = arr[:, ta]
    i_idx = rng.integers(ta + 1, tb, size=B)
    j_idx = rng.integers(0, l, size=B)
    lanes = np.arange(B)
    alpha_a = alpha.copy()
    alpha_b = alpha.copy()
    G_b = G.copy()
    G_b[:, [ta, tb]] = G.max(axis=1, keepdims=True) + 5.0
    if B > 1:
        alpha_a[-1] = L[-1]
        alpha_b[-1] = U[-1]
    mu = rng.normal(size=B)
    mu[0] = 0.0
    sqn = (X * X).sum(axis=1)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    a_state = dict(
        X=t(X), sqn=t(sqn), G=t(G), alpha=t(alpha_a), L=t(L), U=t(U),
        XQ=t(X[i_idx]), sqq=t(sqn[i_idx]), a_i=t(alpha_a[lanes, i_idx]),
        L_i=t(L[lanes, i_idx]), U_i=t(U[lanes, i_idx]),
        g_i=t(G[lanes, i_idx] + 1.0),
        i_idx=torch.tensor(i_idx, dtype=torch.int32, device=device),
        use_exact=torch.tensor(lanes % 2 == 1, device=device),
        gammas=t(rng.uniform(0.05, 0.5, B) * 16.0 / d))
    b_state = dict(
        X=a_state["X"], sqn=a_state["sqn"], G=t(G_b), alpha_new=t(alpha_b),
        L=a_state["L"], U=a_state["U"], XQi=a_state["XQ"],
        sqqi=a_state["sqq"], XQj=t(X[j_idx]), sqqj=t(sqn[j_idx]), mu=t(mu),
        gammas=a_state["gammas"])
    return a_state, b_state


def _close(name, got, want, rtol, scale=None):
    """max |got - want|, raising past rtol * (|want| or scale)."""
    err = (got - want).abs()
    err = torch.where(torch.isnan(err) | (got == want),
                      torch.zeros_like(err), err)
    if torch.isnan(got).any() or torch.isnan(want).any():
        raise AssertionError(f"{name}: NaN")
    ref_mag = want.abs() if scale is None else torch.full_like(want, scale)
    ref_mag = torch.where(torch.isfinite(ref_mag), ref_mag,
                          torch.zeros_like(ref_mag))
    bad = err > rtol * ref_mag
    if bad.any():
        k = int(torch.nonzero(bad.reshape(-1))[0])
        raise AssertionError(
            f"{name}: {int(bad.sum())} entries past rtol {rtol}; first "
            f"flat index {k}: {got.reshape(-1)[k].item()!r} vs "
            f"{want.reshape(-1)[k].item()!r}")
    return float(err.max()) if err.numel() else 0.0


def _same_picks(name, got, want, vals, dtype):
    """Indices equal; in f32 a differing pick must be a near-tie of the
    plain version's values (``vals`` (B, l), per lane)."""
    diff = torch.nonzero(got != want)
    if len(diff) and dtype == torch.float64:
        raise AssertionError(f"{name}: f64 argmax differs at {diff[:4]}")
    for idx in diff.tolist():
        b = idx[0]
        va = vals[b, int(got[tuple(idx)])].item()
        vb = vals[b, int(want[tuple(idx)])].item()
        if not abs(va - vb) <= TIE_RTOL_F32 * max(abs(va), abs(vb)):
            raise AssertionError(f"{name}: argmax {got[tuple(idx)]} vs "
                                 f"{want[tuple(idx)]} in lane {b}, gains "
                                 f"{va!r} vs {vb!r}")
    return len(diff)


def check_pass_a(a, dtype, label, errs):
    from repro_torch.kernels import build, ops, rbf_row_wss, ref
    args = [a[k] for k in ("X", "sqn", "G", "alpha", "L", "U", "XQ", "sqq",
                           "a_i", "L_i", "U_i", "g_i", "i_idx", "use_exact",
                           "gammas")]
    bmax, barg = rbf_row_wss.rbf_row_wss_batched(*args)
    pmax, parg = ref.rbf_row_wss_batched_blocks(*args,
                                                block_l=build.BLOCK_L)
    vals = ref._wss_vals(ref.rbf_rows_batched(
        a["X"], a["sqn"], a["XQ"], a["sqq"], a["gammas"]),
        *[a[k] for k in ("G", "alpha", "L", "U", "a_i", "L_i", "U_i", "g_i",
                         "i_idx", "use_exact")])
    err = _close(f"pass A bmax {label}", bmax, pmax, TOL[dtype])
    n_ties = _same_picks(f"pass A barg {label}", barg, parg, vals, dtype)
    j_c, g_c = ops.rbf_row_wss_batched(*args, impl="cuda")
    j_t, g_t = ops.rbf_row_wss_batched(*args, impl="torch")
    err = max(err, _close(f"pass A gain {label}", g_c, g_t, TOL[dtype]))
    n_ties += _same_picks(f"pass A j {label}", j_c[:, None], j_t[:, None],
                          vals, dtype)
    B = a["G"].shape[0]
    if B > 1:
        assert int(j_c[-1]) == 0 and g_c[-1].item() == -math.inf, label
    # the tie across blocks goes to the lower index in every Newton-gain
    # lane (even lanes; the last lane of B > 1 is all-masked)
    newton = [b for b in range(0, B - (B > 1), 2)]
    assert (j_c[newton] == 5).all() and (j_t[newton] == 5).all(), label
    errs.append(err)
    return n_ties


def check_pass_b(b, dtype, label, errs):
    from repro_torch.kernels import build, ops, rbf_update_wss, ref
    args = [b[k] for k in ("X", "sqn", "G", "alpha_new", "L", "U", "XQi",
                           "sqqi", "XQj", "sqqj", "mu", "gammas")]
    G_k, bmax, barg, bmin = rbf_update_wss.rbf_update_wss_batched(*args)
    G_p, pmax, parg, pmin = ref.rbf_update_wss_batched_blocks(
        *args, block_l=build.BLOCK_L)
    if not torch.equal(G_k[0], b["G"][0]):
        raise AssertionError(f"pass B {label}: the mu = 0 lane's G changed")
    scale = float(b["G"].abs().max())
    err = _close(f"pass B G {label}", G_k, G_p, TOL[dtype], scale)
    err = max(err, _close(f"pass B bmax {label}", bmax, pmax, TOL[dtype],
                          scale))
    err = max(err, _close(f"pass B bmin {label}", bmin, pmin, TOL[dtype],
                          scale))
    vals = torch.where(b["alpha_new"] < b["U"], G_p, -math.inf)
    n_ties = _same_picks(f"pass B barg {label}", barg, parg, vals, dtype)
    _, i_c, gi_c, gdn_c = ops.rbf_update_wss_batched(*args, impl="cuda")
    _, i_t, gi_t, gdn_t = ops.rbf_update_wss_batched(*args, impl="torch")
    err = max(err, _close(f"pass B g_i {label}", gi_c, gi_t, TOL[dtype],
                          scale))
    err = max(err, _close(f"pass B g_dn {label}", gdn_c, gdn_t, TOL[dtype],
                          scale))
    n_ties += _same_picks(f"pass B i {label}", i_c[:, None], i_t[:, None],
                          vals, dtype)
    if G_k.shape[0] > 1:
        assert int(i_c[-1]) == 0 and gi_c[-1].item() == -math.inf, label
    errs.append(err)
    return n_ties


def bank_state(l, B, n_stack, seed, dtype, device):
    """Bank pass A and pass B inputs: the pass state of ``kernel_state``
    (d = 8) over an (n_stack, l, l) Gram bank with the lanes spread over
    its entries.  The duplicated points' bank rows and columns are set
    equal, so their gains tie exactly across the first and last block."""
    a, b = kernel_state(l, 8, B, seed, dtype, device)
    ta, tb = 5, l - 3
    rng = np.random.default_rng(seed + 1)
    from repro_torch.kernels import ref
    gammas = rng.uniform(0.05, 0.5, n_stack)
    bank = torch.empty((n_stack, l, l), dtype=dtype, device=device)
    for g, gam in enumerate(gammas):
        ref.gram_cross(a["X"], a["X"], float(gam), out=bank[g])
    bank[:, :, tb] = bank[:, :, ta]
    bank[:, tb, :] = bank[:, ta, :]
    gidx = torch.tensor(rng.permutation(np.arange(B) % n_stack),
                        dtype=torch.int64, device=device)
    j_idx = torch.tensor(rng.integers(0, l, size=B), dtype=torch.int32,
                         device=device)
    ba = dict(gram=bank, gram_idx=gidx, **{
        k: a[k] for k in ("G", "alpha", "L", "U", "a_i", "L_i", "U_i", "g_i",
                          "i_idx", "use_exact")})
    bb = dict(gram=bank, gram_idx=gidx, **{
        k: b[k] for k in ("G", "alpha_new", "L", "U")},
        i_idx=a["i_idx"], j_idx=j_idx, mu=b["mu"])
    return ba, bb


BANK_A = ("gram", "gram_idx", "G", "alpha", "L", "U", "a_i", "L_i", "U_i",
          "g_i", "i_idx", "use_exact")
BANK_B = ("gram", "gram_idx", "G", "alpha_new", "L", "U", "i_idx", "j_idx",
          "mu")


def check_bank_a(a, dtype, label, errs):
    from repro_torch.kernels import build, ops, rbf_row_wss, ref
    args = [a[k] for k in BANK_A]
    bmax, barg = rbf_row_wss.row_wss_batched_rows(*args)
    pmax, parg = ref.row_wss_batched_rows_blocks(*args,
                                                 block_l=build.BLOCK_L)
    vals = ref._wss_vals(ref.bank_rows(a["gram"], a["gram_idx"], a["i_idx"]),
                         *[a[k] for k in BANK_A[2:]])
    err = _close(f"bank pass A bmax {label}", bmax, pmax, TOL[dtype])
    n_ties = _same_picks(f"bank pass A barg {label}", barg, parg, vals,
                         dtype)
    j_c, g_c = ops.row_wss_batched_rows(*args, impl="cuda")
    j_t, g_t = ops.row_wss_batched_rows(*args, impl="torch")
    err = max(err, _close(f"bank pass A gain {label}", g_c, g_t, TOL[dtype]))
    n_ties += _same_picks(f"bank pass A j {label}", j_c[:, None],
                          j_t[:, None], vals, dtype)
    B = a["G"].shape[0]
    if B > 1:
        assert int(j_c[-1]) == 0 and g_c[-1].item() == -math.inf, label
    newton = [b for b in range(0, B - (B > 1), 2)]
    assert (j_c[newton] == 5).all() and (j_t[newton] == 5).all(), label
    errs.append(err)
    return n_ties


def check_bank_b(b, dtype, label, errs):
    from repro_torch.kernels import build, ops, rbf_update_wss, ref
    args = [b[k] for k in BANK_B]
    G_k, bmax, barg, bmin = rbf_update_wss.update_wss_batched_rows(*args)
    G_p, pmax, parg, pmin = ref.update_wss_batched_rows_blocks(
        *args, block_l=build.BLOCK_L)
    if not torch.equal(G_k[0], b["G"][0]):
        raise AssertionError(f"bank pass B {label}: the mu = 0 lane's G "
                             f"changed")
    scale = float(b["G"].abs().max())
    err = _close(f"bank pass B G {label}", G_k, G_p, TOL[dtype], scale)
    err = max(err, _close(f"bank pass B bmax {label}", bmax, pmax,
                          TOL[dtype], scale))
    err = max(err, _close(f"bank pass B bmin {label}", bmin, pmin,
                          TOL[dtype], scale))
    vals = torch.where(b["alpha_new"] < b["U"], G_p, -math.inf)
    n_ties = _same_picks(f"bank pass B barg {label}", barg, parg, vals,
                         dtype)
    _, i_c, gi_c, gdn_c = ops.update_wss_batched_rows(*args, impl="cuda")
    _, i_t, gi_t, gdn_t = ops.update_wss_batched_rows(*args, impl="torch")
    err = max(err, _close(f"bank pass B g_i {label}", gi_c, gi_t, TOL[dtype],
                          scale))
    err = max(err, _close(f"bank pass B g_dn {label}", gdn_c, gdn_t,
                          TOL[dtype], scale))
    n_ties += _same_picks(f"bank pass B i {label}", i_c[:, None],
                          i_t[:, None], vals, dtype)
    if G_k.shape[0] > 1:
        assert int(i_c[-1]) == 0 and gi_c[-1].item() == -math.inf, label
    else:
        assert int(i_c[0]) == 5, label
    errs.append(err)
    return n_ties


def check_gram(X1, X2, gamma, dtype, label, errs):
    from repro_torch.kernels import gram_block, ref
    K_k = gram_block.gram_cross(X1, X2, gamma)
    K_p = ref.gram_cross(X1, X2, gamma)
    errs.append(_close(f"gram {label}", K_k, K_p, TOL[dtype], 1.0))


def phase_kernels(device) -> dict:
    errs = {k: [] for k in SOURCES}
    shapes = [(N_TRAIN, D, K, "main"), (1000, D, 1, "odd"),
              (1000, 37, 13, "odd"), (300, 5, 19, "odd")]
    for dtype in (torch.float64, torch.float32):
        for l, d, B, kind in shapes:
            label = f"{kind} l={l} d={d} B={B} {str(dtype)[6:]}"
            a, b = kernel_state(l, d, B, seed=l + d + B, dtype=dtype,
                                device=device)
            ta = check_pass_a(a, dtype, label, errs["rbf_row_wss_batched"])
            tb = check_pass_b(b, dtype, label,
                              errs["rbf_update_wss_batched"])
            say(f"[kernels] pass A ok ({ta} f32 near-ties), pass B ok "
                f"({tb} f32 near-ties): {label}")
        rng = np.random.default_rng(3)
        for m, n, d, kind in ((N_TEST, N_TRAIN, D, "main"),
                              (1000, 333, 37, "odd")):
            X1 = torch.tensor(rng.normal(size=(m, d)), dtype=dtype,
                              device=device)
            X2 = torch.tensor(rng.normal(size=(n, d)), dtype=dtype,
                              device=device)
            label = f"{kind} {m}x{n} d={d} {str(dtype)[6:]}"
            check_gram(X1, X2, 1.0 / (2 * d), dtype, label,
                       errs["gram_block"])
            say(f"[kernels] gram ok: {label}")
        for l, B, n_stack, kind in ((N_TRAIN, GRID_B, 3, "main"),
                                    (1000, 1, 1, "odd"), (300, 19, 3, "odd")):
            label = (f"{kind} l={l} B={B} bank={n_stack} "
                     f"{str(dtype)[6:]}")
            a, b = bank_state(l, B, n_stack, seed=l + B, dtype=dtype,
                              device=device)
            ta = check_bank_a(a, dtype, label, errs["row_wss_batched_rows"])
            tb = check_bank_b(b, dtype, label,
                              errs["update_wss_batched_rows"])
            del a, b
            say(f"[kernels] bank pass A ok ({ta} f32 near-ties), bank pass "
                f"B ok ({tb} f32 near-ties): {label}")
    torch.cuda.synchronize()
    worst = {k: max(v) for k, v in errs.items()}
    say(f"[kernels] all kernels agree with their plain versions; max abs "
        f"err {worst}")
    return worst


# ---------------------------------------------------------------------------
# phase 4: small end to end, kernels against plain versions
# ---------------------------------------------------------------------------


def phase_small(device, impl):
    from repro_torch.core import multiclass as mc
    from repro_torch.core import qp
    from repro_torch.svm import SVC, data
    eps = 1e-6
    for kind in ("binary", "3-class"):
        if kind == "binary":
            X, y = data.gaussian_blobs(600, seed=1, d=8, sep=2.0)
        else:
            X, y = data.multiclass_blobs(600, seed=1, k=3, d=8, sep=4.0)
        Xtr, ytr, Xte = X[:400], y[:400], X[400:]
        for alg in ("smo", "pasmo"):
            fits = {}
            for which in (impl, "torch"):
                clf = SVC(C=1.0, gamma="scale", algorithm=alg, eps=eps,
                          impl=which, device=device, dtype=torch.float64)
                fits[which] = clf.fit(Xtr, ytr)
            k, p = fits[impl], fits["torch"]
            rk, rp = k.fit_result_, p.fit_result_
            assert bool(rk.converged.all()) and bool(rp.converged.all())
            assert float(rk.kkt_gap.max()) <= eps, rk.kkt_gap
            np.testing.assert_allclose(rk.objective.cpu().numpy(),
                                       rp.objective.cpu().numpy(),
                                       rtol=1e-6)
            y_idx = mc.class_index(ytr)[1]
            Y = (mc.ovr_labels(y_idx, 2, torch.float64, device)[1:]
                 if kind == "binary"
                 else mc.ovr_labels(y_idx, 3, torch.float64, device))
            for b, a in enumerate(rk.alpha.reshape(len(Y), -1)):
                assert bool(qp.is_feasible(a, qp.make_bounds(Y[b], 1.0)))
            np.testing.assert_array_equal(k.predict(Xte), p.predict(Xte))
            rel = (rk.objective - rp.objective).abs() / rp.objective.abs()
            say(f"[small] {kind} {alg}: iterations "
                f"{rk.iterations.tolist()} (plain "
                f"{rp.iterations.tolist()}), objective rel diff "
                f"{float(rel.max()):.3e}, predictions equal")


    from repro_torch.core import grid
    from repro_torch.core.solver import SolverConfig
    X, y = data.multiclass_blobs(300, seed=2, k=3, d=8, sep=4.0)
    Y = mc.ovr_labels(mc.class_index(y)[1], 3, torch.float64, device)
    cfg = SolverConfig(eps=eps)
    for precompute in (True, False):
        fits = {which: grid.solve_grid(X, Y, (4.0, 1.0), (0.05, 0.2), cfg,
                                       impl=which, precompute=precompute,
                                       device=device, dtype=torch.float64)
                for which in (impl, "torch")}
        rk, rp = fits[impl], fits["torch"]
        assert bool(rk.converged.all()) and bool(rp.converged.all())
        assert float(rk.kkt_gap.max()) <= eps
        np.testing.assert_allclose(rk.objective.cpu().numpy(),
                                   rp.objective.cpu().numpy(), rtol=1e-6)
        rel = (rk.objective - rp.objective).abs() / rp.objective.abs()
        say(f"[small] grid 3-class 2x2, {'bank' if precompute else 'rbf'}: "
            f"iterations {rk.iterations.flatten().tolist()} (plain "
            f"{rp.iterations.flatten().tolist()}), objective rel diff "
            f"{float(rel.max()):.3e}")


# ---------------------------------------------------------------------------
# phase 5: the main path at full width
# ---------------------------------------------------------------------------


def loop_iterations(iters, check_every, max_iter):
    """Iterations the host loop runs: it stops at the first check after
    the last lane converged."""
    m = int(iters.max())
    return min(max_iter, check_every * -(-m // check_every))


def fit_full(X, y, Xte, dtype, device):
    from repro_torch.core.solver_fused import CHECK_EVERY
    from repro_torch.svm import SVC
    clf = SVC(C=1.0, gamma="scale", algorithm="pasmo", eps=1e-3,
              device=device, dtype=dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clf.fit(X, y)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    df = clf.decision_function(Xte)
    pred = clf.classes_[torch.argmax(df, dim=-1).cpu().numpy()]
    pred_s = time.perf_counter() - t0
    t = loop_iterations(clf.fit_result_.iterations, CHECK_EVERY,
                        clf.max_iter)
    return clf, pred, wall, t, pred_s


def phase_full(device, timer):
    from repro_torch import kernels
    from repro_torch.core import multiclass as mc
    from repro_torch.core import qp
    from repro_torch.kernels import ref
    from repro_torch.svm import data
    X, y = data.multiclass_blobs(N_TRAIN + N_TEST, seed=0, k=K, d=D,
                                 sep=12.0)
    Xtr, ytr, Xte, yte = X[:N_TRAIN], y[:N_TRAIN], X[N_TRAIN:], y[N_TRAIN:]

    kernels.reset_launches()                 # the main path starts here
    c64, p64, wall64, t64, ps64 = fit_full(Xtr, ytr, Xte, torch.float64,
                                           device)
    c32, p32, wall32, t32, ps32 = fit_full(Xtr, ytr, Xte, torch.float32,
                                           device)
    counts = kernels.launches()              # ... and ends here
    say(f"[full] launches on the main path: {counts}")
    for name in ("rbf_row_wss_batched", "rbf_update_wss_batched"):
        assert counts[name] == t64 + t32, (name, counts, t64, t32)
    assert counts["gram_block"] >= 1, counts
    assert all(counts[name] == 0 for name in BANK_PASSES), counts

    r64, r32 = c64.fit_result_, c32.fit_result_
    for tag, clf, r, pred, wall, t, ps in (
            ("f64", c64, r64, p64, wall64, t64, ps64),
            ("f32", c32, r32, p32, wall32, t32, ps32)):
        acc = float(np.mean(pred == yte))
        say(f"[full] {tag}: l={N_TRAIN} d={D} lanes={K} gamma="
            f"{clf.gamma_:.6g}; iterations per lane "
            f"{r.iterations.tolist()}; loop iterations {t}; fit "
            f"{wall:.3f} s = {wall / t * 1e3:.4f} ms/iteration; predict "
            f"{ps:.3f} s; held-out accuracy {acc:.4f}; converged "
            f"{r.converged.tolist()}")
    assert bool(r64.converged.all()), "f64 full-width fit did not converge"
    assert bool(r32.converged.all()), "f32 full-width fit did not converge"
    agree = float(np.mean(p64 == p32))
    say(f"[full] f32 vs f64 held-out agreement {agree:.4f}")
    assert agree >= 0.99, agree

    # drift of the carried gradient: G = p - K alpha with the plain Gram
    Xt = c64.X_
    Y = mc.ovr_labels(mc.class_index(ytr)[1], K, torch.float64, device)
    Kfull = ref.gram_cross(Xt, Xt, c64.gamma_)
    G_exact = Y - r64.alpha @ Kfull
    del Kfull
    drift = float((G_exact - r64.G).abs().max())
    gaps = []
    for b in range(K):
        bounds = qp.make_bounds(Y[b], 1.0)
        gaps.append(float(qp.kkt_gap(G_exact[b], r64.alpha[b], bounds)))
    say(f"[full] f64 |G_carried - (p - K alpha)|_max = {drift:.3e}; KKT gap "
        f"(recomputed) max {max(gaps):.3e}, carried max "
        f"{float(r64.kkt_gap.max()):.3e}")
    assert drift <= 1e-8, drift
    assert max(gaps) <= 1e-3 and float(r64.kkt_gap.max()) <= 1e-3

    # per-kernel device time at these shapes (f64, the main fit's dtype)
    rec = kernel_times(device, timer)
    ms_iter = wall64 / t64 * 1e3
    share = (rec["rbf_row_wss_batched"]["ms"]
             + rec["rbf_update_wss_batched"]["ms"]) / ms_iter
    say(f"[full] f64 iteration {ms_iter:.4f} ms wall; the two passes' "
        f"device time {rec['rbf_row_wss_batched']['ms']:.4f} + "
        f"{rec['rbf_update_wss_batched']['ms']:.4f} ms = {share:.4f} of it")
    from repro_torch.svm import SVC
    profile_iterations(
        lambda: SVC(C=1.0, gamma="scale", algorithm="pasmo", eps=1e-3,
                    max_iter=64, device=device,
                    dtype=torch.float64).fit(Xtr, ytr),
        "SVC f64 full width", ms_iter)
    return rec, counts


def profile_iterations(run, label, ms_iter, n_iter=64):
    """Device kernels an iteration launches and the device's busy share of
    the iteration's wall time, from ``torch.profiler`` over ``run()``, a
    fit capped at ``n_iter`` iterations at full width (the lanes do not
    converge within it).  The fit's one-off copies (X up, X down for
    ``gamma="scale"``, results down) and Gram-bank builds are reported
    apart from the iterations' kernels."""
    from torch.profiler import ProfilerActivity, profile
    run()                                    # warm-up, outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    once = [e for e in events if e.key.startswith(("Memcpy", "Memset"))
            or "gram_kernel" in e.key]
    kern = [e for e in events if e not in once]
    dev_us = sum(e.self_device_time_total for e in kern)
    if dev_us <= 0:
        say(f"[profile] {label}: torch.profiler recorded no device time: "
            f"busy share not measured")
        return
    busy_ms = dev_us / 1e3 / n_iter
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    say(f"[profile] {label}, {n_iter} iterations: "
        f"{sum(e.count for e in kern) / n_iter:.1f} device kernels an "
        f"iteration, kernels busy {busy_ms:.4f} ms an iteration = "
        f"{busy_ms / ms_iter:.4f} of the unprofiled {ms_iter:.4f} ms wall "
        f"(idle share {1 - busy_ms / ms_iter:.4f}); once per fit (copies, "
        f"Gram bank) "
        f"{sum(e.self_device_time_total for e in once) / 1e3:.4f} ms in "
        f"all; top kernels by device time: "
        + "; ".join(f"{e.key.removeprefix('void ')[:50]} "
                    f"x{e.count / n_iter:.1f} "
                    f"{e.self_device_time_total / 1e3 / n_iter:.4f} ms"
                    for e in top))


def kernel_times(device, timer):
    from repro_torch.kernels import (build, gram_block, rbf_row_wss,
                                     rbf_update_wss, ref)
    recs = {}
    for dtype in (torch.float64, torch.float32):
        item = torch.tensor([], dtype=dtype).element_size()
        a, b = kernel_state(N_TRAIN, D, K, seed=1, dtype=dtype, device=device)
        XT = a["X"].T.contiguous()
        args_a = [a[k] for k in ("X", "sqn", "G", "alpha", "L", "U", "XQ",
                                 "sqq", "a_i", "L_i", "U_i", "g_i", "i_idx",
                                 "use_exact", "gammas")]
        args_b = [b[k] for k in ("X", "sqn", "G", "alpha_new", "L", "U",
                                 "XQi", "sqqi", "XQj", "sqqj", "mu",
                                 "gammas")]
        l, d, B = N_TRAIN, D, K
        bl = build.BLOCK_L
        nb = -(-l // bl)
        Xte = torch.tensor(np.random.default_rng(2).normal(size=(N_TEST, D)),
                           dtype=dtype, device=device)
        Xtr = a["X"]
        gam = 1.0 / (2 * D)
        cases = {
            "rbf_row_wss_batched": (
                lambda: rbf_row_wss.rbf_row_wss_batched(*args_a, XT=XT),
                lambda: ref.rbf_row_wss_batched_blocks(*args_a, block_l=bl),
                None,
                # X, sqn, 4 state rows, query rows, 6 lane vectors + index
                # + flag in; (B, nb) max and int32 arg out
                (l * d + l + 4 * B * l + B * d + 6 * B) * item + 5 * B
                + B * nb * (item + 4),
                2 * B * l * d + 20 * B * l),
            "rbf_update_wss_batched": (
                lambda: rbf_update_wss.rbf_update_wss_batched(*args_b, XT=XT),
                lambda: ref.rbf_update_wss_batched_blocks(*args_b, block_l=bl),
                None,
                (l * d + l + 4 * B * l + 2 * B * d + 4 * B) * item
                + B * l * item + B * nb * (2 * item + 4),
                4 * B * l * d + 20 * B * l),
            "gram_block": (
                lambda: gram_block.gram_cross(Xte, Xtr, gam),
                lambda: ref.gram_cross(Xte, Xtr, gam),
                lambda: torch.exp(-gam * torch.cdist(Xte, Xtr).square()),
                (N_TEST * D + N_TRAIN * D + N_TEST * N_TRAIN) * item,
                2 * N_TEST * N_TRAIN * D + 6 * N_TEST * N_TRAIN),
        }
        for name, (kern, plain, comp, nbytes, nops) in cases.items():
            # reps keep every queued launch inside the card's queue
            reps, preps = (10, 10) if name == "gram_block" else (100, 20)
            ms_k = timer.ms(kern, reps)
            ms_p = timer.ms(plain, preps)
            ms_k2 = timer.ms(kern, reps)
            ms_p2 = timer.ms(plain, preps)
            comp_ms = timer.ms(comp, preps) if comp is not None else None
            bms, by = bound_ms(nbytes, nops, dtype)
            say(f"[time] {name} {str(dtype)[6:]}: kernel {ms_k:.5f} / "
                f"{ms_k2:.5f} ms, plain {ms_p:.5f} / {ms_p2:.5f} ms, bound "
                f"{bms:.5f} ms by {by} ({nbytes / 1e6:.3f} MB, "
                f"{nops / 1e9:.4f} GFLOP at {HBM_BYTES_PER_S / 1e12} TB/s, "
                f"{PEAK_OPS_PER_S[dtype] / 1e12} TFLOP/s)"
                + ("" if comp_ms is None else
                   f"; composite yardstick exp(-g*cdist^2), three PyTorch "
                   f"calls the port never makes: {comp_ms:.5f} ms"))
            if dtype == torch.float64:
                recs[name] = dict(ms=min(ms_k, ms_k2),
                                  plain_ms=min(ms_p, ms_p2), bound_ms=bms,
                                  bound_by=by)
    return recs


# ---------------------------------------------------------------------------
# phase 6: the (C, gamma) grid at full width
# ---------------------------------------------------------------------------


def fit_grid(solve, device):
    """Run ``solve()`` with the launch counts set to 0 just before and read
    just after; returns (result, counts, wall s, loop iterations, peak
    bytes)."""
    from repro_torch import kernels
    from repro_torch.core.solver_fused import CHECK_EVERY
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    r = solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    t = loop_iterations(r.iterations, CHECK_EVERY, 1_000_000)
    return r, counts, wall, t, torch.cuda.max_memory_allocated(device)


def check_counts(counts, t, bank: bool, label):
    """Each iteration launches one pass A and one pass B of its row source
    and none of the other; a bank build launches the Gram kernel once per
    gamma."""
    on, off = (BANK_PASSES, RBF_PASSES) if bank else (RBF_PASSES,
                                                      BANK_PASSES)
    n_gram = len(GRID_GAMMA_FACTORS) if bank else 0
    for name in on:
        assert counts[name] == t, (label, name, counts, t)
    for name in off:
        assert counts[name] == 0, (label, name, counts)
    assert counts["gram_block"] == n_gram, (label, counts)


def phase_grid(device, timer):
    from repro_torch.core import grid
    from repro_torch.core import multiclass as mc
    from repro_torch.core import qp
    from repro_torch.core.solver import SolverConfig
    from repro_torch.svm import data
    X, y = data.multiclass_blobs(N_TRAIN + N_TEST, seed=0, k=K, d=D,
                                 sep=12.0)
    Xtr, ytr, Xte, yte = X[:N_TRAIN], y[:N_TRAIN], X[N_TRAIN:], y[N_TRAIN:]
    gamma_scale = 1.0 / (D * float(Xtr.var()))
    gammas = [gamma_scale * f for f in GRID_GAMMA_FACTORS]
    eps = 1e-3
    cfg = SolverConfig(algorithm="pasmo", eps=eps)
    Y = mc.ovr_labels(mc.class_index(ytr)[1], K, torch.float64, device)
    runs, bank_counts = {}, {}
    for tag, dtype, precompute in (("bank f64", torch.float64, True),
                                   ("rbf f64", torch.float64, False),
                                   ("bank f32", torch.float32, True)):
        r, counts, wall, t, peak = fit_grid(
            lambda: grid.solve_grid(Xtr, Y, GRID_CS, gammas, cfg,
                                    impl="auto", precompute=precompute,
                                    device=device, dtype=dtype), device)
        say(f"[grid] {tag}: launches {counts}")
        check_counts(counts, t, precompute, tag)
        if precompute:
            for name in BANK_PASSES:
                bank_counts[name] = bank_counts.get(name, 0) + counts[name]
        df = grid.grid_decision(Xte, Xtr, gammas, r.alpha, r.b)
        acc = (torch.argmax(df, dim=1).cpu().numpy()
               == yte[None, None, :]).mean(axis=-1)       # (n_gamma, n_C)
        its = r.iterations
        say(f"[grid] {tag}: l={N_TRAIN} d={D} lanes={r.alpha.shape[:3]} "
            f"gammas={[f'{g:.6g}' for g in gammas]} Cs={list(GRID_CS)}; "
            f"iterations per lane min {int(its.min())} median "
            f"{int(its.flatten().median())} max {int(its.max())}; loop "
            f"iterations {t}; fit {wall:.3f} s = {wall / t * 1e3:.4f} "
            f"ms/iteration; peak device memory {peak / 1e9:.3f} GB; "
            f"converged {int(r.converged.sum())}/{r.converged.numel()}; "
            f"max KKT gap {float(r.kkt_gap.max()):.4e}")
        for g, gam in enumerate(gammas):
            say(f"[grid] {tag}: gamma {gam:.6g}: held-out accuracy by C "
                + ", ".join(f"C={c}: {acc[g, ci]:.4f}"
                            for ci, c in enumerate(GRID_CS))
                + f"; free SVs by C (class sums) "
                + ", ".join(str(int(r.n_free_sv[g, :, ci].sum()))
                            for ci in range(len(GRID_CS))))
        assert bool(r.converged.all()), f"{tag}: a lane did not converge"
        assert float(r.kkt_gap.max()) <= eps, tag
        runs[tag] = (r, wall, t)

    rb, rr, r32 = (runs[k][0] for k in ("bank f64", "rbf f64", "bank f32"))
    rel = float(((rb.objective - rr.objective).abs()
                 / rr.objective.abs()).max())
    rel32 = float(((r32.objective.double() - rb.objective).abs()
                   / rb.objective.abs()).max())
    say(f"[grid] objectives: bank vs rbf (f64) max rel diff {rel:.3e}; "
        f"f32 bank vs f64 bank {rel32:.3e}")
    np.testing.assert_allclose(rb.objective.cpu().numpy(),
                               rr.objective.cpu().numpy(), rtol=1e-6)

    # drift of the carried gradient against G = p - K alpha with the plain
    # Gram, and the KKT gap recomputed from it
    Xt = torch.as_tensor(Xtr, dtype=torch.float64, device=device)
    D2 = grid.sqdist(Xt)
    YC = Y[:, None, :] * torch.tensor(GRID_CS, dtype=torch.float64,
                                      device=device)[None, :, None]
    L, U = torch.clamp_max(YC, 0.0), torch.clamp_min(YC, 0.0)
    drift, gap = {}, {}
    for g, gam in enumerate(gammas):
        Kg = torch.exp(-gam * D2)
        for tag, r in (("bank", rb), ("rbf", rr)):
            G_exact = Y[:, None, :] - r.alpha[g] @ Kg
            drift[tag] = max(drift.get(tag, 0.0),
                             float((G_exact - r.G[g]).abs().max()))
            up = torch.where(r.alpha[g] < U, G_exact, -math.inf).amax(-1)
            dn = torch.where(r.alpha[g] > L, G_exact, math.inf).amin(-1)
            gap[tag] = max(gap.get(tag, 0.0),
                           float(qp.finite_gap(up - dn).max()))
        del Kg
    del D2
    say(f"[grid] f64 |G_carried - (p - K alpha)|_max: bank {drift['bank']:.3e}"
        f", rbf {drift['rbf']:.3e}; KKT gap recomputed from it: bank "
        f"{gap['bank']:.4e}, rbf {gap['rbf']:.4e}")
    assert max(drift.values()) <= 1e-8, drift
    assert max(gap.values()) <= eps, gap
    _, wall, t = runs["bank f64"]
    ms_bank = wall / t * 1e3
    del runs, rb, rr, r32

    recs = grid_kernel_times(device, timer)
    profile_iterations(
        lambda: grid.solve_grid(Xtr, Y, GRID_CS, gammas,
                                SolverConfig(algorithm="pasmo", eps=eps,
                                             max_iter=64),
                                impl="auto", precompute=True, device=device,
                                dtype=torch.float64),
        "grid bank f64 full width", ms_bank)
    phase_oneclass(Xtr, gammas, device)
    return recs, bank_counts


def grid_kernel_times(device, timer):
    """Kernels 1, 2, 4 and 5 at the grid's shapes (l = 16384, B = 90, a
    3-entry bank), and the bank build: device time, plain version's time
    and bound."""
    from repro_torch.kernels import (build, ops, rbf_row_wss, rbf_update_wss,
                                     ref)
    recs = {}
    l, d, B, bl = N_TRAIN, D, GRID_B, build.BLOCK_L
    nb = -(-l // bl)
    for dtype in (torch.float64, torch.float32):
        item = torch.tensor([], dtype=dtype).element_size()
        ba, bb = bank_state(l, B, 3, seed=1, dtype=dtype, device=device)
        args_a = [ba[k] for k in BANK_A]
        args_b = [bb[k] for k in BANK_B]
        a, b = kernel_state(l, d, B, seed=1, dtype=dtype, device=device)
        XT = a["X"].T.contiguous()
        args_ra = [a[k] for k in ("X", "sqn", "G", "alpha", "L", "U", "XQ",
                                  "sqq", "a_i", "L_i", "U_i", "g_i", "i_idx",
                                  "use_exact", "gammas")]
        args_rb = [b[k] for k in ("X", "sqn", "G", "alpha_new", "L", "U",
                                  "XQi", "sqqi", "XQj", "sqqj", "mu",
                                  "gammas")]
        cases = {
            "row_wss_batched_rows": (
                lambda: rbf_row_wss.row_wss_batched_rows(*args_a),
                lambda: ref.row_wss_batched_rows_blocks(*args_a, block_l=bl),
                # B bank rows + 4 state rows, 4 lane vectors, the int32 i,
                # int64 bank index and flag in; (B, nb) max and arg out
                5 * B * l * item + 4 * B * item + 13 * B
                + B * nb * (item + 4),
                20 * B * l),
            "update_wss_batched_rows": (
                lambda: rbf_update_wss.update_wss_batched_rows(*args_b),
                lambda: ref.update_wss_batched_rows_blocks(*args_b,
                                                           block_l=bl),
                # 2 B bank rows + 4 state rows in, G out, mu, i, j, bank
                # index in; (B, nb) max, arg and min out
                7 * B * l * item + B * item + 16 * B
                + B * nb * (2 * item + 4),
                6 * B * l),
            "rbf_row_wss_batched": (
                lambda: rbf_row_wss.rbf_row_wss_batched(*args_ra, XT=XT),
                lambda: ref.rbf_row_wss_batched_blocks(*args_ra, block_l=bl),
                (l * d + l + 4 * B * l + B * d + 6 * B) * item + 5 * B
                + B * nb * (item + 4),
                2 * B * l * d + 20 * B * l),
            "rbf_update_wss_batched": (
                lambda: rbf_update_wss.rbf_update_wss_batched(*args_rb,
                                                              XT=XT),
                lambda: ref.rbf_update_wss_batched_blocks(*args_rb,
                                                          block_l=bl),
                (l * d + l + 4 * B * l + 2 * B * d + 4 * B) * item
                + B * l * item + B * nb * (2 * item + 4),
                4 * B * l * d + 20 * B * l),
        }
        for name, (kern, plain, nbytes, nops) in cases.items():
            ms_k = timer.ms(kern, 100)
            ms_p = timer.ms(plain, 10)
            ms_k2 = timer.ms(kern, 100)
            ms_p2 = timer.ms(plain, 10)
            bms, by = bound_ms(nbytes, nops, dtype)
            say(f"[time] {name} B={B} {str(dtype)[6:]}: kernel {ms_k:.5f} / "
                f"{ms_k2:.5f} ms, plain {ms_p:.5f} / {ms_p2:.5f} ms, bound "
                f"{bms:.5f} ms by {by} ({nbytes / 1e6:.3f} MB, "
                f"{nops / 1e9:.4f} GFLOP)")
            if dtype == torch.float64 and name in BANK_PASSES:
                recs[name] = dict(ms=min(ms_k, ms_k2),
                                  plain_ms=min(ms_p, ms_p2), bound_ms=bms,
                                  bound_by=by)
        del ba, bb, a, b, args_a, args_b, args_ra, args_rb, XT
        # the bank build: one Gram launch per gamma into one (3, l, l) tensor
        X = torch.tensor(np.random.default_rng(2).normal(size=(l, d)),
                         dtype=dtype, device=device)
        gammas = [0.5 / d, 1.0 / d, 2.0 / d]
        ms_k = timer.ms(lambda: ops.gram_bank(X, gammas, impl="cuda"), 3)
        ms_p = timer.ms(lambda: ops.gram_bank(X, gammas, impl="torch"), 3)
        bms, by = bound_ms(3 * l * l * item + l * d * item,
                           3 * (2 * l * l * d + 6 * l * l), dtype)
        say(f"[time] bank build 3 x {l}^2 {str(dtype)[6:]}: Gram kernel "
            f"{ms_k:.4f} ms, plain {ms_p:.4f} ms, bound {bms:.4f} ms by {by}")
        del X
    return recs


def phase_oneclass(Xtr, gammas, device):
    """The one-class (gamma, nu) grid at full width through both row
    sources: convergence, objective agreement, launch counts, and each
    lane's fraction of training outliers beside its nu."""
    from repro_torch.core import grid
    from repro_torch.core.solver import SolverConfig
    eps = 1e-3
    cfg = SolverConfig(algorithm="pasmo", eps=eps)
    res = {}
    for precompute in (True, False):
        tag = "bank" if precompute else "rbf"
        r, counts, wall, t, peak = fit_grid(
            lambda: grid.solve_grid_oneclass(
                Xtr, GRID_NUS, gammas, cfg, impl="auto",
                precompute=precompute, device=device, dtype=torch.float64),
            device)
        check_counts(counts, t, precompute, f"one-class {tag}")
        # training decision -G + b: an outlier has G > b (rho = -b)
        out = (r.G > r.b[..., None]).double().mean(dim=-1)
        sv = (r.alpha > 0).double().mean(dim=-1)
        say(f"[oneclass] {tag} f64: l={N_TRAIN} lanes="
            f"{tuple(r.alpha.shape[:2])}; iterations per lane "
            f"{r.iterations.flatten().tolist()}; loop iterations {t}; {wall:.3f} s = {wall / t * 1e3:.4f} "
            f"ms/iteration; peak device memory {peak / 1e9:.3f} GB; "
            f"launches {counts}; converged "
            f"{int(r.converged.sum())}/{r.converged.numel()}")
        for g, gam in enumerate(gammas):
            say(f"[oneclass] {tag}: gamma {gam:.6g}: "
                + "; ".join(f"nu {nu}: outlier fraction "
                            f"{float(out[g, n]):.4f}, SV fraction "
                            f"{float(sv[g, n]):.4f}"
                            for n, nu in enumerate(GRID_NUS)))
        assert bool(r.converged.all()), f"one-class {tag} did not converge"
        assert float(r.kkt_gap.max()) <= eps
        res[tag] = r
    rel = float(((res["bank"].objective - res["rbf"].objective).abs()
                 / res["rbf"].objective.abs()).max())
    say(f"[oneclass] objectives bank vs rbf max rel diff {rel:.3e}")
    np.testing.assert_allclose(res["bank"].objective.cpu().numpy(),
                               res["rbf"].objective.cpu().numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e}); run "
              f"from the root of a checkout", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    smi = phase_env()
    phase_build()
    timer = DeviceTimer()
    errs = phase_kernels(device)
    phase_small(device, "cuda")
    recs, counts = phase_full(device, timer)
    say(f"[time] slice 1 phases done at {time.perf_counter() - t_start:.1f} s")
    grid_recs, bank_counts = phase_grid(device, timer)
    recs.update(grid_recs)
    counts.update(bank_counts)
    out = []
    for name, (src, replaces) in SOURCES.items():
        r = recs[name]
        out.append(dict(name=name, route="cuda", source=src,
                        replaces=replaces, launches=counts[name],
                        max_abs_err=errs[name], ms=r["ms"],
                        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                        bound_by=r["bound_by"], library_ms=None))
    say(f"[done] {time.perf_counter() - t_start:.1f} s; card: {smi}")
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
