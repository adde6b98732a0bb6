#!/usr/bin/env python3
"""The Gram-bank passes (kernels 4 and 5) and the bank cells, timed in two
checkouts on one card.

    python3 benchmarks/torch_bank_ab.py --against OTHER_CHECKOUT
        [--part kernels|cells|all] [--out FILE.json]

from the root of a checkout, on a CUDA card.  Runs one process per
(checkout, turn), in the order other, this, this, other, so that a drift
of the card or the host falls on both alike; each process imports
``repro_torch`` and ``chip_smoke`` from its own checkout and builds its
kernels there (set-up, not timed).  The parts:

* ``kernels``: each variant of the bank passes at the shapes of
  ``PERF.md``'s kernel table (l = 16384, f64 and f32): the wrapper alone (the
  checkout's kernel: per-block partials, or the lanes' results where the
  kernel folds the pick in) and the dispatch ``ops.row_wss_batched_bank``
  / ``ops.update_wss_batched_bank`` on ``impl="cuda"`` (the kernel and
  whatever reduces its output to the lanes' results), cycling through
  copies of the inputs that hold four L2s (``chip_smoke.cold_copies``),
  timed by ``chip_smoke.DeviceTimer``; a no-op launch; and a SHA-256 of
  every output of the dispatch in every variant at the states of
  ``chip_smoke.py``'s phase 3 (both dtypes), for a bitwise comparison of
  the checkouts.
* ``cells``: the bank cells of ``chip_smoke.py``'s phases 6, 8, 9 and 10
  and the one-class bank grid: loop iterations, ms an iteration (one
  counted run, the bank build included, as ``chip_smoke.py`` times it),
  device kernels an iteration (a ``torch.profiler`` window over a capped
  run) and a SHA-256 of the result's alpha and G.

Prints the card's name and power limit and a table by checkout: the
medians of the two turns, and whether the checkouts' hashes agree;
``--out`` keeps every turn's record.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve()
ROOT = HERE.parents[1]
L = 16384
# (pass, H, act, conj, B): the rows of PERF.md's kernel table
VARIANTS = (("A", 1, False, False, 90), ("A", 2, False, False, 18),
            ("A", 2, True, False, 18), ("A", 1, True, False, 90),
            ("B", 1, False, False, 90), ("B", 2, False, False, 18),
            ("B", 2, True, False, 18), ("B", 1, True, False, 90),
            ("B", 1, False, True, 90), ("B", 1, True, True, 90),
            ("B", 2, True, True, 1), ("B", 2, False, True, 18))
# (l, B, bank entries) of chip_smoke.py's phase 3 states
STATES = ((L, 90, 3), (L, 18, 3), (L, 3, 3), (L, 1, 1), (1001, 90, 3),
          (1001, 1, 1), (300, 19, 3))


def _sha(t) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()[:16]


def variant_name(v) -> str:
    p, H, act, conj, B = v
    return (f"{'4' if p == 'A' else '5'} H={H}{' act' if act else ''}"
            f"{' conj' if conj else ''} B={B}")


def _calls(cs, v, state, act, dirv, mu2):
    """(wrapper, dispatch) of variant ``v`` on one state's tensors."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import rbf_row_wss as pa
    from repro_torch.kernels import rbf_update_wss as pb
    p, H, _, conj, _ = v
    dup = H == 2
    if p == "A":
        args = [state[k] for k in cs.BANK_A]
        if act is not None:
            kern = lambda: pa.row_wss_batched_rows_act(*args, act, dup=dup)
        else:
            kern = lambda: (pa.row_wss_batched_rows_h2 if dup
                            else pa.row_wss_batched_rows)(*args)
        disp = lambda: ops.row_wss_batched_bank(*args, impl="cuda", dup=dup,
                                                act=act)
        return kern, disp
    args = [state[k] for k in cs.BANK_B]
    if conj:
        kern = lambda: pb.update_wss_batched_rows_conj(*args, dirv, mu2,
                                                       dup=dup, act=act)
    elif act is not None:
        kern = lambda: pb.update_wss_batched_rows_act(*args, act, dup=dup)
    else:
        kern = lambda: (pb.update_wss_batched_rows_h2 if dup
                        else pb.update_wss_batched_rows)(*args)
    kw = dict(dirv=dirv, mu2=mu2) if conj else {}
    disp = lambda: ops.update_wss_batched_bank(*args, impl="cuda", dup=dup,
                                               act=act, **kw)
    return kern, disp


def kernels(cs, dev) -> dict:
    import torch
    timer = cs.DeviceTimer()
    out = {"noop_ms": min(timer.ms(lambda: torch.cuda._sleep(0), 100)
                          for _ in range(2))}
    states = {}
    for dtype, v in ((dt, v) for dt in (torch.float64, torch.float32)
                     for v in VARIANTS):
        item = torch.tensor([], dtype=dtype).element_size()
        p, H, masked, conj, B = v
        dup, n = H == 2, H * L
        key = (B, dup, dtype)
        if key not in states:
            if states and next(iter(states))[2] != dtype:
                states.clear()
            states[key] = cs.bank_state(L, B, 3 if B > 1 else 1, 1, dtype,
                                        dev, dup=dup)
        ba, bb = states[key]
        state = dict(ba if p == "A" else bb)
        lo, hi = (L - 3, L + 5) if dup else (5, L - 3)
        if masked:
            state["act"] = cs.act_mask(B, n, (lo, hi), 1, dev)
        if conj:
            state["dirv"], state["mu2"] = cs.conj_inputs(bb, L, B, 1, dev)
        rows = B * L * (1 if p == "A" else 2)
        nbytes = (rows + 4 * B * n) * item + masked * B * n
        if p == "B":
            nbytes += B * n * item + conj * 2 * B * L * item
        nc = cs.n_cold(nbytes)
        copies = cs.cold_copies(state, nc, n)
        calls = [_calls(cs, v, c, c.get("act"), c.get("dirv"), c.get("mu2"))
                 for c in copies]
        t = {}
        for rnd in range(2):
            for k, which in (("kernel_ms", 0), ("dispatch_ms", 1)):
                ms = timer.ms(cs.cycling(lambda c: calls[c][which](), nc),
                              100)
                t[k] = ms if rnd == 0 else min(t[k], ms)
        name = f"{str(dtype)[6:]} {variant_name(v)}"
        out[name] = t
        cs.say(f"[ab] {name}: {t}")
        del copies, calls
    states.clear()
    hashes = {}
    for dt in (torch.float64, torch.float32):
        for l, B, n_stack in STATES:
            for dup in (False, True):
                n = 2 * l if dup else l
                lo, hi = (l - 3, l + 5) if dup else (5, l - 3)
                a, b = cs.bank_state(l, B, n_stack, l + B, dt, dev, dup=dup)
                act = cs.act_mask(B, n, (lo, hi), l + B + dup, dev)
                bc = b if B > 2 else dict(b, mu=torch.full_like(b["mu"], 0.7))
                dirv, mu2 = cs.conj_inputs(bc, l, B, l + B + dup, dev)
                for masked in (False, True):
                    m = act if masked else None
                    for v, st, d, m2 in (
                            (("A", 1 + dup, masked, False, B), a, None, None),
                            (("B", 1 + dup, masked, False, B), b, None, None),
                            (("B", 1 + dup, masked, True, B), bc, dirv, mu2)):
                        got = _calls(cs, v, st, m, d, m2)[1]()
                        hashes[f"{str(dt)[6:]} l={l} {variant_name(v)}"] = \
                            [_sha(x) for x in got]
                del a, b, bc, act
    out["hashes"] = hashes
    return out


def cells(cs, dev) -> dict:
    import torch
    from repro_torch.core import grid
    from repro_torch.core import multiclass as mc
    from repro_torch.core.solver import SolverConfig
    from repro_torch.svm import data
    X, y = data.multiclass_blobs(cs.N_TRAIN + cs.N_TEST, seed=0, k=cs.K,
                                 d=cs.D, sep=12.0)
    Xtr, ytr = X[:cs.N_TRAIN], y[:cs.N_TRAIN]
    gs = 1.0 / (cs.D * float(Xtr.var()))
    gammas = [gs * f for f in cs.GRID_GAMMA_FACTORS]
    sgammas = [gs * f for f in cs.SVR_GAMMA_FACTORS]
    Y = mc.ovr_labels(mc.class_index(ytr)[1], cs.K, torch.float64, dev)
    yv = cs.sinc_target(X, 7)[:cs.N_TRAIN]
    f64 = dict(device=dev, dtype=torch.float64)
    pasmo = dict(algorithm="pasmo", eps=1e-3)
    conj = dict(algorithm="smo", step="conjugate", eps=1e-3)
    svc = lambda c, **kw: grid.solve_grid(Xtr, Y, cs.GRID_CS, gammas, c,
                                          impl="auto", precompute=True, **kw)
    svr = lambda c, **kw: grid.solve_grid_svr(
        Xtr, yv, cs.SVR_GRID_CS, cs.SVR_EPSILONS, sgammas, c,
        precompute=True, **kw)
    # name: (config, fit, profiled iterations: one mask refresh inside
    # with shrinking)
    runs = {
        "grid bank f64 (6)": (pasmo, lambda c: svc(c, **f64), 32),
        "grid bank f32 (6)": (pasmo, lambda c: svc(
            c, device=dev, dtype=torch.float32), 32),
        "one-class bank (6)": (pasmo, lambda c: grid.solve_grid_oneclass(
            Xtr, cs.GRID_NUS, gammas, c, impl="auto", precompute=True,
            **f64), 32),
        "e-SVR grid bank (8)": (pasmo, lambda c: svr(c, **f64), 32),
        "grid bank shrinking (9)": (pasmo, lambda c: svc(
            c, shrinking=True, **f64), 64),
        "e-SVR grid bank shrinking (9)": (pasmo, lambda c: svr(
            c, shrinking=True, **f64), 64),
        "grid bank conjugate (10)": (conj, lambda c: svc(c, **f64), 32),
        "grid bank conjugate shrinking (10)": (conj, lambda c: svc(
            c, shrinking=True, **f64), 64),
        "e-SVR lane bank shrinking conjugate (10)": (
            conj, lambda c: grid.solve_grid_svr(
                Xtr, yv, [10.0], [0.1], [gs], c, precompute=True,
                shrinking=True, **f64), 64),
    }
    out = {}
    for name, (kw, fit, n_prof) in runs.items():
        r, _, wall, t, _ = cs.fit_grid(lambda: fit(SolverConfig(**kw)), dev)
        ms = wall / t * 1e3
        prof = cs.profile_iterations(
            lambda: fit(SolverConfig(**kw, max_iter=n_prof)), name, ms,
            n_prof) or {}
        out[name] = dict(loop=t, ms_iter=ms, kernels=prof.get("kernels"),
                         busy_ms=prof.get("busy_ms"),
                         alpha=_sha(r.alpha), G=_sha(r.G))
        cs.say(f"[ab] {name}: {out[name]}")
        del r
    return out


def run(root: pathlib.Path, part: str) -> dict:
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    assert pathlib.Path(build.__file__).is_relative_to(root)
    assert pathlib.Path(cs.__file__).is_relative_to(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    build.load()
    dev = torch.device("cuda", 0)
    out = {}
    if part in ("kernels", "all"):
        out["kernels"] = kernels(cs, dev)
    if part in ("cells", "all"):
        out["cells"] = cells(cs, dev)
    return out


def _table(turns: dict) -> None:
    for part in ("kernels", "cells"):
        if part not in turns["this"][0]:
            continue
        for name, rec in turns["this"][0][part].items():
            if name == "hashes":
                other = [t[part]["hashes"] for t in turns["other"]]
                this = [t[part]["hashes"] for t in turns["this"]]
                same = all(h == this[0] for h in other + this)
                diff = [k for k in this[0] if other[0].get(k) != this[0][k]]
                print(f"[ab] {part} outputs bitwise equal across checkouts "
                      f"and turns: {same} ({len(this[0])} variant states; "
                      f"differing: {diff[:8]})", flush=True)
                continue
            if not isinstance(rec, dict):
                o = statistics.median(t[part][name] for t in turns["other"])
                s = statistics.median(t[part][name] for t in turns["this"])
                print(f"[ab] {part} {name}: other {o:.5f} this {s:.5f}",
                      flush=True)
                continue
            cols = []
            for k, val in rec.items():
                if isinstance(val, str):
                    cols.append(f"{k} same: "
                                + str(len({t[part][name][k] for tag in turns
                                           for t in turns[tag]}) == 1))
                elif val is not None:
                    o = statistics.median(t[part][name][k]
                                          for t in turns["other"])
                    s = statistics.median(t[part][name][k]
                                          for t in turns["this"])
                    cols.append(f"{k} other {o:.5f} this {s:.5f}")
            print(f"[ab] {part} {name}: " + "; ".join(cols), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=pathlib.Path)
    ap.add_argument("--part", choices=("kernels", "cells", "all"),
                    default="all")
    ap.add_argument("--out", type=pathlib.Path,
                    help="write every turn's JSON record here")
    ap.add_argument("--run", action="store_true")
    ap.add_argument("--root", type=pathlib.Path, default=ROOT)
    args = ap.parse_args(argv)
    if args.run:
        print(json.dumps(run(args.root.resolve(), args.part)), flush=True)
        return 0
    if args.against is None:
        ap.error("--against OTHER_CHECKOUT is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    other = args.against.resolve()
    turns = {"other": [], "this": []}
    for tag, root in (("other", other), ("this", ROOT), ("this", ROOT),
                      ("other", other)):
        p = subprocess.run([sys.executable, str(HERE), "--run", "--root",
                            str(root), "--part", args.part],
                           capture_output=True, text=True, timeout=1800)
        if p.returncode:
            print(p.stdout[-4000:], p.stderr[-8000:], sep="\n")
            return 1
        turns[tag].append(json.loads(p.stdout.strip().splitlines()[-1]))
        print(f"[{tag}] {root}: done", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(turns))
    _table(turns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
