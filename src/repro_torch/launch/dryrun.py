"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on a fake mesh.

The port of ``repro.launch.dryrun``.  Where the reference lowers and
compiles each cell with XLA on forced host devices, the port traces it:
a fake process group of the mesh's size (``REPRO_DRYRUN_DEVICES`` ranks,
default the mesh's size; nothing is set at import), ``FakeTensorMode``
parameters, optimizer state, batch and cache on their placements (no
memory), and one ``train_step``, one prefill or one decode step run under
:class:`repro_torch.launch.cost_analysis.CostMode`, which counts the
per-device FLOPs, bytes and collectives on the local shards.  For each
cell it writes a JSON record with the reference's keys:

  * the trace's wall time (``time_lower_s`` and ``time_compile_s`` are
    both the trace time; there is no compile),
  * per-device FLOPs and bytes (``hlo_flops``, ``hlo_bytes``: the
    dispatch count, not an HLO's), collective operand bytes by kind,
    the loops' trips (:func:`cell_loops`: the step's Python loops, each
    trip traced),
  * ``memory_analysis`` null (no compiler to ask) and the analytic
    per-device bytes of the inputs under their shardings,
  * the roofline terms at the H100's published peaks
    (:mod:`repro_torch.launch.roofline`).

Fake tensors trace on ``cuda`` in a CUDA build of PyTorch, so SDPA's CUDA
kernels are what gets counted; a CPU-only build cannot run ops on fake
CUDA tensors (it is not linked with CUDA), so there the cells trace on
``cpu`` (``--device``), where SDPA is its CPU kernel.

Usage:
  python -m repro_torch.launch.dryrun --mesh single --arch all --shape all
  python -m repro_torch.launch.dryrun --mesh multi --arch grok-1-314b \
      --shape train_4k --out artifacts/dryrun_torch
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import ARCHS, get_config, get_shape
from repro_torch.configs.base import (SHAPES, ModelConfig, ServeConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.launch import roofline as rf
from repro_torch.launch.cost_analysis import CostMode
from repro_torch.models import registry
from repro_torch.sharding import (DEFAULT_RULES, Rules, axis_rules,
                                  map_logical, mesh_shape, place_tree,
                                  tree_shardings)
from repro_torch.tree import leaves

OUT = os.path.join("artifacts", "dryrun_torch")


def choose_microbatches(shape: ShapeConfig, cfg: ModelConfig,
                        dp: int) -> int:
    """Keep per-device microbatch activation footprints sane: target ~4k
    tokens per device per microbatch for d_model >= 4096, 16k below."""
    b_dev = max(1, shape.global_batch // dp)
    target_tokens = 4096 if cfg.d_model >= 4096 else 16384
    mb_rows = max(1, target_tokens // shape.seq_len)
    m = max(1, math.ceil(b_dev / mb_rows))
    while b_dev % m != 0:
        m += 1
    return min(m, b_dev)


def dp_size(mesh) -> int:
    shape = mesh_shape(mesh)
    return shape.get("data", 1) * shape.get("pod", 1)


def trace_device() -> str:
    """``cuda`` in a CUDA build of PyTorch (fake CUDA tensors need no
    card), else ``cpu``."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _empty_like_specs(tree, device):
    """Fake tensors of a tree of ``meta`` tensors (or shape tuples under a
    logical tree), on ``device``."""
    return map_logical(lambda lg, t: torch.empty(
        t.shape, dtype=t.dtype, device=device), *tree)


def _params(cfg, mesh, rules, device):
    lg = registry.param_logical(cfg)
    plain = map_logical(lambda _, s: torch.empty(
        s, dtype=torch.bfloat16, device=device), lg,
        registry.param_shapes(cfg))
    return plain, tree_shardings(lg, plain, mesh, rules)


def _inputs(cfg, shape, mesh, rules, device, drop=()):
    lg = registry.train_input_logical(cfg)
    specs = registry.train_input_specs(cfg, shape)
    for k in drop:
        lg.pop(k)
        specs.pop(k)
    plain = _empty_like_specs((lg, specs), device)
    return place_tree(plain, tree_shardings(lg, plain, mesh, rules))


def build_train(cfg: ModelConfig, shape: ShapeConfig, mesh, rules: Rules,
                device):
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_step import (TrainState, make_train_step,
                                              shard_state)
    tc = TrainConfig(seq_len=shape.seq_len, global_batch=shape.global_batch,
                     microbatches=choose_microbatches(shape, cfg,
                                                      dp_size(mesh)),
                     remat="full")
    params, _ = _params(cfg, mesh, rules, device)
    state = TrainState(params=params, opt=opt_mod.init(params, tc), ef=None,
                       step=torch.zeros((), dtype=torch.int32,
                                        device=device))
    state = shard_state(state, cfg, mesh, rules)
    batch = _inputs(cfg, shape, mesh, rules, device)
    return make_train_step(cfg, tc), (state, batch), dataclasses.asdict(tc)


def build_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh, rules: Rules,
                  device):
    from repro_torch.train.serve_step import make_prefill
    sc = ServeConfig(seq_len=shape.seq_len, batch=shape.global_batch)
    params, sh = _params(cfg, mesh, rules, device)
    batch = _inputs(cfg, shape, mesh, rules, device, drop=("labels",))
    return make_prefill(cfg, sc), (place_tree(params, sh), batch), \
        dataclasses.asdict(sc)


def build_decode(cfg: ModelConfig, shape: ShapeConfig, mesh, rules: Rules,
                 device):
    """One decode step at position ``seq_len - 1`` of a full cache (the
    port's decode takes the position as an int)."""
    from repro_torch.data import shard_batch
    from repro_torch.train.serve_step import make_serve_step
    sc = ServeConfig(seq_len=shape.seq_len, batch=shape.global_batch)
    params, sh = _params(cfg, mesh, rules, device)
    c_lg = registry.cache_logical(cfg)
    cache = _empty_like_specs((c_lg, registry.cache_specs(
        cfg, shape.global_batch, shape.seq_len)), device)
    cache = place_tree(cache, tree_shardings(c_lg, cache, mesh, rules))
    tok = registry.decode_input_specs(cfg, shape)["tokens"]
    tokens = shard_batch({"tokens": torch.empty(
        tok.shape, dtype=tok.dtype, device=device)}, mesh, rules)["tokens"]
    return make_serve_step(cfg, sc), (place_tree(params, sh), cache, tokens,
                                      shape.seq_len - 1), \
        dataclasses.asdict(sc)


def analytic_bytes_per_device(args) -> float:
    """Per-device bytes of all inputs (params, optimizer state, cache,
    batch) under their shardings: each DTensor's local shard, each plain
    tensor whole.  Activations excluded."""
    from torch.distributed.tensor import DTensor
    total = 0
    for leaf in leaves(list(args)):
        if not isinstance(leaf, torch.Tensor):
            continue
        t = leaf.to_local() if isinstance(leaf, DTensor) else leaf
        total += t.numel() * t.element_size()
    return float(total)


def active_params(cfg: ModelConfig) -> int:
    if cfg.family == "moe":
        dense_like = dataclasses.replace(
            cfg, n_experts=cfg.top_k, name=cfg.name + "-active")
        return dense_like.param_count()
    return cfg.param_count()


def cell_loops(cfg: ModelConfig, settings: dict) -> list:
    """(name, trips) of the Python loops a cell's step runs: the layer
    stacks (the encoder's too) and a train step's microbatches.  Where the
    reference reads its HLO's while loops, the port traces every trip, so
    the trips are the ones the cell set up."""
    out = [("layers", cfg.n_layers)]
    if cfg.family == "encdec":
        out.append(("encoder_layers", cfg.encoder_layers))
    if settings.get("microbatches", 1) > 1:
        out.append(("microbatches", settings["microbatches"]))
    return out


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str,
             rules: Rules = DEFAULT_RULES, out_dir: Optional[str] = None,
             device: Optional[str] = None) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    chips = math.prod(mesh_shape(mesh).values())
    device = device or trace_device()
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "chips": chips, "kind": shape.kind, "ok": False,
              "device": device}

    ok, reason = registry.supports_cell(cfg, shape)
    if not ok:
        record.update(skipped=True, skip_reason=reason, ok=True)
        _write(record, out_dir)
        return record

    try:
        build = {"train": build_train, "prefill": build_prefill,
                 "decode": build_decode}[shape.kind]
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        with fake, axis_rules(mesh, rules):
            fn, args, settings = build(cfg, shape, mesh, rules, device)
            in_bytes = analytic_bytes_per_device(args)
            t0 = time.monotonic()
            with CostMode(fake) as cm:
                fn(*args)
            t_trace = time.monotonic() - t0
        cost = cm.cost
        tokens = shape.global_batch * (shape.seq_len
                                       if shape.kind != "decode" else 1)
        mf = rf.model_flops(cfg.param_count(), active_params(cfg), tokens,
                            shape.kind)
        roof = rf.Roofline(
            arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
            hlo_flops_per_device=cost.flops,
            hlo_bytes_per_device=cost.bytes,
            collective_bytes_per_device=cost.collective_bytes,
            model_flops_global=mf, bytes_per_device_peak=None)
        record.update(
            ok=True, skipped=False, settings=settings,
            time_lower_s=t_trace, time_compile_s=t_trace,
            time_analyze_s=0.0,
            hlo_flops=cost.flops, hlo_bytes=cost.bytes,
            xla_cost_analysis={"flops": cost.flops, "bytes": cost.bytes,
                               "caveat": "counted at dispatch on the "
                                         "local shards (no XLA)"},
            collectives={**cost.collectives,
                         "total": cost.collective_bytes,
                         "counts": cost.collective_counts},
            loops=cell_loops(cfg, settings),
            memory_analysis=None,
            input_bytes_per_device=in_bytes,
            param_count=cfg.param_count(),
            active_param_count=active_params(cfg),
            roofline=roof.to_dict())
    except Exception as e:
        record.update(error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    _write(record, out_dir)
    return record


def _write(record: dict, out_dir: Optional[str]):
    if out_dir is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    name = f"{record['mesh']}__{record['arch']}__{record['shape']}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(record, f, indent=2, default=str)


def _mesh_dims(name: str):
    if name == "single":
        return (16, 16), ("data", "model")
    if name == "multi":
        return (2, 16, 16), ("pod", "data", "model")
    # custom "NxM" or "PxNxM" (small test meshes)
    dims = tuple(int(x) for x in name.split("x"))
    return dims, (("data", "model") if len(dims) == 2
                  else ("pod", "data", "model"))


def make_mesh_by_name(name: str, device: Optional[str] = None):
    """The named mesh over a fake process group (started here when none
    runs) of ``REPRO_DRYRUN_DEVICES`` ranks, default the mesh's size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import _device_mesh
    dims, axes = _mesh_dims(name)
    if not dist.is_initialized():
        world = int(os.environ.get("REPRO_DRYRUN_DEVICES",
                                   str(math.prod(dims))))
        dist.init_process_group("fake", rank=0, world_size=world,
                                store=FakeStore())
    return _device_mesh(dims, axes, device or trace_device())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=None)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default=None,
                    help="cuda (fake CUDA tensors; the default in a CUDA "
                         "build) or cpu")
    ap.add_argument("--jobs", type=int, default=1,
                    help="trace the archs in this many processes at once")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = [s.name for s in SHAPES] if args.shape == "all" \
        else args.shape.split(",")
    if args.jobs > 1 and len(archs) > 1:
        return _parallel(archs, args)
    device = args.device or trace_device()
    mesh = make_mesh_by_name(args.mesh, device)

    results = []
    for arch in archs:
        for shape in shapes:
            t0 = time.monotonic()
            rec = run_cell(arch, shape, mesh, args.mesh, DEFAULT_RULES,
                           args.out, device)
            status = ("SKIP" if rec.get("skipped")
                      else "OK" if rec.get("ok") else "FAIL")
            extra = ""
            if rec.get("ok") and not rec.get("skipped"):
                r = rec["roofline"]
                extra = (f" dominant={r['dominant']}"
                         f" frac={r['roofline_fraction']:.3f}"
                         f" trace={rec['time_compile_s']:.1f}s")
            if status == "FAIL":
                extra = " " + rec.get("error", "")[:200]
            print(f"[{status}] {arch} x {shape} x {args.mesh}"
                  f" ({time.monotonic() - t0:.1f}s){extra}", flush=True)
            results.append(rec)

    n_fail = sum(1 for r in results if not r.get("ok"))
    print(f"\n{len(results)} cells, {n_fail} failures", flush=True)
    return 1 if n_fail else 0


def _parallel(archs, args) -> int:
    """One process an arch, ``args.jobs`` at a time; each prints its
    cells' lines as it ends."""
    import subprocess
    import sys
    from concurrent.futures import ThreadPoolExecutor

    def one(arch):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", args.shape, "--mesh", args.mesh, "--out",
               args.out] + (["--device", args.device] if args.device else [])
        r = subprocess.run(cmd, capture_output=True, text=True)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("[")]
        print("\n".join(lines) if lines else
              f"[FAIL] {arch}: exit {r.returncode} {r.stderr[-300:]}",
              flush=True)
        return r.returncode

    t0 = time.monotonic()
    with ThreadPoolExecutor(args.jobs) as pool:
        codes = list(pool.map(one, archs))
    print(f"\n{len(archs)} archs in {time.monotonic() - t0:.1f} s, "
          f"{sum(1 for c in codes if c)} failed", flush=True)
    return 1 if any(codes) else 0


if __name__ == "__main__":
    raise SystemExit(main())
