"""Training launcher: the fault-tolerant step loop on a mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --batch 8 --seq 512 --microbatches 2 --steps 100 --ckpt DIR
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train

The port of ``repro.launch.train``: the same flags and printed lines
(``mesh:``/``arch:``, ``step … loss … gnorm … [straggler]``, ``resumed
from step N``, ``done``), plus ``--device``.  float32 on the CPU and
bfloat16 parameters and compute on the card, as the reference chooses by
backend; float32 optimizer state and accumulation, ``remat="full"``,
random weights from seed 0, data from :class:`SyntheticTokens` (seed 0;
VLM patch and encoder-decoder frame embeddings drawn from the step's
seed).  It resumes from the newest committed checkpoint under ``--ckpt``
and saves every ``--save-every`` steps and after the last.

The mesh is the host mesh (world, 1) over the process group (one rank a
card under ``torchrun``; a one-rank group when started alone), or the
(16, 16) production mesh under ``--production-mesh``, which needs 256
ranks and raises ``RuntimeError`` on a smaller world.  As the
reference's launcher does, the state is placed by the logical-axis rules
(``shard_state``: parameters, AdamW's moments), each batch by
``shard_batch``, a resume re-partitions the checkpoint onto the mesh,
and every step runs under ``axis_rules``.  On a one-device mesh every
placement is ``Replicate`` and the leaves stay plain tensors: the same
arithmetic, without DTensor's dispatch on the host (the one-card path).
:func:`main` returns the final state and the per-step record.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import List

import numpy as np

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import TrainConfig
from repro_torch.data import SyntheticTokens, shard_batch, to_device
from repro_torch.device import synchronize
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     process_group)
from repro_torch.runtime import StepMonitor
from repro_torch.sharding import DEFAULT_RULES, axis_rules, full, mesh_shape
from repro_torch.train.train_step import (TrainState, init_state,
                                          make_train_step, shard_state,
                                          state_shardings)


@dataclasses.dataclass
class TrainRun:
    """What :func:`main` returns: the final state, the first step run
    (after a resume), and each step's loss, gradient norm and wall time
    (seconds, taken after the device finished the step)."""

    state: TrainState
    start: int
    losses: List[float]
    grad_norms: List[float]
    step_s: List[float]


def host_batch(data: SyntheticTokens, cfg, step: int):
    """The step's batch as host arrays; a VLM also gets patch embeddings
    and an encoder-decoder frame embeddings (normal, std 0.02, from the
    step's seed)."""
    batch = data.batch_at(step)
    rows = {"vlm": ("patches", cfg.vision_tokens),
            "encdec": ("frames", cfg.encoder_seq)}.get(cfg.family)
    if rows is not None:
        rng = np.random.default_rng([data.seed, step])
        batch[rows[0]] = (rng.normal(size=(
            data.global_batch, rows[1], cfg.d_model)) * 0.02
        ).astype(np.float32)
    return batch


def batch_at(data: SyntheticTokens, cfg, step: int, device):
    """:func:`host_batch` on ``device``."""
    return to_device(host_batch(data, cfg, step), device)


def main(argv=None) -> TrainRun:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_launch_ckpt"))
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the (16,16) mesh (needs 256 ranks)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    with process_group(args.device) as dev:
        return _train(args, dev)


def _train(args, dev) -> TrainRun:
    import torch.distributed as dist
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    mesh = make_production_mesh(device=dev) if args.production_mesh \
        else make_host_mesh(dist.get_world_size(), 1, device=dev)
    fp32 = dev.type == "cpu"
    tc = TrainConfig(
        seq_len=args.seq, global_batch=args.batch,
        microbatches=args.microbatches,
        param_dtype="float32" if fp32 else "bfloat16",
        compute_dtype="float32" if fp32 else "bfloat16",
        accum_dtype="float32", remat="full")
    print(f"mesh: {mesh_shape(mesh)} ({dev})  arch: {cfg.name} "
          f"(~{cfg.param_count() / 1e6:.0f}M params)")

    with axis_rules(mesh, DEFAULT_RULES):
        state = init_state(0, cfg, tc, device=dev)
        step_fn = make_train_step(cfg, tc)
        data = SyntheticTokens(vocab=cfg.vocab, seq_len=args.seq,
                               global_batch=args.batch)
        ckpt = AsyncCheckpointer(args.ckpt)
        monitor = StepMonitor()
        start = latest_step(args.ckpt) or 0
        if start:
            state = restore_checkpoint(
                args.ckpt, start, state,
                shardings=state_shardings(state, cfg, mesh))
            print(f"resumed from step {start}")
        else:
            state = shard_state(state, cfg, mesh)

        metrics, step_s = [], []
        for step in range(start, args.steps):
            batch = shard_batch(host_batch(data, cfg, step), mesh)
            t0 = time.monotonic()
            state, m = step_fn(state, batch)
            synchronize(dev)
            step_s.append(time.monotonic() - t0)
            slow = monitor.record(step_s[-1])
            metrics.append((full(m["loss"]), full(m["grad_norm"])))
            if step % 10 == 0 or step == args.steps - 1:
                print(f"step {step:4d}  loss {float(metrics[-1][0]):.4f}"
                      f"  gnorm {float(metrics[-1][1]):.3f}"
                      + ("  [straggler]" if slow else ""), flush=True)
            if (step + 1) % args.save_every == 0 or step + 1 == args.steps:
                ckpt.save(step + 1, state)
        ckpt.close()
    print("done")
    return TrainRun(state=state, start=start,
                    losses=[float(a) for a, _ in metrics],
                    grad_norms=[float(b) for _, b in metrics], step_s=step_s)


if __name__ == "__main__":
    main()
