"""Training launcher: the fault-tolerant step loop on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --batch 8 --seq 512 --microbatches 2 --steps 100 --ckpt DIR

The port of ``repro.launch.train``: the same flags and printed lines
(``mesh:``/``arch:``, ``step … loss … gnorm … [straggler]``, ``resumed
from step N``, ``done``), plus ``--device``.  float32 on the CPU and
bfloat16 parameters and compute on the card, as the reference chooses by
backend; float32 optimizer state and accumulation, ``remat="full"``,
random weights from seed 0, data from :class:`SyntheticTokens` (seed 0;
VLM patch and encoder-decoder frame embeddings drawn from the step's
seed).  It resumes from the newest committed checkpoint under ``--ckpt``
and saves every ``--save-every`` steps and after the last.  ``--production-mesh`` raises
``NotImplementedError``: meshes and ``sharding/`` are ROADMAP step 15
(15e).  :func:`main` returns the final state and the per-step record.
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
from repro_torch.data import SyntheticTokens, to_device
from repro_torch.device import resolve_device, synchronize
from repro_torch.runtime import StepMonitor
from repro_torch.train.train_step import TrainState, init_state, \
    make_train_step


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


def batch_at(data: SyntheticTokens, cfg, step: int, device):
    """The step's batch on ``device``; a VLM also gets patch embeddings
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
    return to_device(batch, device)


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
                    help="the (16,16) mesh (ROADMAP step 15e)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh: the production mesh and sharding/ are "
            "ROADMAP step 15 (15e); this launcher trains on one device")

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    fp32 = dev.type == "cpu"
    tc = TrainConfig(
        seq_len=args.seq, global_batch=args.batch,
        microbatches=args.microbatches,
        param_dtype="float32" if fp32 else "bfloat16",
        compute_dtype="float32" if fp32 else "bfloat16",
        accum_dtype="float32", remat="full")
    print(f"mesh: {{'data': 1, 'model': 1}} ({dev})  arch: {cfg.name} "
          f"(~{cfg.param_count() / 1e6:.0f}M params)")

    state = init_state(0, cfg, tc, device=dev)
    step_fn = make_train_step(cfg, tc)
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=args.seq,
                           global_batch=args.batch)
    ckpt = AsyncCheckpointer(args.ckpt)
    monitor = StepMonitor()
    start = latest_step(args.ckpt) or 0
    if start:
        state = restore_checkpoint(args.ckpt, start, state, device=dev)
        print(f"resumed from step {start}")

    metrics, step_s = [], []
    for step in range(start, args.steps):
        batch = batch_at(data, cfg, step, dev)
        t0 = time.monotonic()
        state, m = step_fn(state, batch)
        synchronize(dev)
        step_s.append(time.monotonic() - t0)
        slow = monitor.record(step_s[-1])
        metrics.append((m["loss"], m["grad_norm"]))
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {float(m['loss']):.4f}"
                  f"  gnorm {float(m['grad_norm']):.3f}"
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
