"""Serving launcher: batched prefill + decode loop on a mesh.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve

The port of ``repro.launch.serve``: the same flags and printed lines;
float32 on the CPU, bfloat16 on the card, random weights from seed 0;
a VLM prompt also gets patch embeddings and an encoder-decoder one frame
embeddings, drawn after the tokens as the reference draws them.  The
mesh is the host mesh (world, 1) over the process group (one rank a card
under ``torchrun``; a one-rank group when started alone), or the (16, 16)
production mesh under ``--production-mesh``, which needs 256 ranks and
raises ``RuntimeError`` on a smaller world.  Parameters and the prompt
are placed by the logical-axis rules (``tree_shardings``,
``shard_batch``) and every step runs under ``axis_rules``; on a
one-device mesh they stay plain tensors (the one-card path).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import ServeConfig
from repro_torch.data import shard_batch
from repro_torch.device import synchronize
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     process_group)
from repro_torch.models import registry
from repro_torch.sharding import (DEFAULT_RULES, axis_rules, full,
                                  place_tree, tree_shardings)
from repro_torch.train.serve_step import (DTYPES, greedy_decode,
                                          greedy_prefill)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    with process_group(args.device) as dev:
        _serve(args, dev)


def _serve(args, dev):
    import torch.distributed as dist
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    mesh = make_production_mesh(device=dev) if args.production_mesh \
        else make_host_mesh(dist.get_world_size(), 1, device=dev)
    fp32 = dev.type == "cpu"
    dt = "float32" if fp32 else "bfloat16"
    tdt = DTYPES[dt]
    sc = ServeConfig(seq_len=args.prompt_len + args.tokens,
                     batch=args.batch, param_dtype=dt, compute_dtype=dt,
                     kv_dtype=dt)
    rng = np.random.default_rng(0)
    prompt = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        dtype=torch.int32)}
    if cfg.family == "vlm":
        prompt["patches"] = torch.as_tensor(
            rng.normal(size=(args.batch, cfg.vision_tokens,
                             cfg.d_model)) * 0.02, dtype=tdt)
    if cfg.family == "encdec":
        prompt["frames"] = torch.as_tensor(
            rng.normal(size=(args.batch, cfg.encoder_seq,
                             cfg.d_model)) * 0.02, dtype=tdt)

    with axis_rules(mesh, DEFAULT_RULES):
        params = registry.init_params(0, cfg, tdt, device=dev)
        params = place_tree(params, tree_shardings(
            registry.param_logical(cfg), params, mesh))
        prompt = shard_batch(prompt, mesh)
        t0 = time.perf_counter()
        params, cache, tok = greedy_prefill(cfg, sc, params, prompt,
                                            device=dev)
        synchronize(dev)
        t_prefill = time.perf_counter() - t0
        t0 = time.perf_counter()
        gen = full(greedy_decode(cfg, params, cache, tok, args.prompt_len,
                                 args.tokens))
        synchronize(dev)
        t_decode = time.perf_counter() - t0
    print(f"arch={cfg.name} batch={args.batch}")
    print(f"prefill {args.prompt_len} tok: {t_prefill:.2f}s; decode "
          f"{args.tokens} tok: {t_decode:.2f}s "
          f"({args.batch * args.tokens / max(t_decode, 1e-9):.1f} "
          f"tok/s)")
    print("first sequence:", gen[0].cpu().numpy()[:12], "...")


if __name__ == "__main__":
    main()
