"""Serving launcher: batched prefill + decode loop on one card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny

The port of ``repro.launch.serve``: the same flags and printed lines;
float32 on the CPU, bfloat16 on the card, random weights from seed 0;
a VLM prompt also gets patch embeddings and an encoder-decoder one frame
embeddings, drawn after the tokens as the reference draws them.
``--production-mesh`` raises ``NotImplementedError``: the meshes and
``sharding/`` are ROADMAP step 15 (15e).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import ServeConfig
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import registry
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
    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh: the production mesh and sharding/ are "
            "ROADMAP step 15 (15e); this launcher serves on one device")

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    fp32 = dev.type == "cpu"
    dt = "float32" if fp32 else "bfloat16"
    tdt = DTYPES[dt]
    sc = ServeConfig(seq_len=args.prompt_len + args.tokens,
                     batch=args.batch, param_dtype=dt, compute_dtype=dt,
                     kv_dtype=dt)
    params = registry.init_params(0, cfg, tdt, device=dev)
    rng = np.random.default_rng(0)
    prompt = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=dev)}
    if cfg.family == "vlm":
        prompt["patches"] = torch.as_tensor(
            rng.normal(size=(args.batch, cfg.vision_tokens,
                             cfg.d_model)) * 0.02, dtype=tdt, device=dev)
    if cfg.family == "encdec":
        prompt["frames"] = torch.as_tensor(
            rng.normal(size=(args.batch, cfg.encoder_seq,
                             cfg.d_model)) * 0.02, dtype=tdt, device=dev)

    t0 = time.perf_counter()
    params, cache, tok = greedy_prefill(cfg, sc, params, prompt, device=dev)
    synchronize(dev)
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    gen = greedy_decode(cfg, params, cache, tok, args.prompt_len,
                        args.tokens)
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
