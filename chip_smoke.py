#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--kernels]

from the root of a checkout (``--kernels``: phases 1-3 and every kernel's
timing only, no result lines).  Phases, each printing its own lines; any
failure raises and the script exits non-zero without a result line:

1. env    — the card (``nvidia-smi`` name and power limit), torch and CUDA.
2. build  — ``nvcc`` builds the kernels from ``src/repro_torch/kernels/csrc``.
3. kernels vs plain — pass A, pass B (one state half and the H = 2
   variants of the doubled e-SVR operator), the Gram kernel, the two
   Gram-bank passes (one state half and H = 2), the single-lane passes
   (kernels 6 and 7), the active-set (``act``) variants of passes A
   and B and of the bank passes, and the conjugate variants of both pass
   B kernels (H = 1 and 2, with and without ``act``) against their plain
   PyTorch versions on the same inputs on the card, at the main paths' shapes and at odd ones,
   in float64 and float32, with the edge cases of the CPU tests
   (all-masked lane, a lane whose mask is all false, a mask hiding the
   true argmax, ties across blocks and across state halves, G with the
   mask bitwise equal to G without, a mu = 0 lane, per-lane gammas, lanes
   spread over the bank's entries, both gain rules, a false and a true
   relaunch flag, a mu = mu2 = 0 lane bitwise, a mu2 = 0 lane bitwise
   equal to the variant without the direction).  The bank passes, which
   fold each lane's cross-block pick into their launch and return the
   lanes' results, are held in every variant at ``BANK_SHAPES`` (B = 1,
   3, 18 and 90 at l = 16384, an odd l = 1001, l = 300), and in the
   reference's rows form (``ops.row_wss_batched_rows`` on pre-gathered
   ``KR``, ``ops.update_wss_batched_rows`` on ``KRi``, ``KRj``: the same
   kernels reading the rows as a bank of one-row entries, also off
   16-byte alignment), bitwise equal to the bank form.
   Every variant of kernels 1 and 2 is also held at the edges of their
   tiling (``TILE_EDGES``: one column past a block, lane counts around a
   group, X streamed per group, one feature), and kernels 6 and 7 at the
   edges of their segments and ring (``SINGLE_EDGES``: l = 127, 129, 1001
   by d = 1, 37, 1000) and on an XT off 16-byte alignment (bitwise equal
   to the aligned launch).  The Gram kernel is held at its tiles' edges
   (``GRAM_EDGES``: m, n of 1, 127, 128, 129, 1000 against 333 and 4096,
   d = 1, 37, 128, 1000) and in its symmetric mode (``GRAM_SYM_EDGES``:
   l = 127, 129, 1001 and 16384, written into bank[1] of a 3-entry bank,
   bitwise equal to its transpose, the other entries untouched).
   Tolerance: values to rtol 1e-12 (f64) / 1e-5 (f32); indices exactly,
   except that in f32 an argmax may differ where the plain version's gains
   at both picks agree to 1e-6 relative (the kernel sums its products in
   another order).  Then a ``[resources]`` line: the registers, local
   memory (spills) and shared memory of each tiled variant of kernels 1
   and 2, of the Gram kernel's instances and of kernels 6 and 7.
4. end to end, small — binary and 3-class SVC, smo and pasmo, a 3-class
   2 x 2 (C, gamma) grid through both row sources, single-lane
   ``solve_fused`` (smo, pasmo), SVR, OneClassSVM and a 2 x 2 x 2 e-SVR
   grid; with ``shrinking=True`` the (C, gamma), e-SVR and one-class grids
   and the compacted grid (``chunk=32``) on both sources, the e-SVR grid
   through the bank, and the mask refresh under CUDA graphs
   (``check_every=5``) against ``check_every=1``; with the conjugate step
   SVC, the (C, gamma) and e-SVR grids through both row sources and the
   one-class grid, each with and without shrinking, the compacted grid,
   one fit run twice (bitwise) and ``check_every=5`` against ``1``; f64,
   ``impl="cuda"`` against ``impl="torch"``; and both chunked drivers
   (the compacted grid through both sources at ``chunk=32`` and ``96``,
   the classic one with and without shrinking) with their per-call CUDA
   graph cache against the same drivers with the cache defeated, bitwise,
   and exactly one capture per (cache entry, chunk shape) visited.
5. SVC, full width (slice 1's main path) — a 10-class one-vs-rest SVC at
   l = 16384, d = 128 in f64 and f32: convergence, gradient drift, KKT
   gap, held-out agreement, launch counts, and each kernel's device time
   beside its bound and its plain version's time; then a
   ``torch.profiler`` window over a capped fit: device kernels an
   iteration and the device's busy share of the iteration's wall time.
6. grid, full width (slice 2's main path) — the (C, gamma) grid of the
   same data, 3 gammas x 10 classes x 3 Cs = 90 lanes, through the Gram
   bank (f64 and f32) and through the rbf passes (f64): convergence, bank
   against rbf objectives, gradient
   drift and KKT gap, launch counts, held-out accuracy per (gamma, C),
   peak memory, wall time an iteration, a ``torch.profiler`` window,
   kernels 1, 2, 4 and 5 timed at B = 90 and the bank build timed (beside
   its symmetric bound and cuBLAS's X @ X.T); then
   the one-class grid (3 nus x the 3 gammas) through both row sources.
7. single lane, full width (slice 3) — ``solve_fused`` on lane 0 of phase
   5's problem against the batched fit's lane 0 (objective, drift, KKT
   gap, launches, relaunches that ran), run twice (bitwise equal), kernel
   6's launches split into runs and no-op relaunches, the fused row of
   ``benchmarks/solver_micro.py`` at its largest size as a timing row, and
   a ``torch.profiler`` window.
8. e-SVR and one-class, full width (slice 3) — ``SVR(C=10, epsilon=0.1,
   gamma="scale")`` on a sinc target of the same X, the C = 1 half of the
   e-SVR grid (9 lanes) through the rbf passes and through the Gram bank
   (the H = 2 bank passes), ``OneClassSVM(nu=0.1)`` and the SVR again in f32: convergence,
   drift against p - Q alpha, KKT gap, sum(alpha), held-out R^2, bank
   against rbf objectives, launch counts, profiler windows; then kernels
   6, 7 and the H = 2 variants timed beside their bounds, kernels 6 and 7
   also with one and two stages of their ring in flight, and ``X @ xq``
   (cuBLAS GEMV) on the same inputs.
9. shrinking, full width (slice 4) — the 90-lane grid of phase 6 with
   ``shrinking=True`` through the bank and through the rbf passes, the
   compacted grid (hard shrinking, ``chunk=96``, its C = 0.5 lanes)
   through the bank, and the e-SVR grid of phase 8 through the bank with
   ``shrinking=True``:
   every lane converged with the full-set gap at most eps, G within 1e-8
   of p - Q alpha, sum(alpha), objectives within rtol 1e-6 of phases 6
   and 8's shrink-off results (reused, not rerun), iterations, unshrinks,
   the final active share, ms an iteration (a round for the compacted
   grid, with its split), profiler windows over 64 iterations (one mask
   refresh), peak memory; the compacted grid again without the graph
   cache (bitwise equal; ms a round, ``chunked.solve``'s share, captures
   and peak memory of both) and a profiler window over a round that
   replays its cache entry's graphs; then the six variants of this slice
   timed beside their bounds.
10. conjugate step, full width (slice 5) — ``algorithm="smo",
   step="conjugate"`` on phase 5's SVC, phase 6's grid through the bank
   (without and with shrinking) and through the rbf passes with
   shrinking, phase 8's SVR and one of its e-SVR grid's lanes through the
   bank with shrinking: exact launches of each run's conjugate pass B
   variant, accepted conjugate steps, convergence, drift, full-set gap,
   objectives within rtol 1e-6 of the PA-SMO results of phases 5, 6 and 8
   (reused), a profiler window; then the eight conjugate variants timed
   beside their bounds, the variants without the direction and their
   plain versions.
11. classic engine, full width (slice 9) — ``engine="batched"`` and
   ``impl=None``: (a) the 10-lane SVC of phase 5 on its Gram (kernel 3,
   symmetric mode) in f64 and f32, with a profiler window; (b) the same
   fit with rows from ``X[i] @ X.T``; (c) the paper's variants (smo,
   pasmo_simple, overshoot, pasmo with 3 candidates, ``wss="mvp"``, the
   conjugate step), a Table-2-style line each; (d) the Fig. 3 recorder,
   ``mu/mu* - 1`` in ``benchmarks/fig3_stepsizes.py``'s buckets; (e)
   ``solve_grid(impl=None)`` over phase 6's grid and the classic
   compacted grid over its C = 0.5 lanes, without and with shrinking
   (without shrinking also with the graph cache defeated: bitwise equal,
   ms a round, captures, peak memory);
   (f) ``SVR`` and ``OneClassSVM`` on phase 8's problems and
   ``train_svm`` on lane 0.  Every lane converged, G within 1e-8 of
   p - Q alpha, the full-set gap at most eps, objectives within rtol
   1e-6 of the fused results of phases 5, 6 and 8 (reused) or of (a),
   held-out predictions at least 99% equal; the phase's time is
   printed.
12. flight recorder, full width (slice 10) — ``Diagnostics(ring=
   RingConfig())`` on (a) phase 5's SVC, off, on, on, off, off, on: ring-on
   iterations and alpha bitwise equal to ring-off, 10 lanes drained, each
   lane's last stamp its last iteration, ratio events equal to accepted
   planning steps; ms an iteration off and on, t_off/t_on (the ratio of
   the medians of three) and the kernels
   an iteration with and without the ring (two profiler windows); (b)
   phase 6's 90-lane bank grid (``solve_grid(diagnostics=...)``):
   iterations equal to phase 6's, 90 lanes in caller order, ``trace``/
   ``n_trace`` equal to the drained ratio channel; (c) phase 10's
   conjugate SVC: accepted conjugate steps equal the ratio events; (d)
   phase 4's compacted grid (``chunk=32``): bitwise equal to the run
   without, run-wide stamps, ``chunk_solve`` events, and ring, lanes and
   events equal to the uncached driver's; (e) the grid's JSONL
   rendered by ``repro_torch.launch.telemetry_report`` (environment,
   convergence and straggler lines printed).  The phase's time is printed.
13. several cards (slice 12), on every attached card (one card or
   more) — (a) phase 5's SVC with ``engine="sharded"``: alpha and
   iterations bitwise equal to phase 5's fused fit, ms and kernels an
   iteration, peak memory a card, and with the ring bitwise equal to
   phase 12's ring-on fit; the schedule and gather cost of a call; (b)
   phase 6's one-class grid through both sources on
   ``devices=[cuda:0]``, every field bitwise equal to phase 6's; (c)
   phase 4's small compacted grids on ``devices=[cuda:0]``, bitwise equal
   to phase 4's, one capture per (entry, chunk shape); (d)
   ``repro_torch.core.sharded.solve_sharded`` in a one-rank NCCL group on
   phase 5's lane 0: objective within rtol 1e-6 of that lane's, KKT gap
   at most eps, ms, kernels and collectives an iteration, peak memory.
   The phase's time is printed.
14. analysis — ``repro_torch.analysis.capture_guard`` with real graphs
   (the ``[analysis]`` line): exact captures of a fused and a classic fit
   and of the chunked drivers over a (C, gamma) sweep (the fused one also
   lane-sharded over two slabs on the card), cached bitwise equal to
   uncached; a sweep of fits builds no kernel, and each source hash was
   built once in the process.
15. the LM serving path and the SVM probe (step 15a), ``qwen2-0.5b`` at
   full width (24 layers, d_model 896, vocab 151936), random weights
   from seeds: (a) ``init_params`` in bf16 (parameter count beside
   ``cfg.param_count()``, peak memory); (b) ``greedy_generate`` in bf16,
   batch 8, prompt 512, 64 new tokens, twice (tokens bitwise equal;
   prefill ms, decode ms a step, tokens/s, peak memory; no kernel of the
   port launched: the LM path reaches no Pallas site), the aten ops one
   decode step dispatches (``analysis.dispatch_audit.OpRecorder``), and
   the served prefill's bf16 logits against an f32 forward of the same
   weights; (c)
   in f32 with TF32 off, prefill of 256 tokens and 8 teacher-forced
   decode steps against ``forward_logits`` on all 264 (rtol = atol =
   2e-3, batch 4), again at batch 2 with ``sliding_window=128`` (the ring
   wraps), and bf16 logits against f32 ones, of the full forward and of
   a prefill and decode through the bf16 cache (each bf16 comparison:
   max |diff| at most 0.2, top-1 agreement at least 0.9); (d)
   the probe: features of 4096 sequences of 128 tokens in 4 classes (a
   64-id band each) from the bf16 model, ``train_probe`` on 3072 (kernel
   3 builds the Gram once, symmetric) with each head converged, its KKT
   gap at most eps and its objective within rtol 1e-6 of
   ``solve_ovr_fused`` on the same features, gamma and C;
   ``predict_probe`` on 1024 (one cross Gram); held-out accuracy; kernel
   3 at the probe's shapes against its plain version (the Gram bitwise
   equal to its transpose) and timed.  The phase's time is printed.
16. LM training (step 15b), ``qwen2-0.5b`` at full width from seeds:
   (a) ``repro_torch.launch.train.main`` in bf16, batch 8, seq 512,
   2 microbatches, 8 steps with a checkpoint every 4 into a temporary
   directory, then again to 12 steps, which must resume from step 8:
   every loss and gradient norm finite, every parameter leaf changed,
   every moment nonzero, no kernel of the port launched (the training
   path reaches no Pallas site); ms a step (steps 2-7), tokens/s, peak
   memory; a ``torch.profiler`` window over one step names the SDPA
   kernels of both directions (not the math backend); (b) bf16 against
   f32 gradients of the same weights on one microbatch: cosine at least
   ``BF16_GRAD_COS``, norms within ``BF16_GRAD_NORM_RDIFF``; (c) in f32
   with TF32 off, batch 2 x 256, the gradient through SDPA's efficient
   kernel against the math backend, every leaf within rtol = atol =
   1e-4; (d) SDPA's backward at one layer's shape called 5 times under
   each mode of the deterministic algorithms (off, warn-only, strict),
   in bf16 and f32, by default and with each fused backend forced: the
   bitwise verdict and worst difference printed, the default bitwise
   under strict; then ``run_resilient`` at 4 layers (full width and
   vocab), 8 steps, a checkpoint every 3, failures injected at steps 2
   and 5, under PyTorch's deterministic algorithms: parameters and
   optimizer state bitwise equal to an uninterrupted run.  The phase's time is
   printed.
17. the MoE family (step 15c), ``mixtral-8x7b`` at full width (d_model
   4096, 32 heads, 8 KV heads, d_ff 14336, 8 experts, top-2, window
   4096, vocab 32000) at 2 of its 32 layers, from seeds: (a)
   ``init_params`` in bf16 (parameter count beside ``param_count()``,
   peak memory); (b) ``greedy_generate`` in bf16, batch 8, prompt 512, 32
   new tokens, twice (tokens bitwise equal; prefill ms, decode ms a step,
   tokens/s, peak memory), the aten ops of one decode step and the share
   of (token, k) picks the prefill dropped at capacity factor 1.25, by
   layer; (c) in f32 with capacity factor 8 (nothing drops), TF32 off,
   prefill 256 and 8 teacher-forced decode steps against
   ``forward_logits`` on all 264 (rtol = atol = 2e-3, batch 2), then the
   same weights in bf16 against f32: the share of routing picks that
   agree, max |diff| of the logits (printed, not gated: one flipped pick
   moves a token's logits by a whole expert's output) and top-1 agreement
   at least 0.9; (d) 4 training steps (``make_train_step``, bf16
   parameters and compute, an f32 accumulator, Adafactor, remat full,
   batch 4 x 512 in 2 microbatches): every loss, aux and gradient norm
   finite, every parameter leaf changed, every expert's ``w_gate``
   gradient nonzero on one microbatch; ms a step, tokens/s, peak memory,
   the aux.
18. the Mamba2 SSM family (step 15d), ``mamba2-370m`` at full width and
   depth (48 layers, d_model 1024, 32 heads of 64, state 128, chunk 256,
   vocab 50280, tied), from seeds: (a) ``init_params`` in bf16 (count,
   peak memory); (b) ``greedy_generate`` in bf16, batch 8, prompt 512
   (two chunks), 64 new tokens, twice and bitwise (prefill ms, decode ms
   a step, the decode state's size, the aten ops of a decode step, peak
   memory); (c) in f32 with TF32 off, prefill 256 and 8 decode steps
   against the forward (2e-3), ``ssd_chunked`` at the model's head shapes
   over two chunks against the per-step recurrence in f64 on the card
   (rtol = atol = 1e-4), bf16 against f32 logits (max |diff| at most 0.5,
   top-1 at least 0.75: ``SSM_BF16_MAX_DIFF``, ``SSM_BF16_TOP1``); (d)
   ``repro_torch.launch.train.main`` in bf16,
   AdamW, batch 8 x 512 in 2 microbatches, 4 steps, one save after the
   last: every loss and gradient norm finite, every moment finite and
   nonzero, every parameter leaf changed but those whose bf16 spacing is
   far above the warmup's summed learning rate at every element
   (printed); ms a step, tokens/s, peak memory, a save of the final state
   timed apart.
19. the hybrid family (step 15d), ``recurrentgemma-2b`` at full width and
   depth (26 layers: 8 triples of RG-LRU, RG-LRU, local MQA and a tail of
   2; d_model 2560, 10 heads over 1 KV head of 256, window 2048, d_ff
   7680, vocab 256000, tied), from seeds: (a) ``init_params`` in bf16
   (2894574080 parameters, peak memory); (b) ``greedy_generate`` in bf16,
   batch 8, prompt 512, 32 new tokens, twice and bitwise (prefill ms,
   decode ms a step, the aten ops of a decode step, peak memory); (c) in
   f32 with TF32 off, batch 1, prefill 2040 and 16 decode steps against
   the forward (2e-3; the 2048-slot ring wraps), bf16 against f32 logits
   (max |diff| at most 0.65, top-1 at least 0.8: ``HYBRID_BF16_MAX_DIFF``,
   ``HYBRID_BF16_TOP1``); (d) the RG-LRU scan at 8 x 512 x 2560 against the per-step
   recurrence in f64 (rtol = atol = 2e-4); (e) 4 training steps
   (``make_train_step``, bf16, an f32 accumulator, Adafactor, remat full,
   batch 4 x 512 in 2 microbatches): every loss and gradient norm finite,
   every parameter leaf changed but those whose bf16 spacing is far above
   the warmup's summed learning rate (printed); ms a step, tokens/s, peak
   memory.
20. the encoder-decoder family (step 15d), ``whisper-tiny`` at full width
   and depth (4 + 4 layers, d_model 384, 6 heads, 1500 frames, vocab
   51865, tied), from seeds: (a) ``init_params`` in bf16 (41158272
   parameters); (b) ``greedy_generate`` in bf16, batch 8, prompts of 64
   tokens over 1500 frames, 32 new tokens, twice and bitwise (prefill ms
   with the encoder, decode ms a step, the aten ops of a decode step, the
   cache's size, peak memory); (c) in f32, batch 4, prefill 64 and 16
   decode steps against the forward (2e-3), bf16 against f32 logits (0.2,
   0.9); (d) ``repro_torch.launch.train.main`` in bf16, AdamW, batch 8 x
   128 tokens with their frames in 2 microbatches, 4 steps: losses finite,
   every moment finite and nonzero, the unchanged leaves as in 19 (e); ms
   a step, tokens/s, peak memory.  None of phases 17-20 launches a kernel
   of the port: the tally is checked unchanged.  Each phase's time is
   printed.
21. meshes and sharding (step 15e), ``qwen2-0.5b`` at full width: (a)
   ``make_host_mesh(1, 1)`` starts one NCCL rank and
   ``repro_torch.launch.train.main`` (bf16, batch 8 x 512, 2
   microbatches, 4 steps) takes the one-device path: losses and every
   state leaf bitwise equal to the same steps without a mesh, under
   deterministic algorithms; (b) the same weights as one-rank
   ``Replicate`` DTensors (``tree_shardings``): 2 ``make_train_step``
   steps and a 16-token greedy decode bitwise equal to plain tensors, ms
   a step and a decode step of both (DTensor's host cost); (c)
   ``restore_checkpoint(shardings=)`` of (a)'s checkpoint onto the mesh
   bitwise; (d) with two or more cards, up to 4 NCCL ranks on an (n, 1)
   and a (1, n) mesh: the first microbatch's gradient within the bf16
   gradient gates of one card, 2 training steps; on one card a line says
   the several-rank meshes ran in the CPU tests only; (e) in two
   subprocesses started at the phase's start (each a fake 256-rank
   group, fake CUDA tensors), the dry-run of ``qwen2-0.5b x
   decode_32k``, ``mixtral-8x7b x long_500k``, ``mamba2-370m x
   decode_32k`` and ``whisper-tiny x prefill_32k`` on the (16, 16)
   production mesh and of the sharded solver at l = 1048576, d = 256:
   each record ``ok``, its dominant term, roofline fraction and trace
   time (terms reckoned at the H100's data-sheet peaks).  No kernel of
   the port launches; the phase's time is printed.

The solvers replay their loop body as CUDA graphs on the card
(``repro_torch.core.solver_fused._drive``); the profiler windows over a
fit span one check chunk, which the loop runs eagerly, so no graph is
captured inside them; the window over a compacted round spans replays
only.

Every counted run of phases 5-13 and 15-18 (fits, grids, predicts and
decisions, serving, the training launcher; not the bitwise repeat of
phase 7, the probe's fused reference solve, the profiler windows or the
timings) adds its launches to one tally, which the kernels' JSON record
reports (phases 16-18 add none);
a ``[gram]`` line splits the Gram's launches into bank and Gram builds
(symmetric) and predicts and decisions (cross).  The line before the last is the
kernels' JSON record; the last is the contract line ``{"ok": true,
"device": {...}}``.  No JAX and nothing of the
reference package is imported.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import itertools
import json
import math
import os
import pathlib
import subprocess
import sys
import time

# Phase 16(d) runs PyTorch's deterministic algorithms, which take cuBLAS
# only with a fixed workspace; PyTorch reads this once, at the process's
# first matmul.  ":4096:8" (eight 4 MiB buffers) is the size it already
# takes on Hopper.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402


# Published H100 SXM peaks (NVIDIA data sheet) used for the bounds: HBM3 at
# 3.35 TB/s; 67 TFLOP/s for float32 outside the tensor cores and for
# float64 on the tensor cores (the fastest the card does either type).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float64: 67e12, torch.float32: 67e12}
# H100 SXM L2 (NVIDIA data sheet): a set of inputs smaller than this stays
# in it when one kernel is launched back to back on it.
L2_BYTES = 50 * 2**20
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
    "rbf_row_wss": ("src/repro_torch/kernels/csrc/rbf_row_wss_single.cu",
                    "src/repro/kernels/rbf_row_wss.py:292"),
    "rbf_update_wss": (
        "src/repro_torch/kernels/csrc/rbf_update_wss_single.cu",
        "src/repro/kernels/rbf_update_wss.py:316"),
    "rbf_row_wss_batched_h2": ("src/repro_torch/kernels/csrc/rbf_row_wss.cu",
                               "src/repro/kernels/rbf_row_wss.py:193"),
    "rbf_update_wss_batched_h2": (
        "src/repro_torch/kernels/csrc/rbf_update_wss.cu",
        "src/repro/kernels/rbf_update_wss.py:196"),
    "row_wss_batched_rows_h2": (
        "src/repro_torch/kernels/csrc/row_wss_rows.cu",
        "src/repro/kernels/rbf_row_wss.py:247"),
    "update_wss_batched_rows_h2": (
        "src/repro_torch/kernels/csrc/update_wss_rows.cu",
        "src/repro/kernels/rbf_update_wss.py:261"),
    "rbf_row_wss_batched_act": ("src/repro_torch/kernels/csrc/rbf_row_wss.cu",
                                "src/repro/kernels/rbf_row_wss.py:193"),
    "rbf_update_wss_batched_act": (
        "src/repro_torch/kernels/csrc/rbf_update_wss.cu",
        "src/repro/kernels/rbf_update_wss.py:196"),
    "row_wss_batched_rows_act": (
        "src/repro_torch/kernels/csrc/row_wss_rows.cu",
        "src/repro/kernels/rbf_row_wss.py:247"),
    "update_wss_batched_rows_act": (
        "src/repro_torch/kernels/csrc/update_wss_rows.cu",
        "src/repro/kernels/rbf_update_wss.py:261"),
    "rbf_update_wss_batched_conj": (
        "src/repro_torch/kernels/csrc/rbf_update_wss.cu",
        "src/repro/kernels/rbf_update_wss.py:196"),
    "update_wss_batched_rows_conj": (
        "src/repro_torch/kernels/csrc/update_wss_rows.cu",
        "src/repro/kernels/rbf_update_wss.py:261"),
}
BANK_PASSES = ("row_wss_batched_rows", "update_wss_batched_rows")
RBF_PASSES = ("rbf_row_wss_batched", "rbf_update_wss_batched")
H2_PASSES = ("rbf_row_wss_batched_h2", "rbf_update_wss_batched_h2")
H2_BANK_PASSES = ("row_wss_batched_rows_h2", "update_wss_batched_rows_h2")
BANK_ACT = ("row_wss_batched_rows_act", "update_wss_batched_rows_act")
RBF_ACT = ("rbf_row_wss_batched_act", "rbf_update_wss_batched_act")
SINGLE_PASSES = ("rbf_row_wss", "rbf_update_wss")
# Slice 3: the e-SVR grid (gamma_scale times these, tube widths, Cs), the
# single-lane timing row of benchmarks/solver_micro.py, one-class nu.
SVR_GAMMA_FACTORS = (0.5, 1.0, 2.0)
SVR_EPSILONS = (0.05, 0.1, 0.2)
SVR_CS = (1.0, 10.0)
SVR_B = len(SVR_GAMMA_FACTORS) * len(SVR_EPSILONS) * len(SVR_CS)
# The e-SVR grids that phases 8 and 9 solve run the C = 1 half of the
# grid (9 of its 18 lanes): its C = 10 lanes took up to 150740 iterations
# against at most 42780 for C = 1, and the script must leave room for the
# later phases.  The kernels are still checked and timed at the whole
# grid's B = SVR_B.
SVR_GRID_CS = SVR_CS[:1]
# The compacted grid of phase 9 runs the C = 0.5 third of the (C, gamma)
# grid (30 of its 90 lanes), for the same reason.
COMPACT_CS = GRID_CS[:1]
MICRO = dict(n=16384, C=100.0, gamma=0.5, max_iter=30_000)
# Profiler windows span one host-check chunk of the solvers (CHECK_EVERY):
# the loop runs its first chunk eagerly, so no CUDA graph is captured
# inside a window; the kernels an iteration are the same as a replay's.
PROFILE_ITERS = 32
# Launches of every counted run of the main paths (phases 5-13, 15), summed
# over the runs; "gram_symmetric" counts the Gram's symmetric-mode (bank)
# launches among "gram_block"'s.  The kernels' JSON line reads it.
MAIN_LAUNCHES = collections.Counter()


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
# the chunked drivers' graph cache
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def uncached():
    """The chunked drivers without their per-call CUDA-graph cache: the
    cache's factory swapped for one that never hits
    (``solver_fused._GraphCacheMiss``), so every round builds its loop and
    captures its graphs anew."""
    from repro_torch.core import solver_fused
    saved = solver_fused._GraphCache
    solver_fused._GraphCache = solver_fused._GraphCacheMiss
    try:
        yield
    finally:
        solver_fused._GraphCache = saved


def same_result(a, b, tag):
    """Every field of two results bitwise equal."""
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), \
            (tag, f.name)


def cache_text(log, uncached_log=None) -> str:
    """A chunked call's captures (``capture_guard.CaptureLog``): exactly
    one per (cache entry, chunk shape) visited and none twice; with the
    uncached run's log, its captures beside them."""
    want = log.expected_chunked()
    assert len(log.captures) == want, (len(log.captures), want)
    assert len(set(log.captures)) == len(log.captures)
    text = (f"captures {len(log.captures)} (one per (entry, chunk shape) "
            f"visited: {want}), entries {len({k for k, _ in log.loops})}, "
            f"rounds {len(log.loops)}")
    if uncached_log is not None:
        text += f"; uncached: {len(uncached_log.captures)} captures"
    return text


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


def _points(rng, l, d):
    """l points in d dimensions, normal; with d = 1 the integers 0..l-1
    shuffled and centred instead, since normal draws on a line lie so close
    together that a near-duplicate of i, not the planted tie, would carry
    the best gain."""
    if d == 1:
        return (rng.permutation(l) - l // 2).astype(np.float64)[:, None]
    return rng.normal(size=(l, d))


def kernel_state(l, d, B, seed, dtype, device, gamma_span=16.0):
    """Pass A and pass B inputs with the CPU tests' edge cases: points 5
    and l-3 are duplicates with equal state (an exact gain tie across
    blocks, best in every lane), the last lane of B > 1 is all-masked in
    pass A and has an empty I_up in pass B, lane 0 takes mu = 0, lanes
    alternate the gain rule and every lane has its own gamma,
    gamma_span / d times U(0.05, 0.5)."""
    rng = np.random.default_rng(seed)
    ta, tb = 5, l - 3
    X = _points(rng, l, d)
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
        gammas=t(rng.uniform(0.05, 0.5, B) * gamma_span / d))
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


def bank_state(l, B, n_stack, seed, dtype, device, dup=False):
    """Bank pass A and pass B inputs: the pass state of ``kernel_state``
    (d = 8; ``dup_state``'s doubled (B, 2l) state with ``dup``) over an
    (n_stack, l, l) Gram bank with the lanes spread over its entries.  The
    duplicated points' bank rows and columns are set equal, so their gains
    tie exactly across the first and last block (and, doubled, across the
    halves)."""
    a, b = (dup_state if dup else kernel_state)(l, 8, B, seed, dtype, device)
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
    j_idx = torch.tensor(rng.integers(0, 2 * l if dup else l, size=B),
                         dtype=torch.int32, device=device)
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


def unaligned(t):
    """A contiguous copy of ``t`` one element past 16-byte alignment: the
    bank passes then take their scalar loads."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def check_bank_a(a, dtype, label, errs, act=None, dup=False):
    """Kernel 4 (``act``: its masked variant; ``dup``: H = 2) against its
    plain version: the lanes' (j, gain) the kernel returns, its pick
    folded into the launch, within the tolerance and with exact indices
    (f32: near-ties), the dispatch the kernel's result itself; then the
    reference's rows form, pre-gathered rows read as a bank of one-row
    entries (and the same rows off 16-byte alignment, the scalar loads),
    bitwise the bank form.  Returns (f32 near-ties, the kernel's
    result)."""
    from repro_torch.kernels import ops, rbf_row_wss, ref
    args = [a[k] for k in BANK_A]
    if act is not None:
        kern = lambda *x: rbf_row_wss.row_wss_batched_rows_act(*x, act,
                                                               dup=dup)
    elif dup:
        kern = rbf_row_wss.row_wss_batched_rows_h2
    else:
        kern = rbf_row_wss.row_wss_batched_rows
    j_c, g_c = kern(*args)
    j_t, g_t = ref.row_wss_batched_bank(*args, dup=dup, act=act)
    vals = ref._wss_vals(ref.bank_rows(a["gram"], a["gram_idx"], a["i_idx"],
                                       dup), *[a[k] for k in BANK_A[2:]],
                         act)
    err = _close(f"bank pass A gain {label}", g_c, g_t, TOL[dtype])
    n_ties = _same_picks(f"bank pass A j {label}", j_c[:, None],
                         j_t[:, None], vals, dtype)
    disp = ops.row_wss_batched_bank(*args, impl="cuda", dup=dup, act=act)
    KR = ref.bank_rows(a["gram"], a["gram_idx"], a["i_idx"]).contiguous()
    rows = [kern(R, None, *args[2:]) for R in (KR, unaligned(KR))]
    rows.append(ops.row_wss_batched_rows(KR, *args[2:], impl="cuda",
                                         dup=dup, act=act))
    for got in (disp, *rows):
        if not all(torch.equal(x, y) for x, y in zip(got, (j_c, g_c))):
            raise AssertionError(f"bank pass A {label}: the dispatch or a "
                                 f"rows form differs from the bank form")
    errs.append(err)
    return n_ties, (j_c, g_c)


def check_bank_b(b, dtype, label, errs, act=None, dup=False, dirv=None,
                 mu2=None):
    """Kernel 5 (``act``, ``dup``, and the conjugate direction ``dirv``/
    ``mu2``: its variants) against its plain version: G, the lanes'
    (i_next, g_i_next, g_dn) folded into the launch, and r; the mu = 0
    lane's G bitwise (lane 0, where mu = mu2 = 0); the dispatch the
    kernel's result itself; the rows
    form, aligned and off 16-byte alignment, bitwise the bank form.
    Returns (f32 near-ties, the kernel's result)."""
    from repro_torch.kernels import ops, rbf_update_wss as pb, ref
    args = [b[k] for k in BANK_B]
    kw = dict(dup=dup, act=act, dirv=dirv, mu2=mu2)
    if dirv is not None:
        kern = lambda *x: pb.update_wss_batched_rows_conj(*x, dirv, mu2,
                                                          dup=dup, act=act)
    elif act is not None:
        kern = lambda *x: pb.update_wss_batched_rows_act(*x, act, dup=dup)
    elif dup:
        kern = pb.update_wss_batched_rows_h2
    else:
        kern = pb.update_wss_batched_rows
    got = kern(*args)
    want = ref.update_wss_batched_bank(*args, **kw)
    frozen = b["mu"][0] == 0 and (mu2 is None or mu2[0] == 0)
    if bool(frozen) and not torch.equal(got[0][0], b["G"][0]):
        raise AssertionError(f"bank pass B {label}: the mu = 0 lane's G "
                             f"changed")
    scale = float(b["G"].abs().max())
    err = 0.0
    for name, k in (("G", 0), ("g_i", 2), ("g_dn", 3)):
        err = max(err, _close(f"bank pass B {name} {label}", got[k],
                              want[k], TOL[dtype], scale))
    if dirv is not None:
        err = max(err, _close(f"bank pass B r {label}", got[4], want[4],
                              TOL[dtype], 1.0))
    up = b["alpha_new"] < b["U"]
    vals = torch.where(up if act is None else up & act, want[0], -math.inf)
    n_ties = _same_picks(f"bank pass B i {label}", got[1][:, None],
                         want[1][:, None], vals, dtype)
    disp = ops.update_wss_batched_bank(*args, impl="cuda", **kw)
    KRi, KRj = (ref.bank_rows(b["gram"], b["gram_idx"], b[k]).contiguous()
                for k in ("i_idx", "j_idx"))
    state = [b[k] for k in ("G", "alpha_new", "L", "U")]
    rows = [kern((Ri, Rj), None, *state, None, None, b["mu"])
            for Ri, Rj in ((KRi, KRj), (unaligned(KRi), unaligned(KRj)))]
    rows.append(ops.update_wss_batched_rows(KRi, KRj, *state, b["mu"],
                                            impl="cuda", **kw))
    for other in (disp, *rows):
        if len(other) != len(got) or not all(
                torch.equal(x, y) for x, y in zip(other, got)):
            raise AssertionError(f"bank pass B {label}: the dispatch or a "
                                 f"rows form differs from the bank form")
    errs.append(err)
    return n_ties, got


def check_gram(X1, X2, gamma, dtype, label, errs):
    from repro_torch.kernels import gram_block, ref
    sym = gram_block.gram_cross.symmetric_launches
    K_k = gram_block.gram_cross(X1, X2, gamma)
    assert gram_block.gram_cross.symmetric_launches == sym, label
    K_p = ref.gram_cross(X1, X2, gamma)
    errs.append(_close(f"gram {label}", K_k, K_p, TOL[dtype], 1.0))


def check_gram_bank(X, gamma, dtype, label, errs):
    """The Gram of X with itself in symmetric mode, written into bank[1]
    of a 3-entry bank (at odd l an offset off 16-byte alignment): against
    the plain version, bitwise equal to its transpose, entries 0 and 2
    untouched."""
    from repro_torch.kernels import gram_block, ref
    l = X.shape[0]
    bank = torch.full((3, l, l), math.nan, dtype=dtype, device=X.device)
    sym = gram_block.gram_cross.symmetric_launches
    K = gram_block.gram_cross(X, X, gamma, out=bank[1])
    assert gram_block.gram_cross.symmetric_launches == sym + 1, label
    assert K.data_ptr() == bank[1].data_ptr(), label
    errs.append(_close(f"gram symmetric {label}", K, ref.gram_cross(
        X, X, gamma), TOL[dtype], 1.0))
    if not torch.equal(K, K.T):
        raise AssertionError(f"gram symmetric {label}: K differs from K.T")
    if not (bank[0].isnan().all() and bank[2].isnan().all()):
        raise AssertionError(f"gram symmetric {label}: wrote outside "
                             f"bank[1]")


def single_state(l, d, seed, dtype, device):
    """Kernel 6 and 7 inputs (one lane): points 5 and l-1 are duplicates
    with equal state, an exact gain tie across the first and the last
    128-column segment (one segment at l <= 128) that is the best of pass
    A and, with a raised G, of pass B's next-i scan."""
    rng = np.random.default_rng(seed)
    ta, tb = 5, l - 1
    X = _points(rng, l, d)
    X[tb] = X[ta]
    y = rng.choice([-1.0, 1.0], size=l)
    L, U = np.minimum(0.0, 2.0 * y), np.maximum(0.0, 2.0 * y)
    frac = rng.uniform(size=l)
    frac = np.where(rng.uniform(size=l) < 0.4, np.round(frac), frac)
    frac[[ta, tb]] = 0.5
    alpha = L + (U - L) * frac
    G = rng.normal(size=l)
    G[ta] = G.min() - 50.0
    for arr in (G, alpha, L, U):
        arr[tb] = arr[ta]
    i, j = int(rng.integers(ta + 1, tb)), int(rng.integers(0, l))
    G_b = G.copy()
    G_b[[ta, tb]] = G.max() + 5.0
    sqn = (X * X).sum(axis=1)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    one = lambda a: t(np.reshape(a, (1,)))
    return dict(X=t(X), sqn=t(sqn), G=t(G), alpha=t(alpha), L=t(L), U=t(U),
                xq=t(X[i]), sqq=one(sqn[i]), a_i=one(alpha[i]),
                L_i=one(L[i]), U_i=one(U[i]), g_i=one(G[i] + 1.0),
                i_idx=torch.tensor([i], dtype=torch.int32, device=device),
                use_exact=torch.tensor([False], device=device),
                gamma=one(16.0 / (8.0 * d)), G_b=t(G_b), xq_j=t(X[j]),
                sqq_j=one(sqn[j]), mu=one(rng.normal()))


SINGLE_A = ("X", "sqn", "G", "alpha", "L", "U", "xq", "sqq", "a_i", "L_i",
            "U_i", "g_i", "i_idx", "use_exact", "gamma")


def offset_xt(X):
    """X transposed to (d, l), contiguous, at an address one value past a
    16-byte boundary: the kernels then copy X one value at a time, as they
    do for any odd l."""
    l, d = X.shape
    buf = torch.empty(d * l + 1, dtype=X.dtype, device=X.device)
    XT = buf[1:].view(d, l)
    XT.copy_(X.T)
    assert XT.data_ptr() % 16 != 0
    return XT


def check_single(s, dtype, label, errs_a, errs_b):
    """Kernel 6 (with its relaunch flag both ways) and kernel 7 (with
    mu = 0 bitwise) against their plain versions; both again on an XT off
    16-byte alignment, bitwise equal to the aligned launch (the same sum
    order, other copy widths), with the relaunch flag both ways there."""
    from repro_torch.kernels import build, ops, rbf_row_wss, rbf_update_wss
    from repro_torch.kernels import ref
    args = [s[k] for k in SINGLE_A]
    bl = build.BLOCK_L
    XT_off = offset_xt(s["X"])
    k_k, bmax, barg = rbf_row_wss.rbf_row_wss(*args)
    k_o, omax, oarg = rbf_row_wss.rbf_row_wss(*args, XT=XT_off)
    if not (torch.equal(k_o, k_k) and torch.equal(omax, bmax)
            and torch.equal(oarg, barg)):
        raise AssertionError(f"kernel 6 {label}: an XT off 16-byte "
                             f"alignment changed the result")
    k_p, pmax, parg = ref.rbf_row_wss_blocks(*args, block_l=bl)
    vals = ref._wss_vals(k_p[None], *[s[k][None] for k in (
        "G", "alpha", "L", "U")], *[s[k] for k in (
            "a_i", "L_i", "U_i", "g_i", "i_idx", "use_exact")])
    err = _close(f"kernel 6 k {label}", k_k, k_p, TOL[dtype], 1.0)
    err = max(err, _close(f"kernel 6 bmax {label}", bmax, pmax, TOL[dtype]))
    n_ties = _same_picks(f"kernel 6 barg {label}", barg[None], parg[None],
                         vals, dtype)
    j_c = ops._first_max(bmax[None], barg[None])[0]
    assert int(j_c[0]) == 5, (label, int(j_c[0]))
    # the relaunch: a false flag leaves the stored row bitwise as it was
    other = dict(s, xq=s["xq_j"], sqq=s["sqq_j"])
    other_args = [other[k] for k in SINGLE_A]
    want = ref.rbf_row_wss_blocks(*other_args, block_l=bl)[0]
    for XT in (None, XT_off):
        sentinel = torch.full_like(k_k, 7.0)
        stored = sentinel.clone()
        stored = rbf_row_wss.rbf_row_wss(
            *other_args, XT=XT, k_out=stored,
            run=torch.zeros_like(s["use_exact"]))[0]
        if not torch.equal(stored, sentinel):
            raise AssertionError(f"kernel 6 {label}: a false relaunch flag "
                                 f"changed the stored row")
        stored = rbf_row_wss.rbf_row_wss(
            *other_args, XT=XT, k_out=stored,
            run=torch.ones_like(s["use_exact"]))[0]
        err = max(err, _close(f"kernel 6 relaunched k {label}", stored,
                              want, TOL[dtype], 1.0))
    errs_a.append(err)

    b_args = [s["X"], s["sqn"], s["G_b"], k_p, s["alpha"], s["L"], s["U"],
              s["xq_j"], s["sqq_j"]]
    scale = float(s["G_b"].abs().max())
    err = 0.0
    for mu in (s["mu"], torch.zeros_like(s["mu"])):
        G_k, bmax, barg, bmin = rbf_update_wss.rbf_update_wss(
            *b_args, mu, s["gamma"])
        off = rbf_update_wss.rbf_update_wss(*b_args, mu, s["gamma"],
                                            XT=XT_off)
        if not all(torch.equal(a, b) for a, b in zip(off, (G_k, bmax, barg,
                                                           bmin))):
            raise AssertionError(f"kernel 7 {label}: an XT off 16-byte "
                                 f"alignment changed the result")
        G_p, pmax, parg, pmin = ref.rbf_update_wss_blocks(
            *b_args, mu, s["gamma"], block_l=bl)
        if float(mu) == 0.0 and not torch.equal(G_k, s["G_b"]):
            raise AssertionError(f"kernel 7 {label}: mu = 0 changed G")
        err = max(err, _close(f"kernel 7 G {label}", G_k, G_p, TOL[dtype],
                              scale))
        err = max(err, _close(f"kernel 7 bmax {label}", bmax, pmax,
                              TOL[dtype], scale))
        err = max(err, _close(f"kernel 7 bmin {label}", bmin, pmin,
                              TOL[dtype], scale))
        up = torch.where(s["alpha"] < s["U"], G_p, -math.inf)[None]
        n_ties += _same_picks(f"kernel 7 barg {label}", barg[None],
                              parg[None], up, dtype)
        i_c = ops._first_max(bmax[None], barg[None])[0]
        assert int(i_c[0]) == 5, (label, int(i_c[0]))
    errs_b.append(err)
    return n_ties


def dup_state(l, d, B, seed, dtype, device, gamma_span=16.0):
    """H = 2 pass A and pass B inputs: (B, 2l) state over the base X, with
    the CPU tests' edge cases.  Points 5 and l-3 coincide and half 1 at 5
    carries half 0's state at l-3, so the two tie exactly across halves
    and blocks (the lower doubled index l-3 must win); i lies in half 1
    and its partner i - l is masked; the last lane of B > 1 is all-masked
    in pass A and has an empty I_up in pass B; lane 0 takes mu = 0."""
    rng = np.random.default_rng(seed)
    ta, tb = 5, l - 3
    X = _points(rng, l, d)
    X[tb] = X[ta]
    C = rng.choice([0.5, 1.0, 10.0], size=(B, 1))
    zero = np.zeros((B, l))
    L = np.concatenate([zero, zero - C], axis=1)
    U = np.concatenate([zero + C, zero], axis=1)
    frac = rng.uniform(size=(B, 2 * l))
    frac = np.where(rng.uniform(size=(B, 2 * l)) < 0.4, np.round(frac), frac)
    alpha = L + (U - L) * frac
    G = rng.normal(size=(B, 2 * l))
    G[:, tb] = G.min(axis=1) - 50.0
    alpha[:, tb] = 0.5 * C[:, 0]
    for arr in (G, alpha, L, U):
        arr[:, l + ta] = arr[:, tb]
    lanes = np.arange(B)
    i_idx = rng.integers(ta + 1, tb, size=B) + l
    alpha[lanes, i_idx - l] = L[lanes, i_idx - l]
    j_idx = rng.integers(0, 2 * l, size=B)
    alpha_b = alpha.copy()
    G_b = G.copy()
    G_b[:, [tb, l + ta]] = G.max(axis=1, keepdims=True) + 5.0
    if B > 1:
        alpha[-1] = L[-1]
        alpha_b[-1] = U[-1]
    mu = rng.normal(size=B)
    mu[0] = 0.0
    sqn = (X * X).sum(axis=1)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    ib, jb = i_idx - l, j_idx % l
    a = dict(X=t(X), sqn=t(sqn), G=t(G), alpha=t(alpha), L=t(L), U=t(U),
             XQ=t(X[ib]), sqq=t(sqn[ib]), a_i=t(alpha[lanes, i_idx]),
             L_i=t(L[lanes, i_idx]), U_i=t(U[lanes, i_idx]),
             g_i=t(G[lanes, i_idx] + 1.0),
             i_idx=torch.tensor(i_idx, dtype=torch.int32, device=device),
             use_exact=torch.tensor(lanes % 2 == 1, device=device),
             gammas=t(rng.uniform(0.05, 0.5, B) * gamma_span / d))
    b = dict(X=a["X"], sqn=a["sqn"], G=t(G_b), alpha_new=t(alpha_b),
             L=a["L"], U=a["U"], XQi=a["XQ"], sqqi=a["sqq"], XQj=t(X[jb]),
             sqqj=t(sqn[jb]), mu=t(mu), gammas=a["gammas"])
    return a, b


def check_h2(a, b, dtype, label, errs_a, errs_b):
    """The H = 2 variants of kernels 1 and 2 against their plain versions,
    with the cross-half tie and the mu = 0 lane."""
    from repro_torch.kernels import build, ops, rbf_row_wss, rbf_update_wss
    from repro_torch.kernels import ref
    bl = build.BLOCK_L
    l = a["X"].shape[0]
    args = [a[k] for k in PASS_A_KEYS]
    bmax, barg = rbf_row_wss.rbf_row_wss_batched_h2(*args)
    pmax, parg = ref.rbf_row_wss_batched_blocks(*args, block_l=bl, dup=True)
    vals = ref._wss_vals(ref.rbf_rows_batched(
        a["X"], a["sqn"], a["XQ"], a["sqq"], a["gammas"], dup=True),
        *[a[k] for k in ("G", "alpha", "L", "U", "a_i", "L_i", "U_i", "g_i",
                         "i_idx", "use_exact")])
    err = _close(f"H=2 pass A bmax {label}", bmax, pmax, TOL[dtype])
    n_ties = _same_picks(f"H=2 pass A barg {label}", barg, parg, vals, dtype)
    j_c, g_c = ops.rbf_row_wss_batched(*args, impl="cuda", dup=True)
    j_t, g_t = ops.rbf_row_wss_batched(*args, impl="torch", dup=True)
    err = max(err, _close(f"H=2 pass A gain {label}", g_c, g_t, TOL[dtype]))
    n_ties += _same_picks(f"H=2 pass A j {label}", j_c[:, None],
                          j_t[:, None], vals, dtype)
    B = a["G"].shape[0]
    newton = [k for k in range(0, B - (B > 1), 2)]
    assert (j_c[newton] == l - 3).all(), (label, j_c)
    if B > 1:
        assert int(j_c[-1]) == 0 and g_c[-1].item() == -math.inf, label
    errs_a.append(err)

    args = [b[k] for k in PASS_B_KEYS]
    G_k, bmax, barg, bmin = rbf_update_wss.rbf_update_wss_batched_h2(*args)
    G_p, pmax, parg, pmin = ref.rbf_update_wss_batched_blocks(
        *args, block_l=bl, dup=True)
    if not torch.equal(G_k[0], b["G"][0]):
        raise AssertionError(f"H=2 pass B {label}: the mu = 0 lane changed")
    scale = float(b["G"].abs().max())
    err = _close(f"H=2 pass B G {label}", G_k, G_p, TOL[dtype], scale)
    err = max(err, _close(f"H=2 pass B bmax {label}", bmax, pmax, TOL[dtype],
                          scale))
    err = max(err, _close(f"H=2 pass B bmin {label}", bmin, pmin, TOL[dtype],
                          scale))
    vals = torch.where(b["alpha_new"] < b["U"], G_p, -math.inf)
    n_ties += _same_picks(f"H=2 pass B barg {label}", barg, parg, vals,
                          dtype)
    _, i_c, gi_c, gdn_c = ops.rbf_update_wss_batched(*args, impl="cuda",
                                                     dup=True)
    _, i_t, gi_t, gdn_t = ops.rbf_update_wss_batched(*args, impl="torch",
                                                     dup=True)
    err = max(err, _close(f"H=2 pass B g_i {label}", gi_c, gi_t, TOL[dtype],
                          scale))
    err = max(err, _close(f"H=2 pass B g_dn {label}", gdn_c, gdn_t,
                          TOL[dtype], scale))
    n_ties += _same_picks(f"H=2 pass B i {label}", i_c[:, None],
                          i_t[:, None], vals, dtype)
    assert (i_c[:B - (B > 1)] == l - 3).all(), (label, i_c)
    errs_b.append(err)
    return n_ties


def act_mask(B, n, tie, seed, device):
    """A (B, n) bool active set, 85% of each lane active, with the edge
    cases: lane 0 hides ``tie[0]``, the lower index of the state's exact
    tie and the true argmax of both passes, so ``tie[1]`` must win there;
    lane 1 of B > 2 is all false (index 0 and -inf in both passes); the
    tie stays active in every other lane."""
    rng = np.random.default_rng(seed)
    act = rng.uniform(size=(B, n)) < 0.85
    act[:, list(tie)] = True
    act[0, tie[0]] = False
    if B > 2:
        act[1] = False
    return torch.tensor(act, device=device)


def _expected(B, plain, hidden, newton_only):
    """The picks the edge cases fix: {lane: index} for the tie lanes (even
    lanes only in pass A, where odd lanes take the exact gain) and the
    lanes whose pick must be index 0 at -inf."""
    last = B - (B > 1)
    want = {b: plain for b in range(0, last, 2 if newton_only else 1)}
    empty = [B - 1] if B > 1 else []
    if hidden is not None:
        want[0] = hidden
        if B > 2:
            want.pop(1, None)
            empty.append(1)
    return want, empty


def check_new_a(src, a, act, dtype, label, errs, want, empty, dup):
    """A new pass A variant (the ``act`` variants of kernels 1 and 4, or
    kernel 4's H = 2 variant when ``act`` is None) against its plain
    version (kernel 1: per-block outputs and the dispatched pick; kernel 4:
    :func:`check_bank_a`), then the edge cases."""
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import rbf_row_wss as pa
    if src == "bank":
        n_ties, (j_c, g_c) = check_bank_a(a, dtype, f"{label} A", errs,
                                          act, dup)
        check_edges(j_c, g_c, want, empty, label)
        return n_ties
    bl = build.BLOCK_L
    args = [a[k] for k in PASS_A_KEYS]
    kern = lambda: pa.rbf_row_wss_batched_act(*args, act, dup=dup)
    plain = lambda: ref.rbf_row_wss_batched_blocks(*args, block_l=bl,
                                                   dup=dup, act=act)
    rows = ref.rbf_rows_batched(a["X"], a["sqn"], a["XQ"], a["sqq"],
                                a["gammas"], dup=dup)
    disp = lambda impl: ops.rbf_row_wss_batched(*args, impl=impl, dup=dup,
                                                act=act)
    vals = ref._wss_vals(rows, *[a[k] for k in (
        "G", "alpha", "L", "U", "a_i", "L_i", "U_i", "g_i", "i_idx",
        "use_exact")], act)
    (bmax, barg), (pmax, parg) = kern(), plain()
    err = _close(f"{label} A bmax", bmax, pmax, TOL[dtype])
    n_ties = _same_picks(f"{label} A barg", barg, parg, vals, dtype)
    j_c, g_c = disp("cuda")
    j_t, g_t = disp("torch")
    err = max(err, _close(f"{label} A gain", g_c, g_t, TOL[dtype]))
    n_ties += _same_picks(f"{label} A j", j_c[:, None], j_t[:, None], vals,
                          dtype)
    check_edges(j_c, g_c, want, empty, label)
    check_edges(j_t, g_t, want, {}, label)
    errs.append(err)
    return n_ties


def check_edges(j, g, want, empty, label):
    """The picks the edge cases fix ({lane: index}) and the lanes whose
    pick must be index 0 at -inf."""
    for b, idx in want.items():
        assert int(j[b]) == idx, (label, b, idx, j)
    for b in empty:
        assert int(j[b]) == 0 and g[b].item() == -math.inf, (label, b)


def check_new_b(src, b, act, dtype, label, errs, want, empty, dup):
    """A new pass B variant (the ``act`` variants of kernels 2 and 5, or
    kernel 5's H = 2 variant when ``act`` is None) against its plain
    version (kernel 2: per-block outputs and the dispatched picks; kernel
    5: :func:`check_bank_b`); G with the mask must equal G without it
    bitwise, and the mu = 0 lane's G must come back bitwise."""
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import rbf_update_wss as pb
    if src == "bank":
        n_ties, got = check_bank_b(b, dtype, f"{label} B", errs, act, dup)
        nomask = (pb.update_wss_batched_rows_h2 if dup
                  else pb.update_wss_batched_rows)
        if act is not None and not torch.equal(
                got[0], nomask(*[b[k] for k in BANK_B])[0]):
            raise AssertionError(f"{label} B: G with the mask differs from "
                                 f"G without it")
        check_edges(got[1], got[2], want, empty, label)
        return n_ties
    bl = build.BLOCK_L
    args = [b[k] for k in PASS_B_KEYS]
    kern = lambda m: pb.rbf_update_wss_batched_act(*args, m, dup=dup)
    nomask = (pb.rbf_update_wss_batched_h2 if dup
              else pb.rbf_update_wss_batched)
    plain = lambda: ref.rbf_update_wss_batched_blocks(
        *args, block_l=bl, dup=dup, act=act)
    disp = lambda impl: ops.rbf_update_wss_batched(*args, impl=impl,
                                                   dup=dup, act=act)
    G_k, bmax, barg, bmin = (nomask(*args) if act is None else kern(act))
    G_p, pmax, parg, pmin = plain()
    if act is not None and not torch.equal(G_k, nomask(*args)[0]):
        raise AssertionError(f"{label} B: G with the mask differs from G "
                             f"without it")
    if not torch.equal(G_k[0], b["G"][0]):
        raise AssertionError(f"{label} B: the mu = 0 lane's G changed")
    scale = float(b["G"].abs().max())
    err = _close(f"{label} B G", G_k, G_p, TOL[dtype], scale)
    err = max(err, _close(f"{label} B bmax", bmax, pmax, TOL[dtype], scale))
    err = max(err, _close(f"{label} B bmin", bmin, pmin, TOL[dtype], scale))
    up = b["alpha_new"] < b["U"]
    vals = torch.where(up if act is None else up & act, G_p, -math.inf)
    n_ties = _same_picks(f"{label} B barg", barg, parg, vals, dtype)
    _, i_c, gi_c, gdn_c = disp("cuda")
    _, i_t, gi_t, gdn_t = disp("torch")
    err = max(err, _close(f"{label} B g_i", gi_c, gi_t, TOL[dtype], scale))
    err = max(err, _close(f"{label} B g_dn", gdn_c, gdn_t, TOL[dtype],
                          scale))
    n_ties += _same_picks(f"{label} B i", i_c[:, None], i_t[:, None], vals,
                          dtype)
    check_edges(i_c, gi_c, want, empty, label)
    check_edges(i_t, gi_t, want, {}, label)
    errs.append(err)
    return n_ties


def check_slice4(l, d, B, dtype, device, label, errs, halves=(False, True),
                 gamma_span=16.0):
    """The ``act`` variants of kernels 1 and 2 at one shape, with one state
    half and (``True`` in ``halves``) with two (kernels 4 and 5:
    :func:`check_bank_lanes`)."""
    n_ties = 0
    for dup in halves:
        n = 2 * l if dup else l
        # the exact tie of both passes: (lower, higher) index
        lo, hi = (l - 3, l + 5) if dup else (5, l - 3)
        act = act_mask(B, n, (lo, hi), l + B + dup, device)
        a, b = (dup_state if dup else kernel_state)(
            l, d, B, l + d + B, dtype, device, gamma_span)
        tag = f"rbf H={2 if dup else 1} act {label}"
        n_ties += check_new_a("rbf", a, act, dtype, tag,
                              errs["rbf_row_wss_batched_act"],
                              *_expected(B, lo, hi, True), dup)
        n_ties += check_new_b("rbf", b, act, dtype, tag,
                              errs["rbf_update_wss_batched_act"],
                              *_expected(B, lo, hi, False), dup)
        del a, b
    return n_ties


def conj_inputs(b, l, B, seed, device):
    """The conjugate direction for pass B state ``b``: a (B, l) base row
    (small, as a row difference is), equal at the exact tie's two
    coordinates so the tie survives the update, and mu2.  With B > 2,
    lane 0 is frozen (mu = mu2 = 0) and lane 1 takes mu2 = 0 (the plain
    step); the other lanes move."""
    rng = np.random.default_rng(seed)
    dtype = b["G"].dtype
    base = rng.normal(scale=0.1, size=(B, l))
    base[:, l - 3] = base[:, 5]
    mu2 = rng.normal(scale=0.5, size=B)
    if B > 2:
        mu2[:2] = 0.0
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return t(base), t(mu2)


def check_conj(src, b, act, dtype, label, errs, want, empty, dup):
    """A conjugate variant of kernel 2 or 5 (H = 1 or 2, with or without
    the mask) against its plain version (kernel 2: G, the block values and
    r; kernel 5: :func:`check_bank_b`); with B > 2 the mu = mu2 = 0 lane's
    G bitwise and the mu2 = 0 lane's G bitwise that of the variant without
    the direction (with B <= 2 every lane moves); the dispatched picks and
    edge cases."""
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import rbf_update_wss as pb
    bl = build.BLOCK_L
    B, l = b["G"].shape[0], b["G"].shape[1] // (2 if dup else 1)
    edges = B > 2
    if not edges:
        b = dict(b, mu=torch.full_like(b["mu"], 0.7))
    dirv, mu2 = conj_inputs(b, l, B, l + B + dup, b["G"].device)
    if src == "bank":
        n_ties, got = check_bank_b(b, dtype, f"{label} conj B", errs, act,
                                   dup, dirv, mu2)
        G_nodir = ops.update_wss_batched_bank(*[b[k] for k in BANK_B],
                                              impl="cuda", dup=dup,
                                              act=act)[0]
        conj_moves(got[0], G_nodir, b["G"], edges, label)
        check_edges(got[1], got[2], want, empty, label)
        return n_ties
    args = [b[k] for k in PASS_B_KEYS]
    disp = lambda impl, **kw: ops.rbf_update_wss_batched(
        *args, impl=impl, dup=dup, act=act, **kw)
    G_k, bmax, barg, bmin, r_k = pb.rbf_update_wss_batched_conj(
        *args, dirv, mu2, dup=dup, act=act)
    G_p, pmax, parg, pmin, r_p = ref.rbf_update_wss_batched_blocks(
        *args, block_l=bl, dup=dup, act=act, dirv=dirv, mu2=mu2)
    conj_moves(G_k, disp("cuda")[0], b["G"], edges, label)
    scale = float(b["G"].abs().max())
    err = _close(f"{label} conj B G", G_k, G_p, TOL[dtype], scale)
    err = max(err, _close(f"{label} conj B bmax", bmax, pmax, TOL[dtype],
                          scale))
    err = max(err, _close(f"{label} conj B bmin", bmin, pmin, TOL[dtype],
                          scale))
    err = max(err, _close(f"{label} conj B r", r_k, r_p, TOL[dtype], 1.0))
    up = b["alpha_new"] < b["U"]
    vals = torch.where(up if act is None else up & act, G_p, -math.inf)
    n_ties = _same_picks(f"{label} conj B barg", barg, parg, vals, dtype)
    _, i_c, gi_c, gdn_c, rc = disp("cuda", dirv=dirv, mu2=mu2)
    _, i_t, gi_t, gdn_t, rt = disp("torch", dirv=dirv, mu2=mu2)
    err = max(err, _close(f"{label} conj B g_i", gi_c, gi_t, TOL[dtype],
                          scale))
    err = max(err, _close(f"{label} conj B g_dn", gdn_c, gdn_t, TOL[dtype],
                          scale))
    err = max(err, _close(f"{label} conj B r (dispatched)", rc, rt,
                          TOL[dtype], 1.0))
    n_ties += _same_picks(f"{label} conj B i", i_c[:, None], i_t[:, None],
                          vals, dtype)
    check_edges(i_c, gi_c, want, empty, label)
    check_edges(i_t, gi_t, want, {}, label)
    errs.append(err)
    return n_ties


def conj_moves(G_k, G_nodir, G, edges, label):
    """With ``edges`` (B > 2) lane 0 (mu = mu2 = 0) keeps ``G`` bitwise and
    lane 1 (mu2 = 0) equals the variant without the direction bitwise; the
    lanes with mu2 != 0 move."""
    if edges and not torch.equal(G_k[0], G[0]):
        raise AssertionError(f"{label} conj B: the mu = mu2 = 0 lane's G "
                             f"changed")
    if edges and not torch.equal(G_k[1], G_nodir[1]):
        raise AssertionError(f"{label} conj B: the mu2 = 0 lane's G "
                             f"differs from the variant without dirv")
    moving = slice(2 if edges else 0, None)
    if torch.equal(G_k[moving], G_nodir[moving]):
        raise AssertionError(f"{label} conj B: mu2 != 0 left G as without "
                             f"dirv")


def check_slice5(l, d, B, dtype, device, label, errs, halves=(False, True),
                 gamma_span=16.0):
    """The conjugate variants of kernel 2 at one shape: one state half and
    (``True`` in ``halves``) two, each with and without the active-set
    mask (kernel 5's: :func:`check_bank_lanes`)."""
    n_ties = 0
    for dup in halves:
        n = 2 * l if dup else l
        lo, hi = (l - 3, l + 5) if dup else (5, l - 3)
        _, b = (dup_state if dup else kernel_state)(
            l, d, B, l + d + B + 1, dtype, device, gamma_span)
        for masked in (False, True):
            act = (act_mask(B, n, (lo, hi), l + B + dup, device)
                   if masked else None)
            tag = f"rbf H={2 if dup else 1}{' act' if masked else ''} {label}"
            n_ties += check_conj(
                "rbf", b, act, dtype, tag,
                errs["rbf_update_wss_batched_conj"],
                *_expected(B, lo, hi if masked else None, False), dup)
        del b
    return n_ties


# Shapes where the tiled rbf passes (rbf_tile.cuh) have edges: one column
# past a block (l = 129, also odd, so the 16-byte paths are off); one lane
# group of 16, of 32 with one lane used, two and three groups (l = 1000,
# d = 128: X resident in shared memory); X streamed again per lane group
# (d = 1000, one and two groups); one feature.  At d = 1000 the lanes'
# gammas span 4 / d times U(0.05, 0.5), so gamma |x|^2 lies in 0.2-2 as
# gamma="scale" times the grid's 0.5-2 puts it: with the 16 / d of the
# other shapes (gamma |x|^2 up to 8) a float32 row's value at its own
# point sums 1000 products whose rounding alone moves it by 1e-5 (kernel
# 0.9999821, plain version 0.9999924, exactly 1), the f32 tolerance.
TILE_EDGES = ((129, 37, 17), (1000, D, 16), (1000, D, 17), (1000, D, 33),
              (1000, D, 90), (2048, 1000, 17), (2048, 1000, 33),
              (1000, 1, 17))


def check_tile_edge(l, d, B, dtype, device, label, errs):
    """Every variant of kernels 1 and 2 at one shape against its plain
    version, with the checks of the main shapes: H = 1 (ties across
    blocks, mu = 0 bitwise, all-masked lane), H = 2 (the cross-half tie),
    ``act`` with one and two halves (all-false lane, hidden argmax, G with
    the mask bitwise G without) and the conjugate variants (mu = mu2 = 0
    and mu2 = 0 lanes bitwise)."""
    span = 16.0 if d <= D else 4.0
    a, b = kernel_state(l, d, B, l + d + B, dtype, device, span)
    n = check_pass_a(a, dtype, label, errs["rbf_row_wss_batched"])
    n += check_pass_b(b, dtype, label, errs["rbf_update_wss_batched"])
    a, b = dup_state(l, d, B, l + d + B, dtype, device, span)
    n += check_h2(a, b, dtype, label, errs["rbf_row_wss_batched_h2"],
                  errs["rbf_update_wss_batched_h2"])
    del a, b
    n += check_slice4(l, d, B, dtype, device, label, errs, gamma_span=span)
    return n + check_slice5(l, d, B, dtype, device, label, errs,
                            gamma_span=span)


# The edges of kernels 6 and 7's segments and copies: a segment short of
# 128 columns, one column past a segment, odd rows of XT off 16-byte
# alignment; one feature, a ragged last stage of the ring, d = 1000 (the
# ring cycled eight times, gamma |x|^2 about 2).
SINGLE_EDGES = tuple((l, d, "edge") for l in (127, 129, 1001)
                     for d in (1, 37, 1000))

# The Gram kernel's edges (tiles of 128 x 64 in f64, 128 x 128 in f32): one
# row or column, a tile, one short of it and one past it, each against
# 333 (odd: single-value stores) and 4096 on the other side; d = 1, 37
# (f64 rows off 16-byte alignment: single-value copies), 128 and 1000
# (the ring cycled 63 times).  The symmetric mode at l = 127, 129, 1001
# (bank[1] of a 3-entry bank starts off 16-byte alignment) and 16384.
# gamma = 1 / (2 d) puts gamma |x|^2 near 0.5 for normal rows, inside the
# 0.2-2 that TILE_EDGES draws at d = 1000 for the reason given there.
GRAM_SIDES = (1, 127, 128, 129, 1000)
GRAM_EDGES = tuple((a, b, d) for s in GRAM_SIDES for o in (333, 4096)
                   for a, b in ((s, o), (o, s)) for d in (1, 37, 128, 1000))
GRAM_SYM_EDGES = (tuple((l, d) for l in (127, 129, 1001)
                        for d in (1, 37, 128, 1000))
                  + ((N_TRAIN, D), (N_TRAIN, 37)))

# Kernels 4 and 5 in every variant at these (l, B, bank entries): the
# grid's B = 90, the e-SVR grid's B = 18, B = 3 (64-thread blocks) and
# B = 1 (32-thread blocks) at l = 16384; an odd l (the scalar loads) at
# B = 90 and 1; l = 300 at B = 19.
BANK_SHAPES = ((N_TRAIN, 90, 3), (N_TRAIN, 18, 3), (N_TRAIN, 3, 3),
               (N_TRAIN, 1, 1), (1001, 90, 3), (1001, 1, 1), (300, 19, 3))


def check_bank_lanes(l, B, n_stack, dtype, device, label, errs):
    """Every variant of the bank passes at one shape, one state half and
    two: kernel 4 plain and ``act``, kernel 5 plain, ``act``, conjugate and
    conjugate with ``act`` (:func:`check_bank_a`, :func:`check_bank_b`),
    with the edge cases of :func:`bank_state` and :func:`act_mask`."""
    n_ties = 0
    for dup in (False, True):
        n = 2 * l if dup else l
        lo, hi = (l - 3, l + 5) if dup else (5, l - 3)
        a, b = bank_state(l, B, n_stack, l + B, dtype, device, dup=dup)
        act = act_mask(B, n, (lo, hi), l + B + dup, device)
        for masked in (False, True):
            m = act if masked else None
            hidden = hi if masked else None
            tag = (f"bank H={2 if dup else 1}{' act' if masked else ''} "
                   f"{label}")
            suffix = "_act" if masked else "_h2" if dup else ""
            n_ties += check_new_a("bank", a, m, dtype, tag,
                                  errs["row_wss_batched_rows" + suffix],
                                  *_expected(B, lo, hidden, True), dup)
            n_ties += check_new_b("bank", b, m, dtype, tag,
                                  errs["update_wss_batched_rows" + suffix],
                                  *_expected(B, lo, hidden, False), dup)
            n_ties += check_conj("bank", b, m, dtype, tag,
                                 errs["update_wss_batched_rows_conj"],
                                 *_expected(B, lo, hidden, False), dup)
        del a, b, act
    return n_ties


PASS_A_KEYS = ("X", "sqn", "G", "alpha", "L", "U", "XQ", "sqq", "a_i", "L_i",
               "U_i", "g_i", "i_idx", "use_exact", "gammas")
PASS_B_KEYS = ("X", "sqn", "G", "alpha_new", "L", "U", "XQi", "sqqi", "XQj",
               "sqqj", "mu", "gammas")


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
        # the edges slice two pools of rows (each sliced copy contiguous)
        P1 = torch.tensor(rng.normal(size=(4096, 1000)), dtype=dtype,
                          device=device)
        P2 = torch.tensor(rng.normal(size=(4096, 1000)), dtype=dtype,
                          device=device)
        for m, n, d in GRAM_EDGES:
            check_gram(P1[:m, :d].contiguous(), P2[:n, :d].contiguous(),
                       1.0 / (2 * d), dtype, f"edge {m}x{n} d={d}",
                       errs["gram_block"])
        say(f"[kernels] gram ok at its {len(GRAM_EDGES)} edges (m, n in "
            f"{GRAM_SIDES} against 333 and 4096, d = 1, 37, 128, 1000) "
            f"{str(dtype)[6:]}")
        del P1, P2
        for l, d in GRAM_SYM_EDGES:
            X = torch.tensor(rng.normal(size=(l, d)), dtype=dtype,
                             device=device)
            label = f"l={l} d={d} {str(dtype)[6:]}"
            check_gram_bank(X, 1.0 / (2 * d), dtype, label,
                            errs["gram_block"])
            del X
            say(f"[kernels] gram symmetric ok (into bank[1] of 3, bitwise "
                f"equal to its transpose, bank[0] and bank[2] untouched): "
                f"{label}")
        for l, B, n_stack in BANK_SHAPES:
            label = f"l={l} B={B} bank={n_stack} {str(dtype)[6:]}"
            n = check_bank_lanes(l, B, n_stack, dtype, device, label, errs)
            say(f"[kernels] every variant of kernels 4 and 5 (H = 1, 2, "
                f"act, conjugate; lane results, the pick in the launch) ok, "
                f"the rows form bitwise the bank form aligned and off "
                f"16-byte alignment (ties across blocks and halves, hidden "
                f"argmax, all-false and all-masked lanes, mu = 0 and "
                f"mu = mu2 = 0 bitwise) ({n} f32 near-ties): {label}")
        for l, d, kind in ((N_TRAIN, D, "main"), (1000, 37, "odd"),
                           (300, 5, "odd"), *SINGLE_EDGES):
            label = f"{kind} l={l} d={d} {str(dtype)[6:]}"
            n = check_single(single_state(l, d, l + d, dtype, device), dtype,
                             label, errs["rbf_row_wss"],
                             errs["rbf_update_wss"])
            say(f"[kernels] kernel 6 ok (relaunch flag false: row "
                f"untouched; true: replaced), kernel 7 ok (mu = 0 bitwise), "
                f"both bitwise on an XT off 16-byte alignment ({n} f32 "
                f"near-ties): {label}")
        for l, d, B, kind in ((N_TRAIN, D, SVR_B, "main"),
                              (N_TRAIN, D, 7, "odd"), (1000, 37, 1, "odd"),
                              (300, 5, 19, "odd")):
            label = f"{kind} l={l} d={d} B={B} {str(dtype)[6:]}"
            a, b = dup_state(l, d, B, l + d + B, dtype, device)
            n = check_h2(a, b, dtype, label,
                         errs["rbf_row_wss_batched_h2"],
                         errs["rbf_update_wss_batched_h2"])
            del a, b
            say(f"[kernels] H=2 pass A and pass B ok (cross-half tie to the "
                f"lower index, mu = 0 bitwise) ({n} f32 near-ties): {label}")
        # main shapes: the (C, gamma) grid's (one state half) and the
        # e-SVR grid's (two)
        for l, d, B, halves, kind in (
                (N_TRAIN, D, GRID_B, (False,), "main"),
                (N_TRAIN, D, SVR_B, (True,), "main"),
                (1000, 37, 1, (False, True), "odd"),
                (300, 5, 19, (False, True), "odd")):
            label = f"{kind} l={l} d={d} B={B} {str(dtype)[6:]}"
            n = check_slice4(l, d, B, dtype, device, label, errs, halves)
            say(f"[kernels] act variants of kernels 1 and 2 (H = 1, 2) "
                f"ok (all-false lane, hidden argmax, "
                f"ties across blocks and halves, G with the mask bitwise "
                f"equal to G without, mu = 0 bitwise) ({n} f32 "
                f"near-ties): {label}")
        # slice 5: the conjugate variants of kernel 2 at the main paths'
        # shapes (the SVC's B = 10 and the grids' B = 90 at H = 1, the
        # SVR's B = 1 at H = 2, each a lane group of its own) and at odd
        # ones
        for l, d, B, halves, kind in (
                (N_TRAIN, D, K, (False,), "main"),
                (N_TRAIN, D, GRID_B, (False,), "main"),
                (N_TRAIN, D, 1, (True,), "main"),
                (N_TRAIN, D, SVR_B, (True,), "main"),
                (1000, 37, 3, (False, True), "odd"),
                (300, 5, 19, (False, True), "odd")):
            label = f"{kind} l={l} d={d} B={B} {str(dtype)[6:]}"
            n = check_slice5(l, d, B, dtype, device, label, errs, halves)
            say(f"[kernels] conjugate variants of kernel 2 (H = 1, "
                f"2, with and without act) ok (r, mu = mu2 = 0 lane "
                f"bitwise, mu2 = 0 lane bitwise equal to the variant "
                f"without dirv, mu2 != 0 lanes moved, ties, all-false "
                f"lane) ({n} f32 near-ties): {label}")
        for l, d, B in TILE_EDGES:
            label = f"tile edge l={l} d={d} B={B} {str(dtype)[6:]}"
            n = check_tile_edge(l, d, B, dtype, device, label, errs)
            say(f"[kernels] every variant of kernels 1 and 2 (H = 1, 2, act, "
                f"conjugate) ok at a tile edge ({n} f32 near-ties): {label}")
    torch.cuda.synchronize()
    worst = {k: max(v) for k, v in errs.items()}
    say(f"[kernels] all kernels agree with their plain versions; max abs "
        f"err {worst}")
    return worst


# The batched rbf variants of the main paths (kernel, B, H, act, conj):
# the SVC's B = 10, the e-SVR grid's B = 18 at H = 2, the (C, gamma) grid's
# B = 90 with shrinking, and the conjugate variants as phase 10 launches
# them (B = 18 for the H = 2 mask, which it does not).
TILE_VARIANTS = (
    ("rbf_row_wss_batched", K, 1, False, False),
    ("rbf_row_wss_batched", SVR_B, 2, False, False),
    ("rbf_row_wss_batched", GRID_B, 1, True, False),
    ("rbf_update_wss_batched", K, 1, False, False),
    ("rbf_update_wss_batched", SVR_B, 2, False, False),
    ("rbf_update_wss_batched", GRID_B, 1, True, False),
    ("rbf_update_wss_batched", K, 1, False, True),
    ("rbf_update_wss_batched", GRID_B, 1, True, True),
    ("rbf_update_wss_batched", 1, 2, False, True),
    ("rbf_update_wss_batched", SVR_B, 2, True, True),
)


def phase_resources():
    """Registers, local memory (spills included) and shared memory of the
    tiled variants of kernels 1 and 2, of the Gram kernel (kernel 3) and of
    kernels 6 and 7, from ``cudaFuncGetAttributes``."""
    from repro_torch.kernels import build, gram_block
    out = []
    # the Gram: f64 with and without 16-byte copies, f32 (one instance)
    for bits, vec in ((64, True), (64, False), (32, False)):
        r = build.gram_attrs(bits, vec)
        tile = (r.pop("tm"), r.pop("tn"))
        assert tile == gram_block.TILE[bits], (bits, tile)
        out.append(dict(kernel="gram_block", f=bits, vec=vec, tile=tile,
                        **r))
    for name, B, H, act, conj in TILE_VARIANTS:
        for bits in (64, 32):
            r = build.tile_attrs(name, bits, B, H, act, conj)
            out.append(dict(kernel=name, f=bits, B=B, H=H, act=act,
                            conj=conj, **r))
    for name in SINGLE_PASSES:
        for bits in (64, 32):
            out.append(dict(kernel=name, f=bits, B=1, H=1, act=False,
                            conj=False, **build.single_attrs(name, bits)))
    spills = [r for r in out if r["local_bytes"]]
    say(f"[resources] kernels 1, 2, 3, 6 and 7: registers a thread "
        f"{min(r['regs'] for r in out)}-{max(r['regs'] for r in out)}, "
        f"shared memory a block {min(r['dynamic_smem'] for r in out)}-"
        f"{max(r['dynamic_smem'] for r in out)} B, "
        f"{len(spills)} variants with local memory (spills)")
    say("[resources] " + json.dumps(out))


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
    phase_small_slice3(device, impl, eps)
    compacted = phase_small_slice4(device, impl)
    phase_small_slice5(device, impl)
    return compacted


def sinc_target(X, seed):
    """The repo's sinc target (examples/svr_quickstart.py) on a seeded unit
    projection of X, standardised and scaled to +-3, with 0.1 noise."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=X.shape[1])
    z = X @ (w / np.linalg.norm(w))
    z = (z - z.mean()) / z.std()
    z = 3.0 * z / np.abs(z).max()
    return np.sinc(z) + 0.1 * rng.normal(size=len(z))


def phase_small_slice3(device, impl, eps):
    """Slice 3 end to end, small: single-lane solve_fused, SVR, OneClassSVM
    and a 2 x 2 x 2 e-SVR grid, ``impl`` against ``impl="torch"``."""
    from repro_torch.core import grid
    from repro_torch.core.solver import SolverConfig
    from repro_torch.core.solver_fused import solve_fused
    from repro_torch.svm import SVR, OneClassSVM, data
    X, y = data.xor_gaussians(400, seed=3)
    for alg in ("smo", "pasmo"):
        fits = {which: solve_fused(X, y, 10.0, 0.5,
                                   SolverConfig(algorithm=alg, eps=eps),
                                   impl=which, device=device,
                                   dtype=torch.float64)
                for which in (impl, "torch")}
        rk, rp = fits[impl], fits["torch"]
        assert bool(rk.converged) and bool(rp.converged)
        assert float(rk.kkt_gap) <= eps
        np.testing.assert_allclose(float(rk.objective), float(rp.objective),
                                   rtol=1e-6)
        say(f"[small] solve_fused {alg}: iterations {int(rk.iterations)} "
            f"(plain {int(rp.iterations)}), objective rel diff "
            f"{abs(float(rk.objective / rp.objective) - 1):.3e}")
    Xs = np.random.default_rng(4).normal(size=(500, 6))
    ys = sinc_target(Xs, 5)
    Xtr, ytr, Xte = Xs[:400], ys[:400], Xs[400:]
    fits = {which: SVR(C=1.0, epsilon=0.1, gamma="scale", eps=eps,
                       impl=which, device=device,
                       dtype=torch.float64).fit(Xtr, ytr)
            for which in (impl, "torch")}
    rk, rp = fits[impl].fit_result_, fits["torch"].fit_result_
    assert bool(rk.converged) and float(rk.kkt_gap) <= eps
    np.testing.assert_allclose(float(rk.objective), float(rp.objective),
                               rtol=1e-6)
    assert abs(float(rk.alpha.sum())) <= 1e-8
    pk = fits[impl].predict(Xte)
    pp = fits["torch"].predict(Xte)
    say(f"[small] SVR: iterations {int(rk.iterations)} (plain "
        f"{int(rp.iterations)}), objective rel diff "
        f"{abs(float(rk.objective / rp.objective) - 1):.3e}, held-out "
        f"prediction max diff {float((pk - pp).abs().max()):.3e}")
    fits = {which: OneClassSVM(nu=0.1, gamma="scale", eps=eps, impl=which,
                               device=device,
                               dtype=torch.float64).fit(Xtr)
            for which in (impl, "torch")}
    rk, rp = fits[impl].fit_result_, fits["torch"].fit_result_
    assert bool(rk.converged) and float(rk.kkt_gap) <= eps
    np.testing.assert_allclose(float(rk.objective), float(rp.objective),
                               rtol=1e-6)
    say(f"[small] OneClassSVM: iterations {int(rk.iterations)} (plain "
        f"{int(rp.iterations)}), objective rel diff "
        f"{abs(float(rk.objective / rp.objective) - 1):.3e}")
    fits = {which: grid.solve_grid_svr(Xtr, ytr, (0.5, 2.0), (0.05, 0.2),
                                       (0.1, 0.4), SolverConfig(eps=1e-5),
                                       impl=which, device=device,
                                       dtype=torch.float64)
            for which in (impl, "torch")}
    rk, rp = fits[impl], fits["torch"]
    assert bool(rk.converged.all()) and float(rk.kkt_gap.max()) <= 1e-5
    np.testing.assert_allclose(rk.objective.cpu().numpy(),
                               rp.objective.cpu().numpy(), rtol=1e-6)
    rel = (rk.objective - rp.objective).abs() / rp.objective.abs()
    say(f"[small] e-SVR grid 2x2x2 ({impl}: rbf H=2; plain: bank): "
        f"iterations {rk.iterations.flatten().tolist()} (plain "
        f"{rp.iterations.flatten().tolist()}), objective rel diff "
        f"{float(rel.max()):.3e}")


def _agree(tag, rk, rp, eps):
    """``impl`` against the plain versions: converged, gap, objectives."""
    assert bool(rk.converged.all()) and bool(rp.converged.all()), tag
    assert float(rk.kkt_gap.max()) <= eps, (tag, rk.kkt_gap)
    np.testing.assert_allclose(rk.objective.cpu().numpy(),
                               rp.objective.cpu().numpy(), rtol=1e-6)
    rel = (rk.objective - rp.objective).abs() / rp.objective.abs()
    say(f"[small] {tag}: iterations {rk.iterations.flatten().tolist()} "
        f"(plain {rp.iterations.flatten().tolist()}), objective rel diff "
        f"{float(rel.max()):.3e}")


def phase_small_slice4(device, impl):
    """Slice 4 end to end, small, ``impl`` against ``impl="torch"``:
    soft shrinking through the (C, gamma) grid and the compacted grid with
    hard shrinking on both row sources, the e-SVR grid through the bank
    with and without shrinking, the one-class grid through the bank with
    shrinking, and the mask refresh under CUDA graphs against the eager
    loop; and both chunked drivers' graph caches against the uncached
    drivers, bitwise."""
    from repro_torch.analysis.capture_guard import CaptureLog
    from repro_torch.core import grid
    from repro_torch.core import multiclass as mc
    from repro_torch.core.solver import SolverConfig
    from repro_torch.core.solver_fused import solve_fused_batched
    from repro_torch.svm import data
    eps = 1e-5
    cfg = SolverConfig(eps=eps)
    compacted_runs = {}
    # small: the plain versions run their loops eagerly on the card
    X, y = data.multiclass_blobs(150, seed=2, k=3, d=8, sep=4.0)
    Y = mc.ovr_labels(mc.class_index(y)[1], 3, torch.float64, device)
    Xs = np.random.default_rng(4).normal(size=(120, 6))
    ys = sinc_target(Xs, 5)
    f64 = dict(device=device, dtype=torch.float64)
    for precompute in (True, False):
        src = "bank" if precompute else "rbf"
        kw = dict(precompute=precompute, shrinking=True, **f64)
        runs = {which: grid.solve_grid(X, Y, (4.0, 1.0), (0.05, 0.2), cfg,
                                       impl=which, **kw)
                for which in (impl, "torch")}
        _agree(f"grid 3-class 2x2 shrinking, {src}", runs[impl],
               runs["torch"], eps)
        runs = {which: grid.solve_grid_compacted(
            X, Y, (4.0, 1.0), (0.05, 0.2), cfg, chunk=32, impl=which, **kw)
            for which in (impl, "torch")}
        _agree(f"compacted grid chunk=32 shrinking, {src}", runs[impl],
               runs["torch"], eps)
        # the graph cache: cached and uncached bitwise, one capture per
        # (entry, chunk shape); chunk=96 runs three chunks a round
        for chunk in (32, 96):
            def compacted():
                return grid.solve_grid_compacted(
                    X, Y, (4.0, 1.0), (0.05, 0.2), cfg, chunk=chunk,
                    impl=impl, **kw)
            with CaptureLog() as log:
                cached = compacted()
            with uncached(), CaptureLog() as log_u:
                same_result(cached, compacted(), "compacted grid")
            say(f"[small] compacted grid chunk={chunk} shrinking, {src}: "
                f"cached and uncached bitwise equal; {cache_text(log, log_u)}")
            compacted_runs[(precompute, chunk)] = cached
    # the classic compacted grid (impl=None), cached and uncached
    for shrinking in (False, True):
        def classic():
            return grid.solve_grid_compacted(
                X, Y, (4.0, 1.0), (0.05, 0.2), SolverConfig(eps=eps),
                chunk=96, shrinking=shrinking, **f64)
        with CaptureLog() as log:
            cached = classic()
        with uncached(), CaptureLog() as log_u:
            same_result(cached, classic(), "classic compacted grid")
        say(f"[small] classic compacted grid chunk=96 shrinking={shrinking}:"
            f" cached and uncached bitwise equal; {cache_text(log, log_u)}")
    for shrinking in (True, False):
        runs = {which: grid.solve_grid_svr(Xs, ys, (0.5, 2.0), (0.05, 0.2),
                                           (0.1, 0.4), cfg, impl=which,
                                           precompute=True,
                                           shrinking=shrinking, **f64)
                for which in (impl, "torch")}
        _agree(f"e-SVR grid 2x2x2, bank (H = 2 bank passes), shrinking="
               f"{shrinking}", runs[impl], runs["torch"], eps)
        assert float(runs[impl].alpha.sum(-1).abs().max()) <= 1e-8
    runs = {which: grid.solve_grid_oneclass(Xs, (0.1, 0.3), (0.1, 0.4), cfg,
                                            impl=which, precompute=True,
                                            shrinking=True, **f64)
            for which in (impl, "torch")}
    _agree("one-class grid 2x2 shrinking, bank", runs[impl], runs["torch"],
           eps)
    # the mask refresh under CUDA graphs (check_every=5: eight patterns of
    # refreshes in a chunk) against the eager-every-iteration loop
    Xx, yx = data.xor_gaussians(200, seed=4)
    cfg8 = SolverConfig(eps=eps, shrink_every=8)
    runs = [solve_fused_batched(Xx, np.stack([yx, -yx]), (100.0, 10.0), 0.5,
                                cfg8, impl=impl, shrinking=True,
                                check_every=ce, device=device,
                                dtype=torch.float64) for ce in (5, 1)]
    for f in ("iterations", "n_unshrink", "alpha"):
        assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f
    assert bool(runs[0].converged.all())
    assert float(runs[0].kkt_gap.max()) <= eps
    say(f"[small] soft shrinking, shrink_every=8: check_every=5 (graphs) "
        f"and 1 agree bitwise: iterations {runs[0].iterations.tolist()}, "
        f"n_unshrink {runs[0].n_unshrink.tolist()}")
    return compacted_runs


def phase_small_slice5(device, impl):
    """Slice 5 end to end, small, ``impl`` against ``impl="torch"``: the
    conjugate step in SVC, the (C, gamma) grid through both row sources
    and the one-class grid, each with and without shrinking, the e-SVR
    grid through the rbf passes with shrinking and through the bank
    without (the two H = 2 variants phase 10 does not launch), the
    compacted grid (``chunk=32``); then one conjugate fit run twice
    (bitwise: the four-index alpha update is deterministic) and
    ``check_every=5`` (graphs) against ``1``."""
    from repro_torch.core import grid
    from repro_torch.core import multiclass as mc
    from repro_torch.core.solver import SolverConfig
    from repro_torch.core.solver_fused import solve_fused_batched
    from repro_torch.svm import SVC, data
    eps = 1e-5
    cfg = SolverConfig(algorithm="smo", step="conjugate", eps=eps)
    f64 = dict(device=device, dtype=torch.float64)
    X, y = data.multiclass_blobs(150, seed=2, k=3, d=8, sep=4.0)
    fits = {which: SVC(C=1.0, gamma="scale", algorithm="smo",
                       step="conjugate", eps=eps, impl=which,
                       **f64).fit(X[:100], y[:100])
            for which in (impl, "torch")}
    _agree("SVC 3-class conjugate", fits[impl].fit_result_,
           fits["torch"].fit_result_, eps)
    assert int(fits[impl].fit_result_.n_planning.max()) > 0
    np.testing.assert_array_equal(fits[impl].predict(X[100:]),
                                  fits["torch"].predict(X[100:]))
    Y = mc.ovr_labels(mc.class_index(y)[1], 3, torch.float64, device)
    Xs = np.random.default_rng(4).normal(size=(120, 6))
    ys = sinc_target(Xs, 5)
    # (problem, run, the row sources (precompute) without and with
    # shrinking)
    problems = (
        ("grid 3-class 2x2", lambda kw: grid.solve_grid(
            X, Y, (4.0, 1.0), (0.05, 0.2), cfg, **kw),
         ((True, False), (True, False))),
        ("e-SVR grid 2x2x2", lambda kw: grid.solve_grid_svr(
            Xs, ys, (0.5, 2.0), (0.05, 0.2), (0.1, 0.4), cfg, **kw),
         ((True,), (False,))),
        ("one-class grid 2x2", lambda kw: grid.solve_grid_oneclass(
            Xs, (0.1, 0.3), (0.1, 0.4), cfg, **kw), ((True,), (True,))))
    for shrinking in (False, True):
        for tag, run, sources in problems:
            for precompute in sources[shrinking]:
                src = "bank" if precompute else "rbf"
                runs = {which: run(dict(impl=which, precompute=precompute,
                                        shrinking=shrinking, **f64))
                        for which in (impl, "torch")}
                _agree(f"{tag} conjugate, {src}, shrinking={shrinking}",
                       runs[impl], runs["torch"], eps)
                assert int(runs[impl].n_planning.max()) > 0, tag
    runs = {which: grid.solve_grid_compacted(
        X, Y, (4.0, 1.0), (0.05, 0.2), cfg, chunk=32, impl=which,
        precompute=True, shrinking=True, **f64) for which in (impl, "torch")}
    _agree("compacted grid chunk=32 conjugate, bank", runs[impl],
           runs["torch"], eps)
    # determinism: the same fit twice on the card, bitwise (graphs on)
    Xx, yx = data.xor_gaussians(200, seed=4)
    Yx = np.stack([yx, -yx])
    twice = [solve_fused_batched(Xx, Yx, (20.0, 5.0), 0.5, cfg, impl=impl,
                                 shrinking=True, **f64) for _ in range(2)]
    for f in ("alpha", "G", "iterations", "n_planning", "n_unshrink"):
        assert torch.equal(getattr(twice[0], f), getattr(twice[1], f)), f
    # the mask refresh and the carried direction under CUDA graphs
    cfg8 = SolverConfig(algorithm="smo", step="conjugate", eps=eps,
                        shrink_every=8)
    runs = [solve_fused_batched(Xx, Yx, (20.0, 5.0), 0.5, cfg8, impl=impl,
                                shrinking=True, check_every=ce, **f64)
            for ce in (5, 1)]
    for f in ("alpha", "G", "iterations", "n_planning", "n_unshrink"):
        assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f
    assert bool(runs[0].converged.all())
    assert float(runs[0].kkt_gap.max()) <= eps
    say(f"[small] conjugate: one fit twice bitwise equal (iterations "
        f"{twice[0].iterations.tolist()}, accepted "
        f"{twice[0].n_planning.tolist()}); shrink_every=8, check_every=5 "
        f"(graphs) and 1 agree bitwise: iterations "
        f"{runs[0].iterations.tolist()}, accepted "
        f"{runs[0].n_planning.tolist()}, n_unshrink "
        f"{runs[0].n_unshrink.tolist()}")


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
    counts = read_launches()                 # ... and ends here
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
                    max_iter=PROFILE_ITERS, device=device,
                    dtype=torch.float64).fit(Xtr, ytr),
        "SVC f64 full width", ms_iter)
    lane0 = dict(objective=float(r64.objective[0]), gamma=c64.gamma_,
                 iterations=int(r64.iterations[0]))
    svc_ref = dict(objective=r64.objective, pred=p64, alpha=r64.alpha,
                   iterations=r64.iterations, loop=t64, ms_iter=ms_iter,
                   gamma=c64.gamma_)
    return rec, lane0, svc_ref


def device_events(prof):
    """The device events of a ``torch.profiler`` window, split into the
    loop's kernels and the one-off work (copies, sets, Gram builds)."""
    # record_function ranges (a span recorder's spans, when one is
    # active) show up on the device's track too, under their host names:
    # they are spans, not kernels
    avgs = prof.key_averages()
    host = {e.key for e in avgs
            if e.device_type == torch.autograd.DeviceType.CPU}
    events = [e for e in avgs
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.key not in host
              and not getattr(e, "is_user_annotation", False)]
    once = [e for e in events if e.key.startswith(("Memcpy", "Memset"))
            or "gram_kernel" in e.key]
    return [e for e in events if e not in once], once


def profile_iterations(run, label, ms_iter, n_iter=None):
    """Device kernels an iteration launches and the device's busy share of
    the iteration's wall time, from ``torch.profiler`` over ``run()``, a
    fit capped at ``n_iter`` iterations at full width (the lanes do not
    converge within it).  The fit's one-off copies (X up, X down for
    ``gamma="scale"``, results down) and Gram-bank builds are reported
    apart from the iterations' kernels.  Returns the device kernels an
    iteration and their busy ms an iteration (None without device
    time)."""
    from torch.profiler import ProfilerActivity, profile
    n_iter = PROFILE_ITERS if n_iter is None else n_iter
    run()                                    # warm-up, outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kern, once = device_events(prof)
    dev_us = sum(e.self_device_time_total for e in kern)
    if dev_us <= 0:
        say(f"[profile] {label}: torch.profiler recorded no device time: "
            f"busy share not measured")
        return None
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
    return dict(kernels=sum(e.count for e in kern) / n_iter, busy_ms=busy_ms)


def kernel_times(device, timer):
    from repro_torch.kernels import (build, gram_block, rbf_row_wss,
                                     rbf_update_wss, ref)
    recs = {}
    for dtype in (torch.float64, torch.float32):
        item = torch.tensor([], dtype=dtype).element_size()
        a, b = kernel_state(N_TRAIN, D, K, seed=1, dtype=dtype, device=device)
        l, d, B = N_TRAIN, D, K
        bl = build.BLOCK_L
        nb = -(-l // bl)
        nc = n_cold((l * d + l + 4 * B * l) * item)
        ca, cb = cold_copies(a, nc), cold_copies(b, nc)
        XT = [c["X"].T.contiguous() for c in ca]
        args_a = [[c[k] for k in PASS_A_KEYS] for c in ca]
        args_b = [[c[k] for k in PASS_B_KEYS] for c in cb]
        Xte = torch.tensor(np.random.default_rng(2).normal(size=(N_TEST, D)),
                           dtype=dtype, device=device)
        Xtr = a["X"]
        gam = 1.0 / (2 * D)
        # the Gram kernel writes 537 MB (f64): one set of inputs
        cases = {
            "rbf_row_wss_batched": (
                lambda c: rbf_row_wss.rbf_row_wss_batched(*args_a[c],
                                                          XT=XT[c]),
                lambda c: ref.rbf_row_wss_batched_blocks(*args_a[c],
                                                         block_l=bl),
                None,
                # X, sqn, 4 state rows, query rows, 6 lane vectors + index
                # + flag in; (B, nb) max and int32 arg out
                (l * d + l + 4 * B * l + B * d + 6 * B) * item + 5 * B
                + B * nb * (item + 4),
                2 * B * l * d + 20 * B * l),
            "rbf_update_wss_batched": (
                lambda c: rbf_update_wss.rbf_update_wss_batched(*args_b[c],
                                                                XT=XT[c]),
                lambda c: ref.rbf_update_wss_batched_blocks(*args_b[c],
                                                            block_l=bl),
                None,
                (l * d + l + 4 * B * l + 2 * B * d + 4 * B) * item
                + B * l * item + B * nb * (2 * item + 4),
                4 * B * l * d + 20 * B * l),
            "gram_block": (
                lambda c: gram_block.gram_cross(Xte, Xtr, gam),
                lambda c: ref.gram_cross(Xte, Xtr, gam),
                lambda c: torch.exp(-gam * torch.cdist(Xte, Xtr).square()),
                (N_TEST * D + N_TRAIN * D + N_TEST * N_TRAIN) * item,
                2 * N_TEST * N_TRAIN * D + 6 * N_TEST * N_TRAIN),
        }
        # the product alone (cuBLAS): a yardstick, not the same function
        gemm_ms = timer.ms(lambda: Xte @ Xtr.T, 10)
        for name, (kern, plain, comp, nbytes, nops) in cases.items():
            # reps keep every queued launch inside the card's queue
            reps, preps = (10, 10) if name == "gram_block" else (100, 20)
            kern, plain = cycling(kern, nc), cycling(plain, nc)
            ms_k = timer.ms(kern, reps)
            ms_p = timer.ms(plain, preps)
            ms_k2 = timer.ms(kern, reps)
            ms_p2 = timer.ms(plain, preps)
            comp_ms = (timer.ms(cycling(comp, nc), preps) if comp is not None
                       else None)
            bms, by = bound_ms(nbytes, nops, dtype)
            say(f"[time] {name} {str(dtype)[6:]}: kernel {ms_k:.5f} / "
                f"{ms_k2:.5f} ms, plain {ms_p:.5f} / {ms_p2:.5f} ms, bound "
                f"{bms:.5f} ms by {by} ({nbytes / 1e6:.3f} MB, "
                f"{nops / 1e9:.4f} GFLOP at {HBM_BYTES_PER_S / 1e12} TB/s, "
                f"{PEAK_OPS_PER_S[dtype] / 1e12} TFLOP/s)"
                + ("" if comp_ms is None else
                   f"; composite yardstick exp(-g*cdist^2), three PyTorch "
                   f"calls the port never makes: {comp_ms:.5f} ms; the "
                   f"product alone, cuBLAS X1 @ X2.T: {gemm_ms:.5f} ms"))
            if dtype == torch.float64:
                recs[name] = dict(ms=min(ms_k, ms_k2),
                                  plain_ms=min(ms_p, ms_p2), bound_ms=bms,
                                  bound_by=by)
    return recs


# ---------------------------------------------------------------------------
# phase 6: the (C, gamma) grid at full width
# ---------------------------------------------------------------------------


def read_launches(tally: bool = True) -> dict:
    """The launch counts since the last reset; with ``tally`` also added to
    :data:`MAIN_LAUNCHES` (a run of a main path, not a repeat that only
    checks)."""
    from repro_torch import kernels
    from repro_torch.kernels import gram_block
    counts = kernels.launches()
    if tally:
        MAIN_LAUNCHES.update(counts)
        MAIN_LAUNCHES["gram_symmetric"] += \
            gram_block.gram_cross.symmetric_launches
    return counts


def counted(run, tally: bool = True):
    """``run()`` with the launch counts set to 0 just before and read just
    after (and tallied, see :func:`read_launches`): (result, counts,
    wall s)."""
    from repro_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    r = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return r, read_launches(tally), wall


def predicted(run, label):
    """``run()``, a predict or a score: counted, and it launched the Gram
    kernel and no other kernel."""
    r, counts, _ = counted(run)
    check_only(counts, {"gram_block": counts["gram_block"]}, label)
    assert counts["gram_block"] >= 1, (label, counts)
    return r


def check_only(counts, on, label):
    """Exactly the kernels ``on`` ({name: launches}) ran, as often as
    given."""
    for name, n in counts.items():
        want = on.get(name, 0)
        assert n == want, (label, name, n, want, counts)


def fit_grid(solve, device):
    """``counted(solve)`` for a fit or a grid: (result, counts, wall s,
    loop iterations, peak bytes)."""
    from repro_torch.core.solver_fused import CHECK_EVERY
    torch.cuda.reset_peak_memory_stats(device)
    r, counts, wall = counted(solve)
    t = loop_iterations(r.iterations, CHECK_EVERY, 1_000_000)
    return r, counts, wall, t, torch.cuda.max_memory_allocated(device)


def agree_objectives(prefix, against, tag, got, want):
    """The objectives ``got`` within rtol 1e-6 of ``want``."""
    rel = float(((got - want).abs() / want.abs()).max())
    say(f"{prefix} {tag}: objectives against {against} max rel diff "
        f"{rel:.3e}")
    assert rel <= 1e-6, (tag, rel)


def check_counts(counts, t, bank: bool, label):
    """Each iteration launches one pass A and one pass B of its row source
    and no other kernel; a bank build launches the Gram kernel once per
    gamma."""
    want = {name: t for name in (BANK_PASSES if bank else RBF_PASSES)}
    if bank:
        want["gram_block"] = len(GRID_GAMMA_FACTORS)
    check_only(counts, want, label)


def phase_grid(device, timer):
    from repro_torch.core import grid
    from repro_torch.core import multiclass as mc
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
    runs = {}
    for tag, dtype, precompute in (("bank f64", torch.float64, True),
                                   ("rbf f64", torch.float64, False),
                                   ("bank f32", torch.float32, True)):
        r, counts, wall, t, peak = fit_grid(
            lambda: grid.solve_grid(Xtr, Y, GRID_CS, gammas, cfg,
                                    impl="auto", precompute=precompute,
                                    device=device, dtype=dtype), device)
        say(f"[grid] {tag}: launches {counts}")
        check_counts(counts, t, precompute, tag)
        df, counts, _ = counted(lambda: grid.grid_decision(
            Xte, Xtr, gammas, r.alpha, r.b))
        check_only(counts, {"gram_block": len(gammas)}, f"{tag} decision")
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
    drift, gap = svc_grid_checks(Xtr, Y, gammas, {"bank": rb, "rbf": rr},
                                 device)
    say(f"[grid] f64 |G_carried - (p - K alpha)|_max: bank {drift['bank']:.3e}"
        f", rbf {drift['rbf']:.3e}; KKT gap recomputed from it: bank "
        f"{gap['bank']:.4e}, rbf {gap['rbf']:.4e}")
    assert max(drift.values()) <= 1e-8, drift
    assert max(gap.values()) <= eps, gap
    _, wall, t = runs["bank f64"]
    ms_bank = wall / t * 1e3
    shrink_off = dict(objective=rb.objective, iterations=rb.iterations,
                      ms_iter=ms_bank, loop=t)
    del runs, rb, rr, r32

    recs = grid_kernel_times(device, timer)
    profile_iterations(
        lambda: grid.solve_grid(Xtr, Y, GRID_CS, gammas,
                                SolverConfig(algorithm="pasmo", eps=eps,
                                             max_iter=PROFILE_ITERS),
                                impl="auto", precompute=True, device=device,
                                dtype=torch.float64),
        "grid bank f64 full width", ms_bank)
    shrink_off.update(oneclass=phase_oneclass(Xtr, gammas, device),
                      gammas=gammas)
    return recs, shrink_off


def svc_grid_checks(Xtr, Y, gammas, results, device, Cs=GRID_CS):
    """Per (C, gamma) grid result over ``Cs``: the drift of the carried G
    against p - K alpha with the plain Gram, and the full-set KKT gap
    recomputed from it (maxima over the lanes)."""
    from repro_torch.core import grid
    from repro_torch.core import qp
    Xt = torch.as_tensor(Xtr, dtype=torch.float64, device=device)
    D2 = grid.sqdist(Xt)
    YC = Y[:, None, :] * torch.tensor(Cs, dtype=torch.float64,
                                      device=device)[None, :, None]
    L, U = torch.clamp_max(YC, 0.0), torch.clamp_min(YC, 0.0)
    drift, gap = {}, {}
    for g, gam in enumerate(gammas):
        Kg = torch.exp(-gam * D2)
        for tag, r in results.items():
            G_exact = Y[:, None, :] - r.alpha[g].double() @ Kg
            drift[tag] = max(drift.get(tag, 0.0),
                             float((G_exact - r.G[g]).abs().max()))
            up = torch.where(r.alpha[g] < U, G_exact, -math.inf).amax(-1)
            dn = torch.where(r.alpha[g] > L, G_exact, math.inf).amin(-1)
            gap[tag] = max(gap.get(tag, 0.0),
                           float(qp.finite_gap(up - dn).max()))
        del Kg
    del D2
    return drift, gap


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
        nc = n_cold(5 * B * l * item)
        args_a = [[c[k] for k in BANK_A] for c in cold_copies(ba, nc, l)]
        args_b = [[c[k] for k in BANK_B] for c in cold_copies(bb, nc, l)]
        a, b = kernel_state(l, d, B, seed=1, dtype=dtype, device=device)
        ca, cb = cold_copies(a, nc), cold_copies(b, nc)
        XT = [c["X"].T.contiguous() for c in ca]
        args_ra = [[c[k] for k in PASS_A_KEYS] for c in ca]
        args_rb = [[c[k] for k in PASS_B_KEYS] for c in cb]
        cases = {
            "row_wss_batched_rows": (
                lambda c: rbf_row_wss.row_wss_batched_rows(*args_a[c]),
                lambda c: ref.row_wss_batched_bank(*args_a[c]),
                # B bank rows + 4 state rows, 4 lane vectors, the int32 i,
                # int64 bank index and flag in; (B,) gain and j out
                5 * B * l * item + 4 * B * item + 13 * B + B * (item + 4),
                20 * B * l),
            "update_wss_batched_rows": (
                lambda c: rbf_update_wss.update_wss_batched_rows(*args_b[c]),
                lambda c: ref.update_wss_batched_bank(*args_b[c]),
                # 2 B bank rows + 4 state rows in, G out, mu, i, j, bank
                # index in; (B,) next i, its G and the gap's min out
                7 * B * l * item + B * item + 16 * B
                + B * (2 * item + 4),
                6 * B * l),
            "rbf_row_wss_batched": (
                lambda c: rbf_row_wss.rbf_row_wss_batched(*args_ra[c],
                                                          XT=XT[c]),
                lambda c: ref.rbf_row_wss_batched_blocks(*args_ra[c],
                                                         block_l=bl),
                (l * d + l + 4 * B * l + B * d + 6 * B) * item + 5 * B
                + B * nb * (item + 4),
                2 * B * l * d + 20 * B * l),
            "rbf_update_wss_batched": (
                lambda c: rbf_update_wss.rbf_update_wss_batched(*args_rb[c],
                                                                XT=XT[c]),
                lambda c: ref.rbf_update_wss_batched_blocks(*args_rb[c],
                                                            block_l=bl),
                (l * d + l + 4 * B * l + 2 * B * d + 4 * B) * item
                + B * l * item + B * nb * (2 * item + 4),
                4 * B * l * d + 20 * B * l),
        }
        for name, (kern, plain, nbytes, nops) in cases.items():
            kern, plain = cycling(kern, nc), cycling(plain, nc)
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
        ms_k2 = timer.ms(lambda: ops.gram_bank(X, gammas, impl="cuda"), 3)
        gemm_ms = timer.ms(lambda: X @ X.T, 3)
        # what a symmetric Gram needs, whatever computes it: l (l + 1) / 2
        # products of d and 6 operations an entry; l^2 values written and
        # X read once, for each gamma
        nbytes = 3 * l * l * item + l * d * item
        nops = 3 * (l * (l + 1) * d + 6 * l * l)
        bms, by = bound_ms(nbytes, nops, dtype)
        bms1, by1 = bound_ms(l * l * item + l * d * item,
                             l * (l + 1) * d + 6 * l * l, dtype)
        say(f"[time] bank build 3 x {l}^2 {str(dtype)[6:]}: Gram kernel "
            f"{ms_k:.4f} / {ms_k2:.4f} ms, plain {ms_p:.4f} ms, bound "
            f"{bms:.4f} ms by {by}; one gamma (symmetric): kernel "
            f"{min(ms_k, ms_k2) / 3:.5f} ms, bound {bms1:.5f} ms by {by1}, "
            f"share {bms1 / (min(ms_k, ms_k2) / 3):.4f}; the product alone, "
            f"cuBLAS X @ X.T: {gemm_ms:.5f} ms")
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
    return res


# ---------------------------------------------------------------------------
# phase 7: the single-lane fused solver at full width
# ---------------------------------------------------------------------------


def phase_single(device, timer, lane0):
    """``solve_fused`` on lane 0 of slice 1's data (class 0 against the
    rest) against lane 0 of the batched fit, and the single-lane timing row
    of benchmarks/solver_micro.py at its largest size."""
    from repro_torch.core import qp
    from repro_torch.core.solver import SolverConfig
    from repro_torch.core.solver_fused import CHECK_EVERY, solve_fused
    from repro_torch.kernels import ref
    from repro_torch.svm import data
    X, y = data.multiclass_blobs(N_TRAIN + N_TEST, seed=0, k=K, d=D,
                                 sep=12.0)
    Xtr = X[:N_TRAIN]
    y0 = np.where(y[:N_TRAIN] == np.unique(y)[0], 1.0, -1.0)
    cfg = SolverConfig(algorithm="pasmo", eps=1e-3)
    stats = {}
    r, counts, wall = counted(lambda: solve_fused(
        Xtr, y0, 1.0, lane0["gamma"], cfg, device=device,
        dtype=torch.float64, stats=stats))
    t = loop_iterations(r.iterations, CHECK_EVERY, cfg.max_iter)
    say(f"[single] solve_fused lane 0 f64: l={N_TRAIN} d={D} gamma="
        f"{lane0['gamma']:.6g}; iterations {int(r.iterations)}; loop "
        f"iterations {t}; {wall:.3f} s = {wall / t * 1e3:.4f} ms/iteration; "
        f"launches {counts}; relaunches {stats['relaunches']}, of which "
        f"ran {stats['relaunches_ran']}; converged {bool(r.converged)}")
    assert bool(r.converged), "single-lane fit did not converge"
    check_only(counts, {"rbf_row_wss": 2 * t, "rbf_update_wss": t},
               "single lane")
    assert stats["relaunches"] == t
    # the same fit again: kernels 6 and 7 sum in a fixed order, so it
    # repeats bitwise
    stats2 = {}
    r2, counts2, wall2 = counted(lambda: solve_fused(
        Xtr, y0, 1.0, lane0["gamma"], cfg, device=device,
        dtype=torch.float64, stats=stats2), tally=False)
    for f in ("alpha", "b", "G", "objective", "iterations"):
        if not torch.equal(torch.as_tensor(getattr(r, f)),
                           torch.as_tensor(getattr(r2, f))):
            raise AssertionError(f"solve_fused run twice: {f} differs")
    assert counts2 == counts and stats2 == stats, (counts2, stats2)
    say(f"[single] solve_fused lane 0 run twice: bitwise equal (alpha, b, "
        f"G, objective, iterations), the same launches and relaunches; second "
        f"run {wall2:.3f} s = {wall2 / t * 1e3:.4f} ms/iteration")
    rel = abs(float(r.objective) / lane0["objective"] - 1.0)
    say(f"[single] objective {float(r.objective)!r} vs batched lane 0 "
        f"{lane0['objective']!r}: rel diff {rel:.3e} (batched lane 0 took "
        f"{lane0['iterations']} iterations)")
    assert rel <= 1e-6, rel
    yt = torch.tensor(y0, dtype=torch.float64, device=device)
    Xt = torch.tensor(Xtr, dtype=torch.float64, device=device)
    G_exact = yt - ref.gram_cross(Xt, Xt, lane0["gamma"]) @ r.alpha
    drift = float((G_exact - r.G).abs().max())
    bounds = qp.make_bounds(yt, 1.0)
    gap = float(qp.kkt_gap(G_exact, r.alpha, bounds))
    say(f"[single] |G_carried - (y - K alpha)|_max = {drift:.3e}; KKT gap "
        f"recomputed {gap:.4e}, carried {float(r.kkt_gap):.4e}; feasible "
        f"{bool(qp.is_feasible(r.alpha, bounds))}")
    assert drift <= 1e-8 and gap <= 1e-3
    ms_iter = wall / t * 1e3
    del G_exact, Xt

    # benchmarks/solver_micro.py's fused row at its largest size
    Xm, ym = data.xor_gaussians(MICRO["n"], seed=0)
    cfg_m = SolverConfig(algorithm="pasmo", eps=1e-3,
                         max_iter=MICRO["max_iter"])
    stats_m = {}
    rm, counts_m, wall_m = counted(lambda: solve_fused(
        Xm, ym, MICRO["C"], MICRO["gamma"], cfg_m, device=device,
        dtype=torch.float64, stats=stats_m))
    tm = loop_iterations(rm.iterations, CHECK_EVERY, cfg_m.max_iter)
    say(f"[single] solver_micro fused row (xor l={MICRO['n']} C="
        f"{MICRO['C']} gamma={MICRO['gamma']} max_iter="
        f"{MICRO['max_iter']}) f64: iterations {int(rm.iterations)}, "
        f"converged {bool(rm.converged)}, {wall_m:.3f} s = "
        f"{wall_m / tm * 1e3:.4f} ms/iteration; relaunches ran "
        f"{stats_m['relaunches_ran']} of {stats_m['relaunches']}; KKT gap "
        f"{float(rm.kkt_gap):.4e}")
    check_only(counts_m, {"rbf_row_wss": 2 * tm, "rbf_update_wss": tm},
               "solver_micro row")
    # kernel 6's launches over one lane-0 fit and the solver_micro row (the
    # repeat above only checks): one unconditional and one relaunch a
    # planning iteration; a relaunch with a false flag returns at once
    k6 = counts["rbf_row_wss"] + counts_m["rbf_row_wss"]
    ran = t + stats["relaunches_ran"] + tm + stats_m["relaunches_ran"]
    say(f"[single] kernel 6 in this phase: {k6} launches, of which {ran} "
        f"ran ({t + tm} unconditional, "
        f"{stats['relaunches_ran'] + stats_m['relaunches_ran']} relaunches "
        f"with a true flag) and {k6 - ran} were no-op relaunches")
    profile_iterations(
        lambda: solve_fused(Xtr, y0, 1.0, lane0["gamma"],
                            SolverConfig(algorithm="pasmo", eps=1e-3,
                                         max_iter=PROFILE_ITERS),
                            device=device, dtype=torch.float64),
        "solve_fused f64 full width", ms_iter)


def single_inputs(l, dtype, device):
    """Kernels 6 and 7's inputs at (l, D) in copies that together hold four
    L2s, and the per-copy calls: {"n": copies, name: (kernel(c),
    plain(c)), "X", "xq": per-copy tensors}; kernel 6 stores its row into
    the row that kernel 7 reads."""
    from repro_torch.kernels import build, rbf_row_wss, rbf_update_wss, ref
    item = torch.tensor([], dtype=dtype).element_size()
    n = n_cold((l * D + 5 * l) * item)
    cs = cold_copies(single_state(l, D, 1, dtype, device), n)
    a = [[c[k] for k in SINGLE_A] for c in cs]
    k_row = [torch.empty_like(c["G"]) for c in cs]
    XT = [c["X"].T.contiguous() for c in cs]
    b = [[c["X"], c["sqn"], c["G_b"], k, c["alpha"], c["L"], c["U"],
          c["xq_j"], c["sqq_j"], c["mu"], c["gamma"]]
         for c, k in zip(cs, k_row)]
    bl = build.BLOCK_L
    return {
        "n": n, "X": [c["X"] for c in cs], "xq": [c["xq"] for c in cs],
        "rbf_row_wss": (
            lambda c, run=None: rbf_row_wss.rbf_row_wss(
                *a[c], XT=XT[c], k_out=k_row[c], run=run),
            lambda c: ref.rbf_row_wss_blocks(*a[c], block_l=bl)),
        "rbf_update_wss": (
            lambda c: rbf_update_wss.rbf_update_wss(*b[c], XT=XT[c]),
            lambda c: ref.rbf_update_wss_blocks(*b[c], block_l=bl)),
    }


def slice3_kernel_times(device, timer):
    """Kernels 6 and 7 at l = 16384 (one lane) and the H = 2 variants of
    kernels 1 and 2 at the e-SVR grid's B = 18: device time, plain
    version's time and bound.  Beside kernels 6 and 7, the time of
    ``X @ xq`` (cuBLAS GEMV: the same bytes of X, less work) on the same
    cycled inputs.  What a launch of kernel 6 or 7 costs beside
    its bytes: kernel 6 with a false relaunch flag (every block returns at
    once), and both at 4 l, where three l's worth more bytes give the rate
    at which the kernel streams them."""
    from repro_torch.kernels import build, rbf_row_wss, rbf_update_wss, ref
    recs = {}
    l, d, bl = N_TRAIN, D, build.BLOCK_L
    nb = -(-l // bl)
    for dtype in (torch.float64, torch.float32):
        dt = str(dtype)[6:]
        item = torch.tensor([], dtype=dtype).element_size()
        one = single_inputs(l, dtype, device)
        n1 = one["n"]
        B, n = SVR_B, 2 * l
        a, b = dup_state(l, d, SVR_B, 1, dtype, device)
        n2 = n_cold((l * d + 4 * B * n) * item)
        ca, cb = cold_copies(a, n2), cold_copies(b, n2)
        XT2 = [c["X"].T.contiguous() for c in ca]
        args_a = [[c[k] for k in PASS_A_KEYS] for c in ca]
        args_b = [[c[k] for k in PASS_B_KEYS] for c in cb]
        cases = {
            "rbf_row_wss": (
                *one["rbf_row_wss"], n1,
                # X, sqn, 4 state vectors, query, 7 scalars in; the row,
                # (nb,) max and arg out
                (l * d + 5 * l + d + 6) * item + 5 + l * item
                + nb * (item + 4),
                2 * l * d + 25 * l),
            "rbf_update_wss": (
                *one["rbf_update_wss"], n1,
                # X, sqn, G, k_i, alpha, L, U, query, 3 scalars in; G and
                # (nb,) max, arg and min out
                (l * d + 6 * l + d + 3) * item + l * item
                + nb * (2 * item + 4),
                2 * l * d + 12 * l),
            "rbf_row_wss_batched_h2": (
                lambda c: rbf_row_wss.rbf_row_wss_batched_h2(*args_a[c],
                                                             XT=XT2[c]),
                lambda c: ref.rbf_row_wss_batched_blocks(*args_a[c],
                                                         block_l=bl,
                                                         dup=True),
                n2,
                (l * d + l + 4 * B * n + B * d + 6 * B) * item + 5 * B
                + B * nb * (item + 4),
                2 * B * l * d + 20 * B * n),
            "rbf_update_wss_batched_h2": (
                lambda c: rbf_update_wss.rbf_update_wss_batched_h2(
                    *args_b[c], XT=XT2[c]),
                lambda c: ref.rbf_update_wss_batched_blocks(*args_b[c],
                                                            block_l=bl,
                                                            dup=True),
                n2,
                (l * d + l + 4 * B * n + 2 * B * d + 4 * B) * item
                + B * n * item + B * nb * (2 * item + 4),
                4 * B * l * d + 12 * B * n),
        }
        gemv = cycling(lambda c: torch.mv(one["X"][c], one["xq"][c]), n1)
        ms_g = min(timer.ms(gemv, 100), timer.ms(gemv, 100))
        say(f"[time] X @ xq (cuBLAS GEMV) {dt}: {ms_g:.5f} ms, X read at "
            f"{l * d * item / ms_g / 1e6:.1f} GB/s")
        ms_one = {}
        for name, (kern, plain, nc, nbytes, nops) in cases.items():
            kern, plain = cycling(kern, nc), cycling(plain, nc)
            ms_k = timer.ms(kern, 100)
            ms_p = timer.ms(plain, 20)
            ms_k2 = timer.ms(kern, 100)
            ms_p2 = timer.ms(plain, 20)
            bms, by = bound_ms(nbytes, nops, dtype)
            ms_one[name] = (min(ms_k, ms_k2), nbytes)
            say(f"[time] {name} {dt}: kernel {ms_k:.5f} / {ms_k2:.5f} ms, "
                f"plain {ms_p:.5f} / {ms_p2:.5f} ms, bound {bms:.5f} ms by "
                f"{by} ({nbytes / 1e6:.3f} MB, {nops / 1e9:.4f} GFLOP; "
                f"{nbytes / min(ms_k, ms_k2) / 1e6:.1f} GB/s)")
            if dtype == torch.float64:
                recs[name] = dict(ms=min(ms_k, ms_k2),
                                  plain_ms=min(ms_p, ms_p2), bound_ms=bms,
                                  bound_by=by)
        no = torch.zeros((1,), dtype=torch.bool, device=device)
        noop = one["rbf_row_wss"][0]
        ms_no = timer.ms(cycling(lambda c: noop(c, run=no), n1), 100)
        say(f"[time] rbf_row_wss {dt}: no-op relaunch (false flag) "
            f"{ms_no:.5f} ms")
        del one, a, b, ca, cb, args_a, args_b, XT2
        four = single_inputs(4 * l, dtype, device)
        for name in SINGLE_PASSES:
            ms4 = timer.ms(cycling(four[name][0], four["n"]), 100)
            ms1, nbytes = ms_one[name]
            rate = 3 * nbytes / (ms4 - ms1)        # bytes a ms
            say(f"[time] {name} {dt}: {ms4:.5f} ms at l = {4 * l}; so X "
                f"streams at {rate / 1e6:.1f} GB/s and a launch costs "
                f"{ms1 - nbytes / rate:.5f} ms beside its bytes")
        del noop, four
    return recs


# ---------------------------------------------------------------------------
# phase 8: e-SVR and one-class at full width
# ---------------------------------------------------------------------------


def svr_checks(X, P, L, U, alpha, G, gamma):
    """Gradient drift against p - Q alpha of the doubled operator, the KKT
    gap recomputed from it, and sum(alpha); (drift, gap, |sum|) maxima over
    the (m, 2l) lanes that share ``gamma``."""
    from repro_torch.core import qp
    from repro_torch.kernels import ref
    Kg = ref.gram_cross(X, X, gamma)
    Qa = qp.svr_fold(alpha) @ Kg
    del Kg
    G_exact = P - torch.cat([Qa, Qa], dim=-1)
    drift = float((G_exact - G).abs().max())
    up = torch.where(alpha < U, G_exact, -math.inf).amax(-1)
    dn = torch.where(alpha > L, G_exact, math.inf).amin(-1)
    gap = float(qp.finite_gap(up - dn).max())
    asum = float(alpha.sum(-1).abs().max())
    return drift, gap, asum


def fit_svr(Xtr, ytr, Xte, yte, dtype, device, eps):
    """SVR(C=10, epsilon=0.1, gamma="scale") at full width, launches
    counted: (estimator, ms an iteration)."""
    from repro_torch.core.solver_fused import CHECK_EVERY
    from repro_torch.svm import SVR
    tag = str(dtype)[6:]
    reg = SVR(C=10.0, epsilon=0.1, gamma="scale", eps=eps, device=device,
              dtype=dtype)
    _, counts, wall = counted(lambda: reg.fit(Xtr, ytr))
    r = reg.fit_result_
    t = loop_iterations(r.iterations, CHECK_EVERY, reg.max_iter)
    check_only(counts, {n: t for n in H2_PASSES}, f"SVR {tag}")
    r2 = predicted(lambda: reg.score(Xte, yte), f"SVR {tag} score")
    say(f"[svr] SVR {tag}: l={N_TRAIN} (2l={2 * N_TRAIN} variables) d={D} "
        f"gamma={reg.gamma_:.6g}; iterations {int(r.iterations)}; "
        f"{wall:.3f} s = {wall / t * 1e3:.4f} ms/iteration; launches "
        f"{counts}; SVs {reg.n_support_}; held-out R^2 "
        f"{r2:.4f}; converged {bool(r.converged)}, KKT gap "
        f"{float(r.kkt_gap):.4e}")
    assert bool(r.converged), f"SVR {tag} did not converge"
    return reg, wall / t * 1e3


def phase_svr(device):
    """SVR(C=10, epsilon=0.1, gamma="scale") at full width, the C = 1 half
    of the e-SVR grid and OneClassSVM(nu=0.1), on slice 1's X (f64), then
    the SVR in f32 against the f64 fit."""
    from repro_torch.core import grid
    from repro_torch.core import qp
    from repro_torch.core.solver import SolverConfig
    from repro_torch.core.solver_fused import CHECK_EVERY
    from repro_torch.svm import SVR, OneClassSVM, data
    X, _ = data.multiclass_blobs(N_TRAIN + N_TEST, seed=0, k=K, d=D,
                                 sep=12.0)
    yv = sinc_target(X, 7)
    Xtr, ytr, Xte, yte = X[:N_TRAIN], yv[:N_TRAIN], X[N_TRAIN:], yv[N_TRAIN:]
    Xt = torch.tensor(Xtr, dtype=torch.float64, device=device)
    eps = 1e-3
    reg, ms_iter = fit_svr(Xtr, ytr, Xte, yte, torch.float64, device, eps)
    r = reg.fit_result_
    svr_ref = dict(objective=r.objective, iterations=r.iterations.reshape(1),
                   loop=loop_iterations(r.iterations, CHECK_EVERY,
                                        reg.max_iter), ms_iter=ms_iter)
    q = qp.svr_qp(torch.tensor(ytr, dtype=torch.float64, device=device),
                  10.0, 0.1)
    drift, gap, asum = svr_checks(Xt, q.p, q.bounds.lower, q.bounds.upper,
                                  r.alpha, r.G, reg.gamma_)
    say(f"[svr] SVR f64: |G_carried - (p - Q alpha)|_max = {drift:.3e}; KKT "
        f"gap recomputed {gap:.4e}; |sum alpha| {asum:.3e}")
    assert drift <= 1e-8 and gap <= eps and asum <= 1e-8, (drift, gap, asum)
    profile_iterations(
        lambda: SVR(C=10.0, epsilon=0.1, gamma="scale",
                    max_iter=PROFILE_ITERS, device=device,
                    dtype=torch.float64).fit(Xtr, ytr),
        "SVR f64 full width", ms_iter)

    gammas = [reg.gamma_ * f for f in SVR_GAMMA_FACTORS]
    cfg = SolverConfig(algorithm="pasmo", eps=eps)
    grids = {}
    for src, precompute, on in (("rbf", None, H2_PASSES),
                                ("bank", True, H2_BANK_PASSES)):
        rg, counts, wall, t, peak = fit_grid(
            lambda: grid.solve_grid_svr(Xtr, ytr, SVR_GRID_CS, SVR_EPSILONS,
                                        gammas, cfg, precompute=precompute,
                                        device=device, dtype=torch.float64),
            device)
        want = {n: t for n in on}
        if precompute:
            want["gram_block"] = len(SVR_GAMMA_FACTORS)
        check_only(counts, want, f"e-SVR grid {src}")
        say(f"[svr] e-SVR grid {src} f64: lanes "
            f"{tuple(rg.alpha.shape[:3])} of 2l={2 * N_TRAIN}; "
            f"gammas {[f'{g:.6g}' for g in gammas]}, epsilons "
            f"{list(SVR_EPSILONS)}, Cs {list(SVR_GRID_CS)}; iterations per lane "
            f"{rg.iterations.flatten().tolist()}; loop iterations {t}; "
            f"{wall:.3f} s = {wall / t * 1e3:.4f} ms/iteration; peak device "
            f"memory {peak / 1e9:.3f} GB; launches {counts}; converged "
            f"{int(rg.converged.sum())}/{rg.converged.numel()}; max KKT gap "
            f"{float(rg.kkt_gap.max()):.4e}")
        assert bool(rg.converged.all()), f"an e-SVR grid lane ({src}) did " \
                                         f"not converge"
        worst = svr_grid_checks(Xt, ytr, gammas, rg, device)
        df, counts, _ = counted(lambda: grid.grid_decision(
            Xte, Xtr, gammas, qp.svr_fold(rg.alpha), rg.b))
        check_only(counts, {"gram_block": len(gammas)},
                   f"e-SVR grid {src} decision")
        r2s = 1.0 - ((torch.tensor(yte, device=device) - df) ** 2).sum(
            -1) / float(((yte - yte.mean()) ** 2).sum())
        say(f"[svr] e-SVR grid {src}: |G_carried - (p - Q alpha)|_max = "
            f"{worst[0]:.3e}; KKT gap recomputed {worst[1]:.4e}; |sum alpha| "
            f"{worst[2]:.3e}; held-out R^2 by (gamma, epsilon, C) "
            f"{[round(v, 4) for v in r2s.flatten().tolist()]}")
        assert worst[0] <= 1e-8 and worst[1] <= eps and worst[2] <= 1e-8, \
            worst
        grids[src] = dict(objective=rg.objective, ms_iter=wall / t * 1e3,
                          loop=t, iterations=rg.iterations, gammas=gammas)
        del rg, df
    rel = float(((grids["bank"]["objective"] - grids["rbf"]["objective"])
                 .abs() / grids["rbf"]["objective"].abs()).max())
    say(f"[svr] e-SVR grid objectives bank vs rbf max rel diff {rel:.3e}")
    assert rel <= 1e-6, rel
    prof = SolverConfig(algorithm="pasmo", eps=eps, max_iter=PROFILE_ITERS)
    for src, precompute in (("rbf", None), ("bank", True)):
        profile_iterations(
            lambda: grid.solve_grid_svr(Xtr, ytr, SVR_GRID_CS, SVR_EPSILONS,
                                        gammas, prof, precompute=precompute,
                                        device=device, dtype=torch.float64),
            f"e-SVR grid {src} f64 full width", grids[src]["ms_iter"])

    oc = OneClassSVM(nu=0.1, gamma="scale", eps=eps, device=device,
                     dtype=torch.float64)
    _, counts, wall = counted(lambda: oc.fit(Xtr))
    r = oc.fit_result_
    t = loop_iterations(r.iterations, CHECK_EVERY, oc.max_iter)
    check_only(counts, {n: t for n in RBF_PASSES}, "OneClassSVM")
    out_frac = float((predicted(lambda: oc.predict(Xtr),
                                "OneClassSVM predict") < 0).mean())
    say(f"[svr] OneClassSVM(nu=0.1) f64: l={N_TRAIN}; iterations "
        f"{int(r.iterations)}; {wall:.3f} s = {wall / t * 1e3:.4f} "
        f"ms/iteration; launches {counts}; training outlier fraction "
        f"{out_frac:.4f}; SV fraction {oc.n_support_ / N_TRAIN:.4f}; "
        f"converged {bool(r.converged)}, KKT gap {float(r.kkt_gap):.4e}; "
        f"sum alpha - 1 = {float(r.alpha.sum()) - 1:.3e}")
    assert bool(r.converged) and float(r.kkt_gap) <= eps
    svr_ref["oneclass"] = r.objective

    r32, _ = fit_svr(Xtr, ytr, Xte, yte, torch.float32, device, eps)
    p32 = predicted(lambda: r32.predict(Xte), "SVR f32 predict")
    p64 = predicted(lambda: reg.predict(Xte), "SVR f64 predict")
    diff = float((p32.double() - p64).abs().max())
    rel = abs(float(r32.fit_result_.objective)
              / float(reg.fit_result_.objective) - 1.0)
    say(f"[svr] SVR f32 against f64: held-out predictions max diff "
        f"{diff:.3e}, objective rel diff {rel:.3e}")
    return grids["bank"], svr_ref


def svr_grid_checks(Xt, ytr, gammas, rg, device):
    """Drift, recomputed gap and |sum alpha| (maxima) of an e-SVR grid
    result on ``svr_checks``."""
    from repro_torch.core import qp
    yt = torch.tensor(ytr, dtype=torch.float64, device=device)
    P = torch.stack([qp.svr_qp(yt, 1.0, e).p for e in SVR_EPSILONS])
    Lg = torch.stack([qp.svr_qp(yt, c, 0.0).bounds.lower
                      for c in SVR_GRID_CS])
    Ug = torch.stack([qp.svr_qp(yt, c, 0.0).bounds.upper
                      for c in SVR_GRID_CS])
    worst = [0.0, 0.0, 0.0]
    for g, gam in enumerate(gammas):
        res = svr_checks(Xt, P[:, None, :], Lg[None], Ug[None], rg.alpha[g],
                         rg.G[g], gam)
        worst = [max(w, v) for w, v in zip(worst, res)]
    return worst


# ---------------------------------------------------------------------------
# phase 9: shrinking at full width
# ---------------------------------------------------------------------------


class FusedProbe:
    """Keeps the last :class:`FusedResult` that ``solve_fused_batched_qp``
    returned to the grid drivers (``solve_grid`` hands back a
    ``SolveResult``, which has no unshrink counts), while installed."""

    def __enter__(self):
        from repro_torch.core import solver_fused
        self.orig = solver_fused.solve_fused_batched_qp

        def spy(*args, **kw):
            self.result = self.orig(*args, **kw)
            return self.result

        solver_fused.solve_fused_batched_qp = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.core import solver_fused
        solver_fused.solve_fused_batched_qp = self.orig


class ChunkProbe:
    """Watches ``solve_fused_chunked_qp`` while installed: each round's
    lane bucket and kept rows (the padded coordinates are those with ``L
    = U = 0``), from its chunk solves, and the host's wall time inside
    each of the driver's ``chunked.*`` spans (``split``), from a span
    recorder (``telemetry.recording``) around the run.  The recorder adds
    no synchronization: work a span queues on the card without waiting for
    it (the slice's copies, the rebuild's matvec) is waited for, and
    counted, in the next span that reads a result back.  ``solves``:
    (round key, host seconds) of each chunk solve, which ends on the
    loop's last read of the card."""

    def __enter__(self):
        from repro_torch import telemetry
        from repro_torch.core import solver_fused
        self.mod = solver_fused
        self.orig = solver_fused.solve_fused_batched_qp
        self.rows, self.lanes, self.solves = [], [], []
        self.diag = telemetry.Diagnostics(ring=None)
        self.recording = telemetry.recording(self.diag)
        self.recording.__enter__()

        def spy(X, P, L, U, *args, **kw):
            self.lanes.append(P.shape[0])
            self.rows.append(((L != 0) | (U != 0)).any(0).sum())
            gram = kw.get("gram")
            t0 = time.perf_counter()
            out = self.orig(X, P, L, U, *args, **kw)
            self.solves.append(((tuple(P.shape), None if gram is None
                                 else gram.data_ptr()),
                                time.perf_counter() - t0))
            return out

        solver_fused.solve_fused_batched_qp = spy
        return self

    def __exit__(self, *exc):
        self.recording.__exit__(*exc)
        self.mod.solve_fused_batched_qp = self.orig

    @property
    def split(self) -> dict:
        """{span: host seconds} of the driver's ``chunked.*`` spans."""
        rows = self.diag.spans.summary()["spans"]
        return {k: v["host_ms"] / 1e3 for k, v in rows.items()
                if k.startswith("chunked.")}

    def split_text(self, wall: float) -> str:
        return ", ".join(f"{k.removeprefix('chunked.')} {v:.3f} s "
                         f"({v / wall:.4f})"
                         for k, v in sorted(self.split.items()))


def round_split(solves) -> tuple:
    """The median host seconds of the chunk solves that opened a cache
    entry (its first round: eager chunks and captures) and of those that
    replayed one, from (round key, seconds) pairs, with their counts."""
    seen, first, later = set(), [], []
    for key, sec in solves:
        (later if key in seen else first).append(sec)
        seen.add(key)
    med = [float(np.median(v)) * 1e3 if v else float("nan")
           for v in (first, later)]
    return med[0], len(first), med[1], len(later)


def median_ms(solves) -> float:
    return float(np.median([sec for _, sec in solves])) * 1e3


def split_text(solves) -> str:
    f_ms, n_f, r_ms, n_r = round_split(solves)
    return (f"solve of an entry's first round {f_ms:.3f} ms (median of "
            f"{n_f}), of a replayed round {r_ms:.3f} ms (median of {n_r})")


def replayed_round_window(run, label, ms_round):
    """A ``torch.profiler`` window over one round of ``run()``, a chunked
    call, that replays its cache entry's graphs: the first round whose
    lanes, rows and row source an earlier round of the call had.  Prints
    the round's device kernels an iteration and the device's busy share of
    ``ms_round``, the unprofiled solve of a replayed round."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import solver_fused
    orig = solver_fused.solve_fused_batched_qp
    seen, out = set(), {}

    def spy(X, P, *args, **kw):
        gram = kw.get("gram")
        key = (tuple(P.shape), None if gram is None else gram.data_ptr())
        if key not in seen or out:
            seen.add(key)
            return orig(X, P, *args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = orig(X, P, *args, **kw)
            torch.cuda.synchronize()
        out.update(prof=prof, wall=time.perf_counter() - t0,
                   lanes=P.shape[0], iters=loop_iterations(
                       res.iterations, solver_fused.CHECK_EVERY,
                       args[3].max_iter))
        return res

    solver_fused.solve_fused_batched_qp = spy
    try:
        run()
    finally:
        solver_fused.solve_fused_batched_qp = orig
    assert out, f"{label}: no round replayed an entry"
    kern, once = device_events(out["prof"])
    n = out["iters"]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    say(f"[profile] {label}, a replayed round ({out['lanes']} lanes, {n} "
        f"iterations): {sum(e.count for e in kern) / n:.1f} device kernels "
        f"an iteration, kernels busy {dev_ms:.4f} ms in the round = "
        f"{dev_ms / ms_round:.4f} of a replayed round's unprofiled solve, "
        f"{ms_round:.3f} ms (idle share {1 - dev_ms / ms_round:.4f}); "
        f"copies and sets "
        f"{sum(e.self_device_time_total for e in once) / 1e3:.4f} ms; "
        f"profiled wall {out['wall'] * 1e3:.3f} ms")


def active_share(G, alpha, L, U):
    """The share of coordinates the shrink rule keeps at the final state."""
    from repro_torch.core import qp
    return float(qp.shrink_mask(G, alpha, L, U).double().mean())


def phase_shrink(device, timer, grid_off, svr_off):
    """Slice 4 at full width: the 90-lane (C, gamma) grid of phase 6 with
    soft shrinking through the bank and through the rbf passes, the
    compacted grid (hard shrinking, chunk = 96, the C = 0.5 lanes) through
    the bank, and the e-SVR grid of phase 8 through the bank with soft
    shrinking; objectives against phases 6 and 8's shrink-off results (not
    rerun).  The compacted grid runs with the chunked driver's graph
    cache and again without it (bitwise equal), and a profiler window
    spans one round that replays its cache entry's graphs."""
    from repro_torch.analysis.capture_guard import CaptureLog
    from repro_torch.core import grid
    from repro_torch.core import multiclass as mc
    from repro_torch.core.solver import SolverConfig
    from repro_torch.svm import data
    X, y = data.multiclass_blobs(N_TRAIN + N_TEST, seed=0, k=K, d=D,
                                 sep=12.0)
    Xtr, ytr = X[:N_TRAIN], y[:N_TRAIN]
    gamma_scale = 1.0 / (D * float(Xtr.var()))
    gammas = [gamma_scale * f for f in GRID_GAMMA_FACTORS]
    eps = 1e-3
    cfg = SolverConfig(algorithm="pasmo", eps=eps)
    Y = mc.ovr_labels(mc.class_index(ytr)[1], K, torch.float64, device)
    YC = Y[None, :, None, :] * torch.tensor(
        GRID_CS, dtype=torch.float64, device=device)[None, None, :, None]
    L, U = torch.clamp_max(YC, 0.0), torch.clamp_min(YC, 0.0)
    recs = {}
    objectives_agree = functools.partial(agree_objectives, "[shrink]",
                                         "the shrink-off run")

    results = {}
    for src, precompute, on in (("bank", True, BANK_ACT),
                                ("rbf", False, RBF_ACT)):
        with FusedProbe() as probe:
            r, counts, wall, t, peak = fit_grid(
                lambda: grid.solve_grid(Xtr, Y, GRID_CS, gammas, cfg,
                                        impl="auto", precompute=precompute,
                                        shrinking=True, device=device,
                                        dtype=torch.float64), device)
        want = {n: t for n in on}
        if precompute:
            want["gram_block"] = len(GRID_GAMMA_FACTORS)
        check_only(counts, want, f"grid shrinking {src}")
        n_un = probe.result.n_unshrink
        share = active_share(r.G, r.alpha, L, U)
        ms = wall / t * 1e3
        say(f"[shrink] grid {src} f64 shrinking=True: lanes "
            f"{tuple(r.alpha.shape[:3])}; iterations per lane min "
            f"{int(r.iterations.min())} median "
            f"{int(r.iterations.flatten().median())} max "
            f"{int(r.iterations.max())} (shrink off: max "
            f"{int(grid_off['iterations'].max())}); loop iterations {t} "
            f"(shrink off {grid_off['loop']}); {wall:.3f} s = {ms:.4f} "
            f"ms/iteration (shrink off {grid_off['ms_iter']:.4f}); "
            f"n_unshrink total {int(n_un.sum())}, max {int(n_un.max())}, "
            f"lanes with one {int((n_un > 0).sum())}; final active share "
            f"{share:.4f}; peak device memory {peak / 1e9:.3f} GB; "
            f"launches {counts}; converged "
            f"{int(r.converged.sum())}/{r.converged.numel()}; max KKT gap "
            f"{float(r.kkt_gap.max()):.4e}")
        assert bool(r.converged.all()), f"grid shrinking {src}"
        objectives_agree(f"grid {src}", r.objective, grid_off["objective"])
        results[src] = r
        recs[f"grid {src}"] = (ms, t)
    drift, gap = svc_grid_checks(Xtr, Y, gammas, results, device)
    say(f"[shrink] grid f64 shrinking |G_carried - (p - K alpha)|_max "
        f"{drift}; full-set KKT gap recomputed {gap}")
    assert max(drift.values()) <= 1e-8 and max(gap.values()) <= eps
    del results, r
    prof = SolverConfig(algorithm="pasmo", eps=eps,
                        max_iter=2 * PROFILE_ITERS)
    profile_iterations(
        lambda: grid.solve_grid(Xtr, Y, GRID_CS, gammas, prof, impl="auto",
                                precompute=True, shrinking=True,
                                device=device, dtype=torch.float64),
        "grid bank f64 shrinking=True (one mask refresh inside)",
        recs["grid bank"][0], 2 * PROFILE_ITERS)

    # the compacted grid: hard row and lane compaction between chunks,
    # its rounds replaying the graphs of the driver's cache
    def compacted(c=cfg):
        return grid.solve_grid_compacted(
            Xtr, Y, COMPACT_CS, gammas, c, chunk=96, impl="auto",
            precompute=True, shrinking=True, device=device,
            dtype=torch.float64)

    with ChunkProbe() as rounds, CaptureLog() as log:
        r, counts, wall, _, peak = fit_grid(compacted, device)
    check_only(counts, {BANK_ACT[0]: counts[BANK_ACT[0]],
                        BANK_ACT[1]: counts[BANK_ACT[0]],
                        "gram_block": len(GRID_GAMMA_FACTORS)},
               "compacted grid")
    assert counts[BANK_ACT[0]] > 0
    n_rounds, rows = len(rounds.rows), [int(m) for m in rounds.rows]
    off = {k: grid_off[k][:, :, :len(COMPACT_CS)]
           for k in ("objective", "iterations")}
    say(f"[shrink] compacted grid bank f64 (Cs {list(COMPACT_CS)}, "
        f"chunk=96, shrinking=True): "
        f"rounds {n_rounds}; kept rows per round mean {np.mean(rows):.1f}, "
        f"min {min(rows)}, last {rows[-1]}; lane bucket per round mean "
        f"{np.mean(rounds.lanes):.2f}; iterations per lane max "
        f"{int(r.iterations.max())}, sum {int(r.iterations.sum())} "
        f"(shrink-off grid: sum {int(off['iterations'].sum())}); "
        f"{wall:.3f} s = {wall / n_rounds * 1e3:.3f} ms/round; host wall "
        f"in the driver's ranges (share of the run): "
        f"{rounds.split_text(wall)}; peak device memory "
        f"{peak / 1e9:.3f} GB; "
        f"launches {counts}; converged {int(r.converged.sum())}/"
        f"{r.converged.numel()}; max KKT gap "
        f"{float(r.kkt_gap.max()):.4e}")
    # the same grid without the cache, every round capturing anew (a
    # comparison: its launches are not tallied)
    torch.cuda.reset_peak_memory_stats(device)
    with ChunkProbe() as rounds_u, uncached(), CaptureLog() as log_u:
        r_u, _, wall_u = counted(compacted, tally=False)
    peak_u = torch.cuda.max_memory_allocated(device)
    same_result(r, r_u, "compacted grid, cached against uncached")
    assert len(rounds_u.rows) == n_rounds
    del r_u
    say(f"[shrink] compacted grid graph cache: bitwise equal to the "
        f"uncached driver; {wall / n_rounds * 1e3:.3f} ms/round cached, "
        f"{wall_u / n_rounds * 1e3:.3f} uncached ({wall:.3f} s against "
        f"{wall_u:.3f} s); chunked.solve's share of the run "
        f"{rounds.split.get('chunked.solve', 0.0) / wall:.4f} cached, "
        f"{rounds_u.split.get('chunked.solve', 0.0) / wall_u:.4f} "
        f"uncached; {split_text(rounds.solves)}, uncached every round "
        f"{median_ms(rounds_u.solves):.3f} ms (median); peak device "
        f"memory {peak / 1e9:.3f} GB cached, {peak_u / 1e9:.3f} GB "
        f"uncached; {cache_text(log, log_u)}")
    replayed_round_window(
        lambda: compacted(dataclasses.replace(cfg, max_iter=5 * 96)),
        "compacted grid bank f64 shrinking=True",
        round_split(rounds.solves)[2])
    assert bool(r.converged.all()), "compacted grid"
    objectives_agree("compacted grid", r.objective, off["objective"])
    drift, gap = svc_grid_checks(Xtr, Y, gammas, {"compacted": r}, device,
                                 COMPACT_CS)
    say(f"[shrink] compacted grid |G - (p - K alpha)|_max "
        f"{drift['compacted']:.3e}; full-set KKT gap recomputed "
        f"{gap['compacted']:.4e}")
    assert drift["compacted"] <= 1e-8 and gap["compacted"] <= eps
    del r

    # the e-SVR grid of phase 8 through the bank, soft shrinking: the
    # H = 2 + act bank passes end to end
    from repro_torch.core import qp
    yv = sinc_target(X, 7)[:N_TRAIN]
    sgammas = svr_off["gammas"]
    rg, counts, wall, t, peak = fit_grid(
        lambda: grid.solve_grid_svr(Xtr, yv, SVR_GRID_CS, SVR_EPSILONS,
                                    sgammas, cfg, precompute=True,
                                    shrinking=True,
                                    device=device, dtype=torch.float64),
        device)
    check_only(counts, {BANK_ACT[0]: t, BANK_ACT[1]: t,
                        "gram_block": len(SVR_GAMMA_FACTORS)},
               "e-SVR grid shrinking")
    yt = torch.tensor(yv, dtype=torch.float64, device=device)
    P = torch.stack([qp.svr_qp(yt, 1.0, e).p for e in SVR_EPSILONS])
    Lg = torch.stack([qp.svr_qp(yt, c, 0.0).bounds.lower
                      for c in SVR_GRID_CS])
    Ug = torch.stack([qp.svr_qp(yt, c, 0.0).bounds.upper
                      for c in SVR_GRID_CS])
    share = active_share(rg.G, rg.alpha, Lg[None, None], Ug[None, None])
    ms = wall / t * 1e3
    say(f"[shrink] e-SVR grid bank f64 shrinking=True: lanes "
        f"{tuple(rg.alpha.shape[:3])} of 2l={2 * N_TRAIN}; iterations per "
        f"lane {rg.iterations.flatten().tolist()} (shrink off: "
        f"{svr_off['iterations'].flatten().tolist()}); loop iterations {t} "
        f"(shrink off {svr_off['loop']}); {wall:.3f} s = {ms:.4f} "
        f"ms/iteration (shrink off {svr_off['ms_iter']:.4f}); "
        f"n_unshrink {rg.n_unshrink.flatten().tolist()}; final active share "
        f"{share:.4f}; peak device memory {peak / 1e9:.3f} GB; launches "
        f"{counts}; converged {int(rg.converged.sum())}/"
        f"{rg.converged.numel()}; max KKT gap {float(rg.kkt_gap.max()):.4e}")
    assert bool(rg.converged.all()), "e-SVR grid shrinking"
    objectives_agree("e-SVR grid", rg.objective, svr_off["objective"])
    Xt = torch.as_tensor(Xtr, dtype=torch.float64, device=device)
    worst = svr_grid_checks(Xt, yv, sgammas, rg, device)
    say(f"[shrink] e-SVR grid shrinking: |G_carried - (p - Q alpha)|_max = "
        f"{worst[0]:.3e}; full-set KKT gap recomputed {worst[1]:.4e}; "
        f"|sum alpha| {worst[2]:.3e}")
    assert worst[0] <= 1e-8 and worst[1] <= eps and worst[2] <= 1e-8, worst
    del rg
    profile_iterations(
        lambda: grid.solve_grid_svr(Xtr, yv, SVR_GRID_CS, SVR_EPSILONS,
                                    sgammas, prof, precompute=True,
                                    shrinking=True,
                                    device=device, dtype=torch.float64),
        "e-SVR grid bank f64 shrinking=True (one mask refresh inside)", ms,
        2 * PROFILE_ITERS)


# ---------------------------------------------------------------------------
# phase 10: the conjugate step at full width
# ---------------------------------------------------------------------------

CONJ_PASSES = ("rbf_update_wss_batched_conj", "update_wss_batched_rows_conj")


def phase_conj(device, timer, svc_ref, grid_off, svr_ref):
    """Slice 5 at full width, f64, ``algorithm="smo", step="conjugate"``:
    phase 5's 10-lane SVC, phase 6's 90-lane grid through the bank, with
    shrinking through the bank and through the rbf passes, phase 8's SVR
    and one of its e-SVR grid's lanes through the bank with shrinking.
    Each run: the exact launches of its conjugate pass B variant (and of
    no other pass B), accepted conjugate steps on some lane, every lane
    converged, G within 1e-8 of p - Q alpha, the full-set gap at most eps,
    and the objectives within rtol 1e-6 of the same problems' PA-SMO
    results of phases 5, 6 and 8 (reused, not rerun).  Returns the
    launches per conjugate variant, keyed (source, H, act, B), and the
    conjugate SVC's iterations and accepted steps per lane."""
    from repro_torch.core import grid
    from repro_torch.core import multiclass as mc
    from repro_torch.core import qp
    from repro_torch.core.solver import SolverConfig
    from repro_torch.kernels import ref
    from repro_torch.svm import SVC, SVR, data
    X, y = data.multiclass_blobs(N_TRAIN + N_TEST, seed=0, k=K, d=D,
                                 sep=12.0)
    Xtr, ytr, Xte = X[:N_TRAIN], y[:N_TRAIN], X[N_TRAIN:]
    eps = 1e-3
    cfg = SolverConfig(algorithm="smo", step="conjugate", eps=eps)
    f64 = dict(device=device, dtype=torch.float64)
    variants = {}

    def run(tag, key, fit, on, pasmo):
        """``fit()`` counted: exactly ``on`` ({name: launches}, None for
        the loop iterations) ran."""
        r, counts, wall, t, peak = fit_grid(fit, device)
        want = {n: (t if c is None else c) for n, c in on.items()}
        check_only(counts, want, f"conjugate {tag}")
        variants[key] = variants.get(key, 0) + t
        iters, acc = r.iterations.flatten(), r.n_planning.flatten()
        say(f"[conj] {tag}: iterations per lane max {int(iters.max())} "
            f"median {int(iters.median())}; accepted conjugate steps per "
            f"lane max {int(acc.max())} median {int(acc.median())}, share "
            f"{float(acc.sum()) / float(iters.sum()):.4f}; loop iterations "
            f"{t} (PA-SMO: {pasmo['loop']}, max lane "
            f"{int(pasmo['iterations'].max())}); {wall:.3f} s = "
            f"{wall / t * 1e3:.4f} ms/iteration (PA-SMO "
            f"{pasmo['ms_iter']:.4f}); peak device memory "
            f"{peak / 1e9:.3f} GB; launches {counts}")
        assert bool(r.converged.all()), f"conjugate {tag}"
        assert float(r.kkt_gap.max()) <= eps, tag
        assert int(acc.max()) > 0, f"conjugate {tag}: no accepted step"
        return r, wall / t * 1e3

    objectives_agree = functools.partial(agree_objectives, "[conj]",
                                         "PA-SMO's")

    # 1. phase 5's SVC: kernel 2's conjugate variant, H = 1, B = 10
    clf = SVC(C=1.0, gamma="scale", algorithm="smo", step="conjugate",
              eps=eps, **f64)
    r, _ = run("SVC 10 lanes (rbf, H=1)", ("rbf", 1, False, K),
               lambda: clf.fit(Xtr, ytr).fit_result_,
               {"rbf_row_wss_batched": None, CONJ_PASSES[0]: None},
               svc_ref)
    df = predicted(lambda: clf.decision_function(Xte), "predict")
    pred = clf.classes_[torch.argmax(df, dim=-1).cpu().numpy()]
    agree = float(np.mean(pred == svc_ref["pred"]))
    objectives_agree("SVC", r.objective, svc_ref["objective"])
    Y = mc.ovr_labels(mc.class_index(ytr)[1], K, torch.float64, device)
    Xt = clf.X_
    Kfull = ref.gram_cross(Xt, Xt, clf.gamma_)
    G_exact = Y - r.alpha @ Kfull
    del Kfull
    drift = float((G_exact - r.G).abs().max())
    gap = max(float(qp.kkt_gap(G_exact[b], r.alpha[b],
                               qp.make_bounds(Y[b], 1.0))) for b in range(K))
    say(f"[conj] SVC: held-out predictions equal to PA-SMO's "
        f"{agree:.4f}; |G_carried - (p - K alpha)|_max = {drift:.3e}; KKT "
        f"gap recomputed {gap:.4e}")
    assert agree >= 0.99 and drift <= 1e-8 and gap <= eps, (agree, drift,
                                                            gap)
    conj_svc = dict(iterations=r.iterations, n_planning=r.n_planning)
    del G_exact, r, clf

    # 2-4. phase 6's grid: bank (kernel 5, H = 1), bank with shrinking
    # (kernel 5 + act), rbf with shrinking (kernel 2 + act)
    gammas = [1.0 / (D * float(Xtr.var())) * f for f in GRID_GAMMA_FACTORS]
    results = {}
    for tag, key, pre, shrinking, on in (
            ("bank", ("bank", 1, False, GRID_B), True, False,
             {"row_wss_batched_rows": None, CONJ_PASSES[1]: None}),
            ("bank shrinking", ("bank", 1, True, GRID_B), True, True,
             {"row_wss_batched_rows_act": None, CONJ_PASSES[1]: None}),
            ("rbf shrinking", ("rbf", 1, True, GRID_B), False, True,
             {"rbf_row_wss_batched_act": None, CONJ_PASSES[0]: None})):
        if pre:
            on["gram_block"] = len(GRID_GAMMA_FACTORS)
        r, ms = run(f"grid {tag} 90 lanes", key, lambda: grid.solve_grid(
            Xtr, Y, GRID_CS, gammas, cfg, impl="auto", precompute=pre,
            shrinking=shrinking, **f64), on, grid_off)
        objectives_agree(f"grid {tag}", r.objective, grid_off["objective"])
        results[tag] = r
        if tag == "bank":
            ms_bank = ms
    drift, gap = svc_grid_checks(Xtr, Y, gammas, results, device)
    say(f"[conj] grid |G_carried - (p - K alpha)|_max {drift}; full-set KKT "
        f"gap recomputed {gap}")
    assert max(drift.values()) <= 1e-8 and max(gap.values()) <= eps
    del results, r
    profile_iterations(
        lambda: grid.solve_grid(Xtr, Y, GRID_CS, gammas,
                                SolverConfig(algorithm="smo",
                                             step="conjugate", eps=eps,
                                             max_iter=PROFILE_ITERS),
                                impl="auto", precompute=True, **f64),
        "grid bank f64 conjugate", ms_bank)

    # 5. phase 8's SVR: kernel 2's conjugate variant, H = 2
    yv = sinc_target(X, 7)[:N_TRAIN]
    reg = SVR(C=10.0, epsilon=0.1, gamma="scale", algorithm="smo",
              step="conjugate", eps=eps, **f64)
    r, _ = run("SVR 1 lane of 2l (rbf, H=2)", ("rbf", 2, False, 1),
               lambda: reg.fit(Xtr, yv).fit_result_,
               {"rbf_row_wss_batched_h2": None, CONJ_PASSES[0]: None},
               svr_ref)
    objectives_agree("SVR", r.objective.reshape(1),
                     svr_ref["objective"].reshape(1))
    q = qp.svr_qp(torch.tensor(yv, **f64), 10.0, 0.1)
    drift, gap, asum = svr_checks(reg.X_, q.p, q.bounds.lower,
                                  q.bounds.upper, r.alpha, r.G, reg.gamma_)
    say(f"[conj] SVR: |G_carried - (p - Q alpha)|_max = {drift:.3e}; KKT "
        f"gap recomputed {gap:.4e}; |sum alpha| {asum:.3e}")
    assert drift <= 1e-8 and gap <= eps and asum <= 1e-8, (drift, gap, asum)

    # 6. the same e-SVR problem as one lane of the e-SVR grid through the
    # bank with shrinking: kernel 5's conjugate variant, H = 2 + act
    r, _ = run("e-SVR grid lane (bank, H=2, shrinking)", ("bank", 2, True, 1),
               lambda: grid.solve_grid_svr(
                   Xtr, yv, [10.0], [0.1], [reg.gamma_], cfg, precompute=True,
                   shrinking=True, **f64),
               {"row_wss_batched_rows_act": None, CONJ_PASSES[1]: None,
                "gram_block": 1}, svr_ref)
    objectives_agree("e-SVR grid lane", r.objective.reshape(1),
                     svr_ref["objective"].reshape(1))
    drift, gap, asum = svr_checks(reg.X_, q.p, q.bounds.lower,
                                  q.bounds.upper, r.alpha.reshape(1, -1),
                                  r.G.reshape(1, -1), reg.gamma_)
    say(f"[conj] e-SVR grid lane: |G_carried - (p - Q alpha)|_max = "
        f"{drift:.3e}; KKT gap recomputed {gap:.4e}; |sum alpha| "
        f"{asum:.3e}; n_unshrink {r.n_unshrink.flatten().tolist()}")
    assert drift <= 1e-8 and gap <= eps and asum <= 1e-8, (drift, gap, asum)
    return variants, conj_svc


def conj_kernel_times(device, timer):
    """The eight conjugate variants of kernels 2 and 5, f64, at the shapes
    phase 10 launches them (the two it does not launch, kernel 2's H = 2
    with the mask and kernel 5's H = 2 without, at the e-SVR grid's
    B = 18): device time of the variant, of the same kernel without the
    direction and of the plain version, each cycling through copies of its
    inputs (:func:`cold_copies`), beside the bound.  The direction adds
    B l values read (dirv) and B l written (r) to the variant without it.
    Returns {(source, H, act, B): record}."""
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import rbf_update_wss as pb
    dtype = torch.float64
    item = 8
    l, d, bl = N_TRAIN, D, build.BLOCK_L
    nb = -(-l // bl)
    recs = {}
    for src, H, masked, B in (("rbf", 1, False, K), ("rbf", 1, True, GRID_B),
                              ("rbf", 2, False, 1), ("rbf", 2, True, SVR_B),
                              ("bank", 1, False, GRID_B),
                              ("bank", 1, True, GRID_B),
                              ("bank", 2, True, 1),
                              ("bank", 2, False, SVR_B)):
        dup = H == 2
        n = H * l
        if src == "rbf":
            _, b = (dup_state if dup else kernel_state)(l, d, B, 1, dtype,
                                                        device)
            keys, fn_c = PASS_B_KEYS, pb.rbf_update_wss_batched_conj
            fn_p = lambda *x, **kw: ref.rbf_update_wss_batched_blocks(
                *x, block_l=bl, **kw)
            base_bytes = ((l * d + l + 4 * B * n + 2 * B * d + 4 * B) * item
                          + B * n * item + B * nb * (2 * item + 4))
            nops = 4 * B * l * d + 12 * B * n
        else:
            b = bank_state(l, B, 3 if B > 1 else 1, 1, dtype, device,
                           dup=dup)[1]
            keys, fn_c = BANK_B, pb.update_wss_batched_rows_conj
            fn_p = ref.update_wss_batched_bank
            # (B,) next i, its G and the gap's min out
            base_bytes = ((2 * B * l + 5 * B * n + B) * item + 16 * B
                          + B * (2 * item + 4))
            nops = 6 * B * n
        if masked:
            base_bytes += B * n
        dirv, mu2 = conj_inputs(b, l, B, 1, device)
        nbytes = base_bytes + 2 * B * l * item + B * item
        nc = n_cold(nbytes)
        copies = cold_copies(dict(b, dirv=dirv, mu2=mu2), nc,
                             n if src == "bank" else None)
        acts = [act_mask(B, n, (5, l - 3), c, device) if masked else None
                for c in range(nc)]
        args = [[c[k] for k in keys] for c in copies]
        base = [c["dirv"] for c in copies]
        mu2s = [c["mu2"] for c in copies]
        # the rbf passes take X transposed, made once per copy as the row
        # source makes it once per fit
        xt = [dict(XT=c["X"].T.contiguous()) if src == "rbf" else {}
              for c in copies]
        kern = lambda c: fn_c(*args[c], base[c], mu2s[c], dup=dup,
                              act=acts[c], **xt[c])
        plain = lambda c: fn_p(*args[c], dup=dup, act=acts[c], dirv=base[c],
                               mu2=mu2s[c])
        if masked:
            nodir = (lambda c: (pb.rbf_update_wss_batched_act if src == "rbf"
                                else pb.update_wss_batched_rows_act)(
                *args[c], acts[c], dup=dup, **xt[c]))
        elif src == "rbf":
            nodir = (lambda c: (pb.rbf_update_wss_batched_h2 if dup
                                else pb.rbf_update_wss_batched)(*args[c],
                                                                **xt[c]))
        else:
            nodir = (lambda c: (pb.update_wss_batched_rows_h2 if dup
                                else pb.update_wss_batched_rows)(*args[c]))
        t = {}
        for rnd in range(2):
            for k, fn, reps in (("ms", kern, 100), ("nodir_ms", nodir, 100),
                                ("plain_ms", plain, 10)):
                v = timer.ms(cycling(fn, nc), reps)
                t[k] = v if rnd == 0 else min(t[k], v)
        bms, by = bound_ms(nbytes, nops + 2 * B * n, dtype)
        nodir_bms = bound_ms(base_bytes, nops, dtype)[0]
        # beside the B = 1 variant, whose bytes take less than a launch: a
        # launch that does nothing (PyTorch's spin kernel for 0 cycles)
        noop = ""
        if B == 1:
            noop_ms = timer.ms(lambda: torch.cuda._sleep(0), 100)
            noop = f"; a no-op launch {noop_ms:.5f} ms"
        say(f"[time] conjugate pass B {src} H={H}{' act' if masked else ''} "
            f"B={B} f64: kernel {t['ms']:.5f} ms, without the direction "
            f"{t['nodir_ms']:.5f} ms (bound {nodir_bms:.5f}), plain "
            f"{t['plain_ms']:.5f} ms, bound {bms:.5f} ms by {by} "
            f"({nbytes / 1e6:.3f} MB; cycling through {nc} copies){noop}")
        recs[(src, H, masked, B)] = dict(ms=t["ms"], plain_ms=t["plain_ms"],
                                         bound_ms=bms, bound_by=by)
        del b, copies, args, base, mu2s, acts, xt
    return recs


def cold_copies(state: dict, n: int, index_mod: int | None = None):
    """``n`` copies of the tensors in ``state``: launches that cycle
    through enough of them (:func:`n_cold`) read every input from HBM, as
    the bound assumes, and not from the L2 where launching back to back on
    one set of tensors would leave them.  A Gram bank (``gram``) is shared
    (it is too large to copy, and only a lane's rows are read): with
    ``index_mod`` the row indices ``i_idx``/``j_idx`` move by an odd step
    per copy, so each copy reads other bank rows."""
    out = []
    for c in range(n):
        cp = {}
        for k, v in state.items():
            if k == "gram":
                cp[k] = v
            elif index_mod and k in ("i_idx", "j_idx"):
                cp[k] = ((v.long() + 7919 * c) % index_mod).to(v.dtype)
            else:
                cp[k] = v.clone()
        out.append(cp)
    return out


def n_cold(n_bytes: float) -> int:
    """Copies of a ``n_bytes`` working set that together hold four L2s."""
    return max(2, -(-4 * L2_BYTES // int(n_bytes)))


def cycling(fn, n: int):
    """One call that runs ``fn(c)`` for c = 0, 1, ..., n - 1, 0, ... in
    turn."""
    it = itertools.cycle(range(n))
    return lambda: fn(next(it))


def slice4_kernel_times(device, timer):
    """The act variants of kernels 1, 2, 4 and 5 at the (C, gamma) grid's
    B = 90 (one state half, a 3-entry bank), the H = 2 bank passes and the
    act bank passes at the e-SVR grid's B = 18 over 2l: device time, plain
    version's time and bound.  The mask adds B n bytes read.  Each timed
    call cycles through copies of its inputs (:func:`cold_copies`): at B =
    18 a set of inputs fits in L2."""
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import rbf_row_wss as pa
    from repro_torch.kernels import rbf_update_wss as pb
    recs = {}
    l, d, bl = N_TRAIN, D, build.BLOCK_L
    nb = -(-l // bl)
    for dtype in (torch.float64, torch.float32):
        item = torch.tensor([], dtype=dtype).element_size()
        for B, dup in ((GRID_B, False), (SVR_B, True)):
            n = 2 * l if dup else l
            lo, hi = (l - 3, l + 5) if dup else (5, l - 3)
            ba, bb = bank_state(l, B, 3, 1, dtype, device, dup=dup)
            # bank A: B rows of l, 4 state rows, 4 lane vectors, i, bank
            # index, flag in; (B,) gain and j out.  Bank B: 2 B rows, 4
            # state rows in, G out, mu, i, j, bank index in; (B,) next i,
            # its G and the gap's min out.  The mask adds B n bytes to
            # each.
            bytes_a = ((B * l + 4 * B * n + 4 * B) * item + 13 * B
                       + B * (item + 4))
            bytes_b = ((2 * B * l + 5 * B * n + B) * item + 16 * B
                       + B * (2 * item + 4))
            nc = n_cold(bytes_a)
            A = [[c[k] for k in BANK_A] for c in cold_copies(ba, nc, n)]
            Bk = [[c[k] for k in BANK_B] for c in cold_copies(bb, nc, n)]
            act = act_mask(B, n, (lo, hi), 1, device)
            acts = [act.clone() for _ in range(nc)]
            cases = {
                "row_wss_batched_rows_act": (
                    lambda c: pa.row_wss_batched_rows_act(*A[c], acts[c],
                                                          dup=dup),
                    lambda c: ref.row_wss_batched_bank(*A[c], dup=dup,
                                                       act=acts[c]),
                    bytes_a + B * n, 20 * B * n),
                "update_wss_batched_rows_act": (
                    lambda c: pb.update_wss_batched_rows_act(*Bk[c], acts[c],
                                                             dup=dup),
                    lambda c: ref.update_wss_batched_bank(*Bk[c], dup=dup,
                                                          act=acts[c]),
                    bytes_b + B * n, 6 * B * n),
            }
            if dup:
                cases["row_wss_batched_rows_h2"] = (
                    lambda c: pa.row_wss_batched_rows_h2(*A[c]),
                    lambda c: ref.row_wss_batched_bank(*A[c], dup=True),
                    bytes_a, 20 * B * n)
                cases["update_wss_batched_rows_h2"] = (
                    lambda c: pb.update_wss_batched_rows_h2(*Bk[c]),
                    lambda c: ref.update_wss_batched_bank(*Bk[c], dup=True),
                    bytes_b, 6 * B * n)
            else:
                a, b = kernel_state(l, d, B, 1, dtype, device)
                ca, cb = cold_copies(a, nc), cold_copies(b, nc)
                XT = [c["X"].T.contiguous() for c in ca]
                ra = [[c[k] for k in PASS_A_KEYS] for c in ca]
                rb = [[c[k] for k in PASS_B_KEYS] for c in cb]
                cases["rbf_row_wss_batched_act"] = (
                    lambda c: pa.rbf_row_wss_batched_act(*ra[c], acts[c],
                                                         XT=XT[c]),
                    lambda c: ref.rbf_row_wss_batched_blocks(
                        *ra[c], block_l=bl, act=acts[c]),
                    (l * d + l + 4 * B * l + B * d + 6 * B) * item + 5 * B
                    + B * nb * (item + 4) + B * l,
                    2 * B * l * d + 20 * B * l)
                cases["rbf_update_wss_batched_act"] = (
                    lambda c: pb.rbf_update_wss_batched_act(*rb[c], acts[c],
                                                            XT=XT[c]),
                    lambda c: ref.rbf_update_wss_batched_blocks(
                        *rb[c], block_l=bl, act=acts[c]),
                    (l * d + l + 4 * B * l + 2 * B * d + 4 * B) * item
                    + B * l * item + B * nb * (2 * item + 4) + B * l,
                    4 * B * l * d + 20 * B * l)
            for name, (kern, plain, nbytes, nops) in cases.items():
                ms_k = timer.ms(cycling(kern, nc), 100)
                ms_p = timer.ms(cycling(plain, nc), 10)
                ms_k2 = timer.ms(cycling(kern, nc), 100)
                ms_p2 = timer.ms(cycling(plain, nc), 10)
                bms, by = bound_ms(nbytes, nops, dtype)
                say(f"[time] {name} B={B} H={2 if dup else 1} "
                    f"{str(dtype)[6:]}: kernel {ms_k:.5f} / {ms_k2:.5f} ms, "
                    f"plain {ms_p:.5f} / {ms_p2:.5f} ms, bound {bms:.5f} ms "
                    f"by {by} ({nbytes / 1e6:.3f} MB, {nops / 1e9:.4f} "
                    f"GFLOP; cycling through {nc} copies of the inputs, "
                    f"{nc * nbytes / 1e6:.0f} MB)")
                # the JSON record: the bank act passes at the e-SVR grid's
                # H = 2 (B = 18), the rbf act passes at the grid's B = 90
                main = (name in H2_BANK_PASSES or name in RBF_ACT
                        or (name in BANK_ACT and dup))
                if dtype == torch.float64 and main:
                    recs[name] = dict(ms=min(ms_k, ms_k2),
                                      plain_ms=min(ms_p, ms_p2),
                                      bound_ms=bms, bound_by=by)
            del ba, bb, A, Bk, acts, cases
    return recs


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 11: the classic engine at full width
# ---------------------------------------------------------------------------

# benchmarks/fig3_stepsizes.py's buckets of a planning step's mu/mu* - 1
FIG3_BUCKETS = ((-math.inf, -1.0, "reversed"), (-1.0, -0.1, "shrunk"),
                (-0.1, 0.1, "near-newton"), (0.1, 1.0, "overshoot<2x"),
                (1.0, 10.0, "overshoot<11x"), (10.0, math.inf,
                                               "overshoot>11x"))
# The paper's variants of (c): algorithm, planning candidates, selection
# and step; each runs on the one-vs-rest problem of (a).
CLASSIC_VARIANTS = (("smo", dict(algorithm="smo")),
                    ("pasmo_simple", dict(algorithm="pasmo_simple")),
                    ("overshoot", dict(algorithm="overshoot")),
                    ("pasmo N=3", dict(algorithm="pasmo",
                                       plan_candidates=3)),
                    ("wss=mvp", dict(algorithm="pasmo", wss="mvp")),
                    ("smo conjugate", dict(algorithm="smo",
                                           step="conjugate")))
CLASSIC_COUNTERS = ("n_planning", "n_free", "n_clipped", "n_reverted")


class LaneProbe:
    """Records the lane count of every classic loop
    (``repro_torch.core.grid.solve_lanes``) while installed: one entry a
    C of the classic grid, one a chunk (round) of the compacted one; and
    the host's wall time inside them (``solve_s``: a loop returns after
    its last check has read the card)."""

    def __enter__(self):
        from repro_torch.core import grid
        self.orig, self.lanes, self.solve_s = grid.solve_lanes, [], 0.0

        self.solves = []

        def spy(kernel, p, *args, **kw):
            self.lanes.append(p.shape[0])
            t0 = time.perf_counter()
            out = self.orig(kernel, p, *args, **kw)
            self.solves.append((tuple(p.shape), time.perf_counter() - t0))
            self.solve_s += self.solves[-1][1]
            return out

        grid.solve_lanes = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.core import grid
        grid.solve_lanes = self.orig


def classic_loop(iterations) -> int:
    """Iterations the classic host loop runs over lanes with these counts
    (it stops at the first check after the last lane converged)."""
    from repro_torch.core.solver import CHECK_EVERY
    return loop_iterations(iterations, CHECK_EVERY, 1_000_000)


def counters_text(r) -> str:
    return "; ".join(f"{f} {getattr(r, f).flatten().tolist()}"
                     for f in CLASSIC_COUNTERS)


def phase_classic(device, svc_ref, grid_off, svr_ref):
    """Slice 9 at full width: the classic engine (``engine="batched"``,
    ``impl=None``) on phase 5's 10-lane SVC (Gram kernel in symmetric mode,
    f64 and f32; and rows recomputed from X), the paper's variants, the
    Fig. 3 recorder, phase 6's grid and the compacted grid, phase 8's SVR
    and one-class problems and ``train_svm`` on lane 0's binary problem.
    Every lane converged with its full-set gap at most eps, G within 1e-8
    of p - Q alpha, objectives within rtol 1e-6 of the fused results of
    phases 5, 6 and 8 (reused, not rerun) or of (a).  The compacted grid
    without shrinking runs again without the chunked driver's graph cache
    (bitwise equal)."""
    from repro_torch.analysis.capture_guard import CaptureLog
    from repro_torch.core import grid
    from repro_torch.core import multiclass as mc
    from repro_torch.core import qp
    from repro_torch.core.solver import SolverConfig
    from repro_torch.kernels import gram_block, ops, ref
    from repro_torch.svm import SVC, SVR, OneClassSVM, data, model
    t0 = time.perf_counter()
    X, y = data.multiclass_blobs(N_TRAIN + N_TEST, seed=0, k=K, d=D,
                                 sep=12.0)
    Xtr, ytr, Xte = X[:N_TRAIN], y[:N_TRAIN], X[N_TRAIN:]
    eps = 1e-3
    f64 = dict(device=device, dtype=torch.float64)
    Y = mc.ovr_labels(mc.class_index(ytr)[1], K, torch.float64, device)
    objectives_agree = functools.partial(agree_objectives, "[classic]")

    def fit(tag, run, on):
        """``run()`` counted: exactly the kernels ``on`` ran; a fit's Gram
        is a symmetric launch.  (result, wall s)."""
        r, counts, wall = counted(run)
        check_only(counts, on, tag)
        assert gram_block.gram_cross.symmetric_launches == on.get(
            "gram_block", 0), tag
        return r, wall

    def converged(tag, r):
        assert bool(r.converged.all()), f"classic {tag}: not converged"
        assert float(r.kkt_gap.max()) <= eps, tag

    def exact_g(r, gamma):
        """Drift of the carried G against p - K alpha and the full-set
        gap recomputed from it (maxima over the lanes)."""
        Kfull = ref.gram_cross(Xt, Xt, gamma)
        G_exact = Y - r.alpha.double() @ Kfull
        del Kfull
        gap = max(float(qp.kkt_gap(G_exact[b], r.alpha[b].double(),
                                   qp.make_bounds(Y[b], 1.0)))
                  for b in range(K))
        return float((G_exact - r.G.double()).abs().max()), gap

    # (a) the main path: 10 one-vs-rest lanes on the Gram (kernel 3)
    clf = SVC(C=1.0, gamma="scale", algorithm="pasmo", eps=eps,
              engine="batched", **f64)
    r, wall = fit("SVC f64", lambda: clf.fit(Xtr, ytr).fit_result_,
                  {"gram_block": 1})
    converged("SVC f64", r)
    t = classic_loop(r.iterations)
    ms_iter = wall / t * 1e3
    Xt = clf.X_
    drift, gap = exact_g(r, clf.gamma_)
    df = predicted(lambda: clf.decision_function(Xte), "classic predict")
    pred = clf.classes_[torch.argmax(df, dim=-1).cpu().numpy()]
    agree = float(np.mean(pred == svc_ref["pred"]))
    say(f"[classic] SVC f64 engine={clf.engine_} (Gram kernel 3, "
        f"symmetric): iterations per lane {r.iterations.tolist()}; loop "
        f"iterations {t} (fused: {svc_ref['loop']}); fit {wall:.3f} s = "
        f"{ms_iter:.4f} ms/iteration (fused {svc_ref['ms_iter']:.4f}); "
        f"{counters_text(r)}; |G_carried - (p - K alpha)|_max = "
        f"{drift:.3e}; KKT gap recomputed {gap:.4e}; held-out predictions "
        f"equal to the fused fit's {agree:.4f}")
    objectives_agree("the fused fit's", "SVC f64", r.objective,
                     svc_ref["objective"])
    assert drift <= 1e-8 and gap <= eps and agree >= 0.99, (drift, gap,
                                                            agree)
    ref_a = dict(objective=r.objective, pred=pred, iterations=r.iterations,
                 lane0=float(r.objective[0]), gamma=clf.gamma_,
                 df0=df[:, 0])
    profile_iterations(
        lambda: SVC(C=1.0, gamma="scale", algorithm="pasmo", eps=eps,
                    engine="batched", max_iter=PROFILE_ITERS,
                    **f64).fit(Xtr, ytr),
        "classic SVC f64 full width", ms_iter)
    c32 = SVC(C=1.0, gamma="scale", algorithm="pasmo", eps=eps,
              engine="batched", device=device, dtype=torch.float32)
    r32, wall = fit("SVC f32", lambda: c32.fit(Xtr, ytr).fit_result_,
                    {"gram_block": 1})
    converged("SVC f32", r32)
    df32 = predicted(lambda: c32.decision_function(Xte), "classic f32")
    p32 = c32.classes_[torch.argmax(df32, dim=-1).cpu().numpy()]
    agree = float(np.mean(p32 == pred))
    say(f"[classic] SVC f32: iterations per lane {r32.iterations.tolist()}; "
        f"{wall:.3f} s = {wall / classic_loop(r32.iterations) * 1e3:.4f} "
        f"ms/iteration; held-out predictions equal to f64's {agree:.4f}")
    assert agree >= 0.99, agree
    del clf, c32, r32, df, df32

    # (b) rows recomputed from X (X[i] @ X.T): no kernel of the port
    clf = SVC(C=1.0, gamma="scale", algorithm="pasmo", eps=eps,
              engine="batched", precompute=False, **f64)
    r, wall = fit("SVC rows", lambda: clf.fit(Xtr, ytr).fit_result_, {})
    converged("SVC rows", r)
    say(f"[classic] SVC f64 rows from X: iterations per lane "
        f"{r.iterations.tolist()}; {wall:.3f} s = "
        f"{wall / classic_loop(r.iterations) * 1e3:.4f} ms/iteration")
    objectives_agree("(a)", "SVC rows", r.objective, ref_a["objective"])
    del clf, r

    # (c) the paper's variants (Table 2 style), on the problem of (a)
    for tag, kw in CLASSIC_VARIANTS:
        cfg = SolverConfig(eps=eps, **kw)
        if "wss" in kw:                     # no facade knob: solve_ovr
            def run():
                Kg = ops.gram(Xt, gamma=ref_a["gamma"], device=device)
                return mc.solve_ovr(qp.PrecomputedKernel(Kg), Y, 1.0, cfg,
                                    device=device)
        else:
            def run():
                return SVC(C=1.0, gamma="scale", eps=eps, engine="batched",
                           **kw, **f64).fit(Xtr, ytr).fit_result_
        r, wall = fit(tag, run, {"gram_block": 1})
        converged(tag, r)
        say(f"[classic] Table 2 {tag}: iterations max "
            f"{int(r.iterations.max())} sum {int(r.iterations.sum())} "
            f"(pasmo: max {int(ref_a['iterations'].max())} sum "
            f"{int(ref_a['iterations'].sum())}); counters summed over the "
            f"lanes " + ", ".join(f"{f} {int(getattr(r, f).sum())}"
                        for f in CLASSIC_COUNTERS)
            + f"; wall {wall:.3f} s")
        objectives_agree("(a)", tag, r.objective, ref_a["objective"])
        del r

    # (d) Fig. 3: the recorder of planning-step ratios on (a)'s fit
    cfg = SolverConfig(algorithm="pasmo", eps=eps, record_trace=True)

    def run():
        Kg = ops.gram(Xt, gamma=ref_a["gamma"], device=device)
        return mc.solve_ovr(qp.PrecomputedKernel(Kg), Y, 1.0, cfg,
                            device=device)

    r, wall = fit("Fig. 3", run, {"gram_block": 1})
    converged("Fig. 3", r)
    kept = torch.clamp_max(r.n_trace, cfg.trace_cap)
    assert torch.equal(r.n_trace, r.n_planning), (r.n_trace, r.n_planning)
    assert torch.equal(r.iterations, ref_a["iterations"]), \
        "the recorder changed the path"
    ratios = torch.cat([r.trace[b, :int(kept[b])] for b in range(K)]) - 1.0
    buckets = {label: int(((ratios > lo) & (ratios <= hi)).sum())
               for lo, hi, label in FIG3_BUCKETS}
    over = sum(n for label, n in buckets.items()
               if label.startswith("overshoot"))
    say(f"[classic] Fig. 3 on the card: planning steps per lane "
        f"{r.n_planning.tolist()} (recorded {kept.tolist()}); mu/mu* - 1 "
        f"summed over the lanes: {buckets}; share overshooting "
        f"{over / max(len(ratios), 1):.4f}; "
        f"{wall:.3f} s")
    assert sum(buckets.values()) == len(ratios)
    del r, ratios

    # (e) the classic grid over phase 6's lanes, then the compacted grid
    gammas = [1.0 / (D * float(Xtr.var())) * f for f in GRID_GAMMA_FACTORS]
    cfg = SolverConfig(algorithm="pasmo", eps=eps)
    torch.cuda.reset_peak_memory_stats(device)
    with LaneProbe() as loops:
        r, wall = fit("grid", lambda: grid.solve_grid(
            Xtr, Y, GRID_CS, gammas, cfg, **f64),
            {"gram_block": len(gammas)})
    peak = torch.cuda.max_memory_allocated(device)
    converged("grid", r)
    t = sum(classic_loop(r.iterations[:, :, ci])
            for ci in range(len(GRID_CS)))
    drift, gap = svc_grid_checks(Xtr, Y, gammas, {"classic": r}, device)
    say(f"[classic] grid impl=None f64 (warm-started C chain, "
        f"{len(loops.lanes)} loops of {loops.lanes} lanes): iterations per "
        f"C (max over lanes) "
        f"{[int(r.iterations[:, :, c].max()) for c in range(len(GRID_CS))]}"
        f"; loop iterations {t} (fused, cold: {grid_off['loop']}); "
        f"{wall:.3f} s = {wall / t * 1e3:.4f} ms/iteration (fused "
        f"{grid_off['ms_iter']:.4f}); counters summed "
        + ", ".join(f"{f} {int(getattr(r, f).sum())}"
                    for f in CLASSIC_COUNTERS)
        + f"; |G_carried - (p - K alpha)|_max {drift['classic']:.3e}; KKT "
        f"gap recomputed {gap['classic']:.4e}; peak device memory "
        f"{peak / 1e9:.3f} GB")
    objectives_agree("the fused grid's", "grid", r.objective,
                     grid_off["objective"])
    assert drift["classic"] <= 1e-8 and gap["classic"] <= eps
    del r
    off = grid_off["objective"][:, :, :len(COMPACT_CS)]
    for shrinking in (False, True):
        tag = f"compacted grid shrinking={shrinking}"

        def compacted():
            return grid.solve_grid_compacted(
                Xtr, Y, COMPACT_CS, gammas, cfg, chunk=96,
                shrinking=shrinking, **f64)
        torch.cuda.reset_peak_memory_stats(device)
        with LaneProbe() as rounds, CaptureLog() as log:
            r, wall = fit(tag, compacted, {"gram_block": len(gammas)})
        peak = torch.cuda.max_memory_allocated(device)
        converged(tag, r)
        n = len(rounds.lanes)
        drift, gap = svc_grid_checks(Xtr, Y, gammas, {"c": r}, device,
                                     COMPACT_CS)
        say(f"[classic] {tag} impl=None f64 (Cs {list(COMPACT_CS)}, "
            f"chunk=96): rounds {n}; lane bucket per round {rounds.lanes}; "
            f"iterations per lane max {int(r.iterations.max())} sum "
            f"{int(r.iterations.sum())}; {wall:.3f} s = "
            f"{wall / n * 1e3:.3f} ms/round; counters summed "
            + ", ".join(f"{f} {int(getattr(r, f).sum())}"
                        for f in CLASSIC_COUNTERS)
            + f"; |G - (p - K alpha)|_max {drift['c']:.3e}; KKT gap "
            f"recomputed {gap['c']:.4e}; peak device memory "
            f"{peak / 1e9:.3f} GB; the loops' share of the run "
            f"{rounds.solve_s / wall:.4f}; {cache_text(log)}")
        objectives_agree("the fused grid's", tag, r.objective, off)
        assert drift["c"] <= 1e-8 and gap["c"] <= eps
        if not shrinking:
            # the same grid without the cache (a comparison: its
            # launches are not tallied)
            torch.cuda.reset_peak_memory_stats(device)
            with LaneProbe() as rounds_u, uncached(), \
                    CaptureLog() as log_u:
                r_u, _, wall_u = counted(compacted, tally=False)
            peak_u = torch.cuda.max_memory_allocated(device)
            same_result(r, r_u, f"classic {tag}, cached against uncached")
            assert len(rounds_u.lanes) == n
            del r_u
            say(f"[classic] {tag} graph cache: bitwise equal to the "
                f"uncached driver; {wall / n * 1e3:.3f} ms/round cached, "
                f"{wall_u / n * 1e3:.3f} uncached; the loops' share "
                f"{rounds.solve_s / wall:.4f} cached, "
                f"{rounds_u.solve_s / wall_u:.4f} uncached; "
                f"{split_text(rounds.solves)}, uncached every round "
                f"{median_ms(rounds_u.solves):.3f} ms (median); peak "
                f"device memory {peak / 1e9:.3f} GB cached, "
                f"{peak_u / 1e9:.3f} GB uncached; {cache_text(log, log_u)}")
        del r

    # (f) phase 8's SVR and one-class problems, and train_svm on lane 0
    yv = sinc_target(X, 7)[:N_TRAIN]
    reg = SVR(C=10.0, epsilon=0.1, gamma="scale", eps=eps, engine="batched",
              **f64)
    r, wall = fit("SVR", lambda: reg.fit(Xtr, yv).fit_result_,
                  {"gram_block": 1})
    converged("SVR", r)
    q = qp.svr_qp(torch.tensor(yv, **f64), 10.0, 0.1)
    drift, gap, asum = svr_checks(reg.X_, q.p, q.bounds.lower,
                                  q.bounds.upper, r.alpha, r.G, reg.gamma_)
    say(f"[classic] SVR f64 (2l = {2 * N_TRAIN}): iterations "
        f"{int(r.iterations)} (fused {int(svr_ref['iterations'][0])}); "
        f"{wall:.3f} s = {wall / classic_loop(r.iterations) * 1e3:.4f} "
        f"ms/iteration (fused {svr_ref['ms_iter']:.4f}); "
        f"{counters_text(r)}; |G_carried - (p - Q alpha)|_max = "
        f"{drift:.3e}; KKT gap recomputed {gap:.4e}; |sum alpha| {asum:.3e}")
    objectives_agree("the fused fit's", "SVR", r.objective.reshape(1),
                     svr_ref["objective"].reshape(1))
    assert drift <= 1e-8 and gap <= eps and asum <= 1e-8, (drift, gap, asum)
    oc = OneClassSVM(nu=0.1, gamma="scale", eps=eps, engine="batched", **f64)
    r, wall = fit("one-class", lambda: oc.fit(Xtr).fit_result_,
                  {"gram_block": 1})
    converged("one-class", r)
    say(f"[classic] OneClassSVM(nu=0.1) f64: iterations "
        f"{int(r.iterations)}; {wall:.3f} s; {counters_text(r)}; sum "
        f"alpha - 1 = {float(r.alpha.sum()) - 1:.3e}")
    objectives_agree("the fused fit's", "one-class", r.objective.reshape(1),
                     svr_ref["oneclass"].reshape(1))
    assert abs(float(r.alpha.sum()) - 1.0) <= 1e-8
    del reg, oc, r

    (m, r), wall = fit("train_svm", lambda: model.train_svm(
        Xtr, Y[0], 1.0, ref_a["gamma"],
        SolverConfig(algorithm="pasmo", eps=eps), device=device), {})
    converged("train_svm", r)
    pm = predicted(lambda: model.predict(m, Xte), "train_svm predict")
    agree = float((pm == torch.where(ref_a["df0"] >= 0, 1.0, -1.0)).double()
                  .mean())
    say(f"[classic] train_svm lane 0 (rows from X, one lane): iterations "
        f"{int(r.iterations)} ((a)'s lane 0: "
        f"{int(ref_a['iterations'][0])}); {wall:.3f} s; held-out signs "
        f"equal to (a)'s lane 0 {agree:.4f}")
    objectives_agree("(a)'s lane 0", "train_svm", r.objective.reshape(1),
                     torch.tensor([ref_a["lane0"]], **f64))
    assert agree >= 0.99, agree
    say(f"[classic] phase 11 took {time.perf_counter() - t0:.1f} s")

# ---------------------------------------------------------------------------
# phase 12: the flight recorder at full width
# ---------------------------------------------------------------------------


def lane_series_ok(rec, label):
    """A drained lane's sample stamps rise strictly and end on its last
    iteration, and its ratio events number its accepted steps."""
    ts = rec["samples"]["t"]
    assert all(a < b for a, b in zip(ts, ts[1:])), (label, ts)
    assert ts and ts[-1] == rec["iterations"] - 1, (label, ts[-1:], rec)
    assert rec["n_ratio"] == rec["n_planning"], (label, rec["n_ratio"],
                                                 rec["n_planning"])


def phase_telemetry(device, svc_ref, grid_off, conj_svc):
    """Slice 10 at full width, f64: the flight recorder on the main paths.
    (a) phase 5's 10-lane SVC off, on, on, off, off, on
    (``Diagnostics(ring=RingConfig())``): ring-on iterations and alpha
    bitwise equal to ring-off and to phase 5's, 10 lanes drained, each
    lane's last stamp its last iteration, ``n_ratio == n_planning``; ms an
    iteration off and on, t_off/t_on (the ratio of the medians of three),
    and the kernels an iteration with and without the ring from two
    profiler windows.  (b) phase 6's 90-lane grid through the bank
    with ``diagnostics``: iterations bitwise equal to phase 6's, 90 lanes
    in caller order, ``trace``/``n_trace`` equal to the drained ratio
    channel.  (c) phase 10's conjugate SVC with a ring: iterations equal
    to phase 10's, accepted conjugate steps equal ``n_ratio``.  (d) phase
    4's small compacted grid (``chunk=32``, shrinking, bank) with
    diagnostics against the run without: bitwise equal, run-wide stamps,
    ``chunk_solve`` events.  (e) the grid's JSONL rendered by
    ``repro_torch.launch.telemetry_report``."""
    import tempfile
    from repro_torch.core import grid
    from repro_torch.core import multiclass as mc
    from repro_torch.core.solver import SolverConfig
    from repro_torch.core.solver_fused import CHECK_EVERY
    from repro_torch.launch import telemetry_report
    from repro_torch.svm import SVC, data
    from repro_torch.telemetry import Diagnostics, RingConfig
    t_phase = time.perf_counter()
    X, y = data.multiclass_blobs(N_TRAIN + N_TEST, seed=0, k=K, d=D,
                                 sep=12.0)
    Xtr, ytr = X[:N_TRAIN], y[:N_TRAIN]
    f64 = dict(device=device, dtype=torch.float64)
    eps = 1e-3

    def svc(diag, **kw):
        return SVC(C=1.0, gamma="scale", algorithm="pasmo", eps=eps,
                   diagnostics=diag, **f64, **kw)

    # (a) the SVC: off, on, on, off, off, on.  Repeated fits of one call
    # on an H100 vary by about 10% in wall time, more than the ring costs,
    # so three of each, and the ratio of the medians
    fits = []
    for on in (False, True, True, False, False, True):
        diag = Diagnostics(ring=RingConfig()) if on else None
        clf = svc(diag)
        _, counts, wall = counted(lambda: clf.fit(Xtr, ytr))
        r = clf.fit_result_
        t = loop_iterations(r.iterations, CHECK_EVERY, clf.max_iter)
        check_only(counts, {name: t for name in RBF_PASSES},
                   f"SVC ring {'on' if on else 'off'}")
        fits.append((on, r, wall / t * 1e3, diag))
    off = [f for f in fits if not f[0]]
    ring_on = [f for f in fits if f[0]]
    r0 = off[0][1]
    assert torch.equal(r0.iterations, svc_ref["iterations"]), "phase 5"
    for on, r, _, diag in fits:
        assert torch.equal(r.iterations, r0.iterations), "iterations"
        assert torch.equal(r.alpha, r0.alpha), "alpha"
        if on:
            assert len(diag.lanes) == K, len(diag.lanes)
            for b, rec in enumerate(diag.lanes):
                assert rec["label"] == b and rec["iterations"] == int(
                    r.iterations[b]), (b, rec["iterations"])
                lane_series_ok(rec, f"SVC lane {b}")
    ms_off = sorted(f[2] for f in off)
    ms_on = sorted(f[2] for f in ring_on)
    ratio = ms_off[1] / ms_on[1]
    say(f"[telemetry] SVC {K} lanes f64, ring off/on/on/off/off/on: "
        f"iterations and alpha bitwise equal to ring off and to phase 5 "
        f"(max lane {int(r0.iterations.max())}); ms an iteration in order "
        + ", ".join(f"{'on' if f[0] else 'off'} {f[2]:.4f}" for f in fits)
        + f"; t_off/t_on (ratio of the medians) {ratio:.4f}; accepted "
        f"planning steps = ratio events on every lane (sum "
        f"{int(r0.n_planning.sum())})")
    prof_off = profile_iterations(
        lambda: svc(None, max_iter=PROFILE_ITERS).fit(Xtr, ytr),
        "SVC f64, ring off", ms_off[1])
    prof_on = profile_iterations(
        lambda: svc(Diagnostics(ring=RingConfig()),
                    max_iter=PROFILE_ITERS).fit(Xtr, ytr),
        "SVC f64, ring on", ms_on[1])
    if prof_off and prof_on:
        say(f"[telemetry] kernels an iteration: ring off "
            f"{prof_off['kernels']:.1f}, on {prof_on['kernels']:.1f} (+"
            f"{prof_on['kernels'] - prof_off['kernels']:.1f}); busy ms an "
            f"iteration off {prof_off['busy_ms']:.4f}, on "
            f"{prof_on['busy_ms']:.4f}")

    with tempfile.TemporaryDirectory() as tmp:
        # (b) the 90-lane bank grid, its JSONL kept for (e)
        path = pathlib.Path(tmp) / "grid.jsonl"
        gammas = [1.0 / (D * float(Xtr.var())) * f for f in GRID_GAMMA_FACTORS]
        Y = mc.ovr_labels(mc.class_index(ytr)[1], K, torch.float64, device)
        diag = Diagnostics(path, ring=RingConfig())
        r, counts, wall, t, _ = fit_grid(lambda: grid.solve_grid(
            Xtr, Y, GRID_CS, gammas, SolverConfig(algorithm="pasmo", eps=eps),
            impl="auto", precompute=True, diagnostics=diag, **f64), device)
        check_counts(counts, t, True, "grid with the ring")
        assert torch.equal(r.iterations, grid_off["iterations"]), "phase 6"
        assert len(diag.lanes) == GRID_B, len(diag.lanes)
        cells = [(g, c, ci) for g in range(len(gammas)) for c in range(K)
                 for ci in range(len(GRID_CS))]
        for rec, (g, c, ci) in zip(diag.lanes, cells):
            assert (rec["gamma"], rec["label"], rec["C"]) == (
                gammas[g], c, GRID_CS[ci]), rec
            assert rec["iterations"] == int(r.iterations[g, c, ci])
            lane_series_ok(rec, f"grid lane {rec['lane']}")
            n = rec["n_ratio"]
            assert int(r.n_trace[g, c, ci]) == n
            assert r.trace[g, c, ci, :min(n, r.trace.shape[-1])].tolist() \
                == rec["ratio"]["value"]
        summary = diag.finalize()
        keys = ("n_lanes", "n_converged", "max_iterations", "total_planning")
        say(f"[telemetry] grid bank {GRID_B} lanes with the ring: iterations "
            f"bitwise equal to phase 6, {len(diag.lanes)} lanes drained in "
            f"caller order, trace/n_trace equal to the ratio channel; "
            f"{wall / t * 1e3:.4f} ms an iteration (phase 6 "
            f"{grid_off['ms_iter']:.4f}) over {t} loop iterations; summary "
            f"{dict((k, summary[k]) for k in keys)}")

        # (c) phase 10's conjugate SVC with a ring
        diag_c = Diagnostics(ring=RingConfig())
        clf = SVC(C=1.0, gamma="scale", algorithm="smo", step="conjugate",
                  eps=eps, diagnostics=diag_c, **f64)
        _, counts, wall = counted(lambda: clf.fit(Xtr, ytr))
        rc_ = clf.fit_result_
        t = loop_iterations(rc_.iterations, CHECK_EVERY, clf.max_iter)
        check_only(counts, {"rbf_row_wss_batched": t, CONJ_PASSES[0]: t},
                   "conjugate SVC with the ring")
        assert torch.equal(rc_.iterations, conj_svc["iterations"]), "ph. 10"
        assert torch.equal(rc_.n_planning, conj_svc["n_planning"])
        for rec in diag_c.lanes:
            lane_series_ok(rec, f"conjugate lane {rec['lane']}")
        say(f"[telemetry] conjugate SVC with the ring: iterations and "
            f"accepted steps equal to phase 10's; ratio events per lane "
            f"{[rec['n_ratio'] for rec in diag_c.lanes]}; "
            f"{wall / t * 1e3:.4f} ms an iteration")

        # (d) phase 4's small compacted grid on the card
        Xs, ys = data.multiclass_blobs(150, seed=2, k=3, d=8, sep=4.0)
        Ys = mc.ovr_labels(mc.class_index(ys)[1], 3, torch.float64, device)
        kw = dict(chunk=32, impl="cuda", precompute=True, shrinking=True,
                  **f64)
        cfg_s = SolverConfig(eps=1e-5)
        plain = grid.solve_grid_compacted(Xs, Ys, (4.0, 1.0), (0.05, 0.2),
                                          cfg_s, **kw)
        diag_d = Diagnostics(ring=RingConfig(sample_every=4, cap=64))
        rd, counts, _ = counted(lambda: grid.solve_grid_compacted(
            Xs, Ys, (4.0, 1.0), (0.05, 0.2), cfg_s, diagnostics=diag_d,
            **kw))
        for f in ("iterations", "alpha", "n_planning"):
            assert torch.equal(getattr(rd, f), getattr(plain, f)), f
        # the same run without the chunked driver's graph cache: every
        # field, the Fig. 3 channel and the events (their wall times
        # aside) bitwise equal
        diag_u = Diagnostics(ring=RingConfig(sample_every=4, cap=64))
        with uncached():
            ru = grid.solve_grid_compacted(
                Xs, Ys, (4.0, 1.0), (0.05, 0.2), cfg_s, diagnostics=diag_u,
                **kw)
        same_result(rd, ru, "compacted grid with diagnostics, uncached")

        def timeless(diag):
            return [{k: v for k, v in e.items()
                     if k not in ("ts", "seconds", "deadline")}
                    for e in diag.sink.events
                    if e["event"] != "straggler_warning"]
        assert timeless(diag_d) == timeless(diag_u)
        assert [{k: v for k, v in rec.items() if k != "ts"}
                for rec in diag_d.lanes] == [
            {k: v for k, v in rec.items() if k != "ts"}
            for rec in diag_u.lanes]
        assert len(diag_d.lanes) == rd.iterations.numel()
        for rec in diag_d.lanes:
            lane_series_ok(rec, f"compacted lane {rec['lane']}")
        rounds = [e for e in diag_d.sink.events
                  if e.get("name") == "chunk_solve"]
        assert len(rounds) >= 2 and all(e["seconds"] > 0 for e in rounds)
        warnings = [e for e in diag_d.sink.events
                    if e["event"] == "straggler_warning"]
        say(f"[telemetry] compacted grid chunk=32 with diagnostics: bitwise "
            f"equal to the run without, and (ring, lanes, events) to the "
            f"uncached driver; {len(rounds)} chunk_solve events "
            f"(s: {[round(e['seconds'], 4) for e in rounds]}, live lanes "
            f"{[e['lanes'] for e in rounds]}); {len(warnings)} straggler "
            f"warnings; launches {counts}")

        # (e) the report of (b)'s JSONL
        text = telemetry_report.render_report(
            telemetry_report.load_events(str(path)), top_k=3, trace_lane=0)
        secs = {sec.split("\n", 1)[0]: sec for sec in text.split("## ")[1:]}
        for name in ("environment", "host phases", "convergence",
                     "stragglers", "planning trace (Fig. 3), lane 0",
                     "summary"):
            assert name in secs, (name, list(secs))
        def body(name):
            return [ln for ln in secs[name].splitlines()[1:] if ln.strip()]

        conv = body("convergence")
        say(f"[telemetry] report of {path.name} "
            f"({path.stat().st_size / 1e6:.3f} MB): environment "
            + "; ".join(ln.strip("| ").replace(" | ", "=")
                        for ln in body("environment")
                        if "device_kind" in ln or "cuda_version" in ln))
        for ln in conv[:5] + [f"... {len(conv) - 2} lane rows in all"]:
            say(f"[telemetry]   {ln}")
        for ln in body("stragglers"):
            say(f"[telemetry]   {ln}")
    say(f"[telemetry] phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return dict(ratio=ratio, svc_lanes=ring_on[0][3].lanes)


# ---------------------------------------------------------------------------
# phase 13: several cards (slice 12)
# ---------------------------------------------------------------------------


def device_peaks(devs) -> str:
    """Peak allocated memory of each device since its last reset, GB."""
    return ", ".join(f"{d} {torch.cuda.max_memory_allocated(d) / 1e9:.3f} GB"
                     for d in devs)


def median_wall(run, n: int = 5) -> float:
    """Median wall ms of ``run()``, each ended by a synchronisation."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return sorted(out)[n // 2]


@contextlib.contextmanager
def collective_count(counts):
    """Count the ``torch.distributed`` collectives made inside, by name."""
    import torch.distributed as dist
    saved = {name: getattr(dist, name) for name in ("all_reduce",
                                                     "all_gather")}

    def spy(name):
        def call(*a, **kw):
            counts[name] += 1
            return saved[name](*a, **kw)
        return call
    for name in saved:
        setattr(dist, name, spy(name))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def phase_multi(device, devs, svc_ref, grid_off, small_compacted,
                ring_lanes):
    """Slice 12 at full width, f64, on the cards ``devs`` (every attached
    card), ``device`` the first:
    (a) phase 5's SVC with ``engine="sharded"``: bitwise equal to phase
    5's fused fit on one card, ms and kernels an iteration, peak memory a
    card, and ring on bitwise equal to phase 12's ring; the schedule and
    gather cost of a call (a sharded solve against a batched one, both
    with ``max_iter=0``); (b) phase 6's one-class grid through both
    sources on ``devices=[cuda:0]``, bitwise equal to phase 6's; (c) phase
    4's small compacted grids on ``devices=[cuda:0]``, bitwise equal to
    phase 4's, one capture per (entry, chunk shape); (d)
    ``solve_sharded`` in a one-rank NCCL group on phase 5's lane 0: its
    objective within rtol 1e-6 of that lane's, the KKT gap at most eps;
    ms, kernels and collectives an iteration and peak memory."""
    import os
    import tempfile
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.analysis.capture_guard import CaptureLog
    from repro_torch.core import grid, sharded_lanes, solver_fused
    from repro_torch.core import multiclass as mc
    from repro_torch.core.sharded import solve_sharded
    from repro_torch.core.solver import SolverConfig
    from repro_torch.core.solver_fused import CHECK_EVERY
    from repro_torch.svm import SVC, data
    from repro_torch.telemetry import Diagnostics, RingConfig
    t_phase = time.perf_counter()
    one = len(devs) == 1
    X, y = data.multiclass_blobs(N_TRAIN + N_TEST, seed=0, k=K, d=D,
                                 sep=12.0)
    Xtr, ytr = X[:N_TRAIN], y[:N_TRAIN]
    f64 = dict(device=device, dtype=torch.float64)
    eps = 1e-3

    def reset():
        for d in devs:
            torch.cuda.reset_peak_memory_stats(d)

    def svc(**kw):
        return SVC(C=1.0, gamma="scale", algorithm="pasmo", eps=eps,
                   engine="sharded", **f64, **kw)

    def agree(tag, got, want):
        if one:
            return
        agree_objectives("[multi]", "the unsharded run", tag, got, want)

    # (a) the sharded SVC on every attached card
    reset()
    clf = svc()
    _, counts, wall = counted(lambda: clf.fit(Xtr, ytr))
    r = clf.fit_result_
    t = loop_iterations(r.iterations, CHECK_EVERY, clf.max_iter)
    assert clf.engine_ == "sharded" and bool(r.converged.all())
    if one:
        check_only(counts, {name: t for name in RBF_PASSES}, "sharded SVC")
        assert torch.equal(r.alpha, svc_ref["alpha"]), "phase 5 alpha"
        assert torch.equal(r.iterations, svc_ref["iterations"]), "phase 5"
    agree("SVC", r.objective, svc_ref["objective"])
    ms_a = wall / t * 1e3
    same = "alpha and iterations bitwise equal to phase 5; " if one else ""
    say(f"[multi] SVC engine='sharded' on {len(devs)} card(s), {K} lanes "
        f"f64: {same}{t} loop iterations, {wall:.3f} s = {ms_a:.4f} ms an iteration "
        f"(phase 5 {svc_ref['ms_iter']:.4f}); launches {counts}; peak "
        f"{device_peaks(devs)}")
    profile_iterations(lambda: svc(max_iter=PROFILE_ITERS).fit(Xtr, ytr),
                       "sharded SVC f64 full width", ms_a)
    diag = Diagnostics(ring=RingConfig())
    clf_r = svc(diagnostics=diag)
    _, counts, wall_r = counted(lambda: clf_r.fit(Xtr, ytr))
    if one:
        assert torch.equal(clf_r.fit_result_.alpha, svc_ref["alpha"])
        strip = [[{k: v for k, v in rec.items() if k != "ts"}
                  for rec in lanes] for lanes in (diag.lanes, ring_lanes)]
        assert strip[0] == strip[1], "the ring differs from phase 12's"
    say(f"[multi] SVC sharded with the ring: {len(diag.lanes)} lanes"
        f"{', bitwise equal to phase 12' if one else ''}; "
        f"{wall_r / t * 1e3:.4f} ms an iteration")

    # the schedule and gather cost of a call: a sharded solve against a
    # batched one on the same lanes, neither running an iteration
    Xt = clf.X_
    Y = mc.ovr_labels(mc.class_index(ytr)[1], K, torch.float64, device)
    L, U = torch.clamp_max(Y, 0.0), torch.clamp_min(Y, 0.0)
    gam = torch.full((K,), clf.gamma_, dtype=torch.float64, device=device)
    cfg0 = SolverConfig(algorithm="pasmo", eps=eps, max_iter=0)
    calls = {
        "batched": lambda: solver_fused.solve_fused_batched_qp(
            Xt, Y, L, U, gam, cfg0),
        "sharded": lambda: sharded_lanes.solve_fused_sharded_qp(
            Xt, Y, L, U, gam, cfg0, devices=devs)}
    ms0 = {k: [] for k in calls}
    for k in ("batched", "sharded", "sharded", "batched"):
        ms0[k].append(median_wall(calls[k]))
    cost = min(ms0["sharded"]) - min(ms0["batched"])
    say(f"[multi] schedule and gather of a {K}-lane call over {len(devs)} "
        f"card(s): {cost:.4f} ms (a sharded solve with max_iter=0, "
        f"{min(ms0['sharded']):.4f} ms, less a batched one, "
        f"{min(ms0['batched']):.4f} ms; medians of five, the lower of two "
        f"rounds, run batched, sharded, sharded, batched)")

    # (b) phase 6's one-class grid on devices=[cuda:0]
    cfg = SolverConfig(algorithm="pasmo", eps=eps)
    for precompute, tag in ((True, "bank"), (False, "rbf")):
        reset()
        ro, counts, wall, t, _ = fit_grid(
            lambda: grid.solve_grid_oneclass(
                Xtr, GRID_NUS, grid_off["gammas"], cfg, impl="auto",
                precompute=precompute, devices=[device], **f64), device)
        check_counts(counts, t, precompute, f"sharded one-class {tag}")
        same_result(ro, grid_off["oneclass"][tag], f"one-class {tag}")
        say(f"[multi] one-class grid {tag} on devices=[{device}]: every "
            f"field bitwise equal to phase 6; {t} loop iterations, "
            f"{wall / t * 1e3:.4f} ms an iteration; peak "
            f"{device_peaks(devs)}")

    # (c) phase 4's small compacted grids on devices=[cuda:0]
    Xs, ys = data.multiclass_blobs(150, seed=2, k=3, d=8, sep=4.0)
    Ys = mc.ovr_labels(mc.class_index(ys)[1], 3, torch.float64, device)
    for (precompute, chunk), want in small_compacted.items():
        src = "bank" if precompute else "rbf"
        with CaptureLog() as log:
            rc, counts, _ = counted(lambda: grid.solve_grid_compacted(
                Xs, Ys, (4.0, 1.0), (0.05, 0.2), SolverConfig(eps=1e-5),
                chunk=chunk, impl="cuda", precompute=precompute,
                shrinking=True, devices=[device], **f64))
        same_result(rc, want, f"sharded compacted grid {src} {chunk}")
        assert all(len(k) > 2 for k, _ in log.loops), "unsharded rounds"
        say(f"[multi] compacted grid chunk={chunk} shrinking, {src}, on "
            f"devices=[{device}]: bitwise equal to phase 4; "
            f"{cache_text(log)}")

    # (d) the row-sharded solver in a one-rank NCCL group, phase 5's lane 0
    y0 = Y[0]
    cfg_d = SolverConfig(algorithm="pasmo", eps=eps)
    # a one-rank group on one host: its bootstrap needs the loopback only
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, timeout=timedelta(seconds=300))
        try:
            def row_sharded(c=cfg_d):
                return solve_sharded(Xt, y0, 1.0, clf.gamma_, None, c,
                                     **f64)
            capped = SolverConfig(algorithm="pasmo", eps=eps,
                                  max_iter=PROFILE_ITERS)
            row_sharded(capped)          # warm-up: NCCL's communicator
            # one chunk, which runs eagerly (replays issue no Python
            # call): the collectives but the start's gap and the finish's
            # objective, gap and alpha
            colls = collections.Counter()
            with collective_count(colls):
                row_sharded(capped)
            per_it = (sum(colls.values()) - 4) / PROFILE_ITERS
            reset()
            rs, counts, wall = counted(row_sharded)
            check_only(counts, {}, "row-sharded solver")
            its = int(rs.iterations)
            loop = loop_iterations(rs.iterations.reshape(1), CHECK_EVERY,
                                   cfg_d.max_iter)
            obj, want = float(rs.objective), float(svc_ref["objective"][0])
            rel = abs(obj - want) / abs(want)
            assert bool(rs.converged) and float(rs.kkt_gap) <= eps
            assert rel <= 1e-6, (obj, want)
            ms_d = wall / loop * 1e3
            say(f"[multi] solve_sharded, one NCCL rank on {device}, lane 0 "
                f"(l={N_TRAIN}, d={D}, f64): {its} iterations ({loop} "
                f"loop iterations), objective {obj:.10g} against phase 5's "
                f"{want:.10g} (rel {rel:.3e}), KKT gap "
                f"{float(rs.kkt_gap):.3e}, {int(rs.n_planning)} planning "
                f"steps; {wall:.3f} s = {ms_d:.4f} ms an iteration "
                f"(chunks of {CHECK_EVERY} replayed as CUDA graphs); "
                f"collectives in an eager chunk {dict(colls)} = "
                f"{per_it:.2f} an iteration; peak {device_peaks(devs)}")
            profile_iterations(lambda: row_sharded(capped),
                               "solve_sharded, one NCCL rank", ms_d)
        finally:
            dist.destroy_process_group()
    say(f"[multi] phase 13 took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# the capture guard on the card
# ---------------------------------------------------------------------------


def phase_analysis(device):
    """``repro_torch.analysis.capture_guard`` with real graphs: exact
    captures of a fused and a classic fit, of the fused chunked driver
    (bank and rbf) and the classic compacted grid over a (C, gamma) sweep,
    each bitwise equal to the uncached driver; then a (C, gamma) sweep of
    fits builds no kernel, and every source hash was built once."""
    from repro_torch.analysis import capture_guard
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    findings = capture_guard.run_probes(device)
    for f in findings:
        say(f"[analysis] {f.render()}")
    assert not findings, "the capture guard found something"
    say(f"[analysis] capture guard on the card: "
        f"{len(capture_guard.PROBES) + 1} probes clean (captures exact per "
        f"fit and per chunked call, cached bitwise equal to uncached); "
        f"nvcc builds in this process by source hash {dict(build.BUILDS)} "
        f"(current {build.source_hash()}, "
        f"{'built here' if build.BUILDS else 'found built'}); "
        f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 15: the LM serving path and the SVM probe at full width
# ---------------------------------------------------------------------------

LM_ARCH = "qwen2-0.5b"
# (b) bf16 serving; (c) f32 prefill + teacher-forced decode, then the same
# at batch 2 with a 128-token window, so the ring wraps
LM_SERVE = dict(batch=8, prompt=512, new=64)
LM_F32 = dict(batch=4, prompt=256, extra=8)
LM_WINDOW = dict(batch=2, window=128)
# the reference's own bound for prefill + decode against the full forward
# (tests/test_models_smoke.py)
LM_TOL = 2e-3
# bf16 logits against f32 logits of the same weights, in (b) at the
# served shape and in (c) through the bf16 cache: limits set from the
# first full-width reading of bf16 against f32 (batch 4, 264 tokens, the
# full forward: max |diff| 0.0515, top-1 agreement 0.9631; H100 80GB HBM3
# at 700 W)
BF16_MAX_DIFF = 0.2
BF16_TOP1 = 0.9
# (d) 4096 sequences of 128 tokens, class c's ids uniform over the 64
# from c * (vocab // 4); features in batches of 512; the first 3072 train
PROBE = dict(n=4096, seq=128, k=4, band=64, n_train=3072, batch=512,
             C=10.0, eps=1e-3)


def tree_leaves(tree) -> list:
    from repro_torch.models.layers import tree_map
    out = []
    tree_map(out.append, tree)
    return out


def lm_prefill_decode(cfg, params, tokens, S, kv_dtype, extra=None):
    """Logits (B, T, V) of a prefill of the first ``S`` of ``tokens``
    (B, T) (with ``extra``, the prompt's other inputs: an
    encoder-decoder's frames) and a teacher-forced decode step for each
    later one, and the cache."""
    from repro_torch.models import registry
    T = tokens.shape[1]
    logits, cache = registry.prefill(params, cfg, {"tokens": tokens[:, :S],
                                                   **(extra or {})},
                                     T, kv_dtype=kv_dtype)
    got = [logits]
    for t in range(S, T):
        logits, cache = registry.decode_step(params, cfg, cache,
                                             tokens[:, t:t + 1], t)
        got.append(logits)
    return torch.cat(got, dim=1), cache


def bf16_agrees(bf, full, label, tag="lm", max_diff=BF16_MAX_DIFF,
                min_top1=BF16_TOP1):
    """bf16 logits against f32 ones of the same weights: max |diff| at
    most ``max_diff`` (not gated when None) and top-1 agreement at least
    ``min_top1``."""
    diff = (bf.float() - full).abs()
    top1 = float((bf.argmax(-1) == full.argmax(-1)).double().mean())
    say(f"[{tag}] {label}, bf16 against f32 logits of the same weights "
        f"{tuple(full.shape)}: max abs diff {float(diff.max()):.4f} (limit "
        f"{max_diff}), mean {float(diff.mean()):.5f}, top-1 agreement "
        f"{top1:.4f} (limit {min_top1})")
    if max_diff is not None:
        assert float(diff.max()) <= max_diff, (label, float(diff.max()))
    assert top1 >= min_top1, (label, top1)


def lm_decode_check(cfg, params, B, S, extra, device, label, tag="lm"):
    """Prefill of ``S`` tokens and ``extra`` teacher-forced decode steps in
    f32 against ``forward_logits`` on all ``S + extra``: every logit within
    ``|a - b| <= LM_TOL + LM_TOL |b|``.  Returns the full forward's logits
    and the batch."""
    from repro_torch.models import registry
    batch = registry.demo_batch(cfg, B, S + extra, seed=0, device=device)
    full, _ = registry.forward_logits(params, cfg, batch)
    got, cache = lm_prefill_decode(
        cfg, params, batch["tokens"], S, torch.float32,
        {k: v for k, v in batch.items() if k not in ("tokens", "labels")})
    err = (got - full).abs()
    worst = float((err / (LM_TOL + LM_TOL * full.abs())).max())
    held = decode_cache_text(cache)
    say(f"[{tag}] (c) {label}: prefill {S} + {extra} decode steps against "
        f"forward_logits on {S + extra}, batch {B}, f32: max abs err "
        f"{float(err.max()):.3e} (max |logit| {float(full.abs().max()):.3f})"
        f", worst err / (atol + rtol |b|) {worst:.4f} (rtol = atol = "
        f"{LM_TOL}); {held}")
    assert worst <= 1.0, (label, worst)
    return full, batch


def decode_cache_text(cache) -> str:
    """What a decode cache holds, for the (c) lines: the first attention
    ring's slots and positions, recurrent states, encoder keys."""
    from repro_torch.tree import leaves_with_path
    out = []
    for path, t in leaves_with_path(cache):
        if path.endswith("kpos"):
            ring = t.reshape(-1, t.shape[-1])[0]
            out.append(f"{path} slots {ring.numel()}, positions "
                       f"{int(ring.min())}..{int(ring.max())}")
        elif path.split("/")[-1] in ("h", "conv", "cross_k"):
            out.append(f"{path} {tuple(t.shape)} {str(t.dtype)[6:]}")
    return "; ".join(out)


def decode_ops(cfg, params, cache, tok, pos) -> int:
    """The aten ops (views included) that one ``registry.decode_step``
    dispatches, recorded by the static analysis's ``OpRecorder``."""
    from repro_torch.analysis.dispatch_audit import OpRecorder
    from repro_torch.models import registry
    with OpRecorder() as rec:
        registry.decode_step(params, cfg, cache, tok, pos)
    return len(rec.ops)


def serve_twice(cfg, params, B, S, new, device, label):
    """Greedy bf16 serving of a seeded prompt (an encoder-decoder's also
    draws bf16 frames after the tokens, as the serve launcher does),
    twice, tokens bitwise equal, no kernel of the port launched: (prompt,
    ServeConfig, walls, peak bytes, tokens)."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.train.serve_step import greedy_generate
    rng = np.random.default_rng(0)
    prompt = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (B, S)), dtype=torch.int32,
        device=device)}
    if cfg.family == "encdec":
        prompt["frames"] = torch.as_tensor(
            rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)) * 0.02,
            dtype=torch.bfloat16, device=device)
    sc = ServeConfig(seq_len=S + new, batch=B, param_dtype="bfloat16",
                     compute_dtype="bfloat16", kv_dtype="bfloat16")
    runs = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats(device)
        gen, counts, wall = counted(
            lambda: greedy_generate(cfg, sc, params, prompt, new,
                                    device=device))
        check_only(counts, {}, label)
        runs.append((gen, wall, torch.cuda.max_memory_allocated(device)))
    assert torch.equal(runs[0][0], runs[1][0]), f"{label}: tokens differ"
    assert runs[0][0].shape == (B, new)
    return (prompt, sc, [r[1] for r in runs], max(r[2] for r in runs),
            runs[0][0])


def prefill_ms(prefill, params, prompt, device, n=3):
    """``n`` timed calls of ``prefill(params, prompt)``: (ms of each, the
    last call's result)."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        r = prefill(params, prompt)
        torch.cuda.synchronize(device)
        out.append((time.perf_counter() - t0) * 1e3)
    return out, r


def phase_lm(device, timer, errs):
    """Phase 15: ``qwen2-0.5b`` at full width, random weights, served and
    probed; see the module docstring.  The Gram kernel's checks at the
    probe's shapes raise ``errs["gram_block"]`` to their error."""
    from repro_torch.configs import get_config
    from repro_torch.core import multiclass as mc
    from repro_torch.core.solver import SolverConfig
    from repro_torch.kernels import gram_block, ref
    from repro_torch.models import registry
    from repro_torch.svm import probes
    from repro_torch.train.serve_step import (_cast, greedy_prefill,
                                              make_prefill)
    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    gb = 1e9

    # (a) parameters in bf16 on the card
    torch.cuda.reset_peak_memory_stats(device)
    params = registry.init_params(0, cfg, torch.bfloat16, device=device)
    torch.cuda.synchronize(device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    # param_count() leaves out the QKV biases and the final norm
    extra = (cfg.n_layers * (cfg.n_heads + 2 * cfg.n_kv_heads)
             * cfg.head_dim * cfg.qkv_bias + cfg.d_model)
    peak = torch.cuda.max_memory_allocated(device)
    say(f"[lm] (a) {cfg.name}: {n_params} parameters (cfg.param_count() "
        f"{cfg.param_count()} + {extra} QKV biases and final norm), "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads, {cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}; bf16, peak {peak / gb:.3f} GB")
    assert n_params == cfg.param_count() + extra

    # (b) greedy serving in bf16, twice
    B, S, new = LM_SERVE["batch"], LM_SERVE["prompt"], LM_SERVE["new"]
    prompt, sc, walls, peak, gen = serve_twice(cfg, params, B, S, new,
                                               device, "lm serve")
    t_pre, (served, _) = prefill_ms(make_prefill(cfg, sc), params, prompt,
                                    device)
    ms_pre = min(t_pre)
    ms_tok = (min(walls) * 1e3 - ms_pre) / (new - 1)
    say(f"[lm] (b) greedy_generate bf16, batch {B}, prompt {S}, {new} new "
        f"tokens: walls {walls[0]:.4f} s, {walls[1]:.4f} s (tokens bitwise "
        f"equal); prefill alone {ms_pre:.3f} ms (min of "
        f"{', '.join(f'{t:.3f}' for t in t_pre)}); decode "
        f"{ms_tok:.3f} ms a step of {B} tokens ((best wall - prefill) / "
        f"{new - 1}); {B * new / min(walls):.1f} tokens/s end to end, "
        f"{B * 1e3 / ms_tok:.1f} tokens/s decoding; peak "
        f"{peak / gb:.3f} GB; no kernel of the port "
        f"launched (the LM path reaches no Pallas site); first sequence "
        f"{gen[0, :12].tolist()}")
    # the host's load: the aten ops one decode step dispatches
    p16, cache, tok = greedy_prefill(cfg, sc, params, prompt, device=device)
    n_ops = decode_ops(cfg, p16, cache, tok, S)
    say(f"[lm] (b) one decode step dispatches {n_ops} aten ops (views "
        f"included), {ms_tok * 1e3 / n_ops:.1f} us of the step each")
    del p16, cache, tok
    # the served prefill's logits at every position against an f32
    # forward of the same weights, TF32 off
    assert not torch.backends.cuda.matmul.allow_tf32
    assert served.dtype == torch.bfloat16
    full, _ = registry.forward_logits(_cast(params, torch.float32), cfg,
                                      prompt)
    bf16_agrees(served, full, f"(b) the served prefill, batch {B}, prompt "
                f"{S}")
    del served, full

    # (c) f32 at full width, TF32 off: prefill + decode against the full
    # forward, without and with a wrapped window; bf16 against f32 logits
    # through the full forward and through the bf16 cache
    torch.cuda.reset_peak_memory_stats(device)
    params32 = registry.init_params(1, cfg, torch.float32, device=device)
    full, batch = lm_decode_check(cfg, params32, LM_F32["batch"],
                                  LM_F32["prompt"], LM_F32["extra"], device,
                                  "full attention")
    params16 = _cast(params32, torch.bfloat16)
    bf, _ = registry.forward_logits(params16, cfg, batch)
    bf16_agrees(bf, full, "(c) forward_logits")
    bf, _ = lm_prefill_decode(cfg, params16, batch["tokens"],
                              LM_F32["prompt"], torch.bfloat16)
    bf16_agrees(bf, full, f"(c) prefill {LM_F32['prompt']} + "
                f"{LM_F32['extra']} decode steps through the bf16 cache")
    del full, bf, batch, params16
    windowed = dataclasses.replace(cfg, sliding_window=LM_WINDOW["window"])
    lm_decode_check(windowed, params32, LM_WINDOW["batch"], LM_F32["prompt"],
                    LM_F32["extra"], device,
                    f"sliding_window {LM_WINDOW['window']} (the ring wraps)")
    say(f"[lm] (c) peak {torch.cuda.max_memory_allocated(device) / gb:.3f} "
        f"GB (f32 and bf16 weights, f32 logits)")
    del params32

    # (d) the probe on the bf16 model's features
    P = PROBE
    rng = np.random.default_rng(0)
    labels = rng.integers(0, P["k"], size=P["n"])
    tokens = (labels[:, None] * (cfg.vocab // 4)
              + rng.integers(0, P["band"], size=(P["n"], P["seq"])))
    tokens = torch.as_tensor(tokens, dtype=torch.int32, device=device)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    feats = torch.cat([
        probes.extract_features(params, cfg, {"tokens": tokens[i:i + P[
            "batch"]]}) for i in range(0, P["n"], P["batch"])]).double()
    torch.cuda.synchronize(device)
    t_feat = time.perf_counter() - t0
    assert feats.shape == (P["n"], cfg.d_model)
    assert bool(torch.isfinite(feats).all())
    nt = P["n_train"]
    Xtr, Xte = feats[:nt], feats[nt:]
    ytr, yte = labels[:nt], labels[nt:]
    scfg = SolverConfig(algorithm="pasmo", eps=P["eps"])
    torch.cuda.reset_peak_memory_stats(device)
    probe, counts, wall = counted(
        lambda: probes.train_probe(Xtr, ytr, P["k"], C=P["C"], cfg=scfg,
                                   device=device))
    check_only(counts, {"gram_block": 1}, "probe fit")
    assert gram_block.gram_cross.symmetric_launches == 1
    peak = torch.cuda.max_memory_allocated(device)
    pred = predicted(lambda: probes.predict_probe(probe, Xte), "probe")
    acc = float((pred.cpu().numpy() == yte).mean())
    say(f"[lm] (d) features: {P['n']} sequences of {P['seq']} tokens, "
        f"{P['k']} classes (64-id bands), bf16 model in batches of "
        f"{P['batch']}: {t_feat:.3f} s; gamma {probe.gamma:.6e} (median "
        f"heuristic); fit {nt} x {cfg.d_model} f64, C = {P['C']}: "
        f"{wall:.3f} s, peak {peak / gb:.3f} GB, Gram launches "
        f"{counts['gram_block']} (symmetric)")
    for c in range(P["k"]):
        say(f"[lm] (d) head {c}: iterations {int(probe.iterations[c])}, KKT "
            f"gap {float(probe.kkt_gap[c]):.3e}, converged "
            f"{bool(probe.converged[c])}, objective "
            f"{float(probe.objective[c]):.10e}")
    assert bool(probe.converged.all())
    assert float(probe.kkt_gap.max()) <= P["eps"]
    Y = torch.where(torch.as_tensor(ytr, device=device)[None, :]
                    == torch.arange(P["k"], device=device)[:, None],
                    1.0, -1.0).double()
    fused, _, fwall = counted(
        lambda: mc.solve_ovr_fused(Xtr, Y, P["C"], probe.gamma, scfg,
                                   device=device, dtype=torch.float64),
        tally=False)
    assert bool(fused.converged.all())
    agree_objectives("[lm] (d)", "solve_ovr_fused (the rbf passes, "
                     f"{fwall:.3f} s, iterations "
                     f"{fused.iterations.tolist()})", "probe heads",
                     probe.objective, fused.objective)
    say(f"[lm] (d) held-out accuracy on {P['n'] - nt}: {acc:.4f} "
        f"(reported, not a gate)")
    # kernel 3 at the probe's shapes (X is 22 MB: warm in the L2)
    item = 8
    n, d, m = nt, cfg.d_model, P["n"] - nt
    g = probe.gamma
    for tag, kern, plain, lib, nbytes, nops, sym in (
            (f"Gram {n}^2 x {d} f64, symmetric",
             lambda: gram_block.gram_cross(Xtr, Xtr, g),
             lambda: ref.gram_cross(Xtr, Xtr, g), lambda: Xtr @ Xtr.T,
             (n * n + n * d) * item, n * (n + 1) * d + 6 * n * n, True),
            (f"predict {m} x {n} x {d} f64, cross",
             lambda: gram_block.gram_cross(Xte, Xtr, g),
             lambda: ref.gram_cross(Xte, Xtr, g), lambda: Xte @ Xtr.T,
             (m * n + (m + n) * d) * item, 2 * m * n * d + 6 * m * n,
             False)):
        # the kernel's result at the main path's shapes against the plain
        # version (not tallied: outside a counted run)
        n_sym = gram_block.gram_cross.symmetric_launches
        K_k, K_p = kern(), plain()
        assert gram_block.gram_cross.symmetric_launches == n_sym + sym, tag
        err = _close(f"gram_block, the probe's {tag}", K_k, K_p,
                     TOL[torch.float64], 1.0)
        if sym and not torch.equal(K_k, K_k.T):
            raise AssertionError(f"the probe's {tag}: K differs from K.T")
        errs["gram_block"] = max(errs["gram_block"], err)
        say(f"[lm] (d) gram_block, the probe's {tag}: max abs err {err:.3e} "
            f"against the plain version (tolerance {TOL[torch.float64]})"
            + (", bitwise equal to its transpose" if sym else ""))
        del K_k, K_p
        ms_k, ms_p = timer.ms(kern, 10), timer.ms(plain, 5)
        ms_l = timer.ms(lib, 10)
        bms, by = bound_ms(nbytes, nops, torch.float64)
        say(f"[time] gram_block, the probe's {tag}: kernel {ms_k:.5f} ms, "
            f"plain {ms_p:.5f} ms, cuBLAS's product alone ("
            f"{'X @ X.T' if sym else 'Xq @ X.T'}) {ms_l:.5f} ms, bound "
            f"{bms:.5f} ms by {by}, share {bms / ms_k:.4f} (inputs warm in "
            f"the L2)")
    del feats, Xtr, Xte, probe, fused, params
    say(f"[lm] phase 15: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 16: dense LM training at full width
# ---------------------------------------------------------------------------

# (a) the launcher: 8 steps with a checkpoint every 4, then a resume to 12
TRAIN = dict(batch=8, seq=512, microbatches=2, steps=8, save_every=4,
             resume_to=12)
# (c) f32 with TF32 off: the fused SDPA backward against the math backend
# (the efficient kernel is the one fused backend that takes f32)
TRAIN_F32 = dict(batch=2, seq=256)
TRAIN_TOL = 1e-4
TRAIN_F32_FUSED = "EFFICIENT_ATTENTION"
# (d) run_resilient at 4 layers (full width and vocab), failures at 2, 5
RESILIENT = dict(layers=4, batch=4, seq=256, steps=8, save_every=3,
                 fail_at=(2, 5))
# (d) SDPA's backward called repeatedly at one layer's full-width shape
SDPA_REPEAT = dict(batch=4, heads=14, kv_heads=2, seq=512, head_dim=64,
                   calls=5)
# (b) bf16 against f32 gradients of the same weights, one microbatch
# (4 x 512): limits set from the first full-width reading (cosine
# 0.999764, norms 2.946923 and 2.942775, relative difference 0.001409;
# H100 80GB HBM3 at 700 W), about 4x and 7x its distance from exact
BF16_GRAD_COS = 0.999
BF16_GRAD_NORM_RDIFF = 0.01


def sdpa_kernels(prof) -> dict:
    """The SDPA kernels of a profiler window, by direction: the backend
    each ran on (``cudnn``, ``flash``, ``efficient``, or ``math`` when none
    of theirs ran) and the kernel names."""
    out = {"forward": [], "backward": []}
    for e in device_events(prof)[0]:
        k = e.key
        backend = ("cudnn" if "sdpa" in k and "cudnn" in k else
                   "flash" if "flash_fwd" in k or "flash_bwd" in k else
                   "efficient" if "fmha_cutlass" in k else None)
        if backend is None:
            continue
        bwd = any(s in k for s in ("bprop", "bwd", "cutlassB"))
        out["backward" if bwd else "forward"].append((backend, k[:80]))
    return out


def grads_of(cfg, params, batch, remat="full"):
    """The loss and its gradient leaves (``registry.loss_fn``) at
    ``params``."""
    from repro_torch.models import registry
    from repro_torch.tree import leaves, tree_map
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = registry.loss_fn(live, cfg, batch, remat=remat)
    return loss.detach(), torch.autograd.grad(loss, leaves(live))


@contextlib.contextmanager
def deterministic(mode="strict"):
    """PyTorch's deterministic algorithms in ``mode`` (``"off"``,
    ``"warn"``: on with ``warn_only``, ``"strict"``), restored after."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(mode != "off",
                                       warn_only=mode == "warn")
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])


def sdpa_repeatability(device):
    """Whether attention's backward is bitwise repeatable on the card, as
    the training step calls it (``layers.attention``: K and V repeated
    from ``kv_heads`` to the query heads, then SDPA with ``is_causal``):
    ``SDPA_REPEAT["calls"]`` forward and backward calls on the same
    inputs and cotangent, under each mode of :func:`deterministic`, in
    bf16 and f32, with each fused backend forced and by PyTorch's own
    choice.  Returns {(mode, dtype, backend): (bitwise, worst
    |difference| over out, dq, dk, dv, what ran)}, None where the backend
    refused the call.  What PyTorch chose is the forced backend whose
    forward output its own equals bitwise (the forwards are
    deterministic and differ between backends), else ``math``."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    import warnings
    from repro_torch.models import layers
    P = SDPA_REPEAT
    g = torch.Generator(device=device).manual_seed(7)
    B, S, D = P["batch"], P["seq"], P["head_dim"]
    pos = torch.arange(S, dtype=torch.int32, device=device)
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, do = (torch.randn((B, S, h, D), generator=g, device=device,
                                   dtype=dt)
                       for h in (P["heads"], P["kv_heads"], P["kv_heads"],
                                 P["heads"]))

        def call():
            a, b, c = (t.detach().requires_grad_(True) for t in (q, k, v))
            o = layers.attention(a, b, c, pos, pos, causal=True)
            return (o.detach(),) + torch.autograd.grad(o, (a, b, c), do)

        for mode in ("off", "warn", "strict"):
            fwd = {}
            for name in ("CUDNN_ATTENTION", "FLASH_ATTENTION",
                         "EFFICIENT_ATTENTION", "default"):
                forced = name != "default"
                key = (mode, str(dt).split(".")[1], name)
                try:
                    with warnings.catch_warnings(), deterministic(mode), \
                            (sdpa_kernel(getattr(SDPBackend, name)) if forced
                             else contextlib.nullcontext()):
                        warnings.simplefilter("ignore")
                        runs = [call() for _ in range(P["calls"])]
                except RuntimeError:
                    out[key] = None
                    continue
                first = runs[0]
                worst = max(float((a.float() - b.float()).abs().max())
                            for r in runs[1:] for a, b in zip(first, r))
                ran = name.split("_")[0].lower()
                if forced:
                    fwd[ran] = first[0]
                else:
                    ran = "/".join(b for b, o in fwd.items()
                                   if torch.equal(o, first[0])) or "math"
                out[key] = (worst == 0.0, worst, ran)
    return out


def phase_train(device):
    """Phase 16: ``qwen2-0.5b`` trained at full width from seeds; see the
    module docstring."""
    import io
    import tempfile
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import train
    from repro_torch.models import registry
    from repro_torch.runtime import FailureInjector, run_resilient
    from repro_torch.train.serve_step import _cast
    from repro_torch.train.train_step import init_state, make_train_step
    from repro_torch import kernels
    from repro_torch.tree import leaves, leaves_with_path
    t_phase = time.perf_counter()
    kernels.reset_launches()
    cfg = get_config(LM_ARCH)
    gb = 1e9
    T = TRAIN

    # (a) the launcher, then a resume
    def launch(steps, ckpt):
        buf = io.StringIO()
        argv = ["--batch", str(T["batch"]), "--seq", str(T["seq"]),
                "--microbatches", str(T["microbatches"]), "--steps",
                str(steps), "--save-every", str(T["save_every"]), "--ckpt",
                ckpt, "--device", str(device)]
        torch.cuda.reset_peak_memory_stats(device)
        with contextlib.redirect_stdout(buf):
            run, counts, wall = counted(lambda: train.main(argv))
        check_only(counts, {}, "lm train")
        for line in buf.getvalue().splitlines():
            say(f"[train] (a) | {line}")
        finite = all(math.isfinite(x) for x in run.losses + run.grad_norms)
        assert finite, (run.losses, run.grad_norms)
        return run, buf.getvalue(), wall, torch.cuda.max_memory_allocated(
            device)

    with tempfile.TemporaryDirectory() as ckpt:
        run, _, wall, peak = launch(T["steps"], ckpt)
        ms = [s * 1e3 for s in run.step_s[2:]]
        ms_step = float(np.median(ms))
        tokens = T["batch"] * T["seq"]
        say(f"[train] (a) launch.train bf16, batch {T['batch']}, seq "
            f"{T['seq']}, microbatches {T['microbatches']}: {T['steps']} "
            f"steps in {wall:.3f} s; ms a step (steps 2-{T['steps'] - 1}) "
            f"{', '.join(f'{m:.3f}' for m in ms)}, median {ms_step:.3f}; "
            f"{tokens * 1e3 / ms_step:.1f} tokens/s; peak {peak / gb:.3f} "
            f"GB; losses {', '.join(f'{x:.4f}' for x in run.losses)}; "
            f"grad norms {', '.join(f'{x:.4f}' for x in run.grad_norms)}; "
            f"no kernel of the port launched")
        p0 = registry.init_params(0, cfg, torch.bfloat16, device=device)
        unchanged = [p for (p, a), b in zip(
            leaves_with_path(run.state.params), leaves(p0))
            if torch.equal(a, b)]
        assert not unchanged, f"parameters unchanged by training: {unchanged}"
        idle = [p for p, m in leaves_with_path(run.state.opt)
                if p != "step" and not bool(m.abs().max() > 0)]
        assert not idle, f"optimizer moments still zero: {idle}"
        say(f"[train] (a) every parameter leaf changed; every moment "
            f"nonzero; optimizer step {int(run.state.opt.step)}")
        del p0, run
        run, out, wall, peak2 = launch(T["resume_to"], ckpt)
        assert f"resumed from step {T['steps']}" in out, out
        assert run.start == T["steps"] and len(run.losses) == \
            T["resume_to"] - T["steps"]
        say(f"[train] (a) resumed from step {run.start}: "
            f"{len(run.losses)} steps in {wall:.3f} s (restore and saves "
            f"included), peak {peak2 / gb:.3f} GB")

    # one step under the profiler: the SDPA backend of both directions
    tc = dataclasses.replace(train.TrainConfig(), seq_len=T["seq"],
                             global_batch=T["batch"],
                             microbatches=T["microbatches"],
                             accum_dtype="float32", remat="full")
    step_fn = make_train_step(cfg, tc)
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=T["seq"],
                           global_batch=T["batch"])
    batch = train.batch_at(data, cfg, T["resume_to"], device)
    state = run.state
    del run
    torch.cuda.synchronize(device)
    # the card's kernels only (a CPU rehearsal records its ops)
    with profile(activities=[ProfilerActivity.CUDA if device.type == "cuda"
                             else ProfilerActivity.CPU]) as prof:
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize(device)
    sd = sdpa_kernels(prof)
    kern, _ = device_events(prof)
    busy = sum(e.device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.device_time_total)[:6]
    say(f"[train] (a) done at {time.perf_counter() - t_phase:.1f} s; "
        f"profiler, one step: {sum(e.count for e in kern)} "
        f"kernels, {busy:.3f} ms of device time; SDPA forward "
        f"{sorted(set(sd['forward']))}, backward "
        f"{sorted(set(sd['backward']))}; top kernels "
        + "; ".join(f"{e.key[:60]} {e.device_time_total / 1e3:.3f} ms "
                    f"x{e.count}" for e in top))
    for d in ("forward", "backward"):
        assert sd[d], f"no fused SDPA kernel in the {d}: the math backend"
    del state, batch, prof

    # (b) bf16 against f32 gradients, same weights, one microbatch
    mb = T["batch"] // T["microbatches"]
    params32 = registry.init_params(2, cfg, torch.float32, device=device)
    b = {k: v[:mb] for k, v in train.batch_at(data, cfg, 0, device).items()}
    l32, g32 = grads_of(cfg, params32, b)
    l16, g16 = grads_of(cfg, _cast(params32, torch.bfloat16), b)
    f32 = torch.cat([g.flatten() for g in g32])
    f16 = torch.cat([g.float().flatten() for g in g16])
    cos = float(torch.dot(f16, f32) / (f16.norm() * f32.norm()))
    rdiff = abs(float(f16.norm() / f32.norm()) - 1.0)
    say(f"[train] (b) at {time.perf_counter() - t_phase:.1f} s: bf16 "
        f"against f32 gradients of the same weights, "
        f"batch {mb} x {T['seq']}: losses {float(l16):.6f}, "
        f"{float(l32):.6f}; cosine {cos:.6f} (limit {BF16_GRAD_COS}), "
        f"norms {float(f16.norm()):.6f}, {float(f32.norm()):.6f}, relative "
        f"difference {rdiff:.6f} (limit {BF16_GRAD_NORM_RDIFF})")
    assert cos >= BF16_GRAD_COS, cos
    assert rdiff <= BF16_GRAD_NORM_RDIFF, rdiff
    del g32, g16, f32, f16

    # (c) f32, TF32 off: the fused SDPA backward against the math backend
    assert not torch.backends.cuda.matmul.allow_tf32
    B, S = TRAIN_F32["batch"], TRAIN_F32["seq"]
    bc = {k: v[:B, :S] for k, v in b.items()}
    with sdpa_kernel(getattr(SDPBackend, TRAIN_F32_FUSED)):
        _, fused = grads_of(cfg, params32, bc)
    with sdpa_kernel(SDPBackend.MATH):
        _, plain = grads_of(cfg, params32, bc)
    worst, where = 0.0, ""
    for (path, _), a, w in zip(leaves_with_path(params32), fused, plain):
        r = float(((a - w).abs() / (TRAIN_TOL + TRAIN_TOL * w.abs())).max())
        if r >= worst:
            worst, where = r, path
    say(f"[train] (c) at {time.perf_counter() - t_phase:.1f} s: f32 "
        f"gradients, batch {B} x {S}: SDPA's {TRAIN_F32_FUSED} "
        f"backend against the math backend, every leaf: worst |a - b| / "
        f"(atol + rtol |b|) {worst:.4f} at {where} (rtol = atol = "
        f"{TRAIN_TOL})")
    assert worst <= 1.0, (worst, where)
    del params32, fused, plain, b, bc

    # (d) SDPA's backward repeated: the reason (d) runs deterministic
    # algorithms
    rep = sdpa_repeatability(device)
    Q = SDPA_REPEAT
    for mode, dt in dict.fromkeys(k[:2] for k in rep):
        say(f"[train] (d) attention's backward, {Q['calls']} calls of "
            f"batch {Q['batch']} x {Q['seq']}, {Q['heads']} heads over "
            f"{Q['kv_heads']} KV heads, {dt}, deterministic algorithms "
            f"{mode}: " + "; ".join(
                f"{name}: " + ("refused" if r is None else
                               f"bitwise {r[0]}, worst {r[1]:.3e}, ran "
                               f"{r[2]}")
                for (m, d, name), r in rep.items() if (m, d) == (mode, dt)))
    for dt in ("bfloat16", "float32"):
        assert rep[("strict", dt, "default")][0], rep
    del rep

    # (d) run_resilient against an uninterrupted run, bitwise
    R = RESILIENT
    cfg4 = dataclasses.replace(cfg, n_layers=R["layers"])
    tc4 = dataclasses.replace(tc, microbatches=1, global_batch=R["batch"],
                              seq_len=R["seq"])
    data4 = SyntheticTokens(vocab=cfg.vocab, seq_len=R["seq"],
                            global_batch=R["batch"])
    step4 = make_train_step(cfg4, tc4)

    def batch4(s):
        return train.batch_at(data4, cfg4, s, device)

    with deterministic():
        state0 = init_state(0, cfg4, tc4, device=device)
        ref = state0
        for s in range(R["steps"]):
            ref, _ = step4(ref, batch4(s))
        inj = FailureInjector(fail_at=R["fail_at"])
        with tempfile.TemporaryDirectory() as ck:
            t0 = time.perf_counter()
            final = run_resilient(step4, state0, batch4, R["steps"], ck,
                                  save_every=R["save_every"], injector=inj)
            torch.cuda.synchronize(device)
            t_res = time.perf_counter() - t0
    assert inj.fired == set(R["fail_at"]), inj.fired
    diff = [p for (p, a), b in zip(leaves_with_path(ref), leaves(final))
            if not torch.equal(a, b)]
    say(f"[train] (d) at {time.perf_counter() - t_phase:.1f} s: "
        f"run_resilient, {R['layers']} layers, batch "
        f"{R['batch']} x {R['seq']}, {R['steps']} steps, save every "
        f"{R['save_every']}, failures at {R['fail_at']}: {t_res:.3f} s; "
        f"leaves differing from the uninterrupted run: {diff or 'none'} "
        f"(deterministic algorithms on)")
    assert not diff, diff
    del state0, ref, final
    check_only(kernels.launches(), {}, "phase 16")
    say(f"[train] phase 16: {time.perf_counter() - t_phase:.1f} s; no "
        f"kernel of the port launched in it")


# ---------------------------------------------------------------------------
# phase 17: the MoE family, mixtral-8x7b at full width and 2 layers
# ---------------------------------------------------------------------------

MOE_ARCH = "mixtral-8x7b"
# at its 32 layers the model is about 90 GB in bf16 and fits no card; at 2
# it is about 3.2 G parameters, 6.3 GB in bf16
MOE_LAYERS = 2
# (b) bf16 serving at the config's capacity factor 1.25 (160 slots an
# expert at S = 512)
MOE_SERVE = dict(batch=8, prompt=512, new=32)
# (c) f32 with capacity factor 8, so that nothing drops: prefill +
# teacher-forced decode against the full forward, then bf16 against f32
MOE_F32 = dict(batch=2, prompt=256, extra=8, capacity_factor=8.0)
# (d) bf16 parameters and compute, an f32 accumulator, Adafactor
MOE_TRAIN = dict(batch=4, seq=512, microbatches=2, steps=4)


def moe_drop_share(p, cfg, x) -> float:
    """The share of the (token, k) picks of ``moe.moe_apply(p, cfg, x)``
    that the capacity cut drops."""
    from repro_torch.models import moe
    _, _, idx = moe.route(p, cfg, x)
    B, S, K = idx.shape
    onehot = torch.nn.functional.one_hot(idx, cfg.n_experts).reshape(
        B, S * K, -1)
    pos = (torch.cumsum(onehot, 1) - onehot).reshape(B, S, K, -1)
    slot = torch.take_along_dim(pos, idx[..., None], dim=-1)
    return float((slot >= moe.capacity(cfg, S)).double().mean())


@contextlib.contextmanager
def moe_spy(fn):
    """``fn(p, cfg, x)`` on the arguments of every ``moe.moe_apply`` call
    (one a layer, in order) while the context is open."""
    from repro_torch.models import moe
    orig = moe.moe_apply

    def spy(p, cfg, x):
        fn(p, cfg, x)
        return orig(p, cfg, x)

    moe.moe_apply = spy
    try:
        yield
    finally:
        moe.moe_apply = orig


def phase_moe(device):
    """Phase 17: ``mixtral-8x7b`` at full width and ``MOE_LAYERS`` layers
    from seeds, served and trained; see the module docstring."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import train
    from repro_torch.models import moe, registry
    from repro_torch.train.serve_step import (_cast, greedy_prefill,
                                              make_prefill)
    from repro_torch.train.train_step import init_state, make_train_step
    from repro_torch.tree import leaves, leaves_with_path
    t_phase = time.perf_counter()
    kernels.reset_launches()
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    gb = 1e9

    # (a) parameters in bf16 on the card
    torch.cuda.reset_peak_memory_stats(device)
    params = registry.init_params(0, cfg, torch.bfloat16, device=device)
    torch.cuda.synchronize(device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    peak = torch.cuda.max_memory_allocated(device)
    say(f"[moe] (a) {cfg.name} at {cfg.n_layers} of 32 layers: {n_params} "
        f"parameters (cfg.param_count() {cfg.param_count()} + {cfg.d_model} "
        f"for the final norm), d_model {cfg.d_model}, {cfg.n_heads} heads, "
        f"{cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}, {cfg.n_experts} "
        f"experts, top-{cfg.top_k}, window {cfg.sliding_window}, vocab "
        f"{cfg.vocab}; bf16, {n_params * 2 / gb:.3f} GB, peak "
        f"{peak / gb:.3f} GB")
    assert n_params == cfg.param_count() + cfg.d_model

    # (b) greedy serving in bf16, twice
    B, S, new = MOE_SERVE["batch"], MOE_SERVE["prompt"], MOE_SERVE["new"]
    prompt, sc, walls, peak, gen = serve_twice(cfg, params, B, S, new,
                                               device, "moe serve")
    prefill = make_prefill(cfg, sc)
    t_pre, _ = prefill_ms(prefill, params, prompt, device)
    ms_pre = min(t_pre)
    ms_tok = (min(walls) * 1e3 - ms_pre) / (new - 1)
    say(f"[moe] (b) greedy_generate bf16, batch {B}, prompt {S}, {new} new "
        f"tokens: walls {walls[0]:.4f} s, {walls[1]:.4f} s (tokens bitwise "
        f"equal); prefill alone {ms_pre:.3f} ms (min of "
        f"{', '.join(f'{t:.3f}' for t in t_pre)}); decode {ms_tok:.3f} ms a "
        f"step of {B} tokens; {B * new / min(walls):.1f} tokens/s end to "
        f"end, {B * 1e3 / ms_tok:.1f} tokens/s decoding; peak "
        f"{peak / gb:.3f} GB; first sequence {gen[0, :12].tolist()}")
    shares = []
    with moe_spy(lambda p, c, x: shares.append(moe_drop_share(p, c, x))):
        prefill(params, prompt)
    assert len(shares) == cfg.n_layers
    p16, cache, tok = greedy_prefill(cfg, sc, params, prompt, device=device)
    n_ops = decode_ops(cfg, p16, cache, tok, S)
    say(f"[moe] (b) capacity {moe.capacity(cfg, S)} slots an expert at "
        f"S = {S} (capacity factor {cfg.capacity_factor}): share of "
        f"(token, k) picks the prefill dropped, by layer "
        f"{', '.join(f'{x:.4f}' for x in shares)}; one decode step "
        f"dispatches {n_ops} aten ops (views included), "
        f"{ms_tok * 1e3 / n_ops:.1f} us of the step each")
    del params, p16, cache, tok

    # (c) f32, TF32 off, nothing dropped: prefill + decode against the full
    # forward; then the same weights in bf16 against f32
    assert not torch.backends.cuda.matmul.allow_tf32
    F = MOE_F32
    cfg8 = dataclasses.replace(cfg, capacity_factor=F["capacity_factor"])
    torch.cuda.reset_peak_memory_stats(device)
    params32 = registry.init_params(1, cfg8, torch.float32, device=device)
    _, batch = lm_decode_check(cfg8, params32, F["batch"], F["prompt"],
                               F["extra"], device, f"capacity factor "
                               f"{F['capacity_factor']} (no drop)", "moe")
    picks = {"f32": [], "bf16": []}

    def rec(key):
        return lambda p, c, x: picks[key].append(moe.route(p, c, x)[2])

    with moe_spy(rec("f32")):
        full, _ = registry.forward_logits(params32, cfg8, batch)
    params16 = _cast(params32, torch.bfloat16)
    del params32
    with moe_spy(rec("bf16")):
        bf, _ = registry.forward_logits(params16, cfg8, batch)
    agree = [float((a[..., :, None] == b[..., None, :]).any(-1)
                   .double().mean())
             for a, b in zip(picks["f32"], picks["bf16"])]
    say(f"[moe] (c) routing of the bf16 forward against the f32 one, "
        f"{tuple(picks['f32'][0].shape)} picks a layer: share of (token, "
        f"k) picks whose expert the f32 forward also picked, by layer "
        f"{', '.join(f'{x:.4f}' for x in agree)}")
    bf16_agrees(bf, full, f"(c) forward_logits, capacity factor "
                f"{F['capacity_factor']}", "moe", max_diff=None)
    say(f"[moe] (c) peak {torch.cuda.max_memory_allocated(device) / gb:.3f} "
        f"GB (f32 weights, then bf16)")
    del params16, full, bf, batch, picks

    # (d) training: bf16, f32 accumulator, Adafactor, remat="full"
    T = MOE_TRAIN
    tc = TrainConfig(seq_len=T["seq"], global_batch=T["batch"],
                     microbatches=T["microbatches"], param_dtype="bfloat16",
                     compute_dtype="bfloat16", accum_dtype="float32",
                     accum_mode="outside", remat="full",
                     optimizer="adafactor")
    torch.cuda.reset_peak_memory_stats(device)
    state = init_state(0, cfg, tc, device=device)
    p0 = state.params
    step_fn = make_train_step(cfg, tc)
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=T["seq"],
                           global_batch=T["batch"])
    rows = []
    for s in range(T["steps"]):
        batch = train.batch_at(data, cfg, s, device)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize(device)
        rows.append(((time.perf_counter() - t0) * 1e3, float(m["loss"]),
                     float(m["aux"]), float(m["grad_norm"])))
    peak = torch.cuda.max_memory_allocated(device)
    ms = float(np.median([r[0] for r in rows[1:]]))
    say(f"[moe] (d) {T['steps']} training steps, bf16 with an f32 "
        f"accumulator, Adafactor, remat full, batch {T['batch']} x "
        f"{T['seq']} in {T['microbatches']} microbatches: ms a step "
        f"{', '.join(f'{r[0]:.3f}' for r in rows)} (median of steps 1-"
        f"{T['steps'] - 1} {ms:.3f}); {T['batch'] * T['seq'] * 1e3 / ms:.1f}"
        f" tokens/s; peak {peak / gb:.3f} GB; losses "
        f"{', '.join(f'{r[1]:.4f}' for r in rows)}; aux "
        f"{', '.join(f'{r[2]:.4f}' for r in rows)} (top_k {cfg.top_k} when "
        f"balanced); grad norms {', '.join(f'{r[3]:.4f}' for r in rows)}")
    assert all(math.isfinite(x) for r in rows for x in r[1:]), rows
    unchanged = [p for (p, a), b in zip(leaves_with_path(state.params),
                                        leaves(p0)) if torch.equal(a, b)]
    assert not unchanged, f"parameters unchanged by training: {unchanged}"
    del p0
    mb = {k: v[:T["batch"] // T["microbatches"]] for k, v in batch.items()}
    _, grads = grads_of(cfg, state.params, mb)
    gw = dict(zip([p for p, _ in leaves_with_path(state.params)],
                  grads))["blocks/moe/w_gate"]
    per_expert = gw.float().abs().amax(dim=(2, 3))         # (layers, E)
    say(f"[moe] (d) every parameter leaf changed; max |grad w_gate| by "
        f"(layer, expert) on one microbatch "
        f"{[[f'{x:.3e}' for x in row] for row in per_expert.tolist()]}")
    assert bool((per_expert > 0).all()), per_expert
    del state, grads, gw, batch, mb
    check_only(kernels.launches(), {}, "phase 17")
    say(f"[moe] phase 17: {time.perf_counter() - t_phase:.1f} s; no kernel "
        f"of the port launched in it")


# ---------------------------------------------------------------------------
# phase 18: the Mamba2 SSM family, mamba2-370m at full width and depth
# ---------------------------------------------------------------------------

SSM_ARCH = "mamba2-370m"
# (b) bf16 serving: a 512-token prompt is two of the config's 256-step
# chunks
SSM_SERVE = dict(batch=8, prompt=512, new=64)
SSM_F32 = dict(batch=2, prompt=256, extra=8)
# (c) ssd_chunked at the model's head shapes (32 heads of 64, state 128,
# two chunks of 256) against the per-step recurrence in f64
SSD_CHECK = dict(batch=2, seq=512)
SSD_TOL = 1e-4
# (c) bf16 against f32 logits of the same weights.  The dense family's
# limits (0.2, 0.9) do not hold for this model at 48 layers: its first
# full-width reading gave max |diff| 0.2559 and top-1 0.8390 (H100 80GB
# HBM3 at 700 W) with every decay in f32; the drift grows with the depth
# of bf16 weights and activations.  These limits are about 2x and 1.5x
# that reading's distance from exact.
SSM_BF16_MAX_DIFF = 0.5
SSM_BF16_TOP1 = 0.75
# (d) the launcher: bf16, AdamW, 8 x 512 in 2 microbatches
SSM_TRAIN = dict(batch=8, seq=512, microbatches=2, steps=4)


def ssm_param_total(cfg) -> int:
    """The parameters of ``models.ssm`` at ``cfg`` (``cfg.param_count()``
    is an approximation that leaves out ``w_dt``, ``A_log``, ``D``, the
    norms and the conv's B and C channels)."""
    d, V, K = cfg.d_model, cfg.vocab, cfg.conv_kernel
    din = cfg.ssm_expand * d
    H, N = din // cfg.ssm_head_dim, cfg.ssm_state
    ch = din + 2 * N
    block = d + d * din + d * ch + d * H + 3 * H + K * ch + ch + din + din * d
    return V * d * (1 if cfg.tie_embeddings else 2) + cfg.n_layers * block + d


def ssd_against_recurrence(cfg, device):
    """``ssd_chunked`` at the model's head shapes in f32 against the
    per-step recurrence in f64 on the card: (max |y err|, max |h err|,
    worst err / (atol + rtol |b|))."""
    from repro_torch.models import ssm
    din, H, P, N = ssm._dims(cfg)
    B, S = SSD_CHECK["batch"], SSD_CHECK["seq"]
    g = torch.Generator(device=device).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device)

    # dt log-uniform in [1e-3, 1e-1] as at init, A = -(1..H)
    dt = torch.exp(torch.rand((B, S, H), generator=g, device=device)
                   * math.log(100.0) + math.log(1e-3))
    dA = dt * -torch.arange(1, H + 1, dtype=torch.float32, device=device)
    xdt = normal(B, S, H, P) * dt[..., None]
    Bm, Cm = normal(B, S, N), normal(B, S, N)
    y, h = ssm.ssd_chunked(xdt, dA, Bm, Cm, cfg.ssm_chunk)
    x64, a64, b64, c64 = (t.double() for t in (xdt, dA, Bm, Cm))
    hr = torch.zeros((B, H, P, N), dtype=torch.float64, device=device)
    ys = []
    for t in range(S):
        hr = (hr * torch.exp(a64[:, t])[..., None, None]
              + x64[:, t, :, :, None] * b64[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", hr, c64[:, t]))
    yr = torch.stack(ys, 1)
    worst = max(float(((a.double() - b).abs()
                       / (SSD_TOL + SSD_TOL * b.abs())).max())
                for a, b in ((y, yr), (h, hr)))
    return (float((y.double() - yr).abs().max()),
            float((h.double() - hr).abs().max()), worst)


def phase_ssm(device):
    """Phase 18: ``mamba2-370m`` at full width and depth from seeds, served
    and trained; see the module docstring."""
    import io
    import tempfile
    from repro_torch import kernels
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import train
    from repro_torch.models import registry
    from repro_torch.train import optimizer
    from repro_torch.train.serve_step import (_cast, greedy_prefill,
                                              make_prefill)
    from repro_torch.tree import leaves, leaves_with_path
    t_phase = time.perf_counter()
    kernels.reset_launches()
    cfg = get_config(SSM_ARCH)
    gb = 1e9

    # (a) parameters in bf16 on the card
    torch.cuda.reset_peak_memory_stats(device)
    params = registry.init_params(0, cfg, torch.bfloat16, device=device)
    torch.cuda.synchronize(device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    peak = torch.cuda.max_memory_allocated(device)
    say(f"[ssm] (a) {cfg.name}: {n_params} parameters (cfg.param_count() "
        f"{cfg.param_count()}, an approximation), {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, "
        f"{cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim} heads of "
        f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
        f"{cfg.ssm_chunk}, vocab {cfg.vocab}, tied; bf16, peak "
        f"{peak / gb:.3f} GB")
    assert n_params == ssm_param_total(cfg), (n_params, ssm_param_total(cfg))

    # (b) greedy serving in bf16, twice
    B, S, new = SSM_SERVE["batch"], SSM_SERVE["prompt"], SSM_SERVE["new"]
    prompt, sc, walls, peak, gen = serve_twice(cfg, params, B, S, new,
                                               device, "ssm serve")
    t_pre, _ = prefill_ms(make_prefill(cfg, sc), params, prompt, device)
    ms_pre = min(t_pre)
    ms_tok = (min(walls) * 1e3 - ms_pre) / (new - 1)
    p16, cache, tok = greedy_prefill(cfg, sc, params, prompt, device=device)
    state_gb = (cache.h.numel() * 4 + cache.conv.numel() * 2) / gb
    n_ops = decode_ops(cfg, p16, cache, tok, S)
    say(f"[ssm] (b) greedy_generate bf16, batch {B}, prompt {S} (two "
        f"chunks), {new} new tokens: walls {walls[0]:.4f} s, "
        f"{walls[1]:.4f} s (tokens bitwise equal); prefill alone "
        f"{ms_pre:.3f} ms (min of {', '.join(f'{t:.3f}' for t in t_pre)}); "
        f"decode {ms_tok:.3f} ms a step of {B} tokens; "
        f"{B * new / min(walls):.1f} tokens/s end to end, "
        f"{B * 1e3 / ms_tok:.1f} tokens/s decoding; decode state "
        f"{state_gb:.3f} GB (h {tuple(cache.h.shape)} f32, conv ring "
        f"{tuple(cache.conv.shape)} bf16); peak {peak / gb:.3f} GB; one "
        f"decode step dispatches {n_ops} aten ops, "
        f"{ms_tok * 1e3 / n_ops:.1f} us of the step each; first sequence "
        f"{gen[0, :12].tolist()}")
    del params, p16, cache, tok

    # (c) f32, TF32 off: prefill + decode against the full forward, the
    # scan against the recurrence, bf16 against f32
    assert not torch.backends.cuda.matmul.allow_tf32
    F = SSM_F32
    torch.cuda.reset_peak_memory_stats(device)
    params32 = registry.init_params(1, cfg, torch.float32, device=device)
    full, batch = lm_decode_check(cfg, params32, F["batch"], F["prompt"],
                                  F["extra"], device, "the SSD state and "
                                  "conv ring", "ssm")
    y_err, h_err, worst = ssd_against_recurrence(cfg, device)
    din = cfg.ssm_expand * cfg.d_model
    say(f"[ssm] (c) ssd_chunked f32, batch {SSD_CHECK['batch']} x "
        f"{SSD_CHECK['seq']} ({SSD_CHECK['seq'] // cfg.ssm_chunk} chunks), "
        f"{din // cfg.ssm_head_dim} heads of {cfg.ssm_head_dim}, state "
        f"{cfg.ssm_state}, dt log-uniform in [1e-3, 1e-1], A = "
        f"-(1..{din // cfg.ssm_head_dim}), "
        f"against the per-step recurrence in f64: max abs err y "
        f"{y_err:.3e}, final state {h_err:.3e}; worst err / (atol + rtol "
        f"|b|) {worst:.4f} (rtol = atol = {SSD_TOL})")
    assert worst <= 1.0, worst
    bf, _ = registry.forward_logits(_cast(params32, torch.bfloat16), cfg,
                                    batch)
    bf16_agrees(bf, full, "(c) forward_logits", "ssm",
                max_diff=SSM_BF16_MAX_DIFF, min_top1=SSM_BF16_TOP1)
    say(f"[ssm] (c) peak {torch.cuda.max_memory_allocated(device) / gb:.3f} "
        f"GB (f32 weights, then bf16)")
    del params32, full, bf, batch

    # (d) the training launcher: bf16, AdamW, one save after the last step
    T = SSM_TRAIN
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as ckpt:
        argv = ["--arch", SSM_ARCH, "--batch", str(T["batch"]), "--seq",
                str(T["seq"]), "--microbatches", str(T["microbatches"]),
                "--steps", str(T["steps"]), "--ckpt", ckpt, "--device",
                str(device)]
        torch.cuda.reset_peak_memory_stats(device)
        with contextlib.redirect_stdout(buf):
            run, counts, wall = counted(lambda: train.main(argv))
        check_only(counts, {}, "ssm train")
        peak = torch.cuda.max_memory_allocated(device)
    for line in buf.getvalue().splitlines():
        say(f"[ssm] (d) | {line}")
    assert all(math.isfinite(x) for x in run.losses + run.grad_norms), \
        (run.losses, run.grad_norms)
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        save_checkpoint(ckpt, T["steps"], run.state)
        t_save = time.perf_counter() - t0
    ms = [s * 1e3 for s in run.step_s]
    ms_step = float(np.median(ms[1:]))
    state_gb = sum(t.numel() * t.element_size()
                   for t in tree_leaves(run.state)) / gb
    say(f"[ssm] (d) launch.train bf16, AdamW, batch {T['batch']} x "
        f"{T['seq']} in {T['microbatches']} microbatches: {T['steps']} "
        f"steps in {wall:.3f} s; ms a step {', '.join(f'{m:.3f}' for m in ms)}"
        f" (median of steps 1-{T['steps'] - 1} {ms_step:.3f}); "
        f"{T['batch'] * T['seq'] * 1e3 / ms_step:.1f} tokens/s; peak "
        f"{peak / gb:.3f} GB; the final state ({state_gb:.3f} GB) saved "
        f"apart in {t_save:.3f} s; losses "
        f"{', '.join(f'{x:.4f}' for x in run.losses)}; grad norms "
        f"{', '.join(f'{x:.4f}' for x in run.grad_norms)}")
    idle = [p for p, m in leaves_with_path(run.state.opt) if p != "step"
            and not (bool(torch.isfinite(m).all())
                     and bool(m.abs().max() > 0))]
    assert not idle, f"moments zero or not finite: {idle}"
    # a leaf can keep its bf16 value only where the warmup's summed
    # learning rate (AdamW's step is about lr an element) stays far below
    # half its bf16 spacing (at least |p| / 512) at every element
    tc = TrainConfig()
    lr_sum = sum(float(optimizer.lr_schedule(tc, torch.tensor(s)))
                 for s in range(T["steps"]))
    p0 = dict(leaves_with_path(registry.init_params(0, cfg, torch.bfloat16,
                                                    device=device)))
    still = {p: float(p0[p].float().abs().min()) for p, a in
             leaves_with_path(run.state.params) if torch.equal(a, p0[p])}
    say(f"[ssm] (d) every moment finite and nonzero; leaves whose bf16 "
        f"values training left as they were (smallest |p|; summed lr "
        f"{lr_sum:.3e}): {still or 'none'}")
    for path, smallest in still.items():
        assert smallest / 512 > 10 * lr_sum, (path, smallest, lr_sum)
    del run, p0
    check_only(kernels.launches(), {}, "phase 18")
    say(f"[ssm] phase 18: {time.perf_counter() - t_phase:.1f} s; no kernel "
        f"of the port launched in it")


# ---------------------------------------------------------------------------
# phase 19: the hybrid family, recurrentgemma-2b at full width and depth
# ---------------------------------------------------------------------------

HYBRID_ARCH = "recurrentgemma-2b"
# 2894574080 parameters: the tied embedding 655.36 M, a recurrent block
# 91.776 M, an attention block 73.40544 M (8 triples and a tail of 2)
HYBRID_PARAMS = 2894574080
# (b) bf16 serving
HYBRID_SERVE = dict(batch=8, prompt=512, new=32)
# (c) f32, batch 1: a 2040-token prompt and 16 decode steps, so positions
# 2048-2055 wrap the 2048-slot attention ring
HYBRID_F32 = dict(batch=1, prompt=2040, extra=16)
# (c) bf16 against f32 logits of the same weights.  The dense family's
# limits (0.2, 0.9) do not hold for this model: its first full-width
# reading gave max |diff| 0.3211 and top-1 0.8672 (H100 80GB HBM3 at
# 700 W).  The reference drifts as far in bf16 (on the CPU at the smoke
# widths and 8 layers its bf16 logits lie 0.038 from its f32 ones, the
# port's 0.032, qwen2's 0.008).  These limits are about 2x and 1.5x that
# reading's distance from exact, as phase 18's are.
HYBRID_BF16_MAX_DIFF = 0.65
HYBRID_BF16_TOP1 = 0.8
# (d) the RG-LRU scan at the model's width against the per-step
# recurrence in f64, at the reference oracle's bound
RGLRU_CHECK = dict(batch=8, seq=512)
RGLRU_TOL = 2e-4
# (e) bf16 parameters and compute, an f32 accumulator, Adafactor, at full
# depth (the reckoning: about 46 GB)
HYBRID_TRAIN = dict(batch=4, seq=512, microbatches=2, steps=4)


def rglru_against_recurrence(cfg, device):
    """``rglru._rglru`` at (``RGLRU_CHECK``, the recurrence width) in f32
    against the per-step recurrence in f64 on the card, Lambda drawn as
    the model draws it, gates uniform in (0, 1), inputs normal: (max |y
    err|, max |h err|, worst err / (atol + rtol |b|), and that worst ratio
    of ``_associative_scan`` alone: its f32 prefixes of ``_rglru``'s own
    f32 a and b against the f64 recurrence of the same a and b)."""
    from repro_torch.models import rglru
    B, S = RGLRU_CHECK["batch"], RGLRU_CHECK["seq"]
    w = cfg.rglru_width or cfg.d_model
    g = torch.Generator(device=device).manual_seed(0)
    u = torch.empty((w,), device=device).uniform_(0.9, 0.999, generator=g)
    lam = torch.log(torch.expm1(-torch.log(u) / 8.0))
    xb = torch.randn((B, S, w), generator=g, device=device)
    r = torch.rand((B, S, w), generator=g, device=device)
    i = torch.rand((B, S, w), generator=g, device=device)
    y, h = rglru._rglru(xb, r, i, lam)

    def recurrence(a, b):
        hr = torch.zeros((B, w), dtype=torch.float64, device=device)
        ys = []
        for t in range(S):
            hr = a[:, t] * hr + b[:, t]
            ys.append(hr)
        return torch.stack(ys, 1)

    def ratio(p, q):
        return float(((p.double() - q).abs()
                      / (RGLRU_TOL + RGLRU_TOL * q.abs())).max())

    log_a = -8.0 * torch.nn.functional.softplus(lam.double()) * r.double()
    yr = recurrence(torch.exp(log_a), torch.sqrt(1 - torch.exp(2 * log_a))
                    * i.double() * xb.double())
    worst = max(ratio(y, yr), ratio(h, yr[:, -1]))
    # the recursion alone, on the f32 a and b that _rglru computes
    la32 = -8.0 * torch.nn.functional.softplus(lam) * r
    a32 = torch.exp(la32)
    b32 = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * la32), 1e-12)) \
        * (i * xb)
    scan_worst = ratio(rglru._associative_scan(a32, b32)[1],
                       recurrence(a32.double(), b32.double()))
    return (float((y.double() - yr).abs().max()),
            float((h.double() - yr[:, -1]).abs().max()), worst, scan_worst)


def shape_total(shapes) -> int:
    """The parameters of a ``param_shapes`` tree (NamedTuples whose leaves
    are shape tuples, ``None`` where a leaf is absent)."""
    if shapes is None:
        return 0
    if hasattr(shapes, "_fields"):
        return sum(shape_total(s) for s in shapes)
    return math.prod(shapes)


def lm_serve_lines(tag, cfg, params, spec, device, shape_text):
    """(b) for phases 19 and 20: greedy bf16 serving twice, the prefill
    timed alone, the aten ops of one decode step; prints the line and
    returns nothing."""
    from repro_torch.train.serve_step import greedy_prefill, make_prefill
    B, S, new = spec["batch"], spec["prompt"], spec["new"]
    prompt, sc, walls, peak, gen = serve_twice(cfg, params, B, S, new,
                                               device, f"{tag} serve")
    t_pre, _ = prefill_ms(make_prefill(cfg, sc), params, prompt, device)
    ms_pre = min(t_pre)
    ms_tok = (min(walls) * 1e3 - ms_pre) / (new - 1)
    p16, cache, tok = greedy_prefill(cfg, sc, params, prompt, device=device)
    n_ops = decode_ops(cfg, p16, cache, tok, S)
    cache_gb = sum(t.numel() * t.element_size()
                   for t in tree_leaves(cache)) / 1e9
    say(f"[{tag}] (b) greedy_generate bf16, batch {B}, {shape_text}, {new} "
        f"new tokens: walls {walls[0]:.4f} s, {walls[1]:.4f} s (tokens "
        f"bitwise equal); prefill alone {ms_pre:.3f} ms (min of "
        f"{', '.join(f'{t:.3f}' for t in t_pre)}); decode {ms_tok:.3f} ms a "
        f"step of {B} tokens; {B * new / min(walls):.1f} tokens/s end to "
        f"end, {B * 1e3 / ms_tok:.1f} tokens/s decoding; decode cache "
        f"{cache_gb:.4f} GB; peak {peak / 1e9:.3f} GB; one decode step "
        f"dispatches {n_ops} aten ops, {ms_tok * 1e3 / n_ops:.1f} us of the "
        f"step each; first sequence {gen[0, :12].tolist()}")


def unchanged_leaves(tag, tc, steps, p0, params):
    """Every parameter leaf training left as it was must be one whose
    bf16 spacing (at least |p| / 512) stays far above the warmup's summed
    learning rate at every element; prints them."""
    from repro_torch.train import optimizer
    from repro_torch.tree import leaves_with_path
    lr_sum = sum(float(optimizer.lr_schedule(tc, torch.tensor(s)))
                 for s in range(steps))
    p0 = dict(leaves_with_path(p0))
    still = {p: float(p0[p].float().abs().min()) for p, a in
             leaves_with_path(params) if torch.equal(a, p0[p])}
    say(f"[{tag}] leaves whose bf16 values training left as they were "
        f"(smallest |p|; summed lr {lr_sum:.3e}): {still or 'none'}")
    for path, smallest in still.items():
        assert smallest / 512 > 10 * lr_sum, (path, smallest, lr_sum)


def phase_hybrid(device):
    """Phase 19: ``recurrentgemma-2b`` at full width and depth from seeds,
    served and trained; see the module docstring."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import train
    from repro_torch.models import registry, rglru
    from repro_torch.train.serve_step import _cast
    from repro_torch.train.train_step import init_state, make_train_step
    from repro_torch.tree import leaves
    t_phase = time.perf_counter()
    kernels.reset_launches()
    cfg = get_config(HYBRID_ARCH)
    gb = 1e9

    # (a) parameters in bf16 on the card
    torch.cuda.reset_peak_memory_stats(device)
    params = registry.init_params(0, cfg, torch.bfloat16, device=device)
    torch.cuda.synchronize(device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    shapes = shape_total(rglru.param_shapes(cfg))
    peak = torch.cuda.max_memory_allocated(device)
    n_triples, n_tail = rglru.layout(cfg)
    say(f"[hybrid] (a) {cfg.name}: {n_params} parameters (param_shapes "
        f"{shapes}, the reckoning {HYBRID_PARAMS}, cfg.param_count() "
        f"{cfg.param_count()}), {cfg.n_layers} layers ({n_triples} triples "
        f"of rec, rec, attn and {n_tail} rec), d_model {cfg.d_model}, "
        f"recurrence width {cfg.rglru_width}, {cfg.n_heads} heads over "
        f"{cfg.n_kv_heads} KV head of {cfg.head_dim}, window "
        f"{cfg.local_window}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, tied; "
        f"bf16, {n_params * 2 / gb:.3f} GB, peak {peak / gb:.3f} GB")
    assert n_params == shapes == HYBRID_PARAMS, (n_params, shapes)

    # (b) greedy serving in bf16, twice
    lm_serve_lines("hybrid", cfg, params, HYBRID_SERVE, device,
                   f"prompt {HYBRID_SERVE['prompt']}")
    del params

    # (c) f32, TF32 off: prefill + decode against the full forward with the
    # ring wrapped; bf16 against f32
    assert not torch.backends.cuda.matmul.allow_tf32
    F = HYBRID_F32
    torch.cuda.reset_peak_memory_stats(device)
    params32 = registry.init_params(1, cfg, torch.float32, device=device)
    full, batch = lm_decode_check(cfg, params32, F["batch"], F["prompt"],
                                  F["extra"], device, "the ring wrapped past "
                                  f"the {cfg.local_window}-token window",
                                  "hybrid")
    bf, _ = registry.forward_logits(_cast(params32, torch.bfloat16), cfg,
                                    batch)
    bf16_agrees(bf, full, "(c) forward_logits", "hybrid",
                max_diff=HYBRID_BF16_MAX_DIFF, min_top1=HYBRID_BF16_TOP1)
    say(f"[hybrid] (c) peak {torch.cuda.max_memory_allocated(device) / gb:.3f}"
        f" GB (f32 weights, then bf16)")
    del params32, full, bf, batch

    # (d) the scan against the recurrence
    y_err, h_err, worst, scan_worst = rglru_against_recurrence(cfg, device)
    say(f"[hybrid] (d) _rglru f32 at {RGLRU_CHECK['batch']} x "
        f"{RGLRU_CHECK['seq']} x {cfg.rglru_width} (a^c in [0.9, 0.999] as "
        f"at init, gates uniform) against the per-step recurrence in f64: "
        f"max abs err y {y_err:.3e}, final state {h_err:.3e}; worst err / "
        f"(atol + rtol |b|) {worst:.4f} (rtol = atol = {RGLRU_TOL}); "
        f"_associative_scan alone on the same f32 a and b {scan_worst:.4f}")
    assert worst <= 1.0 and scan_worst <= 1.0, (worst, scan_worst)

    # (e) training: bf16, f32 accumulator, Adafactor, remat="full"
    T = HYBRID_TRAIN
    tc = TrainConfig(seq_len=T["seq"], global_batch=T["batch"],
                     microbatches=T["microbatches"], param_dtype="bfloat16",
                     compute_dtype="bfloat16", accum_dtype="float32",
                     accum_mode="outside", remat="full",
                     optimizer="adafactor")
    torch.cuda.reset_peak_memory_stats(device)
    state = init_state(0, cfg, tc, device=device)
    p0 = state.params
    step_fn = make_train_step(cfg, tc)
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=T["seq"],
                           global_batch=T["batch"])
    rows = []
    for s in range(T["steps"]):
        batch = train.batch_at(data, cfg, s, device)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize(device)
        rows.append(((time.perf_counter() - t0) * 1e3, float(m["loss"]),
                     float(m["grad_norm"])))
    peak = torch.cuda.max_memory_allocated(device)
    ms = float(np.median([r[0] for r in rows[1:]]))
    say(f"[hybrid] (e) {T['steps']} training steps, bf16 with an f32 "
        f"accumulator, Adafactor, remat full, batch {T['batch']} x "
        f"{T['seq']} in {T['microbatches']} microbatches, all "
        f"{cfg.n_layers} layers: ms a step "
        f"{', '.join(f'{r[0]:.3f}' for r in rows)} (median of steps 1-"
        f"{T['steps'] - 1} {ms:.3f}); {T['batch'] * T['seq'] * 1e3 / ms:.1f}"
        f" tokens/s; peak {peak / gb:.3f} GB; losses "
        f"{', '.join(f'{r[1]:.4f}' for r in rows)}; grad norms "
        f"{', '.join(f'{r[2]:.4f}' for r in rows)}")
    assert all(math.isfinite(x) for r in rows for x in r[1:]), rows
    idle = [i for i, m in enumerate(leaves(state.opt))
            if not bool(torch.isfinite(m).all())]
    assert not idle, f"optimizer state not finite: {idle}"
    unchanged_leaves("hybrid", tc, T["steps"], p0, state.params)
    del state, p0, batch
    check_only(kernels.launches(), {}, "phase 19")
    say(f"[hybrid] phase 19: {time.perf_counter() - t_phase:.1f} s; no kernel "
        f"of the port launched in it")


# ---------------------------------------------------------------------------
# phase 20: the encoder-decoder family, whisper-tiny at full width and depth
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "whisper-tiny"
# the token embedding 19.91616 M (tied), an encoder block 2.360064 M, a
# decoder block 2.950272 M, 4 of each, and two final norms
ENCDEC_PARAMS = 41158272
# (b) bf16 serving: 8 prompts of 64 tokens over 8 x 1500 frames
ENCDEC_SERVE = dict(batch=8, prompt=64, new=32)
ENCDEC_F32 = dict(batch=4, prompt=64, extra=16)
# (d) the launcher: bf16, AdamW, 8 x 128 tokens with their frames
ENCDEC_TRAIN = dict(batch=8, seq=128, microbatches=2, steps=4)


def phase_encdec(device):
    """Phase 20: ``whisper-tiny`` at full width and depth from seeds,
    served and trained; see the module docstring."""
    import io
    import tempfile
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import train
    from repro_torch.models import encdec, registry
    from repro_torch.train.serve_step import _cast
    from repro_torch.tree import leaves_with_path
    t_phase = time.perf_counter()
    kernels.reset_launches()
    cfg = get_config(ENCDEC_ARCH)
    gb = 1e9

    # (a) parameters in bf16 on the card
    torch.cuda.reset_peak_memory_stats(device)
    params = registry.init_params(0, cfg, torch.bfloat16, device=device)
    torch.cuda.synchronize(device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    shapes = shape_total(encdec.param_shapes(cfg))
    peak = torch.cuda.max_memory_allocated(device)
    say(f"[encdec] (a) {cfg.name}: {n_params} parameters (param_shapes "
        f"{shapes}, the reckoning {ENCDEC_PARAMS}, cfg.param_count() "
        f"{cfg.param_count()}), {cfg.encoder_layers} + {cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads, d_ff "
        f"{cfg.d_ff}, {cfg.encoder_seq} frames, vocab {cfg.vocab}, tied; "
        f"bf16, {n_params * 2 / gb:.4f} GB, peak {peak / gb:.4f} GB")
    assert n_params == shapes == ENCDEC_PARAMS, (n_params, shapes)

    # (b) greedy serving in bf16 over the frames, twice
    lm_serve_lines("encdec", cfg, params, ENCDEC_SERVE, device,
                   f"prompt {ENCDEC_SERVE['prompt']} over "
                   f"{cfg.encoder_seq} frames (prefill includes the "
                   f"encoder)")
    del params

    # (c) f32, TF32 off: prefill + decode against the full forward; bf16
    # against f32
    assert not torch.backends.cuda.matmul.allow_tf32
    F = ENCDEC_F32
    torch.cuda.reset_peak_memory_stats(device)
    params32 = registry.init_params(1, cfg, torch.float32, device=device)
    full, batch = lm_decode_check(cfg, params32, F["batch"], F["prompt"],
                                  F["extra"], device, "the decoder ring and "
                                  "the encoder's keys", "encdec")
    bf, _ = registry.forward_logits(_cast(params32, torch.bfloat16), cfg,
                                    batch)
    bf16_agrees(bf, full, "(c) forward_logits", "encdec")
    del params32, full, bf, batch

    # (d) the training launcher: bf16, AdamW, frames from the step's seed
    T = ENCDEC_TRAIN
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as ckpt:
        argv = ["--arch", ENCDEC_ARCH, "--batch", str(T["batch"]), "--seq",
                str(T["seq"]), "--microbatches", str(T["microbatches"]),
                "--steps", str(T["steps"]), "--ckpt", ckpt, "--device",
                str(device)]
        torch.cuda.reset_peak_memory_stats(device)
        with contextlib.redirect_stdout(buf):
            run, counts, wall = counted(lambda: train.main(argv))
        check_only(counts, {}, "encdec train")
        peak = torch.cuda.max_memory_allocated(device)
    for line in buf.getvalue().splitlines():
        say(f"[encdec] (d) | {line}")
    assert all(math.isfinite(x) for x in run.losses + run.grad_norms), \
        (run.losses, run.grad_norms)
    ms = [s * 1e3 for s in run.step_s]
    ms_step = float(np.median(ms[1:]))
    say(f"[encdec] (d) launch.train bf16, AdamW, batch {T['batch']} x "
        f"{T['seq']} tokens over {cfg.encoder_seq} frames each in "
        f"{T['microbatches']} microbatches: {T['steps']} steps in "
        f"{wall:.3f} s; ms a step {', '.join(f'{m:.3f}' for m in ms)} "
        f"(median of steps 1-{T['steps'] - 1} {ms_step:.3f}); "
        f"{T['batch'] * T['seq'] * 1e3 / ms_step:.1f} tokens/s; peak "
        f"{peak / gb:.3f} GB; losses "
        f"{', '.join(f'{x:.4f}' for x in run.losses)}")
    idle = [p for p, m in leaves_with_path(run.state.opt) if p != "step"
            and not (bool(torch.isfinite(m).all())
                     and bool(m.abs().max() > 0))]
    assert not idle, f"moments zero or not finite: {idle}"
    unchanged_leaves("encdec", TrainConfig(), T["steps"],
                     registry.init_params(0, cfg, torch.bfloat16,
                                          device=device), run.state.params)
    del run
    check_only(kernels.launches(), {}, "phase 20")
    say(f"[encdec] phase 20: {time.perf_counter() - t_phase:.1f} s; no kernel "
        f"of the port launched in it")


# ---------------------------------------------------------------------------
# phase 21: meshes and sharding (step 15e)
# ---------------------------------------------------------------------------

MESH_TRAIN = dict(batch=8, seq=512, microbatches=2, steps=4)
MESH_DTENSOR = dict(steps=2, batch=8, prompt=64, new=16)
MESH_CARDS = dict(max_cards=4, steps=2)
DRYRUN_CELLS = (("qwen2-0.5b", "decode_32k"), ("mixtral-8x7b", "long_500k"),
                ("mamba2-370m", "decode_32k"), ("whisper-tiny", "prefill_32k"))
SOLVER_DRYRUN = dict(l=1_048_576, d=256)
SUBPROCESS_TIMEOUT = 600


def mesh_train_config(T, fp32=False):
    """The training launcher's config for ``T`` (``launch/train.py``)."""
    from repro_torch.configs.base import TrainConfig
    dt = "float32" if fp32 else "bfloat16"
    return TrainConfig(seq_len=T["seq"], global_batch=T["batch"],
                       microbatches=T["microbatches"], param_dtype=dt,
                       compute_dtype=dt, accum_dtype="float32", remat="full")


def dryrun_processes():
    """Phase 21 (e), started in the background: the dry-run of
    ``DRYRUN_CELLS`` and of the sharded solver on the (16, 16) production
    mesh, in two subprocesses (half the cells each, the solver with the
    second half), each with a fake 256-rank group and fake CUDA tensors
    (they touch no card's memory and no NCCL group).  The last line of
    each is the JSON list of its records."""
    half = (len(DRYRUN_CELLS) + 1) // 2
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for cells, solver in ((DRYRUN_CELLS[:half], False),
                          (DRYRUN_CELLS[half:], True)):
        code = (
            "import json\n"
            "from repro_torch.launch import dryrun, dryrun_solver\n"
            "mesh = dryrun.make_mesh_by_name('single')\n"
            f"recs = [dryrun.run_cell(a, s, mesh, 'single') for a, s in "
            f"{cells!r}]\n"
            + (f"recs.append(dryrun_solver.run({SOLVER_DRYRUN['l']}, "
               f"{SOLVER_DRYRUN['d']}, 'single'))\n" if solver else "")
            + "print(json.dumps(recs, default=str))\n")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=str(ROOT)))
    return procs


def mesh_cards_rank(rank: int, world: int, dims, store: str, out: str,
                    device_type: str = "cuda", smoke: bool = False):
    """Phase 21 (d) on one rank: ``qwen2-0.5b`` (its smoke config with
    ``smoke``) on a ``dims`` host mesh of ``world`` ranks (NCCL, one card a
    rank; gloo for ``device_type="cpu"``): the gradient of the first
    microbatch at the initial parameters, then ``MESH_CARDS['steps']``
    training steps.  Rank 0 saves the loss, the flat float32 gradient and
    the step losses to ``out``."""
    from datetime import timedelta
    import torch.distributed as dist
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data import SyntheticTokens, shard_batch
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import axis_rules, full
    from repro_torch.train.train_step import (init_state, make_train_step,
                                              shard_state)
    T = MESH_TRAIN
    if device_type == "cuda":
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        store=dist.FileStore(store, world), rank=rank, world_size=world,
        timeout=timedelta(seconds=300))
    try:
        mesh = make_host_mesh(*dims, device=dev)
        cfg = (get_smoke if smoke else get_config)(LM_ARCH)
        tc = mesh_train_config(T, fp32=device_type == "cpu")
        data = SyntheticTokens(vocab=cfg.vocab, seq_len=T["seq"],
                               global_batch=T["batch"])
        with axis_rules(mesh):
            state = shard_state(init_state(0, cfg, tc, device=dev), cfg,
                                mesh)
            mb = T["batch"] // T["microbatches"]
            b = shard_batch({k: v[:mb] for k, v in
                             train.host_batch(data, cfg, 0).items()}, mesh)
            loss, g = grads_of(cfg, state.params, b)
            flat = torch.cat([full(x).float().flatten() for x in g])
            step_fn = make_train_step(cfg, tc)
            losses = []
            for s in range(MESH_CARDS["steps"]):
                state, m = step_fn(state, shard_batch(
                    train.host_batch(data, cfg, s), mesh))
                losses.append(float(full(m["loss"])))
        if rank == 0:
            torch.save({"loss": float(full(loss)), "grad": flat.cpu(),
                        "losses": losses}, out)
    finally:
        dist.destroy_process_group()


def run_mesh_cards(world: int, dims, tmp: str, device_type="cuda",
                   smoke=False) -> dict:
    """Rank 0's record of :func:`mesh_cards_rank` on ``world`` ranks, one
    subprocess a rank."""
    store, out = os.path.join(tmp, f"store{dims}"), os.path.join(
        tmp, f"rank0{dims}.pt")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke;"
            " chip_smoke.mesh_cards_rank(int(sys.argv[2]), int(sys.argv[3]),"
            " eval(sys.argv[4]), sys.argv[5], sys.argv[6], sys.argv[7],"
            " sys.argv[8] == '1')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(ROOT), str(r), str(world),
         repr(tuple(dims)), store, out, device_type, "1" if smoke else "0"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SUBPROCESS_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    return torch.load(out, weights_only=True)


def phase_mesh(device):
    """Phase 21: the host mesh, DTensor, re-partitioning, several cards
    and the dry-run (step 15e); see the module docstring."""
    import io
    import tempfile
    import torch.distributed as dist
    from torch.distributed.tensor import (DTensor, Replicate,
                                          distribute_tensor)
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens, shard_batch
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry
    from repro_torch.sharding import (axis_rules, full, map_logical,
                                      tree_shardings)
    from repro_torch.train.serve_step import greedy_decode, greedy_prefill
    from repro_torch.train.train_step import (init_state, make_train_step,
                                              state_shardings)
    from repro_torch.configs.base import ServeConfig
    from repro_torch.tree import leaves
    t_phase = time.perf_counter()
    dry = dryrun_processes()
    cfg = get_config(LM_ARCH)
    T = MESH_TRAIN
    tc = mesh_train_config(T, fp32=device.type == "cpu")
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=T["seq"],
                           global_batch=T["batch"])
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(device)

    def bitwise(a, b):
        return all(torch.equal(full(x), full(y))
                   for x, y in zip(leaves(a), leaves(b)))

    def wrap(tree, shardings):
        """(b)'s leaves as DTensors on their shardings' placements (on
        one rank, every one ``Replicate``)."""
        return map_logical(
            lambda s, x: None if x is None
            else distribute_tensor(x, mesh, s.placements), shardings, tree)

    def replicated(batch):
        return {k: distribute_tensor(v, mesh, [Replicate()] * mesh.ndim)
                for k, v in batch.items()}

    with tempfile.TemporaryDirectory() as tmp:
        # (a) the host mesh over the card, and the launcher on it
        assert not dist.is_initialized()
        mesh = make_host_mesh(1, 1, device=device)
        try:
            assert dist.get_backend() == ("nccl" if device.type == "cuda"
                                          else "gloo")
            assert dist.get_world_size() == 1
            argv = ["--batch", str(T["batch"]), "--seq", str(T["seq"]),
                    "--microbatches", str(T["microbatches"]), "--steps",
                    str(T["steps"]), "--ckpt", tmp, "--device", str(device)]
            buf = io.StringIO()
            with deterministic("strict"):
                with contextlib.redirect_stdout(buf):
                    run, counts, wall = counted(lambda: train.main(argv))
                check_only(counts, {}, "mesh train")
                state = init_state(0, cfg, tc, device=device)
                step_fn = make_train_step(cfg, tc)
                losses = []
                for s in range(T["steps"]):
                    state, m = step_fn(state, train.batch_at(data, cfg, s,
                                                             device))
                    losses.append(float(m["loss"]))
            assert "mesh: {'data': 1, 'model': 1}" in buf.getvalue()
            assert type(run.state.params.embed) is torch.Tensor
            assert run.losses == losses, (run.losses, losses)
            assert bitwise(run.state, state), "launcher state differs"
            say(f"[mesh] (a) make_host_mesh(1, 1): one NCCL rank; "
                f"launch.train on it, {LM_ARCH} bf16, batch {T['batch']} x "
                f"{T['seq']}, {T['microbatches']} microbatches, "
                f"{T['steps']} steps in {wall:.3f} s, the one-device path "
                f"(plain tensors): losses "
                f"{', '.join(f'{x:.4f}' for x in losses)} and every state "
                f"leaf bitwise equal to the same steps without a mesh "
                f"(deterministic algorithms)")
            del state

            # (c) the launcher's checkpoint re-partitioned onto the mesh
            back = restore_checkpoint(
                tmp, T["steps"], run.state,
                shardings=state_shardings(run.state, cfg, mesh))
            assert bitwise(back, run.state), "re-partitioned state differs"
            say(f"[mesh] (c) restore_checkpoint(shardings=) of (a)'s step "
                f"{T['steps']} onto the (1, 1) mesh: {len(leaves(back))} "
                f"leaves bitwise equal to the saved ones")
            del back, run

            # (b) the same weights as one-rank Replicate DTensors
            D = MESH_DTENSOR
            plain = init_state(0, cfg, tc, device=device)
            wrapped = wrap(plain, state_shardings(plain, cfg, mesh))
            assert all(isinstance(t, DTensor)
                       for t in leaves(wrapped.params))
            ms, out = {}, {}
            with deterministic("strict"), axis_rules(mesh):
                for tag, st in (("plain", plain), ("DTensor", wrapped)):
                    times, ls = [], []
                    for s in range(D["steps"]):
                        b = shard_batch(train.host_batch(data, cfg, s),
                                        mesh)
                        if tag != "plain":
                            b = replicated(b)
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        st, m = step_fn(st, b)
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t0)
                        ls.append(float(full(m["loss"])))
                    ms[tag] = times[-1] * 1e3
                    out[tag] = (ls, st)
                assert out["plain"][0] == out["DTensor"][0], out
                assert bitwise(out["plain"][1], out["DTensor"][1])
                del out, plain, wrapped
                sc = ServeConfig(seq_len=D["prompt"] + D["new"],
                                 batch=D["batch"])
                prompt = {"tokens": registry.demo_batch(
                    cfg, D["batch"], D["prompt"], device=device)["tokens"]}
                p0 = registry.init_params(0, cfg, torch.bfloat16,
                                          device=device)
                toks, dec_ms = {}, {}
                for tag in ("plain", "DTensor"):
                    params, pr = p0, shard_batch(prompt, mesh)
                    if tag != "plain":
                        params = wrap(p0, tree_shardings(
                            registry.param_logical(cfg), p0, mesh))
                        pr = replicated(pr)
                    with torch.no_grad():
                        cp, cache, tok = greedy_prefill(cfg, sc, params, pr,
                                                        device=device)
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        toks[tag] = full(greedy_decode(
                            cfg, cp, cache, tok, D["prompt"], D["new"]))
                        torch.cuda.synchronize()
                    dec_ms[tag] = (time.perf_counter() - t0) / (
                        D["new"] - 1) * 1e3
                assert torch.equal(toks["plain"], toks["DTensor"])
            say(f"[mesh] (b) one-rank Replicate DTensors (tree_shardings, "
                f"wrapped): {D['steps']} train steps bitwise equal to plain "
                f"tensors (losses, every state leaf); ms a step (the "
                f"second) plain {ms['plain']:.3f}, DTensor "
                f"{ms['DTensor']:.3f} ({ms['DTensor'] / ms['plain']:.2f}x); "
                f"greedy decode batch {D['batch']}, prompt {D['prompt']}, "
                f"{D['new']} tokens equal; ms a decode step plain "
                f"{dec_ms['plain']:.3f}, DTensor {dec_ms['DTensor']:.3f} "
                f"({dec_ms['DTensor'] / dec_ms['plain']:.2f}x): the host "
                f"cost of DTensor dispatch")
        finally:
            dist.destroy_process_group()

        # (d) several cards
        n = min(torch.cuda.device_count(), MESH_CARDS["max_cards"])
        if n >= 2:
            mb = T["batch"] // T["microbatches"]
            b = {k: v[:mb] for k, v in
                 train.batch_at(data, cfg, 0, device).items()}
            l1, g1 = grads_of(cfg, registry.init_params(
                0, cfg, torch.bfloat16, device=device), b)
            one = torch.cat([g.float().flatten() for g in g1])
            del g1
            for dims in ((n, 1), (1, n)):
                r = run_mesh_cards(n, dims, tmp)
                g = r["grad"].to(device)
                cos = float(torch.dot(g, one) / (g.norm() * one.norm()))
                rdiff = abs(float(g.norm() / one.norm()) - 1.0)
                say(f"[mesh] (d) {n} NCCL ranks on a {dims} mesh: loss "
                    f"{r['loss']:.6f} (one card {float(l1):.6f}); gradient "
                    f"cosine {cos:.6f} (limit {BF16_GRAD_COS}), norm "
                    f"relative difference {rdiff:.6f} (limit "
                    f"{BF16_GRAD_NORM_RDIFF}); {MESH_CARDS['steps']} steps, "
                    f"losses {', '.join(f'{x:.4f}' for x in r['losses'])}")
                assert cos >= BF16_GRAD_COS and rdiff <= BF16_GRAD_NORM_RDIFF
                assert all(math.isfinite(x) for x in r["losses"])
        else:
            say("[mesh] (d) one card: the several-rank meshes ran in the CPU "
                "tests only (tests/test_torch_mesh.py, 4 gloo ranks on a "
                "(2, 2) mesh)")

    # (e) the dry-run, started at the phase's start
    recs = []
    for p in dry:
        stdout, stderr = p.communicate(timeout=SUBPROCESS_TIMEOUT)
        assert p.returncode == 0, (stdout + stderr)[-4000:]
        recs += json.loads(stdout.strip().splitlines()[-1])
    for r in recs[:-1]:
        assert r["ok"] and not r.get("skipped"), r.get("traceback", r)
        ro = r["roofline"]
        assert 0 < ro["roofline_fraction"] <= 1, ro
        say(f"[mesh] (e) dry-run {r['arch']} x {r['shape']} on the (16, 16) "
            f"mesh ({r['device']} fake tensors, a fake 256-rank group): "
            f"dominant {ro['dominant']}, roofline fraction "
            f"{ro['roofline_fraction']:.3e}; terms compute "
            f"{ro['compute_s']:.3e} s, memory {ro['memory_s']:.3e} s, "
            f"collective {ro['collective_s']:.3e} s (reckoned at the "
            f"H100's data-sheet peaks); trace {r['time_compile_s']:.1f} s")
    s = recs[-1]
    p = s["per_iteration"]
    say(f"[mesh] (e) dry-run pasmo-solver l={SOLVER_DRYRUN['l']} "
        f"d={SOLVER_DRYRUN['d']} over 256 fake ranks: per iteration a "
        f"device compute {p['compute_us']:.3f} us, memory "
        f"{p['memory_us']:.3f} us, collective {p['collective_us']:.3f} us "
        f"(reckoned); collectives {s['collectives']['counts']}; trace "
        f"{s['time_compile_s']:.1f} s")
    say(f"[mesh] phase 21 took {time.perf_counter() - t_phase:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="phases 1-3 and every kernel's timing only, "
                         "without the end-to-end phases and without the "
                         "result lines")
    kernels_only = ap.parse_args(argv).kernels
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
    phase_resources()
    say(f"[time] kernel checks done at {time.perf_counter() - t_start:.1f} s")
    if kernels_only:
        for times in (kernel_times, grid_kernel_times, slice3_kernel_times,
                      slice4_kernel_times, conj_kernel_times):
            times(device, timer)
        say(f"[done] kernels only, {time.perf_counter() - t_start:.1f} s; "
            f"card: {smi}")
        return 0
    small_compacted = phase_small(device, "cuda")
    say(f"[time] small runs done at {time.perf_counter() - t_start:.1f} s")
    MAIN_LAUNCHES.clear()                   # phases 5-16 tally from here
    recs, lane0, svc_ref = phase_full(device, timer)
    say(f"[time] slice 1 phases done at {time.perf_counter() - t_start:.1f} s")
    grid_recs, grid_off = phase_grid(device, timer)
    recs.update(grid_recs)
    say(f"[time] slice 2 phases done at {time.perf_counter() - t_start:.1f} s")
    phase_single(device, timer, lane0)
    say(f"[time] single-lane phase done at "
        f"{time.perf_counter() - t_start:.1f} s")
    svr_off, svr_ref = phase_svr(device)
    recs.update(slice3_kernel_times(device, timer))
    say(f"[time] slice 3 phases done at {time.perf_counter() - t_start:.1f} s")
    phase_shrink(device, timer, grid_off, svr_off)
    recs.update(slice4_kernel_times(device, timer))
    say(f"[time] slice 4 phases done at {time.perf_counter() - t_start:.1f} s")
    variants, conj_svc = phase_conj(device, timer, svc_ref, grid_off,
                                    svr_ref)
    conj_recs = conj_kernel_times(device, timer)
    for name in CONJ_PASSES:
        # the record of each conjugate wrapper: its variant launched most
        # on the main path
        src = "rbf" if name == CONJ_PASSES[0] else "bank"
        mine = {k: n for k, n in variants.items() if k[0] == src}
        assert MAIN_LAUNCHES[name] == sum(mine.values()), (name, mine)
        recs[name] = conj_recs[max(mine, key=mine.get)]
        say(f"[conj] {name}: launches by (source, H, act, B) {mine}; the "
            f"record's times are those of {max(mine, key=mine.get)}")
    say(f"[time] slice 5 phase done at {time.perf_counter() - t_start:.1f} s")
    phase_classic(device, svc_ref, grid_off, svr_ref)
    say(f"[time] slice 9 phase done at {time.perf_counter() - t_start:.1f} s")
    tel = phase_telemetry(device, svc_ref, grid_off, conj_svc)
    say(f"[time] slice 10 phase done at {time.perf_counter() - t_start:.1f} s")
    phase_multi(device, [torch.device("cuda", i)
                         for i in range(torch.cuda.device_count())],
                svc_ref, grid_off, small_compacted, tel["svc_lanes"])
    say(f"[time] slice 12 phase done at {time.perf_counter() - t_start:.1f} s")
    phase_analysis(device)
    say(f"[time] analysis done at {time.perf_counter() - t_start:.1f} s")
    phase_lm(device, timer, errs)
    say(f"[time] LM phase done at {time.perf_counter() - t_start:.1f} s")
    phase_train(device)
    say(f"[time] LM training phase done at "
        f"{time.perf_counter() - t_start:.1f} s")
    phase_moe(device)
    say(f"[time] MoE phase done at {time.perf_counter() - t_start:.1f} s")
    phase_ssm(device)
    say(f"[time] SSM phase done at {time.perf_counter() - t_start:.1f} s")
    phase_hybrid(device)
    say(f"[time] hybrid phase done at {time.perf_counter() - t_start:.1f} s")
    phase_encdec(device)
    say(f"[time] encoder-decoder phase done at "
        f"{time.perf_counter() - t_start:.1f} s")
    phase_mesh(device)
    say(f"[time] mesh phase done at {time.perf_counter() - t_start:.1f} s")
    n_gram = MAIN_LAUNCHES["gram_block"]
    n_sym = MAIN_LAUNCHES["gram_symmetric"]
    say(f"[gram] launches over phases 5-13 and 15: {n_gram}; bank and Gram "
        f"builds (l x l, symmetric; l = {N_TRAIN}, the probe's "
        f"{PROBE['n_train']}): {n_sym}; predict and decision (m x l, "
        f"cross): {n_gram - n_sym}")
    idle = [name for name in SOURCES if MAIN_LAUNCHES[name] == 0]
    assert not idle, f"kernels the main paths never launched: {idle}"
    out = []
    for name, (src, replaces) in SOURCES.items():
        r = recs[name]
        out.append(dict(name=name, route="cuda", source=src,
                        replaces=replaces, launches=MAIN_LAUNCHES[name],
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
