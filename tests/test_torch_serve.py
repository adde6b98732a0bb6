"""The port's serving path (``repro_torch.train.serve_step``,
``repro_torch.launch.serve``) against the reference's on the CPU in
float32, smoke configs, the reference's weights carried across.

Tolerances: prefill and decode-step logits to rtol 1e-5 / atol 1e-5 of
the reference's (float32 sums in another order); greedy tokens equal
wherever the reference's top-2 logit margin exceeds 1e-3 (below it the
two argmaxes may part at a rounding tie, and the sequences with them)."""

import dataclasses
import functools
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _path_str
from repro.configs import get_smoke as jget_smoke
from repro.configs.base import ServeConfig as JServeConfig
from repro.models import registry as JR
from repro.train import serve_step as jss
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ServeConfig
from repro_torch.models import registry as R
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import serve_step as ss
from repro_torch.tree import leaves_with_path

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
MARGIN = 1e-3
SC = dict(seq_len=32, batch=2, param_dtype="float32",
          compute_dtype="float32", kv_dtype="float32")


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference's init of ``arch``'s smoke config and the port's copy
    (once a module: the reference's init is the slow part)."""
    jp = JR.init_params(jax.random.PRNGKey(3), jget_smoke(arch), jnp.float32)
    return jp, params_from_numpy(get_smoke(arch),
                                 jax.tree.map(np.asarray, jp), device="cpu")


def _setup(arch, prompt_len=16, **overrides):
    jcfg = dataclasses.replace(jget_smoke(arch), **overrides)
    cfg = dataclasses.replace(get_smoke(arch), **overrides)
    jb = JR.demo_batch(jcfg, batch=2, seq=prompt_len + 8, seed=4)
    tb = R.demo_batch(cfg, batch=2, seq=prompt_len + 8, seed=4,
                      device="cpu")
    return (jcfg, cfg, *_weights(arch), jb, tb)


def _prompt(b, S):
    """The first S tokens of a batch with its patches or frames."""
    return {k: v[:, :S] if k == "tokens" else v for k, v in b.items()
            if k != "labels"}


def _jitted(jcfg):
    """The reference's prefill and serve step, each compiled once."""
    sc = JServeConfig(**SC)
    return (jax.jit(jss.make_prefill(jcfg, sc)),
            jax.jit(jss.make_serve_step(jcfg, sc)))


# the dense model with full attention; the VLM with a window of 8, so its
# ring wraps in the prefill (16 tokens) and on every decode step; the
# hybrid with a local window of 8 (the same); the encoder-decoder over
# its frames
SERVE_CASES = {"qwen2-0.5b": {}, "internvl2-1b": {"sliding_window": 8},
               "recurrentgemma-2b": {"local_window": 8}, "whisper-tiny": {}}


@pytest.mark.parametrize("arch", SERVE_CASES)
def test_prefill_and_serve_step_match_reference(arch):
    """``make_prefill`` then 8 teacher-forced ``make_serve_step`` steps."""
    S = 16
    jcfg, cfg, jp, tp, jb, tb = _setup(arch, S, **SERVE_CASES[arch])
    jpre, jstep = _jitted(jcfg)
    tpre = ss.make_prefill(cfg, ServeConfig(**SC))
    tstep = ss.make_serve_step(cfg, ServeConfig(**SC))
    jl, jc = jpre(jp, _prompt(jb, S))
    tl, tc = tpre(tp, _prompt(tb, S))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for t in range(8):
        jl, jc = jstep(jp, jc, jb["tokens"][:, S + t:S + t + 1],
                       jnp.asarray(S + t, jnp.int32))
        tl, tc = tstep(tp, tc, tb["tokens"][:, S + t:S + t + 1], S + t)
        assert tl.shape == (2, 1, cfg.vocab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    kpos = {p: t for p, t in leaves_with_path(tc) if p.endswith("kpos")}
    want = jax.tree_util.tree_flatten_with_path(jc)[0]
    want = {_path_str(p): np.asarray(x) for p, x in want
            if _path_str(p).endswith("kpos")}
    assert sorted(kpos) == sorted(want) and kpos
    for p, t in kpos.items():
        np.testing.assert_array_equal(t.numpy(), want[p])


def _reference_greedy(jcfg, jp, prompt, steps):
    """The reference's ``greedy_generate``, unrolled to keep each step's
    top-2 margin: (tokens (B, steps), margins (B, steps))."""
    prefill, step = _jitted(jcfg)
    logits, cache = prefill(jp, prompt)
    S = prompt["tokens"].shape[1]
    toks, margins = [], []
    for t in range(steps):
        top2 = np.sort(np.asarray(logits[:, -1]), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok[:, 0]))
        if t < steps - 1:
            logits, cache = step(jp, cache, tok, jnp.asarray(S + t,
                                                             jnp.int32))
    return np.stack(toks, 1), np.stack(margins, 1)


def test_greedy_generate_matches_reference():
    S, steps = 16, 12
    jcfg, cfg, jp, tp, jb, tb = _setup("qwen2-0.5b", S)
    want, margins = _reference_greedy(jcfg, jp, _prompt(jb, S), steps)
    got = ss.greedy_generate(cfg, ServeConfig(**SC), tp, _prompt(tb, S),
                             steps, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, steps)
    compared = 0
    for b in range(2):
        for t in range(steps):
            if margins[b, t] <= MARGIN:
                break      # a tie: the rest of this row may part
            assert int(got[b, t]) == int(want[b, t]), (b, t)
            compared += 1
    assert compared >= steps


def test_serve_cli_prints_the_references_lines():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--batch", "2", "--prompt-len", "8",
         "--tokens", "6"], env=env, capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 3, lines
    assert lines[0] == "arch=qwen2-0.5b-smoke batch=2"
    assert re.fullmatch(r"prefill 8 tok: \d+\.\d\ds; decode 6 tok: "
                        r"\d+\.\d\ds \(\d+\.\d tok/s\)", lines[1]), lines[1]
    m = re.fullmatch(r"first sequence: \[([\d ]+)\] \.\.\.", lines[2])
    assert m, lines[2]
    # the CLI's tokens are greedy_generate's on its seed-0 weights and
    # prompt
    cfg = get_smoke("qwen2-0.5b")
    prompt = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)), dtype=torch.int32)}
    gen = ss.greedy_generate(
        cfg, dataclasses.replace(ServeConfig(**SC), seq_len=14),
        R.init_params(0, cfg, device="cpu"), prompt, 6, device="cpu")
    assert [int(t) for t in m.group(1).split()] == gen[0].tolist()
