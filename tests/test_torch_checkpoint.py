"""The port's checkpointing and resilient loop (``repro_torch.checkpoint``,
``repro_torch.runtime.fault``) on the CPU: the round trip, the
reference's layout and leaf keys, torn directories, the asynchronous
checkpointer's snapshot and garbage collection, and ``run_resilient``
bitwise equal to an uninterrupted run with failures injected (smoke
config, float32)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _path_str
from repro.configs import get_smoke as jget_smoke
from repro.configs.base import TrainConfig as JTrainConfig
from repro.train import train_step as jts
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_smoke
from repro_torch.configs.base import TrainConfig
from repro_torch.data import SyntheticTokens, to_device
from repro_torch.runtime import FailureInjector, StepMonitor, run_resilient
from repro_torch.train.train_step import init_state, make_train_step
from repro_torch.tree import leaves, leaves_with_path

CPU = dict(device="cpu")
TC = dict(param_dtype="float32", compute_dtype="float32",
          accum_dtype="float32", learning_rate=1e-3, remat="none")


def _tree_equal(a, b):
    la, lb = leaves_with_path(a), leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, p
        assert torch.equal(x, y), p


def _state():
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.tensor([1, 2, 3], dtype=torch.int32)},
            "scalar": torch.tensor(7, dtype=torch.int32),
            "seq": [torch.ones(2, dtype=torch.bfloat16), None]}


def test_roundtrip_layout_and_manifest(tmp_path):
    state = _state()
    path = save_checkpoint(str(tmp_path), 5, state, metadata={"run": "a"})
    assert os.path.basename(path) == "step_0000000005"
    assert sorted(os.listdir(path)) == ["COMMIT", "manifest.json",
                                        "state.pt"]
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest == {"step": 5, "metadata": {"run": "a"},
                        "format": "torch/v1"}
    flat = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    assert sorted(flat) == ["nested/b", "scalar", "seq/0", "w"]
    assert latest_step(str(tmp_path)) == 5
    _tree_equal(restore_checkpoint(str(tmp_path), 5, state, **CPU), state)


def test_restore_casts_to_like_and_names_missing_leaves(tmp_path):
    state = {"w": torch.linspace(-1, 1, 8), "i": torch.arange(3)}
    save_checkpoint(str(tmp_path), 1, state)
    like = {"w": torch.zeros(8, dtype=torch.bfloat16),
            "i": torch.zeros(3, dtype=torch.int32)}
    r = restore_checkpoint(str(tmp_path), 1, like, **CPU)
    assert r["w"].dtype == torch.bfloat16 and r["i"].dtype == torch.int32
    assert torch.equal(r["w"], state["w"].to(torch.bfloat16))
    with pytest.raises(KeyError, match="missing leaf v"):
        restore_checkpoint(str(tmp_path), 1, {"v": torch.zeros(1)}, **CPU)
    # shardings must name every leaf of like
    with pytest.raises(ValueError, match="one NamedSharding a leaf"):
        restore_checkpoint(str(tmp_path), 1, like, shardings={"w": None},
                           **CPU)


class _OneDeviceMesh:
    """A one-device mesh's face (no process group): its axis sizes and
    device type."""
    shape = {"data": 1, "model": 1}
    device_type = "cpu"


def test_restore_onto_a_one_device_mesh_is_bitwise_and_plain(tmp_path):
    """``shardings=`` on a one-device mesh: every placement replicates,
    so each leaf comes back a plain tensor, bitwise the saved one, cast to
    like's dtype (the multi-rank re-partitions are in
    ``test_torch_mesh.py``)."""
    from repro_torch.sharding import NamedSharding, P
    state = {"w": torch.randn(4, 6, generator=torch.Generator().manual_seed(0)),
             "nested": {"b": torch.arange(5, dtype=torch.int32)}}
    save_checkpoint(str(tmp_path), 2, state)
    mesh = _OneDeviceMesh()
    sh = {"w": NamedSharding(mesh, P("data", None)),
          "nested": {"b": NamedSharding(mesh, P(None))}}
    r = restore_checkpoint(str(tmp_path), 2, state, shardings=sh)
    assert type(r["w"]) is torch.Tensor
    _tree_equal(r, state)


def test_train_state_keys_are_the_reference_s(tmp_path):
    """Every leaf of a TrainState (AdamW, error feedback on) is stored
    under the key the reference's ``_path_str`` gives the same leaf."""
    arch = "qwen2-0.5b"
    kw = {**TC, "compress_grads": True}
    ref = jts.init_state(jax.random.PRNGKey(0), jget_smoke(arch),
                         JTrainConfig(**kw))
    want = [_path_str(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(ref)[0]]
    state = init_state(0, get_smoke(arch), TrainConfig(**kw), **CPU)
    path = save_checkpoint(str(tmp_path), 1, state)
    flat = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    assert sorted(flat) == sorted(want)
    assert [p for p, _ in leaves_with_path(state)] == want
    _tree_equal(restore_checkpoint(str(tmp_path), 1, state, **CPU), state)


def test_torn_and_tmp_directories_ignored(tmp_path):
    state = {"w": torch.ones(4)}
    save_checkpoint(str(tmp_path), 1, state)
    # a torn write: a step directory without COMMIT, and a stale .tmp
    os.makedirs(tmp_path / "step_0000000002")
    (tmp_path / "step_0000000002" / "state.pt").write_bytes(b"junk")
    os.makedirs(tmp_path / "step_0000000003.tmp")
    assert latest_step(str(tmp_path)) == 1
    assert latest_step(str(tmp_path / "absent")) is None
    # a save over the stale .tmp of its own step replaces it
    save_checkpoint(str(tmp_path), 3, {"w": torch.full((4,), 3.0)})
    assert latest_step(str(tmp_path)) == 3
    assert not os.path.exists(tmp_path / "step_0000000003.tmp")


def test_async_checkpointer_keeps_newest(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    state = {"w": torch.ones((8, 8))}
    for s in [1, 2, 3, 4]:
        ck.save(s, {"w": state["w"] * s})
    ck.close()
    assert latest_step(str(tmp_path)) == 4
    kept = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert kept == ["step_0000000003", "step_0000000004"]
    r = restore_checkpoint(str(tmp_path), 4, state, **CPU)
    assert torch.equal(r["w"], torch.full((8, 8), 4.0))


def test_async_snapshot_unaffected_by_later_in_place_writes(tmp_path):
    """``save`` copies: a step that writes the state in place right after
    (before the writer thread runs) does not reach the checkpoint, though
    ``t.cpu()`` of a CPU tensor is ``t`` itself."""
    w = torch.zeros(1000)
    assert w.cpu() is w
    ck = AsyncCheckpointer(str(tmp_path))
    ck._q.join()
    ck.save(1, {"w": w})
    w.add_(5.0)
    ck.close()
    r = restore_checkpoint(str(tmp_path), 1, {"w": w}, **CPU)
    assert torch.equal(r["w"], torch.zeros(1000))


def test_async_checkpointer_raises_writer_errors(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = AsyncCheckpointer(str(blocker))
    ck.save(1, {"w": torch.ones(2)})
    with pytest.raises(OSError):
        ck.close()


def _training(arch="qwen2-0.5b", **tc):
    cfg = get_smoke(arch)
    tcfg = TrainConfig(**{**TC, **tc})
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=16, global_batch=2)
    state0 = init_state(0, cfg, tcfg, **CPU)
    return (make_train_step(cfg, tcfg), state0,
            lambda s: to_device(data.batch_at(s), "cpu"))


# failures at 4 and 9 with saves every 3 (the reference's own test), and
# one failure before the first save, which restarts from init_state
RESILIENT = {"after_saves": dict(fail_at=[4, 9], save_every=3),
             "before_first_save": dict(fail_at=[1, 7], save_every=5)}


@pytest.mark.parametrize("case", RESILIENT)
def test_resilient_run_bitwise_equal_uninterrupted(tmp_path, case):
    step, state0, batch_at = _training(compress_grads=True,
                                       microbatches=2)
    snapshot = [t.clone() for t in leaves(state0)]
    ref = state0
    for s in range(12):
        ref, _ = step(ref, batch_at(s))
    inj = FailureInjector(fail_at=RESILIENT[case]["fail_at"])
    monitor = StepMonitor(warmup_steps=1)
    final = run_resilient(step, state0, batch_at, n_steps=12,
                          ckpt_dir=str(tmp_path / "ck"),
                          save_every=RESILIENT[case]["save_every"],
                          injector=inj, monitor=monitor)
    assert inj.fired == set(RESILIENT[case]["fail_at"])
    _tree_equal(final, ref)
    assert int(final.step) == 12 and int(final.opt.step) == 12
    assert monitor.count > 0
    # neither loop wrote the initial state
    for a, b in zip(leaves(state0), snapshot):
        assert torch.equal(a, b)


def test_resilient_run_gives_up_after_max_restarts(tmp_path):
    step, state0, batch_at = _training()
    inj = FailureInjector(fail_at=[0, 1, 2])
    with pytest.raises(RuntimeError, match="injected failure at step 1"):
        run_resilient(step, state0, batch_at, n_steps=4,
                      ckpt_dir=str(tmp_path / "ck"), save_every=2,
                      injector=inj, max_restarts=1)


def test_resilient_run_restores_onto_the_state_s_device(tmp_path,
                                                          monkeypatch):
    """The restore goes where ``init_state`` lives, not to the default
    card (which is not there)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    step, state0, batch_at = _training("internvl2-1b")

    def vlm_batch(s):
        b = batch_at(s)
        b["patches"] = torch.zeros((2, 8, 56))
        return b

    final = run_resilient(step, state0, vlm_batch, n_steps=4,
                          ckpt_dir=str(tmp_path / "ck"), save_every=2,
                          injector=FailureInjector(fail_at=[3]))
    assert final.params.embed.device.type == "cpu"
    assert int(final.step) == 4
    assert np.isfinite(final.params.embed.numpy()).all()
