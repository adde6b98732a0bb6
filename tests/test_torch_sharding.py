"""The port's logical-axis rules (``repro_torch.sharding``) against the
reference's (``repro.sharding``): the rule tables, and ``spec_for`` on
every leaf of every config's parameter, cache and training-input trees on
the meshes (1, 1), (2, 2), (2, 2, 2), (16, 16) and (2, 16, 16).

The reference's ``spec_for`` reads only ``mesh.shape``, so both packages
get a stub with a ``shape`` dict and no devices.  Shapes are the
reference's (``jax.eval_shape`` of its init functions), held equal to the
port's ``param_shapes`` and ``cache_specs`` leaf for leaf; specs must be
equal element for element (exact: they are names)."""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS, get_config as jget_config
from repro.configs.base import get_shape as jget_shape
from repro.models import registry as JR
from repro.sharding import (DEFAULT_RULES as J_DEFAULT,
                            LONG_DECODE_RULES as J_LONG, logical as jlg,
                            spec_for as jspec_for)
from repro_torch import sharding as S
from repro_torch.configs import get_config, get_shape
from repro_torch.models import registry as R


class StubMesh:
    def __init__(self, **shape):
        self.shape = dict(shape)


MESHES = {
    "1x1": StubMesh(data=1, model=1),
    "2x2": StubMesh(data=2, model=2),
    "2x2x2": StubMesh(pod=2, data=2, model=2),
    "16x16": StubMesh(data=16, model=16),
    "2x16x16": StubMesh(pod=2, data=16, model=16),
}
TREES = ("param", "cache", "train_input")
CACHE_SHAPE = "decode_32k"
TRAIN_SHAPE = "train_4k"


def _port_leaves(tree):
    """(path, leaf) of a port tree whose leaves are ``logical``s, tensors
    or shape tuples; ``None`` skipped."""
    out = []

    def walk(t, path):
        if t is None:
            return
        if isinstance(t, (S.logical, torch.Tensor)) or (
                isinstance(t, tuple) and not hasattr(t, "_fields")
                and all(isinstance(i, int) for i in t)):
            out.append((path, t))
            return
        items = (sorted(t.items()) if isinstance(t, dict)
                 else zip(t._fields, t) if hasattr(t, "_fields")
                 else enumerate(t))
        for k, v in items:
            walk(v, f"{path}/{k}")

    walk(tree, "")
    return out


def _ref_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jlg))[0]
    return [x for _, x in flat]


@functools.lru_cache(maxsize=None)
def _trees(arch, which):
    """(reference logical leaves, reference shapes, port logical leaves,
    port shapes) of one tree of ``arch``'s full config."""
    jc, c = jget_config(arch), get_config(arch)
    if which == "param":
        jl = JR.param_logical(jc)
        js = jax.eval_shape(lambda: JR.init_params(jax.random.PRNGKey(0), jc,
                                                   jnp.bfloat16))
        pl, ps = R.param_logical(c), R.param_shapes(c)
    elif which == "cache":
        sh = jget_shape(CACHE_SHAPE)
        jl = JR.cache_logical(jc)
        js = JR.cache_specs(jc, sh.global_batch, sh.seq_len)
        pl = R.cache_logical(c)
        ps = R.cache_specs(c, sh.global_batch, sh.seq_len)
    else:
        jl = JR.train_input_logical(jc)
        js = JR.train_input_specs(jc, jget_shape(TRAIN_SHAPE))
        pl = R.train_input_logical(c)
        ps = R.train_input_specs(c, get_shape(TRAIN_SHAPE))
    jshapes = [tuple(x.shape) for x in jax.tree.leaves(js)]
    pshapes = [tuple(x.shape) if isinstance(x, torch.Tensor) else tuple(x)
               for _, x in _port_leaves(ps)]
    return (_ref_leaves(jl), jshapes, [x for _, x in _port_leaves(pl)],
            pshapes)


@pytest.mark.parametrize("which", TREES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_parity(arch, mesh, which):
    jl, jshapes, pl, pshapes = _trees(arch, which)
    assert len(jl) == len(pl) == len(jshapes) == len(pshapes) > 0
    assert pshapes == jshapes
    m = MESHES[mesh]
    for jlog, plog, shape in zip(jl, pl, jshapes):
        assert plog.names == jlog.names
        want = jspec_for(shape, jlog.names, m, J_DEFAULT)
        got = S.spec_for(shape, plog.names, m, S.DEFAULT_RULES)
        assert tuple(got) == tuple(want), (shape, plog.names, got, want)


def test_rule_tables_equal():
    assert S.DEFAULT_RULES == J_DEFAULT
    assert S.LONG_DECODE_RULES == J_LONG


def test_indivisible_heads_drop_to_replicated():
    """qwen2-0.5b's 14 query heads do not divide a 16-way model axis and
    replicate; its d_ff = 4864 still shards over it."""
    c = get_config("qwen2-0.5b")
    m = MESHES["16x16"]
    d, H, hd, f = c.d_model, c.n_heads, c.head_dim, c.d_ff
    assert H == 14
    assert S.spec_for((d, H, hd), ("embed", "heads", "head_dim"), m) == \
        S.P("data", None, None)
    assert S.spec_for((d, f), ("embed", "mlp"), m) == S.P("data", "model")
    # an axis used by an earlier dimension is not reused
    assert S.spec_for((32, 64), ("batch", "embed"), m) == S.P("data", None)
    # an absent axis is dropped from a joint rule
    assert S.spec_for((32, 8), ("batch", None), m) == S.P("data", None)


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    class Named:
        shape = (2, 4)
        mesh_dim_names = ("data", "model")

    m = Named()
    assert S.mesh_shape(m) == {"data": 2, "model": 4}
    assert S.placements_for(S.P(None, "model"), m) == (Replicate(), Shard(1))
    assert S.placements_for(S.P(("model", "data"), None), m) == \
        (Shard(0), Shard(0))


def test_constrain_is_a_noop_outside_axis_rules():
    x = torch.arange(12.0).reshape(3, 4)
    assert S.constrain(x, "batch", "embed") is x
    assert S.current_rules() is None
    with S.axis_rules(MESHES["2x2"]):
        assert S.current_rules()[1] == S.DEFAULT_RULES
        # a plain tensor is the one-device path: unchanged under the rules
        assert S.constrain(x, "batch", "embed") is x
    assert S.current_rules() is None


def test_axis_rules_reach_other_threads():
    """Autograd runs a CUDA backward, and the recompute of a checkpointed
    block, on threads of its own: the rules the forward set must hold
    there too."""
    import threading
    seen = []
    with S.axis_rules(MESHES["2x2"]):
        t = threading.Thread(target=lambda: seen.append(S.current_rules()))
        t.start()
        t.join()
    assert seen[0] is not None and seen[0][1] == S.DEFAULT_RULES
