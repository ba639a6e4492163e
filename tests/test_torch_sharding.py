"""The port's sharding spec functions against the JAX package's
``PartitionSpec``s, leaf by leaf, and the sync policies' training hooks.

A mesh is a JAX ``Mesh`` on the JAX side and the ordered mapping of its axis
sizes on the port's; a ``PartitionSpec`` is compared with the port's
``Spec`` entry by entry.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import make_axis_mesh
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models.lm import init_lm as jax_init_lm
from repro.parallel import sharding as jax_sharding
from repro.sync import get_policy as jax_get_policy
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models.lm import init_lm
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import Spec, is_spec
from repro_torch.sync import available_policies, get_policy

MESHES = [{"data": 2, "model": 2}, {"data": 4}, {"data": 1}]
ARCHS = ["phi4-mini-3.8b", "mamba2-1.3b"]  # one dense, one SSD


def _jax_mesh(axes):
    return make_axis_mesh(tuple(axes.values()), tuple(axes))


def tree_leaves_with_path(tree, is_leaf=None, path=()):
    """A nested-dict tree's (path of key names, leaf) in jax.tree's order (sorted keys)."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        return [item for k in sorted(tree) for item in tree_leaves_with_path(tree[k], is_leaf, path + (k,))]
    if isinstance(tree, list):
        return [item for i, v in enumerate(tree) for item in tree_leaves_with_path(v, is_leaf, path + (f"[{i}]",))]
    return [(path, tree)]


def _jax_leaves(tree):
    """(path of key names, leaf) in jax.tree's order, PartitionSpecs as leaves."""
    def name(k):
        return k.key if isinstance(k, jax.tree_util.DictKey) else str(k)

    leaves = jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    return [(tuple(name(k) for k in path), leaf) for path, leaf in leaves]


def _assert_same_specs(ours, theirs):
    ours = tree_leaves_with_path(ours, is_leaf=is_spec)
    theirs = _jax_leaves(theirs)
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(ours, theirs):
        assert isinstance(a, Spec), path
        assert tuple(a) == tuple(b), (path, a, b)


def _toy_shapes():
    """The shapes of ``tests/test_sync_api.py``'s ``_toy_grads``."""
    return {"embed": {"table": (16, 8)}, "blocks": {"wq": (4, 8, 8)}, "norm": (8,)}


def _trees(shapes):
    """The same shapes as ShapeDtypeStructs (JAX) and zero tensors (port)."""
    if isinstance(shapes, dict):
        pairs = {k: _trees(v) for k, v in shapes.items()}
        return {k: v[0] for k, v in pairs.items()}, {k: v[1] for k, v in pairs.items()}
    return jax.ShapeDtypeStruct(shapes, np.float32), torch.zeros(shapes)


def _lm_trees(arch):
    jax_params = jax.eval_shape(lambda: jax_init_lm(jax.random.PRNGKey(0), jax_smoke_config(arch)))
    ours = init_lm(torch.Generator().manual_seed(0), get_smoke_config(arch))
    return jax_params, ours


@pytest.mark.parametrize("axes", MESHES, ids=lambda m: "x".join(f"{k}{v}" for k, v in m.items()))
@pytest.mark.parametrize("tree", ["toy"] + ARCHS)
def test_param_specs_equal_the_jax_specs(axes, tree):
    if tree == "toy":
        (jax_tree, ours), cfg, jax_cfg = _trees(_toy_shapes()), None, None
    else:
        (jax_tree, ours), cfg, jax_cfg = _lm_trees(tree), get_smoke_config(tree), jax_smoke_config(tree)
    mesh = _jax_mesh(axes)
    for fsdp in (True, False):
        _assert_same_specs(sharding.param_specs(ours, axes, fsdp=fsdp, cfg=cfg),
                           jax_sharding.param_specs(jax_tree, mesh, fsdp=fsdp, cfg=jax_cfg))  # fmt: skip
    for name in available_policies():
        theirs = jax_get_policy(name).opt_state_specs(jax_tree, mesh, jax_cfg)
        mine = get_policy(name).opt_state_specs(ours, axes, cfg)
        assert set(mine) == set(theirs) == {"master", "m", "v"}
        for key in mine:
            _assert_same_specs(mine[key], theirs[key])


@pytest.mark.parametrize("axes", MESHES + [{"pod": 2, "data": 2, "model": 1}, {"model": 4}],
                         ids=lambda m: "x".join(f"{k}{v}" for k, v in m.items()))
def test_batch_and_zero_spec_equal_the_jax_specs(axes):
    mesh = _jax_mesh(axes)
    assert sharding.dp_axes(axes) == jax_sharding.dp_axes(mesh)
    assert sharding.model_axis_size(axes) == jax_sharding.model_axis_size(mesh)
    for extra in (0, 1, 3):
        assert tuple(sharding.batch_spec(axes, extra)) == tuple(jax_sharding.batch_spec(mesh, extra))
    for spec, shape in [((None, None), (8, 6)), ((None, "model"), (6, 8)), (("model", None), (8, 8)),
                        ((None,), (3,)), ((None, None, None), (2, 12, 4)), (("data", None), (8, 8))]:
        ours = sharding.zero_spec(Spec(*spec), shape, axes)
        assert tuple(ours) == tuple(jax_sharding.zero_spec(P(*spec), shape, mesh)), (spec, shape)


@pytest.mark.parametrize("name", ["tree", "tree4", "fifo"])
def test_extension_opt_state_specs_match_scu(name):
    _, ours = _lm_trees("phi4-mini-3.8b")
    cfg = get_smoke_config("phi4-mini-3.8b")
    axes = {"data": 2, "model": 2}
    assert get_policy(name).opt_state_specs(ours, axes, cfg) == get_policy("scu").opt_state_specs(ours, axes, cfg)


@pytest.mark.parametrize("name", ["scu", "tas", "sw", "tree", "tree4", "tree_ew", "fifo"])
def test_shape_gradients_leave_the_values_bit_identical(name):
    gen = torch.Generator().manual_seed(1)
    grads = {"embed": {"table": torch.randn(16, 8, generator=gen)},
             "blocks": {"wq": torch.randn(4, 8, 8, generator=gen), "wk": torch.randn(4, 8, 8, generator=gen)},
             "norm": torch.randn(8, generator=gen), "head": [torch.randn(3, generator=gen)]}  # fmt: skip
    before = {path: leaf.clone() for path, leaf in tree_leaves_with_path(grads)}
    shaped = get_policy(name).shape_gradients(grads, grads, {"data": 2, "model": 2})
    assert shaped is not grads
    got = tree_leaves_with_path(shaped)
    assert [p for p, _ in got] == list(before)  # same leaves in the same order
    for (path, leaf), (_, orig) in zip(got, tree_leaves_with_path(grads)):
        assert leaf is orig, path
        assert torch.equal(leaf, before[path]), path
    assert list(shaped) == list(grads) and list(shaped["blocks"]) == list(grads["blocks"])
