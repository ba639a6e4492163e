"""The placements of the port over a ``DeviceMesh`` against the JAX
package's ``NamedSharding``s, and sharded checkpoints across the packages.

Port side: one group of 4 processes on ``{"data": 2, "model": 2}``
(``tests/_torch_dist.py``), spawned once for this file.  JAX side: the same
params (a smoke config's, in bf16, drawn by JAX and handed over as a JAX
checkpoint) on the 2 x 2 host mesh of the 4 host devices that
``tests/conftest.py`` requests.  Every comparison is bit for bit.  The spec
level (``cache_specs``, ``NamedSharding.index``) needs no processes.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as P

from repro.compat import make_axis_mesh
from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models.lm import init_lm as jax_init_lm
from repro.parallel import sharding as jax_sharding
from repro.serve import decode as jax_decode
from repro.train import checkpoint as jckpt
from repro_torch.configs.registry import get_smoke_config
from repro_torch.parallel.sharding import NamedSharding, Spec
from repro_torch.serve import decode
from tests._torch_dist import start_group

ARCHS = ("phi4-mini-3.8b", "mamba2-1.3b")  # one dense, one SSD
GRID = {"data": 2, "model": 2}


def _jax_mesh(axes):
    return make_axis_mesh(tuple(axes.values()), tuple(axes))


def _bits(x):
    arr = np.asarray(x)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


def _path(jpath):
    return tuple(k.key if isinstance(k, jax.tree_util.DictKey) else str(k) for k in jpath)


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    """JAX's params and shardings by arch, and the group's results by rank."""
    root = tmp_path_factory.mktemp("dist_sharding")
    mesh = _jax_mesh(GRID)
    jax_side = {}
    for arch in ARCHS:
        cfg = jax_smoke_config(arch)
        params = jax_init_lm(jax.random.PRNGKey(0), cfg, jnp.bfloat16)
        shardings = jax_sharding.param_shardings(params, mesh, cfg)
        jckpt.save_checkpoint(str(root / f"jax_params_{arch}"), 0, {"params": params})
        jckpt.save_checkpoint(str(root / f"jax_sharded_{arch}"), 0, {"params": jax.device_put(params, shardings)})
        jax_side[arch] = (params, shardings)
    results = start_group("placements", 4, root, archs=ARCHS).results()
    return root, mesh, jax_side, results


def _jax_blocks(params, shardings, mesh, coords):
    """{path: (JAX's block at mesh ``coords`` (data, model), its index)}."""
    device = mesh.devices[coords]
    out = {}
    for (jpath, leaf), sh in zip(jax.tree_util.tree_leaves_with_path(params), jax.tree.leaves(shardings)):
        index = sh.devices_indices_map(leaf.shape)[device]
        out[_path(jpath)] = (_bits(leaf)[index], [(s.start or 0, s.stop if s.stop is not None else d)
                                                 for s, d in zip(index, leaf.shape)])  # fmt: skip
    return out


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_the_jax_shard_at_its_mesh_coordinates(placed, arch, rank):
    _, mesh, jax_side, results = placed
    got = results[rank]
    assert got["coords"] == divmod(rank, 2)
    want = _jax_blocks(*jax_side[arch], mesh, got["coords"])
    assert sorted(got[arch]["local"]) == sorted(want)
    for path, (block, index) in want.items():
        assert got[arch]["index"][path] == index, path
        assert got[arch]["local"][path].dtype == block.dtype, path
        np.testing.assert_array_equal(got[arch]["local"][path], block, err_msg=str(path))
        assert got[arch]["gathered"][path], path
    assert any(b.size < np.asarray(jax_side[arch][0]["embed"]["table"]).size for b, _ in want.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_tree_size_bytes_equals_jax(placed, arch):
    _, _, jax_side, results = placed
    want = jax_sharding.tree_size_bytes(jax_side[arch][0])
    assert {r[arch]["bytes_from_blocks"] for r in results} == {r[arch]["bytes_whole"] for r in results} == {want}


@pytest.mark.parametrize("arch", ARCHS)
def test_a_checkpoint_saved_by_the_group_restores_in_jax_bit_equal(placed, arch):
    root, _, jax_side, _ = placed
    params, shardings = jax_side[arch]
    restored = jckpt.restore_checkpoint(str(root / f"group_{arch}"), 0, {"params": params}, {"params": shardings})
    for got, want in zip(jax.tree.leaves(restored), jax.tree.leaves({"params": params})):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(_bits(got), _bits(want))
    for got, sh in zip(jax.tree.leaves(restored), jax.tree.leaves(shardings)):
        assert got.sharding == sh
    # the index of a JAX run's sharded save, slot for slot
    ours = json.loads((root / f"group_{arch}" / "step_000000000" / "index.json").read_text())
    theirs = json.loads((root / f"jax_sharded_{arch}" / "step_000000000" / "index.json").read_text())
    assert ours == theirs
    assert max(len(a["shards"]) for a in ours["arrays"].values()) == 4


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("arch", ARCHS)
def test_a_sharded_jax_checkpoint_restores_into_the_group(placed, arch, rank):
    _, mesh, jax_side, results = placed
    want = _jax_blocks(*jax_side[arch], mesh, divmod(rank, 2))
    got = results[rank][arch]["restored"]
    assert sorted(got) == sorted(want)
    for path, (block, _) in want.items():
        np.testing.assert_array_equal(got[path], block, err_msg=str(path))


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_model_axis_above_one_is_refused_by_name(placed, kind):
    """A train step at ``model = 2`` builds (nothing of it is refused any
    more); a serve call there serves, and only its decode graph, which
    cannot capture a ``gloo`` group's collectives, is refused, naming the
    backend."""
    for result in placed[3]:
        if kind == "train":
            assert result["train_built"] is True
        else:
            message = result[f"{kind}_refusal"]
            assert "'gloo'" in message and "EagerServeStep" in message
            assert result["served"].shape == (4, 3)


MESHES = [{"data": 2, "model": 2}, {"data": 4}, {"data": 1}]


@pytest.mark.parametrize("batch", [4, 1, 3])
@pytest.mark.parametrize("axes", MESHES, ids=lambda m: "x".join(f"{k}{v}" for k, v in m.items()))
@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_cache_specs_equal_the_jax_specs(arch, axes, batch):
    ours = decode.cache_specs(get_smoke_config(arch), axes, batch, 16)
    theirs = jax_decode.cache_specs(jax_smoke_config(arch), _jax_mesh(axes), batch, 16)
    flat = jax.tree_util.tree_leaves_with_path(theirs, is_leaf=lambda x: isinstance(x, P))

    def at(tree, path):
        for key in path:
            tree = tree[key]
        return tree

    assert len(flat) == len(jax.tree.leaves(ours, is_leaf=lambda x: isinstance(x, Spec)))
    for jpath, spec in flat:
        mine = at(ours, _path(jpath))
        assert isinstance(mine, Spec) and tuple(mine) == tuple(spec), (jpath, mine, spec)


@pytest.mark.parametrize("spec,shape", [
    ((("pod", "data"), None), (8, 3)), ((None, "model"), (6, 4)), (("data", ("pod", "model")), (4, 8)),
    ((), ()), ((None,), (5,)), (("model", "data", None), (2, 4, 3)),
])  # fmt: skip
def test_named_sharding_index_equals_jax_at_every_coordinate(spec, shape):
    axes = {"pod": 2, "data": 2, "model": 1}
    mesh = _jax_mesh(axes)
    theirs = JaxNamedSharding(mesh, P(*spec)).devices_indices_map(shape)
    ours = NamedSharding(axes, Spec(*spec))
    for coords in np.ndindex(*axes.values()):
        index = ours.index(shape, dict(zip(axes, coords)))
        want = theirs[mesh.devices[coords]]
        assert [(s.start, s.stop) for s in index] == [(w.start or 0, w.stop if w.stop is not None else d)
                                                     for w, d in zip(want, shape)], coords  # fmt: skip
        assert ours.shard_shape(shape) == tuple(s.stop - s.start for s in index)
        assert ours.global_shape(ours.shard_shape(shape)) == tuple(shape)
