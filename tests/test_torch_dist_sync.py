"""The collectives and the seven chip barriers of the port over a process
axis (``repro_torch.sync.axis.MeshAxis``: one party a process, ``gloo`` on
the CPU) against ``jax.lax``'s in ``shard_map`` and the port's stacked shim.

Port side: one group of 2 and one of 4 processes (``tests/_torch_dist.py``),
each spawned once for this file; the group of 4 also runs every collective
on each axis of a 2 x 2 ``DeviceMesh``, whose group ranks are not the global
ones.  JAX side: the same functions in ``shard_map`` over as many of the host
devices that ``tests/conftest.py`` requests (4).  The words are
integer-valued float32 drawn with numpy from a seed, so every sum is exact
in any order: every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import axis_size as jax_axis_size
from repro.compat import make_axis_mesh, shard_map
from repro.sync import get_policy as jax_get_policy
from repro_torch.sync import get_policy
from tests._torch_dist import BARRIERS, perms, start_group

SIZES = (2, 4)
SHAPES = {"scalar": (), "row": (3,)}


def _words(n):
    return {key: np.random.default_rng(10 * n + len(s)).integers(0, 50, size=(n,) + s).astype(np.float32)
            for key, s in SHAPES.items()}  # fmt: skip


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Each size's group, spawned once and run to its end: {n: (words, per-rank results)}."""
    root = tmp_path_factory.mktemp("dist_sync")
    running = {n: (_words(n), start_group("collectives", n, root / f"n{n}", words=_words(n))) for n in SIZES}
    return {n: (words, group.results()) for n, (words, group) in running.items()}


def _jax_on_axis(fn, words):
    """``fn(local value, "x")`` in ``shard_map`` over len(words) host devices."""
    mesh = make_axis_mesh((words.shape[0],), ("x",))
    run = jax.jit(shard_map(lambda v: fn(v, "x"), mesh=mesh, in_specs=P("x"), out_specs=P("x")))
    return np.asarray(run(jnp.asarray(words)))


def _stacked(results, *key):
    return np.stack([np.asarray(r[key]) for r in results])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n", SIZES)
def test_psum_axis_index_and_axis_size_equal_jax(groups, n, shape):
    words, results = groups[n]
    w = words[shape]
    np.testing.assert_array_equal(_stacked(results, "x", shape, "psum"), _jax_on_axis(jax.lax.psum, w))
    index = _jax_on_axis(lambda v, ax: jnp.broadcast_to(jax.lax.axis_index(ax), v.shape).astype(v.dtype), w)
    assert [r[("x", shape, "index")] for r in results] == [int(i) for i in index.reshape(n, -1)[:, 0]]
    size = _jax_on_axis(lambda v, ax: jnp.full(v.shape, jax_axis_size(ax), v.dtype), w)
    assert {r[("x", shape, "size")] for r in results} == {int(size.flat[0])} == {n}


@pytest.mark.parametrize("perm", list(perms(4)))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n", SIZES)
def test_ppermute_equals_jax(groups, n, shape, perm):
    words, results = groups[n]
    pairs = perms(n)[perm]
    want = _jax_on_axis(lambda v, ax: jax.lax.ppermute(v, ax, pairs), words[shape])
    np.testing.assert_array_equal(_stacked(results, "x", shape, "ppermute", perm), want)


@pytest.mark.parametrize("policy", BARRIERS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n", SIZES)
def test_chip_barrier_over_processes_equals_jax_and_the_stacked_shim(groups, n, shape, policy):
    words, results = groups[n]
    got = _stacked(results, "x", shape, policy)
    np.testing.assert_array_equal(got, _jax_on_axis(jax_get_policy(policy).chip_barrier, words[shape]))
    stacked = get_policy(policy).chip_barrier(torch.from_numpy(words[shape]), "x")
    np.testing.assert_array_equal(got, stacked.numpy())
    assert got.shape == words[shape].shape


@pytest.mark.parametrize("axis", ["data", "model"])
@pytest.mark.parametrize("shape", SHAPES)
def test_collectives_on_each_axis_of_a_2x2_mesh_equal_the_stacked_shim(groups, axis, shape):
    """Rank ``r`` sits at (data, model) = divmod(r, 2); along each axis its
    group's ranks map to other global ranks.  Each row of the mesh along the
    axis is held to the stacked shim on that row's words."""
    from repro_torch.sync.axis import axis_index, ppermute, psum

    words, results = groups[4]
    w = words[shape].reshape((2, 2) + words[shape].shape[1:])
    rows = [w[:, j] for j in range(2)] if axis == "data" else [w[i] for i in range(2)]
    ranks = [[2 * i + j for i in range(2)] for j in range(2)] if axis == "data" else [[2 * i, 2 * i + 1] for i in range(2)]
    for row, members in zip(rows, ranks):
        x = torch.from_numpy(row.copy())
        mine = lambda *key: np.stack([np.asarray(results[r][(axis, shape) + key]) for r in members])  # noqa: E731
        np.testing.assert_array_equal(mine("psum"), psum(x, "x").numpy())
        assert [results[r][(axis, shape, "index")] for r in members] == [0, 1]
        assert {results[r][(axis, shape, "size")] for r in members} == {2}
        for pname, pairs in perms(2).items():
            np.testing.assert_array_equal(mine("ppermute", pname), ppermute(x, "x", pairs).numpy())
        assert int(axis_index(x, "x")[1]) == 1
