"""The port's chip-level barriers, notifier and self-signal against the JAX
package's, and the barrier sweep.

JAX side: the policies' chip barriers inside ``shard_map`` over the host
devices that ``tests/conftest.py`` requests (4).  Port side: the same
parties stacked on the leading axis of one CPU tensor.  Arrival words are
integer-valued float32 drawn with numpy from a seed, so every sum is exact in
any order: the comparisons are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import make_axis_mesh, shard_map
from repro.kernels.scu_barrier import ops as jax_ops
from repro.kernels.scu_barrier.kernel import scu_self_signal_kernel
from repro.sync import get_policy as jax_get_policy
from repro_torch.kernels.scu_barrier import kernel as scu_kernel
from repro_torch.kernels.scu_barrier import ops
from repro_torch.kernels.scu_barrier.ref import barrier_ref
from repro_torch.launch import barriers
from repro_torch.sync import available_policies, get_policy
from repro_torch.sync.axis import axis_index, axis_size, ppermute, psum

BUILTINS = ("scu", "tas", "sw", "tree", "tree4", "tree_ew", "fifo")


def _words(shape, seed):
    return np.random.default_rng(seed).integers(0, 50, size=shape).astype(np.float32)


def _jax_on_axis(fn, words):
    """``fn(local value, "x")`` in ``shard_map`` over len(words) host devices."""
    n = words.shape[0]
    mesh = make_axis_mesh((n,), ("x",))
    run = jax.jit(shard_map(lambda v: fn(v, "x"), mesh=mesh, in_specs=P("x"), out_specs=P("x")))
    return np.asarray(run(jnp.asarray(words)))


@pytest.mark.parametrize("name", BUILTINS)
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("s", [(), (3,)])
def test_chip_barrier_equals_the_jax_policy(name, n, s):
    words = _words((n,) + s, seed=10 * n + len(s))
    want = _jax_on_axis(jax_get_policy(name).chip_barrier, words)
    got = get_policy(name).chip_barrier(torch.from_numpy(words), "x")
    assert got.shape == words.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", BUILTINS)
@pytest.mark.parametrize("n", [1, 2, 3, 5, 6, 7, 8, 16])
def test_chip_barrier_equals_the_oracle(name, n):
    for s in ((), (2, 3)):
        arrive = torch.from_numpy(_words((n,) + s, seed=n))
        got = get_policy(name).chip_barrier(arrive, "x")
        assert torch.equal(got, barrier_ref(arrive)), (name, n, s)
        assert torch.equal(got, ops.ref_barrier_count(arrive, "x"))
    ones = torch.ones(n)
    assert torch.equal(get_policy(name).chip_barrier(ones, "x"), torch.full((n,), float(n)))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("s", [(), (3,), (2, 3)])
def test_barrier_equals_the_jax_oracle(n, s):
    """``ops.barrier`` (K3's entry) against the reference's ``psum`` oracle."""
    words = _words((n,) + s, seed=7 * n + len(s))
    want = _jax_on_axis(jax_ops.ref_barrier_count, words)
    np.testing.assert_array_equal(ops.barrier(torch.from_numpy(words)).numpy(), want)


@pytest.mark.parametrize("target", range(4))
@pytest.mark.parametrize("s", [(5,), (), (2, 3)])
def test_notifier_equals_the_jax_notifier(target, s):
    words = _words((4,) + s, seed=target)
    want = _jax_on_axis(lambda v, ax: jax_ops.notifier(v, ax, target), words)
    got = ops.notifier(torch.from_numpy(words), "x", target)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(8,), (1,), (7,), (130,), (3, 5)])
def test_self_signal_equals_the_pallas_kernel_in_interpret_mode(shape):
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    want = np.asarray(scu_self_signal_kernel(jnp.asarray(x), interpret=True))
    got = ops.self_signal(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_axis_shim_equals_the_jax_collectives():
    words = _words((4, 3), seed=1)
    t = torch.from_numpy(words)
    partial = [(0, 2), (1, 0), (3, 1)]  # party 3 receives nothing
    np.testing.assert_array_equal(
        ppermute(t, "x", partial).numpy(), _jax_on_axis(lambda v, ax: jax.lax.ppermute(v, ax, partial), words)
    )
    np.testing.assert_array_equal(psum(t, "x").numpy(), _jax_on_axis(jax.lax.psum, words))
    idx = _jax_on_axis(lambda v, ax: v * 0 + jax.lax.axis_index(ax), words)
    np.testing.assert_array_equal((t * 0 + axis_index(t, "x")).numpy(), idx)
    assert axis_size(t, "x") == 4
    with pytest.raises(ValueError, match="twice"):
        ppermute(t, "x", [(0, 1), (2, 1)])
    with pytest.raises(TypeError, match="axis"):
        psum(t, 0)


def test_cpu_tensors_take_the_plain_versions_and_the_kernels_refuse_them():
    before = (scu_kernel.scu_barrier.launches, scu_kernel.scu_notifier.launches,
              scu_kernel.scu_self_signal.launches)  # fmt: skip
    ops.barrier(torch.ones(4))
    ops.notifier(torch.ones(4), "x", 1)
    ops.self_signal(torch.ones(4))
    after = (scu_kernel.scu_barrier.launches, scu_kernel.scu_notifier.launches,
             scu_kernel.scu_self_signal.launches)  # fmt: skip
    assert after == before
    for call in (lambda: scu_kernel.scu_barrier(torch.ones(4)),
                 lambda: scu_kernel.scu_notifier(torch.ones(4), 0),
                 lambda: scu_kernel.scu_self_signal(torch.ones(4))):  # fmt: skip
        with pytest.raises(ValueError, match="on the card"):
            call()


def test_barrier_sweep_returns_a_curve_for_every_policy():
    result = barriers.run(parties=4, device="cpu", regions=[1, 2], n_barriers=2, reps=1, verbose=False)
    assert result["passes"] == 2
    assert tuple(result["curves"]) == available_policies()
    for name, curve in result["curves"].items():
        assert [region for region, _, _ in curve] == [1, 2]
        assert all(us > 0 and np.isfinite(over) for _, us, over in curve), name
        assert result["counts"][name] == [4.0] * 4, name
        assert result["notified"][name] == 12.0, name  # three other parties' counts of 4


def test_barrier_sweep_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        barriers.run(parties=2, regions=[1], n_barriers=1, reps=1, verbose=False)
