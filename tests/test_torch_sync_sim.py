"""The port's simulator fragments, run by the JAX package's simulator and by the port's own.

Every policy registers simulator fragments.  Here ``repro``'s ``Cluster``
runs the port's through a small adapter that turns the port's op records
into ``repro``'s and passes the values the engine sends back, and every
count must be the same as the JAX package's own fragments give: cycles and
every field of ``ClusterStats``.  The last case runs the port's fragments on
the port's own engine (``repro_torch.core.scu``) beside ``repro``'s
fragments on ``repro``'s engine.
"""

import dataclasses

import pytest

import repro.core.scu.engine as jax_engine
from repro.core.scu import SCU, Cluster, Compute
from repro.core.scu import primitives as jax_primitives
from repro.core.scu.programs import run_barrier_bench, run_chain_bench, run_mutex_bench, run_work_queue_bench
from repro.core.scu.trace import TraceBuilder
from repro.sync import get_policy as jax_get_policy
from repro.sync import register_policy as jax_register_policy
from repro.sync import unregister_policy as jax_unregister_policy
from repro.sync.api import PolicyDef as JaxPolicyDef
import repro_torch.core.scu as port_scu
import repro_torch.core.scu.engine as port_engine
from repro_torch.core.scu import primitives as port_primitives
from repro_torch.sync import get_policy

BUILTINS = ("scu", "tas", "sw", "tree", "tree4", "tree_ew", "fifo")
_OPS = {getattr(port_engine, k): getattr(jax_engine, k) for k in ("Compute", "Mem", "Poll", "Scu")}


def _adapt(gen):
    """A port fragment as a ``repro`` program fragment: same ops, same values sent back."""
    try:
        op = next(gen)
        while True:
            value = yield _OPS[type(op)](**dataclasses.asdict(op))
            op = gen.send(value)
    except StopIteration:
        return


def _adapt_programs(programs):
    return [lambda cluster, cid, p=p: _adapt(p(cluster, cid)) for p in programs]


def _as_jax_policy(name):
    """The port's policy ``name`` in ``repro``'s registry, under ``port_<name>``."""
    port = get_policy(name)
    pipeline = port.make_pipeline_programs
    queue = port.make_work_queue_programs
    return JaxPolicyDef(
        name=f"port_{name}",
        description=port.description,
        make_sim_state=port.make_sim_state,
        sim_barrier=lambda cl, cid, st, cm=None: _adapt(port.sim_barrier(cl, cid, st, cm)),
        sim_mutex=lambda cl, cid, t, st, cm=None: _adapt(port.sim_mutex(cl, cid, t, st, cm)),
        chip_barrier=port.chip_barrier,
        shape_gradients=port.shape_gradients,
        opt_state_specs=port.opt_state_specs,
        make_pipeline_programs=None if pipeline is None else (
            lambda *a: _adapt_programs(pipeline(*a))),
        make_work_queue_programs=None if queue is None else (
            lambda *a: _adapt_programs(queue(*a))),
        trace_barrier=port.trace_barrier,
        trace_mutex=port.trace_mutex,
        trace_safe_barrier=port.trace_safe_barrier,
        trace_safe_mutex=port.trace_safe_mutex,
    )


@pytest.fixture
def as_jax():
    """Registers port policies in ``repro``'s registry for one test, then removes them."""
    added = []

    def register(name):
        jax_register_policy(_as_jax_policy(name))
        added.append(f"port_{name}")
        return f"port_{name}"

    yield register
    for name in added:
        jax_unregister_policy(name)


def test_cost_model_and_addresses_are_the_references():
    assert dataclasses.asdict(port_primitives.DEFAULT_COSTS) == dataclasses.asdict(jax_primitives.DEFAULT_COSTS)
    for name in ("A_BAR_LOCK", "A_BAR_COUNT", "A_BAR_SENSE", "A_MUTEX", "_TAS_FREE"):
        assert getattr(port_primitives, name) == getattr(jax_primitives, name)


def _run_barriers(policy, n, adapt):
    """Staggered arrivals, three back-to-back barriers a core (sense reversal)."""
    cl = Cluster(n_cores=n, scu=SCU(n_cores=n))
    state = policy.make_sim_state(n)
    passed = []

    def prog(delay):
        def p(cluster, cid):
            yield Compute(delay)
            for _ in range(3):
                frag = policy.sim_barrier(cluster, cid, state, None)
                yield from (_adapt(frag) if adapt else frag)
                passed.append((cid, cluster.cycle))

        return p

    cl.load([prog(1 + 9 * i) for i in range(n)])
    stats = cl.run(max_cycles=1_000_000)
    return stats, passed


@pytest.mark.parametrize("name", BUILTINS)
@pytest.mark.parametrize("n", [2, 4, 8])
def test_sim_barrier_cycle_identical(name, n):
    ours, ours_passed = _run_barriers(get_policy(name), n, adapt=True)
    theirs, theirs_passed = _run_barriers(jax_get_policy(name), n, adapt=False)
    assert ours == theirs
    assert ours_passed == theirs_passed


def _run_mutex(policy, n, adapt):
    cl = Cluster(n_cores=n, scu=SCU(n_cores=n))
    state = policy.make_sim_state(n)

    def prog(cluster, cid):
        for _ in range(3):
            frag = policy.sim_mutex(cluster, cid, 5, state, None)
            yield from (_adapt(frag) if adapt else frag)

    cl.load([prog] * n)
    return cl.run(max_cycles=2_000_000)


@pytest.mark.parametrize("name", BUILTINS)
def test_sim_mutex_cycle_identical(name):
    assert _run_mutex(get_policy(name), 4, adapt=True) == _run_mutex(jax_get_policy(name), 4, adapt=False)


@pytest.mark.parametrize("name", BUILTINS)
@pytest.mark.parametrize("compiled", [False, True])
def test_benches_cycle_identical_through_the_jax_registry(as_jax, name, compiled):
    """The JAX package's barrier and mutex benches, compiled traces included
    (the port's ``trace_*`` emitters write into ``repro``'s TraceBuilder)."""
    ours = as_jax(name)
    for bench, kw in ((run_barrier_bench, dict(sfr=10)), (run_mutex_bench, dict(t_crit=5))):
        a = bench(ours, 8, iters=8, compiled=compiled, **kw)
        b = bench(name, 8, iters=8, compiled=compiled, **kw)
        assert a.stats == b.stats, (bench.__name__, name)
        assert a.cycles_per_iter == b.cycles_per_iter


# the chains of tests/test_sync_api.py's fifo tests
@pytest.mark.parametrize("name", ["fifo", "sw"])
@pytest.mark.parametrize("n,sfr,iters,depth", [(8, 100, 16, 8), (4, 60, 12, 1), (4, 60, 12, 2), (4, 60, 12, 8)])
def test_fifo_pipeline_programs_cycle_identical(as_jax, name, n, sfr, iters, depth):
    ours = as_jax(name)
    for compiled in (False, True):
        a = run_chain_bench(ours, n, sfr=sfr, iters=iters, depth=depth, compiled=compiled)
        b = run_chain_bench(name, n, sfr=sfr, iters=iters, depth=depth, compiled=compiled)
        assert a.stats == b.stats


def test_fifo_pipeline_programs_refuse_an_underprovisioned_scu():
    programs = get_policy("fifo").make_pipeline_programs(4, [[10] * 4] * 4, None, None, 4)
    cl = Cluster(n_cores=4, scu=SCU(n_cores=4, n_fifos=2))
    cl.load(_adapt_programs(programs))
    with pytest.raises(RuntimeError, match="provisioning too small"):
        cl.run(max_cycles=10_000)


@pytest.mark.parametrize("producers,consumers", [(2, 2), (1, 3), (3, 1)])
def test_fifo_work_queue_programs_cycle_identical(as_jax, producers, consumers):
    ours = as_jax("fifo")
    for compiled in (False, True):
        a = run_work_queue_bench(ours, producers, consumers, items=24, compiled=compiled)
        b = run_work_queue_bench("fifo", producers, consumers, items=24, compiled=compiled)
        assert a.stats == b.stats


@pytest.mark.parametrize("name", ["sw", "tas"])
def test_trace_emitters_write_identical_rows(name):
    for hook in ("trace_barrier", "trace_mutex"):
        port_hook = getattr(get_policy(name), hook)
        jax_hook = getattr(jax_get_policy(name), hook)
        assert (port_hook is None) == (jax_hook is None)
        if port_hook is None:
            continue
        n = 4
        port_state = get_policy(name).make_sim_state(n)
        jax_state = jax_get_policy(name).make_sim_state(n)
        for cid in range(n):
            ours, theirs = TraceBuilder(), TraceBuilder()
            for _ in range(2):  # two iterations: the local sense flips
                ours.mark()
                theirs.mark()
                if hook == "trace_barrier":
                    port_hook(ours, None, cid, port_state, None)
                    jax_hook(theirs, None, cid, jax_state, None)
                else:
                    port_hook(ours, None, cid, 7, port_state, None)
                    jax_hook(theirs, None, cid, 7, jax_state, None)
            assert ours._rows == theirs._rows, (name, hook, cid)
            assert ours._scu_pool == theirs._scu_pool
            assert ours.build().rows == theirs.build().rows


def _run_on(pkg, policy, n):
    """Staggered arrivals, three barriers and three critical sections a core, on ``pkg``'s engine."""
    cl = pkg.Cluster(n_cores=n, scu=pkg.SCU(n_cores=n))
    state = policy.make_sim_state(n)
    passed = []

    def prog(delay):
        def p(cluster, cid):
            yield pkg.Compute(delay)
            for _ in range(3):
                yield from policy.sim_barrier(cluster, cid, state, None)
                passed.append((cid, cluster.cycle))
                yield from policy.sim_mutex(cluster, cid, 5, state, None)

        return p

    cl.load([prog(1 + 9 * i) for i in range(n)])
    return dataclasses.asdict(cl.run(max_cycles=2_000_000)), passed


@pytest.mark.parametrize("name", BUILTINS)
@pytest.mark.parametrize("n", [2, 8])
def test_port_fragments_on_the_port_engine_equal_repros_on_repros(name, n):
    from repro.core import scu as jax_scu

    assert _run_on(port_scu, get_policy(name), n) == _run_on(jax_scu, jax_get_policy(name), n)
