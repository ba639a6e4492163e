"""The port's trace IR, lowering and batched trace executor against the JAX package.

The IR (``repro_torch.core.scu.trace``) and the lowering
(``repro_torch.core.scu.programs``) must give ``repro``'s rows, row for row,
for every registered policy but ``fifo``.  The executor
(``repro_torch.core.scu.trace_exec.run_traces_torch``, here on the CPU) is
held to the engine (``Cluster(..., mode="lockstep")``, the oracle of
``tests/test_trace.py``): ``cycles``, the nine counters, ``bank_conflicts``,
``finished_at`` and the TCDM words, bit for bit, including the programs
where ``repro``'s own array executor is wrong (a contended test-and-set, a
store and loads of one word in one cycle, the barriers, mutexes and chains).
"""

import numpy as np
import pytest
import torch

from chip_smoke import relocate_cluster, relocated_address, same_trace_result, same_word_traces, tas_lock_traces
from chip_smoke import tcdm_traces
from repro.core.scu import SCU, Cluster
from repro.core.scu import trace as jax_trace
from repro.core.scu.engine import _COUNTERS as JAX_COUNTERS
from repro.core.scu.engine import Compute as JaxCompute
from repro.core.scu.engine import Mem as JaxMem
from repro.core.scu.programs import prep_barrier_bench, prep_chain_bench, prep_mutex_bench
from repro_torch.core.scu import trace as port_trace
from repro_torch.core.scu import trace_exec
from repro_torch.core.scu.engine import _COUNTERS, Compute, Mem
from repro_torch.core.scu.programs import trace_barrier_programs, trace_chain_programs, trace_mutex_programs
from repro_torch.core.scu.trace_exec import control_depth, run_traces_torch
from repro_torch.sync import PolicyDef, available_policies, get_policy, register_policy, unregister_policy

LOWERED = ("scu", "tas", "sw", "tree", "tree4", "tree_ew")
# the policies whose lowering carries no SCU rows, which the executor runs
PURE_TCDM = ("sw", "tree", "tree4")


def _key(program):
    return program.is_traced, program.rows, tuple((s.kind, s.addr, s.data) for s in program.scu_pool)


def _engine(programs):
    n = len(programs)
    cl = Cluster(n_cores=n, scu=SCU(n_cores=n), mode="lockstep")
    cl.load(programs)
    return cl, cl.run()


def _assert_engine_result(got, cl, ref, cores=None):
    """``got`` (the executor's) equals the engine's run, field for field."""
    cores = ref.cores if cores is None else cores
    assert got["cycles"] == ref.cycles
    assert got["bank_conflicts"] == ref.bank_conflicts
    for name in _COUNTERS:
        assert got["counters"][name].tolist() == [getattr(c, name) for c in cores], name
    assert got["finished_at"].tolist() == [c.finished_at for c in cores]
    assert set(cl.tcdm) <= set(got["tcdm"])
    assert got["tcdm"] == {a: cl.tcdm.get(a, 0) for a in got["tcdm"]}


# --------------------------------------------------------------------------- the IR


def test_counter_names_are_the_engines():
    assert _COUNTERS == JAX_COUNTERS


def test_builder_gives_the_references_rows_for_the_same_emitter_calls():
    def emit(tb, mem_cls, compute_cls):
        for it in range(4):
            tb.mark()
            tb.compute(3)
            tb.compute(3)  # coalesced into one row of repeat 2
            tb.emit_op(compute_cls(5))
            tb.poll("tas", 0x40, 0, 1, 3)
            tb.mem("lw", 0x44)
            br = tb.br_eq(2)
            tb.mem_delta("sw", 0x44, 1)
            top = tb.label()
            tb.compute(2)
            tb.poll("lw", 0x48, it % 2, 2, 4, 1, 2)
            j = tb.jmp()
            tb.set_target(br, tb.label())
            tb.emit_op(mem_cls("sw", 0x48, it % 2))
            tb.scu("elw", ("barrier", 0, "wait_all"))
            tb.scu("write", ("notifier", 1, "trigger"), 0)
            tb.set_target(j, tb.label())
            if it == 3:
                tb.jmp(top)

    port, ref = port_trace.TraceBuilder(), jax_trace.TraceBuilder()
    emit(port, Mem, Compute)
    emit(ref, JaxMem, JaxCompute)
    for roll in (True, False):
        assert _key(port.build(roll=roll)) == _key(ref.build(roll=roll))


@pytest.mark.parametrize("prim", ["barrier", "mutex", "chain"])
@pytest.mark.parametrize("variant", LOWERED)
def test_lowering_gives_the_references_rows(variant, prim):
    if prim == "barrier":
        port = trace_barrier_programs(variant, 8, sfr=7, iters=6)
        ref = prep_barrier_bench(variant, 8, sfr=7, iters=6, compiled=True).config.programs
    elif prim == "chain":
        port = trace_chain_programs(variant, 8, sfr=7, iters=3)
        ref = prep_chain_bench(variant, 8, sfr=7, iters=3, compiled=True).config.programs
    else:
        port = trace_mutex_programs(variant, 8, t_crit=3, sfr=5, iters=4)
        ref = prep_mutex_bench(variant, 8, t_crit=3, sfr=5, iters=4, compiled=True).config.programs
    assert [_key(p) for p in port] == [_key(p) for p in ref]
    assert all(p.is_traced for p in port)
    assert [p.label for p in port] == [p.label for p in ref]


def test_every_registered_policy_is_covered():
    assert set(available_policies()) == set(LOWERED) | {"fifo"}


def test_fifo_lowering_raises_a_clear_error():
    for lower in (lambda: trace_barrier_programs("fifo", 8, 0, 2), lambda: trace_mutex_programs("FIFO", 8, 3, 0, 2),
                  lambda: trace_chain_programs("fifo", 8, 7, 3)):  # fmt: skip
        with pytest.raises(ValueError, match="fifo policy does not lower"):
            lower()


def test_a_fragment_that_reads_the_cluster_fails_loudly():
    base = get_policy("tree")

    def reads_cluster(cluster, cid, state, cost_model=None):
        yield Compute(cluster.n_banks)

    policy = PolicyDef(
        name="reads_cluster", description="a trace-safe barrier that reads the cluster",
        make_sim_state=base.make_sim_state, sim_barrier=reads_cluster, sim_mutex=base.sim_mutex,
        chip_barrier=base.chip_barrier, shape_gradients=base.shape_gradients,
        opt_state_specs=base.opt_state_specs, trace_safe_barrier=True,
    )  # fmt: skip
    register_policy(policy)
    try:
        with pytest.raises(RuntimeError, match="cluster.n_banks"):
            trace_barrier_programs("reads_cluster", 2, 0, 1)
    finally:
        unregister_policy("reads_cluster")


def test_clone_and_single_use_behave_as_in_the_reference():
    tb = port_trace.TraceBuilder()
    tb.compute(5)
    tb.mem("sw", 0x40, 1)
    tp = tb.build(label="t")
    pre = tp.clone()
    run_traces_torch([tp], n_banks=4, device="cpu")
    assert tp.consumed
    with pytest.raises(RuntimeError, match="consumed"):
        run_traces_torch([tp], n_banks=4, device="cpu")
    post = tp.clone()
    for c in (pre, post):
        assert not c.consumed and c.is_traced and c.rows == tp.rows and c.label == "t"
        assert run_traces_torch([c], n_banks=4, device="cpu")["tcdm"] == {0x40: 1}


def test_a_generator_that_reads_its_resume_value_is_untraceable():
    def reads_value(cluster, cid):
        v = yield Mem("lw", 0x40)
        if v == 0:
            yield Compute(1)

    def jax_reads_value(cluster, cid):
        v = yield JaxMem("lw", 0x40)
        if v == 0:
            yield JaxCompute(1)

    with pytest.raises(port_trace.Untraceable):
        port_trace.trace_generator(port_trace.TraceBuilder(), reads_value(None, 0))
    with pytest.raises(jax_trace.Untraceable):
        jax_trace.trace_generator(jax_trace.TraceBuilder(), jax_reads_value(None, 0))
    port = port_trace.lower_or_fallback(reads_value, None, 3)
    ref = jax_trace.lower_or_fallback(jax_reads_value, None, 3)
    assert (port.is_traced, port.label, port.fallback) == (ref.is_traced, ref.label, reads_value) == (
        False, "fallback:3", reads_value)
    with pytest.raises(ValueError, match="pure traced"):
        run_traces_torch([port], n_banks=4, device="cpu")


@pytest.mark.parametrize("variant", PURE_TCDM)
def test_chain_tables_are_the_references(variant):
    """The chain's packed tables, as the executor reads them, are the reference's;
    a core that has no item in a tick (filling or draining) emits no Compute
    row for it, not one of 0 cycles."""
    port = trace_chain_programs(variant, 8, sfr=7, iters=3)
    ref = prep_chain_bench(variant, 8, sfr=7, iters=3, compiled=True).config.programs
    got, want = trace_exec._pack_tables(port), jax_trace._pack_tables(ref)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert not any(r[0] == port_trace.T_COMPUTE and r[2] == 0 for p in port for r in p.rows)


def test_pack_tables_is_the_references():
    programs = trace_barrier_programs("sw", 8, sfr=7, iters=3) + tcdm_traces(port_trace.TraceBuilder, 3)
    ref = prep_barrier_bench("sw", 8, sfr=7, iters=3, compiled=True).config.programs
    ref += tcdm_traces(jax_trace.TraceBuilder, 3)
    got, want = trace_exec._pack_tables(programs), jax_trace._pack_tables(ref)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


# --------------------------------------------------------------------------- the executor against the engine

H = (port_trace.T_HALT, 1, 0, 0, 0, 0, 0, 0, 0)
C1 = (port_trace.T_COMPUTE, 1, 1, 0, 0, 0, 0, 0, 0)


def _ctl(kind, a0=0, a1=0):
    return (kind, 1, a0, a1, 0, 0, 0, 0, 0)


def test_control_depth_counts_rows_along_every_edge():
    J, B, L = port_trace.T_JMP, port_trace.T_BR, port_trace.T_LOOP
    assert control_depth([C1, H]) == 1
    # JMP -> LOOP -> HALT: three rows in one fetch
    assert control_depth([C1, _ctl(J, 2), _ctl(L, 0, 3), H]) == 3
    # a LOOP that jumps back onto a BR whose fall-through is a JMP onto the HALT
    assert control_depth([C1, _ctl(B, 7, 5), _ctl(J, 5), C1, _ctl(L, 1, 2), H]) == 4
    with pytest.raises(ValueError, match="without reaching a data row"):
        control_depth([_ctl(J, 1), _ctl(B, 0, 0), C1, H])


def _parity_programs():
    """name -> (port programs, reference programs built by repro, n_cores)."""
    PT, JT = port_trace.TraceBuilder, jax_trace.TraceBuilder
    cases = {f"tcdm x{n}": (lambda n=n: tcdm_traces(PT, n), lambda n=n: tcdm_traces(JT, n)) for n in (4, 8, 64)}
    cases["contended tas lock"] = (lambda: tas_lock_traces(PT), lambda: tas_lock_traces(JT))
    cases["same-word store and loads"] = (lambda: same_word_traces(PT), lambda: same_word_traces(JT))
    for v in ("sw", "tree", "tree4"):
        cases[f"{v} barrier x8"] = (
            lambda v=v: trace_barrier_programs(v, 8, sfr=7, iters=3),
            lambda v=v: prep_barrier_bench(v, 8, sfr=7, iters=3, compiled=True).config.programs)
    for v in ("sw", "tree", "tree4", "tree_ew"):
        cases[f"{v} mutex x8"] = (
            lambda v=v: trace_mutex_programs(v, 8, t_crit=3, iters=3),
            lambda v=v: prep_mutex_bench(v, 8, t_crit=3, iters=3, compiled=True).config.programs)
    for v in PURE_TCDM:
        cases[f"{v} chain x8"] = (
            lambda v=v: trace_chain_programs(v, 8, sfr=7, iters=3),
            lambda v=v: prep_chain_bench(v, 8, sfr=7, iters=3, compiled=True).config.programs)
    cases["sw barrier x64"] = (lambda: trace_barrier_programs("sw", 64, sfr=7, iters=1),
                               lambda: prep_barrier_bench("sw", 64, sfr=7, iters=1, compiled=True).config.programs)
    cases["sw mutex x64"] = (lambda: trace_mutex_programs("sw", 64, t_crit=3, iters=1),
                             lambda: prep_mutex_bench("sw", 64, t_crit=3, iters=1, compiled=True).config.programs)
    return cases


PARITY = _parity_programs()


@pytest.mark.parametrize("name", list(PARITY))
def test_executor_equals_the_engine(name):
    port, ref = PARITY[name]
    cl, stats = _engine(ref())
    got = run_traces_torch(port(), n_banks=cl.n_banks, device="cpu")
    _assert_engine_result(got, cl, stats)


def test_the_reference_executor_is_wrong_where_the_port_is_right():
    """``run_traces_xp``'s ``_set`` lets every contender take the lock at once,
    and a losing load undo a store; the port takes the lock one core at a time
    and keeps the store, as the engine does."""
    ref = jax_trace.run_traces_xp(tas_lock_traces(jax_trace.TraceBuilder), n_banks=8)
    got = run_traces_torch(tas_lock_traces(port_trace.TraceBuilder), n_banks=8, device="cpu")
    assert ref["counters"]["tas_accesses"].tolist() == [1, 1, 1, 1] and ref["cycles"] == 16
    assert got["counters"]["tas_accesses"].tolist() == [1, 3, 5, 7] and got["cycles"] == 46
    # a store of 7 that three loads of the same word lose to: the losers write the old 0 back
    ref = jax_trace.run_traces_xp(same_word_traces(jax_trace.TraceBuilder), n_banks=8)
    got = run_traces_torch(same_word_traces(port_trace.TraceBuilder), n_banks=8, device="cpu")
    assert ref["tcdm"] == {0x40: 0} and got["tcdm"] == {0x40: 7}


@pytest.mark.parametrize("n", [4, 8, 64])
def test_executor_equals_the_reference_executor_where_it_is_right(n):
    """On the pure-TCDM programs, where no lane writes a word that another
    requests in the same cycle; on the barriers, mutexes and chains above
    ``run_traces_xp`` does not agree with the engine."""
    ref = jax_trace.run_traces_xp(tcdm_traces(jax_trace.TraceBuilder, n), n_banks=2 * n)
    got = run_traces_torch(tcdm_traces(port_trace.TraceBuilder, n), n_banks=2 * n, device="cpu")
    assert same_trace_result(got, ref)


def test_relocated_clusters_in_one_call_equal_each_cluster_alone():
    sfrs, banks = (0, 32, 5), 16
    programs = []
    for c, sfr in enumerate(sfrs):
        programs += relocate_cluster(trace_barrier_programs("sw", 8, sfr=sfr, iters=3), c, len(sfrs), banks)
    got = run_traces_torch(programs, n_banks=banks * len(sfrs), device="cpu")
    runs = [_engine(prep_barrier_bench("sw", 8, sfr=sfr, iters=3, compiled=True).config.programs) for sfr in sfrs]
    assert got["cycles"] == max(stats.cycles for _, stats in runs)
    assert got["bank_conflicts"] == sum(stats.bank_conflicts for _, stats in runs)
    for c, (cl, stats) in enumerate(runs):
        lanes = slice(8 * c, 8 * c + 8)
        for name in _COUNTERS:
            assert got["counters"][name][lanes].tolist() == [getattr(k, name) for k in stats.cores], name
        assert got["finished_at"][lanes].tolist() == [k.finished_at for k in stats.cores]
        assert max(k.finished_at for k in stats.cores) + 1 == stats.cycles
        for addr in cl.tcdm:
            assert got["tcdm"][relocated_address(addr, c, len(sfrs), banks)] == cl.tcdm[addr]


@pytest.mark.parametrize("block_cycles", [1, 7, 64])
def test_results_do_not_depend_on_the_block(block_cycles):
    cl, stats = _engine(prep_mutex_bench("sw", 8, t_crit=3, iters=2, compiled=True).config.programs)
    got = run_traces_torch(trace_mutex_programs("sw", 8, t_crit=3, iters=2), n_banks=16, device="cpu",
                           block_cycles=block_cycles)  # fmt: skip
    _assert_engine_result(got, cl, stats)


# --------------------------------------------------------------------------- what it refuses


@pytest.mark.parametrize("lower", [lambda: trace_barrier_programs("scu", 4, 0, 2),
                                   lambda: trace_chain_programs("scu", 4, 7, 3)], ids=["barrier", "chain"])
def test_scu_rows_raise(lower):
    with pytest.raises(ValueError, match="SCU"):
        run_traces_torch(lower(), n_banks=8, device="cpu")


def test_a_control_cycle_raises():
    tb = port_trace.TraceBuilder()
    tb.compute(1)
    tb.jmp(tb.label())  # jumps onto itself: no data row on the way
    with pytest.raises(ValueError, match="without reaching a data row"):
        run_traces_torch([tb.build()], n_banks=4, device="cpu")


def test_max_cycles_raises():
    with pytest.raises(RuntimeError, match="within 50 cycles"):
        run_traces_torch(trace_barrier_programs("sw", 8, 7, 3), n_banks=16, device="cpu", max_cycles=50)


def test_without_a_card_the_default_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    programs = tas_lock_traces(port_trace.TraceBuilder)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_traces_torch(programs, n_banks=8)
    assert not any(p.consumed for p in programs)
