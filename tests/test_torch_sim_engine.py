"""The port's cycle-accurate engine, SCU, extensions, faults and trace cursor against ``repro``.

Every microbenchmark of ``repro_torch.core.scu.programs`` runs under all seven
policies, at 2 and 8 cores, in ``lockstep``, in ``fastforward`` and
``fastforward`` over compiled traces (``TraceProgram.__call__``, the cursor
and the period-collapse monitor), and every field of ``MicrobenchResult`` and
its ``ClusterStats`` must be ``repro``'s on the same inputs.  Then the fault
model: a lost wake without a watchdog times out with a wait-for graph that
names it, a release watchdog recovers it, and seeded random plans give the
same outcome in both modes and on both packages.  Fixed seeds only.
"""

import pytest

from tests._torch_sim import POLICIES, PORT, assert_same, plain, same_on_both

BENCHES = {
    "barrier": lambda s, v, n, **kw: s.programs.run_barrier_bench(v, n, sfr=10, iters=6, **kw),
    "mutex": lambda s, v, n, **kw: s.programs.run_mutex_bench(v, n, t_crit=5, sfr=3, iters=4, **kw),
    "chain": lambda s, v, n, **kw: s.programs.run_chain_bench(v, n, sfr=20, iters=5, depth=4, **kw),
    "work_queue": lambda s, v, n, **kw: s.programs.run_work_queue_bench(
        v, n // 2, n - n // 2, items=2 * n, t_produce=7, t_consume=11, **kw),
}
MODES = {"lockstep": dict(mode="lockstep"), "fastforward": dict(mode="fastforward"),
         "compiled": dict(mode="fastforward", compiled=True)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("bench", list(BENCHES))
def test_microbench_equals_the_reference(bench, policy, n, mode):
    got = same_on_both(BENCHES[bench], policy, n, **MODES[mode])
    assert got["stats"]["cycles"] == got["cycles_total"] > 0
    assert len(got["stats"]["cores"]) == n


@pytest.mark.parametrize("mode", ["lockstep", "fastforward"])
@pytest.mark.parametrize("n", [2, 8])
def test_nop_bench_equals_the_reference(n, mode):
    got = same_on_both(lambda s: s.programs.run_nop_bench(n, cycles=512, mode=mode))
    assert [c["comp_cycles"] for c in got["cores"]] == [512] * n


@pytest.mark.parametrize("n", [2, 8])
def test_the_modes_agree_on_the_port(n):
    """lockstep = fastforward = compiled on the port alone, for every policy's barrier and chain."""
    for policy in POLICIES:
        for bench in ("barrier", "chain"):
            runs = [plain(BENCHES[bench](PORT, policy, n, **kw)) for kw in MODES.values()]
            assert runs[0] == runs[1] == runs[2], (policy, bench)


def test_chain_and_pipeline_programs_run_fifo_natively():
    """``fifo``'s chain runs its credit-bounded FIFO pipeline, the other policies
    the barrier-synchronous emulation; both on the port, as in ``repro``."""
    fifo = same_on_both(lambda s: s.programs.run_chain_bench("fifo", 8, sfr=100, iters=32, depth=8))
    sw = same_on_both(lambda s: s.programs.run_chain_bench("sw", 8, sfr=100, iters=32, depth=8))
    assert fifo["cycles_total"] < sw["cycles_total"]
    assert fifo["scu_per_iter"] > 0 and fifo["tcdm_per_iter"] == 0


def test_make_fleet_equals_sequential_runs_and_the_reference():
    def fleet(s, batched):
        benches = [s.programs.prep_barrier_bench(v, n, sfr=13, iters=4) for v in POLICIES for n in (2, 8)]
        benches += [s.programs.prep_mutex_bench("tas", 8, t_crit=4, iters=3),
                    s.programs.prep_work_queue_bench("fifo", 3, 5, items=16)]
        return s.programs.make_fleet(benches) if batched else [b.run_sequential() for b in benches]

    assert_same(same_on_both(fleet, True), plain(fleet(PORT, False)))


# --------------------------------------------------------------------------- the SCU and its extensions


def test_scu_units_and_extensions_equal_the_reference():
    def units(s):
        out = {"ev": {k: getattr(s.scu_unit.EV, k) for k in dir(s.scu_unit.EV) if k.isupper()}}
        fifo = s.extensions.EventFifo()
        out["empty_message"] = fifo.take_message(5)
        fifo.register_popper(1)
        fifo.push(42)
        fifo.evaluate(s.scu_unit.BaseUnits(2))
        out["messages"] = [fifo.take_message(1), fifo.take_message(1)]
        unit = s.scu_unit.SCU(n_cores=8)
        out["shape"] = [len(unit.barriers), len(unit.mutexes), len(unit.fifos), unit.fifo.depth]
        out["state_key"] = repr(unit.state_key())
        return out

    same_on_both(units)


# --------------------------------------------------------------------------- faults and the watchdog


def _lost_wake_run(s, mode, watchdog=None, max_cycles=20_000):
    """The 8-core ``scu`` barrier bench with ``FaultEvent("lost_wake", cycle=10, core=3)``."""
    fb = s.programs.prep_barrier_bench("scu", 8, mode=mode)
    cl = fb.config.cluster
    cl.faults = s.faults.FaultPlan([s.faults.FaultEvent("lost_wake", cycle=10, core=3)])
    if watchdog is not None:
        cl.scu.watchdog = s.faults.Watchdog(**watchdog)
    cl.load(fb.config.programs)
    try:
        stats = cl.run(max_cycles)
    except s.faults.DeadlockError as err:
        return {"error": err, "applied": cl.faults.applied}
    wd = cl.scu.watchdog
    return {"stats": stats, "applied": cl.faults.applied,
            "releases": None if wd is None else (wd.release_count, wd.release_log)}


@pytest.mark.parametrize("mode", ["lockstep", "fastforward"])
def test_lost_wake_without_a_watchdog_times_out_naming_the_fault(mode):
    got = same_on_both(_lost_wake_run, mode)
    assert got["error"]["raised"] == "SimTimeout"
    assert "did not finish" in got["error"]["message"]
    faults = got["error"]["graph"]["faults"]
    assert [(f["kind"], f["core"], f["cycle"]) for f in faults] == [("lost_wake", 3, 10)]
    assert "lost_wake" in got["error"]["message"]


def test_lost_wake_with_a_release_watchdog_recovers_in_both_modes():
    runs = [same_on_both(_lost_wake_run, mode, watchdog=dict(timeout=300, mode="release"))
            for mode in ("lockstep", "fastforward")]
    assert runs[0] == runs[1]
    assert runs[0]["releases"][0] == 2 and len(runs[0]["applied"]) == 1
    # two releases of 300 cycles each on top of the fault-free run's 256 barriers
    clean = plain(PORT.programs.run_barrier_bench("scu", 8))
    assert runs[0]["stats"]["cycles"] == 2141 and clean["cycles_total"] < 2141 - 2 * 300


def test_a_raising_watchdog_trips_with_the_same_graph():
    for mode in ("lockstep", "fastforward"):
        got = same_on_both(_lost_wake_run, mode, watchdog=dict(timeout=300, mode="raise"))
        assert got["error"]["raised"] == "DeadlockError"


def _random_plan_run(s, policy, n, mode, seed):
    plan = s.faults.FaultPlan.random(seed, n_cores=n, n_banks=2 * n, horizon=400, n_events=4)
    fb = s.programs.prep_barrier_bench(policy, n, sfr=20, iters=6, mode=mode)
    cl = fb.config.cluster
    cl.faults = plan
    cl.load(fb.config.programs)
    try:
        return {"plan": plan.events, "stats": cl.run(20_000), "applied": plan.applied}
    except s.faults.DeadlockError as err:
        return {"plan": plan.events, "error": err, "at": cl.cycle, "applied": plan.applied}


# fixed seeds of tests/test_faults.py's lockstep-vs-fastforward property
@pytest.mark.parametrize("seed", [0, 4242, 9999])
@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("policy", ["scu", "tas", "fifo"])
def test_random_fault_plans_agree_across_modes_and_with_the_reference(policy, n, seed):
    lock = same_on_both(_random_plan_run, policy, n, "lockstep", seed)
    fast = same_on_both(_random_plan_run, policy, n, "fastforward", seed)
    assert lock == fast


def test_wait_for_graph_of_a_domain_plan_equals_the_reference():
    def run(s):
        plan = s.faults.FaultPlan.random_domain(7, n_cores=8, n_banks=16, horizon=300)
        fb = s.programs.prep_barrier_bench("scu", 8, sfr=20, iters=6)
        cl = fb.config.cluster
        cl.faults = plan
        cl.load(fb.config.programs)
        stats = cl.run(20_000)
        return {"stats": stats, "applied": plan.applied, "graph": s.faults.build_wait_graph(cl).describe()}

    same_on_both(run)
