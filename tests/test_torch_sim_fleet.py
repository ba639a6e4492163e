"""The port's fleets, checkpoints and fleet services against ``repro``.

``simulate_fleet``; ``SlotFleet`` admit / free / snapshot / restore into a
recycled slot; ``FleetService`` with retries, degradation, checkpoints and
preemption; ``FleetPool`` with health, the breaker and reroute; the arrival
traces and ``job_energy``.  Each scenario is written once and run on both
packages, and every job's record and stats must be ``repro``'s.  Fixed seeds
only.
"""

import random

import pytest

from tests._torch_sim import POLICIES, PORT, assert_same, plain, same_on_both


def _bench(s, policy, n, iters=6, sfr=10, max_cycles=100_000):
    fb = s.programs.prep_barrier_bench(policy, n, sfr=sfr, iters=iters, compiled=True)
    fb.config.max_cycles = max_cycles
    return fb.config


def _run_fleet(fleet):
    fin = []
    while not fin:
        fin = fleet.advance()
    assert fin[0].error is None, fin[0].error
    fleet.free(fin[0].index)
    return fin[0].cluster.stats


def _reference(s, policy, n, **kw):
    fleet = s.engine.SlotFleet(2, n)
    fleet.admit(_bench(s, policy, n, **kw))
    return _run_fleet(fleet)


def _job(j):
    """A job's record, without its configs, factories and checkpoint objects."""
    keys = ("job_id", "submitted_round", "admitted_round", "finished_round", "slot", "domain", "stats", "error",
            "state", "attempts", "degraded", "wasted_cycles", "fault_log", "priority", "checkpoint_round",
            "preemptions")  # fmt: skip
    return {k: getattr(j, k) for k in keys}


def _lost_wake_plan(s, victim=3):
    return s.faults.FaultPlan([s.faults.FaultEvent("lost_wake", cycle=10, core=victim, lines=1 << 8)])


# --------------------------------------------------------------------------- the fleet engines


def test_simulate_fleet_equals_the_reference_and_each_run_alone():
    def configs(s):
        out = []
        for i, policy in enumerate(POLICIES):
            for n in (8, 16):
                fb = s.programs.prep_barrier_bench(policy, n, sfr=7 * i, iters=3)
                fb.config.cluster.faults = s.faults.FaultPlan(
                    [s.faults.FaultEvent("stall", 5 + i, core=i % n, span=9),
                     s.faults.FaultEvent("bank_blackout", 20 + i, span=6, banks=(1, 2))])
                out.append(fb.config)
        out.append(s.programs.prep_chain_bench("fifo", 8, sfr=30, iters=6, depth=2).config)
        out.append(s.programs.prep_work_queue_bench("tas", 4, 4, items=12).config)
        return out

    batched = same_on_both(lambda s: s.engine.simulate_fleet(configs(s)))
    alone = []
    for cfg in configs(PORT):
        cfg.cluster.load(cfg.programs)
        alone.append(plain(cfg.cluster.run(cfg.max_cycles)))
    assert_same(batched, alone)


def test_slot_fleet_snapshot_and_restore_five_ways():
    def run(s):
        ref = _reference(s, "tree", 8)
        fleet = s.engine.SlotFleet(2, 8)
        slot = fleet.admit(_bench(s, "tree", 8))
        for _ in range(4):
            assert not fleet.advance()
        ckpt = fleet.snapshot(slot)
        out = {"ref": ref, "after_snapshot": _run_fleet(fleet), "cycle": ckpt.cycle}
        for target in (0, 1):
            fleet.restore(ckpt, slot=target)
            out[f"slot{target}"] = _run_fleet(fleet)
        other = s.engine.SlotFleet(3, 8)
        other.restore(ckpt)
        out["other_fleet"] = _run_fleet(other)
        for mode in ("fastforward", "lockstep"):
            out[mode] = s.checkpoint.restore_cluster(ckpt, mode=mode).run(ckpt.max_cycles)
        return out

    got = same_on_both(run)
    assert got["cycle"] > 0
    for key in ("after_snapshot", "slot0", "slot1", "other_fleet", "fastforward", "lockstep"):
        assert got[key] == got["ref"], key


def _recycled_slot(s, seed, policy, k):
    """A previous tenant burns to a tight cycle cap in the slot, which is freed;
    a checkpoint of ``policy``'s job taken at round ``k`` is restored into it."""
    rng = random.Random(seed)
    n = rng.choice((8, 16))
    ref = _reference(s, policy, n)
    fleet = s.engine.SlotFleet(1, n)
    prev = _bench(s, rng.choice(POLICIES), n, iters=8, max_cycles=rng.randrange(60, 400))
    slot = fleet.admit(prev)
    while True:
        fin = fleet.advance()
        if fin:
            timed_out = fin[0].error is not None
            break
    fleet.free(slot)
    other = s.engine.SlotFleet(2, n)
    other.admit(_bench(s, policy, n))
    for _ in range(k):
        assert not other.advance()
    fleet.restore(other.suspend(0))
    return {"timed_out": timed_out, "ref": ref, "restored": _run_fleet(fleet)}


# seeds of tests/test_checkpoint.py's property whose previous tenant does time
# out (for some draws it finishes under its cap, and that test's premise fails)
@pytest.mark.parametrize("seed,policy,k", [(1, "scu", 3), (2, "tas", 7), (5, "fifo", 1), (11, "tree_ew", 12)])
def test_restore_into_a_recycled_slot_is_residue_free(seed, policy, k):
    got = same_on_both(_recycled_slot, seed, policy, k)
    assert got["timed_out"]
    assert got["restored"] == got["ref"]


def test_generator_programs_are_not_checkpointable():
    def run(s):
        fb = s.programs.prep_barrier_bench("scu", 8, sfr=10, iters=6)
        fleet = s.engine.SlotFleet(1, 8)
        slot = fleet.admit(fb.config)
        fleet.advance()
        try:
            fleet.snapshot(slot)
        except s.checkpoint.NotCheckpointable as err:
            return err
        return None

    assert same_on_both(run)["raised"] == "NotCheckpointable"


# --------------------------------------------------------------------------- the fleet service


def _transient_factory(s):
    def make(attempt):
        config = s.programs.prep_barrier_bench("scu", 8, sfr=20, iters=6).config
        config.max_cycles = 4096
        if attempt == 1:
            config.cluster.faults = _lost_wake_plan(s)
        return config

    return make


def _persistent_factory(s):
    def make(attempt):
        config = s.programs.prep_barrier_bench("scu", 8, sfr=20, iters=6).config
        config.max_cycles = 4096
        config.cluster.faults = _lost_wake_plan(s)
        return config

    return make


def _service(s, case):
    fs = s.fleet_service
    if case == "retry":
        svc = fs.FleetService(n_slots=2, slot_cores=8, retry=fs.RetryPolicy(max_attempts=3))
        jobs = [svc.submit(factory=_transient_factory(s)) for _ in range(3)]
    elif case == "backoff_and_degrade":
        svc = fs.FleetService(1, 8, retry=fs.RetryPolicy(max_attempts=3, backoff_rounds=2, backoff_factor=3,
                                                         degrade_after=2))  # fmt: skip
        jobs = [svc.submit(factory=_persistent_factory(s),
                           fallback_factory=lambda attempt: s.programs.prep_barrier_bench("sw", 8, sfr=20, iters=6).config)]
    elif case == "checkpoint_resume":
        def factory(attempt):
            config = _bench(s, "scu", 8, iters=128, max_cycles=4000)
            if attempt == 1:
                config.cluster.faults = s.faults.FaultPlan([s.faults.FaultEvent(
                    "droop", cycle=2000, cores=tuple(range(8)), span=1_000_000, domain="d0")])
            return config

        svc = fs.FleetService(1, 8, retry=fs.RetryPolicy(max_attempts=2, backoff_rounds=0),
                              checkpoint=fs.CheckpointPolicy(interval_rounds=4))  # fmt: skip
        jobs = [svc.submit(factory=factory)]
    elif case == "preemption":
        svc = fs.FleetService(1, 8, admission_order="priority", preempt=True, aging_rounds=3)
        jobs = [svc.submit(factory=lambda a: _bench(s, "scu", 8, iters=64), priority=0)]
        for _ in range(6):
            svc.step()
        jobs.append(svc.submit(factory=lambda a: _bench(s, "scu", 8, iters=8), priority=5))
    else:  # suspend_all
        svc = fs.FleetService(2, 8, checkpoint=fs.CheckpointPolicy(4))
        jobs = [svc.submit(factory=lambda a, p=p: _bench(s, p, 8, iters=24)) for p in ("scu", "tas", "fifo")]
        for _ in range(6):
            svc.step()
        assert svc.suspend_all() and svc.fleet.occupied == 0
    svc.run_until_drained(max_rounds=500_000)
    return {"jobs": [_job(j) for j in jobs], "round": svc.round, "preemptions": svc.preemptions,
            "idle_lane_fraction": svc.idle_lane_fraction}


@pytest.mark.parametrize("case", ["retry", "backoff_and_degrade", "checkpoint_resume", "preemption", "suspend_all"])
def test_fleet_service_equals_the_reference(case):
    got = same_on_both(_service, case)
    jobs = got["jobs"]
    if case == "retry":
        assert all(j["state"] == "done" and j["attempts"] == 2 and j["wasted_cycles"] == 4096 for j in jobs)
    elif case == "backoff_and_degrade":
        assert jobs[0]["state"] == "done" and jobs[0]["degraded"] and jobs[0]["attempts"] == 3
        assert [e["degraded"] for e in jobs[0]["fault_log"]] == [False, False]
    elif case == "checkpoint_resume":
        assert jobs[0]["state"] == "done" and 0 < jobs[0]["wasted_cycles"] < 4000
        assert jobs[0]["stats"] == plain(_reference(PORT, "scu", 8, iters=128))
    elif case == "preemption":
        assert got["preemptions"] == 1 and jobs[0]["stats"] == plain(_reference(PORT, "scu", 8, iters=64))
    else:
        assert [j["stats"] for j in jobs] == [plain(_reference(PORT, p, 8, iters=24)) for p in ("scu", "tas", "fifo")]


def test_a_poisson_stream_through_the_service_equals_sequential_runs():
    def stream(s):
        arrivals = s.arrivals.poisson_trace(rate=0.02, n_jobs=8, seed=3)
        benches = [s.programs.prep_barrier_bench(POLICIES[i % 7], 8, sfr=13 * i, iters=3 + i % 4) for i in range(8)]
        svc = s.fleet_service.FleetService(n_slots=3, slot_cores=8, queue_limit=64)
        jobs, i = [], 0
        while i < len(benches) or svc.pending or svc.fleet.occupied:
            while i < len(benches) and arrivals[i] <= svc.round:
                jobs.append(svc.submit(benches[i].config))
                i += 1
            svc.step()
        return {"arrivals": arrivals, "jobs": [_job(j) for j in jobs],
                "results": [b.finalize(j.stats) for b, j in zip(benches, jobs)]}

    got = same_on_both(stream)
    seq = [plain(s.run_sequential()) for s in
           [PORT.programs.prep_barrier_bench(POLICIES[i % 7], 8, sfr=13 * i, iters=3 + i % 4) for i in range(8)]]
    assert_same(got["results"], seq)


# --------------------------------------------------------------------------- the fleet pool


def _pool(s, case):
    fs, fp = s.fleet_service, s.fleet_pool

    def clean(attempt):
        config = s.programs.prep_barrier_bench("scu", 8, sfr=20, iters=4).config
        config.max_cycles = 4096
        return config

    def victim(domain, config):
        if domain == 0:
            config.cluster.faults = _lost_wake_plan(s)
        return config

    if case == "reroute_and_breaker":
        pool = fp.FleetPool(n_domains=2, n_slots=1, slot_cores=8,
                            retry=fs.RetryPolicy(max_attempts=3, backoff_rounds=0, reroute=True),
                            breaker=fp.BreakerPolicy(probation_after=1, cooldown_rounds=50, probe_successes=1),
                            inject=victim)  # fmt: skip
        jobs = [pool.submit(factory=clean) for _ in range(4)]
        for _ in range(2):
            for _ in range(40):
                pool.step()
            jobs.append(pool.submit(factory=clean))
    elif case == "watchdog_blame":
        def tripping(attempt):
            config = s.programs.prep_barrier_bench("scu", 8, sfr=20, iters=6).config
            config.cluster.faults = _lost_wake_plan(s)
            config.cluster.scu.watchdog = s.faults.Watchdog(timeout=150, mode="raise")
            return config

        pool = fp.FleetPool(n_domains=2, n_slots=1, slot_cores=8, retry=fs.RetryPolicy(max_attempts=1),
                            breaker=fp.BreakerPolicy(probation_after=1, cooldown_rounds=10, probe_successes=1))
        jobs = [pool.submit(factory=tripping), pool.submit(factory=clean)]
    else:  # migration
        def sick(domain, config):
            if domain == 0:
                config.cluster.faults = s.faults.FaultPlan([s.faults.FaultEvent(
                    "droop", cycle=2000, cores=tuple(range(8)), span=1_000_000, domain="sick")])
            return config

        pool = fp.FleetPool(n_domains=2, n_slots=1, slot_cores=8, placement="round-robin",
                            retry=fs.RetryPolicy(max_attempts=3, backoff_rounds=0, reroute=True),
                            inject=sick, checkpoint=fs.CheckpointPolicy(4))  # fmt: skip
        jobs = [pool.submit(factory=lambda a: _bench(s, "scu", 8, iters=128, max_cycles=4000)) for _ in range(2)]
    pool.run_until_drained(max_rounds=500_000)
    health = [{k: getattr(h, k) for k in ("watchdog_trips", "terminal_failures", "wasted_cycles", "completed",
                                          "failed_attempts")} for h in pool.health]  # fmt: skip
    return {"jobs": [_job(j) for j in jobs], "states": pool.states, "health": health, "round": pool.round,
            "reroutes": pool.reroutes, "quarantines": pool.quarantines, "migrations": pool.migrations,
            "report": pool.domain_report(), "idle_lane_fraction": pool.idle_lane_fraction}


@pytest.mark.parametrize("case", ["reroute_and_breaker", "watchdog_blame", "migration"])
def test_fleet_pool_equals_the_reference(case):
    got = same_on_both(_pool, case)
    jobs = got["jobs"]
    if case == "reroute_and_breaker":
        assert all(j["state"] == "done" for j in jobs) and got["quarantines"] >= 1 and got["reroutes"] >= 1
    elif case == "watchdog_blame":
        assert jobs[0]["state"] == "failed" and "watchdog tripped" in jobs[0]["error"]
        assert jobs[0]["fault_log"][0]["watchdog"] is True and jobs[1]["state"] == "done"
    else:
        assert all(j["state"] == "done" for j in jobs) and got["migrations"] >= 1
        assert all(j["stats"] == plain(_reference(PORT, "scu", 8, iters=128)) for j in jobs)


def test_breaker_and_health_records_validate_as_in_the_reference():
    def bad(s):
        out = []
        for make in (lambda: s.fleet_pool.FleetPool(n_domains=0, n_slots=1, slot_cores=8),
                     lambda: s.fleet_pool.BreakerPolicy(probation_after=0),
                     lambda: s.fleet_pool.DomainHealth(window=0),
                     lambda: s.fleet_service.RetryPolicy(max_attempts=0),
                     lambda: s.fleet_service.CheckpointPolicy(0)):  # fmt: skip
            try:
                make()
                out.append(None)
            except ValueError as err:
                out.append(err)
        return out

    assert all(e["raised"] == "ValueError" for e in same_on_both(bad))


# --------------------------------------------------------------------------- arrivals and energy


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_arrival_traces_equal_the_reference(seed):
    got = same_on_both(lambda s: [s.arrivals.poisson_trace(0.05, 40, seed=seed),
                                  s.arrivals.poisson_trace(3.0, 12, seed=seed),
                                  s.arrivals.bursty_trace(4, 10, gap_rounds=500, seed=seed, jitter=20),
                                  s.arrivals.bursty_trace(3, 2, 100, seed=seed)])  # fmt: skip
    assert all(trace == sorted(trace) for trace in got)


@pytest.mark.parametrize("policy", ["scu", "tas", "sw", "fifo"])
def test_job_energy_equals_the_reference(policy):
    def energy(s):
        st = s.programs.prep_mutex_bench(policy, 8, t_crit=12, iters=8).run_sequential().stats
        e = s.serve_energy.job_energy(st)
        return {"split": e, "total": e.total_pj, "wait": e.wait_pj,
                "model": s.energy.DEFAULT_ENERGY.energy_pj(s.energy.Activity.from_stats(st))}

    got = same_on_both(energy)
    assert got["total"] == pytest.approx(got["model"], rel=1e-12)
