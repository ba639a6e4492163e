"""The port's energy model and the paper's DSP applications against ``repro``.

``Activity``, ``EnergyModel`` and ``calibrate`` on the same stats, and
``run_app`` / ``run_app_pipelined`` on the same app skeletons (drawn from the
same seed) must give ``repro``'s every ``AppResult`` field: integers equal,
floats within a relative 1e-12.
"""

import pytest

from tests._torch_sim import POLICIES, PORT, REF, assert_same, plain, same_on_both

# the apps run under every policy (the short ones), and the two with many small
# synchronization-free regions under the paper's two ends
APP_CASES = [(app, v) for app in ("dwt", "fft", "aes", "livermore2") for v in POLICIES]
APP_CASES += [(app, v) for app in ("dijkstra", "livermore6") for v in ("scu", "sw")]


def test_app_table_is_the_references():
    assert_same(plain(PORT.apps.APPS), plain(REF.apps.APPS))
    assert PORT.apps.PIPELINED_APPS == REF.apps.PIPELINED_APPS


@pytest.mark.parametrize("app,policy", APP_CASES)
def test_run_app_equals_the_reference(app, policy):
    got = same_on_both(lambda s: s.apps.run_app(s.apps.APPS[app], policy))
    assert got["cycles"] > 0 and got["energy_uj"] > 0 and got["power_mw"] > 0


@pytest.mark.parametrize("policy", ["fifo", "scu"])
def test_run_app_pipelined_equals_the_reference(policy):
    same_on_both(lambda s: s.apps.run_app_pipelined(s.apps.APPS["livermore2"], policy))


@pytest.mark.parametrize("app", ["dwt", "fft"])
def test_lockstep_equals_fastforward_on_an_app(app):
    runs = [same_on_both(lambda s: s.apps.run_app(s.apps.APPS[app], "scu", mode=mode))
            for mode in ("lockstep", "fastforward")]
    assert runs[0] == runs[1]


def test_scu_wins_on_the_reference_apps():
    """The reference's own claim (``tests/test_system.py``), on the port alone."""
    for app in ("dwt", "fft", "livermore6"):
        scu = PORT.apps.run_app(PORT.apps.APPS[app], "SCU")
        sw = PORT.apps.run_app(PORT.apps.APPS[app], "SW")
        assert scu.cycles <= sw.cycles and scu.energy_uj <= sw.energy_uj * 1.01


def _stats(s, policy):
    return s.programs.run_barrier_bench(policy, 8, sfr=30, iters=8).stats


@pytest.mark.parametrize("policy", ["scu", "tas", "sw"])
def test_activity_and_energy_equal_the_reference(policy):
    def energy(s):
        st = _stats(s, policy)
        act = s.energy.Activity.from_stats(st)
        per = s.energy.Activity.per_iter(st, 8, comp_offset=30.0, cycles_offset=30.0)
        model = s.energy.DEFAULT_ENERGY
        return {"act": act, "per_iter": per, "vector": act.vector(), "pj": model.energy_pj(act),
                "nj": model.energy_nj(act), "breakdown": model.breakdown_pj(act), "mw": model.power_mw(act),
                "nop": [model.nop_power_per_cycle_pj(n) for n in (1, 4, 8)],
                "app_adjust": model.app_energy_adjustment_pj(12345.0), "model": model}

    got = same_on_both(energy)
    assert got["pj"] == pytest.approx(sum(got["breakdown"].values()), rel=1e-12)


def test_calibrate_equals_the_reference():
    def fit(s):
        cells = [(s.energy.Activity.per_iter(_stats(s, v), 8), pj, 8) for v, pj in (("scu", 90.0), ("sw", 900.0))]
        anchors = [(s.energy.Activity.per_iter(_stats(s, "sw"), 8), 1000.0, 8, 0.5)]
        return s.energy.calibrate(cells, anchors)

    model, err = same_on_both(fit)
    assert err >= 0.0 and set(model) == {f for f in plain(PORT.energy.DEFAULT_ENERGY)}


@pytest.mark.parametrize("app", [name for name in REF.apps.APPS if name != "pca"])
def test_the_card_checks_the_references_table(app):
    """``chip_smoke.py``'s Table 2 holds the port on the card to
    ``SIM_APP_REFERENCE``: ``repro``'s (cycles, energy uJ, power mW) under
    scu, tas and sw, app by app.  pca's three runs take 14 s of the reference
    alone and are left out here."""
    from chip_smoke import SIM_APP_REFERENCE, SIM_POLICIES, SIM_REL_TOL

    assert set(SIM_APP_REFERENCE) == set(REF.apps.APPS)
    assert set(SIM_APP_REFERENCE[app]) == set(SIM_POLICIES)
    for v in SIM_POLICIES:
        r = REF.apps.run_app(REF.apps.APPS[app], v)
        cycles, energy_uj, power_mw = SIM_APP_REFERENCE[app][v]
        assert r.cycles == cycles, v
        assert r.energy_uj == pytest.approx(energy_uj, rel=SIM_REL_TOL, abs=0), v
        assert r.power_mw == pytest.approx(power_mw, rel=SIM_REL_TOL, abs=0), v