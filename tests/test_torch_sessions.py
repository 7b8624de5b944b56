"""The port's supply faults, warm replanning sessions, rolling-horizon
replays and queueing margin against the reference's: every test of
tests/test_faults.py, the session tests of tests/test_planner_api.py,
tests/test_rolling.py, tests/test_queueing.py and the queueing tests of
tests/test_extensions.py runs once on each package, keeps its own
assertions, and the two runs' results must be equal bit for bit (wall-clock
fields aside). Numpy on both sides."""
import dataclasses
import importlib
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import _ref_cpu  # noqa: F401  (pins the reference to the CPU)

torch.set_num_threads(1)


def _side(pkg: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")
    return SimpleNamespace(
        name=pkg, core=mod("core"), planner=mod("planner"),
        specs=mod("planner.specs"), rolling=mod("core.rolling"),
        queueing=mod("core.queueing"), solution=mod("core.solution"),
        stage2=mod("core.stage2"))


PORT, REF = _side("repro_torch"), _side("repro")
SIDES = (PORT, REF)
# Fields that follow the wall clock, left out of the comparison.
WALL = {"wall_s", "cpu_s", "runtime_s", "repair_wall_s", "planner_wall_s"}


def _canon(x):
    """A plain, exactly comparable form of a result: arrays by dtype,
    shape and bytes (NaN equal to NaN), floats by their bits, dataclasses
    by class name and fields, without the wall-clock fields."""
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return _canon(x.item())
    if isinstance(x, float):
        return ("f", x.hex())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _canon(getattr(x, f.name))
                 for f in dataclasses.fields(x) if f.name not in WALL})
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items() if k not in WALL}
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [_canon(v) for v in x])
    if isinstance(x, (set, frozenset)):
        return ("set", sorted(map(repr, x)))
    return x


def _both(case, *args):
    """Run one mirrored case on the port and on the reference; their
    results must be bitwise equal. Returns the port's."""
    got, want = case(PORT, *args), case(REF, *args)
    assert _canon(got) == _canon(want)
    return got


def _binding(inst, zeta: float = 0.1):
    """Copy with a binding unmet cap so shedding demand is a violation."""
    return dataclasses.replace(inst, zeta=np.full(inst.I, zeta))


def _result(res):
    """What a `PlanResult` decides: plan, objective, constraint views,
    diagnostics (the repair report included)."""
    return dict(solution=res.solution, objective=res.objective,
                violations=res.violations, slack=res.slack,
                feasible=res.feasible, diagnostics=res.diagnostics,
                options=res.options, solver=res.solver)


# ===========================================================================
# tests/test_faults.py
# ===========================================================================

def _schedule_composition(m):
    c = m.core
    K = 4
    sched = c.FaultSchedule(n_windows=10, events=(
        c.TierOutage(tier=1, t0=2, t1=5),
        c.CapacityShock(t0=3, t1=7, avail_frac=0.5),
        c.SpotRevocation(tier=2, t0=3, t1=6, frac=0.8),
        c.PriceSpike(tier=0, t0=1, t1=9, mult=3.0),
        c.PriceSpike(tier=0, t0=2, t1=4, mult=2.0),
    ))
    assert not sched.is_empty
    af = sched.avail_frac(3, K)
    assert af[1] == 0.0
    assert af[0] == af[3] == 0.5
    assert np.isclose(af[2], min(0.5, 0.2))
    pm = sched.price_mult(3, K)
    assert np.isclose(pm[0], 6.0)
    assert np.all(pm[1:] == 1.0)
    assert np.all(sched.avail_frac(0, K) == 1.0)
    assert np.all(sched.price_mult(0, K) == 1.0)
    return af, pm


def test_schedule_composition_min_avail_product_price():
    _both(_schedule_composition)


def _recovery_clips(m):
    c = m.core
    sched = c.FaultSchedule(n_windows=10, events=(
        c.TierOutage(tier=1, t0=2, t1=8),
        c.TierOutage(tier=2, t0=2, t1=8),
    ))
    clipped = c.FaultSchedule(n_windows=10, events=sched.events
                              + (c.Recovery(t=5, tier=1),))
    assert clipped.avail_frac(6, 3)[1] == 1.0
    assert clipped.avail_frac(6, 3)[2] == 0.0
    everyone = c.FaultSchedule(n_windows=10,
                               events=sched.events + (c.Recovery(t=5),))
    assert np.all(everyone.avail_frac(6, 3) == 1.0)
    return [s.avail_frac(t, 3) for s in (sched, clipped, everyone)
            for t in range(10)]


def test_recovery_clips_matching_events():
    _both(_recovery_clips)


def _change_points(m):
    c = m.core
    K = 3
    sched = c.FaultSchedule(n_windows=12, events=(
        c.TierOutage(tier=0, t0=3, t1=6),
        c.PriceSpike(tier=1, t0=6, t1=9, mult=2.0),
    ))
    pts = sorted(sched.change_points(K))
    assert pts == [3, 6, 9]
    for t in range(1, 12):
        same = (np.array_equal(sched.avail_frac(t, K),
                               sched.avail_frac(t - 1, K))
                and np.array_equal(sched.price_mult(t, K),
                                   sched.price_mult(t - 1, K)))
        assert same == (t not in pts)
    keys = [sched.state_key(t, K) for t in range(12)]
    assert len(set(keys)) == 3
    return pts, keys


def test_change_points_cover_every_state_transition():
    _both(_change_points)


def _identity_fast_path(m):
    c = m.core
    inst = c.default_instance()
    sched = c.FaultSchedule(n_windows=8,
                            events=(c.TierOutage(tier=0, t0=4, t1=6),))
    assert c.apply_faults(inst, sched, 1) is inst
    assert c.apply_faults(inst, c.FaultSchedule(8, ()), 5) is inst
    return c.apply_faults(inst, sched, 4).avail_gpus


def test_apply_faults_identity_fast_path():
    _both(_identity_fast_path)


def _outage_and_spike(m):
    c = m.core
    inst = c.default_instance()
    sched = c.FaultSchedule(n_windows=8, events=(
        c.TierOutage(tier=2, t0=1, t1=5),
        c.PriceSpike(tier=3, t0=1, t1=5, mult=2.5),
    ))
    f = c.apply_faults(inst, sched, 2)
    assert f.avail_gpus is not None and f.avail_gpus[2] == 0.0
    assert np.isclose(f.p_c[3], inst.p_c[3] * 2.5)
    assert not np.any(f.mem_ok[:, 2, :])
    assert np.isinf(f.avail_gpus[0])
    assert np.isclose(f.p_c[0], inst.p_c[0])
    return f.avail_gpus, f.p_c, f.mem_ok


def test_apply_faults_outage_kills_tier_and_spike_scales_price():
    _both(_outage_and_spike)


def _scales_nominal_caps(m):
    c = m.core
    inst = dataclasses.replace(c.default_instance(),
                               avail_gpus=np.full(10, 8.0))
    sched = c.FaultSchedule(n_windows=4, events=(
        c.CapacityShock(t0=0, t1=4, avail_frac=0.49),))
    f = c.apply_faults(inst, sched, 1)
    assert np.all(f.avail_gpus == np.floor(8.0 * 0.49))
    return f.avail_gpus


def test_apply_faults_scales_nominal_caps():
    _both(_scales_nominal_caps)


def _generators(m):
    c = m.core
    inst = c.with_spot_tiers(c.default_instance(), np.arange(10),
                             revoke_rate=0.4)
    a = c.poisson_revocations(inst, 48, seed=5)
    b = c.poisson_revocations(inst, 48, seed=5)
    assert a == b and len(a) > 0
    assert a != c.poisson_revocations(inst, 48, seed=6)
    assert c.poisson_revocations(c.default_instance(), 48, seed=5) == []
    da = c.diurnal_outages(c.default_instance(), 48, n_events=4, seed=2)
    assert da == c.diurnal_outages(c.default_instance(), 48, n_events=4,
                                   seed=2)
    assert len(da) == 4
    for ev in da:
        assert 0 <= ev.t0 < 48
    return a, da


def test_generators_are_deterministic():
    _both(_generators)


def _spot_tiers(m):
    c = m.core
    inst = c.default_instance()
    spot = c.with_spot_tiers(inst, np.array([1, 3]), discount=0.7,
                             revoke_rate=0.3)
    assert np.isclose(spot.p_c[1], inst.p_c[1] * 0.7)
    assert np.isclose(spot.p_c[0], inst.p_c[0])
    assert list(np.flatnonzero(spot.spot)) == [1, 3]
    assert spot.revoke_rate[3] == 0.3 and spot.revoke_rate[0] == 0.0
    return spot.p_c, spot.spot, spot.revoke_rate


def test_with_spot_tiers_discounts_and_marks():
    _both(_spot_tiers)


def _lost_pairs(m):
    c = m.core
    inst = c.default_instance()
    sol = c.agh(inst)
    used = sol.y.sum(axis=0)
    k = int(np.argmax(used))
    jj = np.flatnonzero(sol.y[:, k] > 0)
    smallest = jj[np.argmin(sol.y[jj, k])]
    cap = np.full(inst.K, np.inf)
    cap[k] = used[k] - sol.y[smallest, k]
    capped = dataclasses.replace(inst, avail_gpus=cap)
    lost = c.lost_pairs(capped, sol.y)
    assert (int(smallest), k) in lost
    y_after = sol.y.copy()
    for (j, kk) in lost:
        y_after[j, kk] = 0.0
    assert np.all(y_after.sum(axis=0) <= cap + 1e-9)
    return lost, y_after


def test_lost_pairs_evicts_smallest_first_until_under_cap():
    _both(_lost_pairs)


def _evict_unavailable(m):
    c = m.core
    inst = c.default_instance()
    sol = c.agh(inst)
    k = int(np.argmax(sol.y.sum(axis=0)))
    dead = dataclasses.replace(
        inst, avail_gpus=np.where(np.arange(inst.K) == k, 0.0, np.inf))
    op, lost = c.evict_unavailable(dead, sol)
    assert lost and all(kk == k for (_, kk) in lost)
    assert np.all(op.y[:, k] == 0) and not np.any(op.x[:, :, k] > 0)
    assert np.allclose(op.x.sum(axis=(1, 2)) + op.u, 1.0)
    keep = np.ones(inst.K, bool)
    keep[k] = False
    assert np.array_equal(op.y[:, keep], sol.y[:, keep])
    return op, lost


def test_evict_unavailable_preserves_demand_identity():
    _both(_evict_unavailable)


def _agh_caps(m):
    c = m.core
    inst = c.random_instance(8, 8, 6, seed=1)
    ref = c.agh(inst)
    caps = np.maximum(np.ceil(ref.y.sum(axis=0) * 0.6), 1.0)
    capped = dataclasses.replace(inst, avail_gpus=caps)
    sol = c.agh(capped)
    assert np.all(sol.y.sum(axis=0) <= caps + 1e-9)
    assert c.is_feasible(capped, sol, enforce_zeta=False)
    again = c.agh(inst)
    assert np.array_equal(ref.x, again.x) and np.array_equal(ref.y, again.y)
    return sol, ref


def test_agh_respects_availability_caps():
    _both(_agh_caps)


def _agh_repair(m):
    c = m.core
    inst = c.default_instance()
    base = c.agh(inst)
    k = int(np.argmax(base.y.sum(axis=0)))
    faulted = dataclasses.replace(
        inst, avail_gpus=np.where(np.arange(inst.K) == k, 0.0, np.inf))
    stats: dict = {}
    rep = c.agh_repair(faulted, base, stats=stats)
    assert rep.method == "AGH-repair"
    assert stats["repair"] and len(stats["evicted"]) > 0
    assert all(kk == k for (_, kk) in stats["evicted"])
    assert c.is_feasible(faulted, rep, enforce_zeta=False)
    assert np.all(rep.y[:, k] == 0)
    return rep, stats


def test_agh_repair_feasible_and_subsumes_eviction():
    _both(_agh_repair)


def _repair_survivable(m):
    c = m.core
    sess = m.planner.PlanSession()
    inst = _binding(c.default_instance(), zeta=0.9)
    sess.plan(instance=inst)
    k = int(np.argmax(sess.incumbent.y.sum(axis=0)))
    sched = c.FaultSchedule(n_windows=6,
                            events=(c.TierOutage(tier=k, t0=1, t1=5),))
    res = sess.repair(schedule=sched, t=2)
    rep = res.diagnostics["repair"]
    assert rep["warm"] is True and rep["evicted"]
    assert res.feasible and rep["degradation"]["level"] == 0
    assert sess.repairs == 1
    assert sess.incumbent is res.solution
    return _result(res), sess.replan_log


def test_repair_survivable_fault_is_feasible_level0():
    _both(_repair_survivable)


def _repair_catastrophe(m):
    c = m.core
    inst = _binding(c.default_instance())
    sess = m.planner.PlanSession()
    sess.plan(instance=inst)
    sched = c.FaultSchedule(n_windows=4, events=tuple(
        c.TierOutage(tier=k, t0=0, t1=4) for k in range(inst.K)))
    res = sess.repair(schedule=sched, t=1)
    deg = res.diagnostics["repair"]["degradation"]
    assert not res.feasible
    assert deg["level"] >= 1
    assert deg["violations"]
    assert deg["ladder"][0] == "strict"
    assert deg["zeta_overshoot"] > 0
    sess2 = m.planner.PlanSession()
    sess2.plan(instance=inst)
    res2 = sess2.repair(schedule=sched, t=1)
    assert res2.diagnostics["repair"]["degradation"]["level"] == deg["level"]
    assert np.isclose(res2.objective, res.objective)
    return _result(res), _result(res2)


def test_repair_catastrophe_reports_degradation_never_silent():
    _both(_repair_catastrophe)


def _repair_cold(m):
    sess = m.planner.PlanSession()
    res = sess.repair(instance=m.core.default_instance())
    rep = res.diagnostics["repair"]
    assert rep["warm"] is False and rep["evicted"] == []
    assert res.feasible and rep["degradation"]["level"] == 0
    return _result(res)


def test_repair_without_incumbent_falls_back_cold():
    _both(_repair_cold)


def test_repair_requires_some_instance():
    for m in SIDES:
        with pytest.raises(ValueError):
            m.planner.PlanSession().repair()


def _faulted_replay(m):
    c = m.core
    inst = _binding(c.default_instance(), zeta=0.5)
    spot = c.with_spot_tiers(inst, np.arange(inst.K), revoke_rate=0.3)
    T = 12
    evs = c.poisson_revocations(spot, T, seed=3)
    base = c.agh(inst)
    busiest = int(np.argmax(base.y.sum(axis=0)))
    sched = c.FaultSchedule(T, tuple(evs) + (
        c.TierOutage(tier=busiest, t0=4, t1=8),))
    assert sorted(sched.change_points(inst.K))
    rng = np.random.default_rng(0)
    lam_path = np.clip(
        inst.lam[None, :] * (1.0 + 0.1 * rng.standard_normal((T, inst.I))),
        0.0, None)
    opts = m.planner.PlanOptions(workers=0)

    def bare(inst):
        return m.planner.plan("agh", instance=inst, options=opts).solution

    results = {}
    for mode in ("repair", "cold", "static"):
        planner = (m.planner.PlanSession(options=opts) if mode == "repair"
                   else bare)
        results[mode] = c.rolling(
            spot, lam_path, planner,
            replan_every=(None if mode == "static" else 4),
            faults=sched, fault_response=mode)
    assert results["repair"].fault_replans > 0
    assert results["repair"].evictions > 0
    assert all(w < 1.0 for w in results["repair"].repair_wall_s)
    assert (results["static"].violation_rate
            >= results["repair"].violation_rate - 1e-9)
    assert (results["repair"].violation_rate
            <= results["cold"].violation_rate + 1e-9)
    r_empty = c.rolling(spot, lam_path, m.planner.PlanSession(options=opts),
                        replan_every=4, faults=c.FaultSchedule(T, ()))
    r_none = c.rolling(spot, lam_path, m.planner.PlanSession(options=opts),
                       replan_every=4)
    assert np.allclose(r_empty.per_window_cost, r_none.per_window_cost)
    return results, r_empty, r_none


def test_faulted_replay_repair_dominates_static_and_matches_cold():
    _both(_faulted_replay)


def _spot_fleet(m):
    spec = m.specs.scenario("spot-fleet", n_windows=24)
    inst = spec.build()
    assert inst.spot is not None and inst.spot.any()
    for k, name in enumerate(inst.tier_names):
        assert inst.spot[k] == ("INT" in str(name).upper())
    base = m.specs.scenario("paper-default").build()
    assert np.allclose(inst.p_c[inst.spot], base.p_c[inst.spot] * 0.8)
    assert np.allclose(inst.p_c[~inst.spot], base.p_c[~inst.spot])
    fs = spec.fault_schedule(inst)
    assert not fs.is_empty and fs == spec.fault_schedule(inst)
    sol = m.core.agh(inst)
    assert m.core.is_feasible(inst, sol, enforce_zeta=False)
    return inst.p_c, inst.spot, fs, sol


def test_spot_fleet_scenario_builds_and_schedules():
    _both(_spot_fleet)


def _multi_region(m):
    spec = m.specs.scenario("multi-region")
    inst = spec.build()
    base = m.specs.scenario("paper-default").build()
    assert np.all(inst.p_c > base.p_c)
    placed = spec.fleet.region_of(base)
    assert set(placed) == set(m.specs.REGION_INTENSITY)
    assert spec.fault_schedule(inst, n_windows=12).is_empty
    sol = m.core.agh(inst)
    assert m.core.is_feasible(inst, sol, enforce_zeta=False)
    return inst.p_c, list(placed), sol


def test_multi_region_scenario_carbon_prices_rental():
    _both(_multi_region)


def test_faults_module_is_lint_clean_under_the_determinism_rules():
    """The port's faults.py, linted by the reference's rules at the
    reference's path (inside their determinism scope): clean, and the
    same file with a stdlib-random call injected trips RPR202."""
    from repro.analysis.lint import lint_source
    repo = Path(__file__).resolve().parent.parent
    scope = (repo / "src" / "repro" / "core" / "faults.py").as_posix()
    port = repo / "src" / "repro_torch" / "core" / "faults.py"
    source = port.read_text()
    rules = lambda src: [d.rule for d in lint_source(
        src, display=str(port), posix=scope, path=port).diagnostics]
    assert rules(source) == []
    doctored = source + ("\n\ndef _bad():\n    import random\n"
                         "    return random.random()\n")
    assert "RPR202" in rules(doctored)


try:
    from hypothesis import given, settings, strategies as st

    @st.composite
    def faulted_repairs(draw):
        I = draw(st.integers(2, 5))
        J = draw(st.integers(2, 4))
        K = draw(st.integers(2, 5))
        seed = draw(st.integers(0, 5_000))
        zeta = draw(st.floats(0.05, 0.6))
        n_down = draw(st.integers(1, K))
        tiers = draw(st.permutations(list(range(K))))[:n_down]
        shock = (draw(st.floats(0.0, 0.8)) if draw(st.booleans())
                 else None)
        return (I, J, K, seed, zeta, tuple(tiers), shock)

    def _repair_case(m, case):
        I, J, K, seed, zeta, tiers, shock = case
        c = m.core
        inst = _binding(c.random_instance(I, J, K, seed=seed), zeta=zeta)
        T = 8
        events = tuple(c.TierOutage(tier=k, t0=1, t1=T) for k in tiers)
        if shock is not None:
            events += (c.CapacityShock(t0=1, t1=T, avail_frac=shock),)
        sess = m.planner.PlanSession()
        sess.plan(instance=inst)
        res = sess.repair(schedule=c.FaultSchedule(n_windows=T,
                                                   events=events), t=2)
        deg = res.diagnostics["repair"]["degradation"]
        if res.feasible:
            assert deg["level"] == 0
        else:
            assert deg["level"] >= 1, deg
            assert deg["violations"], deg
            assert deg["ladder"] and deg["ladder"][0] == "strict"
        assert sess.incumbent is res.solution
        assert np.allclose(
            res.solution.x.sum(axis=(1, 2)) + res.solution.u, 1.0)
        return _result(res)

    @settings(max_examples=20, deadline=None)
    @given(faulted_repairs())
    def test_repair_feasible_or_explicit_degradation(case):
        _both(_repair_case, case)
except ImportError:          # pragma: no cover - CI always has hypothesis
    @pytest.mark.skip(reason="hypothesis not installed")
    def test_repair_feasible_or_explicit_degradation():
        pass


# ===========================================================================
# PlanSession (tests/test_planner_api.py)
# ===========================================================================

def _cold_then_warm(m):
    inst = m.core.random_instance(6, 6, 10, seed=1)
    ses = m.planner.PlanSession(options=m.planner.PlanOptions(workers=0))
    r0 = ses.plan(instance=inst)
    assert ses.plans == 1 and ses.warm_replans == 0
    assert not r0.diagnostics["warm_started"]
    drifted = inst.with_lam(inst.lam * 1.08)
    r1 = ses.replan(instance=drifted)
    assert ses.plans == 2 and ses.warm_replans == 1
    assert r1.diagnostics["warm_started"]
    assert r1.feasible
    assert ses.incumbent is r1.solution
    r2 = ses.replan(lam=inst.lam * 0.95)
    assert r2.feasible and ses.warm_replans == 2
    return [_result(r) for r in (r0, r1, r2)], ses.replan_log


def test_session_cold_then_warm_replan():
    _both(_cold_then_warm)


def _without_incumbent(m):
    ses = m.planner.PlanSession()
    res = ses.replan(instance=m.core.default_instance())
    assert not res.diagnostics.get("warm_started", False)
    assert ses.plans == 1 and ses.warm_replans == 0
    return _result(res)


def test_session_without_incumbent_degrades_to_cold():
    _both(_without_incumbent)


def _winning_order(m):
    inst = m.core.random_instance(8, 5, 6, seed=2)
    ses = m.planner.PlanSession(options=m.planner.PlanOptions(workers=0))
    ses.plan(instance=inst)
    if ses.winning_order is not None:
        assert sorted(ses.winning_order) == list(range(inst.I))
    r1 = ses.replan(instance=inst.with_lam(inst.lam * 1.05))
    assert r1.diagnostics["restarts"] == ses.replan_restarts
    return ses.winning_order, _result(r1)


def test_session_remembers_winning_order():
    _both(_winning_order)


def _drives_rolling(m):
    inst = m.core.default_instance()
    path = np.outer(np.linspace(0.9, 1.1, 12), inst.lam)
    ses = m.planner.PlanSession(options=m.planner.PlanOptions(
        restarts=1, patience=2, workers=0))
    res = m.core.rolling(inst, path, ses, replan_every=4)
    assert res.per_window_cost.shape == (12,)
    assert ses.plans >= 2
    assert ses.warm_replans >= 1
    return res, ses.replan_log


def test_session_drives_rolling_replay():
    _both(_drives_rolling)


def _seed_incumbent(m):
    inst = m.core.random_instance(6, 6, 10, seed=1)
    opts = m.planner.PlanOptions(workers=0)
    res = m.planner.plan("agh", instance=inst, options=opts)
    ses = m.planner.PlanSession(options=opts)
    ses.seed(inst, res)
    assert ses.incumbent is res.solution
    r1 = ses.replan(lam=inst.lam * 1.05)
    assert r1.diagnostics["warm_started"] and ses.warm_replans == 1
    return _result(r1)


def test_session_seed_installs_external_incumbent():
    _both(_seed_incumbent)


def _non_warm_solver(m):
    ses = m.planner.PlanSession(solver="gh")
    inst = m.core.default_instance()
    ses.plan(instance=inst)
    r = ses.replan(instance=inst.with_lam(inst.lam * 1.1))
    assert r.diagnostics["warm_started"] is False
    return _result(r)


def test_non_warm_solver_session_stays_cold():
    _both(_non_warm_solver)


# ===========================================================================
# tests/test_rolling.py
# ===========================================================================

def _const(m, T):
    inst = m.core.default_instance()
    return inst, m.core.gh(inst), np.tile(inst.lam, (T, 1))


def _pricing_invariant(m):
    totals, costs = {}, {}
    for T in (96, 288):
        inst, plan, path = _const(m, T)
        r = m.core.rolling(inst, path, lambda i, p=plan: p,
                           replan_every=None)
        assert r.per_window_cost.shape == (T,)
        totals[T], costs[T] = r.total_cost, r
    assert totals[96] == pytest.approx(totals[288], rel=1e-9)
    assert totals[96] / 96 == pytest.approx(totals[288] / 288 * 3, rel=1e-9)
    return costs


def test_window_pricing_invariant_to_window_count():
    _both(_pricing_invariant)


def _pricing_at_288(m):
    from repro.core._scalar_ref import stage2_lp_ref
    T = 288
    inst, plan, path = _const(m, T)
    r = m.core.rolling(inst, path, lambda i, p=plan: p, replan_every=None)
    cap = np.full(inst.I, m.rolling.STRICT_CAP)
    sol, _ = stage2_lp_ref(inst, plan, u_cap=cap)
    want = (m.solution.provisioning_cost(inst, plan) / inst.Delta_T
            * (24.0 / 288.0)
            + m.stage2.stage2_cost(inst, sol) * (24.0 / 288.0))
    assert r.per_window_cost[0] == pytest.approx(want, rel=1e-9)
    assert r.total_cost == pytest.approx(T * want, rel=1e-9)
    return r


def test_window_pricing_matches_seed_at_288():
    _both(_pricing_at_288)


def _batched_vs_loop(m):
    inst = m.core.default_instance()
    rng = np.random.default_rng(0)
    mult = 1.0 + 0.5 * np.sin(np.linspace(0, 2 * np.pi, 18)) \
        + rng.uniform(-0.05, 0.05, 18)
    path = np.outer(mult, inst.lam)
    planner = lambda i: m.core.gh(i)
    rb = m.core.rolling(inst, path, planner, replan_every=6)
    rl = m.core.rolling(inst, path, planner, replan_every=6, batched=False)
    assert rb.replans == rl.replans
    assert rb.violation_rate == rl.violation_rate
    assert np.allclose(rb.per_window_cost, rl.per_window_cost,
                       rtol=1e-9, atol=1e-9)
    return rb, rl


def test_rolling_batched_matches_window_loop():
    _both(_batched_vs_loop)


def _keep_best_rejects(m):
    inst, plan, path = _const(m, 12)
    calls = {"n": 0}

    def planner(i):
        calls["n"] += 1
        if calls["n"] == 1:
            return plan
        return m.core.Solution.empty(i)

    r = m.core.rolling(inst, path, planner, replan_every=4)
    assert calls["n"] > 1
    assert r.replans == 0
    r_static = m.core.rolling(inst, path, lambda i, p=plan: p,
                              replan_every=None)
    assert r.total_cost == pytest.approx(r_static.total_cost, rel=1e-9)
    return r, r_static


def test_keep_best_rejects_worse_candidate():
    _both(_keep_best_rejects)


def _keep_best_adopts(m):
    inst, _, path = _const(m, 8)
    calls = {"n": 0}

    def planner(i):
        calls["n"] += 1
        if calls["n"] == 1:
            return m.core.Solution.empty(i)
        return m.core.gh(i)

    r = m.core.rolling(inst, path, planner, replan_every=4)
    assert r.replans >= 1
    r_bad = m.core.rolling(inst, path, lambda i: m.core.Solution.empty(i),
                           replan_every=None)
    assert r.total_cost < r_bad.total_cost
    return r, r_bad


def test_keep_best_adopts_better_candidate():
    _both(_keep_best_adopts)


def _ewma(m):
    fc = m.rolling._ewma_forecasts(np.array([[1.0], [2.0], [4.0]]), 0.5)
    assert np.allclose(fc[:, 0], [1.0, 1.5, 2.75])
    return fc


def test_ewma_forecasts_recursion():
    _both(_ewma)


def _replay_study(m):
    inst = m.core.default_instance()
    planner = lambda i, p=m.core.gh(inst): p
    r = m.core.replay_study(inst, planner, days=("busy", "volatile"),
                            n_windows=12)
    assert r.per_window_cost.shape == (24,)
    assert np.isfinite(r.total_cost)
    r_s = m.core.replay_study(inst, planner, days=("busy",), n_windows=12,
                              stress=1.5)
    assert np.isfinite(r_s.total_cost)
    r_b = m.core.replay_study(inst, planner, days=("busy",), n_windows=12)
    assert r_s.total_cost >= r_b.total_cost - 1e-9
    return r, r_s, r_b


def test_replay_study_multi_day_and_stress():
    _both(_replay_study)


def _multi_day(m):
    inst = m.core.default_instance()
    planner = lambda i, p=m.core.gh(inst): p
    one = m.core.replay_study(inst, planner, days=("busy",), n_windows=12,
                              seed=3)
    two = m.core.replay_study(inst, planner, days=("busy", "busy"),
                              n_windows=12, seed=3)
    assert two.per_window_cost.shape[0] == 2 * one.per_window_cost.shape[0]
    assert np.allclose(two.per_window_cost[:12], one.per_window_cost)
    return one, two


def test_multi_day_window_h_spans_days():
    _both(_multi_day)


def _lp_reuse(m):
    inst = m.core.default_instance()
    rng = np.random.default_rng(3)
    mult = (1.0 + 0.4 * np.sin(np.linspace(0, 2 * np.pi, 24))
            + rng.uniform(-0.05, 0.05, 24))
    paths = {"constant": np.tile(inst.lam, (12, 1)),
             "diurnal": np.outer(mult, inst.lam)}
    planner = lambda i: m.core.gh(i)
    out = []
    for name, path in paths.items():
        for replan in (None, 6):
            a = m.core.rolling(inst, path, planner, replan_every=replan,
                               lp_reuse=True)
            b = m.core.rolling(inst, path, planner, replan_every=replan,
                               lp_reuse=False)
            assert np.array_equal(a.per_window_cost, b.per_window_cost), \
                (name, replan)
            assert a.violation_rate == b.violation_rate, (name, replan)
            assert a.total_cost == b.total_cost, (name, replan)
            assert a.replans == b.replans, (name, replan)
            out.append(a)
    return out


def test_rolling_lp_reuse_bit_identical():
    _both(_lp_reuse)


# ===========================================================================
# tests/test_queueing.py and the queueing tests of tests/test_extensions.py
# ===========================================================================

RHO_GRID = (0.5, 0.7, 0.9)


def _cases(m):
    return [m.core.default_instance(),
            m.core.random_instance(10, 10, 10, seed=3)]


def _inflation(m):
    q, out = m.queueing, []
    for inst in _cases(m):
        sol = m.core.agh(inst)
        d0, dq = m.solution.proc_delay(inst, sol), q.queueing_delay(inst, sol)
        assert np.all(dq >= d0 - 1e-9)
        rho = q.utilization(inst, sol)
        assert np.all(rho >= 0.0) and np.all(rho <= 0.999)
        assert np.all(rho[sol.y <= 0] == 0.0)
        out.append((dq, rho))
    return out


def test_queueing_delay_is_an_inflation():
    _both(_inflation)


def _margin_bound(m):
    q, out = m.queueing, []
    for inst in _cases(m):
        for rho_max in RHO_GRID:
            sol = m.core.agh(q.with_queueing_margin(inst, rho_max))
            assert int(q.queueing_violations(inst, sol).sum()) == 0, \
                (inst.I, rho_max)
            assert q.utilization(inst, sol).max() <= rho_max + 1e-9
            out.append(sol)
        base = m.core.agh(inst)
        assert int(q.queueing_violations(inst, base).sum()) > 0
    return out


def test_margin_bound_true_delay_within_slo():
    _both(_margin_bound)


def _margin_monotone(m):
    inst = m.core.default_instance()
    prev_eta = prev_tau = -np.inf
    out = []
    for rho_max in RHO_GRID:
        mm = m.queueing.with_queueing_margin(inst, rho_max)
        assert np.isclose(mm.eta, inst.eta * rho_max)
        assert np.allclose(mm.tau, inst.tau / (1.0 - rho_max))
        assert mm.eta > prev_eta
        assert np.all(mm.tau > prev_tau)
        prev_eta, prev_tau = mm.eta, np.max(mm.tau)
        out.append((mm.eta, mm.tau))
    return out


def test_margin_transform_monotone_in_rho_max():
    _both(_margin_monotone)


def _attainment_summary(m):
    q = m.queueing
    inst = m.core.default_instance()
    sol = m.core.agh(inst)
    rep = q.slo_attainment_with_queueing(inst, sol)
    assert rep["violations_queueing"] == int(
        q.queueing_violations(inst, sol).sum())
    assert rep["violations_load_free"] == int(
        np.sum(rep["proc_delay"] > inst.Delta + 1e-9))
    assert np.isclose(rep["max_rho"], q.utilization(inst, sol).max())
    assert np.isclose(rep["margin_min"], float(np.min(
        (inst.Delta - rep["queue_delay"]) / inst.Delta)))
    assert np.allclose(rep["queue_delay"], q.queueing_delay(inst, sol))
    assert np.allclose(rep["proc_delay"], m.solution.proc_delay(inst, sol))
    return rep


def test_slo_attainment_summary_consistent():
    _both(_attainment_summary)


def _dominates_load_free(m):
    inst = m.core.default_instance()
    sol = m.core.agh(inst)
    d0 = m.solution.proc_delay(inst, sol)
    dq = m.queueing.queueing_delay(inst, sol)
    assert np.all(dq >= d0 - 1e-9)
    rho = m.queueing.utilization(inst, sol)
    assert np.all(rho >= 0) and np.all(rho < 1)
    return dq, rho


def test_queueing_delay_dominates_load_free():
    _both(_dominates_load_free)


def _margin_survives(m):
    inst = m.core.default_instance()
    sol_m = m.core.agh(m.queueing.with_queueing_margin(inst, rho_max=0.5))
    rep = m.queueing.slo_attainment_with_queueing(inst, sol_m)
    assert rep["violations_queueing"] == 0
    assert rep["max_rho"] <= 0.5 + 1e-6
    return sol_m, rep


def test_margin_planning_survives_queueing():
    _both(_margin_survives)


def _margin_costs(m):
    inst = m.core.default_instance()
    base = m.core.agh(inst)
    margin = m.core.agh(m.queueing.with_queueing_margin(inst, rho_max=0.5))
    pc = m.core.provisioning_cost
    assert (margin.u.max() > base.u.max() + 1e-6
            or pc(inst, margin) >= pc(inst, base) - 1e-6)
    return base, margin


def test_margin_costs_coverage_or_budget():
    _both(_margin_costs)


def test_canon_tells_results_apart():
    """The comparison above can fail: one ulp, one NaN, one field."""
    a = np.array([1.0, np.nan])
    assert _canon(a) == _canon(a.copy())
    assert _canon(a) != _canon(np.array([math.nextafter(1.0, 2.0), np.nan]))
    assert _canon({"x": 1.0, "wall_s": 1.0}) == _canon({"x": 1.0,
                                                        "wall_s": 2.0})
    assert _canon(PORT.core.Solution.empty(PORT.core.default_instance())) \
        != _canon(PORT.core.gh(PORT.core.default_instance()))
