"""The port's closed-loop serving layer (`repro_torch.serve()`, stations,
router, controller, the legacy simulator) against the reference's.

Every test of tests/test_serving.py and the simulator tests of
tests/test_extensions.py run once on each package, keep their own
assertions, and the two runs' results must be equal bit for bit (the
planner's wall-clock fields aside). On top: a `ServeResult` of the numpy
engine equals the reference's on the same seed, and a closed-loop day
whose every replan runs on the port's torch tier (`PlanSession(engine=
"torch")`, on the CPU here) replans as the reference's xla tier does."""
import dataclasses
import importlib
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import _ref_cpu  # noqa: F401  (pins the reference to the CPU)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _side(pkg: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")
    return SimpleNamespace(
        name=pkg, core=mod("core"), planner=mod("planner"),
        serving=mod("serving"), faults=mod("core.faults"),
        queueing=mod("core.queueing"), solution=mod("core.solution"),
        router=mod("serving.router"), simulator=mod("serving.simulator"),
        stations=mod("serving.stations"))


PORT, REF = _side("repro_torch"), _side("repro")


def _serve_dict(r) -> dict:
    """A `ServeResult` as JSON data, without the planner's wall clock."""
    d = json.loads(r.to_json(sort_keys=True))
    d.pop("planner_wall_s")
    for e in d["replans"]:
        e.pop("wall_s")
    return d


def _canon(x):
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return _canon(x.item())
    if isinstance(x, float):
        return ("f", x.hex())
    if hasattr(x, "to_json") and hasattr(x, "replans"):
        return _serve_dict(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: _canon(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    return x


def _both(case, *args):
    got, want = case(PORT, *args), case(REF, *args)
    assert _canon(got) == _canon(want)
    return got


_PLANS: dict = {}


def _default_plan(m):
    if m.name not in _PLANS:
        inst = m.core.default_instance()
        _PLANS[m.name] = inst, m.core.agh(inst)
    return _PLANS[m.name]


# ===========================================================================
# tests/test_serving.py
# ===========================================================================

ORACLE_N_SERVED = 88
ORACLE_TTFT = [2.28044048, 0.51294643, 0.87837302,
               0.61875, 0.86235424, 1.75080767]
ORACLE_E2E_P95 = [10.05448856, 9.16854819, 8.61619262,
                  7.05208464, 23.89130779, 4.28654712]
ORACLE_ATTAIN = [0.26666667, 0.36363636, 0.56521739,
                 0.77777778, 0.66666667, 1.0]


def _legacy_simulate(m):
    inst, sol = _default_plan(m)
    st = m.simulator.simulate(inst, sol, horizon_s=300.0, rate_scale=0.02,
                              max_batch=32, seed=0)
    assert st.n_served == ORACLE_N_SERVED
    np.testing.assert_allclose(st.per_type_ttft_p50, ORACLE_TTFT, rtol=1e-7)
    np.testing.assert_allclose(st.per_type_e2e_p95, ORACLE_E2E_P95,
                               rtol=1e-7)
    np.testing.assert_allclose(st.per_type_slo_attain, ORACLE_ATTAIN,
                               rtol=1e-7)
    return st


def test_legacy_simulate_explicit_max_batch_bit_identical():
    _both(_legacy_simulate)


def _b_max(m):
    inst, sol = _default_plan(m)
    full = m.stations.build_stations(inst, sol)
    assert full and all(s.b_max >= 1 for s in full)
    small = dataclasses.replace(sol, y=np.maximum(1.0, sol.y * 0.1))
    shrunk = m.stations.build_stations(inst, small)
    by_jk = {(s.j, s.k): s for s in shrunk}
    for s in full:
        assert by_jk[(s.j, s.k)].b_max < s.b_max
    assert all(s.b_max < 32 for s in shrunk)
    return full, shrunk


def test_station_b_max_tracks_committed_capacity():
    _both(_b_max)


def _concurrency(m):
    inst, sol = _default_plan(m)
    st = m.stations.build_stations(inst, sol)[0]
    sim = m.stations.StationSim(inst, st, b_eff=3)
    sim.push([m.stations.Req(qtype=0, t_arrive=0.01 * a, h=32, f=16)
              for a in range(50)])
    sim.drain()
    done = sim.take_done()
    assert len(done) == 50
    assert sim.peak_inflight <= 3
    for r in done:
        assert 0 <= r.t_first <= r.t_done
    return [(r.t_first, r.t_done) for r in done]


def test_station_sim_respects_concurrency_bound():
    _both(_concurrency)


def _deterministic(m):
    inst, sol = _default_plan(m)
    s = m.serving
    tr = s.TrafficSpec(horizon_s=900.0, window_s=300.0, rate_scale=0.02,
                       seed=3)
    ctl = s.ControllerSpec(mode="static")
    a = s.serve(sol, instance=inst, traffic=tr, controller=ctl)
    b = s.serve(sol, instance=inst, traffic=tr, controller=ctl)
    assert a.to_json(sort_keys=True) == b.to_json(sort_keys=True)
    assert a.n_arrived > 0 and a.n_served > 0
    return a


def test_serve_deterministic_under_seeds():
    _both(_deterministic)


def _router(m):
    inst, sol = _default_plan(m)
    stations = m.stations.build_stations(inst, sol)
    router = m.router.Router(inst, sol, stations)
    us = np.linspace(0.0, 1.0, 20001)[:-1]
    out = []
    for i in range(inst.I):
        hits = np.zeros(len(stations))
        shed = 0
        for u in us:
            s = router.route(i, float(u))
            if s == m.router.SHED:
                shed += 1
            else:
                hits[s] += 1
        want = np.array([sol.x[i, st.j, st.k] for st in stations])
        np.testing.assert_allclose(hits / len(us), want, atol=1e-3)
        assert abs(shed / len(us) - (1.0 - want.sum())) < 1e-3
        out.append((hits, shed))
    return out


def test_router_conserves_plan_fractions():
    _both(_router)


def _monotone(m):
    inst, sol = _default_plan(m)
    s = m.serving
    results = []
    for rs in (0.2, 0.8, 1.6):
        results.append(s.serve(
            sol, instance=inst,
            traffic=s.TrafficSpec(horizon_s=900.0, window_s=300.0,
                                  rate_scale=rs, concurrency_scale=1.0,
                                  seed=5),
            controller=s.ControllerSpec(mode="static")))
    attains = [r.attainment() for r in results]
    assert attains[0] >= attains[1] - 0.02
    assert attains[1] >= attains[2] - 0.02
    assert attains[0] > attains[2]
    return results


def test_attainment_monotone_in_rate_scale():
    _both(_monotone)


def _controller_drift(m):
    s = m.serving
    lam = np.array([100.0, 50.0])
    spec = s.ControllerSpec(mode="forecast", warmup=1, cooldown=2,
                            ewma_alpha=0.5, drift_threshold=0.25)
    quiet = s.ReplanController(spec, lam)
    for w in range(10):
        cause, drift = quiet.observe(w, lam, viol_frac=0.0)
        assert cause is None and drift < 1e-9
    drifting = s.ReplanController(spec, lam)
    fired = []
    for w in range(10):
        cause, _ = drifting.observe(w, lam * 3.0, viol_frac=0.0)
        if cause is not None:
            fired.append((w, cause))
            drifting.adopted(w, drifting.forecast)
    assert fired and fired[0][1] == "drift"
    assert np.all(np.diff([w for w, _ in fired]) >= spec.cooldown)
    return fired


def test_controller_fires_on_drift_quiet_when_stationary():
    _both(_controller_drift)


def _controller_budget(m):
    s = m.serving
    lam = np.array([10.0])
    spec = s.ControllerSpec(mode="forecast", warmup=0, cooldown=1,
                            violation_budget=0.05, budget_windows=2,
                            drift_threshold=10.0)
    ctl = s.ReplanController(spec, lam)
    assert ctl.observe(0, lam, viol_frac=0.2)[0] is None
    assert ctl.observe(1, lam, viol_frac=0.2)[0] == "slo"
    fixed = s.ReplanController(s.ControllerSpec(mode="fixed",
                                                replan_every=3), lam)
    causes = [fixed.observe(w, lam, viol_frac=1.0)[0] for w in range(7)]
    assert causes == [None, None, None, "scheduled", None, None,
                      "scheduled"]
    static = s.ReplanController(s.ControllerSpec(mode="static"), lam)
    assert all(static.observe(w, lam * 9, viol_frac=1.0)[0] is None
               for w in range(5))
    return causes


def test_controller_slo_budget_and_fixed_cadence():
    _both(_controller_budget)


def _forecast_replans(m):
    s = m.serving
    inst = m.core.default_instance()
    sol = m.core.agh(m.queueing.with_queueing_margin(inst, rho_max=0.5))
    tr = s.TrafficSpec(horizon_s=3600.0, window_s=300.0, rate_scale=0.02,
                       trace="volatile", seed=2)
    r_fc = s.serve(sol, instance=inst, traffic=tr,
                   controller=s.ControllerSpec(mode="forecast", rho_max=0.5,
                                               warmup=1, cooldown=2))
    assert r_fc.replans and all(e.cause in ("drift", "slo")
                                for e in r_fc.replans)
    r_st = s.serve(sol, instance=inst, traffic=tr,
                   controller=s.ControllerSpec(mode="static"))
    assert not r_st.replans
    return r_fc, r_st


def test_serve_forecast_replans_on_diurnal_drift():
    _both(_forecast_replans)


def _fault_repair(m):
    s = m.serving
    inst = m.core.default_instance()
    sol = m.core.agh(inst)
    busiest = int(np.argmax(sol.y.sum(axis=0)))
    sched = m.faults.FaultSchedule(n_windows=6, events=(
        m.faults.TierOutage(tier=busiest, t0=2, t1=5),))
    r = s.serve(sol, instance=inst,
                traffic=s.TrafficSpec(horizon_s=1800.0, window_s=300.0,
                                      rate_scale=0.01, seed=4),
                controller=s.ControllerSpec(mode="static"), faults=sched)
    assert any(e.cause == "fault" for e in r.replans)
    return r


def test_serve_fault_triggers_warm_repair():
    _both(_fault_repair)


def _json_roundtrip(m):
    inst, sol = _default_plan(m)
    s = m.serving
    r = s.serve(sol, instance=inst,
                traffic=s.TrafficSpec(horizon_s=600.0, window_s=300.0,
                                      rate_scale=0.02, seed=6),
                controller=s.ControllerSpec(mode="static"))
    r2 = s.ServeResult.from_json(r.to_json())
    assert r2.to_json(sort_keys=True) == r.to_json(sort_keys=True)
    assert r2.summary() == r.summary()
    assert json.loads(r.to_json())["per_type_ttft_p50"] is not None
    return r2


def test_serve_result_json_roundtrip():
    _both(_json_roundtrip)


def test_serve_importable_without_jax_or_torch():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['torch'] = None; "
            "from repro_torch import serve, ServeResult, TrafficSpec, "
            "ControllerSpec, Station; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ===========================================================================
# The simulator tests of tests/test_extensions.py
# ===========================================================================

def _serves_and_measures(m):
    inst, sol = _default_plan(m)
    st = m.simulator.simulate(inst, sol, horizon_s=60.0, rate_scale=0.01,
                              seed=0)
    assert st.n_served > 0
    served = ~np.isnan(st.per_type_ttft_p50)
    assert served.any()
    ok = served & ~np.isnan(st.per_type_e2e_p95)
    assert np.all(st.per_type_ttft_p50[ok] <= st.per_type_e2e_p95[ok] + 1e-9)
    assert np.all((st.per_type_slo_attain >= 0)
                  & (st.per_type_slo_attain <= 1))
    return st


def test_simulator_serves_and_measures():
    _both(_serves_and_measures)


def _margin_attains_more(m):
    c = m.core
    inst = c.default_instance(budget=150.0)
    base = c.agh(c.default_instance())
    margin = c.agh(m.queueing.with_queueing_margin(inst, rho_max=0.5))
    st0 = m.simulator.simulate(c.default_instance(), base, horizon_s=240.0,
                               rate_scale=0.02, seed=1)
    st1 = m.simulator.simulate(inst, margin, horizon_s=240.0,
                               rate_scale=0.02, seed=1)
    m0 = np.nanmean(st0.per_type_slo_attain)
    m1 = np.nanmean(st1.per_type_slo_attain)
    assert m1 >= m0 - 0.05, (m0, m1)
    return st0, st1


def test_simulator_margin_plan_attains_more():
    _both(_margin_attains_more)


# ===========================================================================
# A closed-loop day: numpy sessions, and the torch tier against xla's
# ===========================================================================

# benchmarks/serve_closed_loop.py's quick (CI) day, forecast mode.
QUICK = dict(size=(24, 20, 10), horizon_s=7200.0, window_s=300.0,
             rate_scale=0.02, trace="busy", seed=1, rho_max=0.65,
             forecast=dict(drift_threshold=0.5, cooldown=6, ewma_alpha=0.5))


def _closed_loop_day(m, session):
    inst = m.core.random_instance(*QUICK["size"], seed=42)
    res = session.plan(instance=m.queueing.with_queueing_margin(
        inst, QUICK["rho_max"]))
    s = m.serving
    traffic = s.TrafficSpec(horizon_s=QUICK["horizon_s"],
                            window_s=QUICK["window_s"],
                            rate_scale=QUICK["rate_scale"],
                            trace=QUICK["trace"], seed=QUICK["seed"])
    ctl = s.ControllerSpec(mode="forecast", rho_max=QUICK["rho_max"],
                           **QUICK["forecast"])
    return res, s.serve(res, instance=inst, session=session,
                        traffic=traffic, controller=ctl)


def test_numpy_closed_loop_day_equals_reference():
    """A `ServeResult` on the numpy engine is the reference's, bitwise."""
    got_res, got = _closed_loop_day(PORT, PORT.planner.PlanSession(
        options=PORT.planner.PlanOptions(workers=0)))
    want_res, want = _closed_loop_day(REF, REF.planner.PlanSession(
        options=REF.planner.PlanOptions(workers=0)))
    assert got_res.objective == want_res.objective
    assert _serve_dict(got) == _serve_dict(want)
    assert got.replans, "the quick day should replan"


def test_torch_session_closed_loop_day_matches_reference_xla():
    """Every replan of the day on the port's torch tier (CPU) against the
    reference's xla tier: the same replans and causes, each replan's
    objective within 1e-9 relative, equal attainment."""
    pytest.importorskip("jax")
    got_res, got = _closed_loop_day(PORT, PORT.planner.PlanSession(
        engine="torch", options=PORT.planner.PlanOptions(
            workers=0, device="cpu")))
    want_res, want = _closed_loop_day(REF, REF.planner.PlanSession(
        engine="xla", options=REF.planner.PlanOptions(workers=0)))
    assert got_res.diagnostics["engine"] == "torch"
    assert got_res.objective == pytest.approx(want_res.objective, rel=1e-9)
    assert [(e.window, e.cause) for e in got.replans] == \
        [(e.window, e.cause) for e in want.replans]
    assert got.replans
    for g, w in zip(got.replans, want.replans, strict=True):
        assert g.objective == pytest.approx(w.objective, rel=1e-9, abs=0)
    assert got.attainment() == want.attainment()
    assert (got.n_served, got.n_shed) == (want.n_served, want.n_shed)
