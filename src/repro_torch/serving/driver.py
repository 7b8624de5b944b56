"""`serve()` — the closed-loop serving driver.

Runs a planned fleet as continuous-batching stations against hours of
simulated Poisson traffic and closes the loop the paper leaves as future
work: plan -> traffic -> observed SLO -> forecast -> warm replan.

Per control window (`TrafficSpec.window_s`):

1. **synthesize** Poisson arrivals at the instance's fleet-scale rates
   (diurnal `core.trace` multipliers, lognormal token-length noise,
   `rate_scale` thinning with matching concurrency co-thinning so
   utilization — hence queueing — is scale-invariant);
2. **route** each request through the plan-aware `Router` (weighted-random
   over the plan's `x` fractions, shed with the plan's `u` residual);
3. **advance** every station's event-compressed DES to the window end;
4. **observe** completions (attainment, TTFT/e2e percentiles, violation
   fraction) and the full-scale arrival-rate estimate;
5. **decide** via `ReplanController` (EWMA forecast + drift/SLO trigger,
   or the fixed-cadence baseline) and, on a firing, run a warm
   `PlanSession.replan()` on the forecast rates — or `repair()` when a
   `FaultSchedule` has revoked capacity under the incumbent — then swap
   stations diff-aware: surviving (j, k, config) stations keep their
   in-flight work, removed stations drain their backlog without taking
   new traffic, added stations start empty.

The result is a `ServeResult`: per-type latency/attainment, per-window
rows, the replan log with causes, planner wall time as a fraction of the
simulated horizon, and the simulated-vs-analytical calibration ratios.

numpy/stdlib only — `from repro_torch import serve` works without torch.
"""
from __future__ import annotations

import time

import numpy as np

from ..core.faults import FaultSchedule, apply_faults, lost_pairs
from ..core.instance import Instance
from ..core.queueing import with_queueing_margin
from ..core.solution import Solution, proc_delay
from ..core.trace import diurnal_multipliers
from .controller import ReplanController
from .router import SHED, Router
from .stations import Req, StationSim, build_stations
from .types import ControllerSpec, ReplanEvent, ServeResult, TrafficSpec


def _resolve(plan, instance, session):
    """Normalize (plan, instance, session) -> (inst, PlanSession)."""
    from ..planner.api import PlanResult, build_result
    from ..planner.session import PlanSession
    if isinstance(plan, PlanSession):
        if instance is not None or session is not None:
            raise ValueError("pass a PlanSession alone, or a plan with "
                             "instance= (and optionally session=)")
        if plan.last_instance is None or plan.last_result is None:
            raise ValueError("PlanSession has no incumbent: call "
                             ".plan()/.replan() first")
        return plan.last_instance, plan
    if instance is None:
        raise ValueError("serve(plan, instance=...) needs the Instance the "
                         "plan was solved on (or pass a PlanSession)")
    if isinstance(plan, Solution):
        plan = build_result(plan.method or "agh", instance, plan,
                            0.0, 0.0, {}, (session.options if session
                                           else PlanSession().options))
    if not isinstance(plan, PlanResult):
        raise TypeError("plan must be a PlanResult, Solution, or "
                        f"PlanSession, got {type(plan).__name__}")
    sess = session if session is not None else PlanSession()
    sess.seed(instance, plan)
    return instance, sess


def _make_sims(inst: Instance, sol: Solution, cscale: float,
               now: float, old: list[StationSim]
               ) -> tuple[list[StationSim], list[StationSim]]:
    """Diff-aware station (re)build: same (j, k, TP, PP) keeps its state;
    removed stations drain; added ones start empty at the current clock."""
    stations = build_stations(inst, sol)
    prev = {(s.station.j, s.station.k, s.station.tp, s.station.pp): s
            for s in old}
    sims: list[StationSim] = []
    for st in stations:
        b_eff = max(1, round(st.b_max * cscale))
        sim = prev.pop((st.j, st.k, st.tp, st.pp), None)
        if sim is not None:
            sim.station = st
            sim.b_eff = b_eff
        else:
            sim = StationSim(inst, st, b_eff=b_eff)
            sim.t = now
        sims.append(sim)
    return sims, list(prev.values())


def serve(plan, instance: Instance | None = None, *,
          traffic: TrafficSpec | None = None,
          controller: ControllerSpec | None = None,
          session=None, faults: FaultSchedule | None = None) -> ServeResult:
    """Serve simulated traffic against a plan with closed-loop replanning.

    ``plan`` is a `PlanResult` or bare `Solution` (with ``instance=``), or
    a `PlanSession` that already holds an incumbent.  ``faults`` replays a
    `core.faults.FaultSchedule` with the control window as the fault time
    index: capacity revoked under the incumbent triggers a warm
    `session.repair()` (cause ``"fault"``) regardless of controller mode.
    """
    traffic = traffic or TrafficSpec()
    controller = controller or ControllerSpec()
    inst, sess = _resolve(plan, instance, session)
    rng = np.random.default_rng(traffic.seed)
    I = inst.I
    W = traffic.n_windows()
    cscale = traffic.effective_concurrency_scale()
    mult = (diurnal_multipliers(traffic.trace, seed=traffic.trace_seed,
                                n_windows=W)
            if traffic.trace is not None else np.ones(W))

    sol = sess.incumbent
    assert sol is not None
    ctl = ReplanController(controller, inst.lam)
    sims, draining = _make_sims(inst, sol, cscale, 0.0, [])
    router = Router(inst, sol, [s.station for s in sims])

    windows: list[dict] = []
    replans: list[ReplanEvent] = []
    planner_wall = 0.0
    analytic_sum = np.zeros(I)
    all_done: list[Req] = []
    n_arrived = 0
    n_shed = 0
    handled_lost: set[tuple[int, int]] = set()

    rental_sum = 0.0                    # $/h x simulated seconds
    for w in range(W):
        t0 = w * traffic.window_s
        t1 = min(t0 + traffic.window_s, traffic.horizon_s)
        span = max(t1 - t0, 1e-12)
        analytic_sum += proc_delay(inst, sol) * span
        rental_h = float(np.sum(inst.p_c[None, :] * sol.y))
        rental_sum += rental_h * span
        lam_w = inst.lam * mult[w]

        # 1-2. Synthesize this window's arrivals and route them.
        batch: list[tuple[float, int, Req]] = []
        counts = np.zeros(I)
        shed_w = 0
        for i in range(I):
            rate_s = lam_w[i] / 3600.0 * traffic.rate_scale
            n = int(rng.poisson(rate_s * span)) if rate_s > 0 else 0
            if n == 0:
                continue
            counts[i] = n
            times = t0 + np.sort(rng.random(n)) * span
            hs = np.maximum(8, (inst.h[i] * rng.lognormal(
                0, traffic.len_sigma, n)).astype(int))
            fs = np.maximum(4, (inst.f[i] * rng.lognormal(
                0, traffic.len_sigma, n)).astype(int))
            us = rng.random(n)
            for a in range(n):
                s = router.route(i, us[a])
                if s == SHED:
                    shed_w += 1
                    continue
                batch.append((float(times[a]), s,
                              Req(i, float(times[a]), int(hs[a]),
                                  int(fs[a]))))
        n_arrived += int(counts.sum())
        n_shed += shed_w
        batch.sort(key=lambda e: e[0])
        per_station: dict[int, list[Req]] = {}
        for t_a, s, req in batch:
            per_station.setdefault(s, []).append(req)
        for s, reqs in per_station.items():
            sims[s].push(reqs)

        # 3. Advance every station (and drainers) to the window end.
        win_done: list[Req] = []
        for sim in sims:
            sim.advance(t1)
            win_done.extend(sim.take_done())
        still_draining = []
        for sim in draining:
            sim.advance(t1)
            win_done.extend(sim.take_done())
            if sim.pending or sim.inflight:
                still_draining.append(sim)
        draining = still_draining
        all_done.extend(win_done)

        # 4. Observe the window.
        if win_done:
            e2e = np.array([r.t_done for r in win_done])
            slo = inst.Delta[[r.qtype for r in win_done]]
            viol_frac = float(np.mean(e2e > slo))
            row_ttft = float(np.median([r.t_first for r in win_done]))
            row_p95 = float(np.percentile(e2e, 95))
            row_p99 = float(np.percentile(e2e, 99))
        else:
            viol_frac, row_ttft, row_p95, row_p99 = 0.0, None, None, None
        lam_obs = counts / span / max(traffic.rate_scale, 1e-12) * 3600.0

        # 5. Decide and (maybe) replan.
        cause, drift = ctl.observe(w, lam_obs, viol_frac)
        if faults is not None:
            inst_w = apply_faults(inst, faults, w)
            lost = {(int(j), int(k)) for j, k in lost_pairs(inst_w, sol.y)}
            if lost - handled_lost:
                cause = "fault"
                handled_lost = lost
            elif not lost:
                handled_lost = set()
        if cause is not None:
            p0 = time.perf_counter()
            # The planning basis is always the PRISTINE supply at the
            # forecast rates, re-faulted for the current window — so a
            # drift replan during an outage plans on the degraded supply,
            # and one after recovery is not stuck with stale caps.  The
            # queueing-margin view is re-applied so replans keep the
            # headroom policy of the initial plan.
            inst_basis = inst.with_lam(ctl.forecast)
            if controller.rho_max is not None:
                inst_basis = with_queueing_margin(inst_basis,
                                                  controller.rho_max)
            if faults is not None:
                inst_basis = apply_faults(inst_basis, faults, w)
            if cause == "fault":
                res = sess.repair(instance=inst_basis, cause=cause)
            else:
                res = sess.replan(instance=inst_basis, cause=cause)
            wall = time.perf_counter() - p0
            planner_wall += wall
            sol = res.solution
            sims, newly_drained = _make_sims(inst, sol, cscale, t1, sims)
            draining.extend(newly_drained)
            router = Router(inst, sol, [s.station for s in sims])
            ctl.adopted(w, ctl.forecast)
            replans.append(ReplanEvent(
                window=w, t_s=float(t1), cause=cause, drift=float(drift),
                viol_frac=float(viol_frac), wall_s=float(wall),
                objective=float(res.objective)))

        windows.append({
            "t0_s": float(t0), "arrivals": int(counts.sum()),
            "served": len(win_done), "shed": shed_w,
            "attain": float(1.0 - viol_frac), "ttft_p50": row_ttft,
            "e2e_p95": row_p95, "e2e_p99": row_p99,
            "viol_frac": float(viol_frac), "drift": float(drift),
            "stations": len(sims), "rental_per_h": rental_h,
        })

    # Flush: finish all queued and in-flight work past the horizon.
    for sim in sims + draining:
        sim.drain()
        all_done.extend(sim.take_done())

    ttft = np.full(I, np.nan)
    p95 = np.full(I, np.nan)
    p99 = np.full(I, np.nan)
    attain = np.zeros(I)
    by_type: list[list[Req]] = [[] for _ in range(I)]
    for r in all_done:
        by_type[r.qtype].append(r)
    for i in range(I):
        mine = by_type[i]
        if not mine:
            continue
        e2e = np.array([r.t_done for r in mine])
        ttft[i] = float(np.median([r.t_first for r in mine]))
        p95[i] = float(np.percentile(e2e, 95))
        p99[i] = float(np.percentile(e2e, 99))
        attain[i] = float(np.mean(e2e <= inst.Delta[i]))

    return ServeResult(
        stations=[s.station for s in sims],
        per_type_ttft_p50=ttft, per_type_e2e_p95=p95, per_type_e2e_p99=p99,
        per_type_slo_attain=attain,
        analytic_delay=analytic_sum / max(traffic.horizon_s, 1e-12),
        n_arrived=n_arrived, n_served=len(all_done),
        n_shed=n_shed, windows=windows, replans=replans,
        planner_wall_s=float(planner_wall), horizon_s=float(traffic.horizon_s),
        mean_rental_per_h=float(rental_sum / max(traffic.horizon_s, 1e-12)),
        traffic=traffic.to_dict(), controller=controller.to_dict())
