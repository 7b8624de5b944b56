"""Rolling-horizon adaptation study (paper §5.3).

Two complementary settings:
  * synthetic geometric-random-walk volatility (Table 4);
  * diurnal trace replay (Table 5 / Fig. 6), extended to multi-day,
    volatile-day, non-288-window, and inflation-stress replays.

Static variants solve Stage 1 once at t=0; the 5-minute variants re-optimize
the deployment each window with an EWMA demand forecast and a keep-best rule
(adopt the new plan only if it beats the incumbent's objective on the SAME
current forecast).  In every window, the current deployment is operated
through the exact Stage-2 routing LP with the strict per-type unmet cap
u_i <= 0.02 (the stress protocol).

Fast path: the EWMA forecasts are precomputed for the whole path, the
replan schedule is resolved first (it depends only on forecasts and planner
outputs, never on window costs), and each constant-deployment segment is
then solved as one stacked `ScenarioBatch` through a single `Stage2System`
— the LP pattern is rebuilt only when a replan is adopted.  `batched=False`
keeps the per-window `stage2_lp` loop for agreement tests and the
before/after benchmark.

Window pricing: Stage-2 penalties are horizon-priced ($ over
Delta_T as if the window's demand persisted all day); one window accrues
the `window_h`-hour share.  The seed hardcoded the T=288 fraction
(24.0/288.0), mispricing every replay with n_windows != 288 — `window_h`
is now threaded through, so total replay cost is invariant to the window
count for the same demand profile (pinned by tests/test_rolling.py).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
from scipy.optimize import linprog

from .faults import FaultSchedule, apply_faults, evict_unavailable
from .forecast import ewma_forecasts, relative_drift
from .instance import Instance, ScenarioBatch
from .solution import Solution, objective, provisioning_cost
from .stage2 import Stage2System, stage2_cost, stage2_lp
from .trace import multi_day_multipliers, random_walk_lambdas

STRICT_CAP = 0.02

# The EWMA recursion moved to `core.forecast` (shared with the serving
# controller); the old private name stays importable for callers/tests.
_ewma_forecasts = ewma_forecasts


@dataclasses.dataclass
class RollingResult:
    method: str
    mean_window_cost: float
    total_cost: float
    violation_rate: float
    per_window_cost: np.ndarray
    replans: int = 0
    # Supply-fault replay extensions (populated only when a FaultSchedule
    # is passed to `rolling`; defaults keep the base path's result shape).
    fault_replans: int = 0                   # event-driven re-solves
    evictions: int = 0                       # pairs lost to capacity
    repair_wall_s: tuple = ()                # per-event re-solve wall (s)
    degradation_levels: tuple = ()           # repair ladder level per event


def _as_planner(planner) -> Callable[[Instance], Solution]:
    """Normalize the planner argument: a bare ``Instance -> Solution``
    callable passes through; a `repro_torch.planner.PlanSession`-like object
    (anything with a ``replan`` method returning a result with a
    ``.solution``) is adapted so every window after the first becomes a
    warm-started replan seeded from the session's incumbent."""
    if hasattr(planner, "replan"):
        return lambda inst: planner.replan(instance=inst).solution
    return planner


def rolling(inst0: Instance, lam_path: np.ndarray,
            planner: Callable[[Instance], Solution],
            replan_every: int | None = None,
            forecast_ewma: float = 0.4,
            static_forecast: str = "first",
            window_h: float | None = None,
            batched: bool = True,
            lp_reuse: bool = True,
            faults: FaultSchedule | None = None,
            fault_response: str = "repair",
            replan_drift: float | None = None) -> RollingResult:
    """Replay `lam_path` ([T, I] arrivals).  If `replan_every` is None the
    Stage-1 plan is held fixed (static); otherwise the planner re-runs
    every `replan_every` windows on an EWMA forecast with keep-best.
    `planner` is either a bare ``Instance -> Solution`` callable or a
    `PlanSession` (see `_as_planner`) — with a session, every re-solve
    warm-starts from the session incumbent instead of running cold.
    static_forecast: 'first' plans on the first window's demand (synthetic
    GRW study — the walk starts at the forecast); 'mean' plans on the
    day-average (the paper's protocol for the diurnal trace replay).
    window_h: hours per window; defaults to 24/T (a one-day path).  Pass it
    explicitly for multi-day replays, where T spans more than 24 h.

    `faults` injects a supply-side `FaultSchedule` (core/faults.py): every
    supply change point triggers an EVENT-DRIVEN re-solve in addition to
    the `replan_every` schedule, and each window is operated on the
    faulted effective instance (pairs on lost capacity are evicted from
    the operated deployment).  `fault_response` picks the reaction:
    ``"repair"`` (warm `PlanSession.repair` when `planner` is a session,
    else a planner re-solve), ``"cold"`` (full planner re-solve), or
    ``"static"`` (no reaction — the frozen placement rides through the
    fault, the degradation baseline).  With ``faults=None`` this function
    is byte-identical to the pre-fault fast path.

    `lp_reuse` enables the affine-in-lambda re-solve skip on the batched
    fault-free path: within a constant-deployment segment only `lam`
    varies, so when one window's optimal basis touches no lam-scaled
    constraint row (kv/compute/storage all slack — the segment is
    *unsaturated*), the routing (x, u) is provably constant across the
    segment and only the objective moves.  `_affine_segment` certifies
    this from one exact solve + its duals and prices the remaining
    windows by dot products; any failed certificate falls back to the
    always-solve batch.  Pinned bit-identical to `lp_reuse=False` on the
    replay suite (tests/test_rolling.py).

    `replan_drift` makes the `replan_every` cadence forecast-aware (the
    same `core.forecast.relative_drift` trigger the closed-loop serving
    controller uses): a scheduled replan point actually re-solves only
    when the EWMA forecast has drifted more than `replan_drift`
    (relative L1) from the rates the incumbent plan was built for.
    ``None`` (the default) keeps the blind cadence, bit-identical to the
    pre-drift behavior.
    """
    if faults is not None and not faults.is_empty:
        return _rolling_faulted(inst0, lam_path, planner, replan_every,
                                forecast_ewma, static_forecast, window_h,
                                faults, fault_response)
    session = planner if hasattr(planner, "replan") else None
    planner = _as_planner(planner)
    lam_path = np.asarray(lam_path, float)
    T = lam_path.shape[0]
    if window_h is None:
        window_h = 24.0 / T
    lam_fc = (lam_path.mean(axis=0) if static_forecast == "mean"
              else lam_path[0])
    deploy = planner(inst0.with_lam(lam_fc))

    # Resolve the replan schedule first: adoption depends only on forecasts
    # and the keep-best comparison, never on window costs, so the path
    # splits into constant-deployment segments [t0, t1) solvable in batch.
    replans = 0
    segments: list[tuple[int, int, Solution]] = []
    if replan_every is not None:
        fc = ewma_forecasts(lam_path, forecast_ewma)
        lam_basis = lam_fc          # rates the deployed plan was built for
        t0 = 0
        for t in range(T):
            if t > 0 and t % replan_every == 0:
                if (replan_drift is not None
                        and relative_drift(fc[t], lam_basis) <= replan_drift):
                    continue        # forecast hasn't moved: keep the plan
                inst_fc = inst0.with_lam(fc[t])
                cand = planner(inst_fc)
                # Keep-best: both plans scored on the SAME current forecast
                # (the incumbent's score moves with the forecast, so it is
                # re-evaluated here rather than carried over).
                if objective(inst_fc, cand) < objective(inst_fc, deploy) - 1e-6:
                    segments.append((t0, t, deploy))
                    deploy, t0 = cand, t
                    lam_basis = fc[t]
                    replans += 1
                elif session is not None:
                    # Keep-best rejected the candidate: re-anchor the
                    # session's incumbent to the plan actually deployed,
                    # so later warm replans seed from the best-known plan
                    # rather than from the rejected candidate.
                    session.incumbent = deploy
        segments.append((t0, T, deploy))
    else:
        segments = [(0, T, deploy)]

    costs = np.zeros(T)
    viols = 0
    cap = np.full(inst0.I, STRICT_CAP)
    for (t0, t1, dep) in segments:
        if t1 <= t0:
            continue
        rental_w = provisioning_cost(inst0, dep) / inst0.Delta_T * window_h
        if batched:
            system = Stage2System(inst0, dep)
            reused = (_affine_segment(system, lam_path[t0:t1], cap)
                      if lp_reuse else None)
            if reused is not None:
                op, seg_viols = reused
                viols += seg_viols
            else:
                batch = ScenarioBatch.from_lam_path(lam_path[t0:t1])
                op, v, _ = system.solve_batch(batch, u_cap=cap)
                viols += int(v.sum())
        else:
            op = np.zeros(t1 - t0)
            for t in range(t0, t1):
                inst_w = inst0.with_lam(lam_path[t])
                sol, _ = stage2_lp(inst_w, dep, u_cap=cap)
                op[t - t0] = stage2_cost(inst_w, sol)
                viols += int(np.sum(sol.u > 0.01))
        # Horizon-priced penalties accrue the window_h-hour share per
        # window (the seed hardcoded 24/288 here — the headline bugfix).
        costs[t0:t1] = rental_w + op * window_h
    return RollingResult(method="", mean_window_cost=float(costs.mean()),
                         total_cost=float(costs.sum()),
                         violation_rate=viols / (T * inst0.I),
                         per_window_cost=costs, replans=replans)


def _affine_segment(system: Stage2System, lam_seg: np.ndarray,
                    cap: np.ndarray) -> tuple[np.ndarray, int] | None:
    """Certificate-gated LP re-solve skip for one rolling segment.

    Within a constant-deployment segment only `lam` varies window to
    window; tau/e_base stay nominal.  Of the inequality families, kv,
    compute and storage coefficients scale with lam while delay and
    error rows (and the equality block, rhs, bounds) are lam-free.  If
    one window's optimal basis touches NO lam-scaled row, the optimal
    (x, u) is the same vertex for every window — only the objective
    (affine in lam) moves — provided the certificate holds over the
    segment's lam range:

      * active inequality rows and nonzero inequality duals confined to
        the lam-free families (delay, error) — those rows' lhs is
        constant in lam, so they stay exactly tight at every window;
      * per window t, reduced costs rc(lam_t) = c(lam_t) + A^T y keep
        the basis-optimal sign pattern (A^T y is segment-constant since
        y lives on lam-free rows), and the slack lam-scaled rows stay
        strictly slack under lam_t (primal feasibility of the fixed x).

    Certification is per window: a diurnal segment is typically
    unsaturated off-peak and saturated at the peak, so the windows the
    certificate covers are priced by dot products while the rest go
    through the exact per-window solve — identical to what the
    always-solve batch would do for them.

    Returns (per-window operation costs, total violations) with the one
    exact solve's (x, u) reused verbatim and certified windows priced
    through `_coefficients` + the identical cost dot expression — or
    None when the representative solve yields no usable certificate
    (caller falls back to the always-solve batch).
    """
    T = lam_seg.shape[0]
    nx, m_ub = system.nx, system.m_ub
    if T < 2 or nx == 0:
        return None
    inst = system.inst
    # Representative window through the SAME milp path the always-solve
    # batch uses, so window 0's cost is reproduced bit-for-bit.
    r = system.solve(lam=lam_seg[0], u_cap=cap)
    if not r.capped_ok or r.x is None:
        return None
    # Duals come from linprog (milp exposes none); system.A still holds
    # window 0's coefficients after `solve`.
    _, c0 = system._coefficients(inst.tau, inst.e_base, lam_seg[0])
    K = system.A.tocsr()
    bounds = np.stack([system._lb,
                       np.concatenate([np.ones(nx), cap])], axis=1)
    res = linprog(c0, A_ub=K[:m_ub], b_ub=system.row_ub[:m_ub],
                  A_eq=K[m_ub:], b_eq=np.ones(system.I),
                  bounds=bounds, method="highs")
    if not res.success:
        return None
    zfull = np.concatenate([r.x, r.u])
    # The two HiGHS entry points must agree on the vertex — alternate
    # optima would make the reused (x, u) ambiguous.
    if not np.allclose(res.x, zfull, atol=1e-7):
        return None

    fam = system.row_family
    lam_free = fam >= 3                       # delay, error
    y_ub = -res.ineqlin.marginals             # >= 0 for A_ub x <= b_ub
    y_eq = -res.eqlin.marginals
    resid = res.ineqlin.residual
    active = (np.abs(resid) < 1e-9) | (np.abs(y_ub) > 1e-9)
    if np.any(active & ~lam_free):
        return None

    at_y = K[:m_ub].T @ y_ub + K[m_ub:].T @ y_eq
    ub_vec = bounds[:, 1]
    at_lb = zfull <= 1e-9
    at_ub = zfull >= ub_vec - 1e-9
    interior = ~(at_lb | at_ub)

    # Vectorized per-window certificate over the whole segment.
    batch = ScenarioBatch.from_lam_path(lam_seg)
    vals_all, c_all = system.coefficient_batch(batch)
    rc = c_all + at_y[None, :]
    dual_ok = (np.all(rc[:, at_lb] >= -1e-9, axis=1)
               & np.all(rc[:, at_ub] <= 1e-9, axis=1)
               & np.all(np.abs(rc[:, interior]) <= 1e-7, axis=1))
    rows_i = system.rows_all[:system.nnz]
    cols_i = system.cols_all[:system.nnz]
    lhs = np.zeros((T, m_ub))
    np.add.at(lhs, (np.arange(T)[:, None], rows_i[None, :]),
              vals_all[:, :system.nnz] * zfull[cols_i][None, :])
    slack = system.row_ub[:m_ub][None, :] - lhs
    prim_ok = np.all(slack[:, ~lam_free] > 1e-9, axis=1)
    certified = dual_ok & prim_ok
    certified[0] = True          # window 0 is the exact solve itself
    if certified.sum() <= max(1, T // 4):
        return None              # too saturated to pay off: batch-solve

    op = np.empty(T)
    viols = r.viol * int(certified.sum())
    op[0] = r.cost
    for t in range(1, T):
        if certified[t]:
            _, c_t = system._coefficients(inst.tau, inst.e_base, lam_seg[t])
            op[t] = float(c_t[:nx] @ r.x + system.c_u @ r.u)
        else:
            rt = system.solve(lam=lam_seg[t], u_cap=cap)
            op[t] = rt.cost
            viols += rt.viol
    return op, viols


def _rolling_faulted(inst0: Instance, lam_path: np.ndarray, planner_obj,
                     replan_every: int | None, forecast_ewma: float,
                     static_forecast: str, window_h: float | None,
                     faults: FaultSchedule,
                     fault_response: str) -> RollingResult:
    """The supply-faulted replay: `rolling` with a `FaultSchedule`.

    Segments break at every supply change point (event-driven replans)
    AND at every adopted scheduled replan, so each segment has one
    deployment operated under one effective instance.  The operated
    deployment is always the eviction image of the planned one under the
    segment's availability caps — a frozen static placement therefore
    *loses* the traffic its revoked pairs carried, which is exactly the
    degradation the repair modes are measured against.  Event re-solves
    are adopted unconditionally (the incumbent is illegal under the new
    supply); scheduled replans keep the base path's keep-best rule,
    scored against the evicted incumbent."""
    if fault_response not in ("repair", "cold", "static"):
        raise ValueError(f"unknown fault_response {fault_response!r} "
                         f"(expected 'repair', 'cold', or 'static')")
    session = planner_obj if hasattr(planner_obj, "replan") else None
    planner = _as_planner(planner_obj)
    lam_path = np.asarray(lam_path, float)
    T = lam_path.shape[0]
    if window_h is None:
        window_h = 24.0 / T
    K = inst0.K
    # Effective-instance cache: one `apply_faults` materialization (and
    # one `__post_init__` tensor rebuild) per distinct supply state, not
    # per window.
    eff_cache: dict[bytes, Instance] = {}

    def eff_inst(t: int) -> Instance:
        key = faults.state_key(t, K)
        got = eff_cache.get(key)
        if got is None:
            got = apply_faults(inst0, faults, t)
            eff_cache[key] = got
        return got

    lam_fc0 = (lam_path.mean(axis=0) if static_forecast == "mean"
               else lam_path[0])
    deploy = planner(apply_faults(inst0.with_lam(lam_fc0), faults, 0))
    fc = ewma_forecasts(lam_path, forecast_ewma)
    events = set(faults.change_points(K))
    replans = fault_replans = evictions = 0
    repair_walls: list[float] = []
    degradations: list[int] = []
    segments: list[tuple[int, int, Solution]] = []
    t0 = 0
    for t in range(1, T):
        event = t in events
        sched = replan_every is not None and t % replan_every == 0
        if not (event or sched):
            continue
        inst_t = apply_faults(inst0.with_lam(fc[t]), faults, t)
        new_dep = None
        if event and fault_response != "static":
            # Event-driven re-solve, adopted unconditionally: the
            # incumbent deployment is illegal under the new supply.
            w0 = time.perf_counter()
            if fault_response == "repair" and session is not None:
                res = session.repair(instance=inst_t)
                rep = res.diagnostics.get("repair", {})
                evictions += len(rep.get("evicted", []))
                degradations.append(
                    int(rep.get("degradation", {}).get("level", 0)))
                new_dep = res.solution
            else:
                new_dep = planner(inst_t)
            repair_walls.append(time.perf_counter() - w0)
            fault_replans += 1
        elif sched and fault_response != "static":
            cand = planner(inst_t)
            # Keep-best against what the incumbent can actually run under
            # the current supply (its eviction image).
            inc_op, _ = evict_unavailable(inst_t, deploy)
            if objective(inst_t, cand) < objective(inst_t, inc_op) - 1e-6:
                new_dep = cand
                replans += 1
            elif session is not None:
                session.incumbent = inc_op
        if new_dep is not None or event:
            segments.append((t0, t, deploy))
            t0 = t
            if new_dep is not None:
                deploy = new_dep
    segments.append((t0, T, deploy))

    costs = np.zeros(T)
    viols = 0
    cap = np.full(inst0.I, STRICT_CAP)
    for (a, b, dep) in segments:
        if b <= a:
            continue
        ie = eff_inst(a)     # supply state is constant over the segment
        op_dep, lost = evict_unavailable(ie, dep)
        evictions += len(lost)
        rental_w = provisioning_cost(ie, op_dep) / inst0.Delta_T * window_h
        if np.any(op_dep.q > 0.5):
            system = Stage2System(ie, op_dep)
            batch = ScenarioBatch.from_lam_path(lam_path[a:b])
            op, v, _ = system.solve_batch(batch, u_cap=cap)
            viols += int(v.sum())
            costs[a:b] = rental_w + op * window_h
        else:
            # Nothing left deployed: every type fully unmet every window.
            viols += inst0.I * (b - a)
            pen = inst0.Delta_T * float(np.sum(inst0.phi))
            costs[a:b] = rental_w + pen * window_h
    return RollingResult(method="", mean_window_cost=float(costs.mean()),
                         total_cost=float(costs.sum()),
                         violation_rate=viols / (T * inst0.I),
                         per_window_cost=costs, replans=replans,
                         fault_replans=fault_replans, evictions=evictions,
                         repair_wall_s=tuple(repair_walls),
                         degradation_levels=tuple(degradations))


def volatility_study(inst0: Instance, sigma: float, trials: int,
                     planner: Callable[[Instance], Solution],
                     replan_every: int | None, seed: int = 0,
                     n_windows: int = 288) -> float:
    """Mean 24 h cost over `trials` random-walk demand paths (Table 4)."""
    totals = []
    for trial in range(trials):
        rng = np.random.default_rng(seed + 1000 * trial)
        path = random_walk_lambdas(inst0.lam, sigma, n_windows, rng)
        res = rolling(inst0, path, planner, replan_every=replan_every)
        totals.append(res.total_cost)
    return float(np.mean(totals))


def replay_study(inst0: Instance, planner: Callable[[Instance], Solution],
                 days: Sequence[str] = ("busy",), n_windows: int = 288,
                 stress: float | None = None,
                 replan_every: int | None = None, seed: int = 7,
                 forecast_ewma: float = 0.4,
                 faults: FaultSchedule | None = None,
                 fault_response: str = "repair") -> RollingResult:
    """Diurnal trace replay over one or more synthetic days (§5.3 extended).

    `days` concatenates per-day multiplier series ("busy"/"volatile") into a
    multi-day path; `n_windows` is windows PER DAY (window_h stays 24/n
    regardless of the number of days); `stress` applies a uniform
    delay+error inflation (e.g. 1.5 for the 1.5x out-of-sample stress) to
    the operated instance before the replay.  `faults`/`fault_response`
    inject a supply-side `FaultSchedule` exactly as in `rolling` (the
    schedule's `n_windows` should cover the full multi-day path).
    """
    inst = inst0.stressed(stress) if stress is not None else inst0
    mult = multi_day_multipliers(days, seed=seed, n_windows=n_windows)
    path = np.outer(mult, inst.lam)
    return rolling(inst, path, planner, replan_every=replan_every,
                   forecast_ewma=forecast_ewma, static_forecast="mean",
                   window_h=24.0 / n_windows, faults=faults,
                   fault_response=fault_response)
