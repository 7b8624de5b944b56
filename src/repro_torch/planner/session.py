"""`PlanSession` — warm-started replanning over a drifting workload.

A session holds the latest incumbent plan.  `replan()` solves the drifted
problem by seeding AGH's multi-start from that incumbent: the incumbent's
deployment (q, cfg, y) is re-routed under the new demand by one GH
Phase-2 pass, polished by the incremental local search, and installed as
the multi-start's starting best — so the early-stop patience counts from
a strong bound immediately and the solve finishes after a handful of
orderings instead of a cold multi-start.  SageServe's observation
operationalized: at fleet scale, forecast-aware *replanning* beats cold
re-solves because consecutive windows share most of their structure.

The replan protocol trades the cold run's ordering coverage for wall
clock (patience drops from 5 to `replan_patience`, random restarts are
skipped); on drifted workloads the warm seed's head start more than
covers the difference — `benchmarks/allocator_scaling.py` demonstrates
objective <= cold AGH at measurably lower wall time on the (100,80,40)
fleet, and tests/test_perf_smoke.py guards it.

`core.rolling.rolling()` accepts a session wherever it took a bare
planner callable, which turns every rolling-horizon window after the
first into a warm-started solve.

`repair()` is the supply-fault counterpart of `replan()`: same warm
incumbent, but the drift is on the SUPPLY side (tier outages, spot
revocations, capacity shocks from `core.faults`) — assignments on lost
capacity are evicted and the displaced load re-routed by
`core.agh.agh_repair`, with a graceful-degradation ladder (unmet-cap →
delay-relax → budget-overdraft) instead of a bare infeasibility error.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.agh import agh_repair
from repro_torch.core.faults import FaultSchedule, apply_faults
from repro_torch.core.forecast import relative_drift
from repro_torch.core.instance import Instance
from repro_torch.core.solution import Solution

from .api import PlanOptions, PlanRequest, PlanResult, build_result, plan
from .registry import get_solver
from .specs import ScenarioSpec


def _unmet_excess(inst: Instance, sol: Solution) -> float:
    """Arrival-weighted unmet demand beyond the per-type zeta caps — the
    quantity the degradation ladder is minimizing when strict repair is
    out of reach (queries/hour left unserved past the SLO contract)."""
    return float(np.sum(np.maximum(sol.u - inst.zeta, 0.0) * inst.lam))


def _ladder_score(inst: Instance, res: PlanResult) -> tuple[float, float]:
    """Lexicographic degradation score: excess unmet first, then total
    constraint-violation mass.  Ladder retries are adopted only on a
    strict improvement, so a relaxed re-solve can never make the
    operated plan worse than what the strict rung already produced."""
    return (_unmet_excess(inst, res.solution),
            float(sum(res.violations.values())))


@dataclasses.dataclass
class PlanSession:
    """Stateful planning handle: cold-solve once, warm-replan thereafter.

    ``replan_patience`` / ``replan_restarts`` shape the warm protocol
    (early-stop patience and random-restart budget of replans); the cold
    first solve always uses the full `options` as given.  Solvers that
    cannot warm-start (everything but AGH today) fall back to cold solves
    on every call — the session is still useful as a uniform driver.

    ``engine=`` is shorthand for setting ``options.engine``:
    ``PlanSession(engine="torch")`` runs both the cold solve and every
    warm replan on the lane-batched torch tier (the replan option override goes
    through `dataclasses.replace`, so the engine choice survives it).
    """
    solver: str = "agh"
    options: PlanOptions = dataclasses.field(default_factory=PlanOptions)
    engine: str | None = None
    replan_patience: int = 2
    replan_restarts: int = 0
    repair_delay_relax: float = 1.5
    repair_budget_overdraft: float = 1.5
    incumbent: Solution | None = None
    last_result: PlanResult | None = None
    last_instance: Instance | None = None
    winning_order: tuple[int, ...] | None = None
    plans: int = 0
    warm_replans: int = 0
    repairs: int = 0
    # Controller hooks (repro_torch.serving.driver): every solve appends one
    # JSON-safe row {kind, cause, wall_s, objective, warm} here, so the
    # closed-loop replan log and the session's own accounting can never
    # disagree.  `cause=` on replan()/repair() is recorded verbatim.
    replan_log: list[dict] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        if self.engine is not None:
            self.options = dataclasses.replace(self.options,
                                               engine=self.engine)

    def plan(self, instance: Instance | None = None,
             scenario: ScenarioSpec | str | None = None) -> PlanResult:
        """Cold solve; installs the result as the session incumbent."""
        inst = self._resolve(instance, scenario)
        res = plan(PlanRequest(solver=self.solver, instance=inst,
                               options=self.options))
        self._install(inst, res, kind="plan")
        return res

    def replan(self, instance: Instance | None = None,
               scenario: ScenarioSpec | str | None = None,
               lam: np.ndarray | None = None,
               cause: str | None = None) -> PlanResult:
        """Warm-started solve for a drifted problem.

        ``lam=`` is shorthand for "same instance, new demand vector"; it
        requires a prior solve (the session remembers the instance).
        Without an incumbent this degrades to a cold `plan()`.
        ``cause=`` tags the `replan_log` row (the serving controller
        passes its trigger cause — "drift"/"slo"/"scheduled").
        """
        if lam is not None:
            if instance is not None or scenario is not None:
                raise ValueError("pass lam= alone, or instance=/scenario=")
            if self.last_instance is None:
                raise ValueError("lam= replan needs a prior plan()/replan() "
                                 "on a full instance")
            instance = self.last_instance.with_lam(np.asarray(lam, float))
        inst = self._resolve(instance, scenario)
        if (self.incumbent is None
                or self.incumbent.x.shape != (inst.I, inst.J, inst.K)):
            # No incumbent, or one from a differently-shaped problem
            # (population changed): nothing to warm-start from.
            return self.plan(instance=inst)
        warm = get_solver(self.solver).supports_warm_start
        opts = self.options
        if warm:
            # Fast-replan protocol: tighter patience, no random restarts,
            # and the incumbent's winning ordering replayed first (the
            # multi-start winner is empirically stable under drift — see
            # core/agh.py `priority_orders`).  The sequential driver is
            # pinned unless the caller set workers explicitly: AGH's
            # auto fan-out evaluates EVERY ordering with no early stop,
            # which would silently discard the patience the warm seed
            # buys — exactly at the fleet scales where auto engages.
            opts = dataclasses.replace(
                opts, patience=self.replan_patience,
                restarts=self.replan_restarts, order=self.winning_order,
                workers=0 if opts.workers is None else opts.workers)
        res = plan(PlanRequest(solver=self.solver, instance=inst,
                               options=opts, warm_start=self.incumbent))
        self._install(inst, res, warm=warm, kind="replan", cause=cause)
        return res

    def drift(self, lam: np.ndarray) -> float:
        """Demand-weighted relative L1 drift of `lam` against the rates
        the incumbent plan was built for (`core.forecast.relative_drift`)
        — the controller's trigger statistic, exposed for inspection."""
        if self.last_instance is None:
            raise ValueError("drift() needs a prior plan()/replan()")
        return relative_drift(np.asarray(lam, float),
                              self.last_instance.lam)

    def repair(self, instance: Instance | None = None,
               scenario: ScenarioSpec | str | None = None,
               schedule: FaultSchedule | None = None, t: int = 0,
               passes: int = 1, cause: str | None = None) -> PlanResult:
        """Repair the incumbent after a supply-side fault, degrading
        gracefully instead of erroring when strict repair is infeasible.

        The instance is the *faulted* supply view — either passed
        directly (e.g. from `core.rolling`'s fault replay), or derived
        here via ``schedule=``/``t=`` (`core.faults.apply_faults` on the
        remembered or given instance).  With a shape-compatible AGH
        incumbent the solve is `core.agh.agh_repair`: surviving
        assignments pinned, pairs on lost capacity evicted through the
        drain machinery, displaced load re-routed by one Phase-2 pass and
        `passes` incremental local-search passes.  Otherwise (no
        incumbent, population changed, non-warm-startable solver) it
        falls back to a cold registry solve on the faulted instance.

        When the strict solve is infeasible, a graceful-degradation
        ladder runs — each rung adopted only if it strictly improves
        `_ladder_score` against the REAL faulted instance:

        1. **unmet-cap** — hard constraints hold; only the zeta unmet cap
           overshoots.  No re-solve: the overshoot is reported.
        2. **delay-relax** — re-solve with the delay SLOs stretched by
           ``repair_delay_relax`` (coverage bought with latency).
        3. **budget-overdraft** — re-solve with the budget stretched by
           ``repair_budget_overdraft`` on top; the overdraft is flagged.

        The result always carries ``diagnostics["repair"]`` with the
        evicted pairs, warm/cold provenance, and a ``degradation`` report
        (``level`` 0–3, rung ``name``, the ``ladder`` rungs attempted,
        and the residual violation families) — an infeasible repair is
        never silent: its level is >= 1 with a non-empty report."""
        if instance is None and scenario is None:
            if self.last_instance is None:
                raise ValueError("repair() without instance=/scenario= "
                                 "needs a prior plan()/replan()")
            inst = self.last_instance
        else:
            inst = self._resolve(instance, scenario)
        if schedule is not None:
            inst = apply_faults(inst, schedule, t)
        t0, c0 = time.perf_counter(), time.process_time()
        sol, diag, warm = self._repair_solve(inst, passes)
        evicted = [list(map(int, jk)) for jk in diag.get("evicted", [])]
        res = build_result(self.solver, inst, sol, 0.0, 0.0, dict(diag),
                           self.options)
        level, name = 0, "strict"
        tried = ["strict"]
        if not res.feasible:
            level, name = 1, "unmet-cap"
            tried.append("delay-relax")
            relaxed = dataclasses.replace(
                inst, Delta=inst.Delta * self.repair_delay_relax)
            cand = self._ladder_retry(inst, relaxed, res, passes)
            base = inst
            if cand is not None:
                res, base = cand, relaxed
                level, name = 2, "delay-relax"
            if not res.feasible:
                tried.append("budget-overdraft")
                overdrawn = dataclasses.replace(
                    base, delta=inst.delta * self.repair_budget_overdraft)
                cand = self._ladder_retry(inst, overdrawn, res, passes)
                if cand is not None:
                    res = cand
                    level, name = 3, "budget-overdraft"
        if res.feasible:
            # A ladder retry may land a plan that satisfies the REAL
            # constraint system outright — then nothing was degraded.
            level, name = 0, "strict"
        res.wall_s = time.perf_counter() - t0
        res.cpu_s = time.process_time() - c0
        res.diagnostics["repair"] = {
            "evicted": evicted, "warm": warm, "wall_s": res.wall_s,
            "degradation": {
                "level": level, "name": name, "ladder": tried,
                "violations": {k: float(v)
                               for k, v in res.violations.items()
                               if v > 1e-4},
                "unmet_excess": _unmet_excess(inst, res.solution),
                "zeta_overshoot": float(
                    res.violations.get("unmet_cap", 0.0)),
                "budget_overdraft": float(
                    res.violations.get("budget", 0.0)),
            }}
        self._install(inst, res, warm=warm, kind="repair", cause=cause)
        self.repairs += 1
        return res

    def _repair_solve(self, inst: Instance,
                      passes: int) -> tuple[Solution, dict, bool]:
        """One repair solve: warm `agh_repair` when the incumbent can seed
        it, else a cold registry solve.  Returns (solution, diagnostics,
        warm?)."""
        spec = get_solver(self.solver)
        if (self.incumbent is not None and spec.supports_warm_start
                and self.incumbent.x.shape == (inst.I, inst.J, inst.K)):
            stats: dict = {}
            sol = agh_repair(inst, self.incumbent, L=max(1, passes),
                             local_search=self.options.local_search,
                             validate=self.options.validate, stats=stats)
            return sol, stats, True
        sol, diag = spec.solve(inst, self.options, None)
        return sol, dict(diag), False

    def _ladder_retry(self, real: Instance, relaxed: Instance,
                      cur: PlanResult, passes: int) -> PlanResult | None:
        """Solve one ladder rung on the `relaxed` instance, score it
        against the REAL faulted instance, and return it only on a strict
        `_ladder_score` improvement over the current best."""
        sol, diag, _ = self._repair_solve(relaxed, passes)
        cand = build_result(self.solver, real, sol, 0.0, 0.0, dict(diag),
                            self.options)
        if _ladder_score(real, cand) < _ladder_score(real, cur):
            return cand
        return None

    def seed(self, instance: Instance, result: PlanResult) -> None:
        """Install an externally computed `PlanResult` as the incumbent
        (e.g. one loaded from a JSON dump, or a solve a benchmark already
        paid for) without re-solving."""
        self._install(instance, result)

    # Back-compat with the bare-callable planner protocol: a session IS a
    # planner (rolling() and the benchmarks accept either the same way).
    def __call__(self, inst: Instance) -> Solution:
        return self.replan(instance=inst).solution

    @staticmethod
    def _resolve(instance: Instance | None,
                 scenario: ScenarioSpec | str | None) -> Instance:
        return PlanRequest(instance=instance,
                           scenario=scenario).resolve_instance()

    def _install(self, inst: Instance, res: PlanResult,
                 warm: bool = False, kind: str = "plan",
                 cause: str | None = None) -> None:
        self.incumbent = res.solution
        self.last_result = res
        self.last_instance = inst
        self.plans += 1
        self.warm_replans += int(warm)
        self.replan_log.append({
            "kind": kind, "cause": cause, "warm": warm,
            "wall_s": float(res.wall_s),
            "objective": float(res.objective)})
        win = res.diagnostics.get("winning_order")
        if win is not None:
            # Keep the previous remembered ordering when the warm seed
            # itself won — it is still the last known-good construction.
            self.winning_order = tuple(int(i) for i in win)
