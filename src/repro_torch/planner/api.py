"""The unified planning facade: `plan(request) -> PlanResult`.

One entry point replaces the five loose solver functions (`gh`, `agh`,
`solve_milp`, `dvr`/`hf`/`lpr`) and their divergent kwargs:

* `PlanOptions` — the typed option set every solver draws from (restarts,
  local-search mode, workers, time limit, ...).  Irrelevant options are
  ignored by construction (each adapter picks the fields it understands),
  but the *names* are checked: `PlanOptions` is a frozen dataclass, so a
  typo'd option fails at the call site instead of vanishing into `**kw`.
* `PlanRequest` — solver name (resolved through the registry) + problem
  (an `Instance`, or a declarative scenario spec / scenario name from
  `repro_torch.planner.specs`) + options + optional warm-start incumbent.
* `PlanResult` — solution, objective, cost breakdown, per-constraint
  slack report, wall/CPU timings, and solver diagnostics; JSON-round-
  trippable so benchmark dumps and the CI regression gate consume
  registry-keyed rows directly.

The old entry points remain as thin, bit-identical shims — the facade
calls exactly them, pinned by tests/test_planner_api.py.
"""
from __future__ import annotations

import dataclasses
import json
import time

from repro_torch.core.instance import Instance
from repro_torch.core.solution import (Solution, _constraint_usage, cost_terms,
                                 feasibility, objective, slack_report)

from .registry import get_solver


@dataclasses.dataclass(frozen=True)
class PlanOptions:
    """Typed solver options (the union of what the backends understand).

    | field          | consumed by        | meaning                        |
    |----------------|--------------------|--------------------------------|
    | ``seed``       | agh                | RNG seed for random restarts   |
    | ``restarts``   | agh                | random-restart count R         |
    |                |                    | (None = Remark-2 adaptive)     |
    | ``passes``     | agh                | local-search pass cap L        |
    | ``patience``   | agh                | early-stop patience            |
    | ``local_search``| agh               | "batched" / "batched-rescan" / |
    |                |                    | "reference"                    |
    | ``engine``     | agh                | "numpy" (default, the oracle)  |
    |                |                    | / "torch" (the lane-batched    |
    |                |                    | tier, core/tier.py; "xla" is   |
    |                |                    | the reference's name for it)   |
    | ``batch_width``| agh (batched tier) | lanes per device call in the   |
    |                |                    | lockstep batch (None = all)    |
    | ``device``     | agh (batched tier) | where the tier runs: None =    |
    |                |                    | "cuda" (raises without CUDA),  |
    |                |                    | or "cpu"; omitted from         |
    |                |                    | to_dict() while None           |
    | ``workers``    | agh                | multi-start fan-out width      |
    | ``validate``   | agh                | per-move debug consistency     |
    | ``order``      | gh                 | Phase-2 type ordering override |
    | ``run_phase1`` | gh                 | coverage pre-allocation on/off |
    | ``ablation``   | gh                 | M1/M2/M3 ablation switches     |
    | ``time_limit`` | milp, lpr          | solver wall-clock cap (s);     |
    |                |                    | None = the backend's own       |
    |                |                    | default (milp 600, lpr 120),   |
    |                |                    | keeping facade == direct call  |
    | ``mip_rel_gap``| milp               | MIP relative-gap tolerance     |
    | ``relax``      | milp               | solve the LP relaxation        |
    | ``risk``       | plan() post-pass   | kwargs for `repro_torch.risk.  |
    |                |                    | risk_evaluate` run on the      |
    |                |                    | solved plan (e.g. {"S": 5000,  |
    |                |                    | "engine": "pdhg"}, on CUDA     |
    |                |                    | unless "device": "cpu"); the   |
    |                |                    | report summary lands in        |
    |                |                    | diagnostics["risk"].  None     |
    |                |                    | (default) skips it — no torch  |
    |                |                    | import, bit-identical output   |
    """
    seed: int = 0
    restarts: int | None = None
    passes: int = 3
    patience: int = 5
    local_search: str = "batched"
    engine: str = "numpy"
    batch_width: int | None = None
    workers: int | None = None
    validate: bool = False
    order: tuple[int, ...] | None = None
    run_phase1: bool = True
    ablation: frozenset = frozenset()
    time_limit: float | None = None
    mip_rel_gap: float = 1e-3
    relax: bool = False
    risk: dict | None = None
    device: str | None = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ablation"] = sorted(self.ablation)
        d["order"] = list(self.order) if self.order is not None else None
        if self.device is None:
            del d["device"]
        return d

    @staticmethod
    def from_dict(d: dict) -> "PlanOptions":
        d = dict(d)
        if d.get("ablation") is not None:
            d["ablation"] = frozenset(d["ablation"])
        if d.get("order") is not None:
            d["order"] = tuple(d["order"])
        return PlanOptions(**d)


@dataclasses.dataclass
class PlanRequest:
    """What to solve, with what, and how.

    Exactly one of `instance` / `scenario` must be given; `scenario` is a
    `ScenarioSpec` or a registered scenario name (see
    `repro_torch.planner.specs.scenario`).
    """
    solver: str = "agh"
    instance: Instance | None = None
    scenario: object | None = None      # ScenarioSpec | str
    options: PlanOptions = dataclasses.field(default_factory=PlanOptions)
    warm_start: Solution | None = None

    def resolve_instance(self) -> Instance:
        if (self.instance is None) == (self.scenario is None):
            raise ValueError("PlanRequest needs exactly one of "
                             "instance= or scenario=")
        if self.instance is not None:
            return self.instance
        from .specs import ScenarioSpec, scenario
        spec = self.scenario
        if isinstance(spec, str):
            spec = scenario(spec)
        if not isinstance(spec, ScenarioSpec):
            raise TypeError(f"scenario must be a ScenarioSpec or a "
                            f"registered name, got {type(spec).__name__}")
        return spec.build()


@dataclasses.dataclass
class PlanResult:
    """Structured solver output — everything a caller used to re-derive by
    hand from a bare `Solution` (and several things none could get at all).

    ``diagnostics`` is solver-specific but JSON-safe: AGH reports
    orderings evaluated, local-search moves applied, drains, fallback
    rescans, and warm-start provenance; MILP reports its status string.
    """
    solver: str
    solution: Solution
    objective: float
    cost_breakdown: dict[str, float]
    slack: dict[str, float]
    violations: dict[str, float]
    feasible: bool
    wall_s: float
    cpu_s: float
    diagnostics: dict
    options: dict

    def summary(self) -> dict:
        """Flat registry-row summary (no arrays) for benchmark JSON dumps."""
        return {"solver": self.solver, "objective": round(self.objective, 4),
                "wall_s": round(self.wall_s, 4),
                "feasible": self.feasible, **{
                    f"slack_{k}": (round(v, 6) if v != float("inf") else None)
                    for k, v in self.slack.items()}}

    def to_dict(self) -> dict:
        return {
            "solver": self.solver, "solution": self.solution.to_dict(),
            "objective": self.objective,
            "cost_breakdown": self.cost_breakdown, "slack": self.slack,
            "violations": self.violations, "feasible": self.feasible,
            "wall_s": self.wall_s, "cpu_s": self.cpu_s,
            "diagnostics": self.diagnostics, "options": self.options,
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @staticmethod
    def from_dict(d: dict) -> "PlanResult":
        return PlanResult(
            solver=d["solver"], solution=Solution.from_dict(d["solution"]),
            objective=float(d["objective"]),
            cost_breakdown=dict(d["cost_breakdown"]),
            slack={k: (float("inf") if v is None else float(v))
                   for k, v in d["slack"].items()},
            violations=dict(d["violations"]), feasible=bool(d["feasible"]),
            wall_s=float(d["wall_s"]), cpu_s=float(d["cpu_s"]),
            diagnostics=dict(d["diagnostics"]), options=dict(d["options"]))

    @staticmethod
    def from_json(s: str) -> "PlanResult":
        return PlanResult.from_dict(json.loads(s))


def plan(request: PlanRequest | str | None = None, *,
         instance: Instance | None = None, scenario: object | None = None,
         options: PlanOptions | None = None,
         warm_start: Solution | None = None,
         engine: str | None = None) -> PlanResult:
    """Solve one planning request through the registry.

    Accepts a full `PlanRequest`, or the convenience form
    ``plan("agh", instance=inst, options=PlanOptions(...))``.
    ``engine=`` is convenience-form shorthand for
    ``options=dataclasses.replace(options, engine=...)`` — e.g.
    ``plan(instance=inst, engine="torch")`` runs AGH on the lane-batched
    torch tier, on CUDA unless ``options.device`` is ``"cpu"`` (it raises
    without CUDA; ``engine="xla"`` is the same tier).
    """
    if isinstance(request, str) or request is None:
        opts = options or PlanOptions()
        if engine is not None:
            opts = dataclasses.replace(opts, engine=engine)
        request = PlanRequest(solver=request or "agh", instance=instance,
                              scenario=scenario, options=opts,
                              warm_start=warm_start)
    elif (instance is not None or scenario is not None
          or options is not None or warm_start is not None
          or engine is not None):
        raise ValueError("pass either a PlanRequest or keyword fields, "
                         "not both")
    spec = get_solver(request.solver)
    inst = request.resolve_instance()
    warm = request.warm_start if spec.supports_warm_start else None
    t0, c0 = time.perf_counter(), time.process_time()
    sol, diag = spec.solve(inst, request.options, warm)
    wall, cpu = time.perf_counter() - t0, time.process_time() - c0
    diag = dict(diag)
    if request.warm_start is not None:
        diag.setdefault("warm_started", spec.supports_warm_start)
    result = build_result(spec.name, inst, sol, wall, cpu, diag,
                          request.options)
    if request.options.risk is not None:
        # Post-pass tail-risk evaluation of the solved plan.  Lazy
        # import: plans without risk= never touch repro_torch.risk.
        from repro_torch.risk import risk_evaluate
        report = risk_evaluate(inst, result.solution,
                               **request.options.risk)
        result.diagnostics["risk"] = report.summary()
    return result


def build_result(solver: str, inst: Instance, sol: Solution, wall_s: float,
                 cpu_s: float, diagnostics: dict,
                 options: PlanOptions) -> PlanResult:
    """Assemble a `PlanResult` from a solved `Solution` — the one place
    the violation/slack views are derived.

    The constraint system is evaluated INCLUDING the zeta unmet cap, so
    `feasible` can never contradict slack["unmet"].  (The heuristics
    themselves treat zeta as soft — Stage-2 routing enforces it — so a
    zeta-violating plan is reported infeasible here yet still operable.)
    One shared usage pass feeds both the violation and slack views.
    """
    usage = _constraint_usage(inst, sol)
    viol = feasibility(inst, sol, enforce_zeta=True, usage=usage)
    return PlanResult(
        solver=solver, solution=sol, objective=objective(inst, sol),
        cost_breakdown=cost_terms(inst, sol),
        slack=slack_report(inst, sol, usage=usage), violations=viol,
        feasible=all(v <= 1e-4 for v in viol.values()),
        wall_s=wall_s, cpu_s=cpu_s, diagnostics=diagnostics,
        options=options.to_dict())
