"""Public risk-evaluation API.

`risk_evaluate(inst, deploy, S=20_000, engine="pdhg"|"exact")` draws the
evaluation protocol's scenario family in memory-bounded chunks
(`Instance.perturbed_chunks`), solves every scenario's relaxed Stage-2
LP through the batched first-order solver (or the exact oracle), and
folds the per-scenario costs into a `RiskReport`: expected cost,
CVaR_a, violation quantiles, per-constraint tail attribution, and the
solver's convergence diagnostics (anchor hits, harvests, PDHG
iterations, exact fallbacks — non-converged scenarios are solved
exactly and counted, never dropped).

`rank_deployments` scores a set of candidate plans CVaR-vs-expected
under the paper's 1.5x stress family — the report the risk subsystem
exists to produce.

torch is imported lazily (inside the pdhg engine path only): the exact
engine and the report plumbing stay numpy/scipy. The pdhg engine runs on
CUDA unless the caller passes `device="cpu"`; without CUDA it raises.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any

import numpy as np

from ..core.instance import Instance
from ..core.solution import Solution, provisioning_cost
from ..core.stage2 import Stage2System
from .metrics import ALPHAS, risk_stats

ENGINES = ("pdhg", "exact")

#: evaluation-protocol scenario family (matches the reference's
#: `core.evaluate.evaluate`).
PROTOCOL = {"d_infl": 0.15, "e_infl": 0.10, "lam_pm": 0.20, "seed": 1234}


@dataclasses.dataclass
class RiskReport:
    """Risk statistics of one (instance, deployment) pair.

    Costs are TOTAL (stage-1 provisioning + per-scenario stage-2
    operation), so expected/CVaR columns are directly comparable across
    deployments with different provisioning spend.
    """
    method: str
    engine: str
    S: int
    stage1_cost: float
    expected_cost: float              # stage1 + mean stage2
    cost_std: float
    var: dict[str, float]             # alpha -> total-cost VaR
    cvar: dict[str, float]            # alpha -> total-cost CVaR
    violation_rate: float             # P(type-scenario pair unmet > 1%)
    viol_quantiles: dict[str, float]  # per-scenario violation counts
    unmet_quantiles: dict[str, float]  # per-scenario unmet mass
    tail_attribution: dict[str, dict[str, float]]
    diagnostics: dict[str, Any]
    wall_s: float

    # -- serialization --------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "RiskReport":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_json(cls, s: str) -> "RiskReport":
        return cls.from_dict(json.loads(s))

    def summary(self) -> dict[str, float | int | str]:
        """Flat registry row (planner diagnostics, benchmark tables)."""
        row: dict[str, float | int | str] = {
            "method": self.method,
            "engine": self.engine,
            "S": self.S,
            "expected_cost": self.expected_cost,
            "violation_rate": self.violation_rate,
            "wall_s": self.wall_s,
        }
        for k, v in self.cvar.items():
            row[f"cvar_{k}"] = v
        for k, v in self.viol_quantiles.items():
            row[f"viol_{k}"] = v
        d = self.diagnostics
        for k in ("n_anchor0", "n_harvest_exact", "n_pdhg",
                  "n_fallback_exact", "n_anchors"):
            if k in d:
                row[k] = d[k]
        return row


def risk_evaluate(inst: Instance, deploy: Solution, S: int = 20_000,
                  engine: str = "pdhg", *,
                  seed: int | None = None,
                  d_infl: float | None = None, e_infl: float | None = None,
                  lam_pm: float | None = None,
                  chunk: int = 8192, max_anchors: int = 32,
                  alphas: tuple[float, ...] = ALPHAS,
                  tail_alpha: float = 0.95,
                  device: str = "cuda") -> RiskReport:
    """Tail-risk evaluation of a frozen deployment over S scenarios.

    Both engines solve the RELAXED Stage-2 protocol (u <= 1, always
    feasible) and draw bit-identical scenarios from the evaluation
    family, so `engine="exact"` is the oracle for `engine="pdhg"`
    (objectives agree to rtol 1e-5; pinned in tests/test_torch_risk.py).
    `device` is where the pdhg engine's tensors live; the exact engine
    ignores it.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; pick from {ENGINES}")
    seed = PROTOCOL["seed"] if seed is None else seed
    d_infl = PROTOCOL["d_infl"] if d_infl is None else d_infl
    e_infl = PROTOCOL["e_infl"] if e_infl is None else e_infl
    lam_pm = PROTOCOL["lam_pm"] if lam_pm is None else lam_pm

    t0 = time.perf_counter()
    system = Stage2System(inst, deploy)
    if engine == "pdhg":
        from .solver import BatchedStage2Solver  # lazy: pulls in torch
        solver = BatchedStage2Solver(system, device=device,
                                     max_anchors=max_anchors)
        solve_chunk = solver.solve_scenarios
    else:
        from .solver_exact import ExactChunkSolver
        solver = ExactChunkSolver(system)
        solve_chunk = solver.solve_scenarios

    rng = np.random.default_rng(seed)
    costs = np.zeros(S)
    viols = np.zeros(S, dtype=np.int64)
    unmet = np.zeros(S)
    util = np.zeros((S, len(Stage2System.ROW_FAMILIES)))
    done = 0
    for batch in inst.perturbed_chunks(rng, S, chunk=chunk, d_infl=d_infl,
                                       e_infl=e_infl, lam_pm=lam_pm):
        out = solve_chunk(batch)
        sl = slice(done, done + batch.S)
        costs[sl] = out.costs
        viols[sl] = out.viols
        unmet[sl] = out.unmet
        util[sl] = out.util
        done += batch.S
    wall = time.perf_counter() - t0

    s1 = provisioning_cost(inst, deploy)
    stats = risk_stats(s1 + costs, viols, unmet, util,
                       Stage2System.ROW_FAMILIES, alphas=alphas,
                       tail_alpha=tail_alpha)
    diag = dict(solver.diagnostics)
    diag["n_anchors"] = len(getattr(solver, "anchors", ()))
    return RiskReport(
        method=deploy.method, engine=engine, S=S, stage1_cost=float(s1),
        expected_cost=stats["expected_cost"], cost_std=stats["cost_std"],
        var=stats["var"], cvar=stats["cvar"],
        violation_rate=stats["viol_total"] / (S * inst.I),
        viol_quantiles=stats["viol_quantiles"],
        unmet_quantiles=stats["unmet_quantiles"],
        tail_attribution=stats["tail_attribution"],
        diagnostics=diag, wall_s=float(wall))


def rank_deployments(inst: Instance, deployments: dict[str, Solution],
                     S: int = 20_000, engine: str = "pdhg", *,
                     stress: float = 1.5, alpha: float = 0.95,
                     chunk: int = 8192,
                     device: str = "cuda") -> dict[str, Any]:
    """CVaR-vs-expected ranking of candidate plans under stress.

    Evaluates every deployment on `inst.stressed(stress)` (the paper's
    1.5x delay/error inflation family) and returns both orderings —
    the interesting output is where they DISAGREE: a plan that wins on
    expected cost but loses on CVaR_alpha is buying its average from
    the tail.
    """
    key = f"{alpha:.2f}"
    stressed = inst.stressed(stress)
    reports = {
        name: risk_evaluate(stressed, dep, S=S, engine=engine, chunk=chunk,
                            device=device)
        for name, dep in deployments.items()
    }
    by_exp = sorted(reports, key=lambda k: reports[k].expected_cost)
    by_cvar = sorted(reports, key=lambda k: reports[k].cvar[key])
    return {
        "stress": stress,
        "alpha": alpha,
        "S": S,
        "engine": engine,
        "ranking_expected": by_exp,
        "ranking_cvar": by_cvar,
        "agree": by_exp == by_cvar,
        "summaries": {k: r.summary() for k, r in reports.items()},
        "reports": reports,
    }
