"""Two-stage evaluation protocol (paper §5.2).

Stage 1: each algorithm computes deployment decisions (y*, z*, w*) on the
forecast instance; the deployment is then frozen.
Stage 2: for each of S perturbed scenarios (delay/error inflated one-sided
by up to 10–25%, arrivals ±20%), only routing x and unmet u are re-optimized
— an exact LP.

Primary metric: SLO violation rate = fraction of (scenario, type) pairs with
more than 1% of demand unserved.  Secondary: expected total cost = Stage-1
provisioning cost + scenario-averaged Stage-2 storage/delay/unmet penalties.

Fast path (default): the S scenarios are sampled as one stacked
`ScenarioBatch` and solved through a single `Stage2System` — the LP pattern
is assembled once for the frozen deployment and only coefficients are
refreshed per scenario.  `batched=False` keeps the original per-scenario
loop (one `Instance.perturbed` + one `stage2_lp` per scenario); both paths
draw bit-identical scenarios, so they agree to solver precision — pinned by
tests/test_stage2_equivalence.py.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .instance import Instance
from .solution import Solution, provisioning_cost
from .stage2 import Stage2System, stage2_cost, stage2_lp


@dataclasses.dataclass
class EvalResult:
    method: str
    stage1_cost: float
    expected_cost: float
    violation_rate: float
    runtime_s: float
    per_scenario_cost: np.ndarray


def evaluate(inst: Instance, deploy: Solution, S: int = 500, seed: int = 1234,
             d_infl: float = 0.15, e_infl: float = 0.10, lam_pm: float = 0.20,
             u_cap: np.ndarray | None = None, batched: bool = True,
             workers: int | None = None) -> EvalResult:
    rng = np.random.default_rng(seed)
    s1 = provisioning_cost(inst, deploy)
    if batched:
        batch = inst.perturbed_batch(rng, S, d_infl=d_infl, e_infl=e_infl,
                                     lam_pm=lam_pm)
        system = Stage2System(inst, deploy)
        costs, viols, _ = system.solve_batch(batch, u_cap=u_cap,
                                             workers=workers)
        viol = int(viols.sum())
    else:
        costs = np.zeros(S)
        viol = 0
        for s in range(S):
            scen = inst.perturbed(rng, d_infl=d_infl, e_infl=e_infl,
                                  lam_pm=lam_pm)
            sol, _ = stage2_lp(scen, deploy, u_cap=u_cap)
            costs[s] = stage2_cost(scen, sol)
            viol += int(np.sum(sol.u > 0.01))
    return EvalResult(method=deploy.method, stage1_cost=s1,
                      expected_cost=s1 + float(costs.mean()),
                      violation_rate=viol / (S * inst.I),
                      runtime_s=deploy.runtime_s, per_scenario_cost=costs)
