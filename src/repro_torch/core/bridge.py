"""Planner -> serving bridge: turns an allocator `Solution` into the
deployed (model, tier, TP, PP, routing) pairs the serving engines run.

The reference package's TPU tier catalog and its dry-run calibration are
not carried over: the port's tier constants arrive with its launch layer.
"""
from __future__ import annotations

import dataclasses

from .instance import Instance
from .solution import Solution


@dataclasses.dataclass
class PairDeployment:
    model: str
    tier: str
    tp: int
    pp: int
    n_chips: int
    routing: dict[str, float]      # query type -> fraction of that type


@dataclasses.dataclass
class DeploymentSpec:
    pairs: list[PairDeployment]


def to_deployment(inst: Instance, sol: Solution) -> DeploymentSpec:
    pairs = []
    for j in range(inst.J):
        for k in range(inst.K):
            if sol.q[j, k] < 0.5:
                continue
            cfg = sol.config_of(inst, j, k)
            if cfg is None:
                continue
            n, m = cfg
            routing = {inst.query_names[i]: float(sol.x[i, j, k])
                       for i in range(inst.I) if sol.x[i, j, k] > 1e-9}
            pairs.append(PairDeployment(
                model=inst.model_names[j], tier=inst.tier_names[k],
                tp=n, pp=m, n_chips=int(sol.y[j, k]), routing=routing))
    return DeploymentSpec(pairs=pairs)
