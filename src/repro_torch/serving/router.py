"""Plan-aware request router — Mélange's load balancer over the plan.

Mélange ships a tiny weighted-random load balancer over per-GPU profiled
throughputs; here the weights come straight from the plan: a type-i
request is dispatched to station s = (j, k) with probability
``x[i,j,k]`` and shed with the residual probability ``1 - sum_jk x`` (the
plan's unserved fraction ``u_i``) — so the simulated traffic split
converges to the routing LP's split as requests -> infinity, which the
router-conservation test pins.

Weighted-random (rather than deterministic round-robin over fractions)
is what the plan's analytical model assumes: Poisson splitting of a
Poisson arrival stream keeps each station's arrival process Poisson at
rate ``lam_i * x_ijk``.
"""
from __future__ import annotations

import numpy as np

from ..core.instance import Instance
from ..core.solution import Solution
from .types import Station

SHED = -1                        # route() sentinel: request not served


class Router:
    """Weighted-random dispatcher over the plan's routing fractions."""

    def __init__(self, inst: Instance, sol: Solution,
                 stations: list[Station]) -> None:
        I = inst.I
        S = len(stations)
        w = np.zeros((I, S))
        for s, st in enumerate(stations):
            w[:, s] = sol.x[:, st.j, st.k]
        # Cumulative weights against a unit draw: a uniform in [0, 1)
        # falling past cum[i, -1] (= sum_s x_ijk <= 1) is shed — exactly
        # the plan's unserved fraction u_i.
        self.weights = w
        self.cum = np.cumsum(w, axis=1)
        self.n_stations = S
        self.dispatched = np.zeros((I, S), dtype=np.int64)
        self.shed = np.zeros(I, dtype=np.int64)

    def route(self, qtype: int, u: float) -> int:
        """Station index for one type-`qtype` request given a uniform
        draw `u` in [0, 1); `SHED` when the draw lands in the unserved
        residual.  The caller owns the RNG so the arrival/length/routing
        streams stay reproducible in one place."""
        cum = self.cum[qtype]
        if self.n_stations == 0 or u >= cum[-1]:
            self.shed[qtype] += 1
            return SHED
        s = int(np.searchsorted(cum, u, side="right"))
        self.dispatched[qtype, s] += 1
        return s

    def dispatch_fractions(self) -> np.ndarray:
        """Observed per-(type, station) dispatch fractions (of arrivals,
        i.e. including shed mass) — converges to `weights` by the law of
        large numbers; the conservation test pins the tolerance."""
        total = self.dispatched.sum(axis=1) + self.shed
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(total[:, None] > 0,
                            self.dispatched / np.maximum(total[:, None], 1),
                            0.0)
