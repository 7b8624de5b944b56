"""Closed-loop serving simulator — validates the planner's analytical
delay model against engine-level dynamics (the paper's second future-work
item: "integration with a concrete serving engine for closed-loop
deployment", here as a discrete-event simulation of the planned fleet).

Each active (model, tier) pair becomes a continuous-batching station:

  * requests of type i arrive Poisson(lam_i * x_ijk), carrying h_i prompt
    tokens and f_i output tokens (lognormal length noise);
  * the station runs a token-level loop: every decode step advances each
    in-flight request by one token and costs
        step = d_comp/TP + PP * d_comm   (the paper's per-token model)
    amortized over the batch up to the station's concurrency bound
        B_max = min(compute, KV-memory) in-flight requests, derived from
        the plan's committed y/capacity by `stations.station_b_max`
        (an explicit ``max_batch=`` overrides it);
  * prefill is compute-bound: h_i * d_comp / TP, admitted when a slot
    frees (FCFS).

Outputs per type: achieved TTFT / end-to-end latency percentiles vs the
SLO Delta_i, and the ratio to the planner's analytical D — the calibration
error of the paper's planning-layer model under load.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.instance import Instance
from ..core.solution import Solution


@dataclasses.dataclass
class SimRequest:
    rid: int
    qtype: int
    t_arrive: float
    h: int
    f: int
    t_first: float = -1.0
    t_done: float = -1.0
    produced: int = 0


@dataclasses.dataclass
class SimStats:
    per_type_ttft_p50: np.ndarray
    per_type_e2e_p95: np.ndarray
    per_type_slo_attain: np.ndarray
    analytic_delay: np.ndarray
    n_served: int

    def model_error(self) -> np.ndarray:
        """simulated p95 e2e / planner analytical delay (nan if unserved)."""
        with np.errstate(invalid="ignore", divide="ignore"):
            return self.per_type_e2e_p95 / self.analytic_delay


def simulate(inst: Instance, sol: Solution, horizon_s: float = 600.0,
             rate_scale: float = 1.0, max_batch: int | None = None,
             seed: int = 0) -> SimStats:
    """Event-driven simulation of the deployment in `sol` serving Poisson
    traffic for `horizon_s` seconds (arrival rates scaled by rate_scale).

    ``max_batch=None`` (the default) derives each station's concurrency
    bound from the plan's committed capacity via
    `stations.station_b_max` — the compute/memory B_max this docstring
    always promised; a small-capacity station no longer over-admits to a
    blanket 32.  Passing an explicit int restores the historical fixed
    bound bit-identically (the regression test pins this)."""
    from .stations import station_b_max
    rng = np.random.default_rng(seed)
    I = inst.I

    # stations: one per active (j, k) with its (TP, PP) config
    stations = []
    for j in range(inst.J):
        for k in range(inst.K):
            if sol.q[j, k] < 0.5:
                continue
            cfg = sol.config_of(inst, j, k)
            if cfg is None:
                continue
            n, m = cfg
            b_max = (max_batch if max_batch is not None
                     else station_b_max(inst, sol, j, k))
            stations.append(dict(j=j, k=k, tp=n, pp=m, b_max=b_max,
                                 inflight=[], queue=[], t_free=0.0))
    if not stations:
        return SimStats(np.full(I, np.nan), np.full(I, np.nan),
                        np.zeros(I), np.zeros(I), 0)

    # per (type, station) routing weights from x
    route_w = np.zeros((I, len(stations)))
    for s_idx, st in enumerate(stations):
        for i in range(I):
            route_w[i, s_idx] = sol.x[i, st["j"], st["k"]]

    # Poisson arrivals over the horizon
    reqs: list[SimRequest] = []
    rid = 0
    for i in range(I):
        rate = inst.lam[i] / 3600.0 * rate_scale * float(route_w[i].sum())
        if rate <= 0:
            continue
        t = rng.exponential(1.0 / rate)
        while t < horizon_s:
            h = max(8, int(inst.h[i] * rng.lognormal(0, 0.25)))
            f = max(4, int(inst.f[i] * rng.lognormal(0, 0.25)))
            reqs.append(SimRequest(rid, i, t, h, f))
            rid += 1
            t += rng.exponential(1.0 / rate)
    reqs.sort(key=lambda r: r.t_arrive)

    # assign each request to a station by routing fractions
    assign: dict[int, list[SimRequest]] = {s: [] for s in range(len(stations))}
    for r in reqs:
        w = route_w[r.qtype]
        if w.sum() <= 0:
            continue
        s = int(rng.choice(len(stations), p=w / w.sum()))
        assign[s].append(r)

    # simulate each station independently (token-level continuous batching)
    for s_idx, st in enumerate(stations):
        j, k, tp, pp = st["j"], st["k"], st["tp"], st["pp"]
        pending = assign[s_idx]
        ptr = 0
        inflight: list[SimRequest] = []
        t = 0.0
        b_max = st["b_max"]
        while ptr < len(pending) or inflight:
            # admit arrivals (up to the station's concurrency bound)
            while (ptr < len(pending) and len(inflight) < b_max
                   and pending[ptr].t_arrive <= t):
                r = pending[ptr]
                ptr += 1
                # prefill cost (compute-bound, runs inline)
                d_comp = inst.d_comp[r.qtype, j, k]
                t_pre = r.h * d_comp / tp
                t = max(t, r.t_arrive) + t_pre
                r.t_first = t - r.t_arrive
                r.produced = 1
                inflight.append(r)
            if not inflight:
                if ptr < len(pending):
                    t = max(t, pending[ptr].t_arrive)
                    continue
                break
            # one decode step for the whole batch: the slowest member's
            # per-token time bounds the step (batch shares the weights
            # stream; per-token compute is amortized)
            step = max(inst.d_comp[r.qtype, j, k] / tp
                       + pp * inst.d_comm[r.qtype, j, k]
                       for r in inflight)
            t += step
            done = []
            for r in inflight:
                r.produced += 1
                if r.produced >= r.f:
                    r.t_done = t - r.t_arrive
                    done.append(r)
            inflight = [r for r in inflight if r.t_done < 0]
            del done

    ttft = np.full(I, np.nan)
    e2e = np.full(I, np.nan)
    attain = np.zeros(I)
    served = [r for r in reqs if r.t_done > 0]
    for i in range(I):
        mine = [r for r in served if r.qtype == i]
        if not mine:
            continue
        ttft[i] = float(np.median([r.t_first for r in mine]))
        e2e[i] = float(np.percentile([r.t_done for r in mine], 95))
        attain[i] = float(np.mean([r.t_done <= inst.Delta[i] for r in mine]))

    from ..core.solution import proc_delay
    return SimStats(per_type_ttft_p50=ttft, per_type_e2e_p95=e2e,
                    per_type_slo_attain=attain,
                    analytic_delay=proc_delay(inst, sol),
                    n_served=len(served))
