"""Continuous-batching stations: build from a plan, derive the concurrency
bound the docstring always promised, and run an event-compressed
discrete-event loop per station.

`station_b_max` is the satellite bugfix: `simulator.simulate()` documented
a compute-bound concurrency ``B_max`` derived from the station's
utilization headroom but hard-coded ``max_batch=32`` for every station.
The bound here is Little's-law on the committed capacity:

* **compute**: the pair's token throughput cap is
  ``eta * P_k[TFLOP/s] * 1e3 * y / alpha[GFLOP/token]`` tokens/s; at the
  routed mix's mean per-token decode latency ``d_tok`` the sustainable
  concurrency is ``throughput * d_tok`` in-flight requests;
* **memory**: KV space left after weights, ``y*C_gpu - B_eff``, divided
  by the mean per-request KV footprint ``beta/KB_PER_GB * mean(r)``.

``B_max = max(1, floor(min(compute, memory)))`` — a small-capacity station
now admits what its committed GPUs can actually sustain instead of 32.

`StationSim` replaces the token-by-token loop with event-compressed
stepping: between admissions/completions the decode step time is constant,
so the loop jumps ``k = min(tokens to next completion, steps to next
admission opportunity, steps to the window end)`` tokens at once — O(#events)
per window, not O(#tokens) — which is what makes hours of fleet-scale
simulated traffic tractable in Python.
"""
from __future__ import annotations

import collections
import dataclasses
import math

import numpy as np

from ..core.instance import KB_PER_GB, Instance
from ..core.solution import Solution
from .types import Station


def station_b_max(inst: Instance, sol: Solution, j: int, k: int) -> int:
    """Concurrency bound of pair (j,k) from its committed `y` capacity."""
    cfg = sol.config_of(inst, j, k)
    if cfg is None or sol.y[j, k] <= 0:
        return 1
    tp, pp = cfg
    y = float(sol.y[j, k])
    w = np.asarray(sol.x[:, j, k], float)
    if w.sum() <= 0:
        w = np.ones(inst.I)                 # unrouted pair: unweighted mix
    w = w / w.sum()
    # Routed-mix means (per-token decode latency, per-request tokens).
    d_tok = float(w @ (inst.d_comp[:, j, k] / tp
                       + pp * inst.d_comm[:, j, k]))
    r_mean = float(w @ inst.r)
    alpha = float(w @ inst.alpha[:, j, k])  # GFLOP/token
    # Compute bound: tokens/s the committed GPUs sustain, times the time
    # each in-flight request holds a slot per token (Little's law).
    tok_per_s = inst.eta * float(inst.P_gpu[k]) * 1e3 * y / max(alpha, 1e-12)
    b_comp = tok_per_s * d_tok
    # Memory bound: KV space after weights over mean per-request KV bytes.
    free_gb = y * float(inst.C_gpu[k]) - float(inst.B_eff[j, k])
    kv_gb_per_req = float(inst.beta[j]) / KB_PER_GB * r_mean
    b_mem = free_gb / max(kv_gb_per_req, 1e-12)
    return max(1, int(math.floor(min(b_comp, b_mem))))


def build_stations(inst: Instance, sol: Solution) -> list[Station]:
    """Frozen `Station` records for every active pair of the plan."""
    out: list[Station] = []
    for j in range(inst.J):
        for k in range(inst.K):
            if sol.q[j, k] < 0.5:
                continue
            cfg = sol.config_of(inst, j, k)
            if cfg is None:
                continue
            tp, pp = cfg
            out.append(Station(
                j=j, k=k, model=str(inst.model_names[j]),
                tier=str(inst.tier_names[k]), tp=tp, pp=pp,
                gpus=float(sol.y[j, k]),
                b_max=station_b_max(inst, sol, j, k)))
    return out


@dataclasses.dataclass
class Req:
    """One in-simulation request (times relative to simulation start)."""
    qtype: int
    t_arrive: float
    h: int
    f: int
    t_first: float = -1.0
    t_done: float = -1.0
    produced: int = 0


class StationSim:
    """Event-compressed continuous-batching loop for one station.

    Token-interleaved stepping, coherent with the planner's load model:
    constraint (8g) charges prompt AND output tokens to the same per-token
    compute capacity, so the station advances every in-flight request by
    one token per batch step — prompt tokens first (chunked-prefill
    style), then output tokens — at the slowest member's per-token time
    ``d_comp/TP + PP*d_comm``.  TTFT is recorded when a request's prompt
    is consumed.  (The legacy `simulator.simulate()` instead runs prefill
    inline, blocking the whole batch per admission — a model under which
    no fleet-scale station is stable, which is why the closed-loop driver
    does not inherit it.)

    Between admissions, TTFT crossings, completions, and window ends the
    step time is constant, so the loop jumps whole blocks of steps at
    once: O(#events), not O(#tokens) — hours of fleet-scale traffic stay
    tractable in Python.
    """

    def __init__(self, inst: Instance, station: Station,
                 b_eff: int) -> None:
        self.station = station
        self.b_eff = max(1, int(b_eff))     # co-thinned concurrency bound
        j, k = station.j, station.k
        self.d_step = (inst.d_comp[:, j, k] / station.tp
                       + station.pp * inst.d_comm[:, j, k])   # s / token
        self.t = 0.0
        self.pending: collections.deque[Req] = collections.deque()
        self.inflight: list[Req] = []
        self.done: list[Req] = []           # drained by the driver
        self.peak_inflight = 0

    def push(self, reqs: list[Req]) -> None:
        """Enqueue arrivals (must be in nondecreasing t_arrive order)."""
        self.pending.extend(reqs)

    def _admit(self) -> None:
        while (self.pending and len(self.inflight) < self.b_eff
               and self.pending[0].t_arrive <= self.t):
            r = self.pending.popleft()
            r.produced = 0
            self.inflight.append(r)
            self.peak_inflight = max(self.peak_inflight, len(self.inflight))

    def advance(self, until: float) -> None:
        """Run the station loop until the clock reaches `until` (or all
        currently queued work is finished, whichever is later-bounded)."""
        while True:
            self._admit()
            if not self.inflight:
                if self.pending and self.pending[0].t_arrive < until:
                    self.t = max(self.t, self.pending[0].t_arrive)
                    continue
                # Idle: park the clock at the window end.
                self.t = max(self.t, until)
                return
            if self.t >= until:
                return
            step = max(float(self.d_step[r.qtype]) for r in self.inflight)
            # Jump whole steps to the next event: a completion, a TTFT
            # crossing (prompt consumed), an admission opportunity (an
            # arrival while a slot is free), or the window end.
            k = min(r.h + r.f - r.produced for r in self.inflight)
            k_ttft = min((r.h - r.produced for r in self.inflight
                          if r.produced < r.h), default=k)
            k = min(k, k_ttft)
            if (self.pending and len(self.inflight) < self.b_eff
                    and self.pending[0].t_arrive > self.t):
                k_arr = math.ceil((self.pending[0].t_arrive - self.t) / step)
                k = min(k, max(1, k_arr))
            k_end = math.ceil((until - self.t) / step)
            k = max(1, min(k, max(1, k_end)))
            self.t += k * step
            still: list[Req] = []
            for r in self.inflight:
                r.produced += k
                if r.t_first < 0 and r.produced >= r.h:
                    # k never overshoots a crossing (k <= k_ttft), so the
                    # prompt finishes exactly at the current clock.
                    r.t_first = self.t - r.t_arrive
                if r.produced >= r.h + r.f:
                    r.t_done = self.t - r.t_arrive
                    self.done.append(r)
                else:
                    still.append(r)
            self.inflight = still

    def drain(self) -> None:
        """Finish all queued and in-flight work (end-of-horizon flush)."""
        while self.pending or self.inflight:
            self.advance(self.t + 3600.0)

    def take_done(self) -> list[Req]:
        out, self.done = self.done, []
        return out
