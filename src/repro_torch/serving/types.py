"""Typed public surface of the serving layer (`repro_torch.serving`).

Mirrors the planner facade's conventions (`planner/api.py`): frozen spec
dataclasses whose field names are checked at the call site, one structured
result object with an exact JSON round trip, and `summary()` producing the
flat registry rows the benchmark dumps and the CI regression gate consume.

* `TrafficSpec`    — what traffic to synthesize (horizon, windows, Poisson
  thinning, diurnal trace day, length noise);
* `ControllerSpec` — how the replanning controller behaves (forecast /
  fixed-cadence / static, EWMA + trigger knobs);
* `Station`        — one deployed (model, tier) continuous-batching
  station as the plan committed it, with its derived concurrency bound;
* `ReplanEvent`    — one controller firing (cause, drift, wall time);
* `ServeResult`    — per-type latency/attainment metrics, per-window rows,
  the replan log, planner-time accounting, and the simulated-vs-analytical
  calibration ratios.

Everything here is numpy/stdlib only — importing it never touches torch.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

CONTROLLER_MODES = ("forecast", "fixed", "static")


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """Synthetic traffic program for `serve()`.

    | field               | meaning                                       |
    |---------------------|-----------------------------------------------|
    | ``horizon_s``       | simulated wall-clock seconds                  |
    | ``window_s``        | observation/control window length (s)         |
    | ``rate_scale``      | Poisson thinning of the fleet-scale arrival   |
    |                     | rates (1.0 = the instance's full `lam`)       |
    | ``concurrency_scale``| matching thinning of each station's derived  |
    |                     | concurrency bound so utilization — hence      |
    |                     | queueing behaviour — is invariant under       |
    |                     | thinning; ``None`` = follow ``rate_scale``    |
    | ``trace``           | diurnal multiplier day ("busy"/"volatile")    |
    |                     | applied per window; ``None`` = stationary     |
    | ``trace_seed``      | noise seed of the synthetic trace             |
    | ``len_sigma``       | lognormal sigma of token-length noise         |
    | ``seed``            | RNG seed for arrivals/lengths/routing         |

    Thinning note: a thinned system at equal utilization queues slightly
    MORE than the fleet-scale one (fewer servers at the same load), so
    thinned attainment is a conservative estimate of fleet attainment.
    """
    horizon_s: float = 3600.0
    window_s: float = 300.0
    rate_scale: float = 1.0
    concurrency_scale: float | None = None
    trace: str | None = None
    trace_seed: int = 7
    len_sigma: float = 0.25
    seed: int = 0

    def effective_concurrency_scale(self) -> float:
        return (self.rate_scale if self.concurrency_scale is None
                else self.concurrency_scale)

    def n_windows(self) -> int:
        return max(1, int(np.ceil(self.horizon_s / self.window_s)))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "TrafficSpec":
        return TrafficSpec(**d)


@dataclasses.dataclass(frozen=True)
class ControllerSpec:
    """Replanning-controller program for `serve()`.

    ``mode``:

    * ``"forecast"`` — the tentpole controller: EWMA arrival-rate forecast
      (`core.forecast.EwmaForecaster`) + `DriftTrigger`; replans only when
      forecast drift against the incumbent plan's demand basis crosses
      ``drift_threshold`` or the observed per-window SLO-violation
      fraction exceeds ``violation_budget`` for ``budget_windows``
      consecutive windows;
    * ``"fixed"``    — the blind baseline: replan every ``replan_every``
      windows regardless of drift (`core.rolling`'s cadence, kept for
      comparison);
    * ``"static"``   — never replan (the frozen-plan floor).

    ``ewma_alpha`` matches `core.rolling.rolling(forecast_ewma=)`; the
    trigger knobs map 1:1 onto `core.forecast.DriftTrigger`.

    ``rho_max`` (when set) makes every replan plan against
    `core.queueing.with_queueing_margin(inst, rho_max)` — the same
    utilization-headroom view the operator presumably used for the
    initial plan — so a mid-run replan does not silently shed the
    queueing margin the deployed plan was carrying.
    """
    mode: str = "forecast"
    ewma_alpha: float = 0.35
    drift_threshold: float = 0.25
    violation_budget: float = 0.05
    budget_windows: int = 2
    cooldown: int = 4
    warmup: int = 2
    replan_every: int = 12
    rho_max: float | None = None

    def __post_init__(self) -> None:
        if self.mode not in CONTROLLER_MODES:
            raise ValueError(f"mode must be one of {CONTROLLER_MODES}, "
                             f"got {self.mode!r}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "ControllerSpec":
        return ControllerSpec(**d)


@dataclasses.dataclass(frozen=True)
class Station:
    """One active (model, tier) pair as the plan deployed it."""
    j: int
    k: int
    model: str
    tier: str
    tp: int
    pp: int
    gpus: float
    b_max: int          # derived concurrency bound at full (unthinned) scale

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "Station":
        return Station(**d)


@dataclasses.dataclass(frozen=True)
class ReplanEvent:
    """One controller firing and what the planner did about it."""
    window: int
    t_s: float
    cause: str          # "drift" | "slo" | "scheduled" | "fault"
    drift: float
    viol_frac: float
    wall_s: float
    objective: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "ReplanEvent":
        return ReplanEvent(**d)


@dataclasses.dataclass
class ServeResult:
    """Closed-loop outcome of `serve()` — the serving counterpart of
    `PlanResult`.

    ``windows`` rows are flat JSON-safe dicts (one per control window):
    ``t0_s, arrivals, served, shed, attain, ttft_p50, e2e_p95, e2e_p99,
    viol_frac, drift, stations``.  ``calibration`` is the per-type ratio
    of simulated p95 e2e to the time-averaged analytical delay of the
    plans in effect — the closed-loop model-calibration error the paper
    leaves as future work.
    """
    stations: list[Station]
    per_type_ttft_p50: np.ndarray       # [I] seconds (nan if unserved)
    per_type_e2e_p95: np.ndarray        # [I]
    per_type_e2e_p99: np.ndarray        # [I]
    per_type_slo_attain: np.ndarray     # [I] fraction within Delta_i
    analytic_delay: np.ndarray          # [I] time-averaged planner D_i
    n_arrived: int
    n_served: int
    n_shed: int
    windows: list[dict]
    replans: list[ReplanEvent]
    planner_wall_s: float
    horizon_s: float
    traffic: dict
    controller: dict
    # Time-weighted fleet rental rate ($/h) over the horizon — the
    # autoscaling observable: trough replans shrink the fleet, so a
    # forecast-aware controller runs cheaper than a frozen plan.
    mean_rental_per_h: float = 0.0

    # ------------------------------------------------------------------
    def attainment(self) -> float:
        """Served-weighted overall SLO attainment in [0, 1]."""
        if not self.windows:
            return 0.0
        served = sum(w["served"] for w in self.windows)
        if served == 0:
            return 0.0
        hit = sum(w["served"] * w["attain"] for w in self.windows)
        return float(hit / served)

    def planner_frac(self) -> float:
        """Planner wall time as a fraction of the simulated horizon."""
        return float(self.planner_wall_s / max(self.horizon_s, 1e-12))

    def calibration(self) -> np.ndarray:
        """Simulated p95 e2e / analytical delay per type (nan unserved)."""
        with np.errstate(invalid="ignore", divide="ignore"):
            return self.per_type_e2e_p95 / self.analytic_delay

    def summary(self) -> dict:
        """Flat registry-row summary (no arrays) for benchmark dumps."""
        cal = self.calibration()
        cal_med = (float(np.nanmedian(cal))
                   if np.any(np.isfinite(cal)) else None)
        return {
            "attain": round(self.attainment(), 6),
            "served": self.n_served, "shed": self.n_shed,
            "replans": len(self.replans),
            "planner_wall_s": round(self.planner_wall_s, 4),
            "planner_frac": round(self.planner_frac(), 6),
            "mean_rental_per_h": round(self.mean_rental_per_h, 4),
            "calibration_median": (round(cal_med, 4)
                                   if cal_med is not None else None),
        }

    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        def arr(a: np.ndarray) -> list:
            return [None if not np.isfinite(v) else float(v) for v in a]
        return {
            "stations": [s.to_dict() for s in self.stations],
            "per_type_ttft_p50": arr(self.per_type_ttft_p50),
            "per_type_e2e_p95": arr(self.per_type_e2e_p95),
            "per_type_e2e_p99": arr(self.per_type_e2e_p99),
            "per_type_slo_attain": arr(self.per_type_slo_attain),
            "analytic_delay": arr(self.analytic_delay),
            "n_arrived": self.n_arrived, "n_served": self.n_served,
            "n_shed": self.n_shed, "windows": self.windows,
            "replans": [r.to_dict() for r in self.replans],
            "planner_wall_s": self.planner_wall_s,
            "horizon_s": self.horizon_s,
            "mean_rental_per_h": self.mean_rental_per_h,
            "traffic": self.traffic, "controller": self.controller,
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @staticmethod
    def from_dict(d: dict) -> "ServeResult":
        def arr(xs: list) -> np.ndarray:
            return np.array([np.nan if v is None else float(v) for v in xs])
        return ServeResult(
            stations=[Station.from_dict(s) for s in d["stations"]],
            per_type_ttft_p50=arr(d["per_type_ttft_p50"]),
            per_type_e2e_p95=arr(d["per_type_e2e_p95"]),
            per_type_e2e_p99=arr(d["per_type_e2e_p99"]),
            per_type_slo_attain=arr(d["per_type_slo_attain"]),
            analytic_delay=arr(d["analytic_delay"]),
            n_arrived=int(d["n_arrived"]), n_served=int(d["n_served"]),
            n_shed=int(d["n_shed"]), windows=list(d["windows"]),
            replans=[ReplanEvent.from_dict(r) for r in d["replans"]],
            planner_wall_s=float(d["planner_wall_s"]),
            horizon_s=float(d["horizon_s"]),
            mean_rental_per_h=float(d.get("mean_rental_per_h", 0.0)),
            traffic=dict(d["traffic"]), controller=dict(d["controller"]))

    @staticmethod
    def from_json(s: str) -> "ServeResult":
        return ServeResult.from_dict(json.loads(s))
