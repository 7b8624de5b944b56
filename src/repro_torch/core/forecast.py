"""Shared demand-forecast and replan-trigger primitives.

One implementation of the EWMA forecast (paper §5.3's rolling-horizon
predictor) and of the drift measure that decides when a forecast has
moved far enough to justify a replan — consumed by BOTH the offline
rolling-horizon replay (`core.rolling`) and the closed-loop serving
controller (`repro_torch.serving.controller`), so the two layers can never
disagree about what "the forecast" or "drift" means.

* `ewma_forecasts` — the whole-path batch form used by `rolling()`
  (forecasts precomputed before the replay loop runs);
* `EwmaForecaster` — the streaming form used by the serving driver
  (one `update()` per observed window, same recursion, same seeding);
* `relative_drift` — demand-weighted relative L1 distance between two
  arrival-rate vectors.  Demand-weighted so a fleet-scale population's
  tiny types cannot trigger replans on their own noise, while a drift of
  the dominant types registers at its true magnitude;
* `DriftTrigger` — the replan trigger state machine: fires when forecast
  drift since the last replan crosses a threshold OR an observed
  SLO-violation budget is breached for enough consecutive windows,
  subject to a warmup and a cooldown.  It replaces the blind
  `replan_every` cadence.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def ewma_forecasts(lam_path: np.ndarray, alpha: float) -> np.ndarray:
    """Stacked EWMA forecasts: fc[t] = a·lam[t] + (1-a)·fc[t-1], seeded at
    lam[0] — fc[t] is the forecast available AFTER observing window t."""
    fc = np.empty_like(lam_path)
    prev = lam_path[0].copy()
    for t in range(lam_path.shape[0]):
        prev = alpha * lam_path[t] + (1.0 - alpha) * prev
        fc[t] = prev
    return fc


def relative_drift(lam: np.ndarray, lam_ref: np.ndarray,
                   floor: float = 1e-12) -> float:
    """Demand-weighted relative L1 drift of `lam` against `lam_ref`:
    sum|lam - ref| / max(sum ref, floor).  0 = identical; 0.25 = the
    aggregate arrival rate has moved by 25% of the reference volume."""
    lam = np.asarray(lam, float)
    lam_ref = np.asarray(lam_ref, float)
    return float(np.sum(np.abs(lam - lam_ref))
                 / max(float(np.sum(lam_ref)), floor))


@dataclasses.dataclass
class EwmaForecaster:
    """Streaming EWMA over per-window observed arrival rates.

    Seeded at the plan-basis rates so the forecast starts exactly where
    the deployed plan assumed demand to be — the first observed windows
    then pull it toward reality at rate `alpha`, matching the recursion
    of `ewma_forecasts` element for element.
    """
    alpha: float
    forecast: np.ndarray

    def __post_init__(self) -> None:
        self.forecast = np.asarray(self.forecast, float).copy()

    def update(self, lam_obs: np.ndarray) -> np.ndarray:
        self.forecast = (self.alpha * np.asarray(lam_obs, float)
                         + (1.0 - self.alpha) * self.forecast)
        return self.forecast


@dataclasses.dataclass
class DriftTrigger:
    """Forecast-aware replan trigger.

    `observe(window, drift, viol_frac)` returns the trigger cause
    (``"drift"`` / ``"slo"``) when a replan is justified, else None:

    * **drift** — the forecast has moved more than `drift_threshold`
      (relative_drift units) away from the rates the incumbent plan was
      built for;
    * **slo**  — the observed per-window SLO-violation fraction exceeded
      `violation_budget` for `budget_windows` consecutive windows (one
      bad window is noise; a streak is a capacity problem).

    `warmup` windows are trigger-free (the forecast needs observations
    before drift is meaningful); after every adopted replan the caller
    invokes `fired(window)`, which re-arms the `cooldown` — no two
    replans closer than `cooldown` windows, so a breach that a replan
    cannot fix (e.g. a calibration gap) cannot ring the planner
    continuously.
    """
    drift_threshold: float = 0.25
    violation_budget: float = 0.05
    budget_windows: int = 2
    cooldown: int = 4
    warmup: int = 2
    _breach_streak: int = 0
    _last_fire: int = -(1 << 30)

    def observe(self, window: int, drift: float,
                viol_frac: float) -> str | None:
        if viol_frac > self.violation_budget:
            self._breach_streak += 1
        else:
            self._breach_streak = 0
        if window < self.warmup or window - self._last_fire < self.cooldown:
            return None
        if drift > self.drift_threshold:
            return "drift"
        if self._breach_streak >= self.budget_windows:
            return "slo"
        return None

    def fired(self, window: int) -> None:
        self._last_fire = window
        self._breach_streak = 0
