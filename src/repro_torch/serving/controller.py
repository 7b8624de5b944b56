"""Forecast-aware replanning controller for the closed-loop driver.

Composes the shared `core.forecast` primitives — the same EWMA recursion
and drift measure the offline rolling replay uses — into the streaming
decision the driver asks once per window: *should the planner run now?*

* ``forecast`` mode is the tentpole: `EwmaForecaster` tracks observed
  full-scale arrival rates; `DriftTrigger` fires on forecast drift
  against the incumbent plan's demand basis or on a sustained
  SLO-violation-budget breach.  Replans happen when the workload has
  actually moved, not on a clock.
* ``fixed`` mode reproduces the blind `replan_every` cadence
  (`core.rolling`'s `replan_every` behaviour) as the comparison baseline.
* ``static`` mode never replans — the frozen-plan floor.

The controller only *decides*; the driver owns the `PlanSession` and
performs the warm `replan()` / `repair()`, then reports adoption back via
`adopted()` so the trigger's cooldown and the drift basis re-arm.
"""
from __future__ import annotations

import numpy as np

from ..core.forecast import DriftTrigger, EwmaForecaster, relative_drift
from .types import ControllerSpec


class ReplanController:
    """Per-window replan decision: `observe()` -> cause or None."""

    def __init__(self, spec: ControllerSpec, lam_basis: np.ndarray) -> None:
        self.spec = spec
        self.lam_basis = np.asarray(lam_basis, float).copy()
        self.forecaster = EwmaForecaster(alpha=spec.ewma_alpha,
                                         forecast=self.lam_basis)
        self.trigger = DriftTrigger(
            drift_threshold=spec.drift_threshold,
            violation_budget=spec.violation_budget,
            budget_windows=spec.budget_windows,
            cooldown=spec.cooldown, warmup=spec.warmup)

    @property
    def forecast(self) -> np.ndarray:
        return self.forecaster.forecast

    def observe(self, window: int, lam_obs: np.ndarray,
                viol_frac: float) -> tuple[str | None, float]:
        """Ingest one window's observed full-scale arrival rates and SLO
        violation fraction; returns ``(cause, drift)`` where cause is
        ``"drift"`` / ``"slo"`` / ``"scheduled"`` / None."""
        fc = self.forecaster.update(lam_obs)
        drift = relative_drift(fc, self.lam_basis)
        if self.spec.mode == "static":
            return None, drift
        if self.spec.mode == "fixed":
            fire = window > 0 and window % self.spec.replan_every == 0
            return ("scheduled" if fire else None), drift
        return self.trigger.observe(window, drift, viol_frac), drift

    def adopted(self, window: int, lam_basis: np.ndarray) -> None:
        """A replan was adopted: reset the drift basis to the rates the
        new plan was built for and re-arm the trigger cooldown."""
        self.lam_basis = np.asarray(lam_basis, float).copy()
        self.trigger.fired(window)
