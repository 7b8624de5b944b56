"""Synthetic Azure-style diurnal trace (paper §5.3).

The public Azure LLM Inference Trace is not downloadable in this offline
container; this module synthesizes a per-window demand-multiplier series
matching the statistics the paper reports for its replay:

  * 288 five-minute windows over a 24 h horizon;
  * ~10x peak-to-trough ratio on the "busy" day (2024-05-14 analogue) with
    an early-morning trough (~28 k/h) and an evening peak (~300 k/h);
  * ~15.6x ratio on the more volatile second day (2024-05-15 analogue);
  * heavy-tailed short-horizon noise on top of the diurnal envelope.

The multiplier is relative to the day average; the replay scales each query
type's nominal arrival rate by it, exactly as the paper does.
"""
from __future__ import annotations

import numpy as np

WINDOWS_PER_DAY = 288


def diurnal_multipliers(day: str = "busy", seed: int = 7,
                        n_windows: int = WINDOWS_PER_DAY) -> np.ndarray:
    """Per-window demand multiplier (mean ≈ 1) for a synthetic trace day."""
    rng = np.random.default_rng(seed + {"busy": 0, "volatile": 1}[day])
    t = np.arange(n_windows) / n_windows            # 0..1 day fraction
    # Trough around 04:30, evening peak around 20:00 — two-harmonic shape.
    phase = 2 * np.pi * (t - 20.0 / 24.0)
    base = 1.0 + 0.72 * np.cos(phase) + 0.18 * np.cos(2 * phase + 0.9)
    base = np.clip(base, 0.05, None)
    if day == "volatile":
        base = base ** 1.35                          # deepen trough/peak
    # Heavy-tailed multiplicative noise (lognormal).
    noise = np.exp(rng.normal(0.0, 0.06 if day == "busy" else 0.10, n_windows))
    series = base * noise
    series = series / series.mean()
    return series


def multi_day_multipliers(days=("busy", "volatile"), seed: int = 7,
                          n_windows: int = WINDOWS_PER_DAY) -> np.ndarray:
    """Concatenated multi-day replay series: one diurnal multiplier block
    per entry of `days` ("busy"/"volatile"), each with its own noise draw
    (seed offset per position so repeated day types differ).  `n_windows`
    is windows PER DAY; the result has len(days)*n_windows windows."""
    return np.concatenate([
        diurnal_multipliers(day, seed=seed + 11 * idx, n_windows=n_windows)
        for idx, day in enumerate(days)])


def peak_to_trough(series: np.ndarray) -> float:
    return float(series.max() / series.min())


def random_walk_lambdas(lam0: np.ndarray, sigma: float, n_windows: int,
                        rng: np.random.Generator) -> np.ndarray:
    """Geometric random walk demand path (paper Table 4):
    lam^{t+1} = lam^t * exp(N(0, sigma)), per query type."""
    I = len(lam0)
    out = np.empty((n_windows, I))
    lam = lam0.astype(float).copy()
    for tstep in range(n_windows):
        out[tstep] = lam
        lam = lam * np.exp(rng.normal(0.0, sigma, I))
    return out
