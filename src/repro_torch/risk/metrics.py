"""Risk statistics over per-scenario cost / violation vectors.

Pure numpy — importable without torch (the `engine="exact"` path and the
report serialization never touch the tensor tier).

CVaR follows Rockafellar-Uryasev: with VaR_a = the a-quantile of the
cost distribution,  CVaR_a = VaR_a + E[(cost - VaR_a)+] / (1 - a)  — the
expected cost conditional on landing in the worst (1-a) tail.  For an
empirical distribution this is exact (not the discrete-tail-mean
approximation, which is biased for small S·(1-a)).
"""
from __future__ import annotations

import numpy as np

#: default CVaR levels reported by `risk_evaluate`.
ALPHAS = (0.90, 0.95, 0.99)

#: violation quantiles reported (per-scenario viol count + unmet mass).
VIOLATION_QUANTILES = (0.99, 0.999)


def var_cvar(costs: np.ndarray, alpha: float) -> tuple[float, float]:
    """(VaR_alpha, CVaR_alpha) of an empirical cost sample."""
    costs = np.asarray(costs, float)
    var = float(np.quantile(costs, alpha))
    excess = np.maximum(costs - var, 0.0)
    cvar = var + float(excess.mean()) / (1.0 - alpha)
    return var, cvar


def tail_attribution(costs: np.ndarray, util: np.ndarray,
                     families: tuple[str, ...],
                     alpha: float = 0.95) -> dict[str, dict[str, float]]:
    """Which constraint family drives the cost tail.

    `util[s, f]` is scenario s's max utilization (lhs/rhs) over family
    f's inequality rows.  Returns, per family, the mean utilization over
    all scenarios vs over the worst (1-alpha) cost tail — a family whose
    tail utilization pulls clearly above its overall mean is the binding
    resource in the scenarios that make the deployment expensive.
    """
    costs = np.asarray(costs, float)
    var = np.quantile(costs, alpha)
    tail = costs >= var
    if not tail.any():                      # degenerate (constant costs)
        tail = np.ones_like(tail)
    return {
        fam: {
            "mean_util": float(util[:, f].mean()),
            "tail_util": float(util[tail, f].mean()),
        }
        for f, fam in enumerate(families)
    }


def risk_stats(costs: np.ndarray, viols: np.ndarray, unmet: np.ndarray,
               util: np.ndarray, families: tuple[str, ...],
               alphas: tuple[float, ...] = ALPHAS,
               tail_alpha: float = 0.95) -> dict:
    """The full statistics block of a `RiskReport` (costs are Stage-2)."""
    costs = np.asarray(costs, float)
    viols = np.asarray(viols, float)
    unmet = np.asarray(unmet, float)
    S = costs.size
    var = {}
    cvar = {}
    for a in alphas:
        v, cv = var_cvar(costs, a)
        key = f"{a:.2f}"
        var[key] = v
        cvar[key] = cv
    viol_q = {f"p{q * 100:g}": float(np.quantile(viols, q))
              for q in VIOLATION_QUANTILES}
    unmet_q = {f"p{q * 100:g}": float(np.quantile(unmet, q))
               for q in VIOLATION_QUANTILES}
    return {
        "S": int(S),
        "expected_cost": float(costs.mean()),
        "cost_std": float(costs.std()),
        "var": var,
        "cvar": cvar,
        "viol_total": float(viols.sum()),
        "viol_quantiles": viol_q,
        "unmet_quantiles": unmet_q,
        "tail_attribution": tail_attribution(costs, util, families,
                                             alpha=tail_alpha),
    }
