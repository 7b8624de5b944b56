"""Load-dependent queueing extension of the planning-layer delay model —
the paper's first named future-work item ("a load-dependent queueing term
that extends the planning-layer delay model toward engine-level dynamics").

Model: each active pair (j,k) is an M/G/1-PS station. Tokens routed to the
pair occupy its compute at utilization

    rho_jk = sum_i alpha_ijk * r_i * lam_i * x_ijk / (eta * T_conv * P_k * y_jk)

(the LHS/RHS of the paper's compute constraint (8g)), and the processing
delay inflates by the processor-sharing factor 1/(1 - rho):

    D_queue(i) = sum_jk x_ijk * D_ijk(n,m) / (1 - rho_jk)

This keeps the planner linear-solvable by the same heuristics: GH/AGH gain
a `rho_max` knob (utilization-capped commits) that upper-bounds the
inflation factor at construction time — provisioning headroom becomes an
explicit, tunable quantity instead of a side effect of config granularity.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .instance import Instance
from .solution import Solution, proc_delay


def utilization(inst: Instance, sol: Solution) -> np.ndarray:
    """rho[j,k] per active pair (0 for inactive)."""
    load = np.einsum("ijk,ijk->jk",
                     inst.alpha * (inst.r * inst.lam)[:, None, None] / 1e3,
                     sol.x)
    cap = inst.eta * 3600.0 * inst.P_gpu[None, :] * np.maximum(sol.y, 1e-9)
    rho = np.where(sol.y > 0, load / cap, 0.0)
    return np.clip(rho, 0.0, 0.999)


def queueing_delay(inst: Instance, sol: Solution) -> np.ndarray:
    """D_i^proc with the M/G/1-PS load factor applied per pair."""
    rho = utilization(inst, sol)
    infl = 1.0 / (1.0 - rho)                       # [J,K]
    xw = sol.x[:, :, :, None] * sol.w[None, :, :, :]
    D = np.einsum("ijkc,ijkc,jk->i", xw, inst.D_cfg, infl)
    return D


def queueing_violations(inst: Instance, sol: Solution) -> np.ndarray:
    """Per-type boolean: does the queueing-adjusted delay break the SLO
    that the load-free planning model claimed to satisfy?"""
    return queueing_delay(inst, sol) > inst.Delta + 1e-9


def with_queueing_margin(inst: Instance, rho_max: float) -> Instance:
    """Planner-side counterpart: plan against queueing-aware coefficients.

    Two coupled changes such that the TRUE queueing-adjusted delay of any
    emitted plan satisfies the original SLO:
      1. cap utilization at rho_max (deflate per-pair capacity: eta *=
         rho_max), so the PS inflation is bounded by 1/(1 - rho_max);
      2. pre-inflate the per-token delay coefficients by that worst-case
         factor (tau *= 1/(1 - rho_max)), so M1/M2/M3 pick configurations
         whose LOADED delay still meets Delta_i.
    Then D_true = D/(1-rho) <= D * 1/(1-rho_max) = D_planned <= Delta.
    Headroom becomes an explicit knob instead of a config-granularity
    accident."""
    infl = 1.0 / (1.0 - rho_max)
    inst2 = dataclasses.replace(inst, eta=inst.eta * rho_max,
                                tau=inst.tau * infl)
    inst2.__post_init__()
    return inst2


def slo_attainment_with_queueing(inst: Instance, sol: Solution) -> dict:
    """Summary: load-free vs queueing-adjusted delays and margins."""
    d0 = proc_delay(inst, sol)
    dq = queueing_delay(inst, sol)
    rho = utilization(inst, sol)
    return dict(
        proc_delay=d0, queue_delay=dq,
        max_rho=float(rho.max()),
        violations_load_free=int(np.sum(d0 > inst.Delta + 1e-9)),
        violations_queueing=int(np.sum(dq > inst.Delta + 1e-9)),
        margin_min=float(np.min((inst.Delta - dq) / inst.Delta)))
