"""Builtin solver adapters: the paper's algorithms behind the registry.

Each adapter maps the typed `PlanOptions` onto the underlying entry
point's native signature and returns `(Solution, diagnostics)`.  The
underlying functions are called UNCHANGED — the facade is a wrapper, so
facade solutions are bitwise-identical to direct calls (pinned by
tests/test_planner_api.py on the equivalence suite).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.agh import agh
from repro_torch.core.baselines import dvr, hf, lpr
from repro_torch.core.gh import gh
from repro_torch.core.milp import solve_milp

from .registry import SolverSpec, register_solver


def _solve_gh(inst, options, warm_start):
    order = (np.asarray(options.order)
             if options.order is not None else None)
    sol = gh(inst, order=order, run_phase1=options.run_phase1,
             ablation=options.ablation)
    return sol, {"active_pairs": int(np.sum(sol.q > 0.5))}


def _solve_agh(inst, options, warm_start):
    stats: dict = {}
    # For AGH, `options.order` is a PRIORITY ordering: evaluated before the
    # standard multi-start list (PlanSession passes the ordering that
    # produced the incumbent).  GH instead treats it as THE ordering.
    priority = ([np.asarray(options.order)]
                if options.order is not None else None)
    engine = getattr(options, "engine", "numpy") or "numpy"
    extra = {}
    if engine in ("torch", "xla"):
        # Lazy tier load: torch is only imported when the batched tier is
        # actually requested (`from repro_torch import plan` stays
        # torch-free).  "xla" is the reference's name for the same tier.
        from repro_torch.core.tier import load_engine
        solver = load_engine().agh_torch
        extra["batch_width"] = options.batch_width
        extra["device"] = options.device or "cuda"
    elif engine == "numpy":
        solver = agh
    else:
        raise ValueError(f"unknown engine {engine!r}: "
                         "expected 'numpy', 'torch' or 'xla'")
    sol = solver(inst, R=options.restarts, L=options.passes, **extra,
                 seed=options.seed, patience=options.patience,
                 validate=options.validate,
                 local_search=options.local_search,
                 workers=options.workers, warm_start=warm_start,
                 priority_orders=priority, stats=stats)
    stats["active_pairs"] = int(np.sum(sol.q > 0.5))
    return sol, stats


def _solve_milp(inst, options, warm_start):
    # time_limit=None defers to the backend's own default (600 s) so the
    # facade matches a bare solve_milp(inst) call exactly.
    sol = solve_milp(inst,
                     time_limit=(600.0 if options.time_limit is None
                                 else options.time_limit),
                     mip_rel_gap=options.mip_rel_gap, relax=options.relax)
    return sol, {"status": sol.method,
                 "timed_out": sol.method.endswith("(timeout)")}


def _solve_lpr(inst, options, warm_start):
    # lpr's own default is 120 s — distinct from milp's 600 s.
    return lpr(inst, time_limit=(120.0 if options.time_limit is None
                                 else options.time_limit)), {}


def _solve_dvr(inst, options, warm_start):
    return dvr(inst), {}


def _solve_hf(inst, options, warm_start):
    return hf(inst), {}


for _spec in (
    SolverSpec("gh", _solve_gh,
               "Greedy Heuristic (paper Alg. 1), vectorized single pass"),
    SolverSpec("agh", _solve_agh,
               "Adaptive GH (paper Alg. 2): multi-start + incremental "
               "local search; warm-startable from an incumbent",
               supports_warm_start=True),
    SolverSpec("milp", _solve_milp,
               "Exact P_DM MILP via scipy/HiGHS (anytime under time_limit)",
               aliases=("dm",)),
    SolverSpec("lpr", _solve_lpr,
               "LP-relaxation rounding baseline (+ Stage-2 re-routing)"),
    SolverSpec("dvr", _solve_dvr,
               "Decoupled VM-selection-then-routing baseline"),
    SolverSpec("hf", _solve_hf,
               "Homogeneous-fleet provisioning baseline"),
):
    register_solver(_spec)
