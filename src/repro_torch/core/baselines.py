"""State-of-the-art-derived heuristic baselines (paper §2, §5.1).

LPR — LP relaxation of `P_DM` with LP-warmstart greedy rounding: solve the
      relaxation, round configuration selectors by descending fractional
      value, fix the deployment, then re-solve routing as a Stage-2 LP.
DVR — decoupled VM-selection-then-routing (after Kim et al., EuroSys'25):
      per query type, pick the cheapest (model, tier) meeting its error SLO
      in isolation and provision it for the expected load; route afterwards.
      No coupled feasibility enforcement at selection time.
HF  — homogeneous-fleet provisioning (after DynamoLLM, HPCA'25): pick one
      tier for the whole fleet (best perf/$ subject to fitting the largest
      required model), deploy on that tier only, then route.

These deliberately reproduce the failure modes the paper targets: selection
ignores memory/delay/budget coupling, which the Stage-2 LP then exposes.
"""
from __future__ import annotations

import time

import numpy as np

from .instance import Instance
from .mechanisms import State, commit, m1_select, max_commit
from .milp import lp_relaxation_values
from .solution import Solution
from .stage2 import stage2_lp


def _route_with_stage2(inst: Instance, deploy: Solution) -> Solution:
    routed, _ = stage2_lp(inst, deploy, u_cap=np.ones(inst.I),
                          allow_any_deployed=True)
    routed.z = np.where(routed.x > 1e-9, 1.0, 0.0)
    return routed


# ---------------------------------------------------------------------------
# LPR
# ---------------------------------------------------------------------------

def lpr(inst: Instance, time_limit: float = 120.0) -> Solution:
    t0 = time.perf_counter()
    vec, ix = lp_relaxation_values(inst, time_limit=time_limit)
    sol = Solution.empty(inst)
    if vec is not None:
        # Round configuration selectors by descending fractional mass,
        # activating a pair's best fractional config if its q is >= 0.5 of
        # the largest fractional deployment signal.
        qfrac = np.array([[vec[ix.q(j, k)] for k in range(inst.K)]
                          for j in range(inst.J)])
        thresh = max(0.25, 0.5 * float(qfrac.max(initial=0.0)))
        for j in range(inst.J):
            for k in range(inst.K):
                if qfrac[j, k] >= thresh:
                    wf = np.array([vec[ix.w(j, k, c)] for c in range(inst.n_cfg)])
                    c = int(np.argmax(wf))
                    sol.q[j, k] = 1.0
                    sol.w[j, k, c] = 1.0
                    sol.y[j, k] = float(inst.nm[c])
        if sol.q.sum() == 0 and qfrac.max(initial=0.0) > 0:
            j, k = np.unravel_index(np.argmax(qfrac), qfrac.shape)
            wf = np.array([vec[ix.w(j, k, c)] for c in range(inst.n_cfg)])
            c = int(np.argmax(wf))
            sol.q[j, k] = 1.0
            sol.w[j, k, c] = 1.0
            sol.y[j, k] = float(inst.nm[c])
    sol = _route_with_stage2(inst, sol)
    sol.runtime_s = time.perf_counter() - t0
    sol.method = "LPR"
    return sol


# ---------------------------------------------------------------------------
# DVR
# ---------------------------------------------------------------------------

def dvr(inst: Instance) -> Solution:
    t0 = time.perf_counter()
    deploy = Solution.empty(inst)
    for i in range(inst.I):
        # Cheapest (j,k) whose error meets the SLO in isolation —
        # decoupled: no memory/delay/budget coupling at selection time.
        best, best_price = None, np.inf
        for j in range(inst.J):
            for k in range(inst.K):
                if inst.e_bar[i, j, k] > inst.eps[i]:
                    continue
                if inst.p_c[k] < best_price:
                    best, best_price = (j, k), inst.p_c[k]
        if best is None:
            continue
        j, k = best
        # Provision for expected load with the smallest config that fits
        # memory (delay ignored — the decoupling the paper criticizes).
        fit = [c for c in range(inst.n_cfg)
               if inst.B_eff[j, k] / inst.nm[c] <= inst.C_gpu[k]]
        if not fit:
            continue
        c = fit[int(np.argmin(inst.nm[fit]))]
        deploy.q[j, k] = 1.0
        deploy.w[j, k, :] = 0.0
        deploy.w[j, k, c] = 1.0
        deploy.y[j, k] = float(inst.nm[c])
        deploy.z[i, j, k] = 1.0
    sol = _route_with_stage2(inst, deploy)
    sol.runtime_s = time.perf_counter() - t0
    sol.method = "DVR"
    return sol


# ---------------------------------------------------------------------------
# HF
# ---------------------------------------------------------------------------

def hf(inst: Instance) -> Solution:
    t0 = time.perf_counter()
    # One tier for the whole fleet: best TFLOP-per-dollar among tiers that
    # can hold the largest model needed at max parallelism.
    need_B = inst.B_eff.min(axis=0)  # cheapest-model proxy per tier
    score = inst.P_gpu / inst.p_c
    order = np.argsort(-score)
    k_star = None
    for k in order:
        if need_B[k] / float(np.max(inst.nm)) <= inst.C_gpu[k]:
            k_star = int(k)
            break
    deploy = Solution.empty(inst)
    if k_star is not None:
        st = State.fresh(inst)
        for i in np.argsort(-inst.lam):
            i = int(i)
            # Smallest model on k_star meeting the error SLO.
            for j in np.argsort(inst.B):
                j = int(j)
                if inst.e_bar[i, j, k_star] > inst.eps[i]:
                    continue
                c = m1_select(inst, i, j, k_star)
                if c is None:
                    continue
                if st.q[j, k_star] > 0.5:
                    c = int(st.cfg[j, k_star])
                    if inst.D_cfg[i, j, k_star, c] > inst.Delta[i]:
                        continue
                frac = min(st.r_rem[i], max_commit(st, i, j, k_star, c))
                if frac <= 1e-9:
                    continue
                commit(st, i, j, k_star, c, frac)
                if st.r_rem[i] <= 1e-9:
                    break
        deploy.x, deploy.y, deploy.q, deploy.z = st.x, st.y, st.q, st.z
        deploy.u = np.clip(st.r_rem, 0.0, None)
        for j in range(inst.J):
            if st.q[j, k_star] > 0.5 and st.cfg[j, k_star] >= 0:
                deploy.w[j, k_star, int(st.cfg[j, k_star])] = 1.0
    sol = _route_with_stage2(inst, deploy)
    sol.runtime_s = time.perf_counter() - t0
    sol.method = "HF"
    return sol
