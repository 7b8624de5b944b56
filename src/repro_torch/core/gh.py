"""Greedy Heuristic (GH) — paper Algorithm 1, vectorized.

Phase 1 (coverage pre-allocation): greedy set-cover that activates one
(model, tier) pair at a time, maximizing uncovered-types-covered per dollar
of horizon rental, until every type is covered or the Phase-1 budget cap
(beta * delta, beta = 0.8) is reached.  Each round scores every candidate
pair with one pass of array ops over the precomputed M1 tables instead of a
triple Python loop.

Phase 2 (sequential allocation): processes query types in a given order
(default: descending arrival rate).  Per type, the M2 keys of all (j,k)
candidates are produced by `rank_keys_all` and ordered with one stable
lexsort; commits then run down that order with O(1) `max_commit` checks
against the State's incremental aggregates.

Behavioral equivalence with the scalar seed path (`_scalar_ref.gh_scalar`)
is enforced by tests/test_vectorized_equivalence.py.
"""
from __future__ import annotations

import time

import numpy as np

from .contracts import mutates
from .instance import Instance
from .mechanisms import (State, commit, m3_upgrade, max_commit,
                         max_commit_batch, rank_keys_all, solution_from_state,
                         state_restore)
from .solution import Solution


@mutates("q", "cfg", "y", "spend", "uncovered")
def _phase1(st: State) -> None:
    inst = st.inst
    I, J, K = inst.I, inst.J, inst.K
    no_m1 = "no_m1" in st.ablation
    if no_m1:
        # Ablated M1 "selects" the cheapest config everywhere; only the
        # error-SLO filter remains on membership.
        cfg_eff = np.full((I, J, K), inst.cfg_min_nm, dtype=np.int64)
        nm_eff = np.full((I, J, K), int(inst.nm[inst.cfg_min_nm]),
                         dtype=np.int64)
        cover = inst.e_ok
    else:
        cfg_eff, nm_eff, cover = inst.cfg_m1, inst.m1_nm, inst.cover_ok
    cap = inst.phase1_beta * inst.delta
    while st.uncovered and st.spend < cap:
        unc = np.zeros(I, dtype=bool)
        # repro-lint: ignore[RPR203] -- boolean-mask fill: every index is
        # set True regardless of visit order, so set order cannot leak.
        unc[list(st.uncovered)] = True
        members = cover & unc[:, None, None]              # [I,J,K]
        cnt = members.sum(axis=0)                         # [J,K]
        valid = (cnt > 0) & (st.q <= 0.5)
        if not valid.any():
            break
        nm_m = np.where(members, nm_eff, 0)
        worst_nm = nm_m.max(axis=0)                       # [J,K]
        # Config of the first (lowest-i) member attaining the max nm —
        # the scalar scan's `nm > worst_nm` keep-first tie-breaking.
        first_i = np.argmax(members & (nm_m == worst_nm[None]), axis=0)
        worst_c = np.take_along_axis(cfg_eff, first_i[None], axis=0)[0]
        cost = inst.Delta_T * inst.p_c[None, :] * worst_nm   # eq. (14)
        valid &= st.spend + cost <= cap
        if inst.avail_gpus is not None:
            # Phase 1 activates pairs directly (no max_commit): enforce the
            # shared tier availability cap on the candidate's device count.
            tier_used = st.y.sum(axis=0)
            valid &= (tier_used[None, :] + worst_nm
                      <= inst.avail_gpus[None, :] + 1e-9)
        if not valid.any():
            break
        score = np.full((J, K), -np.inf)
        score[valid] = cnt[valid] / cost[valid]
        flat = int(np.argmax(score))                      # first max: j-major
        j, k = flat // K, flat % K
        st.q[j, k] = 1.0
        st.cfg[j, k] = int(worst_c[j, k])
        st.y[j, k] = int(worst_nm[j, k])
        st.spend += float(cost[j, k])
        st.uncovered -= set(int(i) for i in np.flatnonzero(members[:, j, k]))


def _phase2_prep(st: State, i: int, active: np.ndarray, jj: np.ndarray,
                 kk: np.ndarray) -> tuple[np.ndarray, np.ndarray | None]:
    """Candidate configs and delays for one Phase-2 type: the M1 winners
    with the active cells overwritten by each pair's own (possibly
    M3-upgraded) config.  `active`/`jj`/`kk` are the caller-maintained
    active-pair mask and its nonzero index lists.  Shared by `_phase2`
    and the XLA engine's lockstep driver (which computes the M2 keys on
    device from exactly these rows)."""
    inst = st.inst
    no_m1 = "no_m1" in st.ablation
    no_m3 = "no_m3" in st.ablation
    if no_m1:
        c_inact = np.full((inst.J, inst.K), inst.cfg_min_nm, dtype=np.int64)
    else:
        c_inact = inst.cfg_m1[i]
    c_arr = np.where(active, st.cfg, c_inact)             # [J,K], -1 = none
    # Active pairs whose current config breaks the type's delay SLO
    # either get an M3 upgrade or (ablated) are routed to anyway.
    if not no_m3 and jj.size:
        # Gather the few active cells' delays directly — the full
        # [J,K] take_along_axis grid is pure overhead here.
        d_act = inst.D_cfg[i, jj, kk, c_arr[jj, kk]]
        for a in np.flatnonzero(d_act > inst.Delta[i]):
            j, k = int(jj[a]), int(kk[a])
            c2 = m3_upgrade(st, i, j, k)                  # M3
            c_arr[j, k] = -1 if c2 is None else c2
    # Per-pair delay of the candidate configs: precomputed M1 delays
    # with the active cells overwritten (post-upgrade values; dead
    # cells are masked by `valid` downstream).
    if no_m1:
        d_sel = None
    else:
        d_sel = inst.m1_delay[i].copy()
        if jj.size:
            d_sel[jj, kk] = inst.D_cfg[i, jj, kk,
                                       np.maximum(c_arr[jj, kk], 0)]
    return c_arr, d_sel


def _phase2_walk(st: State, i: int, c_arr: np.ndarray, kap0: np.ndarray,
                 kap1: np.ndarray, active: np.ndarray, jj: np.ndarray,
                 kk: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The lazy (pi, kappa)-lexicographic commit scan of one Phase-2 type.

    `kap0`/`kap1` are the flattened per-class key rows (+inf = invalid),
    consumed destructively (visited masking).  All pi=0 (full-coverage)
    cells are visited before any pi=1 cell, each class in ascending
    kappa, and `argmin` returns the first minimum, which reproduces the
    stable lexsort's j-major tie order exactly.  A visited cell is
    masked to +inf and never revisited (the sorted walk's `p` only moved
    forward), so the visit sequence is identical to a sorted walk.
    Mutates `active` in place on fresh activations and returns the
    updated (jj, kk) index lists."""
    inst = st.inst
    K = inst.K
    caps = None
    probes = 0
    while st.r_rem[i] > 1e-9:
        flat = int(np.argmin(kap0))
        cur = kap0
        if not np.isfinite(kap0[flat]):
            flat = int(np.argmin(kap1))
            cur = kap1
            if not np.isfinite(kap1[flat]):
                break
        cur[flat] = np.inf      # visited: the walk never backtracks
        j, k = flat // K, flat % K
        c = int(c_arr[j, k])
        # Re-validate under the *current* state (the pair may have
        # been upgraded while serving an earlier candidate).
        if (st.q[j, k] > 0.5 and c != st.cfg[j, k]
                and inst.nm[c] <= st.y[j, k]):
            c_use = int(st.cfg[j, k])
            if inst.D_cfg[i, j, k, c_use] > inst.Delta[i]:
                continue
        else:
            c_use = c
        if c_use != c:      # rare post-upgrade path: row config stale
            cap = max_commit(st, i, j, k, c_use)
        elif caps is not None:
            cap = float(caps[j, k])
        elif probes < 6:
            cap = max_commit(st, i, j, k, c)
            probes += 1
        else:               # long dead scan: batch the rest of the row
            caps = max_commit_batch(st, i, c_arr)
            # Wholesale-mask candidates the batch proves dead, except
            # stale-config cells (they re-validate to the pair's own
            # config above, so their row cap is not authoritative).
            stale = (active & (c_arr != st.cfg)
                     & (inst.nm[np.maximum(c_arr, 0)] <= st.y))
            dead = ~(stale | (caps > 1e-9))
            kap0[dead.ravel()] = np.inf
            kap1[dead.ravel()] = np.inf
            cap = float(caps[j, k])
        frac = min(st.r_rem[i], cap)
        if frac <= 1e-9:
            continue
        was_active = st.q[j, k] > 0.5
        commit(st, i, j, k, c_use, frac)
        if not was_active:
            active[j, k] = True
            jj, kk = np.nonzero(active)
        caps = None         # state changed: cached row caps invalid
        probes = 0
    return jj, kk


def _phase2(st: State, order: np.ndarray) -> None:
    inst = st.inst
    # The active set changes only when a commit activates a fresh pair —
    # track that instead of recomputing the mask per type.
    active = st.q > 0.5
    jj, kk = np.nonzero(active)                           # j-major order
    for i in order:
        i = int(i)
        c_arr, d_sel = _phase2_prep(st, i, active, jj, kk)
        pi, kappa, valid = rank_keys_all(st, i, c_arr, d_sel=d_sel)  # M2
        if not valid.any():
            continue
        # Lazy candidate selection: see `_phase2_walk`.
        kap0 = np.where(valid & (pi == 0), kappa, np.inf).ravel()
        kap1 = np.where(valid & (pi == 1), kappa, np.inf).ravel()
        jj, kk = _phase2_walk(st, i, c_arr, kap0, kap1, active, jj, kk)


def greedy_heuristic(inst: Instance, order: np.ndarray | None = None,
                     run_phase1: bool = True,
                     ablation: frozenset = frozenset(),
                     phase1_snapshot: tuple | None = None
                     ) -> tuple[Solution, State]:
    """Single-pass GH (Algorithm 1).

    `order` overrides the Phase-2 query ordering (used by AGH's
    multi-start); default is descending lambda.  `ablation` disables
    mechanisms for the Table-3 study.  Phase 1 is ordering-independent, so
    AGH's multi-start runs it once and passes the resulting
    `state_snapshot` as `phase1_snapshot` — restored here bit-identically
    instead of being recomputed per ordering.

    Returns the materialized `Solution` together with the running `State`
    (whose arrays the Solution shares) so AGH's local search can continue
    from the construction state without a rebuild.
    """
    t0 = time.perf_counter()
    st = State.fresh(inst, ablation=ablation)
    if phase1_snapshot is not None:
        state_restore(st, phase1_snapshot)
    elif run_phase1:
        _phase1(st)
    if order is None:
        order = np.argsort(-inst.lam)
    _phase2(st, np.asarray(order))
    sol = solution_from_state(inst, st)
    sol.runtime_s = time.perf_counter() - t0
    sol.method = "GH"
    return sol, st


def gh(inst: Instance, order: np.ndarray | None = None,
       run_phase1: bool = True, ablation: frozenset = frozenset(),
       phase1_snapshot: tuple | None = None) -> Solution:
    """Solution-only wrapper of `greedy_heuristic` with the same explicit
    signature — a typo'd option fails loudly here instead of vanishing
    into a ``**kw`` pass-through."""
    sol, _ = greedy_heuristic(inst, order=order, run_phase1=run_phase1,
                              ablation=ablation,
                              phase1_snapshot=phase1_snapshot)
    return sol
