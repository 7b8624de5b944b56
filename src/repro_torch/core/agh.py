"""Adaptive Greedy Heuristic (AGH) — paper Algorithm 2, vectorized.

Enhancements over GH:
  * multi-start construction: 8 deterministic orderings (ascending/descending
    each of lambda_i, phi_i, per-type weight-footprint proxy, and error
    tightness eps_i) plus R adaptive random permutations (Remark 2:
    R = 3 / 5 / 10 / 20 by problem scale N = I*J*K; the batched engine
    raises the schedule to 5 / 8 / 14 / 24 with the wall-clock it frees),
    early stop after five consecutive non-improving orderings;
  * relocate local search (L = 3 passes): move committed (i,j,k) fractions to
    alternative pairs when feasible and strictly improving;
  * consolidation: drain lightly loaded active pairs onto other active pairs
    and deactivate them when feasible and strictly improving.

Two improvement engines share the construction state:

``local_search="batched"`` (default) — the scored-matrix engine.  Per
source cell, `score_moves_batch` evaluates *every* (j2,k2) destination in
one pass (config selection, delay/M1 admissibility, one `max_commit_batch`
cap evaluation, vectorized delta objective) and `_relocate_batched` applies
the best improving move from that matrix; `_try_drain_batched` batch-scores
all (type x destination) placements of a draining pair up front and places
each type on its cheapest verified destination.  Because it scores the full
destination grid (the paper's "scan all (j',k')") instead of the reference
path's active-pairs-plus-3 shortlist, it both runs faster and never returns
a worse objective on the equivalence suite.

``local_search="reference"`` — the first-improvement scalar probe loop
(PR-1/PR-2 behavior), kept bit-identical to `_scalar_ref.agh_scalar` by
tests/test_vectorized_equivalence.py.

Multi-start fans out over a process pool when `workers` is given (auto for
large instances): Phase 1 is ordering-independent, so its snapshot and the
precomputed `Instance` tensors are shared with forked workers, and the
reduction applies the sequential driver's strict-improvement rule in
ordering-index order — the selected solution is independent of worker
count and scheduling.
"""
from __future__ import annotations

import os
import time

import numpy as np

from .contracts import mutates
from .gh import _phase1, _phase2, greedy_heuristic
from .instance import Instance
from .mechanisms import (DestCache, State, commit, deactivate_pair,
                         delay_sel, deployment_state, max_commit,
                         max_commit_batch, remove_assignment,
                         score_moves_batch, solution_from_state,
                         state_objective, state_restore, state_snapshot,
                         undo_all)
from .solution import Solution, is_feasible, objective


def _orderings(inst: Instance, R: int, rng: np.random.Generator) -> list[np.ndarray]:
    lam, phi, eps = inst.lam, inst.phi, inst.eps
    # Per-type weight-footprint proxy: smallest model whose FP16 error meets
    # the type's SLO ("B_j as it appears for that type") — one masked min
    # over [I,J] instead of a per-type Python loop.
    ok = inst.e_base <= inst.eps[:, None]
    bmin = np.where(ok, inst.B[None, :], np.inf).min(axis=1)
    bproxy = np.where(np.isfinite(bmin), bmin, inst.B.max())
    keys = [lam, phi, bproxy, eps]
    orders = []
    for key in keys:
        orders.append(np.argsort(key))
        orders.append(np.argsort(-key))
    for _ in range(R):
        orders.append(rng.permutation(inst.I))
    return orders


def _adaptive_R(inst: Instance, batched: bool = False) -> int:
    """Remark-2 random-restart budget; the batched engine runs a raised
    schedule, spending the wall-clock the scored-matrix search frees."""
    N = inst.I * inst.J * inst.K
    if N > 5000:
        return 5 if batched else 3
    if N > 2000:
        return 8 if batched else 5
    if N > 500:
        return 14 if batched else 10
    return 24 if batched else 20


# ---------------------------------------------------------------------------
# Reference local search (first-improvement scalar probes, PR-1/PR-2 path)
# ---------------------------------------------------------------------------

def _try_move(st: State, i: int, j: int, k: int, j2: int, k2: int,
              best_obj: float, validate: bool) -> float | None:
    """Move all of x[i,j,k] to (j2,k2); keep if feasible & improving.

    Returns the new objective on success (state mutated), None on rejection
    (state rolled back exactly)."""
    inst = st.inst
    undo: list = []
    frac = remove_assignment(st, i, j, k, undo=undo)
    if st.q[j2, k2] > 0.5:
        c = int(st.cfg[j2, k2])
        if inst.D_cfg[i, j2, k2, c] > inst.Delta[i]:
            undo_all(st, undo)
            return None
    else:
        c = int(inst.cfg_m1[i, j2, k2])
        if c < 0:
            undo_all(st, undo)
            return None
    if max_commit(st, i, j2, k2, c) < frac - 1e-9:
        undo_all(st, undo)
        return None
    commit(st, i, j2, k2, c, frac, undo=undo)
    obj_new = state_objective(st)
    if obj_new < best_obj - 1e-9:
        if validate:
            _assert_state_consistent(st)
        return obj_new
    undo_all(st, undo)
    return None


def _move_targets(st: State, i: int, ranked_jk: np.ndarray,
                  n_inactive: int = 3) -> list[tuple[int, int]]:
    """Candidate destinations for relocating type i: every ACTIVE pair plus
    the few cheapest inactive pairs that pass M1 for this type (the
    reference path's shortlist; the batched engine scores the full grid).
    `ranked_jk` is the per-type list of admissible pairs pre-sorted by
    activation cost, computed once per AGH call."""
    K = st.inst.K
    targets = [(int(f) // K, int(f) % K)
               for f in np.flatnonzero((st.q > 0.5).ravel())]
    taken = 0
    for f in ranked_jk:
        j, k = int(f) // K, int(f) % K
        if st.q[j, k] > 0.5:
            continue
        targets.append((j, k))
        taken += 1
        if taken >= n_inactive:
            break
    return targets


def _rank_inactive_targets(inst: Instance) -> list[np.ndarray]:
    """Per type: flat (j,k) indices of M1+error-admissible pairs, sorted by
    activation cost p_c[k] * nm(M1 config) with j-major tie order — the
    state-independent part of `_move_targets`.  One masked stable argsort
    over the [I, J*K] cost matrix replaces the per-type Python loop; the
    inadmissible cells sort to the tail as +inf and are sliced off."""
    I, JK = inst.I, inst.J * inst.K
    adm = inst.cover_ok.reshape(I, JK)
    cost = (inst.p_c[None, None, :]
            * inst.nm[np.maximum(inst.cfg_m1, 0)]).reshape(I, JK)
    order = np.argsort(np.where(adm, cost, np.inf), axis=1, kind="stable")
    counts = adm.sum(axis=1)
    return [order[i, :counts[i]] for i in range(I)]


def _relocate(st: State, L: int, ranked: list[np.ndarray],
              validate: bool) -> None:
    inst = st.inst
    for _ in range(L):
        improved = False
        obj = state_objective(st)
        for i in range(inst.I):
            assigned = [(int(f) // inst.K, int(f) % inst.K)
                        for f in np.flatnonzero((st.x[i] > 1e-9).ravel())]
            for (j, k) in assigned:
                for (j2, k2) in _move_targets(st, i, ranked[i]):
                    if (j2, k2) == (j, k):
                        continue
                    obj_new = _try_move(st, i, j, k, j2, k2, obj, validate)
                    if obj_new is not None:
                        obj = obj_new
                        improved = True
                        break
        if not improved:
            break


@mutates("D_used", "q", "cfg")
def _try_drain(st: State, j: int, k: int, validate: bool) -> bool:
    """Drain every type off pair (j,k) onto other active pairs and shut the
    pair down; keep only if all traffic lands and the objective improves.

    Replicates the scalar reference's per-type rebuild semantics: after the
    first successful placement the drained pair's config selector is
    cleared, so its remaining traffic stops counting toward D_used while
    the later types are being placed."""
    inst = st.inst
    snap = state_snapshot(st)
    obj0 = state_objective(st)
    types = [int(i) for i in np.flatnonzero(st.x[:, j, k] > 1e-9)]
    c_pair = int(st.cfg[j, k])
    suspended = False
    ok = True
    for i in types:
        frac = float(st.x[i, j, k])
        remove_assignment(st, i, j, k, timed=not suspended,
                          auto_deactivate=False)
        # One batched (8c)–(8h) cap evaluation over all destinations; the
        # first-fit scan below then touches no per-pair Python arithmetic.
        c_dest = np.where(st.q > 0.5, st.cfg, -1)
        c_dest[j, k] = -1
        caps = max_commit_batch(st, i, c_dest)
        d_dest = delay_sel(inst, i, c_dest)
        fits = ((c_dest >= 0) & (d_dest <= inst.Delta[i])
                & (caps >= frac - 1e-9)).ravel()
        placed = False
        for f in np.flatnonzero(fits):
            j2, k2 = int(f) // inst.K, int(f) % inst.K
            commit(st, i, j2, k2, int(st.cfg[j2, k2]), frac)
            placed = True
            break
        if not placed:
            ok = False
            break
        if not suspended:
            # First placement materialized a solution with the drained
            # pair's w zeroed — its residual delay contributions vanish.
            st.D_used -= inst.D_cfg[:, j, k, c_pair] * st.x[:, j, k]
            st.q[j, k] = 0.0
            st.cfg[j, k] = -1
            suspended = True
    if ok:
        if not suspended:
            if c_pair >= 0:
                st.D_used -= inst.D_cfg[:, j, k, c_pair] * st.x[:, j, k]
        deactivate_pair(st, j, k)
        if state_objective(st) < obj0 - 1e-9:
            if validate:
                _assert_state_consistent(st)
            return True
    state_restore(st, snap)
    return False


def _consolidate(st: State, validate: bool) -> None:
    """Drain lightly loaded pairs onto other active pairs (Alg. 2 l.10–12)."""
    inst = st.inst
    while True:
        flat = np.flatnonzero((st.q > 0.5).ravel())
        active = sorted((float(st.y.ravel()[f]), int(f) // inst.K,
                         int(f) % inst.K) for f in flat)
        improved = False
        for _, j, k in active:
            if _try_drain(st, j, k, validate):
                improved = True
                break
        if not improved:
            return


# ---------------------------------------------------------------------------
# Batched local search (scored move matrices, best-improvement, incremental)
# ---------------------------------------------------------------------------

def _invalidate_sources(clean: set, types, cells: set) -> None:
    """Drop every clean-source mark whose score inputs an applied move may
    have touched: all sources of the moved types (their type-local scalars
    — r_rem, E/D_used, stor_used, z row — shifted) and all sources sitting
    on a touched pair whose removal economics changed (`cells` — the
    callers pass pairs left with a single traffic type, whose survivor
    gains the deactivation refund, and drained/deactivated pairs).
    Destination-side reveals — capacity freed on a touched pair making
    someone else's move into it viable — are deliberately NOT tracked
    here; the verification rescan at the fixed point catches them."""
    tset = types if isinstance(types, set) else {types}
    # repro-lint: ignore[RPR203] -- feeds difference_update (an order-
    # insensitive set reduction); iteration order cannot reach any output.
    stale = [s for s in clean if s[0] in tset or (s[1], s[2]) in cells]
    clean.difference_update(stale)


def _relocate_batched(st: State, L: int, validate: bool,
                      cache: DestCache | None = None,
                      clean: set | None = None,
                      fallback: bool = True,
                      stats: dict | None = None) -> bool:
    """Relocate via `score_moves_batch`: per source cell, every destination
    is scored in one pass and the best strictly-improving move is applied.
    Scans the full (j',k') grid (the paper's scan), not the reference
    path's active-pairs-plus-3 shortlist.

    With `clean` (the dirty-source protocol), sources that failed to
    improve stay skipped until an applied move touches their score inputs
    (`_invalidate_sources`); a sweep that found no improving move among
    the dirty sources clears the set and rescans everything (`fallback`;
    `_improve_batched` disables it per call and runs one shared
    verification rescan at the joint relocate/consolidate fixed point
    instead), so the search never declares convergence on stale marks —
    an improving move can be deferred by the approximate invalidation
    rule, never missed.  The improvement test itself is
    threshold-independent (a move improves iff its own delta is negative),
    so marks taken against an older, higher objective stay valid as the
    objective descends.  `L` caps the number of improving sweeps,
    mirroring the fixed-pass engine's bound; rescans that find nothing are
    free.  Returns whether any move was applied."""
    inst = st.inst
    K = inst.K
    track = clean is not None
    improving = 0
    any_improved = False
    while True:
        improved = False
        skipped = False
        obj = state_objective(st)
        for i in range(inst.I):
            for f in np.flatnonzero((st.x[i] > 1e-9).ravel()):
                j, k = int(f) // K, int(f) % K
                if st.x[i, j, k] <= 1e-9:   # merged away earlier this pass
                    continue
                if track and (i, j, k) in clean:
                    skipped = True
                    continue
                ms = score_moves_batch(st, i, j, k, improve_below=obj - 1e-9,
                                       cache=cache, obj_cur=obj)
                if not ms.admissible.any():
                    if track:
                        clean.add((i, j, k))
                    continue
                flat = int(np.argmin(ms.obj_after))
                j2, k2 = flat // K, flat % K
                remove_assignment(st, i, j, k)
                commit(st, i, j2, k2, int(ms.c_dest[j2, k2]), ms.frac)
                obj = state_objective(st)
                improved = True
                if stats is not None:
                    stats["moves_applied"] = stats.get("moves_applied", 0) + 1
                if cache is not None:
                    cache.invalidate_type(i)
                if track and clean:
                    # The source pair's survivors re-score only when the
                    # move leaves exactly one traffic type behind (its
                    # removal now also refunds the pair); arrivals at the
                    # destination pair lose refund appeal, never gain it.
                    cells = set()
                    if np.count_nonzero(st.x[:, j, k] > 1e-9) == 1:
                        cells.add((j, k))
                    _invalidate_sources(clean, i, cells)
                if validate:
                    _assert_state_consistent(st)
        any_improved |= improved
        if improved:
            improving += 1
            if improving >= L:
                break
        elif skipped and fallback:
            clean.clear()       # fallback full rescan before convergence
            if stats is not None:
                stats["rescans"] = stats.get("rescans", 0) + 1
        else:
            break
    return any_improved


def _try_drain_batched(st: State, j: int, k: int,
                       validate: bool) -> tuple[set, set] | None:
    """Drain pair (j,k): one vectorized pass scores every (type x
    destination) placement — delay fits and the commit-cost delta over the
    compressed active-destination list — then each type lands on its
    cheapest destination in score order, with one O(1) `max_commit` check
    at commit time (caps only shrink as earlier types are placed, so the
    pre-placement scores over-approximate and the check restores
    exactness).  Structurally impossible drains (some type has no
    delay-admissible destination — the common case at a converged state)
    are rejected before the detach round trip; a rejected drain rolls back
    through its undo records (exact restore) instead of a full-state
    snapshot, which at (100,80,40) scale saves two multi-MB array copies
    per probe.  Returns `(moved_types, touched_cells)` on success (the
    dirty-source invalidation set) or None."""
    inst = st.inst
    K = inst.K
    types = np.flatnonzero(st.x[:, j, k] > 1e-9)
    dest = np.flatnonzero((st.q > 0.5).ravel())
    dest = dest[dest != j * K + k]
    obj0 = state_objective(st)
    if types.size:
        if dest.size == 0:
            return None
        jj, kk = dest // K, dest % K
        cfg_d = st.cfg[jj, kk]
        # One (T, n_dest) score pass: delay admissibility is state-free and
        # the delta rows read only type-local state (z[i], r_rem[i]), which
        # other types' placements never touch — so the matrix computed here
        # stays exact for each type at its own placement time.
        d_td = inst.D_cfg[types[:, None], jj[None, :], kk[None, :],
                          cfg_d[None, :]]
        fits = d_td <= inst.Delta[types, None]
        if not fits.any(axis=1).all():
            return None
        fr = st.x[types, j, k][:, None]
        if not st.ablation:
            # Cap upper bound per (type, destination) on the pre-detach
            # state: each type's own scalars are computed post-removal in
            # closed form (exact at its placement time — other types'
            # placements never touch them), and destination loads only
            # grow as earlier types land, so this bounds the real commit
            # cap from above.  A type whose best admissible destination
            # cannot absorb its traffic dooms the whole drain before the
            # detach/rollback round trip — the common case at a converged
            # state with near-full destinations.
            frv = st.x[types, j, k]
            c_pair = int(st.cfg[j, k])
            rr2 = st.r_rem[types] + frv
            e2 = st.E_used[types] - inst.e_bar[types, j, k] * frv
            dd2 = st.D_used[types] - inst.D_cfg[types, j, k, c_pair] * frv
            ub = np.minimum(
                rr2[:, None],
                (inst.eps[types, None] - e2[:, None])
                / inst.e_bar_floor[types[:, None], jj[None, :], kk[None, :]])
            ub = np.minimum(ub, (inst.Delta[types, None] - dd2[:, None])
                            / np.maximum(d_td, 1e-12))
            lpx = inst.load_per_x[types[:, None], jj[None, :], kk[None, :]]
            comp = inst.comp_cap_coef[kk] * inst.nm[cfg_d] - st.load[jj, kk]
            with np.errstate(divide="ignore", invalid="ignore"):
                ub = np.where(lpx > 1e-18,
                              np.minimum(ub, comp[None, :] / lpx), ub)
            best_ub = np.where(fits, ub, -np.inf).max(axis=1)
            if np.any(best_ub < frv - 1e-9):
                return None
        delta = (inst.Delta_T * inst.p_s
                 * (np.where(st.z[types][:, jj, kk] < 0.5,
                             inst.B[jj][None, :], 0.0)
                    + inst.data_gb[types, None] * fr)
                 + inst.rho[types, None] * d_td * 1e3 * fr)
        score = np.where(fits, delta, np.inf)
        if not st.ablation:
            # Objective lower bound: routing every type to its *cheapest*
            # admissible destination still costs at least
            # sum_t min(delta) against the removal + deactivation refunds
            # — if that cannot clear the strict-improvement bar (with a
            # 1e-6 margin over float reassociation), the drain cannot
            # either, and the detach round trip is skipped.  The common
            # failure mode at a converged state is exactly this
            # "placeable but not profitable" case.
            hz = st.z[types, j, k] > 0.5
            refunds = (inst.Delta_T * inst.p_s
                       * (inst.data_gb[types] * frv
                          + np.where(hz, inst.B[j], 0.0))
                       + inst.rho[types] * inst.D_cfg[types, j, k, c_pair]
                       * 1e3 * frv)
            n_str = (int(np.count_nonzero(st.z[:, j, k] > 0.5))
                     - int(np.count_nonzero(hz)))
            lb = (score.min(axis=1).sum() - refunds.sum()
                  - inst.Delta_T * (inst.p_s * inst.B[j] * n_str
                                    + inst.p_c[k] * float(st.y[j, k])))
            if lb >= 1e-6:
                return None
        order = np.argsort(score, axis=1, kind="stable")
    undo: list = []
    fracs = [remove_assignment(st, int(i), j, k, undo=undo,
                               auto_deactivate=False)
             for i in types]
    deactivate_pair(st, j, k, undo=undo)
    ok = True
    used: set = set()
    for t, i in enumerate(types):
        i, frac = int(i), float(fracs[t])
        placed = False
        for p in order[t]:
            if not np.isfinite(score[t, p]):
                break
            j2, k2 = int(jj[p]), int(kk[p])
            if max_commit(st, i, j2, k2, int(st.cfg[j2, k2])) >= frac - 1e-9:
                commit(st, i, j2, k2, int(st.cfg[j2, k2]), frac, undo=undo)
                used.add((j2, k2))
                placed = True
                break
        if not placed:
            ok = False
            break
    if ok and state_objective(st) < obj0 - 1e-9:
        if validate:
            _assert_state_consistent(st)
        return {int(i) for i in types}, used | {(j, k)}
    undo_all(st, undo)
    return None


@mutates("cfg_dirty")
def _consolidate_batched(st: State, validate: bool,
                         cache: DestCache | None = None,
                         clean: set | None = None,
                         stats: dict | None = None) -> bool:
    """Drain lightly loaded pairs, restarting the ascending-y scan after
    every success (unchanged protocol).  A successful drain invalidates
    the relocate engine's clean-source marks (and cached admission rows)
    for the moved types and every touched cell, so the following relocate
    sweep re-scores exactly the sources the drain disturbed.  Returns
    whether any pair was drained."""
    inst = st.inst
    any_improved = False
    while True:
        flat = np.flatnonzero((st.q > 0.5).ravel())
        active = sorted((float(st.y.ravel()[f]), int(f) // inst.K,
                         int(f) % inst.K) for f in flat)
        improved = False
        for _, j, k in active:
            res = _try_drain_batched(st, j, k, validate)
            if res is not None:
                if cache is not None:
                    # Arm the config diff even when the drained pair had
                    # no traffic (empty moved-type set): its cfg flipped
                    # to -1 and the cache must not keep scoring it as an
                    # active, rental-free destination.
                    cache.cfg_dirty = True
                    for t in res[0]:
                        cache.invalidate_type(t)
                if clean is not None and clean:
                    _invalidate_sources(clean, res[0], res[1])
                if stats is not None:
                    stats["drains_applied"] = stats.get("drains_applied",
                                                        0) + 1
                improved = True
                break
        if not improved:
            return any_improved
        any_improved = True


def _improve_batched(st: State, L: int, validate: bool,
                     incremental: bool = True,
                     stats: dict | None = None) -> None:
    """The batched improvement phase: relocate and consolidation iterate
    to a joint fixed point (a consolidation that drained something hands
    the disturbed sources back to relocate; one that drained nothing
    terminates — relocate had already converged on the same state).  One
    `DestCache` carries the destination scoring tensors across all sweeps
    of all rounds, diff-synced against the state's config vector; with
    `incremental`, the clean-source set persists across rounds too, so a
    round after a drain re-scores only what the drain touched.

    Inner relocate calls skip clean sources without their own fallback
    rescan; instead, once the dirty fixed point is reached, the clean set
    is cleared and one full verification rescan runs (plus a consolidation
    retry if it moved anything) — the "no improving move is ever missed"
    guarantee costs one extra sweep per ordering, not one per round."""
    cache = DestCache(st)
    clean: set | None = set() if incremental else None
    while True:
        _relocate_batched(st, L, validate, cache, clean, fallback=False,
                          stats=stats)
        if _consolidate_batched(st, validate, cache, clean, stats=stats):
            continue
        if not (incremental and clean):
            return
        # Dirty fixed point: verify with one full rescan.  Only an applied
        # move (deferred by the approximate invalidation rule) keeps the
        # loop alive — and then the next fixed point is verified again, so
        # the state returned has survived a full rescan unimproved.
        clean.clear()
        if stats is not None:
            stats["rescans"] = stats.get("rescans", 0) + 1
        if not _relocate_batched(st, L, validate, cache, clean,
                                 fallback=False, stats=stats):
            return
        _consolidate_batched(st, validate, cache, clean, stats=stats)


def _assert_state_consistent(st: State) -> None:
    """Debug path: the incremental state must match a from-scratch
    objective/feasibility evaluation of its materialized solution."""
    inst = st.inst
    sol = solution_from_state(inst, st)
    full = objective(inst, sol)
    fast = state_objective(st)
    assert abs(full - fast) <= 1e-6 * max(1.0, abs(full)), (full, fast)
    assert is_feasible(inst, sol, enforce_zeta=False)


# ---------------------------------------------------------------------------
# AGH driver (sequential early-stop or deterministic parallel fan-out)
# ---------------------------------------------------------------------------

_PARALLEL_MIN_N = 24000     # auto fan-out only beyond (20,20,20)-class sizes


def _run_ordering(inst: Instance, order: np.ndarray, p1_snap: tuple, L: int,
                  batched: bool, ranked: list[np.ndarray] | None,
                  validate: bool, incremental: bool = True,
                  stats: dict | None = None) -> State:
    """Construction + improvement for one multi-start ordering."""
    _, st = greedy_heuristic(inst, order=order, phase1_snapshot=p1_snap)
    if batched:
        _improve_batched(st, L, validate, incremental=incremental,
                         stats=stats)
    else:
        _relocate(st, L, ranked, validate)
        _consolidate(st, validate)
    return st


def _warm_start_state(inst: Instance, incumbent: Solution, L: int,
                      batched: bool, ranked: list[np.ndarray] | None,
                      validate: bool, incremental: bool,
                      stats: dict | None = None) -> State:
    """The warm-start seed: re-route the NEW instance's demand over the
    incumbent's deployment (one Phase-2 pass — Phase 1's coverage search
    is what the incumbent already paid for), then run the configured
    improvement engine to a fixed point.  Replaces a full multi-start
    ordering at roughly one ordering's cost while typically starting at a
    much better objective than any cold construction.

    Under availability caps the incumbent may sit on capacity this
    instance no longer has (supply drift: revocations, outages) — those
    pairs are evicted first, as in `agh_repair`, so the seed is legal
    before any demand is routed onto it."""
    st = deployment_state(inst, incumbent)
    if inst.avail_gpus is not None:
        from .faults import lost_pairs
        for (j, k) in lost_pairs(inst, st.y):
            deactivate_pair(st, j, k)
    _phase2(st, np.argsort(-inst.lam))
    if batched:
        _improve_batched(st, L, validate, incremental=incremental,
                         stats=stats)
    else:
        _relocate(st, L, ranked, validate)
        _consolidate(st, validate)
    return st


def agh_repair(inst: Instance, incumbent: Solution, L: int = 1,
               local_search: str = "batched", validate: bool = False,
               stats: dict | None = None) -> Solution:
    """One-pass warm *repair* solve for a supply-faulted instance.

    The sub-second replan path behind `PlanSession.repair()`: no
    multi-start, no Phase-1 coverage search — the incumbent's structure
    is what the fleet is already running, so repair (1) seeds the state
    from the incumbent's deployment with routing cleared
    (`deployment_state` — the drain: displaced traffic is simply demand
    to re-route), (2) evicts every pair that no longer fits its tier's
    availability cap via `deactivate_pair` (rental refunded, admissions
    dropped), (3) re-routes ALL demand over the surviving deployment
    with one GH Phase-2 pass — the commit machinery's availability
    guards keep fresh activations inside the reduced caps — and (4)
    polishes with the configured improvement engine capped at `L`
    passes (default 1: latency beats the last percent of objective
    mid-incident).

    Like `agh`, the result is asserted feasible for the hard constraint
    system (zeta excluded — the unmet cap is the first rung of the
    planner's degradation ladder, reported there, never silently
    violated)."""
    t0 = time.perf_counter()
    from .faults import lost_pairs
    batched = local_search != "reference"
    incremental = local_search != "batched-rescan"
    st = deployment_state(inst, incumbent)
    evicted = lost_pairs(inst, st.y)
    for (j, k) in evicted:
        deactivate_pair(st, j, k)
    _phase2(st, np.argsort(-inst.lam))
    if batched:
        _improve_batched(st, L, validate, incremental=incremental,
                         stats=stats)
    else:
        _relocate(st, L, _rank_inactive_targets(inst), validate)
        _consolidate(st, validate)
    best = solution_from_state(inst, st)
    if stats is not None:
        stats.update(repair=True, evicted=[[j, k] for (j, k) in evicted],
                     repair_objective=state_objective(st))
    assert is_feasible(inst, best, enforce_zeta=False), \
        "repair produced an infeasible plan (incremental-state bug)"
    best.runtime_s = time.perf_counter() - t0
    best.method = "AGH-repair"
    return best


# Fork-shared work description for the multi-start pool: set in the parent
# immediately before the pool is created, inherited copy-on-write by the
# forked workers (no per-task pickling of the Instance tensors).
_FANOUT: dict = {}


def _fanout_worker(idx: int):
    inst = _FANOUT["inst"]
    st = _run_ordering(inst, _FANOUT["orders"][idx],
                       _FANOUT["p1"], _FANOUT["L"], _FANOUT["batched"],
                       _FANOUT["ranked"], _FANOUT["validate"],
                       _FANOUT["incremental"])
    # Materialize through the one shared materializer so the parallel and
    # sequential paths can never drift apart.
    return (idx, state_objective(st), solution_from_state(inst, st))


def _multi_start_parallel(inst: Instance, orders: list[np.ndarray],
                          p1_snap: tuple, L: int, batched: bool,
                          ranked: list[np.ndarray] | None, validate: bool,
                          workers: int, incremental: bool = True):
    """Evaluate every ordering (no early stop) and reduce deterministically.

    The reduction scans results in ordering-index order with the sequential
    driver's strict-improvement rule, so the returned solution is identical
    for any worker count — and never worse than the early-stop sequential
    protocol, which evaluates a prefix of the same orderings."""
    import multiprocessing as mp
    if workers > 1 and (mp.current_process().daemon
                        or "fork" not in mp.get_all_start_methods()):
        workers = 1     # pool unavailable here; same protocol inline
    _FANOUT.update(inst=inst, orders=orders, p1=p1_snap, L=L,
                   batched=batched, ranked=ranked, validate=validate,
                   incremental=incremental)
    try:
        if workers > 1:
            import concurrent.futures as cf
            from concurrent.futures.process import BrokenProcessPool
            ctx = mp.get_context("fork")
            try:
                with cf.ProcessPoolExecutor(max_workers=workers,
                                            mp_context=ctx) as ex:
                    results = list(ex.map(_fanout_worker,
                                          range(len(orders))))
            except (OSError, BrokenProcessPool):
                # Pool-infrastructure failure only (sandboxed spawn, killed
                # worker): same protocol inline — the deterministic
                # reduction makes the results identical.  Worker-side
                # algorithm errors propagate unchanged.
                results = [_fanout_worker(i) for i in range(len(orders))]
        else:
            results = [_fanout_worker(i) for i in range(len(orders))]
    finally:
        _FANOUT.clear()
    results.sort(key=lambda r: r[0])
    best, best_obj, best_idx = None, np.inf, -1
    for idx, obj, sol in results:
        if obj < best_obj - 1e-9:
            best, best_obj, best_idx = sol, obj, idx
    return best, best_obj, best_idx


def _auto_workers(inst: Instance, n_orders: int) -> int:
    """Fan out only where it wins: large instances on boxes with enough
    cores.  On <= 2 cores the pool's fork/IPC overhead plus the loss of
    early stopping (the parallel protocol evaluates every ordering) beats
    the speedup, measured end to end — so auto mode stays sequential
    there and `workers=` remains an explicit opt-in."""
    if inst.I * inst.J * inst.K < _PARALLEL_MIN_N:
        return 0
    cpus = os.cpu_count() or 1
    return 0 if cpus < 4 else min(cpus, n_orders, 8)


def agh(inst: Instance, R: int | None = None, L: int = 3, seed: int = 0,
        patience: int = 5, validate: bool = False,
        local_search: str = "batched",
        workers: int | None = None,
        warm_start: Solution | None = None,
        priority_orders: list[np.ndarray] | None = None,
        stats: dict | None = None) -> Solution:
    """Adaptive Greedy Heuristic.

    `local_search` picks the improvement engine: "batched" (default, the
    incremental scored-matrix engine — amortized destination tensors plus
    dirty-source tracking with a fallback full rescan before convergence),
    "batched-rescan" (the same engine with dirty-source tracking disabled:
    every sweep re-scores every source — the oracle the incremental mode
    is tested bit-equal against), or "reference" (the first-improvement
    probe loop, bit-identical to the frozen scalar seed path).  `workers`
    controls the multi-start driver: ``0`` forces
    the sequential early-stop protocol, ``n >= 1`` evaluates every ordering
    under the deterministic-reduction protocol (fanning out over ``n``
    forked processes when ``n > 1``; results are independent of ``n``), and
    ``None`` picks automatically — sequential below `_PARALLEL_MIN_N`,
    fan-out above it.

    `warm_start` seeds the multi-start from an incumbent solution (the
    `PlanSession.replan` path): the incumbent's deployment is re-routed
    under this instance's demand and improved, and that result enters the
    protocol as the starting best — the early-stop patience then counts
    non-improving orderings against a strong bound from the first
    ordering on.  ``R=0`` with a warm start is the fast-replan protocol:
    only the 8 deterministic orderings remain as challengers.

    `priority_orders` are extra Phase-2 orderings evaluated BEFORE the
    standard multi-start list.  `PlanSession` passes the ordering that
    produced the incumbent: the multi-start winner is empirically stable
    under workload drift, so replaying it recovers the cold run's best
    basin at one ordering's cost even when the warm seed's own basin has
    degraded.

    `stats`, when given, is filled in place with solver diagnostics
    (orderings evaluated, local-search moves applied, drains, fallback
    rescans, the winning ordering, warm-start provenance) — collected on
    the sequential driver; the parallel fan-out reports ordering counts
    and the winning ordering only.
    """
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    batched = local_search != "reference"
    incremental = local_search != "batched-rescan"
    if R is None:
        R = _adaptive_R(inst, batched=batched)
    orders = _orderings(inst, R, rng)
    if priority_orders:
        orders = [np.asarray(o) for o in priority_orders] + orders
    # Phase 1 is ordering-independent: run it once and share the snapshot
    # with every start (and every forked worker).
    st0 = State.fresh(inst)
    _phase1(st0)
    p1_snap = state_snapshot(st0)
    ranked = None if batched else _rank_inactive_targets(inst)
    if workers is None:
        workers = _auto_workers(inst, len(orders)) if batched else 0
    if stats is not None:
        stats.update(restarts=R, warm_started=warm_start is not None,
                     local_search=local_search)
    best, best_obj, best_order = None, np.inf, None
    if warm_start is not None:
        st = _warm_start_state(inst, warm_start, L, batched, ranked,
                               validate, incremental, stats=stats)
        best, best_obj = solution_from_state(inst, st), state_objective(st)
        if stats is not None:
            stats["warm_objective"] = best_obj
    if workers:
        par, par_obj, par_idx = _multi_start_parallel(
            inst, orders, p1_snap, L, batched, ranked, validate, workers,
            incremental=incremental)
        # Same strict-improvement rule as the sequential reduction: the
        # warm seed came first, so it wins ties.
        if par_obj < best_obj - 1e-9:
            best, best_obj = par, par_obj
            best_order = orders[par_idx]
        if stats is not None:
            stats["orderings_evaluated"] = len(orders)
    else:
        stale = 0
        evaluated = 0
        for order in orders:
            st = _run_ordering(inst, order, p1_snap, L, batched, ranked,
                               validate, incremental=incremental,
                               stats=stats)
            evaluated += 1
            obj = state_objective(st)
            if obj < best_obj - 1e-9:
                best, best_obj = solution_from_state(inst, st), obj
                best_order = order
                stale = 0
            else:
                stale += 1
                if stale >= patience:
                    break
        if stats is not None:
            stats["orderings_evaluated"] = evaluated
            stats["early_stopped"] = evaluated < len(orders)
    if stats is not None:
        # The ordering whose basin won (None when the warm seed held) —
        # `PlanSession` replays it on the next replan.
        stats["winning_order"] = (None if best_order is None
                                  else [int(i) for i in best_order])
    assert best is not None
    # Final check: the delta-maintained state must stand up to the full
    # constraint system (cheap — once per AGH call, not per move).
    assert is_feasible(inst, best, enforce_zeta=False), \
        "AGH produced an infeasible solution (incremental-state bug)"
    best.runtime_s = time.perf_counter() - t0
    best.method = "AGH"
    return best
