"""The three constraint-aware mechanisms shared by GH and AGH (paper §4.1).

M1 — TP-aware feasibility selection (eq. 9): for candidate (i,j,k), pick the
     cheapest (TP,PP) that simultaneously fits per-device memory and the
     delay SLO; discard the candidate if none exists.
M2 — cost-per-effective-coverage ranking (eqs. 10–11): rank candidates by
     incremental cost per unit of traffic they can actually absorb within
     the remaining error/delay budgets, with a full-coverage tie-breaker.
M3 — TP upgrade on active pairs (eq. 12): before activating a fresh pair,
     try a higher-parallelism configuration on an already-active pair,
     paying only the incremental GPU cost.

Vectorized engine notes
-----------------------
M1 winners are precomputed per instance (`Instance.cfg_m1`), M2 keys are
evaluated for all (j,k) at once (`rank_keys_all`), and the `State` carries
incremental aggregates — per-pair resident KV tokens (`kv_tok`), per-pair
compute load (`load`), and per-type storage (`stor_used`) — maintained by
`commit` / `remove_assignment` so that `max_commit` and the objective are
O(1) instead of O(I·J·K).  `commit` and `remove_assignment` optionally push
inverse records onto an undo list (`undo_all` rolls them back exactly),
which is what lets AGH's local search evaluate a move without copying the
solution.  The scalar seed implementations live in `_scalar_ref.py` and the
equivalence suite checks the two paths produce the same allocations.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .contracts import mutates
from .instance import KB_PER_GB, Instance


@dataclasses.dataclass
class State:
    """Running construction state (paper §4, 'Running state').

    Invariants maintained by `commit` / `remove_assignment` (and relied on
    by `max_commit` / `state_objective`):
      * kv_tok[j,k]   == sum_i kv_tok_per_x[i,j,k] * x[i,j,k]
      * load[j,k]     == sum_i load_per_x[i,j,k]   * x[i,j,k]
      * stor_used[i]  == sum_jk B[j]*z[i,j,k] + data_gb[i]*sum_jk x[i,j,k]
      * spend         == Delta_T*(sum p_c*y + p_s*(sum B*z + sum data_gb*x))
      * D_used[i]     == sum_jk D_cfg[i,j,k,cfg[j,k]] * x[i,j,k]  (over
                         active pairs), E_used likewise with e_bar
    up to float accumulation order (the equivalence tests allow 1e-9).
    """
    inst: Instance
    x: np.ndarray          # [I,J,K]
    y: np.ndarray          # [J,K]
    q: np.ndarray          # [J,K]
    cfg: np.ndarray        # [J,K] config index, -1 if inactive
    z: np.ndarray          # [I,J,K]
    r_rem: np.ndarray      # [I] remaining unserved fraction (tilde r)
    E_used: np.ndarray     # [I] cumulative error
    D_used: np.ndarray     # [I] cumulative delay
    spend: float           # committed budget $
    uncovered: set[int]    # I^unc
    kv_tok: np.ndarray     # [J,K] resident KV tokens routed to each pair
    load: np.ndarray       # [J,K] committed GFLOP load per pair
    stor_used: np.ndarray  # [I] storage GB committed per query type
    # Ablation switches (paper Table 3): subsets of
    # {"no_m1", "no_m2", "no_m3"}; used ONLY by the ablation benchmark.
    ablation: frozenset = frozenset()

    @staticmethod
    def fresh(inst: Instance, ablation: frozenset = frozenset()) -> "State":
        I, J, K = inst.I, inst.J, inst.K
        return State(inst=inst, x=np.zeros((I, J, K)), y=np.zeros((J, K)),
                     q=np.zeros((J, K)), cfg=-np.ones((J, K), dtype=int),
                     z=np.zeros((I, J, K)), r_rem=np.ones(I),
                     E_used=np.zeros(I), D_used=np.zeros(I), spend=0.0,
                     uncovered=set(range(I)), kv_tok=np.zeros((J, K)),
                     load=np.zeros((J, K)), stor_used=np.zeros(I),
                     ablation=ablation)


# ---------------------------------------------------------------------------
# M1
# ---------------------------------------------------------------------------

def m1_select(inst: Instance, i: int, j: int, k: int,
              ablation: frozenset = frozenset()) -> int | None:
    """Cheapest feasible config index for (i,j,k) per eq. (9), else None.

    O(1): the lex-(nm, delay, index)-minimal feasible config is precomputed
    per instance in `Instance.cfg_m1`."""
    if "no_m1" in ablation:
        # Cost-only: always "select" the cheapest config (nm = 1) without
        # the memory/delay filter (paper Table 3: memory violation).
        return inst.cfg_min_nm
    c = int(inst.cfg_m1[i, j, k])
    return None if c < 0 else c


# ---------------------------------------------------------------------------
# M3
# ---------------------------------------------------------------------------

def m3_upgrade(st: State, i: int, j: int, k: int) -> int | None:
    """Smallest config with nm > y_jk meeting the delay SLO within budget
    (eq. 12). Returns the config index or None.

    Candidate filtering is one mask over all configs; only the re-timing
    check walks the (nm, index)-sorted survivors, stopping at the first
    config that keeps every routed type within its SLO."""
    inst = st.inst
    y_cur = st.y[j, k]
    nm = inst.nm
    mask = ((nm > y_cur) & inst.mem_ok[j, k]
            & (inst.D_cfg[i, j, k] <= inst.Delta[i])
            & (st.spend + inst.Delta_T * inst.p_c[k] * (nm - y_cur)
               <= inst.delta))
    if inst.avail_gpus is not None:
        # Shared tier cap: the upgrade swaps this pair's y_cur for nm,
        # so the tier's total usage must stay within availability.
        used_k = float(st.y[:, k].sum())
        mask &= used_k - y_cur + nm <= inst.avail_gpus[k] + 1e-9
    if not mask.any():
        return None
    c_old = int(st.cfg[j, k])
    if c_old < 0:
        for c in inst.cfg_by_nm:
            if mask[c]:
                return int(c)
        return None
    x_col = st.x[:, j, k]
    routed = x_col > 1e-12
    for c in inst.cfg_by_nm:
        if not mask[c]:
            continue
        # Upgrading the pair's config re-times every type already routed to
        # it; require the new config to keep all of them within their SLO.
        d_new = st.D_used + (inst.D_cfg[:, j, k, c]
                             - inst.D_cfg[:, j, k, c_old]) * x_col
        if np.any(d_new[routed] > inst.Delta[routed] + 1e-9):
            continue
        return int(c)
    return None


# ---------------------------------------------------------------------------
# M2 (plus the constraint checks of GH Step 4)
# ---------------------------------------------------------------------------

def effective_coverage(st: State, i: int, j: int, k: int, c: int) -> float:
    """x̄ per eq. (11): min of remaining demand, error slack, delay slack."""
    inst = st.inst
    e = inst.e_bar[i, j, k]
    d = inst.D_cfg[i, j, k, c]
    err_cap = (inst.eps[i] - st.E_used[i]) / max(e, 1e-12)
    del_cap = (inst.Delta[i] - st.D_used[i]) / max(d, 1e-12)
    if "no_m3" in st.ablation:
        # Ablated variant routes on whatever parallelism exists, blind to
        # the accumulated delay (paper Table 3: delay violation).
        del_cap = st.r_rem[i]
    return float(min(st.r_rem[i], err_cap, del_cap))


def delay_sel(inst: Instance, i: int, c_arr: np.ndarray) -> np.ndarray:
    """[J,K] delay of type i at each pair's selected config (config 0's
    value where `c_arr` is -1; dead cells are the caller's problem).  A flat
    fancy gather through `D_cfg_flat` — same values as the take_along_axis
    it replaces at a fraction of the per-call cost."""
    cc = np.maximum(c_arr, 0)
    return inst.D_cfg_flat[i, inst.jk_idx, cc.ravel()].reshape(c_arr.shape)


def rank_keys_all(st: State, i: int, c_arr: np.ndarray,
                  d_sel: np.ndarray | None = None
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched M2 keys for type i over every (model, tier) pair at once.

    `c_arr[J,K]` holds the candidate config per pair (-1 where none);
    `d_sel` optionally passes the already-gathered per-pair delay.
    Returns `(pi, kappa, valid)` arrays [J,K]; sorting valid candidates by
    (pi, kappa) with a stable sort reproduces the scalar candidate scan's
    ordering, including its j-major/k-minor tie-breaking."""
    inst = st.inst
    cc = np.maximum(c_arr, 0)
    d = delay_sel(inst, i, c_arr) if d_sel is None else d_sel
    r_rem = float(st.r_rem[i])
    err_cap = (inst.eps[i] - st.E_used[i]) / inst.e_bar_floor[i]
    del_cap = (inst.Delta[i] - st.D_used[i]) / np.maximum(d, 1e-12)
    if "no_m3" in st.ablation:
        del_cap = np.full_like(d, r_rem)
    xbar = np.minimum(np.minimum(r_rem, err_cap), del_cap)
    inc_gpus = np.maximum(0.0, inst.nm[cc] - st.y)
    cost = (inst.Delta_T * (inst.p_c[None, :] * inc_gpus
                            + inst.p_s * (inst.B[:, None] + inst.data_gb[i]))
            + inst.rho[i] * d * 1e3)
    live = xbar > 1e-9
    valid = (c_arr >= 0) & live
    if "no_m2" in st.ablation:
        # Raw-cost ranking, no effective-coverage normalization, no
        # full-coverage tie-breaker (paper Table 3: ~+50% cost).
        pi = np.zeros(c_arr.shape, dtype=np.int64)
        kappa = cost
    else:
        pi = (xbar < r_rem - 1e-9).astype(np.int64)
        kappa = np.divide(cost, xbar, out=np.full_like(cost, np.inf),
                          where=live)
    return pi, kappa, valid


# ---------------------------------------------------------------------------
# Commit machinery (GH Phase-2 Step 4): verify (8f)-(8h) + budget, commit.
# ---------------------------------------------------------------------------

def max_commit(st: State, i: int, j: int, k: int, c: int,
               over: tuple | None = None) -> float:
    """Largest additional fraction of type-i traffic committable to (j,k)
    at config c without violating (8f) memory, (8g) compute, (8h) storage,
    or the budget (8c).  O(1): reads the State's incremental aggregates.

    `over` optionally substitutes the type-local scalars
    ``(r_rem_i, E_used_i, D_used_i, stor_used_i, spend)`` — see
    `max_commit_batch`; the arithmetic below is `effective_coverage` plus
    the cap chain on those values, bit-identical to the plain path when
    `over` carries the state's own scalars."""
    inst = st.inst
    nm = float(inst.nm[c])
    if over is None:
        cap = effective_coverage(st, i, j, k, c)
        stor_i = st.stor_used[i]
        spend = st.spend
    else:
        rr_i, e_i, d_i, stor_i, spend = over
        e = inst.e_bar[i, j, k]
        d = inst.D_cfg[i, j, k, c]
        err_cap = (inst.eps[i] - e_i) / max(e, 1e-12)
        del_cap = (inst.Delta[i] - d_i) / max(d, 1e-12)
        if "no_m3" in st.ablation:
            del_cap = rr_i
        cap = float(min(rr_i, err_cap, del_cap))
    # (8f): per-device memory headroom -> token budget -> x budget.
    if "no_m1" in st.ablation:
        pass  # ablated: commit blindly past the memory budget
    elif inst.kv_applicable[j]:
        head_gb = inst.C_gpu[k] - inst.B_eff[j, k] / nm \
            - (inst.beta[j] / KB_PER_GB) / nm * st.kv_tok[j, k]
        per_x = (inst.beta[j] / KB_PER_GB) / nm * inst.kv_tok_per_x[i, j, k]
        if per_x > 1e-18:
            cap = min(cap, head_gb / per_x)
        elif head_gb < 0:
            return 0.0
    else:
        if inst.C_gpu[k] - inst.B_eff[j, k] / nm < 0:
            return 0.0
    # (8g): compute headroom of the y GPUs this config provides.
    comp_cap = inst.eta * 3600.0 * inst.P_gpu[k] * nm
    per_x = inst.load_per_x[i, j, k]
    if per_x > 1e-18:
        cap = min(cap, (comp_cap - st.load[j, k]) / per_x)
    # (8h): storage headroom for type i.
    new_weight = inst.B[j] if st.z[i, j, k] < 0.5 else 0.0
    per_x = inst.data_gb[i]
    if per_x > 1e-18:
        cap = min(cap, (inst.C_s - stor_i - new_weight) / per_x)
    # budget (8c): incremental rental + data storage per unit x.
    inc_gpus = max(0.0, inst.nm[c] - st.y[j, k])
    if (inst.avail_gpus is not None and inc_gpus > 0.0
            and st.y[:, k].sum() + inc_gpus > inst.avail_gpus[k] + 1e-9):
        return 0.0   # tier availability cap: the extra devices don't exist
    fixed = inst.Delta_T * (inst.p_c[k] * inc_gpus
                            + (inst.p_s * inst.B[j] if st.z[i, j, k] < 0.5 else 0.0))
    per_x = inst.budget_per_x[i]
    if spend + fixed > inst.delta:
        return 0.0
    if per_x > 1e-18:
        cap = min(cap, (inst.delta - spend - fixed) / per_x)
    return max(0.0, float(cap))


def max_commit_batch(st: State, i: int, c_arr: np.ndarray,
                     d_sel: np.ndarray | None = None,
                     over: tuple | None = None) -> np.ndarray:
    """`max_commit` for type i over every (j,k) pair at once.

    `c_arr[J,K]` gives the config per pair (-1 -> cap 0).  Pure in the
    state, so one batched evaluation replaces a row of scalar calls as long
    as no commit happens in between — used by the batched relocate /
    consolidation destination scans.  `d_sel` optionally passes the
    already-gathered per-pair delay (`delay_sel`) so callers that need it
    anyway don't pay the gather twice.  Elementwise arithmetic mirrors
    `max_commit` exactly.

    `over` optionally substitutes the type-local scalars
    ``(r_rem_i, E_used_i, D_used_i, stor_used_i, spend)`` — the relocate
    screen passes the source-removed values computed in closed form (same
    float ops `remove_assignment` would apply, so the caps equal a real
    remove → batch → undo round trip bitwise on every non-source cell)
    without mutating the state.
    """
    inst = st.inst
    if over is None:
        rr_i = float(st.r_rem[i])
        e_i = st.E_used[i]
        d_i = st.D_used[i]
        stor_i = st.stor_used[i]
        spend = st.spend
    else:
        rr_i, e_i, d_i, stor_i, spend = over
    cc = np.maximum(c_arr, 0)
    nm = inst.nm[cc]
    d = delay_sel(inst, i, c_arr) if d_sel is None else d_sel
    err_cap = (inst.eps[i] - e_i) / inst.e_bar_floor[i]
    del_cap = (inst.Delta[i] - d_i) / np.maximum(d, 1e-12)
    if "no_m3" in st.ablation:
        del_cap = np.full_like(d, rr_i)
    cap = np.minimum(np.minimum(rr_i, err_cap), del_cap)
    dead = c_arr < 0
    zm = st.z[i] < 0.5
    with np.errstate(divide="ignore", invalid="ignore"):
        # (8f)
        if "no_m1" not in st.ablation:
            b_dev = inst.B_eff / nm
            kvd = inst.kv_gb_per_tok[:, None] / nm
            head_gb = inst.C_gpu[None, :] - b_dev - kvd * st.kv_tok
            per_x = kvd * inst.kv_tok_per_x[i]
            kv = inst.kv_applicable[:, None]
            has_px = per_x > 1e-18
            # Unguarded divide: per_x == 0 cells produce inf/nan but are
            # never selected by the mask (errstate silences the warning).
            cap = np.where(kv & has_px, np.minimum(cap, head_gb / per_x),
                           cap)
            dead |= kv & ~has_px & (head_gb < 0)
            dead |= ~kv & (inst.C_gpu[None, :] - b_dev < 0)
        # (8g)
        per_x = inst.load_per_x[i]
        has_px = per_x > 1e-18
        cap = np.where(has_px,
                       np.minimum(cap, (inst.comp_cap_coef[None, :] * nm
                                        - st.load) / per_x),
                       cap)
        # (8h)
        new_weight = np.where(zm, inst.B[:, None], 0.0)
        if inst.data_gb[i] > 1e-18:
            cap = np.minimum(cap, (inst.C_s - stor_i - new_weight)
                             / inst.data_gb[i])
        # budget (8c)
        inc_gpus = np.maximum(0.0, nm - st.y)
        if inst.avail_gpus is not None:
            # tier availability: extra devices beyond the cap don't exist
            tier_used = st.y.sum(axis=0)
            dead |= (inc_gpus > 0) & (tier_used[None, :] + inc_gpus
                                      > inst.avail_gpus[None, :] + 1e-9)
        fixed = inst.Delta_T * (inst.p_c[None, :] * inc_gpus
                                + np.where(zm, inst.p_s_B[:, None], 0.0))
        dead |= spend + fixed > inst.delta
        if inst.budget_per_x[i] > 1e-18:
            cap = np.minimum(cap, (inst.delta - spend - fixed)
                             / inst.budget_per_x[i])
    return np.where(dead, 0.0, np.maximum(0.0, cap))


def max_commit_cells(st: State, i: int, cells: np.ndarray,
                     c_cells: np.ndarray, d_cells: np.ndarray,
                     over: tuple | None = None) -> np.ndarray:
    """`max_commit_batch` on a compressed 1-D list of flat (j,k) cells.

    The pure relocate scan's improvement filter usually leaves a handful
    of candidate destinations; evaluating their (8c)-(8h) caps on [n]
    gathered vectors costs a flat ~25 small-array ops instead of the full
    [J,K] grid pass.  Elementwise arithmetic mirrors `max_commit_batch`
    cell for cell (same ops on the same values — no reductions — so the
    results are bitwise identical to the grid pass at those cells).
    `c_cells`/`d_cells` are the candidate configs and delays at `cells`;
    all cells must hold valid configs (>= 0).  `over` as in
    `max_commit_batch`."""
    inst = st.inst
    if over is None:
        rr_i = float(st.r_rem[i])
        e_i = st.E_used[i]
        d_i = st.D_used[i]
        stor_i = st.stor_used[i]
        spend = st.spend
    else:
        rr_i, e_i, d_i, stor_i, spend = over
    K = inst.K
    jj = cells // K
    kk = cells - jj * K
    nm = inst.nm[c_cells]
    err_cap = (inst.eps[i] - e_i) / inst.e_bar_floor_flat[i][cells]
    del_cap = (inst.Delta[i] - d_i) / np.maximum(d_cells, 1e-12)
    if "no_m3" in st.ablation:
        del_cap = np.full_like(d_cells, rr_i)
    cap = np.minimum(np.minimum(rr_i, err_cap), del_cap)
    dead = np.zeros(cells.shape, dtype=bool)
    zm = st.z[i].reshape(-1)[cells] < 0.5
    kv_tok = st.kv_tok.reshape(-1)[cells]
    load = st.load.reshape(-1)[cells]
    y = st.y.reshape(-1)[cells]
    with np.errstate(divide="ignore", invalid="ignore"):
        # (8f)
        if "no_m1" not in st.ablation:
            b_dev = inst.B_eff_flat[cells] / nm
            kvd = inst.kv_gb_per_tok[jj] / nm
            head_gb = inst.C_gpu[kk] - b_dev - kvd * kv_tok
            per_x = kvd * inst.kv_tok_per_x_flat[i][cells]
            kv = inst.kv_applicable[jj]
            has_px = per_x > 1e-18
            cap = np.where(kv & has_px, np.minimum(cap, head_gb / per_x),
                           cap)
            dead |= kv & ~has_px & (head_gb < 0)
            dead |= ~kv & (inst.C_gpu[kk] - b_dev < 0)
        # (8g)
        per_x = inst.load_per_x_flat[i][cells]
        has_px = per_x > 1e-18
        cap = np.where(has_px,
                       np.minimum(cap, (inst.comp_cap_coef[kk] * nm
                                        - load) / per_x),
                       cap)
        # (8h)
        new_weight = np.where(zm, inst.B[jj], 0.0)
        if inst.data_gb[i] > 1e-18:
            cap = np.minimum(cap, (inst.C_s - stor_i - new_weight)
                             / inst.data_gb[i])
        # budget (8c)
        inc_gpus = np.maximum(0.0, nm - y)
        if inst.avail_gpus is not None:
            tier_used = st.y.sum(axis=0)
            dead |= (inc_gpus > 0) & (tier_used[kk] + inc_gpus
                                      > inst.avail_gpus[kk] + 1e-9)
        fixed = inst.Delta_T * (inst.p_c[kk] * inc_gpus
                                + np.where(zm, inst.p_s_B[jj], 0.0))
        dead |= spend + fixed > inst.delta
        if inst.budget_per_x[i] > 1e-18:
            cap = np.minimum(cap, (inst.delta - spend - fixed)
                             / inst.budget_per_x[i])
    return np.where(dead, 0.0, np.maximum(0.0, cap))


class DestCache:
    """Amortized destination scoring tensors for the incremental engine.

    `score_moves_batch` derives four [J,K] destination matrices per scan —
    candidate config, delay at that config, delay/M1 admissibility, and
    incremental rental — from the per-instance M1 tensors with the active
    cells overwritten.  Those matrices depend only on each pair's selected
    config (`st.cfg`; >= 0 iff the pair is active), not on the source cell
    being scanned, so the cache holds them as stacked [I,J,K] tensors:
    each type's rows are materialized lazily on first scan (one build per
    type per local search instead of four copies per scan), and `sync`
    refreshes only the columns whose config changed since the last call —
    one [J,K] int compare plus O(I) per touched cell.  Cell values are
    computed by the same expressions as the uncached path, so cached scans
    are bit-identical to uncached ones (pinned by the oracle tests).

    `rows` must be called while the state's `cfg` is consistent (i.e. not
    between a scan's internal remove/undo pair); `score_moves_batch` syncs
    before detaching the source.
    """

    def __init__(self, st: State):
        inst = st.inst
        I, J, K = inst.I, inst.J, inst.K
        self.inst = inst
        self.cfg_seen = st.cfg.copy()
        self.c_dest = np.empty((I, J, K), dtype=inst.cfg_m1.dtype)
        self.d_sel = np.empty((I, J, K))
        self.ok = np.empty((I, J, K), dtype=bool)
        self.rental = np.empty((I, J, K))
        # Static destination cost: Delta_T * (incremental rental + the
        # first-admission weight-storage term) — the destination delta
        # minus its frac-scaled parts, so the scan's improvement filter is
        # two array ops.  Depends on cfg (rental) AND on the type's own
        # admission row z[i] — `invalidate_type` flags the latter.
        self.dcost = np.empty((I, J, K))
        self.built = [False] * I
        self.zbuilt = [False] * I
        # Shared all-dead result arrays for the (dominant) no-candidate
        # return — read-only so an aliasing caller cannot corrupt them.
        self.caps0 = np.zeros((J, K))
        self.caps0.setflags(write=False)
        self.adm0 = np.zeros((J, K), dtype=bool)
        self.adm0.setflags(write=False)
        self.inf0 = np.full((J, K), np.inf)
        self.inf0.setflags(write=False)
        # Every cfg change during local search is part of an applied move
        # or drain, which must call `invalidate_type` — that sets this
        # flag, and `rows` only diffs cfg_seen while it is up.
        self.cfg_dirty = False

    @mutates("zbuilt", "cfg_dirty")
    def invalidate_type(self, i: int) -> None:
        """Notify the cache of an applied move/drain placement of type i:
        its admission row z[i] changed (static-cost row rebuilds on next
        use) and the move may have activated/deactivated pairs (cfg diff
        re-enabled)."""
        self.zbuilt[i] = False
        self.cfg_dirty = True

    @mutates("c_dest", "d_sel", "ok", "rental", "dcost", "cfg_seen")
    def _sync(self, st: State) -> None:
        changed = np.flatnonzero(st.cfg != self.cfg_seen)
        if changed.size == 0:
            return
        inst = self.inst
        K = st.cfg.shape[1]
        # Column updates are vectorized over all I rows; rows not yet
        # built get overwritten at build time anyway.  dcost columns use
        # the live z column — exactly what a row rebuild would read.
        for f in changed:
            j, k = int(f) // K, int(f) % K
            c = int(st.cfg[j, k])
            if c >= 0:
                d = inst.D_cfg[:, j, k, c]
                self.c_dest[:, j, k] = c
                self.d_sel[:, j, k] = d
                self.ok[:, j, k] = d <= inst.Delta
                self.rental[:, j, k] = 0.0
                self.dcost[:, j, k] = inst.Delta_T * np.where(
                    st.z[:, j, k] < 0.5, inst.p_s_B[j], 0.0)
            else:
                self.c_dest[:, j, k] = inst.cfg_m1[:, j, k]
                self.d_sel[:, j, k] = inst.m1_delay[:, j, k]
                self.ok[:, j, k] = inst.m1_feasible[:, j, k]
                self.rental[:, j, k] = inst.m1_rental[:, j, k]
                self.dcost[:, j, k] = inst.Delta_T * (
                    inst.m1_rental[:, j, k]
                    + np.where(st.z[:, j, k] < 0.5, inst.p_s_B[j], 0.0))
            self.cfg_seen[j, k] = c

    @mutates("cfg_dirty", "c_dest", "d_sel", "ok", "rental", "dcost",
             "built", "zbuilt")
    def rows(self, st: State, i: int):
        """Synced (c_dest, d_sel, ok, rental, dcost) rows for type i
        (built on first use).  The returned arrays are cache-owned views —
        callers must not mutate them."""
        if self.cfg_dirty:
            self._sync(st)
            self.cfg_dirty = False
        if not self.built[i]:
            inst = self.inst
            jj, kk = np.nonzero(self.cfg_seen >= 0)
            c_act = self.cfg_seen[jj, kk]
            d_act = inst.D_cfg[i, jj, kk, c_act]
            self.c_dest[i] = inst.cfg_m1[i]
            self.c_dest[i, jj, kk] = c_act
            self.d_sel[i] = inst.m1_delay[i]
            self.d_sel[i, jj, kk] = d_act
            self.ok[i] = inst.m1_feasible[i]
            self.ok[i, jj, kk] = d_act <= inst.Delta[i]
            self.rental[i] = inst.m1_rental[i]
            self.rental[i, jj, kk] = 0.0
            self.built[i] = True
            self.zbuilt[i] = False
        if not self.zbuilt[i]:
            inst = self.inst
            self.dcost[i] = inst.Delta_T * (
                self.rental[i] + np.where(st.z[i] < 0.5,
                                          inst.p_s_B[:, None], 0.0))
            self.zbuilt[i] = True
        return (self.c_dest[i], self.d_sel[i], self.ok[i], self.rental[i],
                self.dcost[i])


@dataclasses.dataclass
class RemovalTerms:
    """Closed-form scalars of detaching ALL of x[i,j,k] from its pair.

    Mirrors `remove_assignment` (+ `deactivate_pair` when the source is
    the pair's last traffic) term by term, in the same float op order, so
    `over` equals a real remove → score → undo round trip bitwise on
    every non-source cell.  Shared by `score_moves_batch`'s pure scan
    path and the XLA engine's batched relocate screen — the two consumers
    must agree on these scalars exactly, which is why they are computed
    in one place."""
    frac: float           # removed fraction (= x[i,j,k])
    data: float           # data_gb[i] * frac
    d_src: float          # per-unit delay at the source pair's config
    gain: float           # objective decrease of the bare removal
    deact: bool           # removal empties the pair (deactivation refund)
    over: tuple           # (r_rem, E_used, D_used, stor_used, spend) after


def removal_terms(st: State, i: int, j: int, k: int) -> RemovalTerms:
    """Source-removal scalars for relocating all of x[i,j,k]; see
    `RemovalTerms`.  Pure — the state is never touched."""
    inst = st.inst
    frac = float(st.x[i, j, k])
    c_src = int(st.cfg[j, k])
    had_z = bool(st.z[i, j, k] > 0.5)
    data = inst.data_gb[i] * frac
    weight = inst.B[j] if had_z else 0.0
    d_src = inst.D_cfg[i, j, k, c_src]
    gain = (inst.Delta_T * inst.p_s * (data + weight)
            + inst.rho[i] * d_src * 1e3 * frac)
    deact = float(st.x[:, j, k].sum()) - frac <= 1e-12
    n_oth = 0
    if deact:
        n_oth = int(np.count_nonzero(st.z[:, j, k] > 0.5))
        if had_z:
            n_oth -= 1
        gain += inst.Delta_T * (inst.p_s * inst.B[j] * n_oth
                                + inst.p_c[k] * float(st.y[j, k]))
    # Source-removed scalars, in `remove_assignment`'s own op order,
    # so the caps equal a real remove -> score -> undo round trip.
    rr2 = float(st.r_rem[i]) + frac
    e2 = st.E_used[i] - inst.e_bar[i, j, k] * frac
    d2 = st.D_used[i] - d_src * frac
    stor2 = st.stor_used[i] - (data + weight)
    sp2 = st.spend - inst.Delta_T * inst.p_s * (data + weight)
    if deact:
        if n_oth:
            sp2 -= inst.Delta_T * inst.p_s * inst.B[j] * n_oth
        sp2 -= inst.Delta_T * inst.p_c[k] * float(st.y[j, k])
    return RemovalTerms(frac=frac, data=data, d_src=d_src, gain=gain,
                        deact=deact, over=(rr2, e2, d2, stor2, sp2))


@dataclasses.dataclass
class MoveScores:
    """Scored relocate destinations for one (i, j, k) source cell.

    Produced by `score_moves_batch`; `obj_after[j2,k2]` is the objective of
    the solution after moving the full fraction to (j2,k2) (`inf` where the
    move is inadmissible), `caps` the destination's (8c)-(8h) commit cap,
    `c_dest` the config the move would commit at, and `obj_removed` the
    objective of the intermediate source-removed state.

    The pure path (`cache` + `improve_below`) is *lazy*: cap verification
    stops at the best admissible destination, so `admissible` marks only
    that cell (the exact argmin of the full scan's admissible set — see
    the best-first argument in the source) and `caps` is populated only
    there; `obj_removed` is the closed-form value, accurate to float
    reassociation.  The exhaustive grids come from the non-lazy paths."""
    i: int
    j: int
    k: int
    frac: float
    c_dest: np.ndarray      # [J,K]
    caps: np.ndarray        # [J,K]
    admissible: np.ndarray  # [J,K] bool
    obj_after: np.ndarray   # [J,K]
    obj_removed: float


def score_moves_batch(st: State, i: int, j: int, k: int,
                      improve_below: float | None = None,
                      cache: DestCache | None = None,
                      obj_cur: float | None = None) -> MoveScores:
    """Score moving all of x[i,j,k] to every destination (j2,k2) at once.

    One pass replaces the scalar probe-per-destination loop: config
    selection (active pairs route at their current config, inactive pairs
    at the M1 winner), the delay/M1 admissibility masks, one
    `max_commit_batch` cap evaluation, and the vectorized delta objective
    of `commit_delta_batch`.  Admissibility and caps agree with sequential
    `_try_move` probing cell-for-cell (pinned by the property suite); the
    state is restored exactly before returning.

    With `improve_below`, destinations whose post-move objective is not
    strictly under the bound are filtered from `admissible` *before* the
    cap evaluation — the scan's fast path: a converged source pays only
    the delta arithmetic (caps stay zero, `obj_after` stays inf) and the
    expensive (8c)-(8h) pass runs only when an improving candidate exists.

    With `cache` (a `DestCache`) and `improve_below` together, the scan is
    *pure* — the state is never touched.  The destination matrices come
    from the cache's lazily built, diff-synced per-type rows (same cell
    values bit-for-bit as the uncached rebuild); the source-removed
    objective is derived in closed form (the removal's refunds mirror
    `remove_assignment` + `deactivate_pair` term by term, accurate to
    float reassociation, ~1e-12 at objective scale); and the commit caps
    come from `max_commit_batch` with the source-removed type scalars
    passed as overrides — the same float ops a real removal would apply,
    so the caps equal the remove → score → undo protocol bitwise on every
    non-source cell.  `obj_cur` optionally passes the caller's current
    objective so the sweep loop's value is reused instead of recomputed.
    """
    inst = st.inst
    if cache is not None and improve_below is not None:
        c_dest, d_sel, ok_c, rental, dcost = cache.rows(st, i)
        # Removal gain in closed form: refunded data storage, weight
        # storage on first-admission drop, routed delay — plus the rental
        # and stranded-admission refunds of `deactivate_pair` when the
        # source is the pair's last traffic.  The removal's unmet-penalty
        # increase (phi * frac exactly, since r_rem >= 0 invariantly)
        # cancels against the destination's `d_unmet` term, so obj_after
        # reduces to obj_cur - gain + the destination delta.
        rt = removal_terms(st, i, j, k)
        frac, gain = rt.frac, rt.gain
        if obj_cur is None:
            obj_cur = state_objective(st)
        obj0 = obj_cur - gain + inst.Delta_T * inst.phi[i] * frac
        # Improvement filter in two array ops: the frac-scaled delay term
        # plus the cached static destination cost against a folded bound.
        dyn = float(inst.rho[i]) * 1e3 * frac
        base = obj_cur - gain + inst.Delta_T * (inst.p_s * rt.data)
        delta = dcost + dyn * d_sel
        ok = ok_c & (delta < improve_below - base)
        ok[j, k] = False
        cells = np.flatnonzero(ok.reshape(-1))
        if cells.size == 0:
            return MoveScores(i=i, j=j, k=k, frac=frac, c_dest=c_dest,
                              caps=cache.caps0, admissible=cache.adm0,
                              obj_after=cache.inf0, obj_removed=obj0)
        over = rt.over
        rr2, e2, d2 = over[0], over[1], over[2]
        # Cap upper bound on the surviving cells: `max_commit`'s chain
        # starts from min(r_rem, err_cap, del_cap) and the (8g) compute
        # term and only min()s further, so any cell whose bound is already
        # under `frac` is dead — killing it here cannot change the scan's
        # outcome, and most improving-but-undercap candidates die on
        # these four cheap compressed-vector terms.
        d_cells0 = d_sel.reshape(-1)[cells]
        ub = np.minimum((inst.eps[i] - e2) / inst.e_bar_floor_flat[i][cells],
                        (inst.Delta[i] - d2) / np.maximum(d_cells0, 1e-12))
        if "no_m3" in st.ablation:
            ub = np.full_like(d_cells0, rr2)
        ub = np.minimum(rr2, ub)
        per_x = inst.load_per_x_flat[i][cells]
        with np.errstate(divide="ignore", invalid="ignore"):
            kk_c = cells % inst.K
            nm_c = inst.nm[c_dest.reshape(-1)[cells]]
            gcap = (inst.comp_cap_coef[kk_c] * nm_c
                    - st.load.reshape(-1)[cells]) / per_x
        ub = np.where(per_x > 1e-18, np.minimum(ub, gcap), ub)
        alive = ub >= frac - 1e-9
        if not alive.all():
            cells = cells[alive]
            if cells.size == 0:
                return MoveScores(i=i, j=j, k=k, frac=frac, c_dest=c_dest,
                                  caps=cache.caps0, admissible=cache.adm0,
                                  obj_after=cache.inf0, obj_removed=obj0)
        # Best-first cap verification: obj_after is `delta` plus a
        # constant, so walking candidates in ascending-delta order (stable
        # — flat-index ties keep the grid argmin's j-major order) and
        # stopping at the first one whose cap fits selects exactly the
        # argmin of obj_after over the admissible set, at the cost of a
        # few O(1) cap checks instead of a full cap pass.  Long undercap
        # runs fall back to one vectorized pass over the remaining cells.
        d_cells = delta.reshape(-1)[cells]
        cap_order = np.argsort(d_cells, kind="stable")
        found = -1
        cap_found = 0.0
        n_try = min(cap_order.size, 8)
        for t in range(n_try):
            f = int(cells[cap_order[t]])
            j2, k2 = f // inst.K, f % inst.K
            cap = max_commit(st, i, j2, k2, int(c_dest[j2, k2]), over=over)
            if cap >= frac - 1e-9:
                found, cap_found = f, cap
                break
        if found < 0 and cap_order.size > n_try:
            rest = cells[cap_order[n_try:]]
            caps_r = max_commit_cells(st, i, rest,
                                      c_dest.reshape(-1)[rest],
                                      d_sel.reshape(-1)[rest], over=over)
            hits = np.flatnonzero(caps_r >= frac - 1e-9)
            if hits.size:
                found = int(rest[hits[0]])
                cap_found = float(caps_r[hits[0]])
        if found < 0:
            return MoveScores(i=i, j=j, k=k, frac=frac, c_dest=c_dest,
                              caps=cache.caps0, admissible=cache.adm0,
                              obj_after=cache.inf0, obj_removed=obj0)
        caps = np.zeros_like(d_sel)
        caps.reshape(-1)[found] = cap_found
        adm = np.zeros(ok.shape, dtype=bool)
        adm.reshape(-1)[found] = True
        obj_after = np.full_like(d_sel, np.inf)
        obj_after.reshape(-1)[found] = delta.reshape(-1)[found] + base
        return MoveScores(i=i, j=j, k=k, frac=frac, c_dest=c_dest,
                          caps=caps, admissible=adm, obj_after=obj_after,
                          obj_removed=obj0)
    if cache is not None:
        # Rows are read on the pre-detach state: the removal below may
        # deactivate the source pair, and that transient must not enter
        # the cache.  The only cell where the rows can then disagree with
        # the detached state is the source itself, which the
        # `ok[j, k] = False` exclusion masks either way.
        c_dest, d_sel, ok_c, rental, _ = cache.rows(st, i)
    undo: list = []
    frac = remove_assignment(st, i, j, k, undo=undo)
    if cache is None:
        # Destination configs/delays: the precomputed M1 winner everywhere,
        # overwritten on the (few) active cells with the pair's own config.
        jj, kk = np.nonzero(st.q > 0.5)
        c_act = st.cfg[jj, kk]
        c_dest = inst.cfg_m1[i].copy()
        c_dest[jj, kk] = c_act
        d_sel = inst.m1_delay[i].copy()
        d_act = inst.D_cfg[i, jj, kk, c_act]
        d_sel[jj, kk] = d_act
        ok = inst.m1_feasible[i].copy()
        ok[jj, kk] = d_act <= inst.Delta[i]
        rental = inst.m1_rental[i].copy()
        rental[jj, kk] = 0.0
    else:
        ok = ok_c.copy()
    ok[j, k] = False
    obj0 = state_objective(st)
    # Delta objective of committing `frac` at each destination, mirroring
    # `commit` + `state_objective`: incremental rental (active pairs run at
    # their own config, so only fresh activations rent GPUs — the
    # precomputed M1 rental with active cells zeroed), first-admission
    # model storage, per-fraction data storage, routed delay, and the
    # absorbed unmet penalty (a destination-independent scalar).
    rr = float(st.r_rem[i])
    d_unmet = max(rr - frac, 0.0) - max(rr, 0.0)
    obj_after = (obj0 + inst.Delta_T * inst.phi[i] * d_unmet
                 + inst.Delta_T * (rental
                                   + np.where(st.z[i] < 0.5,
                                              inst.p_s_B[:, None], 0.0)
                                   + inst.p_s * inst.data_gb[i] * frac)
                 + inst.rho[i] * d_sel * 1e3 * frac)
    if improve_below is not None:
        ok &= obj_after < improve_below
        n_ok = int(np.count_nonzero(ok))
        if n_ok == 0:
            undo_all(st, undo)
            return MoveScores(i=i, j=j, k=k, frac=frac, c_dest=c_dest,
                              caps=np.zeros_like(d_sel), admissible=ok,
                              obj_after=np.full_like(d_sel, np.inf),
                              obj_removed=obj0)
        if n_ok <= 6:
            # Few surviving candidates: O(1) scalar caps (identical
            # arithmetic) beat the full-grid batch pass.
            caps = np.zeros_like(d_sel)
            K = c_dest.shape[1]
            for f in np.flatnonzero(ok.ravel()):
                j2, k2 = int(f) // K, int(f) % K
                caps[j2, k2] = max_commit(st, i, j2, k2,
                                          int(c_dest[j2, k2]))
            adm = ok & (caps >= frac - 1e-9)
            obj_after = np.where(adm, obj_after, np.inf)
            undo_all(st, undo)
            return MoveScores(i=i, j=j, k=k, frac=frac, c_dest=c_dest,
                              caps=caps, admissible=adm,
                              obj_after=obj_after, obj_removed=obj0)
    caps = max_commit_batch(st, i, np.where(ok, c_dest, -1), d_sel=d_sel)
    adm = ok & (caps >= frac - 1e-9)
    obj_after = np.where(adm, obj_after, np.inf)
    undo_all(st, undo)
    return MoveScores(i=i, j=j, k=k, frac=frac, c_dest=c_dest, caps=caps,
                      admissible=adm, obj_after=obj_after, obj_removed=obj0)


@mutates("x", "z", "q", "cfg", "y", "r_rem", "E_used", "D_used", "spend",
         "kv_tok", "load", "stor_used", "uncovered")
def commit(st: State, i: int, j: int, k: int, c: int, frac: float,
           undo: list | None = None) -> None:
    """Apply an accepted assignment to the running state, maintaining every
    incremental aggregate.  When `undo` is given, push a record that
    `undo_all` restores exactly (bitwise)."""
    inst = st.inst
    if frac <= 0:
        return
    c_old = int(st.cfg[j, k])
    retime = c_old >= 0 and c_old != c
    if undo is not None:
        undo.append((
            "commit", i, j, k,
            float(st.x[i, j, k]), float(st.z[i, j, k]), float(st.q[j, k]),
            c_old, float(st.y[j, k]), float(st.r_rem[i]),
            float(st.E_used[i]), float(st.D_used[i]), st.spend,
            float(st.kv_tok[j, k]), float(st.load[j, k]),
            float(st.stor_used[i]),
            st.D_used.copy() if retime else None,
            i in st.uncovered))
    nm = int(inst.nm[c])
    inc_gpus = max(0, nm - int(st.y[j, k]))
    new_adm = st.z[i, j, k] < 0.5
    if retime:
        # Config change re-times previously routed traffic on this pair.
        x_col = st.x[:, j, k]
        st.D_used += np.where(
            x_col > 1e-12,
            (inst.D_cfg[:, j, k, c] - inst.D_cfg[:, j, k, c_old]) * x_col,
            0.0)
    st.x[i, j, k] += frac
    st.z[i, j, k] = 1.0
    st.q[j, k] = 1.0
    st.cfg[j, k] = c
    st.y[j, k] = nm
    st.r_rem[i] = max(0.0, st.r_rem[i] - frac)
    st.E_used[i] += inst.e_bar[i, j, k] * frac
    st.D_used[i] += inst.D_cfg[i, j, k, c] * frac
    st.kv_tok[j, k] += inst.kv_tok_per_x[i, j, k] * frac
    st.load[j, k] += inst.load_per_x[i, j, k] * frac
    st.stor_used[i] += (inst.B[j] if new_adm else 0.0) + inst.data_gb[i] * frac
    st.spend += inst.Delta_T * (
        inst.p_c[k] * inc_gpus
        + (inst.p_s * inst.B[j] if new_adm else 0.0)
        + inst.p_s * inst.data_gb[i] * frac)
    st.uncovered.discard(i)


@mutates("x", "z", "r_rem", "E_used", "D_used", "spend", "kv_tok", "load",
         "stor_used")
def remove_assignment(st: State, i: int, j: int, k: int,
                      undo: list | None = None, timed: bool = True,
                      auto_deactivate: bool = True) -> float:
    """Inverse delta of `commit`: take type i entirely off pair (j,k).

    Zeroes x/z for the cell and rolls every aggregate back by the removed
    fraction.  With `auto_deactivate`, a pair left without traffic is shut
    down (y/q/cfg cleared, all admissions on it dropped) — the relocate
    move's source-side semantics.  `timed=False` skips the D_used
    subtraction for pairs whose delay contribution was already suspended
    (consolidation).  Returns the removed fraction."""
    inst = st.inst
    frac = float(st.x[i, j, k])
    had_z = st.z[i, j, k] > 0.5
    c_jk = int(st.cfg[j, k])
    st.x[i, j, k] = 0.0
    deact = auto_deactivate and float(st.x[:, j, k].sum()) <= 1e-12
    if undo is not None:
        undo.append((
            "remove", i, j, k, frac, had_z, deact, c_jk,
            float(st.q[j, k]), float(st.y[j, k]),
            float(st.r_rem[i]), float(st.E_used[i]), float(st.D_used[i]),
            st.spend, float(st.kv_tok[j, k]), float(st.load[j, k]),
            st.stor_used.copy() if deact else float(st.stor_used[i]),
            st.z[:, j, k].copy() if deact else None))
    st.z[i, j, k] = 0.0
    st.r_rem[i] = st.r_rem[i] + frac
    st.E_used[i] -= inst.e_bar[i, j, k] * frac
    if timed and c_jk >= 0:
        st.D_used[i] -= inst.D_cfg[i, j, k, c_jk] * frac
    st.kv_tok[j, k] -= inst.kv_tok_per_x[i, j, k] * frac
    st.load[j, k] -= inst.load_per_x[i, j, k] * frac
    data = inst.data_gb[i] * frac
    weight = inst.B[j] if had_z else 0.0
    st.stor_used[i] -= data + weight
    st.spend -= inst.Delta_T * inst.p_s * (data + weight)
    if deact:
        deactivate_pair(st, j, k)
    return frac


@mutates("z", "q", "y", "cfg", "spend", "stor_used")
def deactivate_pair(st: State, j: int, k: int,
                    undo: list | None = None) -> None:
    """Shut pair (j,k) down: drop every remaining admission on it (model
    storage spend + per-type storage), refund the rental, clear y/q/cfg.
    With `undo`, push a record `undo_all` restores exactly; otherwise
    callers own the rollback (enclosing undo record or snapshot)."""
    inst = st.inst
    if undo is not None:
        undo.append(("deact", j, k, float(st.q[j, k]), float(st.y[j, k]),
                     int(st.cfg[j, k]), st.spend, st.z[:, j, k].copy(),
                     st.stor_used.copy()))
    others = st.z[:, j, k] > 0.5
    n_other = int(np.count_nonzero(others))
    if n_other:
        st.spend -= inst.Delta_T * inst.p_s * inst.B[j] * n_other
        st.stor_used[others] -= inst.B[j]
        st.z[:, j, k] = 0.0
    st.spend -= inst.Delta_T * inst.p_c[k] * float(st.y[j, k])
    st.q[j, k] = 0.0
    st.y[j, k] = 0.0
    st.cfg[j, k] = -1


@mutates("x", "z", "q", "cfg", "y", "r_rem", "E_used", "D_used", "spend",
         "kv_tok", "load", "stor_used", "uncovered")
def undo_all(st: State, undo: list) -> None:
    """Roll back every record pushed by `commit` / `remove_assignment`, in
    reverse order.  Restoration is exact: each record carries the previous
    raw values, so the state is bitwise-identical to before the moves."""
    while undo:
        rec = undo.pop()
        if rec[0] == "deact":
            (_, j, k, q0, y0, cfg0, sp0, zcol, stor0) = rec
            st.stor_used[:] = stor0
            st.z[:, j, k] = zcol
            st.q[j, k] = q0
            st.y[j, k] = y0
            st.cfg[j, k] = cfg0
            st.spend = sp0
        elif rec[0] == "commit":
            (_, i, j, k, x0, z0, q0, cfg0, y0, rr0, e0, d0, sp0,
             kv0, ld0, su0, dvec, unc_had) = rec
            st.x[i, j, k] = x0
            st.z[i, j, k] = z0
            st.q[j, k] = q0
            st.cfg[j, k] = cfg0
            st.y[j, k] = y0
            st.r_rem[i] = rr0
            st.E_used[i] = e0
            if dvec is not None:
                st.D_used[:] = dvec
            else:
                st.D_used[i] = d0
            st.spend = sp0
            st.kv_tok[j, k] = kv0
            st.load[j, k] = ld0
            st.stor_used[i] = su0
            if unc_had:
                st.uncovered.add(i)
        else:
            (_, i, j, k, frac, had_z, deact, cfg0, q0, y0,
             rr0, e0, d0, sp0, kv0, ld0, su0, zcol) = rec
            st.x[i, j, k] = frac
            st.q[j, k] = q0
            st.y[j, k] = y0
            st.cfg[j, k] = cfg0
            st.r_rem[i] = rr0
            st.E_used[i] = e0
            st.D_used[i] = d0
            st.spend = sp0
            st.kv_tok[j, k] = kv0
            st.load[j, k] = ld0
            if deact:
                st.stor_used[:] = su0
                st.z[:, j, k] = zcol
            else:
                st.stor_used[i] = su0
                st.z[i, j, k] = 1.0 if had_z else 0.0


# ---------------------------------------------------------------------------
# State-level objective / snapshots (AGH local search support)
# ---------------------------------------------------------------------------

def state_objective(st: State) -> float:
    """Objective (8a) straight from the running state: spend already holds
    rental + model storage + data storage; D_used is exactly proc_delay and
    clip(r_rem) is the unmet fraction.  O(I) — no einsum over [I,J,K,C]."""
    inst = st.inst
    unmet = np.clip(st.r_rem, 0.0, None)
    return float(st.spend + np.dot(inst.rho, st.D_used) * 1e3
                 + inst.Delta_T * np.dot(inst.phi, unmet))


def state_snapshot(st: State) -> tuple:
    """Deep copy of every mutable field (multi-step rollback)."""
    return (st.x.copy(), st.y.copy(), st.q.copy(), st.cfg.copy(),
            st.z.copy(), st.r_rem.copy(), st.E_used.copy(), st.D_used.copy(),
            st.spend, set(st.uncovered), st.kv_tok.copy(), st.load.copy(),
            st.stor_used.copy())


@mutates("x", "z", "q", "cfg", "y", "r_rem", "E_used", "D_used", "spend",
         "kv_tok", "load", "stor_used", "uncovered")
def state_restore(st: State, snap: tuple) -> None:
    (x, y, q, cfg, z, r_rem, E, D, spend, unc, kv, load, stor) = snap
    st.x[:] = x
    st.y[:] = y
    st.q[:] = q
    st.cfg[:] = cfg
    st.z[:] = z
    st.r_rem[:] = r_rem
    st.E_used[:] = E
    st.D_used[:] = D
    st.spend = spend
    st.uncovered = set(unc)
    st.kv_tok[:] = kv
    st.load[:] = load
    st.stor_used[:] = stor


def solution_from_state(inst: Instance, st: State):
    """Materialize a `Solution` from the running state (shared by GH/AGH)."""
    from .solution import Solution

    sol = Solution.empty(inst)
    sol.x, sol.y, sol.q, sol.z = st.x, st.y, st.q, st.z
    sol.u = np.clip(st.r_rem, 0.0, None)
    jj, kk = np.nonzero((st.q > 0.5) & (st.cfg >= 0))
    sol.w[jj, kk, st.cfg[jj, kk]] = 1.0
    return sol


@mutates("q", "cfg", "y", "spend")
def deployment_state(inst: Instance, sol, ablation: frozenset = frozenset()
                     ) -> State:
    """A fresh `State` seeded with an existing solution's DEPLOYMENT —
    active pairs, their configs, and their GPU counts — with all routing
    cleared (x = 0, every type fully unserved, z = 0).

    This is the warm-start entry point of AGH's replanning path: the
    incumbent's Stage-1 structure is kept, rentals are charged into
    `spend` (so the (8c) budget cap sees them), and GH Phase 2 then
    re-routes the *new* demand over that structure — activating extra
    pairs only where the incumbent's capacity cannot absorb the drift.
    The seeded state trivially satisfies every State invariant (all
    running aggregates are zero except `spend`), so commit/undo and the
    local-search engines operate on it unchanged.
    """
    st = State.fresh(inst, ablation=ablation)
    active = sol.q > 0.5
    has_cfg = sol.w.max(axis=2) > 0.5
    keep = active & has_cfg
    st.q[:] = np.where(keep, 1.0, 0.0)
    st.cfg[:] = np.where(keep, sol.w.argmax(axis=2), -1)
    st.y[:] = np.where(keep, sol.y, 0.0)
    st.spend = float(inst.Delta_T * np.sum(inst.p_c[None, :] * st.y))
    return st
