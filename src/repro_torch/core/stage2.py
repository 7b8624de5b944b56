"""Stage-2 operation LP (paper §5.2): with the Stage-1 deployment
(y, q, w, z) held fixed, re-optimize only routing x and unmet u under the
realized (perturbed) parameters.  The problem is a pure LP solved exactly
with HiGHS.

Vectorized engine
-----------------
The evaluation protocols (§5.2 Tables 2/4/5, §5.3 rolling horizon) solve
this LP hundreds of times against the SAME frozen deployment — only the
realized (tau, e_base, lam) differ per scenario.  The constraint *pattern*
(admissible triples, sparsity, equality block, rhs, bounds) is therefore a
function of the deployment alone, and every per-scenario coefficient is a
one-factor rescale of a per-triple base array:

  (8f) KV coef      kvA_t · lam_i · tau_i      (T_res ∝ lam · d_comp ∝ tau)
  (8g) compute coef gA_t  · lam_i
  (8h) storage coef sA_t  · lam_i
  (8i) delay coef   dA_t  · tau_i + dB_t       (comm term is tau-free)
  (8j) error coef   mu_k  · e_base_ij

`Stage2System` assembles the COO pattern once per deployment (rhs included
— it is scenario-invariant), keeps a CSC template whose `.data` is refreshed
in place per scenario, and solves scenarios back-to-back through HiGHS via
`scipy.optimize.milp` — the thin wrapper; scipy exposes no basis warm-start
API, so structure reuse is the part of the warm start we can keep.
`solve_batch` runs a whole `ScenarioBatch` this way, optionally fanned out
over a process pool.  No per-scenario `Instance` (nor its [I,J,K,C] tensor
rebuild) is materialized anywhere on this path.

Equivalence with the frozen per-call assembly (`_scalar_ref.stage2_lp_ref`)
is pinned by tests/test_stage2_equivalence.py.
"""
from __future__ import annotations

import dataclasses

import numpy as np
from scipy import sparse
from scipy.optimize import Bounds, LinearConstraint, milp

from .instance import KB_PER_GB, T_CONV, Instance, ScenarioBatch
from .solution import Solution, cost_terms

# Optional true basis warm-start across scenarios (ROADMAP risk item):
# scipy's HiGHS wrappers rebuild the solver per call, discarding the
# optimal basis between scenarios.  When the `highspy` bindings are
# installed, `solve_batch(warm_start=...)` can instead drive one
# persistent Highs model whose basis carries over from scenario to
# scenario.  The import is gated — this container (and CI) ships without
# highspy, and the scipy path stays the byte-identical default.
try:
    import highspy
except ImportError:            # pragma: no cover - exercised via the flag
    highspy = None

HAVE_HIGHSPY = highspy is not None


@dataclasses.dataclass
class _LPResult:
    """Raw per-scenario solve outcome (pre-`Solution` materialization)."""
    x: np.ndarray | None     # [nx] routing values (None if both solves failed)
    u: np.ndarray            # [I] unmet, clipped to [0, 1]
    cost: float              # stage-2 operation cost (storage+delay+unmet)
    capped_ok: bool          # strict-cap LP was feasible
    viol: int                # SLO violations: #{i : u_i > 0.01}


class Stage2System:
    """Fixed-structure Stage-2 routing LP for one (instance, deployment).

    Build once per deployment; `solve`/`solve_batch` refresh only the
    coefficient values from each scenario's (tau, e_base, lam).
    """

    #: constraint families, in `row_family` code order (rows 0..m_ub).
    ROW_FAMILIES = ("kv", "compute", "storage", "delay", "error")

    def __init__(self, inst: Instance, deploy: Solution,
                 allow_any_deployed: bool = False):
        self.inst = inst
        self.deploy = deploy
        I = inst.I
        self.I = I
        n_arr = np.array([n for (n, _) in inst.configs], float)
        m_arr = np.array([m for (_, m) in inst.configs], float)

        # Active pairs, j-major / k-minor (the legacy scan order).
        pj, pk = np.nonzero(deploy.q > 0.5)
        P = pj.size
        cfg_p = (deploy.w[pj, pk].argmax(axis=1) if P
                 else np.zeros(0, dtype=int))
        nm_p = inst.nm[cfg_p].astype(float)
        self.pj, self.pk, self.cfg_p = pj, pk, cfg_p

        # Admissible triples in legacy `adm` order: i-major, pair-minor.
        if allow_any_deployed:
            mask_ip = np.ones((I, P), dtype=bool)
        else:
            mask_ip = deploy.z[:, pj, pk] > 0.5 if P else np.zeros((I, 0), bool)
        ti, tp = np.nonzero(mask_ip)
        tj, tk = pj[tp], pk[tp]
        self.ti, self.tp, self.tj, self.tk = ti, tp, tj, tk
        nx = ti.size
        self.nx = nx
        self.n = nx + I

        # --- per-triple base factors (scenario value = base × factor) -----
        bw_term = inst.B[tj] * inst.nu[tk] / inst.BW[tk]   # d_comp / tau
        r_t, f_t = inst.r[ti], inst.f[ti]
        nm_t, n_t, m_t = nm_p[tp], n_arr[cfg_p][tp], m_arr[cfg_p][tp]
        # (8f) applies only to KV-cache models (SSM-state models have no
        # per-token resident KV and get no memory row, as in the seed):
        # beta/KB/nm · r · T_res, with T_res = lam/3600 · f · d_comp.
        sel_kv = inst.kv_applicable[tj]
        self.kvA = (inst.beta[tj] / KB_PER_GB / nm_t * r_t
                    * f_t / T_CONV * bw_term)[sel_kv]
        self.gA = inst.B[tj] * inst.nu[tk] * r_t / 1e3     # alpha · r (8g)
        self.sA = inst.theta[ti] / KB_PER_GB * r_t         # (8h) and c_x
        self.dA = bw_term * r_t / n_t                      # D_cfg tau-part
        self.dB = m_t * inst.d_comm[ti, tj, tk] * f_t      # D_cfg comm-part
        self.eA = inst.mu[tk]                              # e_bar / e_base

        # --- row layout (legacy order: kv, compute, storage, delay, err) --
        pair_n = np.bincount(tp, minlength=P) if P else np.zeros(0, int)
        pair_has = pair_n > 0
        kv_pair = pair_has & inst.kv_applicable[pj]
        i_n = np.bincount(ti, minlength=I)
        i_has = i_n > 0
        row = 0
        kv_row = np.full(P, -1)
        kv_row[kv_pair] = row + np.arange(kv_pair.sum())
        row += int(kv_pair.sum())
        g_row = np.full(P, -1)
        g_row[pair_has] = row + np.arange(pair_has.sum())
        row += int(pair_has.sum())
        s_row = np.full(I, -1)
        s_row[i_has] = row + np.arange(i_has.sum())
        row += int(i_has.sum())
        d_row = np.full(I, -1)
        d_row[i_has] = row + np.arange(i_has.sum())
        row += int(i_has.sum())
        e_row = np.full(I, -1)
        e_row[i_has] = row + np.arange(i_has.sum())
        row += int(i_has.sum())
        self.m_ub = row

        # Constraint-family label per inequality row (repro_torch.risk tail
        # attribution): index into ROW_FAMILIES.
        fam = np.empty(self.m_ub, dtype=np.int64)
        fam[kv_row[kv_pair]] = 0
        fam[g_row[pair_has]] = 1
        fam[s_row[i_has]] = 2
        fam[d_row[i_has]] = 3
        fam[e_row[i_has]] = 4
        self.row_family = fam

        self.ti_kv = ti[sel_kv]
        t_col = np.arange(nx)
        rows_ub = np.concatenate([
            kv_row[tp[sel_kv]], g_row[tp], s_row[ti], d_row[ti], e_row[ti],
        ]) if nx else np.zeros(0, int)
        cols_ub = np.concatenate(
            [t_col[sel_kv], t_col, t_col, t_col, t_col]) if nx else \
            np.zeros(0, int)
        self.nnz = rows_ub.size

        # Scenario-invariant rhs, in row order.
        b_ub = np.empty(self.m_ub)
        b_ub[kv_row[kv_pair]] = (inst.C_gpu[pk] - inst.B_eff[pj, pk] / nm_p
                                 )[kv_pair]
        b_ub[g_row[pair_has]] = (inst.eta * 3600.0 * inst.P_gpu[pk]
                                 * deploy.y[pj, pk])[pair_has]
        stor_base = np.sum(inst.B[None, :, None] * deploy.z, axis=(1, 2))
        b_ub[s_row[i_has]] = (inst.C_s - stor_base)[i_has]
        b_ub[d_row[i_has]] = inst.Delta[i_has]
        b_ub[e_row[i_has]] = inst.eps[i_has]

        # One combined constraint block: the m_ub inequality rows on top of
        # the I equality rows of (8b) (x-row sums + u = 1, scenario-
        # invariant).  A single CSC template is built once with
        # data = COO-entry-index so `A.data = vals[perm]` refreshes the
        # per-scenario coefficients in place; HiGHS is then fed through
        # `scipy.optimize.milp` (the thin wrapper — `linprog` re-validates
        # and re-stacks A_ub/A_eq on every call, which at ~1 ms/solve would
        # dominate these tiny LPs).
        eq_rows = self.m_ub + np.concatenate([ti, np.arange(I)])
        eq_cols = np.concatenate([t_col, nx + np.arange(I)])
        all_rows = np.concatenate([rows_ub, eq_rows])
        all_cols = np.concatenate([cols_ub, eq_cols])
        nnz_all = all_rows.size
        # Concat-order COO pattern, exposed for tensor engines (repro_torch.risk):
        # entry e of `coefficient_batch`'s value rows lives at
        # (rows_all[e], cols_all[e]); the first `self.nnz` entries are the
        # scenario-dependent inequality coefficients, the tail is the
        # constant equality block (value 1.0).
        self.rows_all = all_rows
        self.cols_all = all_cols
        self.nnz_all = nnz_all
        self.m = self.m_ub + I
        coo = sparse.coo_matrix(
            (np.arange(nnz_all, dtype=float), (all_rows, all_cols)),
            shape=(self.m_ub + I, self.n))
        self.A = coo.tocsc()
        self._perm = self.A.data.astype(np.int64)
        self._vals = np.ones(nnz_all)          # eq tail stays 1.0 forever
        self.A.data = self._vals[self._perm]   # drop the index template
        self.row_lb = np.concatenate([np.full(self.m_ub, -np.inf),
                                      np.ones(I)])
        self.row_ub = np.concatenate([b_ub, np.ones(I)])

        # Bounds template: x in [0,1]; u rows refreshed per cap.
        self._lb = np.zeros(self.n)
        self._ub = np.ones(self.n)
        self.c_u = inst.Delta_T * inst.phi                  # unmet objective

    # ------------------------------------------------------------------
    def _coefficients(self, tau: np.ndarray, e_base: np.ndarray,
                      lam: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(A_ub COO values, objective c) for one scenario's parameters."""
        inst, ti = self.inst, self.ti
        lam_t = lam[ti]
        sx = self.sA * lam_t                               # (8h) coef
        D_t = self.dA * tau[ti] + self.dB                  # (8i) coef
        vals = np.concatenate([
            self.kvA * (lam * tau)[self.ti_kv],
            self.gA * lam_t,
            sx,
            D_t,
            self.eA * e_base[ti, self.tj],
        ]) if self.nx else np.zeros(0)
        c = np.empty(self.n)
        c[:self.nx] = (inst.Delta_T * inst.p_s * sx
                       + inst.rho[ti] * 1e3 * D_t)
        c[self.nx:] = self.c_u
        return vals, c

    def coefficient_batch(self, batch: ScenarioBatch
                          ) -> tuple[np.ndarray, np.ndarray]:
        """Stacked `_coefficients` over a whole batch, for tensor engines.

        Returns (vals[S, nnz_all], c[S, n]): per-scenario COO values in
        concat order (see `rows_all`/`cols_all`; the equality tail is the
        constant 1.0) and per-scenario objective vectors.  Elementwise ops
        match `_coefficients` exactly, so each row is bit-identical to the
        per-scenario path — pinned in tests/test_risk.py.
        """
        inst, ti = self.inst, self.ti
        S = batch.S
        tau = (np.broadcast_to(inst.tau, (S, inst.I)) if batch.tau is None
               else batch.tau)
        lam = (np.broadcast_to(inst.lam, (S, inst.I)) if batch.lam is None
               else batch.lam)
        e_base = (np.broadcast_to(inst.e_base, (S, inst.I, inst.J))
                  if batch.e_base is None else batch.e_base)
        vals = np.ones((S, self.nnz_all))
        c = np.empty((S, self.n))
        if self.nx:
            lam_t = lam[:, ti]
            sx = self.sA * lam_t
            D_t = self.dA * tau[:, ti] + self.dB
            k0 = self.ti_kv.size
            vals[:, :k0] = self.kvA * (lam * tau)[:, self.ti_kv]
            vals[:, k0:k0 + self.nx] = self.gA * lam_t
            vals[:, k0 + self.nx:k0 + 2 * self.nx] = sx
            vals[:, k0 + 2 * self.nx:k0 + 3 * self.nx] = D_t
            vals[:, k0 + 3 * self.nx:self.nnz] = self.eA * e_base[
                :, ti, self.tj]
            c[:, :self.nx] = (inst.Delta_T * inst.p_s * sx
                              + inst.rho[ti] * 1e3 * D_t)
        c[:, self.nx:] = self.c_u
        return vals, c

    def _highs(self, c: np.ndarray, cap: np.ndarray):
        self._ub[self.nx:] = cap
        return milp(c,
                    constraints=LinearConstraint(self.A, self.row_lb,
                                                 self.row_ub),
                    bounds=Bounds(self._lb, self._ub))

    def solve(self, tau: np.ndarray | None = None,
              e_base: np.ndarray | None = None,
              lam: np.ndarray | None = None,
              u_cap: np.ndarray | None = None) -> _LPResult:
        """Solve one scenario; strict cap first, relaxed (u<=1) fallback —
        the legacy `stage2_lp` protocol."""
        inst = self.inst
        tau = inst.tau if tau is None else tau
        e_base = inst.e_base if e_base is None else e_base
        lam = inst.lam if lam is None else lam
        cap = inst.zeta if u_cap is None else u_cap
        vals, c = self._coefficients(tau, e_base, lam)
        if self.nnz:
            self._vals[:self.nnz] = vals
            self.A.data = self._vals[self._perm]
        res = self._highs(c, cap)
        capped_ok = res.status == 0
        if not capped_ok:
            res = self._highs(c, np.ones(self.I))
        if res.status == 0:
            u = np.clip(res.x[self.nx:], 0.0, 1.0)
            x = res.x[:self.nx]
            # stage2_cost of the materialized solution: the LP objective
            # with the clipped u (x terms are exactly c's x terms).
            cost = float(c[:self.nx] @ x + self.c_u @ u)
        else:   # fully unserved fallback (deployment cannot route anything)
            x, u = None, np.ones(self.I)
            cost = float(self.c_u @ u)
        return _LPResult(x=x, u=u, cost=cost, capped_ok=capped_ok,
                         viol=int(np.sum(u > 0.01)))

    def solve_batch(self, batch: ScenarioBatch,
                    u_cap: np.ndarray | None = None,
                    workers: int | None = None,
                    warm_start: bool | None = None
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Solve every scenario of `batch` against the fixed deployment.

        Returns (costs[S], viols[S], capped_ok[S]).  With `workers`, the
        scenario list is fanned out over a process pool (each worker reuses
        this system's pattern; chunked to amortize pickling).

        `warm_start` requests the persistent-Highs basis warm start across
        scenarios (sequential only; requires the optional `highspy`
        bindings).  `None` means "use it when available and sequential";
        `True` raises if highspy is absent — the scipy path is never
        silently swapped out.
        """
        S = batch.S
        if warm_start and not HAVE_HIGHSPY:
            raise RuntimeError(
                "warm_start=True requires the optional highspy bindings; "
                "install highspy or pass warm_start=False/None")
        use_pool = workers and workers > 1 and S >= 2 * workers
        if warm_start is None:
            warm_start = HAVE_HIGHSPY and not use_pool
        if warm_start and not use_pool:
            return _solve_chunk_highspy(self, batch, u_cap)
        if use_pool:
            import concurrent.futures as cf
            import multiprocessing as mp
            chunks = np.array_split(np.arange(S), workers)
            parts = []
            # spawn, not fork: the parent is typically multithreaded (torch,
            # BLAS) and forking such a process can deadlock the children.
            with cf.ProcessPoolExecutor(
                    max_workers=workers,
                    mp_context=mp.get_context("spawn")) as ex:
                futs = [ex.submit(_solve_chunk, self, _batch_slice(batch, c),
                                  u_cap) for c in chunks if c.size]
                parts = [f.result() for f in futs]
            costs = np.concatenate([p[0] for p in parts])
            viols = np.concatenate([p[1] for p in parts])
            capped = np.concatenate([p[2] for p in parts])
            return costs, viols, capped
        return _solve_chunk(self, batch, u_cap)

    def materialize(self, r: _LPResult) -> Solution:
        """Legacy `stage2_lp` output: deployment copy + scenario routing."""
        sol = self.deploy.routed_copy()
        if r.x is not None:
            sol.x[self.ti, self.tj, self.tk] = r.x
        sol.u = r.u.copy()
        return sol


def _batch_slice(batch: ScenarioBatch, idx: np.ndarray) -> ScenarioBatch:
    pick = lambda a: None if a is None else a[idx]
    return ScenarioBatch(S=idx.size, tau=pick(batch.tau),
                         e_base=pick(batch.e_base), lam=pick(batch.lam))


def _solve_chunk(system: Stage2System, batch: ScenarioBatch,
                 u_cap: np.ndarray | None
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sequential scenario loop over one chunk (process-pool task body)."""
    S = batch.S
    costs = np.zeros(S)
    viols = np.zeros(S, dtype=np.int64)
    capped = np.zeros(S, dtype=bool)
    for s in range(S):
        r = system.solve(
            tau=None if batch.tau is None else batch.tau[s],
            e_base=None if batch.e_base is None else batch.e_base[s],
            lam=None if batch.lam is None else batch.lam[s],
            u_cap=u_cap)
        costs[s], viols[s], capped[s] = r.cost, r.viol, r.capped_ok
    return costs, viols, capped


def _solve_chunk_highspy(system: Stage2System, batch: ScenarioBatch,
                         u_cap: np.ndarray | None
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sequential chunk via one persistent Highs model (basis warm start).

    Mirrors `_solve_chunk`'s strict-cap-then-relax protocol; only the LP
    backend differs.  HiGHS keeps the previous optimal basis between
    `run()` calls on the same model, so consecutive scenarios — one-factor
    rescales of each other — typically re-optimize in a handful of dual
    simplex iterations instead of solving from scratch.
    """
    if highspy is None:          # pragma: no cover - guarded by callers
        raise RuntimeError("highspy is not installed")
    inst = system.inst
    cap = inst.zeta if u_cap is None else u_cap
    S = batch.S
    costs = np.zeros(S)
    viols = np.zeros(S, dtype=np.int64)
    capped = np.zeros(S, dtype=bool)

    h = highspy.Highs()
    h.setOptionValue("output_flag", False)
    lp = highspy.HighsLp()
    lp.num_col_ = system.n
    lp.num_row_ = system.m
    lp.col_cost_ = np.zeros(system.n)
    lp.col_lower_ = system._lb.copy()
    ub0 = np.ones(system.n)
    ub0[system.nx:] = cap
    lp.col_upper_ = ub0
    lp.row_lower_ = system.row_lb.copy()
    lp.row_upper_ = system.row_ub.copy()
    lp.a_matrix_.format_ = highspy.MatrixFormat.kColwise
    lp.a_matrix_.start_ = system.A.indptr.astype(np.int32)
    lp.a_matrix_.index_ = system.A.indices.astype(np.int32)
    lp.a_matrix_.value_ = system._vals[system._perm].copy()
    h.passModel(lp)

    col_idx = np.arange(system.n, dtype=np.int32)
    u_idx = col_idx[system.nx:]
    u_lb = np.zeros(system.I)
    rows_ineq = system.rows_all[:system.nnz]
    cols_ineq = system.cols_all[:system.nnz]
    kOptimal = highspy.HighsModelStatus.kOptimal

    def _run(c: np.ndarray, u_ub: np.ndarray) -> tuple[bool, np.ndarray]:
        h.changeColsCost(system.n, col_idx, c)
        h.changeColsBounds(system.I, u_idx, u_lb, u_ub)
        h.run()
        if h.getModelStatus() != kOptimal:
            return False, np.zeros(system.n)
        return True, np.array(h.getSolution().col_value)

    for s in range(S):
        vals, c = system._coefficients(
            inst.tau if batch.tau is None else batch.tau[s],
            inst.e_base if batch.e_base is None else batch.e_base[s],
            inst.lam if batch.lam is None else batch.lam[s])
        for e in range(system.nnz):
            h.changeCoeff(int(rows_ineq[e]), int(cols_ineq[e]),
                          float(vals[e]))
        ok, xfull = _run(c, cap)
        capped[s] = ok
        if not ok:
            ok, xfull = _run(c, np.ones(system.I))
        if ok:
            u = np.clip(xfull[system.nx:], 0.0, 1.0)
            costs[s] = float(c[:system.nx] @ xfull[:system.nx]
                             + system.c_u @ u)
        else:
            u = np.ones(system.I)
            costs[s] = float(system.c_u @ u)
        viols[s] = int(np.sum(u > 0.01))
    return costs, viols, capped


def stage2_lp(inst: Instance, deploy: Solution, u_cap: np.ndarray | None = None,
              allow_any_deployed: bool = False) -> tuple[Solution, bool]:
    """Solve the Stage-2 routing LP for `inst` (realized params) given the
    fixed deployment in `deploy`.  Returns (solution, capped_feasible):
    if the strict unmet cap is infeasible, re-solves with the cap relaxed
    (u <= 1) and returns capped_feasible = False.

    One-shot wrapper over `Stage2System`; callers solving many scenarios
    against the same deployment should build the system once instead.
    """
    system = Stage2System(inst, deploy, allow_any_deployed=allow_any_deployed)
    r = system.solve(u_cap=u_cap)
    sol = system.materialize(r)
    sol.method = deploy.method + "+stage2"
    return sol, r.capped_ok


def stage2_cost(inst: Instance, sol: Solution) -> float:
    """Operation cost of a Stage-2 solution: storage + delay + unmet terms."""
    t = cost_terms(inst, sol)
    return t["data_storage"] + t["delay_penalty"] + t["unmet_penalty"]
