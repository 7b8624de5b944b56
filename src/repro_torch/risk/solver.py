"""Batched first-order Stage-2 LP solver, in torch.float64 on the card.

A port of the reference's scenario-batched solver: all S scenarios of a
`ScenarioBatch` are solved against one frozen deployment as stacked
tensor programs (f64, scenario axis leading) on one device — CUDA unless
the caller passes `device="cpu"` — with the scipy/HiGHS path as the
exact oracle. Three phases, cheapest first:

1. **Anchor-basis warm start.**  Each scenario's LP is a one-factor
   rescale of the base LP, so optimal bases cluster into a small set
   (~30 distinct bases cover tens of thousands of scenarios of the
   evaluation family).  An *anchor* is an optimal basis harvested from
   one exact solve: (active rows, basic columns, nonbasic-at-upper-bound
   columns), completed to a square basis through pivoted Gram-Schmidt
   when the vertex is degenerate.  For a batch of scenarios the solver
   proposes the candidate vertex/dual of the most promising anchor
   (first pass: nearest hit-centroid in perturbation space; retries:
   most-hit untried anchor).  The k x k active systems
   B(s) z_B = rhs_eff(s)  and  B(s)^T y = -c_B(s)  are solved EXACTLY
   in closed form by exploiting how scenarios perturb the constraint
   matrix: equality rows are scenario-constant, kv/compute/storage rows
   are pure per-row rescales (every entry of row i carries the same
   lam/tau factor), and only active delay/error rows change shape — of
   which an optimal basis holds a bounded number (q capped by the
   largest `_SHAPE_CLASSES` entry; anchors pad to the smallest fitting
   class so nominal deployments keep tiny q).  Writing
   B(s) = D(s) B0 + U dR(s) with D(s) the diagonal of row factors and
   U the q unit columns of the changed rows, Woodbury gives
   B(s)^{-1} = (I - G0 M(s)^{-1} dR(s)) B0^{-1} D(s)^{-1} with
   G0 = B0^{-1} U precomputed per anchor and M(s) = I_q + dR(s) G0 a
   tiny q x q system solved by an unrolled LU.  Everything is gathers
   and small dgemms — B(s) is never materialized and no batched LAPACK
   is invoked — then *verifies* each candidate with the PDHG
   convergence criteria proper (primal feasibility < `TOL_PF`, relative
   duality gap < `TOL_GAP`, duals clipped to sign-validity before the
   gap is formed).  A passing candidate IS PDHG converged at iteration
   0 — the stopping rule, not the proposer, is the correctness
   authority.  Scenarios that no anchor explains trigger an exact solve
   of one representative whose basis joins the anchor set (adaptive
   harvesting).

2. **PDHG iterations.**  Scenarios left over once the anchor set stops
   growing run restarted PDHG from the best candidate: Ruiz
   equilibration, diagonal (Pock-Chambolle) preconditioning, primal
   weight omega adapted at restarts, restart-to-average, and the same
   duality-gap stopping rule.

3. **Exact fallback.**  Scenarios that fail to converge within the
   iteration budget fall back to the exact oracle and are *counted* in
   the diagnostics — never silently dropped.

The LP solved here is the relaxed Stage-2 protocol (u <= 1, always
feasible), matching `Stage2System.solve(u_cap=ones)` — the risk
statistics want the realized cost of every scenario, not a strict-cap
feasibility verdict.  Per-scenario objectives agree with the oracle to
rtol 1e-5 (in practice ~1e-14); pinned in tests/test_torch_risk.py.

Device programs are plain torch operations (eager, no compiled graph):
every reduction over an index space is a one-hot matmul or an `amax`
scatter, never an atomic add, so two runs on the card give bit-identical
costs. Each candidate call returns its outputs to the host in one copy,
and each PDHG block in one copy. `_candidate_kernel.calls`,
`_pdhg_block.calls` and `_to_host.syncs` count the device programs run
and the device-to-host copies made, so a run can show its profile.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from scipy import sparse

from ..core.instance import ScenarioBatch
from ..core.stage2 import Stage2System
from ..device import resolve_device
from .solver_exact import ExactChunkSolver, _ChunkArrays

# PDHG convergence criteria — the single correctness authority for every
# non-exact scenario (anchor candidates must pass the SAME test).
TOL_PF = 1e-8       # max primal constraint violation (unscaled rows)
TOL_GAP = 1e-7      # relative duality gap |p-d| / (1+|p|+|d|)

_RUIZ_ITERS = 10
# Woodbury shape classes (q, eg): q = max scenario-varying (delay/error)
# rows per anchor basis, eg = max matrix entries in those rows x basic
# columns.  `_pack` pads each anchor to the SMALLEST fitting class, so
# nominal deployments (q <= 2 in practice) keep the small fast shapes
# while stressed deployments (15-16 active delay/error rows) still get
# kernel-representable anchors instead of degenerating to per-scenario
# exact solves.
_SHAPE_CLASSES = ((8, 64), (24, 192))
# Scenario counts pad up to these sizes, so the device programs see a few
# repeating shapes whatever the group sizes.
_S_BUCKETS = (256, 1024, 4096, 8192)

F64, I64 = torch.float64, torch.int64


def _bucket(S: int) -> int:
    for b in _S_BUCKETS:
        if S <= b:
            return b
    return int(2 ** np.ceil(np.log2(S)))


def _to_host(rows: int, *ts: torch.Tensor) -> list[np.ndarray]:
    """The first `rows` rows of each [S, ...] tensor, fetched to the host
    in ONE device-to-host copy (packed as f64 columns; bool flags come back
    as 0/1 and are compared, not cast)."""
    cols = [t[:rows].reshape(rows, -1).to(F64) for t in ts]
    host = torch.cat(cols, dim=1).cpu().numpy()
    _to_host.syncs += 1
    edges = np.cumsum([0] + [c.shape[1] for c in cols])
    return [host[:, a:b] for a, b in zip(edges[:-1], edges[1:], strict=True)]


_to_host.syncs = 0


# ---------------------------------------------------------------------------
# Candidate program: propose the anchor's vertex/dual for every scenario in
# the batch and verify it with the PDHG stopping rule.
# ---------------------------------------------------------------------------

def _lu_small(M: torch.Tensor) -> torch.Tensor:
    """No-pivot LU (compact storage) on [S, q, q] blocks, unrolled.

    M = I_q + dR G0 is diagonally dominated for in-cell scenarios and
    exactly the identity on padding slots, so pivoting is unnecessary;
    a scenario whose M is ill-conditioned produces a garbage candidate
    (inf/NaN from a zero pivot included) that the verification stage
    rejects (exactness is never assumed). The caller's tensor is not
    modified.
    """
    M = M.clone()
    Q = M.shape[1]
    for j in range(Q - 1):
        f = M[:, j + 1:, j] / M[:, j, j][:, None]
        M[:, j + 1:, j] = f
        M[:, j + 1:, j + 1:] -= f[:, :, None] * M[:, j:j + 1, j + 1:]
    return M


def _solve_small(Mlu: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Solve M h = r from the compact LU ([S, q] right-hand sides)."""
    Q = Mlu.shape[1]
    h = r.clone()
    for j in range(1, Q):
        h[:, j] -= torch.sum(Mlu[:, j, :j] * h[:, :j], dim=1)
    for j in reversed(range(Q)):
        h[:, j] -= torch.sum(Mlu[:, j, j + 1:] * h[:, j + 1:], dim=1)
        h[:, j] *= 1.0 / Mlu[:, j, j]
    return h


def _solve_small_t(Mlu: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Solve M^T g = r from the same compact LU (M^T = U^T L^T)."""
    Q = Mlu.shape[1]
    a = r.clone()
    for j in range(Q):
        if j:
            a[:, j] -= torch.sum(Mlu[:, :j, j] * a[:, :j], dim=1)
        a[:, j] *= 1.0 / Mlu[:, j, j]
    for j in reversed(range(Q - 1)):
        a[:, j] -= torch.sum(Mlu[:, j + 1:, j] * a[:, j + 1:], dim=1)
    return a


def _candidate_kernel(vals_all, c_all, pad, rhs0, is_eq, rows_a, cols_a,
                      ub, Rm, Rn,
                      e_r, m_r, M_r, rhs_act,
                      scale_e, scale_m, scale_mask,
                      e_g, dv0, jpos_g, rowq_g, Hq, Hk, P_M, Hg,
                      bas_idx, bas_mask, nb_vec, act_idx, act_mask,
                      B0inv, G0):
    # Index-space reductions are (gather, one-hot matmul) pairs: Rm/Rn are
    # the system-wide one-hot row/col maps, and the anchor tensors are
    # padded to static sizes with zero-weight tails. Matmuls sum in a
    # fixed order, where a scatter-add of f64 on CUDA (atomics) would not.
    vals = vals_all[pad]
    c = c_all[pad]
    S = pad.shape[0]
    m = rhs0.shape[0]

    # Woodbury pieces (see module docstring): row factors D(s) for the
    # pure-rescale rows, entry deltas dv of the q shape-changing rows.
    w_r = vals[:, e_r] * m_r[None, :]
    rhs_eff = rhs_act[None, :] - w_r @ M_r
    c_b = c[:, bas_idx] * bas_mask[None, :]
    dinv = 1.0 / (scale_mask[None, :] * vals[:, scale_e] * scale_m[None, :]
                  + (1.0 - scale_mask)[None, :])
    dv = vals[:, e_g] - dv0[None, :]
    Q = Hq.shape[1]
    Mlu = _lu_small(torch.eye(Q, dtype=vals.dtype, device=vals.device)[None]
                    + (dv @ P_M).reshape(S, Q, Q))

    # Primal:  B z_B = rhs_eff.
    t = (rhs_eff * dinv) @ B0inv.T
    h = _solve_small(Mlu, (dv * t[:, jpos_g]) @ Hq)
    z_b = t - h @ G0.T
    # Dual:  B^T y_act = -c_B.
    w0 = ((-c_b) @ B0inv) * dinv
    g = _solve_small_t(Mlu, w0 @ Hg)
    w = w0 - (((dv * g[:, rowq_g]) @ Hk) @ B0inv) * dinv

    z = (z_b * bas_mask[None, :]) @ F.one_hot(
        bas_idx, c.shape[1]).to(vals.dtype) + nb_vec[None, :]
    z = torch.minimum(torch.clamp(z, min=0.0), ub[None, :])
    y = (w * act_mask[None, :]) @ F.one_hot(act_idx, m).to(vals.dtype)
    y = torch.where(is_eq[None, :], y, torch.clamp(y, min=0.0))

    # Verification = the PDHG convergence criteria on the candidate.
    rowsv = (vals * z[:, cols_a]) @ Rm
    r0 = rowsv - rhs0[None, :]
    viol = torch.where(is_eq[None, :], r0.abs(), torch.clamp(r0, min=0.0))
    pf = torch.amax(viol, dim=1)
    p = torch.sum(c * z, dim=1)
    rc = c + (vals * y[:, rows_a]) @ Rn
    d = -torch.sum(rhs0[None, :] * y, dim=1) + torch.sum(
        torch.clamp(rc * ub[None, :], max=0.0), dim=1)
    gap = (p - d).abs() / (1.0 + p.abs() + d.abs())
    pf = torch.where(torch.isfinite(pf), pf, torch.inf)
    gap = torch.where(torch.isfinite(gap), gap, torch.inf)
    ok = (pf < TOL_PF) & (gap < TOL_GAP)
    score = torch.maximum(pf, gap)
    _candidate_kernel.calls += 1
    return ok, p, z, y, rowsv, score


_candidate_kernel.calls = 0


# ---------------------------------------------------------------------------
# PDHG programs (phase 2): per-scenario Ruiz scaling + preconditioned
# restarted iterations, all S scenarios in lockstep.
# ---------------------------------------------------------------------------

def _pdhg_setup(vals, c, rhs0, rows_a, cols_a, ub, z0, y0, Rm, Rn):
    S = vals.shape[0]
    m = rhs0.shape[0]
    n = c.shape[1]
    like = dict(dtype=vals.dtype, device=vals.device)
    r_idx = rows_a[None, :].expand(S, -1)
    c_idx = cols_a[None, :].expand(S, -1)
    vs = vals
    dr = torch.ones((S, m), **like)
    dc = torch.ones((S, n), **like)
    for _ in range(_RUIZ_ITERS):
        av = vs.abs()
        # Row/column maxima: `amax` is exact in any order.
        rmax = torch.zeros((S, m), **like).scatter_reduce(
            1, r_idx, av, "amax", include_self=True)
        cmax = torch.zeros((S, n), **like).scatter_reduce(
            1, c_idx, av, "amax", include_self=True)
        er = 1.0 / torch.sqrt(torch.clamp(rmax, min=1e-12))
        ec = 1.0 / torch.sqrt(torch.clamp(cmax, min=1e-12))
        vs = vs * er[:, rows_a] * ec[:, cols_a]
        dr = dr * er
        dc = dc * ec
    cs = c * dc
    rhss = rhs0[None, :] * dr
    ubs = ub[None, :] / dc
    av = vs.abs()
    sig0 = 1.0 / torch.clamp(av @ Rm, min=1e-12)
    tau0 = 1.0 / torch.clamp(av @ Rn, min=1e-12)
    omega = torch.clamp(
        torch.linalg.vector_norm(cs, dim=1)
        / torch.clamp(torch.linalg.vector_norm(rhss, dim=1), min=1.0),
        min=1e-4)
    z = torch.minimum(torch.clamp(z0 / dc, min=0.0), ubs)
    y = y0 * dr
    return vs, cs, rhss, ubs, sig0, tau0, omega, dr, dc, z, y


def _pdhg_residuals(vs, cs, rhss, ubs, dr, is_eq, rows_a, cols_a, Rm, Rn,
                    z, y):
    p = torch.sum(cs * z, dim=1)
    kz = (vs * z[:, cols_a]) @ Rm
    r0 = kz - rhss
    pf = torch.amax(torch.where(is_eq[None, :], r0.abs(),
                                torch.clamp(r0, min=0.0)) / dr, dim=1)
    yc = torch.where(is_eq[None, :], y, torch.clamp(y, min=0.0))
    rc = cs + (vs * yc[:, rows_a]) @ Rn
    d = -torch.sum(rhss * yc, dim=1) + torch.sum(
        torch.clamp(rc * ubs, max=0.0), dim=1)
    gap = (p - d).abs() / (1.0 + p.abs() + d.abs())
    return p, pf, gap


def _pdhg_block(vs, cs, rhss, ubs, sig0, tau0, is_eq, rows_a, cols_a,
                Rm, Rn, dr, omega, z, y, z_r, y_r, n_inner: int):
    """`n_inner` PDHG iterations + one restart/adaptation step."""
    tau = tau0 / omega[:, None]
    sig = sig0 * omega[:, None]
    zs = torch.zeros_like(z)
    ys = torch.zeros_like(y)
    for _ in range(n_inner):
        kty = (vs * y[:, rows_a]) @ Rn
        zn = torch.minimum(torch.clamp(z - tau * (cs + kty), min=0.0), ubs)
        arg = 2.0 * zn - z
        kz = (vs * arg[:, cols_a]) @ Rm
        t = y + sig * (kz - rhss)
        yn = torch.where(is_eq[None, :], t, torch.clamp(t, min=0.0))
        z, y = zn, yn
        zs += zn
        ys += yn
    za, ya = zs / float(n_inner), ys / float(n_inner)

    p, pf, gap = _pdhg_residuals(vs, cs, rhss, ubs, dr, is_eq,
                                 rows_a, cols_a, Rm, Rn, z, y)
    pa, pfa, gapa = _pdhg_residuals(vs, cs, rhss, ubs, dr, is_eq,
                                    rows_a, cols_a, Rm, Rn, za, ya)
    take_avg = torch.maximum(pfa, gapa) < torch.maximum(pf, gap)
    z = torch.where(take_avg[:, None], za, z)
    y = torch.where(take_avg[:, None], ya, y)
    p = torch.where(take_avg, pa, p)
    pf = torch.where(take_avg, pfa, pf)
    gap = torch.where(take_avg, gapa, gap)

    dz = torch.linalg.vector_norm(z - z_r, dim=1)
    dy = torch.linalg.vector_norm(y - y_r, dim=1)
    can = (dz > 1e-12) & (dy > 1e-12)
    omega_new = torch.exp(0.5 * torch.log(torch.where(can, dy / dz, 1.0))
                          + 0.5 * torch.log(omega))
    omega = torch.where(can, omega_new, omega)
    _pdhg_block.calls += 1
    return z, y, omega, p, pf, gap


_pdhg_block.calls = 0


# ---------------------------------------------------------------------------
# Host-side anchors.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Anchor:
    act: np.ndarray            # active rows
    bas: np.ndarray            # basic columns (sorted; keying only)
    nb_ub: np.ndarray          # nonbasic columns at upper bound
    feat: np.ndarray           # perturbation-space features of the source
    pack: tuple                # padded device tensors for _candidate_kernel
    hits: int = 0
    feat_sum: np.ndarray = dataclasses.field(default=None)  # type: ignore[assignment]

    def __post_init__(self) -> None:
        if self.feat_sum is None:
            self.feat_sum = np.zeros_like(self.feat)

    @property
    def key(self) -> tuple:
        return (tuple(self.act.tolist()), tuple(self.bas.tolist()))

    @property
    def centroid(self) -> np.ndarray:
        """Running mean of the features this anchor has solved.

        Far more predictive than the harvest scenario's own features —
        the source sits at the EDGE of its basis cell, the centroid near
        the middle.  Falls back to the source until the first hit.
        """
        return self.feat_sum / self.hits if self.hits else self.feat


class BatchedStage2Solver(ExactChunkSolver):
    """Solve `ScenarioBatch`es against one `Stage2System`, batched.

    Anchors persist across `solve_scenarios` calls, so later chunks of a
    large S resolve almost entirely at iteration 0.  Thread-compatible
    with the relaxed Stage-2 protocol only (u_cap is pinned to ones).
    The exact oracle, the pattern plumbing, and the statistics recorder
    come from `ExactChunkSolver` — both engines share them verbatim.
    Device tensors live on `device`: CUDA unless the caller passes
    "cpu"; without CUDA the constructor raises (no fallback).
    """

    def __init__(self, system: Stage2System, *, device: str = "cuda",
                 max_anchors: int = 32, pdhg_max_iter: int = 20000,
                 pdhg_check: int = 50):
        super().__init__(system)
        self.device = resolve_device(device)
        self.max_anchors = max_anchors
        self.pdhg_max_iter = pdhg_max_iter
        self.pdhg_check = pdhg_check
        inst = system.inst
        base_e = inst.e_base.mean(axis=1)
        self._feat_base = np.concatenate([inst.tau, inst.lam, base_e])
        self.anchors: list[_Anchor] = []
        self._anchor_keys: set[tuple] = set()
        self.diagnostics = {
            "n_anchor0": 0, "n_harvest_exact": 0, "n_pdhg": 0,
            "n_fallback_exact": 0, "pdhg_iters_max": 0, "n_scenarios": 0,
        }
        # Static device-side pattern tensors, shared by every device call.
        self._d_rhs0 = self._dev(self.rhs0, F64)
        self._d_is_eq = self._dev(self.is_eq, torch.bool)
        self._d_rows = self._dev(self.rows, I64)
        self._d_cols = self._dev(self.cols, I64)
        self._d_ub = self._dev(self.ub, F64)
        # System-wide one-hot accumulation maps: every index-space sum is
        # a matmul against one of them, in a fixed order (see
        # _candidate_kernel).
        E = self.nnz_all
        Rm = np.zeros((E, self.m))
        Rm[np.arange(E), self.rows] = 1.0
        Rn = np.zeros((E, self.n))
        Rn[np.arange(E), self.cols] = 1.0
        self._d_Rm = self._dev(Rm, F64)
        self._d_Rn = self._dev(Rn, F64)

    def _dev(self, a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        """A host array as a tensor of `dtype` on the solver's device."""
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=self.device)

    def _harvest_anchor(self, res, vals: np.ndarray, feat: np.ndarray
                        ) -> bool:
        """Extract an optimal basis from a linprog result; True if new."""
        n, nx, m_ub, I = self.n, self.nx, self.m_ub, self.I
        z = res.x
        y_ineq = -res.ineqlin.marginals
        resid = res.ineqlin.residual
        act = np.concatenate([
            np.where((np.abs(resid) < 1e-7) | (y_ineq > 1e-9))[0],
            m_ub + np.arange(I)])
        if act.size > n:
            # More active rows than columns: a square basis over the
            # column space cannot exist; trim to the rows with the
            # largest |dual| plus the equality block.
            strong = np.argsort(-np.abs(y_ineq[act[:-I]]))[:n - I]
            act = np.concatenate([act[:-I][strong], m_ub + np.arange(I)])
        at_lb = np.abs(z) < 1e-8
        at_ub = np.abs(z - self.ub) < 1e-8
        inside = ~(at_lb | at_ub)
        order = np.concatenate([
            np.where(inside)[0], np.where(at_ub)[0],
            np.where(at_lb & (np.arange(n) < nx))[0],
            np.where(at_lb & (np.arange(n) >= nx))[0]])
        Ad = sparse.coo_matrix((vals, (self.rows, self.cols)),
                               shape=(self.m, self.n)).toarray()
        W = Ad[np.ix_(act, order)].copy()
        k = act.size
        chosen: list[int] = []
        left = list(range(W.shape[1]))
        for _ in range(k):
            norms = np.linalg.norm(W[:, left], axis=0)
            good = np.where(norms > 1e-8)[0]
            if not good.size:
                return False
            j = left[good[0]]
            chosen.append(j)
            v = W[:, j] / np.linalg.norm(W[:, j])
            W -= np.outer(v, v @ W)
            left.remove(j)
        bas = np.sort(order[np.array(chosen)])
        nonbas = np.setdiff1d(np.arange(n), bas)
        nb_ub = nonbas[at_ub[nonbas]]
        key = (tuple(act.tolist()), tuple(bas.tolist()))
        if key in self._anchor_keys:
            return False
        pack = self._pack(act, bas, nb_ub, vals, Ad)
        if pack is None:                    # over the Woodbury budget
            return False
        self._anchor_keys.add(key)
        self.anchors.append(
            _Anchor(act=act, bas=bas, nb_ub=nb_ub, feat=feat, pack=pack))
        return True

    def _pack(self, act: np.ndarray, bas: np.ndarray, nb_ub: np.ndarray,
              vals: np.ndarray, Ad: np.ndarray) -> tuple | None:
        """Build an anchor's padded device tensors for `_candidate_kernel`.

        `vals`/`Ad` are the SOURCE scenario's entry values / dense matrix
        — the basis block (identity tail) is inverted once here and the
        kernel reconstructs every scenario's solve from it via Woodbury.
        Returns None when the basis exceeds every `_SHAPE_CLASSES`
        budget (shape-changing rows / their entry count): such an
        anchor is rejected and its scenarios take the PDHG/exact path.
        Otherwise pads to the smallest fitting (q, eg) class, so small-q
        anchors never pay big-q shapes.
        """
        K, E = self.n, self.nnz_all
        k = act.size
        row_pos = np.full(self.m, -1)
        row_pos[act] = np.arange(k)
        col_pos = np.full(self.n, -1)
        col_pos[bas] = np.arange(k)
        in_nb = np.zeros(self.n, dtype=bool)
        in_nb[nb_ub] = True

        sel_r = np.where((row_pos[self.rows] >= 0) & in_nb[self.cols])[0]
        e_r = np.zeros(E, dtype=np.int64)
        i_r = np.zeros(E, dtype=np.int64)
        m_r = np.zeros(E)
        e_r[:sel_r.size] = sel_r
        i_r[:sel_r.size] = row_pos[self.rows[sel_r]]
        # ub == 1 everywhere in the relaxed protocol, so the nb_ub
        # contribution to rhs_eff is just the coefficient itself.
        m_r[:sel_r.size] = self.ub[self.cols[sel_r]]
        M_r = np.zeros((E, K))
        M_r[np.arange(E), i_r] = np.where(m_r != 0.0, 1.0, 0.0)

        # Row classification: eq rows are scenario-constant, kv/compute/
        # storage rows rescale as a whole (one factor per row), delay/
        # error rows genuinely change shape -> Woodbury slots.
        fam = self.system.row_family
        scale_e = np.zeros(K, dtype=np.int64)
        scale_m = np.zeros(K)
        scale_mask = np.zeros(K)
        gen_pos: list[int] = []
        for p, r in enumerate(act):
            if r >= self.m_ub:
                continue                    # equality row: constant
            if fam[r] >= 3:
                gen_pos.append(p)           # delay/error: shape-changing
                continue
            ee = np.where(self.rows == r)[0]
            rep = ee[np.argmax(np.abs(vals[ee]))]
            if abs(vals[rep]) < 1e-12:      # degenerate rescale source
                gen_pos.append(p)
                continue
            scale_e[p] = rep
            scale_m[p] = 1.0 / vals[rep]
            scale_mask[p] = 1.0
        gen_rows = act[np.array(gen_pos, dtype=np.int64)]
        slot = {int(r): a for a, r in enumerate(gen_rows)}
        sel_g = np.where(np.isin(self.rows, gen_rows)
                         & (col_pos[self.cols] >= 0))[0]
        cls = next((c for c in _SHAPE_CLASSES
                    if len(gen_pos) <= c[0] and sel_g.size <= c[1]), None)
        if cls is None:
            return None
        Q, EG = cls

        P0 = np.eye(K)
        P0[:k, :k] = Ad[np.ix_(act, bas)]
        B0inv = np.linalg.inv(P0)
        G0 = np.zeros((K, Q))
        Hg = np.zeros((K, Q))
        for a, p in enumerate(gen_pos):
            G0[:, a] = B0inv[:, p]
            Hg[p, a] = 1.0
        e_g = np.zeros(EG, dtype=np.int64)
        dv0 = np.zeros(EG)
        jpos_g = np.zeros(EG, dtype=np.int64)
        rowq_g = np.zeros(EG, dtype=np.int64)
        Hq = np.zeros((EG, Q))
        Hk = np.zeros((EG, K))
        P_M = np.zeros((EG, Q * Q))
        for t, e in enumerate(sel_g):
            e_g[t] = e
            dv0[t] = vals[e]
            jp = col_pos[self.cols[e]]
            a = slot[int(self.rows[e])]
            jpos_g[t] = jp
            rowq_g[t] = a
            Hq[t, a] = 1.0
            Hk[t, jp] = 1.0
            P_M[t, a * Q:(a + 1) * Q] = G0[jp, :]

        rhs_act = np.zeros(K)
        rhs_act[:k] = self.rhs0[act]
        bas_idx = np.zeros(K, dtype=np.int64)
        bas_idx[:k] = bas
        bas_mask = np.zeros(K)
        bas_mask[:k] = 1.0
        nb_vec = np.zeros(self.n)
        nb_vec[nb_ub] = self.ub[nb_ub]
        act_idx = np.zeros(K, dtype=np.int64)
        act_idx[:k] = act
        act_mask = np.zeros(K)
        act_mask[:k] = 1.0
        d = self._dev
        return (d(e_r, I64), d(m_r, F64), d(M_r, F64), d(rhs_act, F64),
                d(scale_e, I64), d(scale_m, F64), d(scale_mask, F64),
                d(e_g, I64), d(dv0, F64), d(jpos_g, I64), d(rowq_g, I64),
                d(Hq, F64), d(Hk, F64), d(P_M, F64), d(Hg, F64),
                d(bas_idx, I64), d(bas_mask, F64), d(nb_vec, F64),
                d(act_idx, I64), d(act_mask, F64), d(B0inv, F64),
                d(G0, F64))

    # -- scenario features (anchor ordering only; no correctness role) --
    def _features(self, batch: ScenarioBatch) -> np.ndarray:
        inst = self.system.inst
        S = batch.S
        tau = (np.broadcast_to(inst.tau, (S, inst.I)) if batch.tau is None
               else batch.tau)
        lam = (np.broadcast_to(inst.lam, (S, inst.I)) if batch.lam is None
               else batch.lam)
        eb = (np.broadcast_to(inst.e_base.mean(axis=1), (S, inst.I))
              if batch.e_base is None else batch.e_base.mean(axis=2))
        feats = np.concatenate([tau, lam, eb], axis=1)
        return feats / np.maximum(self._feat_base[None, :], 1e-12)

    # -- the batched solve ----------------------------------------------
    def solve_scenarios(self, batch: ScenarioBatch) -> _ChunkArrays:
        system = self.system
        S = batch.S
        vals, c = system.coefficient_batch(batch)
        feats = self._features(batch)
        out = _ChunkArrays(S, self.n_fam)
        diag = self.diagnostics
        diag["n_scenarios"] += S

        if not self.anchors:
            v0, c0 = system.coefficient_batch(ScenarioBatch(S=1))
            res0 = self._exact(v0[0], c0[0])
            self._harvest_anchor(res0, v0[0],
                                 np.ones_like(self._feat_base))

        # One chunk-wide device residency; per-group rows are gathered on
        # device, inside the candidate program.
        d_vals_all = self._dev(vals, F64)
        d_c_all = self._dev(c, F64)
        feat_sq = np.sum(feats * feats, axis=1)

        unresolved = np.arange(S)
        tried = np.zeros((S, 0), dtype=bool)
        best_score = np.full(S, np.inf)
        best_z = np.zeros((S, self.n))
        best_y = np.zeros((S, self.m))

        while unresolved.size:
            A = len(self.anchors)
            still: list[np.ndarray] = []
            if A == 0:
                # No kernel-representable anchor yet (every harvested
                # basis tripped every _SHAPE_CLASSES cap): skip the anchor
                # pass — the harvest/PDHG tail below sees everything
                # exhausted and keeps making progress one exact solve
                # (or one PDHG batch) at a time.
                exhausted_idx = unresolved
                live = pick = np.zeros(0, dtype=np.int64)
            else:
                if tried.shape[1] < A:
                    tried = np.concatenate(
                        [tried, np.zeros((S, A - tried.shape[1]), bool)],
                        axis=1)
                # Anchor ordering (heuristic only — never affects
                # correctness): first pass goes to the nearest
                # hit-centroid, retries walk the untried anchors by hit
                # frequency.
                afeat = np.stack([a.centroid for a in self.anchors])
                hits = np.array([a.hits for a in self.anchors], dtype=float)
                t_u = tried[unresolved]
                fu = feats[unresolved]
                dist = (feat_sq[unresolved, None]
                        + np.sum(afeat * afeat, axis=1)[None, :]
                        - 2.0 * (fu @ afeat.T))
                dist[t_u] = np.inf
                hit_score = np.where(t_u, -np.inf, hits[None, :])
                first = ~t_u.any(axis=1)
                pick = np.where(first, np.argmin(dist, axis=1),
                                np.argmax(hit_score, axis=1))
                exhausted = ~np.isfinite(
                    dist[np.arange(unresolved.size), pick])
                exhausted_idx = unresolved[exhausted]
                live = unresolved[~exhausted]
                pick = pick[~exhausted]

            for a_id in np.unique(pick):
                grp = live[pick == a_id]
                tried[grp, a_id] = True
                anchor = self.anchors[a_id]
                # Gather the group's rows and pad to a bucket — the
                # program only ever does work proportional to the
                # scenarios actually trying this anchor, in a few shapes.
                Sg = grp.size
                Sb = _bucket(Sg)
                pad = np.concatenate([grp, np.repeat(grp[:1], Sb - Sg)])
                d_pad = torch.from_numpy(pad).to(self.device,
                                                 non_blocking=True)
                ok, p, z, y, rowsv, score = _candidate_kernel(
                    d_vals_all, d_c_all, d_pad,
                    self._d_rhs0, self._d_is_eq,
                    self._d_rows, self._d_cols, self._d_ub,
                    self._d_Rm, self._d_Rn, *anchor.pack)
                ok_np, p_np, sc_np, z_np, y_np, rows_np = _to_host(
                    Sg, ok, p, score, z, y, rowsv)
                ok_np = ok_np[:, 0] > 0.5
                hit = grp[ok_np]
                if hit.size:
                    anchor.hits += int(hit.size)
                    anchor.feat_sum += feats[hit].sum(axis=0)
                    diag["n_anchor0"] += int(hit.size)
                    out.costs[hit] = p_np[ok_np, 0]
                    out.record_batch(hit, z_np[ok_np], rows_np[ok_np], self)
                miss = grp[~ok_np]
                if miss.size:
                    sc = sc_np[~ok_np, 0]
                    better = sc < best_score[miss]
                    upd = miss[better]
                    if upd.size:
                        best_score[upd] = sc[better]
                        best_z[upd] = z_np[~ok_np][better]
                        best_y[upd] = y_np[~ok_np][better]
                    still.append(miss)

            leftovers = (np.concatenate(still) if still
                         else np.zeros(0, dtype=np.int64))
            if exhausted_idx.size:
                if len(self.anchors) < self.max_anchors:
                    # Harvest: exact-solve one representative; its basis
                    # joins the anchor set, the others retry against it.
                    s = int(exhausted_idx[0])
                    res = self._exact(vals[s], c[s])
                    diag["n_harvest_exact"] += 1
                    self._record_exact(s, vals[s], c[s], res, out)
                    self._harvest_anchor(res, vals[s], feats[s])
                    unresolved = np.concatenate(
                        [leftovers, exhausted_idx[1:]])
                    continue
                # Anchor space exhausted: hand the rest to PDHG.
                unresolved = np.zeros(0, dtype=np.int64)
                pdhg_idx = np.concatenate([leftovers, exhausted_idx])
                self._run_pdhg(pdhg_idx, vals, c, best_z, best_y, out)
                return out
            unresolved = leftovers

        return out

    def _run_pdhg(self, idx: np.ndarray, vals: np.ndarray, c: np.ndarray,
                  best_z: np.ndarray, best_y: np.ndarray,
                  out: _ChunkArrays) -> None:
        """Phase 2 (restarted PDHG) + phase 3 (exact fallback)."""
        diag = self.diagnostics
        if not idx.size:
            return
        Sp = idx.size
        Sb = _bucket(Sp)
        pad = np.concatenate([idx, np.repeat(idx[:1], Sb - Sp)])
        (vs, cs, rhss, ubs, sig0, tau0, omega, dr, dc, z, y) = _pdhg_setup(
            self._dev(vals[pad], F64), self._dev(c[pad], F64),
            self._d_rhs0, self._d_rows, self._d_cols, self._d_ub,
            self._dev(best_z[pad], F64), self._dev(best_y[pad], F64),
            self._d_Rm, self._d_Rn)
        z_r, y_r = z, y
        done = np.zeros(Sb, dtype=bool)
        p_done = np.zeros(Sb)
        z_done = np.zeros((Sb, self.n))
        it = 0
        while it < self.pdhg_max_iter:
            z, y, omega, p, pf, gap = _pdhg_block(
                vs, cs, rhss, ubs, sig0, tau0, self._d_is_eq,
                self._d_rows, self._d_cols, self._d_Rm, self._d_Rn,
                dr, omega, z, y, z_r, y_r, self.pdhg_check)
            z_r, y_r = z, y
            it += self.pdhg_check
            # One copy per block: the stopping flags with the cost and the
            # unscaled primal they would be recorded with.
            ok, p_np, z_phys = _to_host(
                Sb, (pf < TOL_PF) & (gap < TOL_GAP), p, z * dc)
            new = (ok[:, 0] > 0.5) & ~done
            if new.any():
                p_done[new] = p_np[new, 0]
                z_done[new] = z_phys[new]
                done |= new
            if done[:Sp].all():
                break
        diag["pdhg_iters_max"] = max(diag["pdhg_iters_max"], it)
        conv = np.where(done[:Sp])[0]
        if conv.size:
            diag["n_pdhg"] += int(conv.size)
            sel = idx[conv]
            out.costs[sel] = p_done[conv]
            for j, s in zip(conv, sel, strict=True):
                out.record_z(int(s), vals[s], z_done[j], self)
        fail = np.where(~done[:Sp])[0]
        for j in fail:
            s = int(idx[j])
            res = self._exact(vals[s], c[s])
            diag["n_fallback_exact"] += 1
            self._record_exact(s, vals[s], c[s], res, out)
