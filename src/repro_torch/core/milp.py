"""Exact MILP for `P_DM` (paper §3.2), solved with scipy's HiGHS backend.

Gurobi is unavailable offline; HiGHS is an exact branch-and-cut MILP solver
with the same time-limit semantics, so the "DM" column remains the true
optimum wherever the solver converges within its cap.

Variable vector layout (concatenated):
    x  [I*J*K]   continuous routing fractions in [0,1]
    u  [I]       continuous unmet fractions in [0, zeta_i]
    y  [J*K]     integer GPU counts in [0, max(n*m)]
    q  [J*K]     binary deployment flags
    w  [J*K*C]   binary joint (TP,PP) selectors
    z  [I*J*K]   binary admission flags
    v  [I*J*K*C] continuous McCormick auxiliaries (eq. 7)
"""
from __future__ import annotations

import time

import numpy as np
from scipy import sparse
from scipy.optimize import Bounds, LinearConstraint, milp

from .instance import KB_PER_GB, Instance
from .solution import Solution


class _Index:
    def __init__(self, inst: Instance):
        I, J, K, C = inst.I, inst.J, inst.K, inst.n_cfg
        self.I, self.J, self.K, self.C = I, J, K, C
        self.nx = I * J * K
        self.nu = I
        self.ny = J * K
        self.nq = J * K
        self.nw = J * K * C
        self.nz = I * J * K
        self.nv = I * J * K * C
        ofs = 0
        self.ox = ofs
        ofs += self.nx
        self.ou = ofs
        ofs += self.nu
        self.oy = ofs
        ofs += self.ny
        self.oq = ofs
        ofs += self.nq
        self.ow = ofs
        ofs += self.nw
        self.oz = ofs
        ofs += self.nz
        self.ov = ofs
        ofs += self.nv
        self.n = ofs

    def x(self, i, j, k): return self.ox + (i * self.J + j) * self.K + k
    def u(self, i): return self.ou + i
    def y(self, j, k): return self.oy + j * self.K + k
    def q(self, j, k): return self.oq + j * self.K + k
    def w(self, j, k, c): return self.ow + (j * self.K + k) * self.C + c
    def z(self, i, j, k): return self.oz + (i * self.J + j) * self.K + k
    def v(self, i, j, k, c):
        return self.ov + ((i * self.J + j) * self.K + k) * self.C + c


def build(inst: Instance):
    """Build (c, LinearConstraint, integrality, Bounds) for `P_DM`."""
    ix = _Index(inst)
    I, J, K, C = ix.I, ix.J, ix.K, ix.C
    rows, cols, vals, lbs, ubs = [], [], [], [], []
    row = 0

    def add(entries, lb, ub):
        nonlocal row
        for col, val in entries:
            rows.append(row)
            cols.append(col)
            vals.append(val)
        lbs.append(lb)
        ubs.append(ub)
        row += 1

    # (8b) sum_jk x + u = 1
    for i in range(I):
        ent = [(ix.x(i, j, k), 1.0) for j in range(J) for k in range(K)]
        ent.append((ix.u(i), 1.0))
        add(ent, 1.0, 1.0)
    # (8c) budget
    ent = []
    for j in range(J):
        for k in range(K):
            ent.append((ix.y(j, k), inst.Delta_T * inst.p_c[k]))
    for i in range(I):
        for j in range(J):
            for k in range(K):
                ent.append((ix.z(i, j, k), inst.Delta_T * inst.p_s * inst.B[j]))
                ent.append((ix.x(i, j, k),
                            inst.Delta_T * inst.p_s * inst.theta[i] / KB_PER_GB
                            * inst.r[i] * inst.lam[i]))
    add(ent, -np.inf, inst.delta)
    # (8d) sum_c w = q ; (8e) y = sum_c nm w
    for j in range(J):
        for k in range(K):
            add([*((ix.w(j, k, c), 1.0) for c in range(C)), (ix.q(j, k), -1.0)],
                0.0, 0.0)
            add([(ix.y(j, k), 1.0),
                 *((ix.w(j, k, c), -float(inst.nm[c])) for c in range(C))],
                0.0, 0.0)
    # (8f) per-device memory
    for j in range(J):
        for k in range(K):
            ent = []
            for c in range(C):
                nm = float(inst.nm[c])
                ent.append((ix.w(j, k, c), inst.B_eff[j, k] / nm))
                if inst.kv_applicable[j]:
                    for i in range(I):
                        coef = (inst.beta[j] / KB_PER_GB / nm
                                * inst.r[i] * inst.T_res[i, j, k])
                        if coef:
                            ent.append((ix.v(i, j, k, c), coef))
                else:
                    ent.append((ix.w(j, k, c),
                                inst.beta[j] / KB_PER_GB * 64.0 / nm))
            ent.append((ix.q(j, k), -float(inst.C_gpu[k])))
            add(ent, -np.inf, 0.0)
    # (8g) compute throughput
    for j in range(J):
        for k in range(K):
            ent = [(ix.x(i, j, k),
                    inst.alpha[i, j, k] * inst.r[i] * inst.lam[i] / 1e3)
                   for i in range(I)]
            ent.append((ix.y(j, k), -inst.eta * 3600.0 * inst.P_gpu[k]))
            add(ent, -np.inf, 0.0)
    # (8h) storage per type
    for i in range(I):
        ent = []
        for j in range(J):
            for k in range(K):
                ent.append((ix.z(i, j, k), inst.B[j]))
                ent.append((ix.x(i, j, k),
                            inst.theta[i] / KB_PER_GB
                            * inst.r[i] * inst.lam[i]))
        add(ent, -np.inf, inst.C_s)
    # (8i) delay SLO via McCormick v
    for i in range(I):
        ent = [(ix.v(i, j, k, c), float(inst.D_cfg[i, j, k, c]))
               for j in range(J) for k in range(K) for c in range(C)]
        add(ent, -np.inf, float(inst.Delta[i]))
    # (8j) error SLO
    for i in range(I):
        ent = [(ix.x(i, j, k), float(inst.e_bar[i, j, k]))
               for j in range(J) for k in range(K)]
        add(ent, -np.inf, float(inst.eps[i]))
    # (8k) x <= z <= q
    for i in range(I):
        for j in range(J):
            for k in range(K):
                add([(ix.x(i, j, k), 1.0), (ix.z(i, j, k), -1.0)], -np.inf, 0.0)
                add([(ix.z(i, j, k), 1.0), (ix.q(j, k), -1.0)], -np.inf, 0.0)
    # (7) McCormick envelopes
    for i in range(I):
        for j in range(J):
            for k in range(K):
                for c in range(C):
                    add([(ix.v(i, j, k, c), 1.0), (ix.x(i, j, k), -1.0)],
                        -np.inf, 0.0)
                    add([(ix.v(i, j, k, c), 1.0), (ix.w(j, k, c), -1.0)],
                        -np.inf, 0.0)
                    add([(ix.x(i, j, k), 1.0), (ix.w(j, k, c), 1.0),
                         (ix.v(i, j, k, c), -1.0)], -np.inf, 1.0)

    A = sparse.csr_matrix((vals, (rows, cols)), shape=(row, ix.n))
    constraint = LinearConstraint(A, np.array(lbs), np.array(ubs))

    # Objective (8a)
    cobj = np.zeros(ix.n)
    for j in range(J):
        for k in range(K):
            cobj[ix.y(j, k)] += inst.Delta_T * inst.p_c[k]
    for i in range(I):
        cobj[ix.u(i)] += inst.Delta_T * inst.phi[i]
        for j in range(J):
            for k in range(K):
                cobj[ix.z(i, j, k)] += inst.Delta_T * inst.p_s * inst.B[j]
                cobj[ix.x(i, j, k)] += (inst.Delta_T * inst.p_s
                                        * inst.theta[i] / KB_PER_GB
                                        * inst.r[i] * inst.lam[i])
                for c in range(C):
                    cobj[ix.v(i, j, k, c)] += (inst.rho[i] * 1e3
                                               * inst.D_cfg[i, j, k, c])

    lo = np.zeros(ix.n)
    hi = np.ones(ix.n)
    hi[ix.oy:ix.oy + ix.ny] = float(np.max(inst.nm))
    for i in range(I):
        hi[ix.u(i)] = float(inst.zeta[i])
    integrality = np.zeros(ix.n)
    integrality[ix.oy:ix.oy + ix.ny] = 1
    integrality[ix.oq:ix.oq + ix.nq] = 1
    integrality[ix.ow:ix.ow + ix.nw] = 1
    integrality[ix.oz:ix.oz + ix.nz] = 1
    return cobj, constraint, integrality, Bounds(lo, hi), ix


def _extract(inst: Instance, ix: _Index, sol_vec: np.ndarray) -> Solution:
    I, J, K, C = ix.I, ix.J, ix.K, ix.C
    s = Solution.empty(inst)
    for i in range(I):
        s.u[i] = sol_vec[ix.u(i)]
        for j in range(J):
            for k in range(K):
                s.x[i, j, k] = sol_vec[ix.x(i, j, k)]
                s.z[i, j, k] = round(sol_vec[ix.z(i, j, k)])
    for j in range(J):
        for k in range(K):
            s.y[j, k] = round(sol_vec[ix.y(j, k)])
            s.q[j, k] = round(sol_vec[ix.q(j, k)])
            for c in range(C):
                s.w[j, k, c] = round(sol_vec[ix.w(j, k, c)])
    s.x = np.clip(s.x, 0.0, 1.0)
    s.u = np.clip(s.u, 0.0, None)
    return s


def solve_milp(inst: Instance, time_limit: float = 600.0,
               mip_rel_gap: float = 1e-3, relax: bool = False) -> Solution:
    """Solve `P_DM` exactly (or its LP relaxation with relax=True)."""
    t0 = time.perf_counter()
    c, constraint, integrality, bounds, ix = build(inst)
    if relax:
        integrality = np.zeros_like(integrality)
    res = milp(c, constraints=[constraint], integrality=integrality,
               bounds=bounds,
               options=dict(time_limit=time_limit, mip_rel_gap=mip_rel_gap,
                            disp=False))
    dt = time.perf_counter() - t0
    if res.x is None:
        s = Solution.empty(inst)
        s.runtime_s = dt
        s.method = "DM(timeout)" if not relax else "LP(fail)"
        return s
    s = _extract(inst, ix, res.x)
    s.runtime_s = dt
    s.method = "DM" if not relax else "LP-relax"
    return s


def lp_relaxation_values(inst: Instance, time_limit: float = 120.0):
    """Raw fractional variable vector of the LP relaxation (for LPR)."""
    c, constraint, integrality, bounds, ix = build(inst)
    res = milp(c, constraints=[constraint],
               integrality=np.zeros_like(integrality), bounds=bounds,
               options=dict(time_limit=time_limit, disp=False))
    return res.x, ix
