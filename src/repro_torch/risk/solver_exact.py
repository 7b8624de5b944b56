"""Exact (oracle) chunk solver + shared host-side bookkeeping.

Pure numpy/scipy — `risk_evaluate(engine="exact")` routes here and never
imports torch.  `BatchedStage2Solver` (the pdhg engine) subclasses
`ExactChunkSolver` to share the LP pattern plumbing, the linprog oracle,
and the per-scenario statistics recorder, guaranteeing both engines
compute cost/violation/utilization through the SAME code.

The LP solved is the relaxed Stage-2 protocol (u <= 1): always feasible,
so every scenario yields a realized cost — what the tail statistics
need.  The objective bookkeeping matches `Stage2System.solve` exactly:
cost = c_x @ x + c_u @ clip(u, 0, 1).
"""
from __future__ import annotations

import numpy as np
from scipy import sparse
from scipy.optimize import linprog

from ..core.instance import ScenarioBatch
from ..core.stage2 import Stage2System


class _ChunkArrays:
    """Per-chunk result accumulator: costs, violations, tail inputs."""

    def __init__(self, S: int, n_fam: int):
        self.costs = np.zeros(S)
        self.viols = np.zeros(S, dtype=np.int64)
        self.unmet = np.zeros(S)
        self.util = np.zeros((S, n_fam))

    def record_z(self, s: int, vals: np.ndarray, z: np.ndarray,
                 solver: "ExactChunkSolver") -> None:
        rowsv = np.zeros(solver.m)
        np.add.at(rowsv, solver.rows, vals * z[solver.cols])
        self._stats(np.array([s]), z[None, :], rowsv[None, :], solver)

    def record_batch(self, sel: np.ndarray, z: np.ndarray,
                     rowsv: np.ndarray, solver: "ExactChunkSolver") -> None:
        self._stats(sel, z, rowsv, solver)

    def _stats(self, sel: np.ndarray, z: np.ndarray, rowsv: np.ndarray,
               solver: "ExactChunkSolver") -> None:
        u = np.clip(z[:, solver.nx:], 0.0, 1.0)
        self.viols[sel] = np.sum(u > 0.01, axis=1)
        self.unmet[sel] = u.sum(axis=1)
        fam = solver.system.row_family
        safe = np.maximum(solver.rhs0[:solver.m_ub], 1e-12)
        ratio = rowsv[:, :solver.m_ub] / safe[None, :]
        for f in range(self.util.shape[1]):
            rows_f = np.where(fam == f)[0]
            if rows_f.size:
                self.util[sel, f] = ratio[:, rows_f].max(axis=1)


class ExactChunkSolver:
    """Every scenario through linprog/HiGHS — the exact oracle path."""

    def __init__(self, system: Stage2System):
        self.system = system
        self.n, self.nx, self.I = system.n, system.nx, system.I
        self.m_ub = system.m_ub
        self.m = system.m_ub + system.I
        self.rows = system.rows_all.astype(np.int64)
        self.cols = system.cols_all.astype(np.int64)
        self.nnz_all = system.nnz_all
        self.rhs0 = system.row_ub.copy()
        self.ub = np.ones(self.n)                 # relaxed protocol
        self.is_eq = np.zeros(self.m, dtype=bool)
        self.is_eq[self.m_ub:] = True
        self.n_fam = len(Stage2System.ROW_FAMILIES)
        self.diagnostics: dict = {"n_exact": 0}

    def _exact(self, vals: np.ndarray, c: np.ndarray):
        """One exact scenario solve via linprog/HiGHS (exposes duals)."""
        K = sparse.coo_matrix((vals, (self.rows, self.cols)),
                              shape=(self.m, self.n)).tocsr()
        bounds = np.stack([np.zeros(self.n), self.ub], axis=1)
        return linprog(c, A_ub=K[:self.m_ub], b_ub=self.rhs0[:self.m_ub],
                       A_eq=K[self.m_ub:], b_eq=self.rhs0[self.m_ub:],
                       bounds=bounds, method="highs")

    def _record_exact(self, s: int, vals: np.ndarray, c: np.ndarray, res,
                      out: _ChunkArrays) -> None:
        z = np.concatenate([res.x[:self.nx],
                            np.clip(res.x[self.nx:], 0.0, 1.0)])
        out.costs[s] = float(c[:self.nx] @ z[:self.nx]
                             + c[self.nx:] @ z[self.nx:])
        out.record_z(s, vals, z, self)

    def solve_scenarios(self, batch: ScenarioBatch) -> _ChunkArrays:
        vals, c = self.system.coefficient_batch(batch)
        out = _ChunkArrays(batch.S, self.n_fam)
        for s in range(batch.S):
            res = self._exact(vals[s], c[s])
            self._record_exact(s, vals[s], c[s], res, out)
        self.diagnostics["n_exact"] += batch.S
        return out
