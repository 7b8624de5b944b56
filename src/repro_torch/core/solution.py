"""Solution container + shared objective / feasibility evaluator for `P_DM`.

Every solver (exact MILP, GH, AGH, LPR, DVR, HF) returns a `Solution`;
the objective (8a) and the constraint system (8b)–(8k) are evaluated by ONE
shared implementation so that costs and feasibility verdicts are comparable
across methods and checkable by property tests.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .instance import KB_PER_GB, Instance


@dataclasses.dataclass
class Solution:
    x: np.ndarray            # [I,J,K] routing fractions
    y: np.ndarray            # [J,K]   GPUs per pair (int)
    q: np.ndarray            # [J,K]   deployment flag
    w: np.ndarray            # [J,K,C] joint TP/PP selector
    z: np.ndarray            # [I,J,K] admission flag
    u: np.ndarray            # [I]     unserved fraction
    runtime_s: float = 0.0
    method: str = ""

    @staticmethod
    def empty(inst: Instance) -> "Solution":
        I, J, K, C = inst.I, inst.J, inst.K, inst.n_cfg
        return Solution(x=np.zeros((I, J, K)), y=np.zeros((J, K)),
                        q=np.zeros((J, K)), w=np.zeros((J, K, C)),
                        z=np.zeros((I, J, K)), u=np.ones(I))

    def copy(self) -> "Solution":
        return Solution(self.x.copy(), self.y.copy(), self.q.copy(),
                        self.w.copy(), self.z.copy(), self.u.copy(),
                        self.runtime_s, self.method)

    def routed_copy(self) -> "Solution":
        """Copy of this deployment with the routing cleared: y/q/w/z frozen,
        x zeroed and u all-unmet, ready for a Stage-2 scenario LP to fill.
        """
        return Solution(x=np.zeros_like(self.x), y=self.y.copy(),
                        q=self.q.copy(), w=self.w.copy(), z=self.z.copy(),
                        u=np.ones(self.u.shape[0]), method=self.method)

    def config_of(self, inst: Instance, j: int, k: int) -> tuple[int, int] | None:
        c = np.argmax(self.w[j, k])
        if self.w[j, k, c] <= 0.5:
            return None
        return inst.configs[c]

    def to_dict(self) -> dict:
        """JSON-safe dict (arrays as nested lists); `from_dict` inverts it
        exactly — the planner's `PlanResult` serialization rides this."""
        return dict(x=self.x.tolist(), y=self.y.tolist(), q=self.q.tolist(),
                    w=self.w.tolist(), z=self.z.tolist(), u=self.u.tolist(),
                    runtime_s=self.runtime_s, method=self.method)

    @staticmethod
    def from_dict(d: dict) -> "Solution":
        return Solution(x=np.asarray(d["x"], float),
                        y=np.asarray(d["y"], float),
                        q=np.asarray(d["q"], float),
                        w=np.asarray(d["w"], float),
                        z=np.asarray(d["z"], float),
                        u=np.asarray(d["u"], float),
                        runtime_s=float(d.get("runtime_s", 0.0)),
                        method=str(d.get("method", "")))


# ---------------------------------------------------------------------------
# Objective (8a)
# ---------------------------------------------------------------------------

def proc_delay(inst: Instance, sol: Solution) -> np.ndarray:
    """D_i^proc (eq. 6) in seconds, using the selected (TP, PP) per pair."""
    # D_cfg[i,j,k,c] weighted by x * w  (the McCormick product, exact here
    # because w is integral in any committed solution).
    xw = sol.x[:, :, :, None] * sol.w[None, :, :, :]
    return np.einsum("ijkc,ijkc->i", xw, inst.D_cfg)


def cost_terms(inst: Instance, sol: Solution) -> dict[str, float]:
    """The five objective components of (8a), in dollars over Delta_T."""
    rental = inst.Delta_T * float(np.sum(inst.p_c[None, :] * sol.y))
    model_storage = inst.Delta_T * inst.p_s * float(
        np.sum(inst.B[None, :, None] * sol.z))
    data_gb_h = (inst.theta[:, None, None] / KB_PER_GB
                 * inst.r[:, None, None] * inst.lam[:, None, None] * sol.x)
    data_storage = inst.Delta_T * inst.p_s * float(np.sum(data_gb_h))
    delay_pen = float(np.sum(inst.rho * proc_delay(inst, sol) * 1e3))  # rho $/ms
    unmet_pen = inst.Delta_T * float(np.sum(inst.phi * sol.u))
    return dict(rental=rental, model_storage=model_storage,
                data_storage=data_storage, delay_penalty=delay_pen,
                unmet_penalty=unmet_pen)


def objective(inst: Instance, sol: Solution) -> float:
    return float(sum(cost_terms(inst, sol).values()))


def provisioning_cost(inst: Instance, sol: Solution) -> float:
    """Stage-1 cost: rental + model storage (deterministic given deployment)."""
    t = cost_terms(inst, sol)
    return t["rental"] + t["model_storage"]


# ---------------------------------------------------------------------------
# Constraints (8b)–(8k)
# ---------------------------------------------------------------------------

def kv_gb_per_device(inst: Instance, sol: Solution, j: int, k: int,
                     nm: float) -> float:
    """KV-cache GB per device for pair (j,k) under config product nm (8f)."""
    if not inst.kv_applicable[j]:
        # SSM-state models: constant recurrent state, not per-token KV.
        return (inst.beta[j] / KB_PER_GB) * 64.0 / nm
    tokens = float(np.sum(inst.r * inst.T_res[:, j, k] * sol.x[:, j, k]))
    return (inst.beta[j] / KB_PER_GB) / nm * tokens


def _constraint_usage(inst: Instance, sol: Solution) -> dict:
    """Shared usage/capacity arithmetic of (8c) and (8f)–(8j), consumed by
    BOTH `feasibility` (max violation) and `slack_report` (min headroom) —
    one implementation, so the violation and slack views of a constraint
    can never drift apart.

    Returns: ``spend`` (8c $), ``active`` ([J,K] deployment mask),
    ``mem_used`` ([J,K] per-device GB at active pairs; None when nothing
    is deployed), ``load``/``cap`` ([J,K] GFLOP, (8g)), ``stor`` ([I] GB,
    (8h)), ``dproc`` ([I] s, (8i)), ``err`` ([I], (8j)).
    """
    data_gb_h = (inst.theta[:, None, None] / KB_PER_GB
                 * inst.r[:, None, None] * inst.lam[:, None, None] * sol.x)
    spend = (inst.Delta_T * np.sum(inst.p_c[None, :] * sol.y)
             + inst.Delta_T * inst.p_s
             * (np.sum(inst.B[None, :, None] * sol.z) + np.sum(data_gb_h)))
    active = sol.q > 0.5
    mem_used = None
    if active.any():
        nm_sel = np.einsum("jkc,c->jk", sol.w, inst.nm)
        nm_safe = np.maximum(nm_sel, 1.0)
        tokens = np.einsum("i,ijk,ijk->jk", inst.r, inst.T_res, sol.x)
        kv_gb = np.where(
            inst.kv_applicable[:, None],
            (inst.beta[:, None] / KB_PER_GB) / nm_safe * tokens,
            (inst.beta[:, None] / KB_PER_GB) * 64.0 / nm_safe)
        mem_used = inst.B_eff / nm_safe + kv_gb
    load = np.einsum("ijk,ijk->jk",
                     inst.alpha * (inst.r * inst.lam)[:, None, None] / 1e3,
                     sol.x)
    cap = inst.eta * 3600.0 * inst.P_gpu[None, :] * sol.y
    stor = (np.sum(inst.B[None, :, None] * sol.z, axis=(1, 2))
            + np.sum(data_gb_h, axis=(1, 2)))
    err = np.einsum("ijk,ijk->i", inst.e_bar, sol.x)
    return dict(spend=spend, active=active, mem_used=mem_used, load=load,
                cap=cap, stor=stor, dproc=proc_delay(inst, sol), err=err)


def feasibility(inst: Instance, sol: Solution, tol: float = 1e-6,
                enforce_zeta: bool = True,
                usage: dict | None = None) -> dict[str, float]:
    """Max violation per constraint family; all ≈0 ⇒ feasible.

    `usage` optionally reuses a `_constraint_usage(inst, sol)` result for
    this exact (inst, sol) pair — callers evaluating both views (the
    planner facade pairs this with `slack_report`) pay the vectorized
    pass once."""
    v: dict[str, float] = {}
    u = usage if usage is not None else _constraint_usage(inst, sol)
    # (8b) routing + unmet = 1
    v["demand"] = float(np.max(np.abs(sol.x.sum(axis=(1, 2)) + sol.u - 1.0)))
    # (8c) budget
    v["budget"] = max(0.0, float(u["spend"] - inst.delta))
    # (8d)-(8e) configuration consistency
    v["config_sum"] = float(np.max(np.abs(sol.w.sum(axis=2) - sol.q)))
    v["y_eq_nm"] = float(np.max(np.abs(sol.y - np.einsum("jkc,c->jk", sol.w, inst.nm))))
    # (8f) per-device memory: inactive pairs count any routed traffic as a
    # "ghost routing" violation, active pairs check weights + resident KV
    # (or the constant SSM state) per device.
    active = u["active"]
    worst = 0.0
    if (~active).any():
        worst = float(np.max(np.where(~active, sol.x.sum(axis=0), 0.0)))
    if u["mem_used"] is not None:
        worst = max(worst, float(np.max(
            np.where(active, u["mem_used"] - inst.C_gpu[None, :], -np.inf))))
    v["memory"] = max(0.0, worst)
    # (8g) compute throughput
    v["compute"] = max(0.0, float(np.max(u["load"] - u["cap"])))
    # (8h) storage (per query type, as displayed with free i)
    v["storage"] = max(0.0, float(np.max(u["stor"] - inst.C_s)))
    # (8i) delay SLO
    v["delay"] = max(0.0, float(np.max(u["dproc"] - inst.Delta)))
    # (8j) error SLO
    v["error"] = max(0.0, float(np.max(u["err"] - inst.eps)))
    # (8k) chain x <= z <= q
    v["chain"] = max(0.0, float(np.max(sol.x - sol.z - tol)),
                     float(np.max(sol.z - sol.q[None, :, :] - tol)))
    # tier availability caps (supply-side faults; core/faults.py) — only
    # reported when caps are set, so the base constraint-family keys are
    # unchanged for uncapped instances.
    if inst.avail_gpus is not None:
        v["availability"] = max(0.0, float(
            np.max(sol.y.sum(axis=0) - inst.avail_gpus)))
    # unmet cap
    if enforce_zeta:
        v["unmet_cap"] = max(0.0, float(np.max(sol.u - inst.zeta)))
    return v


def is_feasible(inst: Instance, sol: Solution, tol: float = 1e-4,
                enforce_zeta: bool = True) -> bool:
    return all(val <= tol for val in
               feasibility(inst, sol, enforce_zeta=enforce_zeta).values())


def slack_report(inst: Instance, sol: Solution,
                 usage: dict | None = None) -> dict[str, float]:
    """Signed headroom per constraint family (positive = slack remaining,
    negative = violated by that much) — the planner's `PlanResult` carries
    this next to the `feasibility()` violation report so operators can see
    which constraint BINDS a plan, not just whether it is satisfied.

    * ``budget``  — $ left under (8c);
    * ``memory``  — min over active pairs of per-device GB free under (8f)
      (inf when nothing is deployed);
    * ``compute`` — min over active pairs of GFLOP-capacity headroom (8g);
    * ``storage`` — min over types of storage-cap headroom (8h);
    * ``delay``   — min over types of delay-SLO headroom (8i), seconds;
    * ``error``   — min over types of error-SLO headroom (8j);
    * ``unmet``   — min over types of zeta-cap headroom.

    `usage` reuses a `_constraint_usage` result exactly as in
    `feasibility`.
    """
    u = usage if usage is not None else _constraint_usage(inst, sol)
    rep = {"budget": float(inst.delta - u["spend"])}
    active = u["active"]
    if u["mem_used"] is not None:
        rep["memory"] = float(np.min(
            np.where(active, inst.C_gpu[None, :] - u["mem_used"], np.inf)))
        rep["compute"] = float(np.min(
            np.where(active, u["cap"] - u["load"], np.inf)))
    else:
        rep["memory"] = float("inf")
        rep["compute"] = float("inf")
    rep["storage"] = float(np.min(inst.C_s - u["stor"]))
    rep["delay"] = float(np.min(inst.Delta - u["dproc"]))
    rep["error"] = float(np.min(inst.eps - u["err"]))
    rep["unmet"] = float(np.min(inst.zeta - sol.u))
    if inst.avail_gpus is not None:
        # devices still rentable on the scarcest tier (faulted instances)
        rep["availability"] = float(
            np.min(inst.avail_gpus - sol.y.sum(axis=0)))
    return rep
