"""Problem instance for the joint allocation MILP (paper §3).

An instance bundles every parameter of `P_DM`: query types (I), foundation
models (J), GPU tiers (K = hardware × precision), feasible TP degrees N and
PP depths M, the two-phase delay coefficients, SLOs, prices, and budgets.

Workload statistics are calibrated to the Azure LLM Inference Trace as the
paper describes (§5.1); the trace itself is not available offline, so
`default_instance()` reproduces the paper's published calibration ranges
(arrival rates 1k–25k queries/h across six types, token-length buckets per
Splitwise-style rules, GPU tier table from NVIDIA datasheets, GPTQ-keyed
precision multipliers).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

# Precision-keyed multipliers (paper eq. (1) and Table 1).
PRECISIONS = ("FP16", "INT8", "INT4")
NU = {"FP16": 1.0, "INT8": 0.5, "INT4": 0.25}     # latency / bytes-per-weight scale
MU = {"FP16": 1.0, "INT8": 1.15, "INT4": 1.35}    # error multiplier

# Hardware table: (memory GB, TFLOP/s, HBM bandwidth GB/s, $/h at FP16).
# Values follow the paper's footnote ranges (24–80 GB, 768–3350 GB/s,
# 40.7–1484 TFLOPs, $0.35–$2.50/h).
GPU_HW = {
    "RTX4090": dict(mem=24.0, tflops=82.6, bw=1008.0, price=0.35),
    "A6000": dict(mem=48.0, tflops=40.7 * 2, bw=768.0, price=0.80),
    "A100-40": dict(mem=40.0, tflops=312.0, bw=1555.0, price=1.20),
    "H100-80": dict(mem=80.0, tflops=1484.0, bw=3350.0, price=2.50),
}
# Tier list (hardware, precision) — A100/H100 INT4 excluded per paper §5.1.
DEFAULT_TIERS = [
    ("A6000", "FP16"), ("A6000", "INT8"), ("A6000", "INT4"),
    ("RTX4090", "FP16"), ("RTX4090", "INT8"), ("RTX4090", "INT4"),
    ("A100-40", "FP16"), ("A100-40", "INT8"),
    ("H100-80", "FP16"), ("H100-80", "INT8"),
]

QUERY_TYPES = ("Summarization", "CodeGen", "Translation",
               "MathSolving", "ImageGen", "VideoGen")

NVLINK_BW_GBPS = 750.0          # mid of the paper's 600–900 GB/s range
T_CONV = 3600.0                 # seconds per hour
KB_PER_GB = 1e6


@dataclasses.dataclass
class Instance:
    """All parameters of `P_DM`. Arrays are indexed [i], [j], [k] or combos."""

    # --- sets -----------------------------------------------------------
    query_names: Sequence[str]
    model_names: Sequence[str]
    tier_names: Sequence[str]
    tp_degrees: Sequence[int]       # N
    pp_depths: Sequence[int]        # M

    # --- workload -------------------------------------------------------
    lam: np.ndarray                 # [I] queries/hour
    h: np.ndarray                   # [I] input tokens
    f: np.ndarray                   # [I] output tokens
    theta: np.ndarray               # [I] KB/token storage footprint

    # --- models ---------------------------------------------------------
    B: np.ndarray                   # [J] weight footprint GB (FP16)
    beta: np.ndarray                # [J] KV-cache KB/token
    e_base: np.ndarray              # [I, J] FP16 base error rate

    # --- tiers ----------------------------------------------------------
    C_gpu: np.ndarray               # [K] GB per device
    P_gpu: np.ndarray               # [K] TFLOP/s
    p_c: np.ndarray                 # [K] $/h
    BW: np.ndarray                  # [K] GB/s
    nu: np.ndarray                  # [K] latency/bytes scale
    mu: np.ndarray                  # [K] error multiplier

    # --- SLOs / prices / budgets -----------------------------------------
    Delta: np.ndarray               # [I] delay SLO (s)
    eps: np.ndarray                 # [I] error SLO
    rho: np.ndarray                 # [I] $/ms/query delay penalty
    phi: np.ndarray                 # [I] $/h unmet penalty
    zeta: np.ndarray                # [I] unmet-demand cap
    p_s: float                      # $/GB-h storage
    delta: float                    # global budget $
    C_s: float                      # storage cap GB
    Delta_T: float = 24.0           # scheduling horizon (h)
    eta: float = 0.9                # PP-bubble compute-utilization factor
    phase1_beta: float = 0.8        # GH Phase-1 budget fraction
    tau: np.ndarray | None = None   # [I] task-specific overhead for d_comp
    kv_applicable: np.ndarray | None = None  # [J] bool; False for SSM-state models
    # --- supply-side availability (core/faults.py) -----------------------
    # All three default to None, which means "the unbounded on-demand fleet
    # of the paper" — every solver/tensor path is bit-identical to the
    # pre-fault code until a cap is set.
    avail_gpus: np.ndarray | None = None   # [K] max rentable devices per tier
    spot: np.ndarray | None = None         # [K] bool: spot-priced (revocable)
    revoke_rate: np.ndarray | None = None  # [K] Poisson revocations / hour

    # ------------------------------------------------------------------
    # Derived quantities (computed once in __post_init__).
    # ------------------------------------------------------------------
    def __post_init__(self):
        I, J, K = self.I, self.J, self.K
        if self.tau is None:
            self.tau = np.ones(I)
        if self.kv_applicable is None:
            self.kv_applicable = np.ones(J, dtype=bool)
        self.r = self.h + self.f                                  # [I]
        # Effective weight footprint: nu shrinks bytes-per-weight (§3.1(4)).
        self.B_eff = self.B[:, None] * self.nu[None, :]            # [J, K]
        # Per-token compute delay at TP=1 (memory-bandwidth-bound decode
        # roofline, d_comp = tau_i * B_j * nu_k / BW_k) — paper §5.1.
        self.d_comp = (self.tau[:, None, None] * self.B[None, :, None]
                       * self.nu[None, None, :] / self.BW[None, None, :])  # [I,J,K]
        # Per-token inter-stage communication delay: activation bytes over
        # NVLink-class interconnect plus a fixed per-hop latency.
        act_gb = (self.beta * 8.0) / KB_PER_GB                     # [J] ~activation size
        self.d_comm = np.broadcast_to(
            (act_gb[None, :, None] / NVLINK_BW_GBPS) + 5e-6, (I, J, K)).copy()
        # Per-token compute cost (GFLOP/token): ~2 FLOP per active parameter,
        # scaled by precision (paper: "model FLOPs scaled by tier precision").
        self.alpha = np.broadcast_to(
            self.B[None, :, None] * self.nu[None, None, :], (I, J, K)).copy()
        # KV residency weight (see README of core/): the paper's T_res is
        # "calibrated as the per-token decode duration"; we fold the arrival
        # rate into the calibration so that beta_j * sum_i r_i * T_res * x
        # equals the steady-state resident KV bytes:
        #   resident tokens = (lam/3600 q/s) * f_i tokens in flight * t/token.
        self.T_res = (self.lam[:, None, None] / T_CONV
                      * self.f[:, None, None] * self.d_comp)       # [I,J,K]
        # Joint (TP, PP) configuration lattice.
        self.configs = [(n, m) for n in self.tp_degrees for m in self.pp_depths]
        self.nm = np.array([n * m for (n, m) in self.configs])     # [C]
        n_arr = np.array([n for (n, _) in self.configs], float)
        m_arr = np.array([m for (_, m) in self.configs], float)
        # D^k_ij(n,m) = d_comp * r_i / n + m * d_comm * f_i  (paper §3.1(7)).
        self.D_cfg = (self.d_comp[..., None] * self.r[:, None, None, None] / n_arr
                      + m_arr * self.d_comm[..., None]
                      * self.f[:, None, None, None])               # [I,J,K,C]
        # Effective per-token error rate (eq. 1).
        self.e_bar = self.e_base[:, :, None] * self.mu[None, None, :]  # [I,J,K]
        self._precompute_allocation_tensors()

    def _precompute_allocation_tensors(self) -> None:
        """State-independent tensors for the vectorized allocation engine.

        Everything here depends only on instance parameters, so it is
        computed once per instance (and recomputed by `perturbed` /
        `stressed` / manual `__post_init__` calls) and then reused by every
        GH construction, AGH ordering, and local-search move:

        * `mem_ok[J,K,C]`   — per-device weight-memory feasibility of each
                              (TP,PP) config (the memory half of M1 / eq. 9);
        * `cfg_m1[I,J,K]`   — the M1 winner: lexicographically (nm, delay,
                              index)-minimal config that fits memory AND the
                              delay SLO; -1 where no config is feasible;
        * `m1_nm[I,J,K]`    — nm of the M1 winner (0 where infeasible);
        * `e_ok` / `cover_ok` — error-SLO admissibility and the Phase-1
                              coverage mask (M1 feasible AND e_bar <= eps);
        * `data_gb[I]`      — the static data-storage term of eq. (10),
                              theta_i/KB * r_i * lam_i (also the per-unit-x
                              storage coefficient of (8h));
        * `kv_tok_per_x[I,J,K]` — resident KV tokens per unit x ((8f));
        * `load_per_x[I,J,K]`   — GFLOP-load per unit x ((8g));
        * `budget_per_x[I]`     — $ per unit x of data storage ((8c));
        * `cfg_by_nm[C]`    — config indices sorted by (nm, index), the scan
                              order M1/M3 tie-breaking is defined over.
        """
        I, J, K = self.I, self.J, self.K
        C = len(self.configs)
        # Memory feasibility of each config: B_eff/nm <= C_gpu (strict `>`
        # is the scalar discard condition, so keep `<=` here).
        per_dev = self.B_eff[:, :, None] / self.nm[None, None, :]   # [J,K,C]
        self.mem_ok = per_dev <= self.C_gpu[None, :, None]          # [J,K,C]
        if self.avail_gpus is not None:
            # Tier availability caps (core/faults.py): a config whose device
            # count alone exceeds the tier's cap can never be deployed there,
            # so it is statically infeasible — masking it here propagates
            # through cfg_m1 / m1_nm / cover_ok / m1_delay below.  The
            # cross-pair (shared-cap) part of the constraint is dynamic and
            # enforced by the `max_commit*` / `m3_upgrade` / Phase-1 guards.
            self.avail_gpus = np.asarray(self.avail_gpus, float)
            self.mem_ok = self.mem_ok & (
                self.nm[None, None, :] <= self.avail_gpus[None, :, None])
        # Joint M1 feasibility per candidate: memory AND delay SLO.
        feas = self.mem_ok[None, :, :, :] & (
            self.D_cfg <= self.Delta[:, None, None, None])          # [I,J,K,C]
        # Lexicographic argmin over (nm, delay, config index): first take the
        # minimal nm among feasible configs, then the minimal delay within
        # that nm level, then the first config index (np.argmax on a boolean
        # picks the first True) — exactly the scalar scan's tie-breaking.
        big = np.iinfo(np.int64).max
        nm_masked = np.where(feas, self.nm[None, None, None, :], big)
        nm_min = nm_masked.min(axis=3)                              # [I,J,K]
        any_feas = nm_min < big
        tie = feas & (nm_masked == nm_min[..., None])
        d_masked = np.where(tie, self.D_cfg, np.inf)
        d_min = d_masked.min(axis=3)
        first = tie & (d_masked == d_min[..., None])
        self.cfg_m1 = np.where(any_feas, first.argmax(axis=3), -1)  # [I,J,K]
        self.m1_nm = np.where(any_feas, nm_min, 0).astype(np.int64)
        # No-M1 ablation always "selects" the globally cheapest config.
        self.cfg_min_nm = int(np.argmin(self.nm))
        # Error-SLO admissibility and Phase-1 coverage mask.
        self.e_ok = self.e_bar <= self.eps[:, None, None]           # [I,J,K]
        self.cover_ok = (self.cfg_m1 >= 0) & self.e_ok
        # Static eq. (10) data term == per-unit-x coefficient of (8h).
        self.data_gb = self.theta / KB_PER_GB * self.r * self.lam   # [I]
        # Per-unit-x coefficients of the running-state caps.
        self.kv_tok_per_x = self.r[:, None, None] * self.T_res      # [I,J,K]
        self.load_per_x = (self.alpha * self.r[:, None, None]
                           * self.lam[:, None, None] / 1e3)         # [I,J,K]
        self.budget_per_x = self.Delta_T * self.p_s * self.data_gb  # [I]
        # Config scan order for M3: ascending (nm, index).
        self.cfg_by_nm = np.lexsort((np.arange(C), self.nm))
        # Gather support for the batched local-search engine: delay of the
        # M1 winner per (i,j,k) (value at config 0 where infeasible — dead
        # cells are always masked by the caller), a flat [J*K] index row,
        # and a zero-copy [I, J*K, C] view of D_cfg.  Flat fancy gathers
        # through these replace per-call `np.take_along_axis` grids, which
        # dominate the per-move cost at local-search call rates.
        self.m1_delay = np.take_along_axis(
            self.D_cfg, np.maximum(self.cfg_m1, 0)[..., None],
            axis=3)[..., 0]                                         # [I,J,K]
        self.jk_idx = np.arange(J * K)
        self.D_cfg_flat = self.D_cfg.reshape(I, J * K, C)
        # Flat [I, J*K] / [J*K] zero-copy views for the compressed-cells
        # cap evaluator (`max_commit_cells`) and the relocate screen's
        # upper-bound prefilter — gathering through these skips a reshape
        # per call, which adds up at local-search call rates.
        self.kv_tok_per_x_flat = self.kv_tok_per_x.reshape(I, J * K)
        self.load_per_x_flat = self.load_per_x.reshape(I, J * K)
        self.B_eff_flat = self.B_eff.reshape(J * K)
        # Constant factors hoisted out of `max_commit_batch` /
        # `rank_keys_all` — same operations on the same inputs, computed
        # once per instance instead of per call (the per-op dispatch cost
        # dominates at local-search call rates).
        self.kv_gb_per_tok = self.beta / KB_PER_GB                  # [J]
        self.comp_cap_coef = self.eta * 3600.0 * self.P_gpu         # [K]
        self.p_s_B = self.p_s * self.B                              # [J]
        self.e_bar_floor = np.maximum(self.e_bar, 1e-12)            # [I,J,K]
        self.e_bar_floor_flat = self.e_bar_floor.reshape(I, J * K)
        self.m1_feasible = self.cfg_m1 >= 0                         # [I,J,K]
        # Incremental rental of activating a pair at its M1 winner for type
        # i (0 GPUs where infeasible) — the inactive-destination branch of
        # the relocate delta objective, hoisted to a per-instance tensor.
        self.m1_rental = self.p_c[None, None, :] * self.m1_nm       # [I,J,K]
        # Device-resident tensor bundle for the XLA engine, built lazily
        # on first `engine="xla"` solve (see core/xla/tensors.py).  The
        # perturbed()/stressed()/with_lam() helpers construct fresh
        # Instance objects, so a cached bundle can never go stale.
        self._xla_tensors = None

    # --- sizes ---------------------------------------------------------
    @property
    def I(self) -> int:
        return len(self.query_names)

    @property
    def J(self) -> int:
        return len(self.model_names)

    @property
    def K(self) -> int:
        return len(self.tier_names)

    @property
    def n_cfg(self) -> int:
        return len(self.configs)

    def with_lam(self, lam: np.ndarray) -> "Instance":
        """A copy of this instance with a different demand vector."""
        new = dataclasses.replace(self, lam=np.asarray(lam, float))
        return new

    def perturbed(self, rng: np.random.Generator, d_infl: float = 0.25,
                  e_infl: float = 0.25, lam_pm: float = 0.20) -> "Instance":
        """One Stage-2 scenario: one-sided delay/error inflation, ±lam."""
        inst = dataclasses.replace(self)
        inst.tau = self.tau * (1.0 + rng.uniform(0.0, d_infl, self.I))
        inst.e_base = self.e_base * (1.0 + rng.uniform(0.0, e_infl, (self.I, self.J)))
        inst.lam = self.lam * (1.0 + rng.uniform(-lam_pm, lam_pm, self.I))
        inst.__post_init__()
        return inst

    def perturbed_batch(self, rng: np.random.Generator, S: int,
                        d_infl: float = 0.25, e_infl: float = 0.25,
                        lam_pm: float = 0.20) -> "ScenarioBatch":
        """S Stage-2 scenarios as stacked parameter tensors.

        Draws are taken scenario by scenario in exactly the order
        `perturbed` uses, so with the same generator the s-th row is
        bit-identical to the s-th sequential `perturbed` call — the batched
        and looped evaluation protocols sample the same scenarios.
        """
        I, J = self.I, self.J
        tau = np.empty((S, I))
        e_base = np.empty((S, I, J))
        lam = np.empty((S, I))
        for s in range(S):
            tau[s] = self.tau * (1.0 + rng.uniform(0.0, d_infl, I))
            e_base[s] = self.e_base * (1.0 + rng.uniform(0.0, e_infl, (I, J)))
            lam[s] = self.lam * (1.0 + rng.uniform(-lam_pm, lam_pm, I))
        return ScenarioBatch(S=S, tau=tau, e_base=e_base, lam=lam)

    def perturbed_chunks(self, rng: np.random.Generator, S: int,
                         chunk: int = 8192,
                         d_infl: float = 0.25, e_infl: float = 0.25,
                         lam_pm: float = 0.20):
        """Yield `perturbed_batch(S)` as successive `ScenarioBatch` chunks.

        Draws come from the same generator in the same scenario order, so
        concatenating the chunks is bit-identical to the one-shot
        `perturbed_batch(rng, S)` — but peak memory is O(chunk·I·J) instead
        of O(S·I·J), which is what lets `risk_evaluate` run S=10⁵ without a
        ~GB e_base allocation.  Pinned in tests/test_risk.py.
        """
        done = 0
        while done < S:
            n = min(chunk, S - done)
            yield self.perturbed_batch(rng, n, d_infl=d_infl,
                                       e_infl=e_infl, lam_pm=lam_pm)
            done += n

    def stressed(self, alpha_mult: float) -> "Instance":
        """Uniform delay+error inflation by `alpha_mult` (Fig. 3 / Fig. 5)."""
        inst = dataclasses.replace(self)
        inst.tau = self.tau * alpha_mult
        inst.e_base = self.e_base * alpha_mult
        inst.__post_init__()
        return inst


@dataclasses.dataclass
class ScenarioBatch:
    """Stacked realized parameters for S Stage-2 scenarios.

    Only the perturbable parameters are stored ([S, ...] rows of tau,
    e_base, lam); a `None` field means "base value in every scenario".
    `Stage2System.solve_batch` consumes the batch directly — no per-scenario
    `Instance` (and no `__post_init__` tensor rebuild) is ever materialized
    on the fast path.  `materialize` builds the s-th full `Instance` for
    cross-checking against the per-scenario reference protocol.
    """
    S: int
    tau: np.ndarray | None = None       # [S, I]
    e_base: np.ndarray | None = None    # [S, I, J]
    lam: np.ndarray | None = None       # [S, I]

    @staticmethod
    def from_lam_path(lam_path: np.ndarray) -> "ScenarioBatch":
        """A demand-only batch (rolling-horizon replay windows)."""
        lam_path = np.asarray(lam_path, float)
        return ScenarioBatch(S=lam_path.shape[0], lam=lam_path)

    def materialize(self, base: Instance, s: int) -> Instance:
        inst = dataclasses.replace(base)
        if self.tau is not None:
            inst.tau = self.tau[s].copy()
        if self.e_base is not None:
            inst.e_base = self.e_base[s].copy()
        if self.lam is not None:
            inst.lam = self.lam[s].copy()
        inst.__post_init__()
        return inst


def default_instance(seed: int = 0, budget: float = 100.0,
                     phi_v_mult: float = 1.0, zeta: float = 1.0) -> Instance:
    """The paper's base instance: I=6 query types, J=6 Llama-3.x models,
    K=10 GPU tiers (hardware × precision)."""
    rng = np.random.default_rng(seed)
    # Llama-3.x catalog: 1B..70B; B_j 2–140 GB; beta 31–305 KB/token (§5.1).
    model_names = ["llama3-1b", "llama3-3b", "llama3-8b",
                   "llama3-11b", "llama3-34b", "llama3-70b"]
    B = np.array([2.0, 6.0, 16.0, 22.0, 68.0, 140.0])
    beta = np.array([31.0, 52.0, 98.0, 122.0, 210.0, 305.0])

    lam = np.array([18000.0, 15000.0, 12000.0, 8000.0, 2500.0, 1500.0])
    h = np.array([2000.0, 512.0, 800.0, 300.0, 100.0, 150.0])
    f = np.array([200.0, 800.0, 600.0, 700.0, 1200.0, 2500.0])
    # Storage footprints are scaled below the paper's nominal KB/token range
    # so that the $100/day budget admits full coverage under OUR d_comp
    # calibration (documented deviation; the paper's relative text/image/
    # video ordering is preserved).
    theta = np.array([5.0, 4.0, 6.0, 4.5, 25.0, 40.0])
    Delta = np.array([2.5, 1.5, 2.0, 5.0, 16.0, 25.0])
    # ImageGen is the strict-accuracy type (eps 1.3%): only 34B+ models at
    # FP16/INT8 are admissible, so the big-model-on-small-tier tension the
    # paper's M1 guards against is present in the candidate set.
    eps = np.array([0.05, 0.02, 0.04, 0.03, 0.0155, 0.08])
    rho = np.array([2e-4, 3e-4, 1e-4, 6e-4, 7e-4, 1e-3])
    phi = np.array([600.0, 750.0, 500.0, 700.0,
                    1200.0 * phi_v_mult, 1500.0 * phi_v_mult])
    # FP16 base error rate: decreasing in model size, per-type difficulty.
    # Calibrated so that mid-size quantized models can meet strict accuracy
    # SLOs (INT8/INT4 within eps for 8B+), putting the INT-tier/accuracy
    # trade-off of §3.1(4) in play exactly as the paper describes.
    size_quality = np.array([0.055, 0.030, 0.015, 0.0138, 0.010, 0.007])
    difficulty = np.array([0.9, 0.85, 0.8, 1.1, 1.0, 1.0])
    e_base = difficulty[:, None] * size_quality[None, :]

    tier_names, C_gpu, P_gpu, p_c, BW, nu, mu = [], [], [], [], [], [], []
    for hw, prec in DEFAULT_TIERS:
        spec = GPU_HW[hw]
        tier_names.append(f"{hw}-{prec}")
        C_gpu.append(spec["mem"])
        P_gpu.append(spec["tflops"])
        # Quantized tiers rent slightly cheaper (spot-style discount).
        p_c.append(spec["price"] * {"FP16": 1.0, "INT8": 0.9, "INT4": 0.85}[prec])
        BW.append(spec["bw"])
        nu.append(NU[prec])
        mu.append(MU[prec])

    tau = np.array([1.0, 0.9, 0.95, 1.1, 1.2, 1.3])
    return Instance(
        query_names=list(QUERY_TYPES), model_names=model_names,
        tier_names=tier_names, tp_degrees=[1, 2, 4, 8], pp_depths=[1, 2, 4],
        lam=lam, h=h, f=f, theta=theta, B=B, beta=beta, e_base=e_base,
        C_gpu=np.array(C_gpu), P_gpu=np.array(P_gpu), p_c=np.array(p_c),
        BW=np.array(BW), nu=np.array(nu), mu=np.array(mu),
        Delta=Delta, eps=eps, rho=rho, phi=phi,
        zeta=np.full(6, zeta), p_s=float(rng.uniform(0.0005, 0.001)),
        delta=budget, C_s=1000.0, tau=tau)


def random_instance(I: int, J: int, K: int, seed: int = 0,
                    budget: float | None = None) -> Instance:
    """Synthetic instance of arbitrary size for the runtime-scaling study
    (paper Table 6 expands (I,J,K) up to (20,20,20))."""
    rng = np.random.default_rng(seed)
    base = default_instance(seed=seed)
    qi = rng.integers(0, base.I, size=I)
    lam = base.lam[qi] * rng.uniform(0.7, 1.3, I)
    h = base.h[qi] * rng.uniform(0.8, 1.2, I)
    f = base.f[qi] * rng.uniform(0.8, 1.2, I)
    theta = base.theta[qi] * rng.uniform(0.9, 1.1, I)
    Delta = base.Delta[qi] * rng.uniform(0.9, 1.3, I)
    eps = base.eps[qi] * rng.uniform(0.9, 1.4, I)
    rho, phi, tau = base.rho[qi], base.phi[qi], base.tau[qi]

    # Model catalog: log-spaced sizes 1B..70B.
    sizes = np.exp(rng.uniform(np.log(2.0), np.log(140.0), J))
    order = np.argsort(sizes)
    B = sizes[order]
    beta = 31.0 + (305.0 - 31.0) * (B - B.min()) / max(B.max() - B.min(), 1e-9)
    quality = 0.049 * (B / 2.0) ** -0.75 + 0.006
    difficulty = rng.uniform(0.8, 1.15, I)
    e_base = difficulty[:, None] * quality[None, :]

    hw_keys = list(GPU_HW)
    tier_names, C_gpu, P_gpu, p_c, BW, nu, mu = [], [], [], [], [], [], []
    for t in range(K):
        hw = hw_keys[t % len(hw_keys)]
        prec = PRECISIONS[(t // len(hw_keys)) % 3]
        spec = GPU_HW[hw]
        tier_names.append(f"{hw}-{prec}-{t}")
        C_gpu.append(spec["mem"])
        P_gpu.append(spec["tflops"] * rng.uniform(0.9, 1.1))
        p_c.append(spec["price"] * rng.uniform(0.85, 1.15)
                   * {"FP16": 1.0, "INT8": 0.9, "INT4": 0.85}[prec])
        BW.append(spec["bw"] * rng.uniform(0.95, 1.05))
        nu.append(NU[prec])
        mu.append(MU[prec])

    if budget is None:
        budget = 100.0 * I / 6.0
    return Instance(
        query_names=[f"q{i}" for i in range(I)],
        model_names=[f"m{j}" for j in range(J)], tier_names=tier_names,
        tp_degrees=[1, 2, 4, 8], pp_depths=[1, 2, 4],
        lam=lam, h=h, f=f, theta=theta, B=B, beta=beta, e_base=e_base,
        C_gpu=np.array(C_gpu), P_gpu=np.array(P_gpu), p_c=np.array(p_c),
        BW=np.array(BW), nu=np.array(nu), mu=np.array(mu),
        Delta=Delta, eps=eps, rho=rho, phi=phi, zeta=np.ones(I),
        p_s=float(rng.uniform(0.0005, 0.001)), delta=budget, C_s=1000.0 * I / 6.0,
        tau=tau)
