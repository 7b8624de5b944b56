"""Declarative scenario specs: fleet x workload x SLO -> `Instance`.

Replaces the ad-hoc `default_instance(...)` / `random_instance(...)`
kwarg-wiring that every benchmark and example hand-rolled.  A scenario is
three orthogonal pieces:

* `FleetSpec`    — which hardware catalog serves (the paper's GPU tier
  table, or the TPU tier catalog from `core/bridge.py`) and which (TP, PP)
  lattice is allowed;
* `WorkloadSpec` — which query-type population (the paper's Azure-trace-
  calibrated six types, or a synthetic population of any size) and which
  demand process drives replays (flat / diurnal / bursty / random-walk);
* `SLOSpec`      — budget, penalty multipliers, unmet caps, and optional
  uniform delay+error stress.

`ScenarioSpec.build()` composes them into a fully derived `Instance`;
`ScenarioSpec.demand_path()` materializes the demand process as a
[T, I] arrival path for rolling-horizon replays.  Named generators
(`scenario("paper-default")`, "azure-diurnal", "bursty", "budget-tight",
"tpu-fleet", "fleet-scale", ...) cover the repo's standard studies; new
workload families are one registry entry, not a new kwargs plumbing job.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.instance import Instance, default_instance, random_instance
from repro_torch.core.trace import (diurnal_multipliers, multi_day_multipliers,
                              random_walk_lambdas)


# Grid carbon intensity by region, kgCO2e per kWh (rounded long-run
# averages: hydro/nuclear-heavy EU-North vs coal-heavy Asia-East).  Keyed
# by the region names `FleetSpec.regions` draws from.
REGION_INTENSITY: dict[str, float] = {
    "eu-north": 0.04,
    "us-central": 0.40,
    "asia-east": 0.60,
}


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Hardware catalog + parallelism lattice + supply economics.

    ``spot_tiers`` marks part of the catalog spot-priced through
    `core.faults.with_spot_tiers` — ``"quantized"`` puts the
    INT-quantized tiers on spot (the cheap, revocable capacity pool),
    ``"all"`` the whole fleet; rental is discounted by ``spot_discount``
    and revocable at ``spot_revoke_rate`` Poisson revocations/hour
    (consumed by `ScenarioSpec.fault_schedule`).

    ``regions`` places tiers round-robin across named regions and, with
    ``carbon_price`` ($/kgCO2e), folds each region's grid carbon
    intensity (`REGION_INTENSITY`) into the rental rate via
    `core.carbon.carbon_priced` — the multi-region cost asymmetry the
    planner then arbitrages.  ``carbon_price`` without ``regions`` prices
    every tier at the default grid intensity.
    """
    catalog: str = "gpu"                    # "gpu" (paper) | "tpu" (bridge)
    tp_degrees: tuple[int, ...] | None = None
    pp_depths: tuple[int, ...] | None = None
    spot_tiers: str | None = None           # None | "quantized" | "all"
    spot_discount: float = 0.8
    spot_revoke_rate: float = 0.25
    regions: tuple[str, ...] | None = None
    carbon_price: float | None = None

    def apply(self, inst: Instance) -> Instance:
        if self.catalog == "tpu":
            from repro_torch.core.bridge import tpu_instance
            inst = tpu_instance(inst)
        elif self.catalog != "gpu":
            raise ValueError(f"unknown fleet catalog {self.catalog!r} "
                             f"(expected 'gpu' or 'tpu')")
        if self.tp_degrees is not None or self.pp_depths is not None:
            inst = dataclasses.replace(
                inst,
                tp_degrees=list(self.tp_degrees or inst.tp_degrees),
                pp_depths=list(self.pp_depths or inst.pp_depths))
            inst.__post_init__()
        if self.carbon_price is not None:
            from repro_torch.core.carbon import carbon_priced
            inst = carbon_priced(inst, carbon_price=self.carbon_price,
                                 intensity=self.tier_intensity(inst))
        if self.spot_tiers is not None:
            from repro_torch.core.faults import with_spot_tiers
            inst = with_spot_tiers(inst, self.spot_mask(inst),
                                   discount=self.spot_discount,
                                   revoke_rate=self.spot_revoke_rate)
        return inst

    def spot_mask(self, inst: Instance) -> np.ndarray:
        """[K] bool mask of the spot-priced tiers under ``spot_tiers``."""
        if self.spot_tiers == "all":
            return np.ones(inst.K, dtype=bool)
        if self.spot_tiers == "quantized":
            return np.array(["INT" in str(n).upper()
                             for n in inst.tier_names], dtype=bool)
        raise ValueError(f"unknown spot_tiers {self.spot_tiers!r} "
                         f"(expected 'quantized' or 'all')")

    def region_of(self, inst: Instance) -> tuple[str, ...] | None:
        """Tier -> region assignment (round-robin over ``regions``)."""
        if self.regions is None:
            return None
        R = len(self.regions)
        return tuple(self.regions[k % R] for k in range(inst.K))

    def tier_intensity(self, inst: Instance) -> dict[str, float] | None:
        """Per-tier-name grid intensity for `core.carbon` (None = default
        intensity everywhere)."""
        placed = self.region_of(inst)
        if placed is None:
            return None
        return {str(n): REGION_INTENSITY[r]
                for n, r in zip(inst.tier_names, placed, strict=True)}


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Query-type population + demand process.

    ``family="paper"`` uses the Azure-trace-calibrated base population
    (§5.1); ``family="synthetic"`` draws a population of (I, J, K) types /
    models / tiers with `random_instance`.  ``demand`` picks the temporal
    process for `demand_path`: "flat" (constant), "diurnal" (busy-day
    trace replica), "bursty" (volatile-day replica: deeper peaks, heavier
    noise), "multi-day" (busy+volatile concatenation), or "random-walk"
    (geometric, volatility ``sigma``).
    """
    family: str = "paper"
    I: int = 6
    J: int = 6
    K: int = 10
    lam_scale: float = 1.0
    demand: str = "flat"
    n_windows: int = 288
    days: tuple[str, ...] = ("busy", "volatile")
    sigma: float = 0.03


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Budget / penalty / stress knobs."""
    budget: float | None = None
    phi_v_mult: float = 1.0
    zeta: float = 1.0
    stress: float | None = None             # uniform delay+error inflation


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    name: str = "custom"
    fleet: FleetSpec = dataclasses.field(default_factory=FleetSpec)
    workload: WorkloadSpec = dataclasses.field(default_factory=WorkloadSpec)
    slo: SLOSpec = dataclasses.field(default_factory=SLOSpec)
    seed: int = 0

    def build(self) -> Instance:
        """The fully derived `Instance` for this scenario."""
        w, s = self.workload, self.slo
        if w.family == "paper":
            inst = default_instance(
                seed=self.seed,
                budget=100.0 if s.budget is None else s.budget,
                phi_v_mult=s.phi_v_mult, zeta=s.zeta)
        elif w.family == "synthetic":
            inst = random_instance(w.I, w.J, w.K, seed=self.seed,
                                   budget=s.budget)
            if s.zeta != 1.0 or s.phi_v_mult != 1.0:
                inst = dataclasses.replace(
                    inst, zeta=np.full(inst.I, s.zeta),
                    phi=inst.phi * s.phi_v_mult)
                inst.__post_init__()
        else:
            raise ValueError(f"unknown workload family {w.family!r} "
                             f"(expected 'paper' or 'synthetic')")
        inst = self.fleet.apply(inst)
        if s.stress is not None:
            inst = inst.stressed(s.stress)
        if w.lam_scale != 1.0:
            inst = inst.with_lam(inst.lam * w.lam_scale)
        return inst

    def demand_path(self, inst: Instance | None = None) -> np.ndarray:
        """[T, I] arrival path realizing the workload's demand process."""
        inst = inst if inst is not None else self.build()
        w = self.workload
        if w.demand == "flat":
            return np.tile(inst.lam, (w.n_windows, 1))
        if w.demand == "diurnal":
            mult = diurnal_multipliers("busy", seed=self.seed + 7,
                                       n_windows=w.n_windows)
        elif w.demand == "bursty":
            mult = diurnal_multipliers("volatile", seed=self.seed + 7,
                                       n_windows=w.n_windows)
        elif w.demand == "multi-day":
            mult = multi_day_multipliers(w.days, seed=self.seed + 7,
                                         n_windows=w.n_windows)
        elif w.demand == "random-walk":
            rng = np.random.default_rng(self.seed)
            return random_walk_lambdas(inst.lam, w.sigma, w.n_windows, rng)
        else:
            raise ValueError(f"unknown demand process {w.demand!r}")
        return np.outer(mult, inst.lam)

    def fault_schedule(self, inst: Instance | None = None,
                       n_windows: int | None = None,
                       frac: float = 1.0):
        """Seeded supply-fault schedule matching this scenario's spot
        economics: a Poisson revocation process over the spot tiers
        (`core.faults.poisson_revocations`, rate from the fleet's
        ``spot_revoke_rate``).  Returns an EMPTY `FaultSchedule` when the
        fleet has no spot tiers — callers can pass it to `rolling`
        unconditionally."""
        from repro_torch.core.faults import FaultSchedule, poisson_revocations
        inst = inst if inst is not None else self.build()
        T = n_windows if n_windows is not None else self.workload.n_windows
        events = poisson_revocations(inst, T, seed=self.seed + 13,
                                     frac=frac)
        return FaultSchedule(n_windows=T, events=tuple(events))


# ---------------------------------------------------------------------------
# Named scenario generators
# ---------------------------------------------------------------------------

SCENARIOS: dict[str, ScenarioSpec] = {
    # The paper's base instance (§5.1): Azure-trace-calibrated workload
    # statistics on the NVIDIA GPU tier table.
    "paper-default": ScenarioSpec(name="paper-default"),
    # Same calibration with the diurnal busy-day replay process attached
    # (Table 5 / Fig. 6).
    "azure-diurnal": ScenarioSpec(
        name="azure-diurnal",
        workload=WorkloadSpec(demand="diurnal")),
    # Volatile-day replica: ~15.6x peak-to-trough, heavier-tailed noise.
    "bursty": ScenarioSpec(
        name="bursty", workload=WorkloadSpec(demand="bursty")),
    # Tight-budget stress (the paper's S3 scenario: $72/day).
    "budget-tight": ScenarioSpec(
        name="budget-tight", slo=SLOSpec(budget=72.0)),
    # High-penalty + tight budget (S5): image/video unmet penalties x5.
    "high-penalty": ScenarioSpec(
        name="high-penalty", slo=SLOSpec(budget=72.0, phi_v_mult=5.0)),
    # The paper's planner provisioning a TPU fleet (core/bridge.py tier
    # catalog: v5e/v5p/v4 x bf16/int8, TP up to 16).
    "tpu-fleet": ScenarioSpec(
        name="tpu-fleet", fleet=FleetSpec(catalog="tpu")),
    # Beyond-paper fleet-scale population (the allocator's scaling size).
    "fleet-scale": ScenarioSpec(
        name="fleet-scale",
        workload=WorkloadSpec(family="synthetic", I=100, J=80, K=40),
        seed=42),
    # Out-of-sample robustness: 1.5x uniform delay+error inflation.
    "stress-1.5x": ScenarioSpec(
        name="stress-1.5x", slo=SLOSpec(stress=1.5)),
    # Spot economics: the INT-quantized tiers move to a 20%-discounted,
    # revocable spot pool; `.fault_schedule()` yields the matching Poisson
    # revocation process for failure replays (core/faults.py).
    "spot-fleet": ScenarioSpec(
        name="spot-fleet",
        fleet=FleetSpec(spot_tiers="quantized"),
        workload=WorkloadSpec(demand="diurnal")),
    # Carbon-priced multi-region fleet: tiers round-robin across three
    # grids (core/carbon.py intensities), carbon folded into rental at
    # $0.15/kgCO2e — clean-region capacity gets structurally cheaper.
    "multi-region": ScenarioSpec(
        name="multi-region",
        fleet=FleetSpec(regions=("eu-north", "us-central", "asia-east"),
                        carbon_price=0.15)),
}


def list_scenarios() -> tuple[str, ...]:
    return tuple(sorted(SCENARIOS))


def scenario(name: str, *, seed: int | None = None,
             n_windows: int | None = None,
             budget: float | None = None) -> ScenarioSpec:
    """Look up a named scenario, optionally overriding the common knobs.

    Unknown names raise with the registered list, mirroring the solver
    registry's contract.
    """
    spec = SCENARIOS.get(name)
    if spec is None:
        raise KeyError(f"unknown scenario {name!r}; registered scenarios: "
                       f"{', '.join(list_scenarios())}")
    if seed is not None:
        spec = dataclasses.replace(spec, seed=seed)
    if n_windows is not None:
        spec = dataclasses.replace(
            spec, workload=dataclasses.replace(spec.workload,
                                               n_windows=n_windows))
    if budget is not None:
        spec = dataclasses.replace(
            spec, slo=dataclasses.replace(spec.slo, budget=budget))
    return spec
