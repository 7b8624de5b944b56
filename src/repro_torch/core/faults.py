"""Supply-side fault injection — the ROADMAP's "failures, spot tiers,
regions" scenario axis.

Every scenario family so far perturbs *demand* (`perturbed`, `stressed`,
the diurnal traces); production fleets also lose *supply*: spot-priced
tiers get revoked, a region's capacity drops mid-replay, a tier's rental
price spikes.  This module models those disruptions as typed, seeded
events composed into a `FaultSchedule` over replay windows, and turns a
schedule into effective per-window instances:

* Event taxonomy — `TierOutage` (a tier's capacity goes to zero),
  `SpotRevocation` (a fraction of a spot tier's pool is reclaimed),
  `CapacityShock` (fleet-wide or single-tier availability multiplier),
  `PriceSpike` (rental price multiplier), `Recovery` (clips every event
  active on a tier — "the provider restored capacity early").  All are
  frozen dataclasses over window indices: an event spans ``[t0, t1)``.
* `FaultSchedule.avail_frac(t)` / `price_mult(t)` fold the active events
  into per-tier multipliers (availability composes by min, prices by
  product); `change_points()` lists every window where the supply state
  differs from the previous window — the event-driven replan triggers.
* `apply_faults(inst, schedule, t)` materializes the effective instance
  for window t: prices scaled, `Instance.avail_gpus` capped at
  ``floor(frac * nominal)``.  With no nominal cap set, only full outages
  (frac == 0) bind — partial revocation of an unbounded fleet is a no-op
  by construction (documented; benchmarks set nominal caps from the
  initial plan's usage).
* Generators — `poisson_revocations` (seeded Poisson process per
  spot-priced tier), `diurnal_outages` (outage start times biased toward
  the demand peak — correlated failures are the hard case), plus
  `with_spot_tiers` to mark a subset of tiers spot-priced (discounted
  rental, revocation rate).
* Eviction — `lost_pairs` / `evict_unavailable`: which active pairs must
  be shut down so every tier fits its (newly reduced) cap, dropping the
  smallest deployments first (minimal disruption, deterministic order).
  This is the supply-side entry point of the repair path
  (`core.agh.agh_repair`).

Determinism: every generator takes an explicit seed and draws through
`np.random.default_rng` — the schedule for a given (instance, seed) is
reproducible byte for byte.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .instance import Instance
from .solution import Solution
from .trace import diurnal_multipliers

_EPS = 1e-9


# ---------------------------------------------------------------------------
# Event taxonomy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TierOutage:
    """Tier `tier` has zero capacity over windows [t0, t1)."""
    tier: int
    t0: int
    t1: int


@dataclasses.dataclass(frozen=True)
class SpotRevocation:
    """Fraction `frac` of tier `tier`'s pool is reclaimed over [t0, t1).

    ``frac=1.0`` (the default drawn by `poisson_revocations`) reclaims
    the whole tier — on an unbounded fleet that is the only binding
    shape; fractional revocations bind once `Instance.avail_gpus` sets a
    nominal pool size."""
    tier: int
    t0: int
    t1: int
    frac: float = 1.0


@dataclasses.dataclass(frozen=True)
class CapacityShock:
    """Availability multiplier `avail_frac` over [t0, t1) — fleet-wide
    when `tier` is None, else that tier only."""
    t0: int
    t1: int
    avail_frac: float
    tier: int | None = None


@dataclasses.dataclass(frozen=True)
class PriceSpike:
    """Rental price of tier `tier` multiplied by `mult` over [t0, t1)."""
    tier: int
    t0: int
    t1: int
    mult: float


@dataclasses.dataclass(frozen=True)
class Recovery:
    """At window `t`, every event active on `tier` ends early (all tiers
    when `tier` is None) — capacity restored ahead of schedule."""
    t: int
    tier: int | None = None


FaultEvent = TierOutage | SpotRevocation | CapacityShock | PriceSpike


def _event_tier(e: FaultEvent) -> int | None:
    return getattr(e, "tier", None)


# ---------------------------------------------------------------------------
# Schedule
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A set of fault events over an `n_windows`-window replay.

    The schedule is pure data: `avail_frac` / `price_mult` fold the
    events active at a window into per-tier multipliers, and
    `change_points` resolves every window at which the folded supply
    state changes — the replay's event-driven replan triggers.
    """
    n_windows: int
    events: tuple[FaultEvent | Recovery, ...] = ()

    @property
    def is_empty(self) -> bool:
        return not any(not isinstance(e, Recovery) for e in self.events)

    def _end(self, e: FaultEvent) -> int:
        """Effective end window of `e` after Recovery clipping."""
        t1 = int(e.t1)
        tier = _event_tier(e)
        for r in self.events:
            if not isinstance(r, Recovery):
                continue
            if r.tier is not None and tier is not None and r.tier != tier:
                continue
            if e.t0 < r.t < t1:
                t1 = int(r.t)
        return t1

    def active(self, t: int) -> tuple[FaultEvent, ...]:
        """Events in force at window t (Recovery clipping applied)."""
        return tuple(e for e in self.events
                     if not isinstance(e, Recovery)
                     and e.t0 <= t < self._end(e))

    def avail_frac(self, t: int, K: int) -> np.ndarray:
        """[K] per-tier availability multiplier at window t (min-composed)."""
        frac = np.ones(K)
        for e in self.active(t):
            if isinstance(e, TierOutage):
                frac[e.tier] = 0.0
            elif isinstance(e, SpotRevocation):
                frac[e.tier] = min(frac[e.tier], 1.0 - float(e.frac))
            elif isinstance(e, CapacityShock):
                if e.tier is None:
                    frac = np.minimum(frac, float(e.avail_frac))
                else:
                    frac[e.tier] = min(frac[e.tier], float(e.avail_frac))
        return np.clip(frac, 0.0, 1.0)

    def price_mult(self, t: int, K: int) -> np.ndarray:
        """[K] per-tier rental-price multiplier at window t (product)."""
        mult = np.ones(K)
        for e in self.active(t):
            if isinstance(e, PriceSpike):
                mult[e.tier] *= float(e.mult)
        return mult

    def state_key(self, t: int, K: int) -> bytes:
        """Hashable supply state at window t — equal keys mean the same
        effective instance (used to cache `apply_faults` materializations
        across windows)."""
        return (self.avail_frac(t, K).tobytes()
                + self.price_mult(t, K).tobytes())

    def change_points(self, K: int) -> list[int]:
        """Windows t >= 1 where the supply state differs from window t-1
        (sorted).  Window 0's state is the initial plan's problem, not a
        change."""
        pts = []
        prev = self.state_key(0, K)
        for t in range(1, self.n_windows):
            cur = self.state_key(t, K)
            if cur != prev:
                pts.append(t)
            prev = cur
        return pts


# ---------------------------------------------------------------------------
# Effective instances
# ---------------------------------------------------------------------------

def apply_faults(inst: Instance, schedule: FaultSchedule, t: int) -> Instance:
    """The effective instance at window t: rental prices scaled by the
    active price multipliers, `avail_gpus` capped at ``floor(frac *
    nominal)`` per tier.  Returns `inst` itself (no copy, no tensor
    rebuild) when nothing is active at t."""
    K = inst.K
    af = schedule.avail_frac(t, K)
    pm = schedule.price_mult(t, K)
    if np.all(af >= 1.0 - _EPS) and np.all(np.abs(pm - 1.0) <= _EPS):
        return inst
    changes: dict = {}
    if np.any(np.abs(pm - 1.0) > _EPS):
        changes["p_c"] = inst.p_c * pm
    if np.any(af < 1.0 - _EPS):
        if inst.avail_gpus is not None:
            nominal = np.asarray(inst.avail_gpus, float)
            changes["avail_gpus"] = np.where(
                af <= _EPS, 0.0, np.floor(nominal * af))
        else:
            # Unbounded nominal fleet: partial fractions cannot bind (a
            # fraction of infinity is infinity); full outages become a
            # zero cap, everything else stays unbounded.
            changes["avail_gpus"] = np.where(af <= _EPS, 0.0, np.inf)
    return dataclasses.replace(inst, **changes)


def with_spot_tiers(inst: Instance, tiers: np.ndarray,
                    discount: float = 0.8,
                    revoke_rate: float = 0.25) -> Instance:
    """Mark a subset of tiers spot-priced: rental discounted by
    `discount`, revocable at `revoke_rate` Poisson revocations/hour.
    `tiers` is a [K] boolean mask or an index array."""
    mask = np.zeros(inst.K, dtype=bool)
    tiers = np.asarray(tiers)
    if tiers.dtype == bool:
        mask[:] = tiers
    else:
        mask[tiers] = True
    return dataclasses.replace(
        inst,
        p_c=np.where(mask, inst.p_c * discount, inst.p_c),
        spot=mask,
        revoke_rate=np.where(mask, float(revoke_rate), 0.0))


# ---------------------------------------------------------------------------
# Seeded generators
# ---------------------------------------------------------------------------

def poisson_revocations(inst: Instance, n_windows: int,
                        window_h: float | None = None, seed: int = 0,
                        frac: float = 1.0,
                        duration_windows: int | None = None
                        ) -> list[SpotRevocation]:
    """Seeded Poisson revocation process per spot-priced tier.

    Each tier with ``revoke_rate > 0`` draws revocation events at its
    rate (events/hour x `window_h` hours per window); each event
    reclaims `frac` of the tier's pool for `duration_windows` windows
    (default: ~1 hour's worth, at least one window).  Deterministic for
    a given (instance, seed) pair."""
    if inst.revoke_rate is None:
        return []
    if window_h is None:
        window_h = 24.0 / n_windows
    if duration_windows is None:
        duration_windows = max(1, int(round(1.0 / window_h)))
    rng = np.random.default_rng(seed)
    events: list[SpotRevocation] = []
    for k in range(inst.K):
        rate = float(inst.revoke_rate[k])
        if rate <= 0.0:
            continue
        # Exponential inter-arrival times in hours over the replay span.
        t_h = float(rng.exponential(1.0 / rate))
        span_h = n_windows * window_h
        while t_h < span_h:
            t0 = int(t_h / window_h)
            if t0 < n_windows:
                events.append(SpotRevocation(
                    tier=k, t0=t0,
                    t1=min(n_windows, t0 + duration_windows),
                    frac=float(frac)))
            t_h += float(rng.exponential(1.0 / rate))
    return events


def diurnal_outages(inst: Instance, n_windows: int, n_events: int,
                    seed: int = 0, day: str = "busy",
                    duration_windows: int | None = None
                    ) -> list[TierOutage]:
    """Outages whose start times are biased toward the diurnal demand
    peak — correlated supply loss under load is the stress case the
    repair path must survive.  Tiers are drawn uniformly; start windows
    are drawn proportionally to the diurnal multiplier."""
    if duration_windows is None:
        duration_windows = max(1, n_windows // 12)
    rng = np.random.default_rng(seed)
    mult = diurnal_multipliers(day, seed=seed, n_windows=n_windows)
    p = np.asarray(mult, float)
    p = p / p.sum()
    starts = rng.choice(n_windows, size=n_events, p=p)
    tiers = rng.integers(0, inst.K, size=n_events)
    return [TierOutage(tier=int(k), t0=int(t0),
                       t1=min(n_windows, int(t0) + duration_windows))
            for k, t0 in zip(tiers, starts, strict=True)]


# ---------------------------------------------------------------------------
# Eviction (the supply-side entry point of the repair path)
# ---------------------------------------------------------------------------

def lost_pairs(inst: Instance, y: np.ndarray) -> list[tuple[int, int]]:
    """Pairs to evict so every tier fits its availability cap.

    Per over-subscribed tier, active pairs are dropped smallest-y-first
    (ties by model index) until the tier is within its cap —
    deterministic, minimal-disruption.  Empty when no caps are set or
    nothing is over."""
    if inst.avail_gpus is None:
        return []
    y = np.asarray(y, float)
    out: list[tuple[int, int]] = []
    for k in range(inst.K):
        cap = float(inst.avail_gpus[k])
        used = float(y[:, k].sum())
        if used <= cap + _EPS:
            continue
        jj = np.nonzero(y[:, k] > 0.5)[0]
        for j in jj[np.lexsort((jj, y[jj, k]))]:
            out.append((int(j), int(k)))
            used -= float(y[j, k])
            if used <= cap + _EPS:
                break
    return out


def evict_unavailable(inst: Instance, sol: Solution
                      ) -> tuple[Solution, list[tuple[int, int]]]:
    """Solution-level eviction: zero out the pairs on lost capacity and
    push their routed traffic into unmet — what a frozen static
    placement actually serves while operated through a fault."""
    lost = lost_pairs(inst, sol.y)
    if not lost:
        return sol, []
    out = sol.copy()
    for (j, k) in lost:
        out.x[:, j, k] = 0.0
        out.z[:, j, k] = 0.0
        out.q[j, k] = 0.0
        out.y[j, k] = 0.0
        out.w[j, k, :] = 0.0
    out.u = np.clip(1.0 - out.x.sum(axis=(1, 2)), 0.0, 1.0)
    return out, lost
