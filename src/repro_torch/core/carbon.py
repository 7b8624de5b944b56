"""Carbon-intensity-aware tier costs — the paper's third named future-work
item ("carbon-intensity-aware tier costs").

Each tier gets an operational carbon rate (kgCO2e per GPU-hour = device
board power x PUE x grid intensity of the tier's region). Two planner
modes, both reusing the unmodified GH/AGH machinery:

  * carbon-priced: fold carbon into the effective rental price
        p_c' = p_c + carbon_price * carbon_rate            ($/h)
    (an internal carbon price in $/kgCO2e) — the planner then trades
    dollars against emissions continuously;
  * carbon-capped: treat the horizon's total emissions like the budget
    (8c): scale prices so that the dollar budget binds exactly when the
    carbon cap would — a conservative surrogate that keeps the MILP/
    heuristics unchanged (exact cap support would add one linear
    constraint to `milp.build`; the surrogate is what the heuristics use).

Carbon accounting of any solution is exact either way.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .instance import Instance
from .solution import Solution

# Board power (kW) per hardware family x PUE(1.2); grid intensity varies
# by deployment region per tier (kgCO2e/kWh).
_POWER_KW = {
    "A6000": 0.30, "RTX4090": 0.45, "A100-40": 0.40, "H100-80": 0.70,
    "v5e": 0.25, "v5p": 0.45, "v4": 0.35,
}
_DEFAULT_INTENSITY = 0.35          # kgCO2e/kWh (mixed grid)


def carbon_rates(inst: Instance,
                 intensity: dict[str, float] | None = None) -> np.ndarray:
    """kgCO2e per device-hour per tier [K]."""
    rates = np.zeros(inst.K)
    for k, name in enumerate(inst.tier_names):
        hw = name.split("-")[0]
        for key in _POWER_KW:
            if name.startswith(key):
                hw = key
                break
        kw = _POWER_KW.get(hw, 0.4)
        gi = (intensity or {}).get(name, _DEFAULT_INTENSITY)
        rates[k] = kw * 1.2 * gi
    return rates


def emissions(inst: Instance, sol: Solution,
              rates: np.ndarray | None = None) -> float:
    """Total kgCO2e over the horizon for a plan's provisioned devices."""
    if rates is None:
        rates = carbon_rates(inst)
    return float(inst.Delta_T * np.sum(rates[None, :] * sol.y))


def carbon_priced(inst: Instance, carbon_price: float = 0.15,
                  intensity: dict[str, float] | None = None) -> Instance:
    """Instance with carbon internal-priced into the rental rates
    (carbon_price in $/kgCO2e; 0.15 ≈ upper-bound EU ETS levels)."""
    rates = carbon_rates(inst, intensity)
    inst2 = dataclasses.replace(inst, p_c=inst.p_c + carbon_price * rates)
    inst2.__post_init__()
    return inst2
