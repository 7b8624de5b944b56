"""Supply-side eviction: the one piece of the fault model the allocator's
warm-start path needs (`agh._warm_start_state`, `agh.agh_repair`).

A copy of `lost_pairs` from the reference package's fault model; the fault
events, schedules and generators are not part of the port yet.
"""
from __future__ import annotations

import numpy as np

from .instance import Instance

_EPS = 1e-9


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
