"""repro_torch.serving — the closed-loop serving layer and the engine.

Public API (numpy/stdlib only — importing it never touches torch):

* `serve(plan, instance=..., traffic=TrafficSpec(...),
  controller=ControllerSpec(...)) -> ServeResult` — the closed-loop
  driver (`driver.py`): plan-aware routing, forecast-aware replanning,
  per-window observability;
* the typed specs/result (`types.py`), the concurrency-bound derivation
  (`stations.py`), the Mélange-style router (`router.py`), and the
  controller (`controller.py`);
* `simulate()` — the legacy open-loop simulator (`simulator.py`), kept
  with its original semantics (bit-identical under an explicit
  ``max_batch``);
* `Engine` — the torch batched execution engine (static-batch prefill +
  greedy decode), loaded lazily on first attribute access so the rest of
  the layer stays importable without torch.
"""
from __future__ import annotations

from .controller import ReplanController
from .driver import serve
from .router import Router
from .simulator import SimStats, simulate
from .stations import StationSim, build_stations, station_b_max
from .types import (ControllerSpec, ReplanEvent, ServeResult, Station,
                    TrafficSpec)

_ENGINE_EXPORTS = ("Engine", "Request")

__all__ = [
    "serve", "ServeResult", "TrafficSpec", "ControllerSpec", "Station",
    "ReplanEvent", "ReplanController", "Router", "StationSim",
    "build_stations", "station_b_max", "simulate", "SimStats",
    *_ENGINE_EXPORTS,
]


def __getattr__(name: str):
    if name in _ENGINE_EXPORTS:
        from . import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
