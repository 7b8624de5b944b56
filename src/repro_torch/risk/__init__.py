"""repro_torch.risk — scenario-batched tail-risk evaluation.

Lazy exports: importing `repro_torch.risk` stays cheap and numpy-only; the
batched solver (which pulls in torch) loads only when the pdhg engine or
`BatchedStage2Solver` itself is first touched.
"""
from __future__ import annotations

from typing import Any

_EXPORTS = {
    "risk_evaluate": ".api",
    "rank_deployments": ".api",
    "RiskReport": ".api",
    "ENGINES": ".api",
    "risk_stats": ".metrics",
    "var_cvar": ".metrics",
    "tail_attribution": ".metrics",
    "ALPHAS": ".metrics",
    "ExactChunkSolver": ".solver_exact",
    "BatchedStage2Solver": ".solver",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str) -> Any:
    mod_name = _EXPORTS.get(name)
    if mod_name is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(mod_name, __name__)
    value = getattr(mod, name)
    globals()[name] = value
    return value


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(__all__))
