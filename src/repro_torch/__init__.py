"""repro_torch — the reproduction on PyTorch and CUDA.

A port of the JAX package `repro` for an NVIDIA H100: the allocator
(`core`, numpy), the planner facade (`planner`), the scenario-batched
Stage-2 risk solver (`risk`, f64 on the card), the decoder for the
attention, RWKV6, Mamba2 and hybrid families (`models`, `configs`), its
hand-written Hopper kernels (`kernels`: flash prefill, flash decode, the
SSD and WKV scans), the batched engine (`serving`) and the plan -> deploy
-> serve launcher (`launch`). Entry points run on CUDA unless the caller
passes `device="cpu"`.

The package root re-exports the planner API lazily (`plan`,
`PlanOptions`, `PlanResult`, `register_solver`, ...): ``from repro_torch
import plan`` imports neither torch nor the model and kernel subpackages.
"""
from __future__ import annotations

# Lazily resolved from repro_torch.planner (numpy/scipy only).
_PLANNER_EXPORTS = (
    "plan", "PlanOptions", "PlanRequest", "PlanResult",
    "SolverSpec", "UnknownSolverError", "EngineUnavailableError",
    "register_solver", "solver_names",
    "unregister_solver", "FleetSpec", "WorkloadSpec", "SLOSpec",
    "ScenarioSpec", "scenario", "list_scenarios",
)

__all__ = list(_PLANNER_EXPORTS)


def __getattr__(name: str):
    if name in _PLANNER_EXPORTS:
        from repro_torch import planner
        return getattr(planner, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
