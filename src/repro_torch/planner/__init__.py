# The planner facade: one entry point over every allocation solver
# (`plan()`/`PlanRequest`/`PlanResult`), the solver registry and the
# declarative scenario specs, and warm-started replanning sessions
# (`PlanSession`); `plan(options=PlanOptions(risk=...))` runs the port's
# scenario-batched risk solver on the solved plan.
from repro_torch.core.tier import EngineUnavailableError

from .api import PlanOptions, PlanRequest, PlanResult, plan
from .registry import (SolverSpec, UnknownSolverError, get_solver,
                       register_solver, solver_names, unregister_solver)
from .session import PlanSession
from .specs import (SCENARIOS, FleetSpec, ScenarioSpec, SLOSpec,
                    WorkloadSpec, list_scenarios, scenario)

__all__ = [
    "EngineUnavailableError",
    "PlanOptions", "PlanRequest", "PlanResult", "plan",
    "SolverSpec", "UnknownSolverError", "get_solver", "register_solver",
    "solver_names", "unregister_solver",
    "PlanSession",
    "SCENARIOS", "FleetSpec", "ScenarioSpec", "SLOSpec", "WorkloadSpec",
    "list_scenarios", "scenario",
]
