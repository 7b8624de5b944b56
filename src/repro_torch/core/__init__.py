# The allocator the serving path plans with: GH / AGH over the paper's
# P_DM instance, and the bridge from a plan to deployed pairs. Numpy host
# code, kept as a copy of the reference package's modules.
from .agh import agh, agh_repair
from .bridge import DeploymentSpec, PairDeployment, to_deployment
from .gh import gh, greedy_heuristic
from .instance import Instance, default_instance, random_instance
from .solution import Solution, feasibility, is_feasible, objective

__all__ = [
    "agh", "agh_repair", "gh", "greedy_heuristic", "Instance",
    "default_instance", "random_instance", "Solution", "feasibility",
    "is_feasible", "objective", "DeploymentSpec", "PairDeployment",
    "to_deployment",
]
