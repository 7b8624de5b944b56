# The allocator: GH / AGH over the paper's P_DM instance, the exact MILP and
# the baselines, the Stage-2 LP system, the supply-fault model, and the
# bridge from a plan to deployed pairs. Numpy/scipy host code, kept as a
# copy of the reference package's modules.
from .agh import agh, agh_repair
from .baselines import dvr, hf, lpr
from .bridge import DeploymentSpec, PairDeployment, to_deployment
from .faults import (CapacityShock, FaultSchedule, PriceSpike, Recovery,
                     SpotRevocation, TierOutage, apply_faults,
                     diurnal_outages, evict_unavailable, lost_pairs,
                     poisson_revocations, with_spot_tiers)
from .gh import gh, greedy_heuristic
from .instance import (Instance, ScenarioBatch, default_instance,
                       random_instance)
from .milp import solve_milp
from .solution import (Solution, cost_terms, feasibility, is_feasible,
                       objective, provisioning_cost, slack_report)
from .stage2 import Stage2System, stage2_cost, stage2_lp
from .tier import EngineUnavailableError

__all__ = [
    "agh", "agh_repair", "dvr", "hf", "lpr", "gh", "greedy_heuristic",
    "Instance", "ScenarioBatch", "default_instance", "random_instance",
    "CapacityShock", "FaultSchedule", "PriceSpike", "Recovery",
    "SpotRevocation", "TierOutage", "apply_faults", "diurnal_outages",
    "evict_unavailable", "lost_pairs", "poisson_revocations",
    "with_spot_tiers", "solve_milp", "Solution", "cost_terms",
    "feasibility", "is_feasible", "objective", "provisioning_cost",
    "slack_report", "Stage2System", "stage2_cost", "stage2_lp",
    "DeploymentSpec", "PairDeployment", "to_deployment",
    "EngineUnavailableError",
]
