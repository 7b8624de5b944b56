# The allocator: GH / AGH over the paper's P_DM instance, the exact MILP and
# the baselines, the Stage-2 LP system, the supply-fault model, the
# queueing margin, rolling-horizon replays, and the bridge from a plan to
# deployed pairs. Numpy/scipy host code, kept as a copy of the reference
# package's modules; `tier` loads the lane-batched torch tier lazily.
from .agh import agh, agh_repair
from .baselines import dvr, hf, lpr
from .bridge import DeploymentSpec, PairDeployment, to_deployment
from .evaluate import EvalResult, evaluate
from .faults import (CapacityShock, FaultSchedule, PriceSpike, Recovery,
                     SpotRevocation, TierOutage, apply_faults,
                     diurnal_outages, evict_unavailable, lost_pairs,
                     poisson_revocations, with_spot_tiers)
from .gh import gh, greedy_heuristic
from .instance import (Instance, ScenarioBatch, default_instance,
                       random_instance)
from .mechanisms import (MoveScores, State, m1_select, m3_upgrade,
                         max_commit, max_commit_batch, rank_keys_all,
                         score_moves_batch, solution_from_state,
                         state_objective)
from .milp import solve_milp
from .queueing import (queueing_delay, slo_attainment_with_queueing,
                       utilization, with_queueing_margin)
from .rolling import RollingResult, replay_study, rolling, volatility_study
from .solution import (Solution, cost_terms, feasibility, is_feasible,
                       objective, proc_delay, provisioning_cost,
                       slack_report)
from .stage2 import Stage2System, stage2_cost, stage2_lp
from .tier import EngineUnavailableError

__all__ = [
    "agh", "agh_repair", "dvr", "hf", "lpr", "EvalResult", "evaluate", "gh",
    "greedy_heuristic",
    "Instance", "ScenarioBatch", "default_instance", "random_instance",
    "CapacityShock", "FaultSchedule", "PriceSpike", "Recovery",
    "SpotRevocation", "TierOutage", "apply_faults", "diurnal_outages",
    "evict_unavailable", "lost_pairs", "poisson_revocations",
    "with_spot_tiers",
    "MoveScores", "State", "m1_select", "m3_upgrade", "max_commit",
    "max_commit_batch", "rank_keys_all", "score_moves_batch",
    "solution_from_state", "state_objective",
    "solve_milp", "RollingResult", "replay_study",
    "rolling", "volatility_study", "Solution", "cost_terms", "feasibility",
    "is_feasible", "objective", "proc_delay", "provisioning_cost",
    "slack_report", "Stage2System", "stage2_cost", "stage2_lp",
    "DeploymentSpec", "PairDeployment", "to_deployment",
    "EngineUnavailableError",
]
