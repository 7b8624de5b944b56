"""Quickstart on the PyTorch/CUDA port: plan a heterogeneous serving fleet
through the unified planner API in <5 seconds.

The twin of examples/quickstart.py, on `repro_torch`:

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda]

Shows the whole surface: named scenario specs, the solver registry, the
structured `PlanResult` (cost breakdown, per-constraint slack, solver
diagnostics), AGH on the lane-batched torch tier, and warm-started
replanning with `PlanSession`. The torch tier runs on CUDA unless
--device cpu is given, and raises without a card.
"""
import argparse

import numpy as np

from repro_torch import (EngineUnavailableError, PlanOptions, PlanSession,
                         list_scenarios, plan, scenario, solver_names)
from repro_torch.core import evaluate
from repro_torch.core.bridge import to_deployment


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the torch tier runs: cuda (default) or "
                         "cpu; raises without a card")
    args = ap.parse_args()

    # The paper's base scenario: 6 query types (Azure-trace-calibrated),
    # 6 Llama-3.x models, 10 GPU tiers, $100/day budget.
    spec = scenario("paper-default")
    inst = spec.build()
    print("Registered solvers:", ", ".join(solver_names()))
    print("Registered scenarios:", ", ".join(list_scenarios()))
    print(f"Scenario '{spec.name}': {inst.I} query types, "
          f"{inst.J} models, {inst.K} tiers")

    for solver in ("gh", "agh"):
        res = plan(solver, instance=inst)
        cb = res.cost_breakdown
        print(f"\n{solver}: solved in {res.wall_s*1e3:.0f} ms, "
              f"objective ${res.objective:.2f} "
              f"(rental ${cb['rental']:.2f} + penalties "
              f"${cb['delay_penalty'] + cb['unmet_penalty']:.2f}), "
              f"feasible={res.feasible}")
        print("  binding slack: " + ", ".join(
            f"{k}={v:.3g}" for k, v in sorted(res.slack.items(),
                                              key=lambda kv: kv[1])[:3]))
        for p in to_deployment(inst, res.solution).pairs:
            routed = ", ".join(f"{q}:{frac:.0%}"
                               for q, frac in p.routing.items())
            print(f"  {p.model} on {p.tier}: TP={p.tp} PP={p.pp} "
                  f"({p.n_chips} GPUs) <- {routed}")

    # The torch engine: same AGH, multi-start as one batched lane axis on
    # the card, numpy path as the oracle (objective can only match or
    # beat it). A missing card is an error here, not a fallback: the
    # numpy engine runs above already.
    try:
        res_t = plan("agh", instance=inst,
                     options=PlanOptions(engine="torch", device=args.device))
    except EngineUnavailableError as exc:
        raise SystemExit(f"engine='torch' unavailable: {exc}") from exc
    print(f"\nagh on engine='torch': ${res_t.objective:.2f} in "
          f"{res_t.wall_s*1e3:.0f} ms "
          f"({res_t.diagnostics.get('orderings_evaluated')} orderings "
          f"batched, {res_t.diagnostics.get('device_calls_phase2')} "
          f"phase-2 device calls)")

    # Warm-started replanning: demand drifts, the session replans from
    # its incumbent instead of re-solving cold.
    ses = PlanSession()
    ses.plan(instance=inst)
    drifted = inst.with_lam(inst.lam * np.linspace(1.1, 0.9, inst.I))
    res = ses.replan(instance=drifted)
    print(f"\nreplan after demand drift: ${res.objective:.2f} in "
          f"{res.wall_s*1e3:.0f} ms (warm-started="
          f"{res.diagnostics.get('warm_started')}, "
          f"{res.diagnostics.get('orderings_evaluated')} orderings)")

    # Two-stage robustness check (paper §5.2, small S for the demo).
    res = plan("agh", instance=inst)
    ev = evaluate(inst, res.solution, S=50, u_cap=np.full(6, 0.02))
    print(f"\nAGH under 50 perturbed scenarios: expected cost "
          f"${ev.expected_cost:.1f}, SLO violations "
          f"{ev.violation_rate:.1%}")


if __name__ == "__main__":
    main()
