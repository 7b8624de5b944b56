"""Planner CLI: run AGH (or GH / exact MILP) on the paper instance or the
TPU tier catalog and emit the deployment spec the serving launcher consumes.

    PYTHONPATH=src python -m repro_torch.launch.plan --method agh --tiers tpu \
        [--budget 100] [--calibrate experiments/dryrun_results.json] \
        [--out deployment.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="agh",
                    choices=["agh", "gh", "milp", "lpr", "dvr", "hf"])
    ap.add_argument("--tiers", default="gpu", choices=["gpu", "tpu"])
    ap.add_argument("--budget", type=float, default=100.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calibrate", default=None,
                    help="dry-run JSON to re-fit decode coefficients from")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from ..core import (agh, default_instance, dvr, gh, hf, lpr, objective,
                        provisioning_cost, solve_milp)
    from ..core.bridge import calibrate_from_dryrun, to_deployment, tpu_instance

    inst = default_instance(seed=args.seed, budget=args.budget)
    if args.tiers == "tpu":
        inst = tpu_instance(inst)
    if args.calibrate:
        arch_to_model = {  # framework archs standing in for catalog sizes
            "qwen2-0.5b": 0, "qwen2-1.5b": 1, "rwkv6-7b": 2,
            "deepseek-7b": 3, "internvl2-26b": 4, "qwen2-72b": 5}
        inst = calibrate_from_dryrun(inst, args.calibrate, arch_to_model)

    solver = dict(agh=agh, gh=gh, lpr=lpr, dvr=dvr, hf=hf,
                  milp=lambda i: solve_milp(i, time_limit=600))[args.method]
    sol = solver(inst)
    spec = to_deployment(inst, sol)
    out = dict(
        method=sol.method, runtime_s=round(sol.runtime_s, 4),
        objective=round(objective(inst, sol), 2),
        stage1_cost=round(provisioning_cost(inst, sol), 2),
        unmet=[round(float(u), 4) for u in sol.u],
        pairs=[dataclasses.asdict(p) for p in spec.pairs])
    txt = json.dumps(out, indent=2)
    print(txt)
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
