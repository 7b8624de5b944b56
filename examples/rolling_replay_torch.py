"""Rolling-horizon replay on the synthetic Azure-style diurnal trace
(paper §5.3, Table 5 / Fig. 6 at demo scale), on the PyTorch/CUDA port's
planner API.

The twin of examples/rolling_replay.py, on `repro_torch`. Compares
AGH-static vs AGH-5min, where the 5-minute variant replans through a
`PlanSession` — every window after the first warm-starts from the session
incumbent instead of running a cold multi-start. The planner's numpy
engine does all the work: nothing here runs on a device.

    PYTHONPATH=src python examples/rolling_replay_torch.py [--windows 96]
"""
import argparse

import numpy as np

from repro_torch import PlanOptions, PlanSession, scenario
from repro_torch.core.rolling import rolling
from repro_torch.core.trace import peak_to_trough


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=96)
    ap.add_argument("--day", default="busy", choices=["busy", "volatile"])
    args = ap.parse_args()

    spec = scenario("azure-diurnal" if args.day == "busy" else "bursty",
                    n_windows=args.windows)
    inst = spec.build()
    path = spec.demand_path(inst)
    print(f"trace: {args.windows} windows, "
          f"peak/trough = {peak_to_trough(path[:, 0] / inst.lam[0]):.1f}x")

    opts = PlanOptions(restarts=1, patience=2)
    r_static = rolling(inst, path, PlanSession(options=opts),
                       replan_every=None)
    session = PlanSession(options=opts)
    r_roll = rolling(inst, path, session, replan_every=4)

    print(f"\n{'':14s}{'mean/win':>10s}{'total':>12s}{'viol':>8s}{'replans':>9s}")
    for name, r in (("AGH-static", r_static), ("AGH-5min", r_roll)):
        print(f"{name:14s}{r.mean_window_cost:10.2f}{r.total_cost:12.1f}"
              f"{100*r.violation_rate:7.1f}%{r.replans:9d}")
    print(f"session: {session.plans} plans, "
          f"{session.warm_replans} warm replans")

    # coarse ASCII profile of per-window cost (static)
    c = r_static.per_window_cost
    q = np.quantile(c, [0, .5, 1])
    print(f"\nper-window cost (static): min={q[0]:.2f} med={q[1]:.2f} "
          f"max={q[2]:.2f}")
    bins = (c / max(c.max(), 1e-9) * 40).astype(int)
    for i in range(0, len(c), max(1, len(c) // 24)):
        print(f"  w{i:03d} {'#' * bins[i]}")


if __name__ == "__main__":
    main()
