"""Run the full dry-run sweep: every (arch × shape × mesh) combination.

Each combination runs in a subprocess (its own fake process group, isolation
against failures) and appends its result to the JSON artifact that the
roofline analysis reads. The port's artifact is its own file, so the
reference's `experiments/dryrun_results.json` is never touched.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.sweep \
        [--json experiments/dryrun_results_torch.json] [--multi-pod-only] \
        [--single-pod-only] [--arch A ...] [--timeout 3600]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from ..configs import ARCH_IDS
from .specs import SHAPES

# Cheap combos first: coverage accumulates fastest and failures surface early.
_ARCH_ORDER = ["qwen2-0.5b", "qwen2-1.5b", "musicgen-medium", "rwkv6-7b",
               "deepseek-7b", "zamba2-7b", "llama4-scout-17b-a16e",
               "internvl2-26b", "qwen2-72b", "kimi-k2-1t-a32b"]
_SHAPE_ORDER = ["train_4k", "decode_32k", "prefill_32k", "long_500k"]


def load(path: str) -> list:
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json",
                    default="experiments/dryrun_results_torch.json")
    ap.add_argument("--timeout", type=float, default=3600.0)
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--rerun", action="store_true",
                    help="re-run combos already present in the JSON")
    args = ap.parse_args(argv)

    archs = args.arch or [a for a in _ARCH_ORDER if a in ARCH_IDS]
    meshes = [False, True]
    if args.multi_pod_only:
        meshes = [True]
    if args.single_pod_only:
        meshes = [False]

    combos = [(a, s, mp) for mp in meshes for a in archs
              for s in _SHAPE_ORDER if s in SHAPES]
    done = {(r["arch"], r["shape"], r["multi_pod"]) for r in load(args.json)
            if r.get("status") in ("ok", "skipped")}
    t0 = time.time()
    n_fail = 0
    for i, (a, s, mp) in enumerate(combos):
        if not args.rerun and (a, s, mp) in done:
            print(f"[{i+1}/{len(combos)}] skip (done): {a} {s} mp={mp}",
                  flush=True)
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", a, "--shape", s, "--json", args.json]
        if mp:
            cmd.append("--multi-pod")
        print(f"[{i+1}/{len(combos)}] {a} {s} mp={mp} "
              f"(t={time.time()-t0:.0f}s)", flush=True)
        env = dict(os.environ)
        env["PYTHONPATH"] = env.get("PYTHONPATH", "src")
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=args.timeout, env=env)
            if proc.returncode != 0:
                n_fail += 1
                tail = (proc.stderr or proc.stdout or "")[-2000:]
                print(f"  FAILED rc={proc.returncode}\n{tail}", flush=True)
                _record_failure(args.json, a, s, mp, tail)
        except subprocess.TimeoutExpired:
            n_fail += 1
            print("  TIMEOUT", flush=True)
            _record_failure(args.json, a, s, mp, "timeout")
    print(f"sweep done: {len(combos)} combos, {n_fail} failures, "
          f"{time.time()-t0:.0f}s", flush=True)
    return 1 if n_fail else 0


def _record_failure(path: str, arch: str, shape: str, mp: bool,
                    msg: str) -> None:
    data = load(path)
    data = [r for r in data if not (r["arch"] == arch and r["shape"] == shape
                                    and r["multi_pod"] == mp)]
    data.append(dict(arch=arch, shape=shape, multi_pod=mp, status="failed",
                     error=msg))
    with open(path, "w") as f:
        json.dump(data, f, indent=1, default=str)


if __name__ == "__main__":
    sys.exit(main())
