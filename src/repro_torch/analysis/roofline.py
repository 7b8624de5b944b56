"""Roofline analysis over the dry-run artifacts (EXPERIMENTS.md §Roofline),
with the H100 data-sheet constants of `launch.mesh`.

Per (arch × shape × mesh):
    compute    = HLO_FLOPs_per_device / peak_FLOPs          [s]
    memory     = HLO_bytes_per_device / HBM_bw              [s]
    collective = collective_bytes_per_device / ICI_bw       [s]
plus MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference), N = active params,
D = tokens processed, and the usefulness ratio MODEL_FLOPS / HLO_FLOPs
(catches remat / masked-attention / capacity-factor waste).

    PYTHONPATH=src python -m repro_torch.analysis.roofline \
        [--json experiments/dryrun_results_torch.json] [--md]
"""
from __future__ import annotations

import argparse
import json
import sys

from ..launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16
from ..launch.specs import SHAPES

_ADVICE = {
    "compute": ("skip fully-masked attention blocks / drop the capacity "
                "factor — most HLO FLOPs above MODEL_FLOPS are maskable"),
    "memory": ("decode is weight-stream-bound: quantize weights or raise "
               "batch to amortize the per-token parameter read"),
    "collective": ("reshard to keep the contraction local (move FSDP "
                   "gathers off the critical path / overlap with compute)"),
}


def tokens_of(shape: str) -> int:
    s = SHAPES[shape]
    if s["kind"] == "decode":
        return s["global_batch"]          # one new token per sequence
    return s["global_batch"] * s["seq_len"]


def analyze_row(r: dict) -> dict | None:
    if r.get("status") != "ok":
        return None
    n_dev = r["n_devices"]
    comp = r["hlo_flops_per_device"] / PEAK_FLOPS_BF16
    mem = r["hlo_bytes_per_device"] / HBM_BW
    coll = r["collective_bytes_per_device"] / ICI_BW
    terms = dict(compute=comp, memory=mem, collective=coll)
    dominant = max(terms, key=terms.get)
    D = tokens_of(r["shape"])
    mult = 6.0 if r["kind"] == "train" else 2.0
    model_flops = mult * r["params_active"] * D
    hlo_total = r["hlo_flops_per_device"] * n_dev
    ratio = model_flops / hlo_total if hlo_total else float("nan")
    return dict(
        arch=r["arch"], shape=r["shape"],
        mesh="2x16x16" if r["multi_pod"] else "16x16",
        compute_s=comp, memory_s=mem, collective_s=coll,
        dominant=dominant,
        model_flops=model_flops, hlo_flops_total=hlo_total,
        useful_ratio=ratio,
        advice=_ADVICE[dominant],
        collectives=r.get("collectives", {}),
    )


def markdown_table(rows: list[dict]) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | "
           "dominant | MODEL/HLO flops |\n"
           "|---|---|---|---|---|---|---|---|\n")
    body = ""
    for a in rows:
        body += ("| %s | %s | %s | %.3e | %.3e | %.3e | **%s** | %.3f |\n"
                 % (a["arch"], a["shape"], a["mesh"], a["compute_s"],
                    a["memory_s"], a["collective_s"], a["dominant"],
                    a["useful_ratio"]))
    return hdr + body


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json",
                    default="experiments/dryrun_results_torch.json")
    ap.add_argument("--md", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    with open(args.json) as f:
        data = json.load(f)
    rows = [a for a in (analyze_row(r) for r in data) if a]
    rows.sort(key=lambda a: (a["mesh"], a["arch"], a["shape"]))
    if args.md:
        print(markdown_table(rows))
    else:
        print(json.dumps(rows, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
