#!/usr/bin/env python3
"""Time the port's in-place AdamW update on one card at several piece
sizes, and the memory each allocates beyond the weights, gradients and
moments.

    python3 tools/time_adamw.py [--pieces 22 24 25 26 27]

The tree is llama4-scout-17b-a16e's largest leaves at one full-width
layer: the 202,048 x 5,120 embedding and head and the 16 experts' w1 (16
x 5,120 x 8,192), bf16 weights and gradients, f32 moments (2.74e9
elements, 33 GB). For each piece size 2**k (`optimizer.PIECE`)
`apply_updates` runs in turns (sizes in order, then in reverse,
`--rounds` times), each call timed by
CUDA events; printed per size: the median ms, the bytes the update must
move (read the weight, gradient and both moments, write the weight and
both moments, read the gradient again for the global norm: 24 B an
element) over 3.35 TB/s as its bound, and the peak bytes allocated
beyond the tree. The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.training import optimizer  # noqa: E402

SHAPES = dict(embed=(202_048, 5_120), head=(5_120, 202_048),
              w1=(16, 5_120, 8_192))
HBM_BYTES_PER_S = 3.35e12


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pieces", type=int, nargs="+",
                    default=[22, 24, 25, 26, 27])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def tree(scale, dtype):
        return {k: (scale * torch.randn(s, generator=gen, device=dev))
                .to(dtype) for k, s in SHAPES.items()}

    params, grads = tree(1.0, torch.bfloat16), tree(1e-3, torch.bfloat16)
    state = dict(mu=tree(1e-3, torch.float32),
                 nu={k: t.abs_() for k, t in tree(1e-6,
                                                  torch.float32).items()},
                 step=torch.zeros((), dtype=torch.int32, device=dev))
    cfg = optimizer.AdamWConfig()
    n = sum(t.numel() for t in params.values())
    bound_ms = 24 * n / HBM_BYTES_PER_S * 1e3
    times: dict[int, list[float]] = {k: [] for k in args.pieces}
    extra: dict[int, int] = {}
    order = list(args.pieces)
    for r in range(2 * args.rounds + 1):     # round 0 warms up
        for k in (order if r % 2 == 0 else order[::-1]):
            optimizer.PIECE = 1 << k
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            optimizer.apply_updates(cfg, params, grads, state)
            b.record()
            torch.cuda.synchronize()
            extra[k] = max(extra.get(k, 0),
                           torch.cuda.max_memory_allocated() - base)
            if r:
                times[k].append(a.elapsed_time(b))
    print(f"{n / 1e9:.3f}e9 elements; bound {bound_ms:.2f} ms (24 B an "
          f"element at 3.35 TB/s)")
    print("| piece | median ms | all ms | share of bound | extra GiB |")
    print("|---|---|---|---|---|")
    for k in args.pieces:
        med = float(np.median(times[k]))
        print(f"| 2**{k} | {med:.2f} | {[round(t, 2) for t in times[k]]} | "
              f"{bound_ms / med:.3f} | {extra[k] / 2 ** 30:.3f} |",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
