#!/usr/bin/env python3
"""Time the grouped int8 GEMM of the W8A8 experts on one card: the K-major
`wgmma` kernel (the served one) beside the N-major `mma.sync` kernel
on the same operands, and beside what the bf16 experts run instead.

    python3 tools/time_int8.py

For each served W8A8 shape (chip_smoke.py's `_int8_shapes`: kimi-k2's
products at a prefill of 8 prompts padded to 999 tokens and at a decode
step, llama4-scout's w1), on random int8 operands (dense: every expert
filled) and, at the decode shapes, on the a of a served decode step
(routed: only the experts its 8 tokens chose are non-zero,
`chip_smoke.routed_a`): both kernels bit for bit against the plain
version, each kernel's time in turns (K-major, N-major, N-major,
K-major; CUDA-graph replays of 20 calls), the K-major kernel's pre-pass
alone, the dense bound (bytes of a, b and the int32 output at 3.35 TB/s
against 2 E C K N operations at 1,979 TOP/s int8) and, routed, the bound
on the filled experts' bytes; the same product in bf16 by `torch.bmm`
(the bf16 MoE path's expert product) and, where torch._int_mm takes the
shape (more than 16 rows), a loop of one _int_mm per expert. This is
`chip_smoke.check_and_time_int8` with the bf16 column; the card's name
and power limit come first, a summary table last.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    timed = cs.check_and_time_int8(torch.device("cuda"), 0, bf16_bmm=True)
    print("shape | K-major ms | N-major ms | pre-pass ms | bound ms (by) | "
          "share | bf16 bmm ms")
    for label, t in timed.items():
        bnd, by = ((t["routed_bound_ms"], t["routed_bound_by"] + ", routed")
                   if "routed_bound_ms" in t else (t["bound_ms"],
                                                   t["bound_by"]))
        print(f"{label} {t['shape']} | {t['ms']:.4f} | {t['nmajor_ms']:.4f} "
              f"| {t['prepass_ms']:.4f} | {bnd:.4f} ({by}) | "
              f"{100 * bnd / t['ms']:.1f} % | {t['bf16_bmm_ms']:.4f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
