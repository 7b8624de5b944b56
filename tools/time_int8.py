#!/usr/bin/env python3
"""Time the grouped int8 GEMM of the W8A8 experts on one card, beside what
the bf16 experts run instead and the per-expert library loop.

    python3 tools/time_int8.py

For each served W8A8 shape (chip_smoke.py's `_int8_shapes`: kimi-k2's
products at a prefill of 8 prompts padded to 999 tokens and at a decode
step, llama4-scout's w1), on random int8 operands: the kernel's time
(CUDA events, 10 calls after a warm-up), whether it equals the plain
version bit for bit, its bound (bytes of a, b and the int32 output at
3.35 TB/s against 2 E C K N operations at 1,979 TOP/s int8), the same
product in bf16 by `torch.bmm` (the bf16 MoE path's expert product) and,
where torch._int_mm takes the shape (more than 16 rows), a loop of one
_int_mm per expert. The card's name and power limit come first.
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
from repro_torch.kernels.int8_grouped_matmul import kernel as gk  # noqa: E402
from repro_torch.kernels.int8_grouped_matmul.ref import \
    int8_grouped_matmul_ref  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, E, C, K, N in cs._int8_shapes():
        a = torch.randint(-128, 128, (E, C, K), generator=gen, device=dev,
                          dtype=torch.int8)
        b = torch.randint(-128, 128, (E, K, N), generator=gen, device=dev,
                          dtype=torch.int8)
        same = torch.equal(gk.int8_grouped_matmul(a, b),
                           int8_grouped_matmul_ref(a, b))
        ms = cs._event_ms(lambda: gk.int8_grouped_matmul(a, b), 10)
        bnd, by = cs.bound(a.numel() + b.numel() + 4 * E * C * N,
                           2.0 * E * C * K * N, cs.PEAK_INT8_OPS)
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        bf16 = cs._event_ms(lambda: torch.bmm(a16, b16), 5)
        del a16, b16
        loop = "n/a (C <= 16)"
        if C > 16:
            loop_ms = cs._event_ms(
                lambda: [torch._int_mm(a[e], b[e]) for e in range(E)], 3)
            loop = f"{loop_ms:.4f} ms"
        print(f"{label} [{E},{C},{K}] x [{E},{K},{N}]: "
              f"{'equal' if same else 'MISMATCH'}, {ms:.4f} ms, bound "
              f"{bnd:.4f} ms ({by}), bf16 bmm {bf16:.4f} ms, _int_mm loop "
              f"{loop}", flush=True)
        del a, b
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
