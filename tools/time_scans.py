#!/usr/bin/env python3
"""Time the two scan kernels of one or more trees side by side, on one card.

    python3 tools/time_scans.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository (for instance a
`git archive` of another commit unpacked into a directory `.gitignore`
lists). Each runs in its own process, builds its own kernels into its own
`build/kernels/`, and prints, for `ssm_scan` and `rwkv6_wkv` at the served
shapes (chip_smoke.py's `scan_inputs`, f32, from a nonzero state), the
best of three CUDA-graph timings (chip_smoke.py's `time_ms`, 20 calls
each) and the largest errors of y and the final state against the plain
version; then, at the training shape of chip_smoke.py's phase 12.4 (B 8,
T 2048, f32, from zeros), the forward with its chunk states and the
backward (`ssm_scan_bwd`, `rwkv6_wkv_bwd`), each the best of three
CUDA-graph timings. Give the trees in turns (A B B A) to see the spread.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

CHILD = r"""
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.kernels.rwkv6_wkv import kernel as wk
from repro_torch.kernels.rwkv6_wkv.ref import rwkv6_wkv_ref
from repro_torch.kernels.rwkv6_wkv_bwd import kernel as wbk
from repro_torch.kernels.ssm_scan import kernel as sk
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.kernels.ssm_scan_bwd import kernel as sbk

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(4)
for name, kern, ref, bwd in (
        ("ssm_scan", sk.ssm_scan, ssm_scan_ref, sbk.ssm_scan_bwd),
        ("rwkv6_wkv", wk.rwkv6_wkv, rwkv6_wkv_ref, wbk.rwkv6_wkv_bwd)):
    *ins, s0 = cs.scan_inputs(name, torch.float32, gen, dev)
    y, s = kern(*ins, s0)
    want_y, want_s = ref(*ins, s0)
    ey = (y - want_y).abs().max().item()
    es = (s - want_s).abs().max().item()
    ms = min(cs.time_ms([lambda: kern(*ins, s0)], n=20)[0] for _ in range(3))
    print(f"{sys.argv[1]} {name}: {ms:.4f} ms, max err y {ey:.3e}, "
          f"state {es:.3e}", flush=True)
    *ins, _ = cs.scan_inputs(name, torch.float32, gen, dev, T=2048, B=8)
    dy = torch.randn(ins[0].shape, generator=gen, device=dev)
    _, _, states = kern(*ins, None, with_states=True)
    fwd = min(cs.time_ms([lambda: kern(*ins, None, with_states=True)],
                         n=12)[0] for _ in range(3))
    ms = min(cs.time_ms([lambda: bwd(*ins, states, dy)], n=6)[0]
             for _ in range(3))
    print(f"{sys.argv[1]} {name}_bwd [B 8, T 2048, f32, from zeros]: "
          f"{ms:.4f} ms; forward with chunk states {fwd:.4f} ms",
          flush=True)
    del ins, dy, states
    torch.cuda.empty_cache()
"""


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for tree in argv:
        root = Path(tree).resolve()
        subprocess.run([sys.executable, "-c", CHILD, tree], cwd=root,
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
