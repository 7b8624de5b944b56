#!/usr/bin/env python3
"""Where the two scan backward kernels spend a chunk, phase by phase.

    python3 tools/scan_bwd_phases.py [--probe noshfl|noexp]

Copies `kernels/csrc/ssm_scan_bwd.cu` and `rwkv6_wkv_bwd.cu` into
`build/phases/`, adds a clock64() mark after every __syncthreads of the
chunk kernel and before the start of each sub-phase (every thread sums the
cycles between its marks over the sweep), builds the copies with the
flags of `kernels/_build.py`, runs each at chip_smoke.py phase 12.4's
shape (B 8, T 2048, f32, from zeros) through the kernels' own launchers,
and prints the cycles per chunk between marks, averaged over the blocks,
for the first thread of warps 0, 8 and 15. Each interval is named by
the phase it holds, in the order a chunk runs them (the phases of each
`.cu`; a barrier's interval includes the wait there).
`--probe` times a copy with one piece of the WKV diagonal blocks taken
out, to see what that piece costs: `noshfl` drops the shuffles that join
A's sums across lanes, `noexp` the exponentials. Those copies compute
wrong gradients and serve timing only. Needs a card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "phases"
THREADS = (0, 256, 480)   # the first threads of warps 0, 8 and 15
# Per library: the chunk kernel, the code that follows its chunk loop, the
# sub-phases' first lines, and what each mark's interval holds (the marks
# after the four barriers come first, then those at the sub-phases), in
# the order a chunk runs them.
KERNELS = {
    "ssm_scan_bwd": (
        "ssd_bwd_kernel", "  if (owns) {\n#pragma unroll\n"
        "    for (int k = 0; k < NTW; ++k) {\n      store2(ds_in",
        ["    // (b) dB (jobs < NTN) and dC",
         "    // (c) <Ge, S_in> and the step of G back"],
        [(1, "phase 1"), (2, "phase 2"), (4, "(a) d(dt x), dx"),
         (5, "(b) dB, dC"), (3, "(c) G's step, wait"),
         (0, "phase 4, next top")]),
    "rwkv6_wkv_bwd": (
        "wkv_bwd_kernel", "  if (owns) {\n#pragma unroll\n"
        "    for (int j = 0; j < NTW; ++j) {\n      store2(ds_in",
        ["    if (tid < NTH / 2) {\n      // (d) The diagonal",
         "    cp_async_wait<1>();   // this chunk's S_in has",
         "    // (f) rowsum(Ge S_in)"],
        [(1, "phase 1"), (4, "(c) A off the diagonal"),
         (5, "(d) or (e) diagonal blocks"), (2, "wait"),
         (6, "dv, dr, dk"), (3, "(f) G's step, wait"),
         (0, "phase 4, next top")]),
}
PROBES = {
    "noshfl": [("#pragma unroll\n        for (int o = E / 2; o > 0; o >>= 1)"
                "\n          sum += __shfl_xor_sync(0xffffffffu, sum, o);\n",
                "")],
    "noexp": [("fast_exp2((first ? cA[cc] : cB[cc]) - Cs[",
               "((first ? cA[cc] : cB[cc]) - Cs["),
              ("fast_exp2(Cs[t * LD + ch] -", "(Cs[t * LD + ch] -")],
}


def instrument(name: str, edits) -> tuple[ctypes.CDLL, int]:
    from repro_torch.kernels import _build

    kern, end_marker, anchors, _ = KERNELS[name]
    s = (CSRC / f"{name}.cu").read_text()
    for old, new in edits:
        if old not in s:
            raise SystemExit(f"{name}: probe text not found: {old[:60]!r}")
        s = s.replace(old, new)
    start = s.index(f"__launch_bounds__(NTH, 1) {kern}(")
    start = s.index("\n", s.index("extern __shared__", start)) + 1
    end = s.index(end_marker, start)
    body, count = s[start:end], [0]

    def mark(m):
        count[0] += 1
        return f"__syncthreads(); PHASE_MARK({count[0] - 1});"

    body = re.sub(r"__syncthreads\(\);", mark, body)
    for anchor in anchors:
        body = body.replace(anchor, f"PHASE_MARK({count[0]});\n{anchor}", 1)
        count[0] += 1
    n = count[0]
    write = "".join(
        f"  if (threadIdx.x == {t}) for (int i = 0; i < {n}; ++i) "
        f"g_phase[((blockIdx.y * gridDim.x + blockIdx.x) * 3 + {j}) * 8 + i]"
        f" = phase_acc[i];\n" for j, t in enumerate(THREADS))
    s = (s[:start] + f"  long long phase_acc[{n}] = {{}}, "
         "phase_last = clock64();\n" + body + write + s[end:])
    s = s.replace('#include "common.cuh"\n', '#include "common.cuh"\n'
                  "__device__ long long g_phase[8192 * 24];\n"
                  "#define PHASE_MARK(i) { const long long now = clock64(); "
                  "phase_acc[i] += now - phase_last; phase_last = now; }\n", 1)
    s += ("\nEXPORT int read_phases(long long* out, int n) { return "
          "cudaMemcpyFromSymbol(out, g_phase, n * sizeof(long long)); }\n")
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    src.write_text(s)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC),
                    "-o", str(lib), str(src)], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(lib)), n


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--probe", choices=sorted(PROBES))
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6_wkv import kernel as wk
    from repro_torch.kernels.rwkv6_wkv_bwd import kernel as wbk
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan_bwd import kernel as sbk

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    names = ["rwkv6_wkv_bwd"] if args.probe else list(KERNELS)
    for name in names:
        lib, n = instrument(name, PROBES.get(args.probe, []))
        _build._loaded[name] = lib
        scan = name[:-len("_bwd")]
        fwd, mod = ((sk.ssm_scan, sbk) if scan == "ssm_scan"
                    else (wk.rwkv6_wkv, wbk))
        getattr(mod, "_entry").cache_clear()
        bwd = getattr(mod, name)
        *ins, _ = cs.scan_inputs(scan, torch.float32, gen, dev, T=2048, B=8)
        dy = torch.randn(ins[0].shape, generator=gen, device=dev)
        _, _, states = fwd(*ins, None, with_states=True)
        ms = cs._event_ms(lambda: bwd(*ins, states, dy), 5)
        B, T, heads = ins[0].shape[:3]
        blocks = B * (-(-heads // 2) if scan == "ssm_scan" else heads)
        buf = (ctypes.c_longlong * (blocks * 24))()
        lib.read_phases(buf, blocks * 24)
        cyc = (np.array(buf[:]).reshape(blocks, 3, 8)[:, :, :n]
               / -(-T // 32))
        print(f"{name}{' --probe ' + args.probe if args.probe else ''}: "
              f"{ms:.4f} ms a call with the marks; cycles per chunk, mean "
              f"over {blocks} blocks:")
        for j, t in enumerate(THREADS):
            mean = cyc[:, j].mean(0)
            print(f"  thread {t}: " + ", ".join(
                f"{lab} {mean[i]:.0f}" for i, lab in KERNELS[name][3])
                + f"; total {mean.sum():.0f}")
        del ins, dy, states
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
