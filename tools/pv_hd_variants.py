#!/usr/bin/env python3
"""Time variants of the head_dim-split softmax and P V kernel side by side,
on one card.

    python3 tools/pv_hd_variants.py

Run from the root of a checkout. Each variant is
`src/repro_torch/kernels/csrc/decode_attention_hd.cu` with a few text
edits, built with the repo's nvcc flags into `build/pv_hd_variants/` (one
nvcc each, all started together) and called through the repo's wrapper
(`decode_softmax_pv_hd`, its C entry point swapped for the variant's):

  tree     the source as it is;
  combine  the runs merged by a second kernel (one block a group), as
           before the merge was folded into the launch;
  ring3, ring6
           a ring of 3 or 6 stages instead of 4;
  copies   the ring's copies and the merges, no softmax or P V: the floor
           that the copies alone set (its output is wrong).

Prints nvcc's spill report of the tree's softmax instances, then at each
shape (those of tools/time_decode_hd.py, and qwen2-72b's at B 1, cut into
64 runs a group) the best of three CUDA-graph timings (chip_smoke.py's
`time_ms`, each call on its own scores and v) of each variant, with the
cut's runs a group at RUNS_PER_SM 4 and, for the tree, 3, 6 and 8,
beside the bytes bound and the largest error against the plain version.
The variants go in turns (tree first and last) to show the spread.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, ".")
sys.path.insert(0, "src")
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention_hd import kernel as hk  # noqa: E402
from repro_torch.kernels.decode_attention_hd.ref import (  # noqa: E402
    decode_softmax_pv_hd_ref)

COMBINE_KERNEL = r"""
template <typename T>
__global__ void __launch_bounds__(NTH) combine_kernel(
    const float* __restrict__ ws, T* __restrict__ o, int n_split, int G,
    int HL, Strides so) {
  const int kvh = blockIdx.x, b = blockIdx.y, KV = gridDim.x;
  const int n_out = G * HL, stride = part_floats(G, HL);
  const float* base = ws + (int64_t)(b * KV + kvh) * n_split * stride;
  T* ob = o + b * so.b + kvh * so.h;
  for (int idx = threadIdx.x; idx < n_out; idx += NTH) {
    const int g = idx / HL, d = idx % HL;
    float M = -INFINITY;
    for (int r = 0; r < n_split; ++r)
      M = fmaxf(M, base[r * stride + n_out + g]);
    float L = 0.f, O = 0.f;
    if (M != -INFINITY)
      for (int r = 0; r < n_split; ++r) {
        const float* part = base + r * stride;
        const float w = exp2f(part[n_out + g] - M);
        L = fmaf(part[n_out + G + g], w, L);
        O = fmaf(part[idx], w, O);
      }
    ob[g * so.t + d] = from_float<T>(M == -INFINITY ? 0.f : O / L);
  }
}

template <typename T>
cudaError_t launch_scores("""
LAUNCH = "      a.scale * 1.4426950408889634f, a.ss, a.sv, a.so);\n"
VARIANTS = {
    "tree": [],
    "combine": [
        ("  __threadfence();\n  __syncthreads();\n  if (tid == 0)\n",
         "  if (n_split > 1) return;   // the second kernel merges\n"
         "  __threadfence();\n  __syncthreads();\n  if (tid == 0)\n"),
        ("\ntemplate <typename T>\ncudaError_t launch_scores(",
         "\n" + COMBINE_KERNEL),
        (LAUNCH + "  return cudaGetLastError();",
         LAUNCH + "  if (cudaPeekAtLastError() != cudaSuccess || a.n_split == 1)"
         "\n    return cudaGetLastError();\n  combine_kernel<T><<<dim3(a.KV, "
         "a.B), NTH, 0, a.stream>>>(a.ws, static_cast<T*>(a.o), a.n_split, "
         "a.G, a.HL, a.so);\n  return cudaGetLastError();")],
    "ring3": [("constexpr int RING = 4;", "constexpr int RING = 3;")],
    "ring6": [("constexpr int RING = 4;", "constexpr int RING = 6;")],
    "copies": [("    for (int step = 0; step < n_team; ++step) {",
                "    for (int step = 0; step < (left < 0 ? n_team : 0); "
                "++step) {")],
}
SHAPES = [("qwen2-72b 16x16", 8, 8, 8, 32768, 8),
          ("qwen2-0.5b 16x16", 8, 2, 7, 32768, 4),
          ("qwen2-1.5b 4 cards", 8, 2, 6, 1024, 32),
          ("qwen2-72b 16x16 at B 1", 1, 8, 8, 32768, 8)]
PLAN = [("tree", 4), ("tree", 3), ("tree", 6), ("tree", 8), ("combine", 4),
        ("ring3", 4), ("ring6", 4), ("copies", 4), ("tree", 4)]
OUT = Path("build/pv_hd_variants")


def edited(src: str, edits) -> str:
    for a, b in edits:
        if src.count(a) != 1:
            raise RuntimeError(f"edit does not apply once: {a!r}")
        src = src.replace(a, b)
    return src


def build() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    for h in _build.HEADERS:
        (OUT / h).write_text((_build.CSRC / h).read_text())
    src = (_build.CSRC / "decode_attention_hd.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        (OUT / f"{name}.cu").write_text(edited(src, edits))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(OUT / f"lib{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entries = {}
    argtypes = hk._entry("decode_softmax_pv_hd_fwd").argtypes
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        if name == "tree":
            report_spills(log)
        fn = ctypes.CDLL(str(OUT / f"lib{name}.so")).decode_softmax_pv_hd_fwd
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        entries[name] = fn
    return entries


def report_spills(log: str) -> None:
    """One line a softmax instance: its template arguments, registers and
    spill bytes."""
    cur, spills = None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*softmax_pv_kernel(\S+)'",
                      line)
        if m:
            cur = m.group(1)[:40]
        elif cur and "spill" in line:
            spills = line.strip()
        elif cur and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            print(f"tree softmax_pv_kernel{cur}: {regs} registers, {spills}",
                  flush=True)
            cur = None


def main() -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    entries = build()
    own_entry, own_rps = hk._entry, hk.RUNS_PER_SM
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, B, KV, G, S, hl in SHAPES:
        scores_b = 4.0 * B * KV * G * S
        b_ms, b_by = cs.bound(scores_b + 2 * B * KV * S * hl + 4 * S
                              + 2 * B * KV * G * hl,
                              2.0 * B * KV * G * S * hl, cs.PEAK_F32_FLOPS)
        n = max(2, -(-200_000_000 // int(scores_b + 2 * B * KV * S * hl)))
        ins = [(8.0 * torch.randn((B, KV, G, S), generator=gen, device=dev),
                cs.model_layout(gen, B, S, KV, hl, torch.bfloat16, dev))
               for _ in range(n)]
        k_pos = torch.arange(S, dtype=torch.int32, device=dev)
        pos, scale = S - 1, (16 * hl) ** -0.5
        want = decode_softmax_pv_hd_ref(ins[0][0], ins[0][1].float(), k_pos,
                                        pos, scale)
        for var, rps in PLAN:
            hk._entry = (lambda e, f=entries[var]:
                         f if e == "decode_softmax_pv_hd_fwd" else own_entry(e))
            hk.RUNS_PER_SM = rps
            try:
                n_split = hk.split(B, KV, S, hk._n_sm(dev))[0]
                got = hk.decode_softmax_pv_hd(*ins[0], k_pos, pos, scale)
                err = (got.float() - want).abs().max().item()
                ms = min(cs.time_ms([lambda i=i: hk.decode_softmax_pv_hd(
                    *i, k_pos, pos, scale) for i in ins])[0]
                    for _ in range(3))
            finally:
                hk._entry, hk.RUNS_PER_SM = own_entry, own_rps
            print(f"[{name}: B={B} KV={KV} G={G} S={S} hl={hl}] {var} "
                  f"runs/SM {rps} (n_split {n_split}): "
                  f"{ms:.4f} ms, bound {b_ms:.4f} ({b_by}; "
                  f"{100 * b_ms / ms:.1f}%), max abs err {err:.2e}",
                  flush=True)
        del ins
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
