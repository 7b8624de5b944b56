#!/usr/bin/env python3
"""Time the flash-attention backward kernel of one or more trees side by
side, on one card.

    python3 tools/time_attention_bwd.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository (for instance a
`git archive` of another commit unpacked into a directory `.gitignore`
lists). Each runs in its own process, builds its own kernels into its own
`build/kernels/`, and prints, at each shape below that its kernel takes,
the best of three CUDA-graph timings (chip_smoke.py's `time_ms`, 24 calls
over three input sets) of the bf16 backward on the forward's own o and
LSE, its bound (5 products of the admitted pairs at 989 TFLOP/s, or the
bytes read and written once at 3.35 TB/s, whichever is longer), and
SDPA's backward on the same inputs (a yardstick the port never calls).
Give the trees in turns (A B B A) to see the spread.

Shapes (B, H, KV, T, hd, window), all causal: qwen2-0.5b's training shape
(8, 14, 2, 2048, 64, 0); qwen2-1.5b's attention (8, 12, 2, 2048, 128, 0);
zamba2-7b's shared attention (2, 32, 32, 1024, 112, 4096); the smoke
configs' width (4, 4, 2, 512, 32, 0).
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

CHILD = r"""
import sys, torch
import torch.nn.functional as F
sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention_bwd import kernel as bk

SHAPES = [(8, 14, 2, 2048, 64, 0), (8, 12, 2, 2048, 128, 0),
          (2, 32, 32, 1024, 112, 4096), (4, 4, 2, 512, 32, 0)]
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
for B, H, KV, T, hd, window in SHAPES:
    tag = f"B={B} H={H} KV={KV} T={T} hd={hd} window={window}"
    pos = torch.arange(T, dtype=torch.int32, device=dev)
    q, do = (cs.model_layout(gen, B, T, H, hd, torch.bfloat16, dev)
             for _ in range(2))
    k, v = (cs.model_layout(gen, B, T, KV, hd, torch.bfloat16, dev)
            for _ in range(2))
    o, lse = fk.flash_attention(q, k, v, pos, pos, window, with_lse=True)
    sets = [(q, k, v, o, lse, do)] + [
        tuple(t.clone(memory_format=torch.preserve_format)
              for t in (q, k, v, o, lse, do)) for _ in range(2)]
    try:
        bk.flash_attention_bwd(q, k, v, o, lse, do, pos, pos, window)
    except ValueError as e:
        print(f"{sys.argv[1]} [{tag}]: not taken ({e})", flush=True)
        continue
    ms = min(cs.time_ms([lambda a=a: bk.flash_attention_bwd(
        *a, pos, pos, window) for a in sets], n=24)[0] for _ in range(3))
    pairs = T * (T + 1) // 2
    # q, o, dO, dq and k, v, dk, dv once each, lse and the positions.
    n_bytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel() + 8 * T
    b, by = cs.bound(n_bytes, 5 * 2.0 * pairs * hd * B * H)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                         enable_gqa=True)
    lib = cs._event_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                   retain_graph=True), 10)
    print(f"{sys.argv[1]} [{tag}]: {ms:.4f} ms, bound {b:.4f} ms ({by}; "
          f"{100 * b / ms:.1f}%), SDPA backward {lib:.4f} ms", flush=True)
    del sets, leaves, out
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
