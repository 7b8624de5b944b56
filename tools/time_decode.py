#!/usr/bin/env python3
"""Time the decode kernel of one or more trees side by side, on one card.

    python3 tools/time_decode.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository (for instance a
`git archive` of another commit unpacked into a directory `.gitignore`
lists). Each runs in its own process, builds its own kernels into its own
`build/kernels/`, and prints, at each shape below, the best of three
CUDA-graph timings (chip_smoke.py's `time_ms`, 48 calls over enough
caches to exceed the 50 MB L2, as a layer stack reads them) of the bf16
kernel without and, where the tree's kernel has one, with its
log-sum-exp output, beside the bytes bound (q, the output, the admissible
slots of k and v and the key positions once each, at 3.35 TB/s). Give
the trees in turns (A B B A) to see the spread.

Shapes (B, KV, G, S, hd): phase 6's served decode of qwen2-0.5b (8, 2, 7,
1031, 64), zamba2-7b (8, 32, 1, 1031, 112) and kimi-k2 (8, 8, 8, 1031,
128), every slot admissible; then kimi-k2's per-rank decode_32k shape on
2x16x16 (4, 8, 8, 8192, 128), a full ring, whole and as one of the 16
"model" ranks' 512-slot ranges.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

CHILD = r"""
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.kernels.decode_attention import kernel as dk

SHAPES = [("qwen2-0.5b", 8, 2, 7, 1031, 64),
          ("zamba2-7b", 8, 32, 1, 1031, 112), ("kimi-k2", 8, 8, 8, 1031, 128),
          ("kimi-k2 decode_32k, whole ring", 4, 8, 8, 8192, 128)]
RANGES = 16
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
bf16 = torch.bfloat16


def timed(calls):
    return min(cs.time_ms(calls)[0] for _ in range(3))


def report(tag, q, caches, k_pos, pos):
    B, KV, G, hd = q.shape
    S = caches[0][0].shape[2]
    b, by = cs.bound(2 * (2 * q.numel() + 2 * B * KV * S * hd) + 4 * S,
                     4.0 * B * KV * G * hd * S)
    ms = timed([lambda c=c: dk.decode_attention(q, *c, k_pos, pos)
                for c in caches])
    try:
        lse_ms = timed([lambda c=c: dk.decode_attention(
            q, *c, k_pos, pos, return_lse=True) for c in caches])
        with_lse = f"{lse_ms:.4f} ms with the lse"
    except TypeError:
        with_lse = "no lse output"
    print(f"{sys.argv[1]} [{tag}: B={B} KV={KV} G={G} S={S} hd={hd}]: "
          f"{ms:.4f} ms, {with_lse}, bound {b:.4f} ms ({by}; "
          f"{100 * b / ms:.1f}%)", flush=True)


for name, B, KV, G, S, hd in SHAPES:
    q = torch.randn((B, KV, G, hd), generator=gen, device=dev).to(bf16)
    kc = cs.model_layout(gen, B, S, KV, hd, bf16, dev)
    vc = cs.model_layout(gen, B, S, KV, hd, bf16, dev)
    n = max(1, -(-100_000_000 // (2 * kc.numel() * 2)))
    caches = [(kc, vc)] + [tuple(t.clone(memory_format=torch.preserve_format)
                                 for t in (kc, vc)) for _ in range(n - 1)]
    pos = S - 1 if S < 8192 else 3 * S + 123
    k_pos = torch.arange(S, dtype=torch.int32, device=dev)
    if S == 8192:
        k_pos = pos - ((pos - k_pos) % S)
    report(name, q, caches, k_pos, pos)
    if S == 8192:
        L = S // RANGES
        ranges = [(kc[:, :, a:a + L], vc[:, :, a:a + L])
                  for a in range(0, S, L)]
        report(f"one of {RANGES} ranges", q, ranges, k_pos[:L].clone(), pos)
    del caches
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
