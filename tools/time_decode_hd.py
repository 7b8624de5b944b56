#!/usr/bin/env python3
"""Time the head_dim-split decode pair of one or more trees side by side,
on one card.

    python3 tools/time_decode_hd.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository (for instance a
`git archive` of another commit unpacked into a directory `.gitignore`
lists). Each runs in its own process, builds its own kernels into its own
`build/kernels/`, and prints, at each shape below, the best of three
CUDA-graph timings (chip_smoke.py's `time_ms`: 48 calls, each on its own
inputs, enough of them to exceed the 50 MB L2 as the layers of a rank
do) of `decode_softmax_pv_hd` and of `decode_scores_hd` in bf16, each
beside its bytes bound (at 3.35 TB/s: the softmax reads the summed f32
scores, the slice of v and k_pos and writes the output; the scores read
q and the slice of k and write the f32 scores). Every slot is admissible
(the last decode position of a flat cache). Give the trees in turns
(A B B A) to see the spread.

Shapes (B, KV, G, S, hl), each one "model" rank's slice of head_dim, the
cache laid out as the rank holds it ([B, S, KV, hl], contiguous):
qwen2-72b's decode_32k on 16x16 (8, 8, 8, 32768, 8; chip_smoke.py's
phase 14.6); qwen2-0.5b's decode_32k on 16x16 (8, 2, 7, 32768, 4: 4-lane
pieces); qwen2-1.5b on 4 cards (8, 2, 6, 1024, 32:
`tools/mesh_decode.py --kvhd`).
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

CHILD = r"""
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.kernels.decode_attention_hd import kernel as hk

SHAPES = [("qwen2-72b 16x16", 8, 8, 8, 32768, 8),
          ("qwen2-0.5b 16x16", 8, 2, 7, 32768, 4),
          ("qwen2-1.5b 4 cards", 8, 2, 6, 1024, 32)]
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
bf16 = torch.bfloat16


def timed(calls):
    return min(cs.time_ms(calls)[0] for _ in range(3))


for name, B, KV, G, S, hl in SHAPES:
    scores_b = 4.0 * B * KV * G * S
    flops = 2.0 * B * KV * G * S * hl
    pv_b, pv_by = cs.bound(scores_b + 2 * B * KV * S * hl + 4 * S
                           + 2 * B * KV * G * hl, flops, cs.PEAK_F32_FLOPS)
    sc_b, sc_by = cs.bound(2 * B * KV * G * hl + 2 * B * KV * S * hl
                           + scores_b, flops, cs.PEAK_F32_FLOPS)
    n = max(2, -(-200_000_000 // int(scores_b + 4 * B * KV * S * hl)))
    ins = []
    for _ in range(n):
        q = torch.randn((B, KV, G, hl), generator=gen, device=dev).to(bf16)
        k = cs.model_layout(gen, B, S, KV, hl, bf16, dev)
        v = cs.model_layout(gen, B, S, KV, hl, bf16, dev)
        s = 8.0 * torch.randn((B, KV, G, S), generator=gen, device=dev)
        ins.append((q, k, v, s))
    k_pos = torch.arange(S, dtype=torch.int32, device=dev)
    pos, scale = S - 1, (16 * hl) ** -0.5
    pv = timed([lambda i=i: hk.decode_softmax_pv_hd(i[3], i[2], k_pos, pos,
                                                    scale) for i in ins])
    sc = timed([lambda i=i: hk.decode_scores_hd(i[0], i[1]) for i in ins])
    print(f"{sys.argv[1]} [{name}: B={B} KV={KV} G={G} S={S} hl={hl}, "
          f"{n} input sets]: softmax_pv {pv:.4f} ms, bound {pv_b:.4f} "
          f"({pv_by}; {100 * pv_b / pv:.1f}%); scores {sc:.4f} ms, bound "
          f"{sc_b:.4f} ({sc_by}; {100 * sc_b / sc:.1f}%)", flush=True)
    del ins
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
