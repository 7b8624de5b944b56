#!/usr/bin/env python3
"""Tile steps per block of the flash-attention backward's dK/dV grid, and
how long the block scheduler takes to run them, on paper.

    python3 tools/bwd_schedule.py

For a causal shape (Tq = Tk = T, positions 0..T-1) a dK/dV block owns a
key tile and walks every query tile at or after it, for each of its G
query heads. The card hands the next block of the grid, in index order,
to the first SM that frees (list scheduling); each block also pays a
set-up of about one tile step (its own tiles' loads, the ring's fill, the
epilogue). This prints, for each grid, the steps per block, their total
and mean per SM, and the simulated end in step-times: the bf16 design's
grid (128-key tiles, one block per KV head, key tile 0 first) and the
earlier mma.sync grid (64-key tiles of 64-row query tiles, key tile
fastest in index order), at each shape tools/time_attention_bwd.py times.
"""
from __future__ import annotations

import heapq

SMS = 132
SHAPES = [(8, 14, 2, 2048), (8, 12, 2, 2048), (2, 32, 32, 1024),
          (4, 4, 2, 512)]


def list_schedule(lengths, setup=1.0, sms=SMS) -> float:
    free = [0.0] * sms
    for n in lengths:
        t = heapq.heappop(free)
        heapq.heappush(free, t + n + setup)
    return max(free)


def grid(B, KV, G, T, keys, rows, key_tile_first):
    """Steps per block in launch order (query tiles of `rows` rows)."""
    n = -(-T // keys)
    steps = [G * -(-(T - j * keys) // rows) for j in range(n)]
    if key_tile_first:          # key tile slowest in index order
        return [s for s in steps for _ in range(KV * B)]
    return [s for _ in range(KV * B) for s in steps]


def main() -> int:
    for B, H, KV, T in SHAPES:
        G = H // KV
        for name, blocks in (
                ("wgmma, 128 keys, longest first",
                 grid(B, KV, G, T, 128, 128, True)),
                ("mma.sync, 64 keys, index order",
                 grid(B, KV, G, T, 64, 64, False))):
            # Steps in units of the wgmma design's 128 x 128 tile.
            unit = 1.0 if name.startswith("wgmma") else 0.25
            lens = [s * unit for s in blocks]
            print(f"B={B} H={H} KV={KV} T={T} {name}: {len(lens)} blocks, "
                  f"{max(lens):g} .. {min(lens):g} steps each, "
                  f"{sum(lens):g} in all, {sum(lens) / SMS:.1f} per SM; "
                  f"ends after {list_schedule(lens):.1f} step-times")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
