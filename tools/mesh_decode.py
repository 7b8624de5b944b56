#!/usr/bin/env python3
"""The slot-split and head_dim-split decodes across cards, one process
per card.

    python3 tools/mesh_decode.py [--cards 4] [--layers 28] [--kvhd]
    python3 tools/mesh_decode.py --device cpu --smoke [--kvhd]   # gloo

qwen2-1.5b (12 heads, 2 KV heads, hd 128, bf16, random weights from
--seed, which every rank draws alike) on a (data, model) = (1, cards)
mesh: the 2 KV heads do not divide the "model" axis, so the rules split
every decode cache on its slots, and each rank runs the decode kernel on
its own slots, the parts merged by their log-sum-exps. Each rank (card r,
NCCL over a `file://` store under build/) prefills B 8 x T 600 into a
cache of 1,032 positions, so the last rank's 258 slots stay empty, then
decodes 32 steps:
- on its own card unsharded: the kernel path, and the f32 plain path
  (the truth, as chip_smoke.py's phase 13);
- on the mesh: the logits against the unsharded kernel path under
  chip_smoke.py's phase-5 bf16 criteria, the decode kernel launched as
  often, the caches still split on their slots afterwards, and the last
  step's all-gathered bytes (`analysis.op_stats.OpCounter`) below one
  layer's whole key cache, which the decode gathered to every rank, each
  layer, each step, before the slot split.
With --kvhd the cache is placed as the reference's `prefer_hd` places it
(the dry-run's `kvhd`): split on head_dim, 128 / cards lanes a rank. Each
rank runs the head_dim-split pair on its lanes (`decode_scores_hd`, the
partial scores all-reduced, `decode_softmax_pv_hd`): the logits against
the unsharded kernel path under the same criteria, each kernel of the pair
launched once per layer per decode step (on the card) and the whole-head
decode kernel not at all on the mesh, the caches still split on head_dim,
the last step's all-gathered bytes below one layer's key cache and its
all-reduced bytes the partial scores' (B x H x S f32 a layer) and less than
a layer's key cache more.
Rank 0 prints the card's name and power limit and one JSON line; exits 1
if a check fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def _run(params, cfg, toks, dec, max_len, use_kernels, prefer_hd=False):
    """Prefill, then one decode step per column of dec, with the kernels'
    launch counts set to 0 before. Returns (logits [B, 1 + steps, V] f32,
    wall s, launches, the last step's collectives by kind, the cache)."""
    import torch

    import chip_smoke as cs
    from repro_torch.analysis.op_stats import OpCounter
    from repro_torch.models import decoder
    ops = cs.kernel_ops()
    for op in ops.values():
        op.launches = 0
    cs._sync(toks.device)
    t0 = time.perf_counter()
    with torch.no_grad():
        lg, cache = decoder.prefill(params, cfg, toks, max_len=max_len,
                                    use_kernels=use_kernels,
                                    prefer_hd=prefer_hd)
        out = [cs._whole(lg)]
        T, n = toks.shape[1], dec.shape[1]
        for s in range(n):
            with OpCounter() as c:
                lg, cache = decoder.decode_step(
                    params, cfg, cache, dec[:, s:s + 1], T + s,
                    use_kernels=use_kernels)
            out.append(cs._whole(lg))
    cs._sync(toks.device)
    wall = time.perf_counter() - t0
    return (torch.cat(out, dim=1).float(), wall,
            {k: op.launches for k, op in ops.items() if op.launches},
            dict(c.stats.collectives), cache)


def worker(rank: int, world: int, store: str, args, out_path: str) -> None:
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import decoder
    from repro_torch.parallel.sharding import distribute_params

    cuda = args.device == "cuda"
    dev = torch.device(f"cuda:{rank}" if cuda else "cpu")
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        cfg = get_config("qwen2-1.5b")
        cfg = (cfg.smoke() if args.smoke
               else dataclasses.replace(cfg, n_layers=args.layers))
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = decoder.init_params(gen, cfg)
        toks = torch.randint(1, cfg.vocab_size, (args.batch, args.prompt),
                             generator=gen, device=dev)
        dec = torch.randint(1, cfg.vocab_size, (args.batch, args.steps),
                            generator=gen, device=dev)
        L = args.max_len
        _run(params, cfg, toks[:, :16], dec[:, :2], L, True)   # warm-up
        want, wall0, n0, _, _ = _run(params, cfg, toks, dec, L, True)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        f32 = _run(cs._tree_map(lambda x: x.float(), params), cfg32, toks,
                   dec, L, False)[0]
        rel0 = cs.row_rel(want, f32)
        mesh = make_host_mesh(world, device=dev.type)
        sp = distribute_params(params, mesh)
        hd = args.kvhd
        _run(sp, cfg, toks[:, :16], dec[:, :2], L, True, hd)   # warm-up
        got, wall, n, coll, cache = _run(sp, cfg, toks, dec, L, True, hd)
        kc = cache["layers"][0]
        layer_k = kc.numel() // kc.shape[0] * kc.element_size()
        dim = 4 if hd else 2        # of [L, B, S, KV, hd]: hd or slots
        split = all(
            p.is_shard(dim) for t in cache["layers"]
            for name, p in zip(mesh.mesh_dim_names, t.placements)
            if name == "model")
        rel, rel_f32 = cs.row_rel(got, want), cs.row_rel(got, f32)
        res = dict(
            cards=world, layers=cfg.n_layers, batch=args.batch,
            prompt=args.prompt, steps=args.steps, max_len=L,
            split_on="head_dim" if hd else "slots",
            local_extent=kc.to_local().shape[dim],
            empty_rank=world - 1 if (not hd and args.prompt + args.steps
                                     <= L - L // world) else None,
            row_rel_vs_unsharded=rel, row_rel_vs_f32=rel_f32,
            unsharded_row_rel_vs_f32=rel0,
            same_greedy=(got.argmax(-1) == want.argmax(-1)).float()
            .mean().item(),
            launches=n, unsharded_launches=n0, wall_s=wall,
            unsharded_wall_s=wall0, last_step_collectives=coll,
            one_layer_key_cache_bytes=layer_k, caches_split=split)
        ok = (rel <= cs.E2E_BF16_REL and rel_f32 <= 2 * rel0 + cs.E2E_TOL
              and split and coll.get("all-gather", 0) < layer_k
              and bool(torch.isfinite(got).all()))
        if hd:
            # one launch of each kernel of the pair a layer a decode step
            # (none on the CPU, where the ops are their plain versions),
            # and no whole-head decode on the mesh
            per = cfg.n_layers * args.steps if cuda else None
            scores = cfg.n_layers * args.batch * cfg.n_heads * L * 4
            res["scores_all_reduce_bytes"] = scores
            ok = (ok and n.get("decode_scores_hd") == per
                  and n.get("decode_softmax_pv_hd") == per
                  and "decode_attention" not in n
                  and scores <= coll.get("all-reduce", 0) < scores + layer_k)
        else:
            ok = ok and (n.get("decode_attention")
                         == n0.get("decode_attention"))
        res["ok"] = ok
        if rank == 0:
            Path(out_path).write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--layers", type=int, default=28)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config, B 2 x T 20, 4 steps, 32 slots")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kvhd", action="store_true",
                    help="split the cache on head_dim (prefer_hd), not on "
                         "its slots")
    args = ap.parse_args(argv)
    args.batch, args.prompt, args.steps, args.max_len = (
        (2, 20, 4, 32) if args.smoke else (8, 600, 32, 1032))
    import subprocess

    import torch
    import torch.multiprocessing as mp
    if args.device == "cuda":
        if torch.cuda.device_count() < args.cards:
            print(f"needs {args.cards} cards, has "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 1
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
        from repro_torch.kernels import _build
        _build.build_all(("flash_attention", "decode_attention",
                          "decode_attention_hd"))
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        out = Path(tmp) / "result.json"
        mp.start_processes(worker, args=(args.cards, str(Path(tmp) / "store"),
                                         args, str(out)),
                           nprocs=args.cards, start_method="spawn")
        res = json.loads(out.read_text())
    print(json.dumps({"mesh_decode": res}))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
