#!/usr/bin/env python3
"""The sharded training step across cards, one process per card.

    python3 tools/mesh_train.py [--cards 4] [--model 2] [TREE ...]
    python3 tools/mesh_train.py --device cpu --smoke     # gloo rehearsal

qwen2-0.5b whole (24 layers, bf16, random weights from --seed, which
every rank draws alike), B 8 x T 2048 of `PackedStream` tokens, on a
(data, model) = (cards / model, model) mesh, NCCL over a `file://` store
under build/. Each rank (card r):
- on its own card unsharded: the loss and gradients of the step, on the
  kernel path, the plain bf16 path and the plain f32 path (the same
  bf16-rounded weights; the truth);
- on the mesh (`distribute_params`): the loss and every gradient leaf,
  held as chip_smoke.py's phase 14.3 holds them (rel L2 to the f32
  gradient at most 2x the plain bf16 path's + E2E_TOL), and the
  collective bytes a rank of that forward and backward by kind
  (`analysis.op_stats.OpCounter`);
- then, from the same weights, one warm-up step (its collective bytes a
  rank counted) and --steps timed steps of `make_train_step` (AdamW in
  place), on the mesh and unsharded: each step's loss on the mesh within
  LOSS_REL of the unsharded one's, and the median step wall of each.
Each TREE (the root of a checkout of this repository, for instance a
`git archive` of another commit unpacked into a directory `.gitignore`
lists) is timed in its own set of processes on its own code, in the
order given, which may repeat a tree (A B B A); the checks run on this
tree's code first. Rank 0 prints the card's name and power limit and
one JSON line; exits 1 if a check fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

LOSS_REL = 1e-3    # a step's loss on the mesh against one card's


def _whole_grads(params, cfg, batch, use_kernels):
    """(loss, every gradient leaf whole) of one forward and backward."""
    import chip_smoke as cs
    loss, grads = cs._grads(params, cfg, batch, use_kernels)
    return loss.float().item(), [cs._whole(g) for g in grads]


def _steps(params, cfg, batch, n: int, dev) -> tuple[list, list, dict]:
    """One warm-up step, under `OpCounter`, and n timed steps of
    `make_train_step` on params (consumed): (the n + 1 losses, the n step
    walls in s, the warm-up step's collective bytes a rank by kind)."""
    import contextlib

    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.analysis.op_stats import OpCounter
    from repro_torch.training.optimizer import AdamWConfig, init_state
    from repro_torch.training.train_loop import as_trainable, make_train_step
    params = as_trainable(params)
    opt = init_state(params)
    step = make_train_step(cfg, AdamWConfig())
    losses, walls, counter = [], [], OpCounter()
    for i in range(n + 1):
        cs._sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        with counter if i == 0 else contextlib.nullcontext():
            params, opt, m = step(params, opt, batch)
        losses.append(m["loss"].float().item())
        cs._sync(dev)
        if i:
            walls.append(time.perf_counter() - t0)
    return losses, walls, dict(counter.stats.collectives)


def worker(rank: int, world: int, store: str, args, tree: str, check: bool,
           out_path: str) -> None:
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    from repro_torch.analysis.op_stats import OpCounter
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import decoder
    from repro_torch.parallel.sharding import distribute_params
    from repro_torch.training.data import DataConfig, PackedStream
    from repro_torch.training.train_loop import batch_on

    cuda = args.device == "cuda"
    dev = torch.device(f"cuda:{rank}" if cuda else "cpu")
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        cfg = get_config("qwen2-0.5b")
        cfg = cfg.smoke() if args.smoke else cfg
        params = decoder.init_params(
            torch.Generator(device=dev).manual_seed(args.seed), cfg)
        batch = batch_on(PackedStream(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=args.seq,
            batch_size=args.batch, seed=args.seed)).batch(0), dev)
        mesh = make_host_mesh(args.model, device=dev.type)
        res = dict(tree=tree, src=str(Path(decoder.__file__).parents[2]),
                   cards=world, mesh=list(mesh.shape),
                   layers=cfg.n_layers, batch=args.batch, seq=args.seq,
                   dtype=cfg.dtype)
        if check:
            names = [n for n, _ in cs._named(params)]
            lk, gk = _whole_grads(params, cfg, batch, True)
            lp, gp = _whole_grads(params, cfg, batch, False)
            cfg32 = dataclasses.replace(cfg, dtype="float32")
            lt, gt = _whole_grads(cs._tree_map(lambda x: x.float(), params),
                                  cfg32, batch, False)
            sp = distribute_params(cs._tree_map(torch.clone, params), mesh)
            with OpCounter() as c:
                ls, gs = _whole_grads(sp, cfg, batch, True)
            bad, worst, gap = [], (0.0, ""), (0.0, "")
            for name, a, k, b, t in zip(names, gs, gk, gp, gt, strict=True):
                rs, rp = cs._rel_l2(a, t), cs._rel_l2(b, t)
                worst = max(worst, (rs / max(2 * rp + cs.E2E_TOL, 1e-30),
                                    name))
                gap = max(gap, (cs._rel_l2(a, k), name))
                if rs > 2 * rp + cs.E2E_TOL:
                    bad.append(name)
            del gs, gk, gp, gt
            res.update(loss_sharded=ls, loss_unsharded=lk, loss_plain=lp,
                       loss_f32=lt, worst_leaf_of_tol=worst[0],
                       worst_leaf=worst[1], sharded_vs_unsharded_rel_l2=gap[0],
                       gap_leaf=gap[1], bad_leaves=bad,
                       grad_collective_bytes=c.stats.collective_bytes,
                       grad_collectives=dict(c.stats.collectives))
        losses, walls, coll = _steps(
            distribute_params(cs._tree_map(torch.clone, params), mesh), cfg,
            batch, args.steps, dev)
        res.update(step_losses=losses, step_walls_s=walls,
                   median_step_s=statistics.median(walls),
                   step_collectives=coll,
                   step_collective_bytes=sum(coll.values()))
        if check:
            losses0, walls0, _ = _steps(params, cfg, batch, args.steps, dev)
            res.update(unsharded_step_losses=losses0,
                       unsharded_step_walls_s=walls0,
                       unsharded_median_step_s=statistics.median(walls0),
                       worst_step_loss_rel=max(
                           abs(a - b) / abs(b)
                           for a, b in zip(losses, losses0)))
            res["ok"] = (not bad and res["worst_step_loss_rel"] <= LOSS_REL
                         and all(map(math.isfinite, losses)))
        if cuda:
            res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        if rank == 0:
            Path(out_path).write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", default=[],
                    help="checkouts to time after this tree's check")
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--model", type=int, default=2,
                    help='ranks on the "model" axis')
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config, B 4 x T 32, 2 steps")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    args.batch, args.seq = (4, 32) if args.smoke else (8, 2048)
    if args.smoke:
        args.steps = min(args.steps, 2)
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
    runs = [(str(ROOT), True)] + [(t, False) for t in args.trees]
    (ROOT / "build").mkdir(exist_ok=True)
    out = []
    for tree, check in runs:
        if args.device == "cuda":     # each tree builds its own kernels
            subprocess.run([sys.executable, "-c", (
                "import sys; sys.path.insert(0, 'src'); "
                "from repro_torch.kernels import _build; _build.build_all("
                "('flash_attention', 'flash_attention_bwd'))")],
                cwd=tree, check=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            path = Path(tmp) / "result.json"
            mp.start_processes(worker, args=(
                args.cards, str(Path(tmp) / "store"), args, tree, check,
                str(path)), nprocs=args.cards, start_method="spawn")
            out.append(json.loads(path.read_text()))
        print(f"{tree}: median step {out[-1]['median_step_s']:.4f} s",
              flush=True)
    res = dict(out[0], timed=[
        {k: r[k] for k in ("tree", "src", "median_step_s", "step_walls_s",
                           "step_collective_bytes", "step_collectives")}
        for r in out])
    print(json.dumps({"mesh_train": res}))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
