"""End-to-end serving driver on the PyTorch/CUDA port: plan -> deploy ->
route -> serve.

The twin of examples/serve_e2e.py, on `repro_torch`:
  1. AGH plans the heterogeneous fleet (model x tier x TP/PP x routing).
  2. Each planned (model, tier) pair is deployed as a serving Engine
     (smoke-scale model standing in for the catalog entry, head dim 32,
     random weights from a seeded torch.Generator).
  3. A batch of mixed-type requests is routed per the planner's fractions
     and served (real prefill + autoregressive decode; on CUDA through the
     flash-attention and flash-decode kernels), reporting TTFT per type
     against the plan's SLO and the kernels' launch counts.

    PYTHONPATH=src python examples/serve_e2e_torch.py [--requests 24] [--device cuda]

Runs on CUDA unless --device cpu is given, and raises without a card.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import plan
from repro_torch.configs import get_config
from repro_torch.core import default_instance
from repro_torch.core.bridge import to_deployment
from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import decoder
from repro_torch.serving.engine import Engine, Request

# smoke-scale stand-ins for the planner's model catalog
STANDIN = {"llama3-1b": "qwen2-0.5b", "llama3-3b": "qwen2-0.5b",
           "llama3-8b": "qwen2-1.5b", "llama3-11b": "qwen2-1.5b",
           "llama3-34b": "qwen2-1.5b", "llama3-70b": "qwen2-72b"}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; raises without a card")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    # --- 1. plan ---------------------------------------------------------
    inst = default_instance()
    res = plan("agh", instance=inst)
    sol = res.solution
    spec = to_deployment(inst, sol)
    print(f"[plan] AGH in {res.wall_s:.2f}s -> "
          f"{len(spec.pairs)} deployed pairs")
    for p in spec.pairs:
        print(f"  {p.model} @ {p.tier} TP={p.tp} PP={p.pp} "
              f"chips={p.n_chips} routing={p.routing}")

    # --- 2. deploy -------------------------------------------------------
    engines = {}
    for p in spec.pairs:
        cfg = get_config(STANDIN.get(p.model, "qwen2-0.5b")).smoke()
        params = decoder.init_params(
            torch.Generator(device=dev).manual_seed(0), cfg)
        engines[(p.model, p.tier)] = Engine(
            cfg, params, max_len=args.prompt_len + args.new_tokens + 8,
            max_batch=args.requests)
    print(f"[deploy] {len(engines)} engines up on {dev}")

    # --- 3. route + serve -------------------------------------------------
    rng = np.random.default_rng(0)
    lam = inst.lam / inst.lam.sum()
    types = rng.choice(inst.I, size=args.requests, p=lam)
    per_engine: dict = {k: [] for k in engines}
    for rid, ti in enumerate(types):
        qname = inst.query_names[ti]
        # route by the planner's fractions for this type
        pairs = [(p, p.routing.get(qname, 0.0)) for p in spec.pairs]
        weights = np.array([w for _, w in pairs])
        if weights.sum() <= 0:
            continue
        pick = pairs[rng.choice(len(pairs), p=weights / weights.sum())][0]
        vocab = engines[(pick.model, pick.tier)].cfg.vocab_size
        per_engine[(pick.model, pick.tier)].append((qname, Request(
            rid=rid,
            prompt=rng.integers(1, vocab, args.prompt_len).astype(np.int32),
            max_new_tokens=args.new_tokens)))

    flash_attention.launches = decode_attention.launches = 0
    t0 = time.perf_counter()
    ttfts: dict[str, list[float]] = {}
    total_toks = 0
    for key, items in per_engine.items():
        if not items:
            continue
        reqs = [r for _, r in items]
        engines[key].generate(reqs)
        for (qname, r) in items:
            ttfts.setdefault(qname, []).append(r.first_token_s)
            total_toks += len(r.output)
    wall = time.perf_counter() - t0
    print(f"[serve] {args.requests} requests, {total_toks} tokens "
          f"in {wall:.2f}s ({total_toks/wall:.1f} tok/s)")
    for i, qname in enumerate(inst.query_names):
        if qname in ttfts:
            print(f"  {qname:14s} TTFT p50={np.median(ttfts[qname])*1e3:6.1f}ms"
                  f"  (plan SLO {inst.Delta[i]:.1f}s)")
    print(f"[kernels] flash_attention={flash_attention.launches} "
          f"decode_attention={decode_attention.launches}")


if __name__ == "__main__":
    main()
