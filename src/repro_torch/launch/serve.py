"""Serving launcher: plan the fleet with AGH, turn the plan into deployed
pairs, and serve a batch of requests on one engine.

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch qwen2-0.5b]
        [--requests 8] [--prompt-len 32] [--new-tokens 16] [--seed 0]
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

`--arch` takes the attention configs (qwen2-*, deepseek-7b), the MoE
configs (kimi-k2-1t-a32b, llama4-scout-17b-a16e), internvl2-26b (text-only
prompts), rwkv6-7b and zamba2-7b. musicgen-medium's codebook tokens are
refused, as the engine refuses them (`serving.engine.check_servable`).

It runs on CUDA unless `--device cpu` is given, and raises when CUDA is
absent. `--smoke` serves the reduced config, sized for the CPU. Weights
are random, drawn from `--seed`.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..configs import get_config
from ..core import agh, default_instance, to_deployment
from ..core.bridge import DeploymentSpec
from ..core.instance import Instance
from ..core.solution import Solution
from ..device import resolve_device
from ..models import decoder
from ..models.config import ModelConfig
from ..serving.engine import Engine, Request, check_servable


def plan_fleet(seed: int = 0) -> tuple[Instance, Solution, DeploymentSpec]:
    """Step 1 and 2: AGH on the paper's default instance, then the
    deployed pairs."""
    inst = default_instance(seed=seed)
    sol = agh(inst)
    return inst, sol, to_deployment(inst, sol)


def build_engine(cfg: ModelConfig, device: torch.device, seed: int,
                 max_len: int, max_batch: int) -> Engine:
    """An engine with random weights drawn from `seed` on `device`; raises
    NotImplementedError before drawing them for a config the engine cannot
    serve."""
    check_servable(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = decoder.init_params(gen, cfg)
    return Engine(cfg, params, max_len=max_len, max_batch=max_batch)


def make_requests(prompt_lens: list[int], new_tokens: int, vocab_size: int,
                  seed: int) -> list[Request]:
    """One request per prompt length, tokens uniform in [1, vocab)."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(1, vocab_size, size=n
                                               ).astype(np.int32),
                    max_new_tokens=new_tokens)
            for i, n in enumerate(prompt_lens)]


def serve_batch(engine: Engine, reqs: list[Request]) -> dict:
    """Step 3: serve one batch; wall time, mean TTFT and tokens/s."""
    t0 = time.perf_counter()
    engine.generate(reqs)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    wall = time.perf_counter() - t0
    n_tok = sum(len(r.output) for r in reqs)
    return dict(wall_s=wall, ttft_s=float(np.mean([r.first_token_s
                                                   for r in reqs])),
                tokens=n_tok, tok_per_s=n_tok / wall)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced config (for CPU runs)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1-2. Plan (the paper's allocator) and deploy.
    inst, sol, spec = plan_fleet(args.seed)
    print(f"AGH plan ({sol.runtime_s:.2f}s): "
          f"{[(p.model, p.tier, p.tp, p.pp) for p in spec.pairs]}")

    # 3. One engine standing in for the planned pairs serves a batch.
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    engine = build_engine(cfg, device, args.seed,
                          max_len=args.prompt_len + args.new_tokens,
                          max_batch=args.requests)
    reqs = make_requests([args.prompt_len] * args.requests, args.new_tokens,
                         cfg.vocab_size, args.seed)
    stats = serve_batch(engine, reqs)
    print(f"served {len(reqs)} requests on {cfg.name} ({device}): "
          f"TTFT={stats['ttft_s'] * 1e3:.1f}ms "
          f"throughput={stats['tok_per_s']:.1f} tok/s "
          f"wall={stats['wall_s']:.2f}s")
    for r in reqs[:2]:
        print(f"  req {r.rid}: {len(r.output)} tokens, first 8 = "
              f"{r.output[:8]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
