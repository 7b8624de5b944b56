"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        [--smoke] [--steps 50] [--batch 8] [--seq 256] [--lr 3e-4]
        [--ckpt DIR] [--ckpt-every N] [--seed 0] [--device cuda|cpu]

The reference's flags, plus `--device` and `--seed` (the random weights'
generator). It runs on CUDA unless `--device cpu` is given, and raises
when CUDA is absent. On CUDA the attention layers run the flash-attention
kernel and its backward kernel, and the recurrent mixers (rwkv6, mamba2,
the zamba2 hybrid) the scan kernels and their backward kernels; W8A8
experts raise. `--smoke` trains the reduced config, sized for the CPU.
"""
from __future__ import annotations

import argparse
import sys

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..configs import get_config
    from ..device import resolve_device
    from ..models.decoder import check_trainable
    from ..training.data import DataConfig, PackedStream
    from ..training.optimizer import AdamWConfig
    from ..training.train_loop import train

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    check_trainable(cfg)
    stream = PackedStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, batch_size=args.batch,
        n_codebooks=cfg.n_codebooks))
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(1, args.steps // 10))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    _, history = train(cfg, opt, stream, args.steps, rng=gen,
                       ckpt_path=args.ckpt, ckpt_every=args.ckpt_every,
                       device=dev)
    for h in history:
        print("step=%4d loss=%.4f grad_norm=%.3f lr=%.2e wall=%.1fs"
              % (h["step"], h["loss"], h["grad_norm"], h["lr"], h["wall_s"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
