"""Train a ~100M-parameter model for a few hundred steps on the
PyTorch/CUDA port.

The twin of examples/train_demo.py, on `repro_torch`: the qwen2-0.5b
family at reduced width (~100M params, f32) with the synthetic
packed-token pipeline, AdamW (warmup + cosine) and checkpointing — the
training substrate end to end; on CUDA the attention layers run the
flash-attention kernel and its backward kernel.

    PYTHONPATH=src python examples/train_demo_torch.py [--steps 200] [--device cuda]

Runs on CUDA unless --device cpu is given, and raises without a card.
The checkpoint goes to build/train_demo_torch in the checkout unless
--ckpt names another directory.
"""
import argparse
import dataclasses
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention_bwd.ops import flash_attention_bwd
from repro_torch.training.data import DataConfig, PackedStream
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import train

CKPT = Path(__file__).resolve().parent.parent / "build" / "train_demo_torch"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=str(CKPT))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; raises without a card")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    # ~100M params: 12 layers x d512 on the qwen2 family, 32k vocab.
    cfg = dataclasses.replace(
        get_config("qwen2-0.5b"),
        name="qwen2-100m", n_layers=12, d_model=512, n_heads=8,
        n_kv_heads=2, head_dim=64, d_ff=2048, vocab_size=32768,
        dtype="float32", loss_chunk=128)
    n = cfg.param_count()
    print(f"model: {cfg.name}  params={n/1e6:.1f}M")

    stream = PackedStream(DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=args.seq,
                                     batch_size=args.batch))
    opt = AdamWConfig(lr=6e-4, total_steps=args.steps,
                      warmup_steps=max(10, args.steps // 20))
    flash_attention.launches = flash_attention_bwd.launches = 0
    _, hist = train(cfg, opt, stream, args.steps, log_every=10,
                    ckpt_path=args.ckpt, ckpt_every=max(50, args.steps // 2),
                    device=dev)
    print(f"\nloss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} over "
          f"{args.steps} steps ({hist[-1]['wall_s']:.0f}s)")
    assert hist[-1]["loss"] < hist[0]["loss"], "training failed to learn"
    print(f"checkpoint written to {args.ckpt}")
    print(f"[kernels] flash_attention={flash_attention.launches} "
          f"flash_attention_bwd={flash_attention_bwd.launches}")


if __name__ == "__main__":
    main()
