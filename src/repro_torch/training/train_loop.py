"""Training step + loop on one device, checkpointed.

`make_train_step` differentiates `decoder.train_loss` with autograd (on
CUDA through the flash-attention kernel and its backward kernel) and
applies AdamW in place; parameters are leaf tensors with `requires_grad`.
The step consumes its parameter and optimizer trees as the reference's
`jax.jit(..., donate_argnums=(0, 1))` consumes its donated buffers: it
writes the new values into them, so a caller that needs a tree's old
values after a step copies them first. The loop reads the step's
scalars back to the host only at log steps.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import torch

from ..device import resolve_device
from ..models import decoder
from ..models.config import ModelConfig
from . import checkpoint
from .optimizer import AdamWConfig, apply_updates, init_state, leaves, \
    unflatten


def as_trainable(params: Any) -> Any:
    """The tree with every tensor a leaf that requires a gradient, each
    sharing the given tensor's storage."""
    return unflatten(params, [p.detach().requires_grad_()
                              for p in leaves(params)])


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    use_kernels: bool = True) -> Callable:
    """One step: the loss, its gradients by autograd, AdamW. `params`
    (leaf tensors that require a gradient) and `opt_state` are consumed
    as donated buffers are: the step updates them in place and returns
    the same objects. `use_kernels` as `decoder.train_loss` (False: the
    plain path, as the dry-run traces on meta tensors)."""
    def train_step(params: Any, opt_state: dict, batch: dict):
        loss = decoder.train_loss(params, cfg, batch, use_kernels=use_kernels)
        # a leaf the loss does not reach (zamba2's shared attention when
        # the depth is cut below one super-block) gets zeros, as jax.grad
        grads = unflatten(params, torch.autograd.grad(
            loss, leaves(params), allow_unused=True, materialize_grads=True))
        params, opt_state, metrics = apply_updates(opt_cfg, params, grads,
                                                   opt_state)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics
    return train_step


def batch_on(batch: dict, device: torch.device) -> dict:
    """A numpy batch (`PackedStream.batch`) as tensors on `device`."""
    return {k: torch.from_numpy(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def train(cfg: ModelConfig, opt_cfg: AdamWConfig, stream, n_steps: int,
          rng: torch.Generator | None = None, log_every: int = 10,
          ckpt_path: str | None = None, ckpt_every: int = 0,
          params: Any = None, *, device: str | torch.device = "cuda",
          opt_state: dict | None = None, return_state: bool = False):
    """Single-device training loop: steps [start, n_steps) of `stream`,
    start = `opt_state["step"]` when resuming (0 otherwise). Without
    `params`, weights are drawn by `decoder.init_params` from `rng` (a
    generator on `device`; default seed 0). Runs on CUDA unless
    device="cpu" and raises without it. The `params` and `opt_state` it
    is handed are consumed, as the reference's donated buffers: every
    step writes into their storage. Returns (params, history), the
    history one dict (loss, grad_norm, lr, step, wall_s) per log step and
    for the last step, and with `return_state` the optimizer state too
    (the trees updated; the params as leaves that require a gradient,
    sharing the handed tensors' storage); with `ckpt_every`, saves
    dict(params, opt_state) with meta (step, arch) every `ckpt_every`
    steps."""
    dev = resolve_device(str(device))
    if params is None:
        rng = (torch.Generator(device=dev).manual_seed(0) if rng is None
               else rng)
        params = decoder.init_params(rng, cfg)
    params = as_trainable(params)
    opt_state = init_state(params) if opt_state is None else opt_state
    start = int(opt_state["step"])
    step_fn = make_train_step(cfg, opt_cfg)
    history: list[dict] = []
    t0 = time.perf_counter()
    for step in range(start, n_steps):
        batch = batch_on(stream.batch(step), dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == n_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
        if ckpt_path and ckpt_every and (step + 1) % ckpt_every == 0:
            checkpoint.save(ckpt_path, dict(params=params,
                                            opt_state=opt_state),
                            meta=dict(step=step + 1, arch=cfg.name))
    return (params, history, opt_state) if return_state else (params,
                                                               history)
