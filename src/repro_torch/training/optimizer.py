"""AdamW with global-norm clipping, the reference's arithmetic on the
port's parameter tree (nested dicts of tensors).

Not `torch.optim.AdamW`: the moments are f32 even for bf16 parameters,
each update is computed in f32 from the parameter's f32 value and cast
back once, weight decay applies to matrices only (ndim >= 2), and the
global norm sums the leaves in the reference's order (`jax.tree.leaves`:
sorted dict keys), so that it rounds like the reference. Every scalar of a
step (the clip scale, the learning rate, the step count) stays a device
tensor: a step never reads back to the host.
"""
from __future__ import annotations

import dataclasses
import math
import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def leaves(tree: dict) -> list[torch.Tensor]:
    """The tensors of a tree of dicts in `jax.tree.leaves` order (keys
    sorted)."""
    return [x for k in sorted(tree)
            for x in (leaves(tree[k]) if isinstance(tree[k], dict)
                      else (tree[k],))]


def unflatten(tree: dict, flat: list) -> dict:
    """A tree shaped like `tree` (its key order kept) with its leaves, in
    `leaves` order, taken from `flat`."""
    it = iter(flat)

    def build(node: dict) -> dict:
        built = {k: build(node[k]) if isinstance(node[k], dict) else next(it)
                 for k in sorted(node)}
        return {k: built[k] for k in node}

    return build(tree)


def init_state(params: dict) -> dict:
    def zeros(t):
        return torch.zeros_like(t, dtype=torch.float32)

    p = leaves(params)
    dev = p[0].device if p else None
    return dict(mu=unflatten(params, [zeros(t) for t in p]),
                nu=unflatten(params, [zeros(t) for t in p]),
                step=torch.zeros((), dtype=torch.int32, device=dev))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_frac; `step` an int32
    tensor, the result an f32 tensor on its device."""
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5
           * (1 + torch.cos(math.pi * t)))
    return cfg.lr * warm * cos


def global_norm(tree: dict) -> torch.Tensor:
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def _update(cfg: AdamWConfig, p, g, mu, nu, scale, lr, b1t, b2t):
    """One leaf's step, in the reference's order of operations."""
    g = g.float() * scale
    mu = cfg.b1 * mu + (1 - cfg.b1) * g
    nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
    mhat = mu / b1t
    nhat = nu / b2t
    delta = mhat / (torch.sqrt(nhat) + cfg.eps)
    if p.ndim >= 2:  # decoupled weight decay on matrices only
        delta = delta + cfg.weight_decay * p.float()
    newp = (p.float() - lr * delta).to(p.dtype)
    return newp, mu, nu


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: dict, grads: dict,
                  state: dict) -> tuple[dict, dict, dict]:
    """One AdamW step with global-norm clipping. Returns (new_params,
    new_state, metrics), metrics grad_norm and lr as device tensors."""
    step = state["step"]
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1t = 1 - cfg.b1 ** (step.float() + 1)
    b2t = 1 - cfg.b2 ** (step.float() + 1)
    out = [_update(cfg, p, g, m, n, scale, lr, b1t, b2t)
           for p, g, m, n in zip(leaves(params), leaves(grads),
                                 leaves(state["mu"]), leaves(state["nu"]),
                                 strict=True)]
    new_p = unflatten(params, [o[0] for o in out])
    new_state = dict(mu=unflatten(params, [o[1] for o in out]),
                     nu=unflatten(params, [o[2] for o in out]),
                     step=step + 1)
    return new_p, new_state, dict(grad_norm=gnorm, lr=lr)
