"""AdamW with global-norm clipping, the reference's arithmetic on the
port's parameter tree (nested dicts of tensors).

Not `torch.optim.AdamW`: the moments are f32 even for bf16 parameters,
each update is computed in f32 from the parameter's f32 value and cast
back once, weight decay applies to matrices only (ndim >= 2), and the
global norm sums the leaves in the reference's order (`jax.tree.leaves`:
sorted dict keys), so that it rounds like the reference. Every scalar of a
step (the clip scale, the learning rate, the step count) stays a device
tensor: a step never reads back to the host.

The update is in place, as the reference's jitted step writes into its
donated buffers (`donate_argnums=(0, 1)`): each leaf's new weight and
moments go into the tensors it was given, so a step holds one copy of
each (12 B a bf16 parameter with its gradient and f32 moments). A leaf
larger than PIECE elements is updated PIECE elements at a time, so the
update's f32 temporaries stay within ~24 B an element of one piece
whatever the leaf's size. The global norm sums each leaf's squares
whole (a piecewise sum would round otherwise and move the clip scale's
last bits), from one f32 copy of one leaf at a time.
"""
from __future__ import annotations

import dataclasses
import math
import torch

from ..device import is_dtensor

#: Elements of a leaf updated at a time: 2**26 took 219.3 ms for
#: llama4-scout's largest leaves (2.74e9 elements) on an H100, 2**25
#: 223.1, 2**24 230.5 (`tools/time_adamw.py`); its ~1.5 GiB of f32
#: temporaries stay under the global norm's 3.9 GiB for those leaves.
PIECE = 1 << 26


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


def _pieces(*xs: torch.Tensor) -> list[tuple[torch.Tensor, ...]]:
    """Matching views of same-shaped tensors over their flat storage,
    PIECE elements each (the last one shorter): the tensors whole where
    they fit one piece, or one of them is a DTensor (its local shard is
    updated whole) or not contiguous."""
    n = xs[0].numel()
    if n <= PIECE or any(is_dtensor(x) or not x.is_contiguous()
                         for x in xs):
        return [xs]
    flat = [x.view(-1) for x in xs]
    return [tuple(f[i:i + PIECE] for f in flat) for i in range(0, n, PIECE)]


def global_norm(tree: dict) -> torch.Tensor:
    """The L2 norm of the tree's leaves, each leaf's f32 squares summed
    whole: a bf16 leaf's f32 copy is squared in place (4 B an element
    beside the leaf), with the values of `square(x.float())`."""
    total = 0
    for x in leaves(tree):
        sq = x.float()
        sq = sq.square() if sq is x or is_dtensor(sq) else sq.square_()
        total = total + torch.sum(sq)
        del sq
    return torch.sqrt(total)


def _update(cfg: AdamWConfig, p, g, mu, nu, scale, lr, b1t, b2t,
            decay: bool):
    """One piece's step, in the reference's order of operations; each
    temporary is dropped after its last use. `decay`: the leaf is a
    matrix (decoupled weight decay on matrices only)."""
    g = g.float() * scale
    mu = cfg.b1 * mu + (1 - cfg.b1) * g
    nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
    del g
    mhat = mu / b1t
    nhat = nu / b2t
    delta = mhat / (torch.sqrt(nhat) + cfg.eps)
    del mhat, nhat
    if decay:
        delta = delta + cfg.weight_decay * p.float()
    newp = (p.float() - lr * delta).to(p.dtype)
    return newp, mu, nu


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: dict, grads: dict,
                  state: dict) -> tuple[dict, dict, dict]:
    """One AdamW step with global-norm clipping, in place: each leaf's new
    weight is written into its tensor in `params` (after its piece's
    update has read the old one), its moments into `state["mu"]` and
    `state["nu"]`, and `state["step"]` is advanced. Returns (params,
    state, metrics): the trees it was given, metrics grad_norm and lr as
    device tensors."""
    step = state["step"]
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1t = 1 - cfg.b1 ** (step.float() + 1)
    b2t = 1 - cfg.b2 ** (step.float() + 1)
    for p, g, m, n in zip(leaves(params), leaves(grads), leaves(state["mu"]),
                          leaves(state["nu"]), strict=True):
        for pp, gp, mp, np_ in _pieces(p, g, m, n):
            newp, mu, nu = _update(cfg, pp, gp, mp, np_, scale, lr, b1t,
                                   b2t, p.ndim >= 2)
            pp.copy_(newp)
            mp.copy_(mu)
            np_.copy_(nu)
            del newp, mu, nu    # before the next piece's temporaries
    step.add_(1)
    return params, state, dict(grad_norm=gnorm, lr=lr)
