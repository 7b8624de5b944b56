"""Clean twin of bad_decode_step: host values branch, tensors stay on the
device (torch.where, masks), metadata reads are free."""
import torch

from repro_torch.models.config import ModelConfig


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, max_len: int,
            prefix: torch.Tensor | None = None, *, use_kernels: bool = True):
    B, T = tokens.shape
    P = 0 if prefix is None else prefix.shape[1]
    for layer in range(cfg.n_layers):           # host bound
        pass
    if use_kernels and tokens.device.type == "cuda" and "embed" in params:
        pass
    if tokens.numel() == 0 or not tokens.is_contiguous():
        raise ValueError(f"bad tokens {tuple(tokens.shape)}")
    return params["embed"][tokens], max(max_len, T + P)


def decode_step(params: dict, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
                pos: int):
    x = params["embed"][tokens]
    x = torch.where(x.abs() > 100, x / 100, x)  # device-side select
    if pos >= cfg.max_len or not isinstance(cache, dict):
        raise ValueError("cache full")
    steps = []
    for t in range(int(pos), int(pos) + 2):     # int() of a host int
        steps.append(x[:, t % x.shape[1]])
    return x @ params["head"], cache, torch.stack(steps)
