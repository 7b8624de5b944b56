"""RPR401/402/403 in device programs (linted as models/decoder.py, whose
`prefill` and `decode_step` are entries of the device-program table)."""
import torch

from repro_torch.models.config import ModelConfig


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, max_len: int):
    n = int(tokens.max())                       # RPR402: int() of a tensor
    for _ in range(tokens.sum()):               # RPR403: traced bound
        pass
    return params["embed"][tokens], n


def decode_step(params: dict, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
                pos: int):
    x = params["embed"][tokens]
    if x.abs().max() > 100:                     # RPR401: if on a tensor
        x = x / 100
    scale = 2.0 if x.mean() > 0 else 1.0        # RPR401: IfExp on a tensor
    top = x.argmax(dim=-1).tolist()             # RPR402: .tolist()
    logits = x @ params["head"]
    assert torch.isfinite(logits).all()         # RPR401: assert on a tensor
    return logits * scale, cache, logits.sum().item(), top  # RPR402
