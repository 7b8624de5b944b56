"""RPR401/402 in a kernel launcher (linted as
kernels/decode_attention/kernel.py, whose `decode_attention` is a table
entry): reading a device tensor's value to size the launch."""
import torch


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     k_pos: torch.Tensor, pos):
    S = int(k_pos.max()) + 1                    # RPR402: int() of a tensor
    if (k_pos < 0).any():                       # RPR401: if on a tensor
        raise ValueError("empty slots")
    return torch.empty_like(q), S, pos.item()   # RPR402: pos unannotated
