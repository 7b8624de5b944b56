"""Clean twin of bad_launcher: the launcher checks metadata only."""
import torch


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     k_pos: torch.Tensor, pos: int):
    B, KV, G, hd = q.shape
    S = k.shape[2]
    if q.device.type != "cuda" or k.dtype != q.dtype:
        raise ValueError("operands")
    for name, t in (("k", k), ("v", v)):
        if t.stride(-1) != 1 or min(t.stride()) < 0:
            raise ValueError(f"{name} strides {t.stride()}")
    if k_pos.dtype != torch.int32 or k_pos.shape != (S,):
        raise ValueError("k_pos")
    out = torch.empty_like(q)
    ws = (torch.empty((B, KV, G, hd), dtype=torch.float32, device=q.device)
          if S > 64 else None)
    return out, ws, int(pos), q.data_ptr()
