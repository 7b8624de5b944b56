"""RPR301/302 in the f64 risk solver."""
import torch


def _candidate_kernel(vals, c, pad):
    S = pad.shape[0]
    eye = torch.eye(S, device=vals.device)      # RPR301: implicit f32
    z = (vals[pad] @ eye).half()                # RPR302: .half()
    return z, torch.full((S,), 0.5, device=vals.device)     # RPR301
