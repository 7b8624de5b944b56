"""Clean twin of risk/bad_dtype, and RPR303's torch form: a Python float
entering a device program is a wrapped number and never demotes f64."""
import torch


def _candidate_kernel(vals, c, pad, scale):
    S = pad.shape[0]
    eye = torch.eye(S, dtype=vals.dtype, device=vals.device)
    z = torch.where(vals[pad] @ eye > 0, vals[pad] @ eye, 1.0)
    return z * scale, torch.full((S,), 0.5, dtype=vals.dtype,
                                 device=vals.device)


def caller(vals, c, pad):
    return _candidate_kernel(vals, c, pad, 0.5)     # float literal: no RPR303
