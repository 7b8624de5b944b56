"""Device-resident instance tensors for the lane-batched torch tier.

One `TierInstanceTensors` bundle per (`Instance`, device), cached on the
instance itself (`inst._xla_tensors`, a dict keyed by device, so a bundle
built for the CPU is never handed to a CUDA solve; the perturbed() /
stressed() / with_lam() helpers build fresh Instance objects, so a cached
bundle can never go stale).  Every tensor is a flat ``[I, J*K]`` (or
``[J*K]``) view of a precomputed numpy tensor the numpy engine already
uses — the host arrays are the source of truth, the device copies are
uploaded once and reused by every call of every solve on the instance.

float64 is non-negotiable: the numpy oracle runs in float64, and the
engine's <=-objective contract against it leaves no room for float32
rounding in the ranking keys.  Every tensor carries an explicit dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from .instance import Instance


def _up(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device)


class TierInstanceTensors:
    """Flat [I, J*K] device tensors shared by the phase-2 ranking program
    and the relocate screen program.

    The derived products (`psb_data`, `rho_d`) are computed with numpy in
    exactly the elementwise op order of `rank_keys_all`, so the values
    shipped to the device match the oracle's intermediate grids bitwise.
    """

    def __init__(self, inst: Instance, device: torch.device):
        I, J, K = inst.I, inst.J, inst.K
        JK = J * K
        self.inst = inst
        self.device = device
        self.JK = JK
        m1_delay = inst.m1_delay.reshape(I, JK)
        f64, b8 = torch.float64, torch.bool
        dev = device
        # --- shared by both programs ----------------------------------
        self.m1_delay = _up(m1_delay, f64, dev)
        self.m1_valid = _up(inst.m1_feasible.reshape(I, JK), b8, dev)
        self.ebf = _up(inst.e_bar_floor_flat, f64, dev)
        self.eps = _up(inst.eps, f64, dev)
        self.Delta = _up(inst.Delta, f64, dev)
        self.Delta_T = float(inst.Delta_T)
        # --- phase-2 ranking (rank_keys_all's cost pieces) ------------
        # Cost term p_s * (B_j + data_gb_i), elementwise in the oracle's
        # own op order (add, then scale).
        B_jk = np.repeat(inst.B, K)
        self.psb_data = _up(
            inst.p_s * (B_jk[None, :] + inst.data_gb[:, None]), f64, dev)
        # Routed-delay cost rho_i * d * 1e3 at the M1 winner (active
        # cells are overridden per call).
        self.rho_d = _up((inst.rho[:, None] * m1_delay) * 1e3, f64, dev)
        self.m1_nm = _up(inst.m1_nm.reshape(I, JK).astype(float), f64, dev)
        self.pc_flat = _up(np.tile(inst.p_c, J), f64, dev)
        # --- relocate screen (DestCache row ingredients) --------------
        self.m1_rental = _up(inst.m1_rental.reshape(I, JK), f64, dev)
        self.lpx = _up(inst.load_per_x_flat, f64, dev)
        self.psB_flat = _up(np.repeat(inst.p_s_B, K), f64, dev)
        self.comp_flat = _up(np.tile(inst.comp_cap_coef, J), f64, dev)


def tensors_for(inst: Instance, device: torch.device) -> TierInstanceTensors:
    """The instance's cached tensor bundle on `device`, built on first
    use."""
    if inst._xla_tensors is None:
        inst._xla_tensors = {}
    key = str(device)
    tx = inst._xla_tensors.get(key)
    if tx is None:
        tx = inst._xla_tensors[key] = TierInstanceTensors(inst, device)
    return tx
