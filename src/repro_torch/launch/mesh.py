"""Device meshes over the process group's world.

Single pod: 256 devices as (data=16, model=16).
Multi-pod:  512 devices as (pod=2, data=16, model=16) — the `pod` axis
carries data parallelism across pods (batch + FSDP), keeping TP traffic
inside a pod; only gradient/FSDP collectives cross pods.

Defined as FUNCTIONS over an initialised process group: importing this
module starts no process group and touches no device. The caller gives
`torch.distributed.init_process_group` its address, world size and rank.
"""
from __future__ import annotations

import torch.distributed as dist

from ..device import resolve_device


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group before building a mesh")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The production mesh; raises unless the world is 256 ranks (512 with
    `multi_pod`). On CUDA unless the caller passes "cpu" (the dry-run's
    fake process group); raises without CUDA."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n, want = _world(), 512 if multi_pod else 256
    if n != want:
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{want} ranks, got {n}")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


def make_host_mesh(model: int | None = None, device: str = "cuda"):
    """(data, model) mesh over the world's ranks: `model` of them along
    the model axis (default 1), the rest along data. On CUDA unless the
    caller passes "cpu"; raises without CUDA."""
    from torch.distributed.device_mesh import init_device_mesh
    n = _world()
    model = model or 1
    if n % model:
        raise ValueError(f"a model axis of {model} does not divide the "
                         f"world of {n} ranks")
    return init_device_mesh(resolve_device(device).type, (n // model, model),
                            mesh_dim_names=("data", "model"))


# H100 SXM5 hardware constants used by the roofline analysis (per GPU),
# under the reference's names. Data-sheet figures (NVIDIA H100 Tensor Core
# GPU data sheet, SXM5 column), not measurements of any card.
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense bf16 tensor core
HBM_BW = 3.35e12                  # B/s, HBM3
ICI_BW = 900e9                    # B/s, NVLink 4, both directions together
