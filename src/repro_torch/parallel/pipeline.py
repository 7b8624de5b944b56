"""Pipeline parallelism over the `stage` mesh axis (GPipe schedule).

The paper treats PP depth `m` as a first-class decision variable whose cost
is (i) an additive per-token inter-stage communication delay `m * d_comm`
and (ii) a pipeline-bubble utilization factor eta (8g). This module is the
realization the planner's decision maps onto: layers are split into `m`
contiguous stages along a `stage` mesh axis; microbatches stream through
the stages, each tick's activations handed to the next stage around the
ring by point-to-point sends in the stage group.

Bubble accounting matches the paper's eta: with M microbatches and m stages
the schedule runs (M + m - 1) ticks, utilization = M / (M + m - 1); the
planner's eta = 0.9 corresponds to M ≈ 9 * (m - 1) microbatches.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .sharding import map_with_path


def pipeline_utilization(n_micro: int, n_stages: int) -> float:
    """GPipe utilization = M / (M + m - 1) — the paper's eta."""
    return n_micro / (n_micro + n_stages - 1)


def _stage_slice(a: torch.Tensor, stage_id: int) -> torch.Tensor:
    """This stage's params from a leaf with a leading stage dim: the local
    shard of a DTensor sharded on it over `stage`, or row `stage_id` of a
    tensor every rank holds whole."""
    from torch.distributed.tensor import DTensor
    if isinstance(a, DTensor):
        local = a.to_local()
        if local.shape[0] != 1:
            raise ValueError(f"stage params must be sharded one stage per "
                             f"rank on the leading dim, got local "
                             f"{tuple(local.shape)}")
        return local[0]
    return a[stage_id]


def pipelined_forward(stage_fn: Callable, mesh, n_stages: int,
                      n_micro: int):
    """Build a pipelined forward pass.

    stage_fn(stage_params, x) -> x: applies ONE stage's layers.
    Returns f(stacked_stage_params, x_microbatches) where
      stacked_stage_params: tree with leading dim n_stages (DTensors
      sharded on it over the 'stage' mesh axis, or tensors every rank holds
      whole), x_microbatches: [n_micro, mb, ...] activations, the same on
      every rank of the stage group.

    Schedule: (n_micro + n_stages - 1) ticks; at tick t stage 0 ingests
    microbatch t, every stage runs its layers on the activation it holds
    (a bubble where it holds none), the last stage emits microbatch
    t - n_stages + 1, and the activations go to the next stage around the
    ring. Only the last stage holds the outputs (the others hold zeros), so
    a sum over the stage group replicates them: every rank returns the
    [n_micro, mb, ...] outputs. At n_stages == 1 the handoff is the
    identity.
    """
    if "stage" not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no 'stage' axis: {mesh.mesh_dim_names}")
    size = mesh.size(mesh.mesh_dim_names.index("stage"))
    if size != n_stages:
        raise ValueError(f"the 'stage' axis has {size} ranks, not "
                         f"{n_stages}")

    def run(params, xs: torch.Tensor) -> torch.Tensor:
        group = mesh.get_group("stage")
        stage_id = mesh.get_local_rank("stage")
        sp = map_with_path(lambda _, a: _stage_slice(a, stage_id), params)
        nxt = dist.get_global_rank(group, (stage_id + 1) % n_stages)
        prv = dist.get_global_rank(group, (stage_id - 1) % n_stages)
        buf = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        for t in range(n_micro + n_stages - 1):
            if stage_id == 0 and t < n_micro:
                buf = xs[t]
            mb = t - stage_id               # the microbatch this stage holds
            y = stage_fn(sp, buf) if 0 <= mb < n_micro else buf
            if stage_id == n_stages - 1 and mb >= 0:
                outs[mb] = y
            if n_stages > 1:
                y = y.contiguous()
                buf = torch.empty_like(y)
                reqs = dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, y, nxt, group),
                    dist.P2POp(dist.irecv, buf, prv, group)])
                for r in reqs:
                    r.wait()
            else:
                buf = y
        if n_stages > 1:
            dist.all_reduce(outs, group=group)
        return outs

    return run


def split_stages(layer_params, n_stages: int):
    """Reshape stacked layer params [L, ...] -> [n_stages, L/m, ...]."""
    def r(a):
        L = a.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} "
                             f"stages")
        return a.reshape((n_stages, L // n_stages) + tuple(a.shape[1:]))
    return map_with_path(lambda _, a: r(a), layer_params)
