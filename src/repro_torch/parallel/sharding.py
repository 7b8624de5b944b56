"""Rule-based, divisibility-checked sharding for every architecture, as
DTensor placements on a `DeviceMesh`.

Strategy (Megatron-TP + FSDP hybrid), the reference's rules unchanged:
  * the `model` mesh axis carries tensor parallelism: projection output dims,
    expert dims (expert parallelism), SSM inner dims, attention head dims;
  * the `data` (and `pod`) axes carry the batch AND fully-sharded parameter
    storage (FSDP) on a second tensor dim;
  * every rule checks divisibility against the mesh axis sizes and falls
    back to replication — this is what lets ten heterogeneous architectures
    (odd vocab 92553, 14-head attention, 384-expert MoE) share one codebase.

A spec is a tuple with one entry per tensor dim: None, a mesh axis name,
or a tuple of names (the information of JAX's `PartitionSpec`). The rules
read only the mesh's axis names and sizes, so they take a `DeviceMesh` or
any object with `.shape` (axis -> size) and `.axis_names`. Trees are
nested dicts, tuples and lists whose leaves have a `.shape`; a leaf's path
is its dict keys and sequence indices as strings, the reference's key path.
`to_placements` turns a spec into one `Shard(d)` / `Replicate()` per mesh
dim, and `distribute_params` / `distribute_cache` turn the port's trees
into DTensors.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import torch


class Spec(tuple):
    """A sharding spec: one entry per tensor dim (None, an axis name, or a
    tuple of names; a tuple of one name is that name, as in JAX's
    `PartitionSpec`). A tuple subclass, so a spec tree's leaves are told
    apart from the tuples of the tree it mirrors."""

    def __new__(cls, entries=()):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


class MeshAxes:
    """A `DeviceMesh`'s axis names and sizes in the form the rules read."""

    def __init__(self, mesh):
        self.axis_names = tuple(mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, mesh.shape))


def _axes(mesh):
    """The rules' view of `mesh`: a DeviceMesh, or anything with `.shape`
    (axis -> size) and `.axis_names`."""
    return MeshAxes(mesh) if hasattr(mesh, "mesh_dim_names") else mesh


def mesh_axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    mesh = _axes(mesh)
    return int(math.prod(mesh.shape[a] for a in axes))


def batch_axes(mesh):
    """Axes carrying the global batch."""
    ax = tuple(a for a in ("pod", "data") if a in _axes(mesh).axis_names)
    return ax if ax else None


def fsdp_axes(mesh):
    """Axes carrying fully-sharded parameter storage (same as batch)."""
    return batch_axes(mesh)


def _fits(dim: int, mesh, axes) -> bool:
    return axes is not None and dim % mesh_axis_size(mesh, axes) == 0


def _matrix_spec(shape: tuple[int, ...], mesh, n_stack: int,
                 model_dim: int, fsdp_dim: int) -> Spec:
    """Spec for a (possibly stacked) matrix: `model` on model_dim, FSDP on
    fsdp_dim, each guarded by divisibility."""
    spec: list[Any] = [None] * len(shape)
    if _fits(shape[model_dim], mesh, "model" if "model" in mesh.axis_names
             else None):
        spec[model_dim] = "model"
    fx = fsdp_axes(mesh)
    if fsdp_dim != model_dim and _fits(shape[fsdp_dim], mesh, fx):
        spec[fsdp_dim] = fx
    del n_stack
    return Spec(spec)


# Parameter-name classification: which dim gets TP ('model').
_COL_PARALLEL = {"wq", "wk", "wv", "w1", "w3", "wx", "wz", "wB", "wC",
                 "wdt", "wA", "wg", "wr"}
_ROW_PARALLEL = {"wo", "w2", "wB_out"}
_REPLICATED = {"ln", "ln1", "ln2", "final_norm", "dt_bias", "A_log", "D",
               "u", "mu", "w0", "router", "bq", "bk", "bv"}


def _param_spec(path: tuple[str, ...], shape: tuple[int, ...],
                mesh) -> Spec:
    name = path[-1]
    in_moe = "moe" in path
    nd = len(shape)
    if name in _REPLICATED or nd <= 1:
        return Spec((None,) * nd)
    if name == "embed":
        # [V, d] or [nq, V, d]
        vdim, ddim = nd - 2, nd - 1
        spec: list[Any] = [None] * nd
        if _fits(shape[vdim], mesh, "model"):
            spec[vdim] = "model"
            if _fits(shape[ddim], mesh, fsdp_axes(mesh)):
                spec[ddim] = fsdp_axes(mesh)
        elif _fits(shape[ddim], mesh, "model"):
            spec[ddim] = "model"
        return Spec(spec)
    if name == "head":
        # [d, V] or [nq, d, V]
        ddim, vdim = nd - 2, nd - 1
        spec = [None] * nd
        if _fits(shape[vdim], mesh, "model"):
            spec[vdim] = "model"
            if _fits(shape[ddim], mesh, fsdp_axes(mesh)):
                spec[ddim] = fsdp_axes(mesh)
        elif _fits(shape[ddim], mesh, "model"):
            spec[ddim] = "model"
        return Spec(spec)
    if name == "prefix_proj":
        return _matrix_spec(shape, mesh, 0, nd - 1, nd - 2)
    if in_moe and name in ("w1", "w3", "w2") and nd >= 3:
        # Expert-parallel: [.., E, d, f] / [.., E, f, d] — E over `model`,
        # the wide inner dim over FSDP.
        edim = nd - 3
        spec = [None] * nd
        if _fits(shape[edim], mesh, "model"):
            spec[edim] = "model"
            wide = nd - 1 if name in ("w1", "w3") else nd - 2
            if _fits(shape[wide], mesh, fsdp_axes(mesh)):
                spec[wide] = fsdp_axes(mesh)
        else:  # fall back to plain TP on the f dim
            wide = nd - 1 if name in ("w1", "w3") else nd - 2
            if _fits(shape[wide], mesh, "model"):
                spec[wide] = "model"
        return Spec(spec)
    if name == "conv":
        spec = [None] * nd
        if _fits(shape[-1], mesh, "model"):
            spec[-1] = "model"
        return Spec(spec)
    if name in _COL_PARALLEL:
        return _matrix_spec(shape, mesh, 0, nd - 1, nd - 2)
    if name in _ROW_PARALLEL:
        return _matrix_spec(shape, mesh, 0, nd - 2, nd - 1)
    return Spec((None,) * nd)


def map_with_path(fn: Callable, tree: Any, path: tuple[str, ...] = ()):
    """`fn(path, leaf)` over a tree of dicts, tuples and lists, with the
    same structure out; None stays None (a subtree with no leaves)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(params: Any, mesh) -> Any:
    """Spec tree matching `params`."""
    mesh = _axes(mesh)
    return map_with_path(
        lambda path, leaf: _param_spec(path, tuple(leaf.shape), mesh), params)


def opt_state_specs(params_spec: Any) -> dict:
    """AdamW moments inherit the parameter sharding (ZeRO-style)."""
    return dict(mu=params_spec, nu=params_spec, step=Spec())


def batch_spec(mesh, shape: tuple[int, ...]) -> Spec:
    """Batch-leading arrays: shard dim 0 over ('pod','data') if divisible."""
    mesh = _axes(mesh)
    bx = batch_axes(mesh)
    if _fits(shape[0], mesh, bx):
        return Spec((bx,) + (None,) * (len(shape) - 1))
    # try 'data' alone (multi-pod, batch not divisible by pod*data)
    if "data" in (bx or ()) and shape[0] % mesh.shape["data"] == 0:
        return Spec(("data",) + (None,) * (len(shape) - 1))
    return Spec((None,) * len(shape))


def _cache_spec(names: tuple[str, ...], shp: tuple[int, ...], mesh,
                prefer_hd: bool) -> Spec:
    nd = len(shp)
    s: list[Any] = [None] * nd
    bx = batch_axes(mesh)
    bdim = 1 if nd >= 2 else 0
    # mamba group caches are [n_super, E, B, ...]
    if "mamba" in names and nd >= 3:
        bdim = 2
    if nd > bdim and _fits(shp[bdim], mesh, bx):
        s[bdim] = bx
    if "ssm" in names:
        # [..., B, nh, hp, N] -> shard nh over model
        if _fits(shp[bdim + 1], mesh, "model"):
            s[bdim + 1] = "model"
    elif "state" in names:
        # rwkv [..., B, H, hd, hd] -> shard H
        if _fits(shp[bdim + 1], mesh, "model"):
            s[bdim + 1] = "model"
    elif "conv" in names or "xprev" in names:
        if _fits(shp[-1], mesh, "model"):
            s[-1] = "model"
    elif nd == 5:
        # attention cache [L, B, S, KV, hd]: KV over model, else S
        # (or hd under prefer_hd)
        if _fits(shp[3], mesh, "model"):
            s[3] = "model"
        elif prefer_hd and _fits(shp[4], mesh, "model"):
            s[4] = "model"
        elif _fits(shp[2], mesh, "model"):
            s[2] = "model"
    return Spec(s)


def cache_specs(cache: Any, mesh, prefer_hd: bool = False) -> Any:
    """KV/state caches: batch dim over data axes; heads (or window/seq) over
    `model` when divisible. Cache trees are stacked with a leading layer
    (or super-block) dim followed by batch.

    prefer_hd: for attention caches whose KV-head count does not divide the
    `model` axis, shard the head_dim instead of the sequence — decode then
    all-reduces per-step logits instead of all-gathering the cache."""
    mesh = _axes(mesh)
    return map_with_path(
        lambda path, leaf: _cache_spec(path, tuple(leaf.shape), mesh,
                                       prefer_hd), cache)


def to_placements(spec: Spec, mesh) -> list:
    """One placement per mesh dim: `Shard(d)` on every mesh dim that tensor
    dim d is sharded over (a dim over ('pod', 'data') is sharded on both,
    in mesh order: JAX's major-to-minor), `Replicate()` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.mesh_dim_names]
    for d, entry in enumerate(spec):
        for axis in (entry,) if isinstance(entry, str) else entry or ():
            out[mesh.mesh_dim_names.index(axis)] = Shard(d)
    return out


def _shard_of(t, mesh, placements) -> Any:
    """This rank's even shard of t under `placements` (a tensor dim split
    over several mesh dims is split in mesh order, as DTensor splits it).
    t itself where no mesh dim of more than one rank splits it, so a
    one-device mesh shares t's storage. Else a tensor of its own, laid out
    as t: contiguous, or K-major for the W8A8 expert weights (int8 with a
    unit stride on d_in, `moe.kmajor`), which `int8_grouped_matmul`
    routes by layout. Meta tensors give meta shards: nothing is moved."""
    local = t.detach()
    for i, p in enumerate(placements):
        n = mesh.size(i)
        if p.is_shard() and n > 1:
            size = local.shape[p.dim] // n
            local = local.narrow(p.dim, mesh.get_local_rank(i) * size, size)
    if local.shape == t.shape:
        return local
    if t.dtype == torch.int8 and t.dim() >= 2 and t.stride(-2) == 1:
        return local.transpose(-1, -2).contiguous().transpose(-1, -2)
    return local.clone(memory_format=torch.contiguous_format)


def _distribute(tree: Any, rule: Callable, mesh) -> Any:
    """Each leaf as a DTensor placed by `rule`, built from this rank's
    shard (`_shard_of`) with no communication: every rank must hold the
    same whole tree, as the port's seeded trees are."""
    from torch.distributed.tensor import DTensor
    axes = _axes(mesh)

    def place(path, t):
        pl = to_placements(rule(path, tuple(t.shape), axes), mesh)
        return DTensor.from_local(_shard_of(t, mesh, pl), mesh, pl,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    return map_with_path(place, tree)


def distribute_params(params: Any, mesh) -> Any:
    """The port's parameter tree as DTensors placed by `param_specs`; real
    or meta tensors (the dry-run's), the W8A8 expert weights K-major in
    their shards."""
    return _distribute(params, _param_spec, mesh)


def distribute_cache(cache: Any, mesh, prefer_hd: bool = False) -> Any:
    """The port's cache tree as DTensors placed by `cache_specs`; real or
    meta tensors."""
    return _distribute(
        cache, lambda path, shp, axes: _cache_spec(path, shp, axes, prefer_hd),
        mesh)
