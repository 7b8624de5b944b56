#!/usr/bin/env python3
"""The collectives of the sharded loss, counted on the CPU, by shape.

    python3 tools/dryrun_collectives.py [--tree TREE]

The harness of `tests/test_torch_dryrun.py`: a (data, model) = (2, 4) mesh
of 8 fake ranks (the dry-run's fake process group), parameters and tokens
on the meta device, the plain path, one rank's ops counted
(`analysis.op_stats.OpCounter`). Runs the forward loss of qwen2-0.5b at 4
layers (tokens [8, 256] and [8, 512]) and of llama4-scout at 2 layers
(tokens [8, 256]), and qwen2-0.5b's 2-layer `train_4k` row (forward,
backward, AdamW; batch [8, 256]). Prints one JSON object: per run the
flops and collective bytes a device, and every collective whose outputs
add up to at least 5e7 bytes, by (op, output shape, dtype). TREE (default:
this checkout) is the root of the checkout whose `src/repro_torch` runs,
for instance a `git archive` of another commit.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BIG = 5e7      # bytes: the collectives listed one by one


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from repro_torch.analysis.op_stats import (_SKIP_BYTES_OPS, COLLECTIVE_NS,
                                               OpCounter)
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import ShapeCase, params_specs
    from repro_torch.models import decoder
    from repro_torch.parallel import sharding as shd
    torch.set_num_threads(1)

    class ByShape(TorchDispatchMode):
        """Bytes of each collective's outputs, by (op, shape, dtype), on
        one rank's local tensors (as `OpCounter` counts them)."""

        def __init__(self):
            super().__init__()
            self.bytes = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            from torch._subclasses.fake_tensor import FakeTensor
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            name = func.__name__.split(".")[0]
            if (func.namespace in COLLECTIVE_NS
                    and name not in _SKIP_BYTES_OPS
                    and not any(isinstance(a, FakeTensor)
                                for a in tree_leaves((args, kwargs)))):
                for t in tree_leaves(out):
                    if isinstance(t, torch.Tensor):
                        self.bytes[(name, tuple(t.shape), str(t.dtype))] += (
                            t.numel() * t.element_size())
            return out

    def big(seen):
        return [dict(op=op, shape=list(shape), dtype=dt, bytes=b)
                for (op, shape, dt), b in sorted(seen.items(),
                                                 key=lambda kv: -kv[1])
                if b >= BIG]

    dryrun.init_fake_world(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    out = dict(tree=str(Path(decoder.__file__).parents[2]))
    for arch, layers, T in (("qwen2-0.5b", 4, 256), ("qwen2-0.5b", 4, 512),
                            ("llama4-scout-17b-a16e", 2, 256)):
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        p = shd.distribute_params(params_specs(cfg), mesh)
        t = torch.empty(8, T, dtype=torch.int32, device="meta")
        c, tag = OpCounter(), ByShape()
        with c, tag, torch.no_grad():
            decoder.train_loss(p, cfg, dict(tokens=t, targets=t),
                               use_kernels=False)
        out[f"{arch}, {layers} layers, forward loss, tokens [8, {T}]"] = dict(
            flops=c.stats.flops, collective_bytes=c.stats.collective_bytes,
            collectives=big(tag.bytes))
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=2)
    tag = ByShape()
    with tag:
        r = dryrun.row("qwen2-0.5b", "train_4k", False, cfg,
                       ShapeCase("train_4k", 256, 8, "train"), mesh)
    out["qwen2-0.5b, 2 layers, train_4k row, batch [8, 256]"] = dict(
        flops=r["hlo_flops_per_device"],
        collective_bytes=r["collective_bytes_per_device"],
        by_kind=r["collectives"], collectives=big(tag.bytes))
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
