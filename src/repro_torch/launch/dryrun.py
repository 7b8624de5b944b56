"""Multi-pod dry-run: prove the distribution config is coherent.

For one (architecture × input shape × mesh) combination this script runs
the step function once on a fake process group of 256 ranks (single-pod
16x16) or 512 (multi-pod 2x16x16), as rank 0, with its parameters, caches
and inputs on the meta device (shapes, no data) made DTensors by the
sharding rules. Nothing is allocated or computed: the step runs the
port's plain path (its Hopper kernels need real tensors, as the
reference's dry-run lowers the XLA twins and never its Pallas kernels)
and `analysis.op_stats` counts one rank's flops, bytes and collectives as
it goes; `FlopCounterMode` gives the global count beside it. The row has
the reference's schema: the `hlo_` names stay, since the roofline and
`core.bridge.calibrate_from_dryrun` read them, but the counts come from
the op trace, not from HLO.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \
        --shape train_4k [--multi-pod] [--json out.json]

The fake process group is global to its process: run one combination
per process (`launch.sweep` does), never beside a real process group.
"""
import argparse
import json
import sys
import time


def init_fake_world(n: int) -> None:
    """A fake process group of n ranks in this process, as rank 0: its
    collectives return at once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks exists; the dry-run needs {n}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _copies(tree):
    """`tree` with every tensor a new copy (a leaf that requires a
    gradient stays one)."""
    import torch
    return torch.utils._pytree.tree_map(
        lambda t: t.detach().clone().requires_grad_(t.requires_grad)
        if isinstance(t, torch.Tensor) else t, tree)


def _step(cfg, case, mesh, opts, donate=True):
    """(the step as a thunk, its inputs) on meta DTensors over `mesh`.
    The step writes into its donated arguments, as the reference's
    `donate_argnums`: the train step into the params and optimizer state
    (`make_train_step`), decode into the cache (`layers._write`). With
    `donate` False it copies them first, inside the thunk."""
    from ..models import decoder
    from ..parallel import sharding as shd
    from ..training.optimizer import AdamWConfig, init_state
    from ..training.train_loop import as_trainable, make_train_step
    from .specs import input_specs, params_specs

    def own(tree):
        return tree if donate else _copies(tree)

    params = shd.distribute_params(params_specs(cfg), mesh)
    inputs = input_specs(cfg, case)
    if case.kind == "train":
        params = as_trainable(params)
        opt = init_state(params)
        step = make_train_step(cfg, AdamWConfig(), use_kernels=False)
        return (lambda: step(own(params), own(opt), inputs)), (params, opt,
                                                               inputs)
    if case.kind == "prefill":
        return (lambda: decoder.prefill(
            params, cfg, inputs["tokens"], inputs.get("prefix"),
            max_len=case.seq_len, use_kernels=False)), (params, inputs)
    cache = shd.distribute_cache(inputs["cache"], mesh,
                                 prefer_hd="kvhd" in opts)
    return (lambda: decoder.decode_step(
        params, cfg, own(cache), inputs["tokens"], inputs["pos"],
        use_kernels=False)), (params, cache, inputs["tokens"])


def trace_step(cfg, case, mesh, opts: tuple[str, ...] = (),
               donate: bool = True) -> dict:
    """Run `case`'s step of `cfg` once on meta DTensors over `mesh` under
    the op counter, the global flop counter and the memory tracker,
    `donate` as `run_one`'s. Returns dict(stats=OpStats, global_flops,
    memory, trace_s)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..analysis.op_stats import OpCounter, tree_bytes

    run, args = _step(cfg, case, mesh, opts, donate)
    counter = OpCounter()
    counter.stats.argument_bytes = tree_bytes(args)
    mem, memory = _mem_tracker(args)
    t0 = time.perf_counter()
    with counter, mem, FlopCounterMode(display=False) as flops:
        with torch.set_grad_enabled(case.kind == "train"):
            out = run()
    wall = time.perf_counter() - t0
    memory.update(argument_bytes=counter.stats.argument_bytes,
                  output_bytes=tree_bytes(out))
    if "error" not in memory:
        memory.update(_peak_bytes(mem, counter.stats.argument_bytes))
    return dict(stats=counter.stats, global_flops=flops.get_total_flops(),
                memory=memory, trace_s=wall)


def _mem_tracker(args):
    """(`torch.distributed._tools.mem_tracker.MemTracker` tracking args,
    or a null context where it cannot be built, and the memory dict:
    temp_bytes None until read, the reason under `error` where it is
    never read, as the reference keeps XLA's where XLA:CPU has none)."""
    import contextlib

    import torch
    memory = dict(argument_bytes=None, output_bytes=None, temp_bytes=None,
                  generated_code_bytes=None)
    try:
        from torch.distributed._tools.mem_tracker import MemTracker
        mt = MemTracker()
        mt.track_external(*[t for t in torch.utils._pytree.tree_leaves(args)
                            if isinstance(t, torch.Tensor)])
        return mt, memory
    except Exception as e:  # noqa: BLE001 (reported in the row)
        memory["error"] = f"{type(e).__name__}: {e}"
        return contextlib.nullcontext(), memory


def _peak_bytes(mt, argument_bytes: float) -> dict:
    """temp_bytes: the tracker's peak of live local bytes, over all
    devices and kinds, beyond the step's arguments (XLA's temp is the
    memory a program needs besides its arguments and outputs)."""
    try:
        peak = mt.get_tracker_snapshot("peak")
        total = sum(v.get("Total", 0) for v in peak.values())
        if not total:
            raise RuntimeError("MemTracker saw no memory")
        return dict(temp_bytes=max(0, total - argument_bytes))
    except Exception as e:  # noqa: BLE001 (reported in the row)
        return dict(temp_bytes=None, error=f"{type(e).__name__}: {e}")


def run_one(arch: str, shape: str, multi_pod: bool,
            donate: bool = True, opts: tuple[str, ...] = ()) -> dict:
    import dataclasses

    from ..configs import get_config
    from ..models.config import ModelConfig
    from .mesh import make_production_mesh
    from .specs import applicable, shape_case

    cfg: ModelConfig = get_config(arch)
    # Beyond-paper optimization variants (§Perf): baseline has all off.
    flag_map = dict(seqshard="seq_shard_attention",
                    moeshard="moe_expert_shard_constraint",
                    w8a8="moe_w8a8")
    cfg_opts = {flag_map[o]: True for o in opts if o in flag_map}
    if cfg_opts:
        cfg = dataclasses.replace(cfg, **cfg_opts)
    case = shape_case(shape)
    ok, why = applicable(cfg, case)
    if not ok:
        return dict(arch=arch, shape=shape, multi_pod=multi_pod,
                    status="skipped", reason=why)

    init_fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    return row(arch, shape, multi_pod, cfg, case, mesh, opts, donate)


def row(arch: str, shape: str, multi_pod: bool, cfg, case, mesh,
        opts: tuple[str, ...] = (), donate: bool = True) -> dict:
    """The dry-run row of `case`'s step of `cfg` on `mesh`: the
    reference's schema, the counts of `trace_step`."""
    t0 = time.perf_counter()
    traced = trace_step(cfg, case, mesh, tuple(opts), donate)
    stats = traced["stats"]
    return dict(
        arch=arch, shape=shape, multi_pod=multi_pod, status="ok",
        opts=list(opts),
        n_devices=mesh.size(), kind=case.kind,
        # nothing is lowered or compiled: the trace's wall, and the
        # set-up's (the meta trees and their DTensors)
        lower_s=round(traced["trace_s"], 2),
        compile_s=round(time.perf_counter() - t0 - traced["trace_s"], 2),
        # per device: one rank's local ops
        hlo_flops_per_device=stats.flops,
        hlo_bytes_per_device=stats.bytes_estimate,
        hlo_bytes_upper=stats.bytes_accessed,
        hlo_bytes_lower=stats.bytes_written + stats.argument_bytes,
        collective_bytes_per_device=stats.collective_bytes,
        collectives=stats.collectives,
        n_collectives=stats.n_collectives,
        raw_cost_analysis_flops=float(traced["global_flops"]),
        memory=traced["memory"],
        params_total=cfg.param_count(),
        params_active=cfg.active_param_count(),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--json", default=None, help="append result to this file")
    ap.add_argument("--opt", action="append", default=[],
                    choices=["seqshard", "moeshard", "w8a8", "kvhd"],
                    help="enable a beyond-paper optimization variant")
    args = ap.parse_args(argv)

    res = run_one(args.arch, args.shape, args.multi_pod,
                  opts=tuple(args.opt))
    print(json.dumps(res, indent=2, default=str))
    if args.json:
        try:
            with open(args.json) as f:
                data = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            data = []
        data = [r for r in data
                if not (r["arch"] == res["arch"] and r["shape"] == res["shape"]
                        and r["multi_pod"] == res["multi_pod"]
                        and r.get("opts", []) == res["opts"])]
        data.append(res)
        with open(args.json, "w") as f:
            json.dump(data, f, indent=1, default=str)
    return 0 if res["status"] in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
