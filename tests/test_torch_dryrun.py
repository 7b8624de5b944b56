"""The port's dry-run, its op counter, the meta-device specs, the
production meshes and the roofline, against the JAX package's
(`tests/test_distribution.py` has the reference's twins).

Everything that needs a process group runs in a subprocess with a fake
one (`torch.testing._internal.distributed.fake_pg`): it is global to its
process, and this one keeps none (`test_torch_parallel`'s mesh test
asserts so). The reference's HLO count runs in a subprocess of its own
with 8 host devices, as its test does.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _ref_cpu  # noqa: F401  (pins the reference to the CPU)

from repro_torch.analysis import roofline
from repro_torch.analysis.op_stats import OpCounter, OpStats
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import specs, sweep
from repro_torch.models import decoder
from repro_torch.parallel.sharding import map_with_path

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "experiments", "dryrun_results_torch.json")
# qwen2-0.5b's forward loss at 4 layers on a (2, 4) mesh, tokens [8, 256]:
# the port runs prefill attention on every "model" rank (its 2 KV heads do
# not divide 4, so the kernels' placements replicate whole heads), where
# GSPMD splits part of it on this small mesh: the port's count is the
# larger, 1.065x. At the production meshes GSPMD replicates that attention
# too (kimi-k2 prefill_32k at 1 layer on 16x16: 7.578e13 flops a device in
# both programs).
FLOP_TOL = 0.10


# A torch subprocess's environment and first lines: one intra-op thread,
# as this module runs, so that the subprocesses do not crowd the cores
# that the other test workers share.
ONE_THREAD = dict(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
_ONE_THREAD_CODE = "import torch\ntorch.set_num_threads(1)\n"


def _env(extra=None) -> dict:
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                **(extra or {}))


def _run(code: str, env_extra=None, timeout: float = 600.0):
    """`code` in a torch subprocess of one intra-op thread."""
    return subprocess.run(
        [sys.executable, "-c", _ONE_THREAD_CODE + textwrap.dedent(code)],
        capture_output=True, text=True, timeout=timeout,
        env=_env({**ONE_THREAD, **(env_extra or {})}))


def _run_ref(code: str, n_devices: int, timeout: float = 600.0):
    """`code` in a jax subprocess with `n_devices` host devices."""
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
        text=True, timeout=timeout, env=_env({
            "XLA_FLAGS": f"--xla_force_host_platform_device_count="
                         f"{n_devices}", "JAX_PLATFORMS": "cpu"}))


def _last_json(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# The op counter
# ---------------------------------------------------------------------------

def test_op_counter_counts_the_local_product():
    """[256, 64, 4096] @ [4096, 8192] in bf16 on the meta device, x split
    on its batch over "data" and w on its columns over "model" of a 16x16
    mesh over 256 fake ranks: the counter sees one rank's
    [1024, 4096] x [4096, 512] (4.29e9 flops), not the global product
    (1.10e12, which `FlopCounterMode` beside it counts), and no call of
    DTensor's sharding propagation."""
    got = _last_json(_run("""
        import json, torch
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch.analysis.op_stats import OpCounter
        from repro_torch.launch.dryrun import init_fake_world
        from repro_torch.launch.mesh import make_production_mesh
        init_fake_world(256)
        mesh = make_production_mesh(device="cpu")
        meta = dict(device="meta", dtype=torch.bfloat16)
        x = DTensor.from_local(torch.empty(16, 64, 4096, **meta), mesh,
                               [Shard(0), Replicate()])
        w = DTensor.from_local(torch.empty(4096, 512, **meta), mesh,
                               [Replicate(), Shard(1)])
        c = OpCounter()
        with c, FlopCounterMode(display=False) as fc:
            y = x @ w
        print(json.dumps(dict(flops=c.stats.flops,
                              global_flops=fc.get_total_flops(),
                              shape=list(y.shape),
                              local=list(y.to_local().shape))))
    """))
    assert got["flops"] == 2 * 1024 * 4096 * 512 == 4294967296
    assert got["global_flops"] == 2 * 256 * 64 * 4096 * 8192
    assert got["shape"] == [256, 64, 8192] and got["local"] == [16, 64, 512]


def test_op_counter_weights_a_loop_by_its_trip_count():
    """The twin of `test_hlo_stats_trip_count_weighting`: a loop of N
    matmuls counts N times one of them (exactly: eager ops are counted as
    they run), and views and `detach` write no bytes."""
    d, N = 64, 16
    w = torch.empty(d, d, device="meta")
    with OpCounter() as c:
        h = torch.empty(d, d, device="meta")
        for _ in range(N):
            h = h @ w
        h.view(-1).detach()
    assert c.stats.flops == 2.0 * d * d * d * N
    assert c.stats.bytes_written == N * d * d * 4
    assert c.stats.bytes_accessed == N * 3 * d * d * 4


def test_op_stats_bytes_estimate_is_the_reference_formula():
    from repro.analysis.hlo_stats import HloStats
    for lo, hi, arg in ((10.0, 40.0, 5.0), (100.0, 20.0, 0.0)):
        ref = HloStats(bytes_written=lo, bytes_accessed=hi,
                       argument_bytes=arg)
        got = OpStats(bytes_written=lo, bytes_accessed=hi, argument_bytes=arg)
        assert got.bytes_estimate == ref.bytes_estimate
    assert ([f.name for f in dataclasses.fields(OpStats)]
            == [f.name for f in dataclasses.fields(HloStats)])


# ---------------------------------------------------------------------------
# The dry-run
# ---------------------------------------------------------------------------

_REF_SMOKE = """
    import dataclasses, json
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import decoder
    from repro.parallel import sharding as shd
    from repro.launch.specs import params_specs
    from repro.analysis.hlo_stats import analyze
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=4)
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    p_shapes = params_specs(cfg)
    p_shard = shd.to_shardings(shd.param_specs(p_shapes, mesh), mesh)
    toks = jax.ShapeDtypeStruct((8, 256), jnp.int32)
    tok_shard = jax.sharding.NamedSharding(
        mesh, shd.batch_spec(mesh, toks.shape))
    with mesh:
        f = jax.jit(lambda p, t: decoder.train_loss(
            p, cfg, dict(tokens=t, targets=t)),
            in_shardings=(p_shard, tok_shard))
        compiled = f.lower(p_shapes, toks).compile()
    s = analyze(compiled.as_text())
    print(json.dumps(dict(flops=s.flops, collective_bytes=s.collective_bytes)))
"""

_PORT_SMOKE = """
    import dataclasses, json, torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.analysis.op_stats import OpCounter
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import ShapeCase, params_specs
    from repro_torch.models import decoder
    from repro_torch.parallel import sharding as shd
    dryrun.init_fake_world(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    out = {}
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=4)
    p = shd.distribute_params(params_specs(cfg), mesh)
    for T, name in ((512, "qwen2-0.5b/512"), (256, "qwen2-0.5b")):
        t = torch.empty(8, T, dtype=torch.int32, device="meta")
        c = OpCounter()
        with c, torch.no_grad():
            decoder.train_loss(p, cfg, dict(tokens=t, targets=t),
                               use_kernels=False)
        out[name] = dict(flops=c.stats.flops,
                         collective_bytes=c.stats.collective_bytes)
    for arch, wide in MOE_RUNS:
        base = get_config(arch)
        cfg = dataclasses.replace(base, n_layers=2, d_ff=base.d_ff * wide)
        p = shd.distribute_params(params_specs(cfg), mesh)
        c = OpCounter()
        with c, torch.no_grad():
            decoder.train_loss(p, cfg, dict(tokens=t, targets=t),
                               use_kernels=False)
        out[f"{arch}/{wide}"] = dict(flops=c.stats.flops,
                                     collective_bytes=c.stats.collective_bytes)
    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b"), n_layers=2)
    p = shd.distribute_params(params_specs(cfg), mesh)
    t = torch.empty(8, 4096, dtype=torch.int32, device="meta")
    c = OpCounter()
    with c, torch.no_grad():
        decoder.train_loss(p, cfg, dict(tokens=t, targets=t),
                           use_kernels=False)
    out["kimi-k2-1t-a32b/32k"] = dict(flops=c.stats.flops,
                                      collective_bytes=c.stats.collective_bytes)
    case = ShapeCase("train_4k", 256, 8, "train")
    for arch in ("rwkv6-7b", "zamba2-7b", "kimi-k2-1t-a32b", "qwen2-0.5b"):
        c = dataclasses.replace(get_config(arch), n_layers=2)
        out[arch + "/train"] = dryrun.row(arch, "train_4k", False, c, case,
                                          mesh)
    print(json.dumps(out))
"""

# The MoE forward losses of `_PORT_SMOKE` and `_REF_MOE`: (arch, d_ff
# multiple) at 2 layers, tokens [8, 256] on a (2, 4) mesh; and kimi-k2 at 2
# layers, tokens [8, 4096] (32k), under "kimi-k2-1t-a32b/32k".
MOE_RUNS = (("kimi-k2-1t-a32b", 1), ("kimi-k2-1t-a32b", 2),
            ("llama4-scout-17b-a16e", 1))

_REF_MOE = """
    import dataclasses, json
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import decoder
    from repro.parallel import sharding as shd
    from repro.launch.specs import params_specs
    from repro.analysis.hlo_stats import analyze
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    toks = jax.ShapeDtypeStruct((8, 256), jnp.int32)
    tok_shard = jax.sharding.NamedSharding(
        mesh, shd.batch_spec(mesh, toks.shape))
    out = {}
    for arch in ("kimi-k2-1t-a32b", "llama4-scout-17b-a16e"):
        cfg = dataclasses.replace(get_config(arch), n_layers=2)
        p_shapes = params_specs(cfg)
        p_shard = shd.to_shardings(shd.param_specs(p_shapes, mesh), mesh)
        with mesh:
            f = jax.jit(lambda p, t, cfg=cfg: decoder.train_loss(
                p, cfg, dict(tokens=t, targets=t)),
                in_shardings=(p_shard, tok_shard))
            compiled = f.lower(p_shapes, toks).compile()
        s = analyze(compiled.as_text())
        out[arch] = dict(flops=s.flops, collective_bytes=s.collective_bytes)
    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b"), n_layers=2)
    p_shapes = params_specs(cfg)
    p_shard = shd.to_shardings(shd.param_specs(p_shapes, mesh), mesh)
    toks = jax.ShapeDtypeStruct((8, 4096), jnp.int32)
    tok_shard = jax.sharding.NamedSharding(
        mesh, shd.batch_spec(mesh, toks.shape))
    with mesh:
        f = jax.jit(lambda p, t: decoder.train_loss(
            p, cfg, dict(tokens=t, targets=t)),
            in_shardings=(p_shard, tok_shard))
        compiled = f.lower(p_shapes, toks).compile()
    s = analyze(compiled.as_text())
    out["kimi-k2-1t-a32b/32k"] = dict(flops=s.flops,
                                      collective_bytes=s.collective_bytes)
    print(json.dumps(out))
"""

# The reference's train step (forward, backward, AdamW) of qwen2-0.5b at 2
# layers, batch [8, 256] on the (2, 4) mesh, jitted as its dry-run's
# `run_one` jits a train row.
_REF_TRAIN = """
    import dataclasses, json
    import jax
    from repro.analysis.hlo_stats import analyze
    from repro.configs import get_config
    from repro.launch.specs import ShapeCase, input_specs, params_specs
    from repro.parallel import sharding as shd
    from repro.training.optimizer import AdamWConfig, init_state
    from repro.training.train_loop import make_train_step
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=2)
    p_shapes = params_specs(cfg)
    p_spec = shd.param_specs(p_shapes, mesh)
    p_shard = shd.to_shardings(p_spec, mesh)
    inputs = input_specs(cfg, ShapeCase("train_4k", 256, 8, "train"))
    with mesh:
        opt_shapes = jax.eval_shape(init_state, p_shapes)
        opt_shard = shd.to_shardings(dict(
            mu=p_spec, nu=p_spec, step=jax.sharding.PartitionSpec()), mesh)
        batch_shard = {k: jax.sharding.NamedSharding(
            mesh, shd.batch_spec(mesh, v.shape)) for k, v in inputs.items()}
        f = jax.jit(make_train_step(cfg, AdamWConfig()),
                    in_shardings=(p_shard, opt_shard, batch_shard),
                    out_shardings=(p_shard, opt_shard, None),
                    donate_argnums=(0, 1))
        compiled = f.lower(p_shapes, opt_shapes, inputs).compile()
    s = analyze(compiled.as_text())
    print(json.dumps(dict(flops=s.flops, collective_bytes=s.collective_bytes)))
"""


@pytest.fixture(scope="module")
def smoke_rows():
    """The port's side of the smoke, in a subprocess: qwen2-0.5b at 4
    layers, the forward loss on a (2, 4) mesh of 8 fake ranks, tokens
    [8, 256] as the reference's test, and [8, 512]; the same for the MoE
    runs `MOE_RUNS` at 2 layers, tokens [8, 256]; and a train step
    (forward, backward, AdamW) row of rwkv6-7b, zamba2-7b, kimi-k2 and
    qwen2-0.5b at 2 layers on the same mesh, batch [8, 256]."""
    return _last_json(_run(_PORT_SMOKE.replace(
        "MOE_RUNS", repr(MOE_RUNS))))


@pytest.fixture(scope="module")
def ref_smoke():
    """The reference's qwen2-0.5b forward loss of `_REF_SMOKE`."""
    pytest.importorskip("jax")
    return _last_json(_run_ref(_REF_SMOKE, 8))


@pytest.fixture(scope="module")
def ref_moe():
    """The reference's MoE forward losses of `_REF_MOE`."""
    pytest.importorskip("jax")
    return _last_json(_run_ref(_REF_MOE, 8))


@pytest.fixture(scope="module")
def ref_train():
    """The reference's qwen2-0.5b train row of `_REF_TRAIN`."""
    pytest.importorskip("jax")
    return _last_json(_run_ref(_REF_TRAIN, 8))


def test_dryrun_smoke_subprocess(smoke_rows, ref_smoke):
    """Flops and collectives on every family; the qwen2-0.5b forward
    within FLOP_TOL of the reference's trip-count-aware HLO count
    (`analysis.hlo_stats.analyze` of the compiled program, per device)."""
    ref = ref_smoke
    got = smoke_rows["qwen2-0.5b"]
    assert got["flops"] > 1e9 and got["collective_bytes"] > 0
    assert ref["flops"] > 1e9 and ref["collective_bytes"] > 0
    ratio = got["flops"] / ref["flops"]
    assert abs(ratio - 1) <= FLOP_TOL, (got, ref, ratio)
    assert ratio >= 1, "the port counts replicated attention, not less"
    for arch in ("rwkv6-7b", "zamba2-7b", "kimi-k2-1t-a32b", "qwen2-0.5b"):
        r = smoke_rows[arch + "/train"]
        assert r["status"] == "ok" and r["kind"] == "train", arch
        assert r["hlo_flops_per_device"] > 1e9, arch
        assert r["collective_bytes_per_device"] > 0, arch
        assert r["raw_cost_analysis_flops"] > r["hlo_flops_per_device"], arch
        assert r["memory"]["argument_bytes"] > 0, arch
        assert r["memory"]["temp_bytes"] > 0, arch


def test_sharded_moe_flops_match_reference(smoke_rows, ref_moe):
    """kimi-k2 and llama4-scout at 2 layers, the forward loss on the
    (2, 4) mesh: the port's flops within FLOP_TOL of the reference's HLO
    count. Each rank runs its experts over the whole batch's copies
    (the global capacity) on its slice of f, as the reference's GSPMD
    program does; gathering the experts' whole f would run every expert
    product twice over here (1.355x and 1.178x)."""
    ref = ref_moe
    for arch in ("kimi-k2-1t-a32b", "llama4-scout-17b-a16e"):
        got = smoke_rows[f"{arch}/1"]["flops"]
        ratio = got / ref[arch]["flops"]
        assert abs(ratio - 1) <= FLOP_TOL, (arch, got, ref[arch], ratio)


def test_moe_moves_tokens_not_expert_weights(smoke_rows):
    """kimi-k2 at its d_ff and at twice it, the forward loss on the (2, 4)
    mesh: the expert weights stay split over "data", the tokens move, so
    the collective bytes do not grow with d_ff (within 1 %), as the
    reference's do not (a gather of the experts' f grows by 8.46e9 bytes
    a layer from d_ff to 2 * d_ff: 1.85x over the run)."""
    one, two = (smoke_rows[f"kimi-k2-1t-a32b/{w}"]["collective_bytes"]
                for w in (1, 2))
    assert one > 0
    assert abs(two / one - 1) <= 0.01, (one, two)


def test_moe_token_gather_moves_less_than_the_reference(smoke_rows,
                                                        ref_moe):
    """kimi-k2 at 2 layers, the forward loss on the (2, 4) mesh with 32k
    tokens ([8, 4096]), where the tokens outweigh the expert weights: the
    port gathers every rank's tokens to the ranks of each slice of f
    (`moe._sharded_experts`), and moves at most the reference's collective
    bytes a device (which all-gathers and all-reduces an f32 dispatch
    buffer), with flops within FLOP_TOL of its HLO count."""
    got = smoke_rows["kimi-k2-1t-a32b/32k"]
    ref = ref_moe["kimi-k2-1t-a32b/32k"]
    assert ref["flops"] > 1e12 and got["collective_bytes"] > 0, (got, ref)
    assert got["collective_bytes"] <= ref["collective_bytes"], (got, ref)
    assert abs(got["flops"] / ref["flops"] - 1) <= FLOP_TOL, (got, ref)


# qwen2-0.5b's 2-layer train_4k row of `smoke_rows` (forward, backward,
# AdamW, batch [8, 256] on the (2, 4) mesh) while the loss gathered every
# chunk's logits whole: its collective bytes a device, and those of the
# logits' collectives in it, each chunk's whole-batch f32 [8, 256, V]
# all-gathered over "model" and all-reduced over "data" in the forward
# and again in the checkpoint's recompute, and their backward's
# reduce-scatter [4, 256, V / 4] (an op trace tagged by output shape).
TRAIN_ROW_GATHERED = 7.417530768e9
TRAIN_ROW_LOGITS_PAIR = 4 * 1.244659712e9 + 1.55582464e8


def test_loss_head_moves_less_than_the_reference(smoke_rows, ref_smoke,
                                                 ref_moe):
    """The forward loss on the (2, 4) mesh: the head is gathered over
    "data" once and each rank keeps its rows and its slice of V, whose
    log-sum-exps are merged, so qwen2-0.5b (4 layers) counts at most the
    reference's collective bytes a device and llama4-scout (2 layers)
    at most 1.25x its (the head's gather, 5.2e8 bytes, is most of it at
    2,048 tokens). Gathering each chunk's whole-batch f32 logits counted
    2.584e9 and 3.578e9 (4.7x and 5.0x the reference's)."""
    got, ref = smoke_rows["qwen2-0.5b"], ref_smoke
    assert 0 < got["collective_bytes"] <= ref["collective_bytes"], (got, ref)
    got = smoke_rows["llama4-scout-17b-a16e/1"]
    ref = ref_moe["llama4-scout-17b-a16e"]
    assert 0 < got["collective_bytes"] <= 1.25 * ref["collective_bytes"], (
        got, ref)


def test_loss_head_bytes_do_not_grow_with_tokens(smoke_rows):
    """qwen2-0.5b's forward loss at tokens [8, 512] moves less than 1 %
    of one chunk's whole f32 logits (8 x 256 x V x 4 bytes) more than at
    [8, 256]: the head is gathered once a call, and the chunks reduce
    only [B_local, c] maxima, sums and gold logits (the parent moved two
    chunks' worth of logits more, 2.49e9 bytes)."""
    V = get_config("qwen2-0.5b").vocab_size
    more = (smoke_rows["qwen2-0.5b/512"]["collective_bytes"]
            - smoke_rows["qwen2-0.5b"]["collective_bytes"])
    assert more < 0.01 * 8 * 256 * V * 4, more


def test_train_row_sheds_the_logits_pair(smoke_rows):
    """qwen2-0.5b's 2-layer train step row (forward, backward, AdamW)
    counts at least the logits' collectives (`TRAIN_ROW_LOGITS_PAIR`)
    fewer bytes than while the loss gathered them
    (`TRAIN_ROW_GATHERED`)."""
    got = smoke_rows["qwen2-0.5b/train"]["collective_bytes_per_device"]
    assert 0 < got <= TRAIN_ROW_GATHERED - TRAIN_ROW_LOGITS_PAIR, got


# The same row while every rank looked up the whole batch: its collective
# bytes and flops a device, and the embedding gradient's all-reduce of the
# whole [V, d] f32 table in it (then reduce-scattered onto its split).
TRAIN_ROW_WHOLE_TABLE = 1.971492236e9
TRAIN_ROW_FLOPS = 3.45392545792e11
EMBED_GRAD_ALL_REDUCE = 151936 * 896 * 4 * 2


def test_train_row_moves_less_than_the_reference(smoke_rows, ref_train):
    """qwen2-0.5b's 2-layer train step row on the (2, 4) mesh: each rank
    looks up its rows on its slice of the table, so the table's gradient
    is never all-reduced whole: the row counts at most the reference's
    collective bytes a device (`_REF_TRAIN`, the HLO of its train step),
    at least the whole table's all-reduce fewer than when every rank
    looked up the whole batch (`TRAIN_ROW_WHOLE_TABLE`), and no more
    flops than then."""
    got = smoke_rows["qwen2-0.5b/train"]
    bytes_, flops = (got["collective_bytes_per_device"],
                     got["hlo_flops_per_device"])
    assert ref_train["collective_bytes"] > 0 and ref_train["flops"] > 1e9
    assert 0 < bytes_ <= ref_train["collective_bytes"], (got, ref_train)
    assert bytes_ <= TRAIN_ROW_WHOLE_TABLE - EMBED_GRAD_ALL_REDUCE, bytes_
    assert 0 < flops <= TRAIN_ROW_FLOPS, flops


def test_embedding_collectives_never_hold_the_table():
    """The embedding's forward and backward alone
    (`layers.vocab_parallel_embed` on meta DTensors, the table as the rules
    place it, the gradient of every output, then placed as the table, as
    the optimizer reads it) on the (2, 4) mesh. A table
    split on V (qwen2-0.5b, with tokens [8, 256], where the looked-up rows
    move, and [8, 16384], where the table is gathered over "data";
    musicgen's 4 codebook tables): no collective outputs more than
    V / model rows of the table or the rank's own looked-up rows
    [B_local, T, d] (each codebook's), and none the whole table, as the
    parent's gradient all-reduce did. A V that does not divide "model"
    (internvl2-26b's 92,553 words; the table split on d there, whole over
    "data"): one collective outputs the whole vocabulary, the gradient's
    sum over "data" of each rank's d slice, as the reference's program
    sums it."""
    got = _last_json(_run("""
        import dataclasses, json, torch
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves
        from repro_torch.analysis.op_stats import (_SKIP_BYTES_OPS,
                                                   COLLECTIVE_NS)
        from repro_torch.configs import get_config
        from repro_torch.launch import dryrun
        from repro_torch.launch.specs import params_specs
        from repro_torch.models import layers
        from repro_torch.parallel import sharding as shd

        class Sizes(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.numel = []

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                got = func(*args, **(kwargs or {}))
                if (func.namespace in COLLECTIVE_NS and func.__name__
                        .split(".")[0] not in _SKIP_BYTES_OPS):
                    self.numel += [t.numel() for t in tree_leaves(got)
                                   if isinstance(t, torch.Tensor)]
                return got
        dryrun.init_fake_world(8)
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        out = {}
        for arch, T in (("qwen2-0.5b", 256), ("qwen2-0.5b", 16384),
                        ("musicgen-medium", 256), ("internvl2-26b", 256)):
            cfg = dataclasses.replace(get_config(arch), n_layers=1)
            table = shd.distribute_params(params_specs(cfg), mesh)["embed"]
            table = table.detach().requires_grad_(True)
            nq = (cfg.n_codebooks,) if cfg.n_codebooks else ()
            t = torch.empty(8, T, *nq, dtype=torch.int64, device="meta")
            sizes = Sizes()
            with sizes:
                x = layers.vocab_parallel_embed(table, t)
                x.backward(torch.ones_like(x))
                grad = table.grad.redistribute(mesh, table.placements)
            out[f"{arch}/{T}"] = dict(
                grad=[str(p) for p in table.grad.placements],
                numel=sizes.numel, moves=layers._table_moves(table, 8, T),
                placements=[str(p) for p in x.placements],
                slice=max(1, cfg.n_codebooks) * cfg.vocab_size // 4
                * cfg.d_model, rows=max(1, cfg.n_codebooks) * 4 * T
                * cfg.d_model, whole=table.numel(),
                vocab=cfg.vocab_size * cfg.d_model // 4)
        print(json.dumps(out))
    """))
    assert not got["qwen2-0.5b/256"]["moves"]
    assert got["qwen2-0.5b/16384"]["moves"]
    for key in ("qwen2-0.5b/256", "qwen2-0.5b/16384", "musicgen-medium/256"):
        r = got[key]
        assert r["numel"], (key, r)
        assert max(r["numel"]) <= max(r["slice"], r["rows"]), (key, r)
        assert max(r["numel"]) < r["whole"], (key, r)
        assert r["placements"] == ["S(0)", "R"], (key, r)
    r = got["internvl2-26b/256"]
    assert [n for n in r["numel"] if n >= r["vocab"]] == [r["vocab"]], r


def test_loss_collectives_never_hold_a_chunks_logits():
    """The loss head's forward and backward alone (`chunked_ce_loss` on
    meta DTensors, activations [8, 256, d] in the batch layout, the head
    as the rules place it) on the (2, 4) mesh, for qwen2-0.5b (V split
    over "model"), internvl2-26b (V 92,553 does not divide 4: the head is
    split on d, the row-parallel fallback) and musicgen's first codebook
    head: no collective outputs as many elements as one chunk's whole
    logits, B x c x V (the parent's all-gather and all-reduce)."""
    got = _last_json(_run("""
        import dataclasses, json, torch
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves
        from repro_torch.analysis.op_stats import COLLECTIVE_NS
        from repro_torch.configs import get_config
        from repro_torch.launch import dryrun
        from repro_torch.launch.specs import params_specs
        from repro_torch.models import decoder, layers
        from repro_torch.parallel import sharding as shd

        class Sizes(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.numel = []

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                got = func(*args, **(kwargs or {}))
                if func.namespace in COLLECTIVE_NS:
                    self.numel += [t.numel() for t in tree_leaves(got)
                                   if isinstance(t, torch.Tensor)]
                return got
        dryrun.init_fake_world(8)
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        out = {}
        for arch in ("qwen2-0.5b", "internvl2-26b", "musicgen-medium"):
            cfg = dataclasses.replace(get_config(arch), n_layers=1)
            p = shd.distribute_params(params_specs(cfg), mesh)
            head = p["head"][0] if cfg.n_codebooks else p["head"]
            head = head.detach().requires_grad_(True)
            x = torch.empty(8, 256, cfg.d_model, dtype=cfg.torch_dtype,
                            device="meta", requires_grad=True)
            t = torch.empty(8, 256, dtype=torch.int64, device="meta")
            sizes = Sizes()
            with sizes:
                xs = decoder._batch_layout(layers.replicated_like(x, head))
                layers.chunked_ce_loss(head, xs, t, cfg.loss_chunk).backward()
            out[arch] = dict(numel=sizes.numel, chunk=8 * min(
                256, cfg.loss_chunk) * cfg.vocab_size)
        print(json.dumps(out))
    """))
    for arch, r in got.items():
        assert r["numel"] and max(r["numel"]) < r["chunk"], (arch, r)


def test_dryrun_donation_keeps_one_copy_of_the_state():
    """qwen2-0.5b's smoke config, a train row on a (2, 4) mesh of 8 fake
    ranks, with and without the reference's buffer donation: donated, the
    step writes the weights and moments into its arguments; not donated,
    it copies them first, so its `temp_bytes` is larger by at least one
    rank's weights + mu + nu. The flops are the same."""
    got = _last_json(_run("""
        import json
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.analysis.op_stats import tree_bytes
        from repro_torch.configs import get_config
        from repro_torch.launch import dryrun
        from repro_torch.launch.specs import ShapeCase, params_specs
        from repro_torch.parallel import sharding as shd
        from repro_torch.training.optimizer import init_state
        dryrun.init_fake_world(8)
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        cfg = get_config("qwen2-0.5b").smoke()
        case = ShapeCase("train_4k", 64, 8, "train")
        out = {str(d): dryrun.row("qwen2-0.5b", case.name, False, cfg, case,
                                  mesh, donate=d) for d in (True, False)}
        p = shd.distribute_params(params_specs(cfg), mesh)
        st = init_state(p)
        out["state"] = tree_bytes((p, st["mu"], st["nu"]))
        print(json.dumps(out))
    """))
    on, off = got["True"], got["False"]
    assert on["status"] == off["status"] == "ok"
    assert got["state"] > 0
    assert on["hlo_flops_per_device"] == off["hlo_flops_per_device"] > 0
    assert (off["memory"]["temp_bytes"] - on["memory"]["temp_bytes"]
            >= got["state"]), (on["memory"], off["memory"], got["state"])


def test_split_layer_stack_is_gathered_once_per_step():
    """llama4-scout's smoke config at 4 and 8 layers on a (2, 4) mesh of
    8 fake ranks: the rules split its shared expert's layer dim over
    "model" (4 divides both depths). Prefill and decode gather that stack
    once per step, so twice the layers gather at most twice the bytes
    (gathered once per layer, it would be four times the stack's bytes).
    The dispatch buffers are each rank's own experts' either way, so
    `moe_expert_shard_constraint` leaves the row unchanged."""
    got = _last_json(_run("""
        import dataclasses, json
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import get_config
        from repro_torch.launch import dryrun
        from repro_torch.launch.specs import ShapeCase
        dryrun.init_fake_world(8)
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        arch = "llama4-scout-17b-a16e"
        base = get_config(arch).smoke()
        out = {}
        for n in (4, 8):
            cfg = dataclasses.replace(base, n_layers=n)
            for kind in ("prefill", "decode"):
                case = ShapeCase(kind + "_32k", 64, 8, kind)
                for flag in (False, True):
                    c = dataclasses.replace(
                        cfg, moe_expert_shard_constraint=flag)
                    r = dryrun.row(arch, case.name, False, c, case, mesh)
                    out[f"{kind}{n}{flag}"] = [
                        r["collectives"]["all-gather"],
                        r["hlo_bytes_per_device"],
                        r["collective_bytes_per_device"]]
        print(json.dumps(out))
    """))
    for kind in ("prefill", "decode"):
        assert got[f"{kind}8False"][0] <= 2 * got[f"{kind}4False"][0], got
        for n in (4, 8):
            assert got[f"{kind}{n}True"] == got[f"{kind}{n}False"], got


# decode_32k at 2 layers on the single-pod production mesh (16x16): the
# port's dry-run row on 256 fake ranks, the reference's HLO count on 256
# host devices (its `run_one` decode branch at the cut depth).
SLOT_DECODE_ARCHS = ("kimi-k2-1t-a32b", "qwen2-72b")

_PORT_DECODE = """
    import dataclasses, json
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import shape_case
    dryrun.init_fake_world(256)
    mesh = make_production_mesh(device="cpu")
    case = shape_case("decode_32k")
    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_config(arch), n_layers=2)
        r = dryrun.row(arch, case.name, False, cfg, case, mesh)
        out[arch] = dict(flops=r["hlo_flops_per_device"],
                         collective_bytes=r["collective_bytes_per_device"])
    print(json.dumps(out))
"""

_REF_DECODE = """
    import dataclasses, json
    import jax
    from repro.analysis.hlo_stats import analyze
    from repro.configs import get_config
    from repro.launch.mesh import make_production_mesh
    from repro.launch.specs import input_specs, params_specs, shape_case
    from repro.models import decoder
    from repro.parallel import sharding as shd
    mesh = make_production_mesh()
    case = shape_case("decode_32k")
    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_config(arch), n_layers=2)
        p_shapes = params_specs(cfg)
        p_shard = shd.to_shardings(shd.param_specs(p_shapes, mesh), mesh)
        inputs = input_specs(cfg, case)
        cache_shard = shd.to_shardings(
            shd.cache_specs(inputs["cache"], mesh), mesh)
        tok_shard = jax.sharding.NamedSharding(
            mesh, shd.batch_spec(mesh, inputs["tokens"].shape))
        with mesh:
            f = jax.jit(lambda p, c, t, pos, cfg=cfg: decoder.decode_step(
                p, cfg, c, t, pos),
                in_shardings=(p_shard, cache_shard, tok_shard, None),
                out_shardings=(None, cache_shard), donate_argnums=(1,))
            compiled = f.lower(p_shapes, inputs["cache"], inputs["tokens"],
                               inputs["pos"]).compile()
        s = analyze(compiled.as_text())
        out[arch] = dict(flops=s.flops, collective_bytes=s.collective_bytes)
    print(json.dumps(out))
"""


def test_slot_split_decode_matches_reference():
    """kimi-k2 (64 heads, 8 KV) and qwen2-72b (64, 8) decode_32k at 2
    layers on the 16x16 mesh: 8 KV heads do not divide the 16 "model"
    ranks, so both rule sets split the attention cache on its slots. Each
    rank attends over its own slots and the parts are merged by their
    log-sum-exps, as GSPMD runs the reference's attention there: the
    port's flops are within 1 % of the reference's HLO count and its
    collective bytes at most the reference's. Gathering the cache to every
    "model" rank, each rank attending over all of it, counts 2.50x and
    4.95x the reference's flops, and at kimi-k2 1.36x its collective
    bytes."""
    pytest.importorskip("jax")
    archs = repr(SLOT_DECODE_ARCHS)
    got = _last_json(_run(_PORT_DECODE.replace("ARCHS", archs)))
    ref = _last_json(_run_ref(_REF_DECODE.replace("ARCHS", archs), 256))
    for arch in SLOT_DECODE_ARCHS:
        g, r = got[arch], ref[arch]
        assert r["flops"] > 1e9 and g["collective_bytes"] > 0, (arch, g, r)
        assert abs(g["flops"] / r["flops"] - 1) <= 0.01, (arch, g, r)
        assert g["collective_bytes"] <= r["collective_bytes"], (arch, g, r)


@pytest.fixture(scope="module")
def decode_row(tmp_path_factory):
    """`python -m repro_torch.launch.dryrun` for qwen2-0.5b decode_32k on
    the single-pod mesh of 256 fake ranks, into a --json file, twice
    (the second run replaces the first row)."""
    path = tmp_path_factory.mktemp("dryrun") / "rows.json"
    for _ in range(2):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "qwen2-0.5b", "--shape", "decode_32k", "--json", str(path)],
            capture_output=True, text=True, timeout=600,
            env=_env(ONE_THREAD))
        assert proc.returncode == 0, proc.stderr[-3000:]
    return path


def test_dryrun_cli_row_feeds_roofline_and_calibration(decode_row):
    """The CLI's row has the reference's schema; the roofline analyses it
    with the H100 constants, and `calibrate_from_dryrun` re-fits the
    planner from it as the reference's does."""
    pytest.importorskip("jax")
    from repro.core import bridge as ref_bridge
    from repro.core import default_instance as ref_default_instance

    from repro_torch.core import bridge, default_instance
    rows = json.loads(decode_row.read_text())
    assert len(rows) == 1
    r = rows[0]
    for key in ("arch", "shape", "multi_pod", "status", "n_devices", "kind",
                "hlo_flops_per_device", "hlo_bytes_per_device",
                "hlo_bytes_upper", "hlo_bytes_lower",
                "collective_bytes_per_device", "collectives",
                "n_collectives", "raw_cost_analysis_flops", "memory",
                "params_total", "params_active", "lower_s", "compile_s",
                "opts"):
        assert key in r, key
    assert (r["status"], r["n_devices"], r["kind"]) == ("ok", 256, "decode")
    assert r["hlo_flops_per_device"] > 0 and r["hlo_bytes_per_device"] > 0
    assert r["collective_bytes_per_device"] > 0
    assert set(r["collectives"]) <= {"all-gather", "all-reduce",
                                     "reduce-scatter", "all-to-all",
                                     "collective-permute"}
    a = roofline.analyze_row(r)
    assert a["mesh"] == "16x16" and a["dominant"] in roofline._ADVICE
    assert a["compute_s"] == r["hlo_flops_per_device"] / 989e12
    assert "| qwen2-0.5b | decode_32k | 16x16 |" in roofline.markdown_table(
        [a])
    arch_to_model = {"qwen2-0.5b": 0}
    got = bridge.calibrate_from_dryrun(default_instance(), str(decode_row),
                                       arch_to_model)
    want = ref_bridge.calibrate_from_dryrun(ref_default_instance(),
                                            str(decode_row), arch_to_model)
    np.testing.assert_array_equal(got.B, want.B)
    assert got.B[0] != default_instance().B[0]


def test_roofline_is_the_reference_with_h100_constants():
    """The port's `analyze_row` is the reference's with the H100
    data-sheet constants in place of the TPU v5e ones."""
    pytest.importorskip("jax")
    from repro.analysis import roofline as ref_roofline
    from repro.launch import mesh as ref_mesh
    row = dict(status="ok", arch="qwen2-72b", shape="train_4k",
               multi_pod=True, n_devices=512, kind="train",
               hlo_flops_per_device=3.0e15, hlo_bytes_per_device=2.0e12,
               collective_bytes_per_device=5.0e11, params_active=7.27e10,
               collectives={"all-reduce": 5.0e11})
    got, want = roofline.analyze_row(row), ref_roofline.analyze_row(row)
    for key, const in (("compute_s", "PEAK_FLOPS_BF16"),
                       ("memory_s", "HBM_BW"), ("collective_s", "ICI_BW")):
        ratio = getattr(ref_mesh, const) / getattr(port_mesh, const)
        assert got[key] == pytest.approx(want[key] * ratio, rel=1e-12)
    for key in ("arch", "shape", "mesh", "model_flops", "hlo_flops_total",
                "useful_ratio"):
        assert got[key] == want[key]
    assert roofline.analyze_row(dict(row, status="failed")) is None


def test_dryrun_results_artifact_sane():
    """The twin of the reference's: the committed sweep artifact covers
    every (arch, shape) pair on both meshes with ok/skipped status."""
    if not os.path.exists(ARTIFACT):
        pytest.skip("sweep not yet run")
    with open(ARTIFACT) as f:
        rows = json.load(f)
    seen = {(r["arch"], r["shape"], r["multi_pod"]): r["status"]
            for r in rows}
    missing = [(a, s, mp) for a in ARCH_IDS for s in specs.SHAPES
               for mp in (False, True) if (a, s, mp) not in seen]
    if missing:
        pytest.skip(f"sweep incomplete: {len(missing)} combos outstanding")
    assert all(v in ("ok", "skipped") for v in seen.values()), seen


def test_sweep_skips_done_combos_and_records_failures(tmp_path, capsys,
                                                      monkeypatch):
    """`launch.sweep` runs `python -m repro_torch.launch.dryrun` per combo
    into the given artifact; combos already ok there are skipped, and a
    failure is recorded in place of an earlier row."""
    path = tmp_path / "rows.json"
    rows = [dict(arch="qwen2-0.5b", shape=s, multi_pod=False, status="ok")
            for s in specs.SHAPES if s != "long_500k"]
    path.write_text(json.dumps(rows))
    cmds = []

    def run(cmd, **kw):
        cmds.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "", "")
    monkeypatch.setattr(sweep.subprocess, "run", run)
    assert sweep.main(["--json", str(path), "--arch", "qwen2-0.5b",
                       "--single-pod-only"]) == 0
    assert capsys.readouterr().out.count("skip (done)") == len(rows)
    assert cmds == [[sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", "qwen2-0.5b", "--shape", "long_500k",
                     "--json", str(path)]]
    sweep._record_failure(str(path), "qwen2-0.5b", "train_4k", False, "x")
    got = {(r["shape"], r["status"]) for r in json.loads(path.read_text())}
    assert ("train_4k", "failed") in got and ("train_4k", "ok") not in got


# ---------------------------------------------------------------------------
# Meshes and constants
# ---------------------------------------------------------------------------

def test_production_mesh_on_a_fake_group():
    """(16, 16) over 256 fake ranks, (2, 16, 16) over 512, on the CPU;
    any other world size still raises."""
    got = _last_json(_run("""
        import json
        import torch.distributed as dist
        from repro_torch.launch.dryrun import init_fake_world
        from repro_torch.launch.mesh import make_production_mesh
        out = {}
        for n, multi in ((256, False), (512, True), (8, False), (256, True)):
            init_fake_world(n)
            try:
                m = make_production_mesh(multi_pod=multi, device="cpu")
                out[f"{n}/{multi}"] = [list(m.shape), list(m.mesh_dim_names),
                                       m.device_type]
            except ValueError as e:
                out[f"{n}/{multi}"] = str(e)
            dist.destroy_process_group()
        print(json.dumps(out))
    """))
    assert got["256/False"] == [[16, 16], ["data", "model"], "cpu"]
    assert got["512/True"] == [[2, 16, 16], ["pod", "data", "model"], "cpu"]
    assert "256 ranks, got 8" in got["8/False"]
    assert "512 ranks, got 256" in got["256/True"]


def test_hardware_constants_are_h100_data_sheet():
    """The reference's three names, with H100 SXM5 data-sheet figures:
    dense bf16 tensor-core rate, HBM3 bandwidth, NVLink 4 per GPU."""
    assert port_mesh.PEAK_FLOPS_BF16 == 989e12
    assert port_mesh.HBM_BW == 3.35e12
    assert port_mesh.ICI_BW == 900e9


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def _leaf_meta(tree) -> dict:
    out = {}
    map_with_path(lambda p, t: out.__setitem__(
        p, (tuple(t.shape), t.dtype, t.stride())), tree)
    return out


@pytest.mark.parametrize("arch,w8a8", [(a, False) for a in ARCH_IDS] + [
    (a, True) for a in ARCH_IDS if get_config(a).n_experts])
def test_params_specs_match_init_params(arch, w8a8):
    """`params_specs` builds `init_params`'s tree on the meta device: the
    same leaves, shapes, dtypes and strides (the W8A8 experts K-major)."""
    cfg = dataclasses.replace(get_config(arch).smoke(), moe_w8a8=w8a8)
    got = specs.params_specs(cfg)
    assert all(t.is_meta for t in _leaf_meta_tensors(got))
    assert _leaf_meta(got) == _leaf_meta(
        decoder.init_params(torch.Generator().manual_seed(0), cfg))


def _leaf_meta_tensors(tree) -> list:
    out = []
    map_with_path(lambda p, t: out.append(t), tree)
    return out


@pytest.mark.parametrize("shape", list(specs.SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_reference(arch, shape):
    """`SHAPES`, `shape_case` and `applicable` are the reference's; the
    input stand-ins have its shapes and dtypes (the decode cache its
    tree), `pos` the cache's last position."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as ref_get_config
    from repro.launch import specs as ref_specs
    assert specs.SHAPES == ref_specs.SHAPES
    case, ref_case = specs.shape_case(shape), ref_specs.shape_case(shape)
    assert dataclasses.asdict(case) == dataclasses.asdict(ref_case)
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert specs.applicable(cfg, case) == ref_specs.applicable(ref_cfg,
                                                                ref_case)
    got, want = specs.input_specs(cfg, case), ref_specs.input_specs(
        ref_cfg, ref_case)
    assert got.keys() == want.keys()
    for key in got:
        if key == "pos":
            assert got[key] == case.seq_len - 1
            continue
        w_flat = jax.tree_util.tree_flatten_with_path(want[key])[0]
        g_flat = {p: t for p, t in _leaf_meta_items(got[key])}
        assert len(g_flat) == len(w_flat)
        for path, w in w_flat:
            p = tuple(str(getattr(k, "key", getattr(k, "idx", "?")))
                      for k in path)
            g = g_flat[p]
            assert g.is_meta and tuple(g.shape) == w.shape, (key, p)
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype)


def _leaf_meta_items(tree):
    out = []
    map_with_path(lambda p, t: out.append((p, t)), tree)
    return out
