"""The port's distribution layer against the JAX package's: the sharding
rules (`parallel/sharding.py`) give the reference's specs leaf for leaf
for all ten configs at full width on five meshes, the unchunked attention
of the seq-sharded variant is the reference's, and on gloo process groups
on the CPU the sharded decoder and the GPipe schedule give the reference's
numbers.

The gloo runs are `torch.multiprocessing.spawn` workers that never import
jax: the reference's weights and inputs reach them in an `np.savez` file,
and they write their results to another. Each run has 120 s.
Tolerances, f32 atol = rtol = 1e-5: the sharded logits (to ~3.4) and
loss against the reference's, though the sharded run sums its
row-parallel products per shard, then across the ranks (the largest
difference seen was 3.8e-6); the sharded gradients against the unsharded
port's; the pipeline 1e-5, as tests/test_distribution.py.
"""
import dataclasses
import functools
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import _ref_cpu  # noqa: F401  (pins the reference to the CPU)

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import decoder, layers
from repro_torch.parallel import pipeline, sharding

torch.set_num_threads(1)

# (shape, axis names): the dry-run's meshes and three small ones.
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
SPAWN_TIMEOUT = 120.0


class StubMesh:
    """What the rules read of a mesh: its axis names and sizes."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


def _stub(name) -> StubMesh:
    return StubMesh(*MESHES[name])


def _ref():
    jax = pytest.importorskip("jax")
    from repro.parallel import sharding as ref_sharding
    return jax, ref_sharding


def _flat_ref_specs(tree) -> dict:
    """path -> spec entries of a reference PartitionSpec tree."""
    jax, _ = _ref()
    from jax.sharding import PartitionSpec as P
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {tuple(str(getattr(k, "key", getattr(k, "idx", "?")))
                  for k in path): tuple(spec) for path, spec in flat}


def _flat(tree) -> dict:
    """path -> leaf of a port tree (specs, or tensors)."""
    out = {}
    sharding.map_with_path(lambda path, leaf: out.__setitem__(path, leaf),
                           tree)
    return out


def _flat_specs(tree) -> dict:
    out = {}

    def walk(node, path):
        if isinstance(node, sharding.Spec):
            out[path] = tuple(node)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
    walk(tree, ())
    return out


@functools.lru_cache(maxsize=None)
def _ref_param_shapes(arch):
    from repro.configs import get_config as ref_get_config
    from repro.launch.specs import params_specs
    return params_specs(ref_get_config(arch))


@functools.lru_cache(maxsize=None)
def _ref_cache_shapes(arch):
    jax, _ = _ref()
    from repro.configs import get_config as ref_get_config
    from repro.launch.specs import input_specs, shape_case
    return input_specs(ref_get_config(arch), shape_case("decode_32k"))["cache"]


# ---------------------------------------------------------------------------
# The sharding rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, mesh):
    _, ref_sharding = _ref()
    shapes = _ref_param_shapes(arch)
    want = _flat_ref_specs(ref_sharding.param_specs(shapes, _stub(mesh)))
    got = _flat_specs(sharding.param_specs(shapes, _stub(mesh)))
    assert got == want
    for path, spec in got.items():     # and every sharded dim divides
        leaf = _flat(shapes)[path]
        assert len(spec) == len(leaf.shape)
        for dim, axes in zip(leaf.shape, spec):
            assert dim % sharding.mesh_axis_size(_stub(mesh), axes) == 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_port_param_tree_has_reference_paths(arch):
    """The port's own parameter tree (smoke size) walks to the reference's
    key paths and shapes, so its specs are the reference's."""
    jax, ref_sharding = _ref()
    from repro.configs import get_config as ref_get_config
    from repro.models import decoder as ref_decoder
    ref_shapes = jax.eval_shape(lambda: ref_decoder.init_params(
        jax.random.PRNGKey(0), ref_get_config(arch).smoke()))
    params = decoder.init_params(torch.Generator().manual_seed(0),
                                 get_config(arch).smoke())
    got = {p: tuple(t.shape) for p, t in _flat(params).items()}
    assert got == {p: tuple(t.shape) for p, t in _flat(ref_shapes).items()}
    assert (_flat_specs(sharding.param_specs(params, _stub("2x4")))
            == _flat_ref_specs(ref_sharding.param_specs(ref_shapes,
                                                        _stub("2x4"))))


@pytest.mark.parametrize("prefer_hd", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(arch, mesh, prefer_hd):
    """Every config's decode cache at B 128 and 32,768 positions: the
    port's tree (built on the meta device) has the reference's paths and
    shapes, and the rules give the reference's specs."""
    _, ref_sharding = _ref()
    ref_cache = _ref_cache_shapes(arch)
    cache = decoder.init_cache(get_config(arch), 128, 32_768, "meta")
    assert ({p: tuple(t.shape) for p, t in _flat(cache).items()}
            == {p: tuple(t.shape) for p, t in _flat(ref_cache).items()})
    want = _flat_ref_specs(ref_sharding.cache_specs(ref_cache, _stub(mesh),
                                                    prefer_hd=prefer_hd))
    assert _flat_specs(sharding.cache_specs(cache, _stub(mesh),
                                            prefer_hd=prefer_hd)) == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_hd_split_cache_slices_fit_the_kernel_pair(arch, mesh):
    """Every config's decode cache at B 128 and 32,768 positions under
    `prefer_hd`: where the rules split an attention cache on head_dim,
    the slice a "model" rank holds has lanes the hd-split pair takes
    (`kernels.decode_attention_hd.kernel.LANES`), a group it takes, and a
    [B,KV,S,hl] view of its contiguous [B,S,KV,hl] shard that it can
    read in bf16 and f32. On 16x16 the split caches are the ones listed
    (4 lanes where head_dim is 64: qwen2-0.5b, musicgen-medium)."""
    from repro_torch.kernels._layout import aligned16
    from repro_torch.kernels.decode_attention_hd import kernel as hk
    cfg = get_config(arch)
    stub = _stub(mesh)
    n_model = stub.shape["model"]
    cache = decoder.init_cache(cfg, 128, 32_768, "meta")
    specs = _flat_specs(sharding.cache_specs(cache, stub, prefer_hd=True))
    lanes = set()
    for path, leaf in _flat(cache).items():
        # the attention caches: k and v, [L, B, S, KV, hd]
        if path[-1] not in ("0", "1") or specs[path][4] != "model":
            continue
        L, Bc, S, KV, hd = leaf.shape
        hl = hd // n_model
        lanes.add(hl)
        assert hl in hk.LANES, (path, hl)
        assert 0 < cfg.n_heads // KV <= hk.MAX_GROUP, path
        b_local = Bc // sharding.mesh_axis_size(stub, specs[path][1])
        view = ((b_local, KV, S, hl), (S * KV * hl, hl, KV * hl, 1))
        for dtype in (torch.bfloat16, torch.float32):
            assert aligned16(*view, dtype.itemsize, 0,
                             hk._align(hl, dtype)), (path, dtype)
    if mesh == "16x16":
        want = {"qwen2-0.5b": {4}, "musicgen-medium": {4}, "qwen2-1.5b": {8},
                "qwen2-72b": {8}, "kimi-k2-1t-a32b": {8},
                "llama4-scout-17b-a16e": {8}, "internvl2-26b": {8}}
        assert lanes == want.get(arch, set())


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec_equals_reference(mesh):
    _, ref_sharding = _ref()
    for shape in [(256, 4096), (32, 32_768), (128, 1), (1, 524_288),
                  (8, 256), (2, 16, 4), (3, 7), (16, 5), (64,)]:
        assert (tuple(sharding.batch_spec(_stub(mesh), shape))
                == tuple(ref_sharding.batch_spec(_stub(mesh), shape))), shape


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_state_specs_equal_reference(arch):
    _, ref_sharding = _ref()
    shapes = _ref_param_shapes(arch)
    mesh = _stub("2x16x16")
    want = ref_sharding.opt_state_specs(ref_sharding.param_specs(shapes,
                                                                  mesh))
    got = sharding.opt_state_specs(sharding.param_specs(shapes, mesh))
    assert got.keys() == want.keys()
    assert tuple(got["step"]) == tuple(want["step"])
    for k in ("mu", "nu"):
        assert _flat_specs(got[k]) == _flat_ref_specs(want[k])


def test_to_placements_orders_mesh_dims():
    from torch.distributed.tensor import Replicate, Shard

    class Names:
        mesh_dim_names = ("pod", "data", "model")

    got = sharding.to_placements(sharding.Spec((None, ("pod", "data"),
                                                "model")), Names())
    assert got == [Shard(1), Shard(1), Shard(2)]
    assert sharding.to_placements(sharding.Spec((None, None)), Names()) == [
        Replicate()] * 3
    assert sharding.to_placements(sharding.Spec(("data",)), Names()) == [
        Replicate(), Shard(0), Replicate()]


def test_mesh_builders_need_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        make_host_mesh(1, device="cpu")


# ---------------------------------------------------------------------------
# The seq-sharded variant's unchunked attention
# ---------------------------------------------------------------------------

def test_seqshard_flag_is_noop_without_a_mesh():
    """tests/test_perf_variants.py:34 on the port: with no mesh the flag's
    unchunked attention gives the chunked path's logits (2e-3), and the
    reference's flag-on logits from the same weights (1e-5)."""
    jax, _ = _ref()
    from repro.configs import get_config as ref_get_config
    from repro.models import decoder as ref_decoder
    from repro_torch.models.weights import params_from_numpy
    ref_cfg = ref_get_config("qwen2-1.5b").smoke()
    cfg = get_config("qwen2-1.5b").smoke()
    cfg_on = dataclasses.replace(cfg, seq_shard_attention=True)
    ref_params = ref_decoder.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 32))
    lg0, _ = decoder.prefill(params, cfg, torch.from_numpy(toks), max_len=40)
    lg1, _ = decoder.prefill(params, cfg_on, torch.from_numpy(toks),
                             max_len=40)
    np.testing.assert_allclose(lg0.numpy(), lg1.numpy(), atol=2e-3,
                               rtol=2e-3)
    want, _ = ref_decoder.prefill(
        ref_params, dataclasses.replace(ref_cfg, seq_shard_attention=True),
        toks, max_len=40)
    np.testing.assert_allclose(lg1.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_unchunked_equals_chunked_attention():
    """tests/test_perf_variants.py:49 on the port (2e-5), with and without
    a window of 100, and against the reference's `attention_unchunked`."""
    jax, _ = _ref()
    from repro.models import layers as ref_layers
    rng = np.random.default_rng(0)
    B, T, H, KV, hd = 2, 384, 4, 2, 64
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    pos = torch.arange(T)
    for window in (0, 100):
        a = layers.attention(tq, tk, tv, pos, pos, window=window,
                             block_q=128, block_k=128)
        b = layers.attention_unchunked(tq, tk, tv, pos, pos, window=window)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)
        want = ref_layers.attention_unchunked(q, k, v, np.arange(T),
                                              np.arange(T), window=window)
        np.testing.assert_allclose(b.numpy(), np.asarray(want), atol=2e-5)


# ---------------------------------------------------------------------------
# Gloo process groups
# ---------------------------------------------------------------------------

def _spawn(fn, nprocs: int, *args) -> None:
    """Run fn(rank, *args) in nprocs spawned processes; fail on an error
    or after SPAWN_TIMEOUT seconds, killing what still runs."""
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                pytest.fail(f"gloo workers still running after "
                            f"{SPAWN_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)


def _init(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)


def _smoke_cfg(kv: int):
    return dataclasses.replace(get_config("qwen2-1.5b").smoke(),
                               n_kv_heads=kv)


def _tree(flat: dict) -> dict:
    """'a/b/c' keys -> the nested dict."""
    out: dict = {}
    for key, a in flat.items():
        node = out
        *head, last = key.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = a
    return out


def _decoder_worker(rank, world, store, model, kv, inp, out):
    _init(rank, world, store)
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels._layout import check_aligned
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.parallel.sharding import distribute_params

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach()

    res = {}
    with np.load(inp) as f:
        data = dict(f)
    cfg = _smoke_cfg(kv)
    weights = _tree({k[2:]: v for k, v in data.items() if k.startswith("p/")})
    params = params_from_numpy(weights, cfg, "cpu")
    mesh = make_host_mesh(model, device="cpu")
    sp = distribute_params(params, mesh)
    toks = torch.from_numpy(data["tokens"])
    T = toks.shape[1]
    for flag in (False, True):
        c = dataclasses.replace(cfg, seq_shard_attention=flag)
        with torch.no_grad():
            lg, cache = decoder.prefill(sp, c, toks, max_len=T + 3)
            steps = [lg]
            for s, nt in enumerate(data["decode_tokens"]):
                lg, cache = decoder.decode_step(sp, c, cache,
                                                torch.from_numpy(nt), T + s)
                steps.append(lg)
        res[f"logits_{int(flag)}"] = torch.stack([whole(x) for x in steps])
    batch = dict(tokens=toks, targets=torch.from_numpy(data["targets"]))
    for name, ps in (("sharded", sp), ("plain", params)):
        leaves = _flat(ps)
        for t in leaves.values():
            t.requires_grad_(True)
        loss = decoder.train_loss(ps, cfg, batch)
        loss.backward()
        res[f"loss_{name}"] = loss.detach()
        for path, t in leaves.items():
            res[f"grad_{name}/" + "/".join(path)] = whole(t.grad)
    # No fallback: CUDA meshes raise here, the production mesh wants 256
    # ranks, and a kernel never reads a DTensor's pointer.
    for name, fn, err in (
            ("cuda_mesh", lambda: make_host_mesh(model), RuntimeError),
            ("production_mesh",
             lambda: make_production_mesh(), ValueError),
            ("kernel", lambda: check_aligned("flash_attention",
                                             q=sp["embed"]), TypeError)):
        try:
            fn()
        except err as e:
            res[f"raised_{name}"] = np.array(str(e))
    if model == 2 and kv == 2:
        # the other mixers run sharded too: the smoke configs' prefill
        # logits equal the unsharded port's
        for arch in ("rwkv6-7b", "zamba2-7b", "kimi-k2-1t-a32b"):
            c = get_config(arch).smoke()
            p = decoder.init_params(torch.Generator().manual_seed(0), c)
            with torch.no_grad():
                res[f"mixer_{arch}"] = torch.stack([whole(
                    decoder.prefill(ps, c, toks[:, :8])[0])
                    for ps in (distribute_params(p, mesh), p)])
    if rank == 0:
        np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
    dist.destroy_process_group()


@pytest.mark.parametrize("model,kv", [(2, 2), (1, 2), (2, 1)],
                         ids=["mesh1x2", "mesh2x1", "mesh1x2-kv1"])
def test_sharded_decoder_equals_reference(tmp_path, model, kv):
    """qwen2-1.5b smoke in f32 on a world of 2 gloo ranks: (data, model)
    (1, 2) shards heads, (2, 1) the batch and FSDP storage; with one KV
    head on (1, 2) the keys and values are split on head_dim and the cache
    on its positions, so the kernels take them replicated. The prefill
    logits and 3 decode steps equal the reference's unsharded ones, with
    `seq_shard_attention` off and on; `train_loss` equals the reference's
    loss, and the sharded gradients the unsharded port's. On (1, 2) the
    rwkv6, zamba2 and kimi-k2 smoke configs' sharded prefill logits equal
    the unsharded port's (`test_torch_parallel_mixers.py` holds those
    families against the reference)."""
    jax, _ = _ref()
    from repro.configs import get_config as ref_get_config
    from repro.models import decoder as ref_decoder
    ref_cfg = dataclasses.replace(ref_get_config("qwen2-1.5b").smoke(),
                                  n_kv_heads=kv)
    params = jax.tree.map(np.asarray, ref_decoder.init_params(
        jax.random.PRNGKey(0), ref_cfg))
    rng = np.random.default_rng(1)
    B, T = 2, 16
    toks = rng.integers(0, ref_cfg.vocab_size, (B, T)).astype(np.int64)
    targets = rng.integers(0, ref_cfg.vocab_size, (B, T)).astype(np.int64)
    dec = rng.integers(0, ref_cfg.vocab_size, (3, B, 1)).astype(np.int64)
    lg, cache = ref_decoder.prefill(params, ref_cfg, toks, max_len=T + 3)
    want = [np.asarray(lg)]
    for s in range(3):
        lg, cache = ref_decoder.decode_step(params, ref_cfg, cache, dec[s],
                                            T + s)
        want.append(np.asarray(lg))
    want_loss = float(ref_decoder.train_loss(
        params, ref_cfg, dict(tokens=toks, targets=targets)))
    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, tokens=toks, targets=targets, decode_tokens=dec,
             **{"p/" + "/".join(p): a for p, a in _flat(params).items()})
    _spawn(_decoder_worker, 2, 2, str(tmp_path / "store"), model, kv,
           str(inp), str(out))
    with np.load(out) as f:
        got = dict(f)
    for flag in (0, 1):
        np.testing.assert_allclose(got[f"logits_{flag}"], np.stack(want),
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got["logits_1"], got["logits_0"], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got["loss_sharded"], want_loss, rtol=1e-5)
    grads = [k for k in got if k.startswith("grad_plain/")]
    assert len(grads) == len(_flat(params))
    for k in grads:
        np.testing.assert_allclose(
            got[k.replace("plain", "sharded", 1)], got[k], atol=1e-5,
            rtol=1e-5, err_msg=k)
    if not torch.cuda.is_available():
        assert "CUDA is not available" in str(got["raised_cuda_mesh"])
    assert "256" in str(got["raised_production_mesh"])
    assert "DTensor" in str(got["raised_kernel"])
    if model == 2 and kv == 2:
        for arch in ("rwkv6-7b", "zamba2-7b", "kimi-k2-1t-a32b"):
            sharded, plain = got[f"mixer_{arch}"]
            np.testing.assert_allclose(sharded, plain, atol=1e-5, rtol=1e-5,
                                       err_msg=arch)


def _slot_decode_worker(rank, world, store, inp, out, prefer_hd=False):
    """Prefill and 3 decode steps of each case of `SLOT_CASES` on a (1, 4)
    mesh, whose "model" axis splits the cache's slots, or with
    `prefer_hd` its head_dim."""
    _init(rank, world, store)
    from torch.distributed.tensor import DTensor

    from repro_torch.analysis.op_stats import OpCounter
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.parallel.sharding import distribute_params

    res = {}
    with np.load(inp) as f:
        data = dict(f)
    mesh = make_host_mesh(4, device="cpu")
    toks = torch.from_numpy(data["tokens"])
    T = toks.shape[1]
    for name, window in SLOT_CASES:
        cfg = dataclasses.replace(_smoke_cfg(2), sliding_window=window)
        weights = _tree({k[2:]: v for k, v in data.items()
                         if k.startswith("p/")})
        sp = distribute_params(params_from_numpy(weights, cfg, "cpu"), mesh)
        gathered, reduced, placements = [], [], []
        dim = 4 if prefer_hd else 2    # of [L, B, S, KV, hd]: hd or slots
        with torch.no_grad():
            lg, cache = decoder.prefill(sp, cfg, toks, max_len=SLOT_MAX_LEN,
                                        prefer_hd=prefer_hd)
            steps = [lg]
            for s, nt in enumerate(data["decode_tokens"]):
                with OpCounter() as c:
                    lg, cache = decoder.decode_step(
                        sp, cfg, cache, torch.from_numpy(nt), T + s)
                gathered.append(c.stats.collectives.get("all-gather", 0.0))
                reduced.append(c.stats.collectives.get("all-reduce", 0.0))
                steps.append(lg)
                placements.append([
                    [p.is_shard(dim) for p in t.placements]
                    for t in cache["layers"] if isinstance(t, DTensor)])
        res[f"logits_{name}"] = torch.stack([x.full_tensor() for x in steps])
        res[f"gathered_{name}"] = torch.tensor(gathered)
        res[f"reduced_{name}"] = torch.tensor(reduced)
        res[f"placements_{name}"] = np.array(placements)
        res[f"slots_{name}"] = torch.tensor(
            cache["layers"][0].to_local().shape[dim])
    if rank == 0:
        np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
    dist.destroy_process_group()


# The slot-split decode: (case, sliding window) of qwen2-1.5b smoke with
# 2 KV heads on (data, model) = (1, 4), a cache of SLOT_MAX_LEN positions.
SLOT_CASES = (("flat", 0), ("ring", 16))
SLOT_MAX_LEN = 32


def _split_decode_reference(tmp_path):
    """The reference's unsharded prefill and 3 decode steps of each case
    of `SLOT_CASES` (qwen2-1.5b smoke, 2 KV heads, f32), and the input
    file of the gloo workers. Returns (want by case, input path, B)."""
    jax, _ = _ref()
    from repro.configs import get_config as ref_get_config
    from repro.models import decoder as ref_decoder
    rng = np.random.default_rng(5)
    B, T = 2, 16
    base = dataclasses.replace(ref_get_config("qwen2-1.5b").smoke(),
                               n_kv_heads=2)
    params = jax.tree.map(np.asarray, ref_decoder.init_params(
        jax.random.PRNGKey(0), base))
    toks = rng.integers(0, base.vocab_size, (B, T)).astype(np.int64)
    dec = rng.integers(0, base.vocab_size, (3, B, 1)).astype(np.int64)
    want = {}
    for name, window in SLOT_CASES:
        ref_cfg = dataclasses.replace(base, sliding_window=window)
        lg, cache = ref_decoder.prefill(params, ref_cfg, toks,
                                        max_len=SLOT_MAX_LEN)
        steps = [np.asarray(lg)]
        for s in range(3):
            lg, cache = ref_decoder.decode_step(params, ref_cfg, cache,
                                                dec[s], T + s)
            steps.append(np.asarray(lg))
        want[name] = np.stack(steps)
    inp = tmp_path / "in.npz"
    np.savez(inp, tokens=toks, decode_tokens=dec,
             **{"p/" + "/".join(p): a for p, a in _flat(params).items()})
    return want, inp, B


def test_slot_split_decode_equals_reference(tmp_path):
    """qwen2-1.5b smoke in f32, 2 KV heads, on 4 gloo ranks as (data,
    model) = (1, 4): the heads do not divide "model", so the rules split
    each cache on its slots, and each rank attends over its own and the
    parts are merged by their log-sum-exps. A flat cache of 32 slots
    after a 16-token prompt (during the 3 decode steps the fourth rank's
    8 slots are all empty, the third's partly), and a ring of
    `sliding_window` 16 slots, 4 a rank, that the decode steps wrap. The
    prefill logits and 3 decode steps equal the reference's unsharded
    ones at 1e-5; after every step both caches are still split on their
    slots over "model", and no step all-gathers as many bytes as one
    layer's whole key cache (the parent gathered both caches of every
    layer at every step)."""
    want, inp, B = _split_decode_reference(tmp_path)
    out = tmp_path / "out.npz"
    _spawn(_slot_decode_worker, 4, 4, str(tmp_path / "store"), str(inp),
           str(out))
    with np.load(out) as f:
        got = dict(f)
    cfg = _smoke_cfg(2)
    for name, window in SLOT_CASES:
        np.testing.assert_allclose(got[f"logits_{name}"], want[name],
                                   atol=1e-5, rtol=1e-5, err_msg=name)
        S = min(SLOT_MAX_LEN, window) if window else SLOT_MAX_LEN
        assert int(got[f"slots_{name}"]) == S // 4, name
        for step in got[f"placements_{name}"]:
            assert len(step) == 2, name                    # k and v
            for pl in step:
                assert list(pl) == [False, True], (name, pl)   # "model"
        layer_k = B * S * cfg.n_kv_heads * cfg.hd * 4
        assert got[f"gathered_{name}"].max() < layer_k, (
            name, got[f"gathered_{name}"], layer_k)


def test_hd_split_decode_equals_reference(tmp_path):
    """The same model, mesh and cases with the cache placed under
    `prefer_hd` (the dry-run's `kvhd`): the 2 KV heads do not divide the
    4 "model" ranks, so the rules split each cache on head_dim, 8 of the
    32 lanes a rank. Each rank scores its own lanes, the partial scores
    are all-reduced, and each rank runs the softmax and P V on its lanes
    (the global head's scale). The prefill logits and 3 decode steps equal
    the reference's unsharded ones at 1e-5, flat and ring; after every
    step both caches are still split on head_dim over "model" (each
    rank's slice written in place); no step all-gathers as many bytes as
    one layer's whole key cache, and each step all-reduces at least the
    partial scores of every layer (B x H x S f32 a layer)."""
    want, inp, B = _split_decode_reference(tmp_path)
    out = tmp_path / "out.npz"
    _spawn(_slot_decode_worker, 4, 4, str(tmp_path / "store"), str(inp),
           str(out), True)
    with np.load(out) as f:
        got = dict(f)
    cfg = _smoke_cfg(2)
    for name, window in SLOT_CASES:
        np.testing.assert_allclose(got[f"logits_{name}"], want[name],
                                   atol=1e-5, rtol=1e-5, err_msg=name)
        S = min(SLOT_MAX_LEN, window) if window else SLOT_MAX_LEN
        assert int(got[f"slots_{name}"]) == cfg.hd // 4, name
        for step in got[f"placements_{name}"]:
            assert len(step) == 2, name                    # k and v
            for pl in step:
                assert list(pl) == [False, True], (name, pl)   # "model"
        layer_k = B * S * cfg.n_kv_heads * cfg.hd * 4
        assert got[f"gathered_{name}"].max() < layer_k, (
            name, got[f"gathered_{name}"], layer_k)
        scores = cfg.n_layers * B * cfg.n_heads * S * 4
        assert got[f"reduced_{name}"].min() >= scores, (
            name, got[f"reduced_{name}"], scores)


# The sharded loss head: (case, arch, vocabulary) of the smoke configs in
# f32 at 2 layers, chunks of LOSS_CHUNK positions, on (data, model) =
# (2, 2) over 4 ranks: V split over "model" (qwen2-0.5b), V that does not
# divide it (internvl2-26b at 509 words, with its prefix: the head is
# split on d, the row-parallel fallback), and 4 codebook heads with a
# prefix (musicgen).
LOSS_CASES = (("vsplit", "qwen2-0.5b", 512), ("rows", "internvl2-26b", 509),
              ("codebooks", "musicgen-medium", 512))
LOSS_B, LOSS_T, LOSS_CHUNK = 4, 16, 4


def _loss_cfg(arch: str, vocab: int, get=get_config):
    return dataclasses.replace(get(arch).smoke(), vocab_size=vocab,
                               loss_chunk=LOSS_CHUNK)


def _loss_batch(data: dict, name: str) -> dict:
    return {k: torch.from_numpy(data[f"{name}/{k}"])
            for k in ("tokens", "targets", "prefix") if f"{name}/{k}" in data}


def _loss_head_worker(rank, world, store, inp, out):
    """Each case of `LOSS_CASES` on a (2, 2) mesh: `train_loss` and every
    gradient, sharded and unsharded; the collectives of the sharded loss's
    forward and backward by output size; the served logits of a prefill
    and a decode step, sharded (whole, and their placements) and
    unsharded."""
    _init(rank, world, store)
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from repro_torch.analysis.op_stats import COLLECTIVE_NS
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.parallel.sharding import distribute_params

    class Sizes(TorchDispatchMode):
        """The element counts of every collective's outputs."""

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

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach()

    res = {}
    with np.load(inp) as f:
        data = dict(f)
    mesh = make_host_mesh(2, device="cpu")
    for name, arch, vocab in LOSS_CASES:
        cfg = _loss_cfg(arch, vocab)
        params = params_from_numpy(_tree({
            k[len(name) + 3:]: v for k, v in data.items()
            if k.startswith(f"{name}/p/")}), cfg, "cpu")
        sp = distribute_params(params, mesh)
        batch = _loss_batch(data, name)
        for label, ps in (("sharded", sp), ("plain", params)):
            leaves = _flat(ps)
            for t in leaves.values():
                t.requires_grad_(True)
            loss = decoder.train_loss(ps, cfg, batch)
            loss.backward()
            res[f"{name}/loss_{label}"] = loss.detach()
            for path, t in leaves.items():
                res[f"{name}/grad_{label}/" + "/".join(path)] = whole(t.grad)
                t.requires_grad_(False)
            with torch.no_grad():
                lg, cache = decoder.prefill(ps, cfg, batch["tokens"],
                                            batch.get("prefix"),
                                            max_len=LOSS_T + 8 + 1)
                P = 0 if "prefix" not in batch else batch["prefix"].shape[1]
                lg2, _ = decoder.decode_step(ps, cfg, cache,
                                             batch["tokens"][:, :1], LOSS_T + P)
            for step, x in (("prefill", lg), ("decode", lg2)):
                res[f"{name}/{step}_{label}"] = whole(x)
                if isinstance(x, DTensor):
                    res[f"{name}/{step}_placements"] = np.array([
                        f"Shard({p.dim})" if p.is_shard() else
                        "Replicate" if p.is_replicate() else "Partial"
                        for p in x.placements])
        # the loss head alone, forward and backward, on activations in
        # the batch layout: the element counts of its collectives
        head, targets = sp["head"].detach(), batch["targets"]
        if cfg.n_codebooks:
            head, targets = head[1], targets[..., 1]
        head.requires_grad_(True)
        x = decoder._batch_layout(layers.replicated_like(
            torch.randn(LOSS_B, LOSS_T, cfg.d_model,
                        generator=torch.Generator().manual_seed(0)
                        ).requires_grad_(True), head))
        sizes = Sizes()
        with sizes:
            layers.chunked_ce_loss(head, x, targets,
                                   cfg.loss_chunk).backward()
        res[f"{name}/collective_numels"] = torch.tensor(sizes.numel)
    if rank == 0:
        np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
    dist.destroy_process_group()


def test_sharded_loss_head_equals_reference(tmp_path):
    """The vocabulary-parallel loss head on 4 gloo ranks as (data, model)
    = (2, 2), f32, every case of `LOSS_CASES`, targets at the first and
    last entry of each "model" rank's vocabulary slice (and of the whole
    vocabulary where it does not divide): `train_loss` equals the
    reference's (1e-5) and every sharded gradient the unsharded port's
    and the reference's (1e-5); no collective of the sharded loss,
    forward or backward, outputs as many elements as one chunk's whole
    logits (B x c x V, the parent's gather); the served logits of a
    prefill and a decode step equal the unsharded port's (1e-5), placed
    as the reference returns them: B over "data", V over "model" where
    it divides, else replicated."""
    jax, _ = _ref()
    import jax.numpy as jnp
    from repro.configs import get_config as ref_get_config
    from repro.models import decoder as ref_decoder
    rng = np.random.default_rng(7)
    arrays, want = {}, {}
    for name, arch, vocab in LOSS_CASES:
        ref_cfg = _loss_cfg(arch, vocab, ref_get_config)
        params = jax.tree.map(np.asarray, ref_decoder.init_params(
            jax.random.PRNGKey(3), ref_cfg))
        nq = (ref_cfg.n_codebooks,) if ref_cfg.n_codebooks else ()
        toks = rng.integers(0, vocab, (LOSS_B, LOSS_T, *nq))
        half = vocab // 2
        edges = np.array([0, half - 1, half, vocab - 1])
        targets = rng.integers(0, vocab, (LOSS_B, LOSS_T, *nq))
        targets[:, :4] = edges.reshape(1, 4, *(1,) * len(nq))
        batch = dict(tokens=toks.astype(np.int64),
                     targets=targets.astype(np.int64))
        if ref_cfg.n_prefix_embeds:
            batch["prefix"] = rng.normal(size=(
                LOSS_B, ref_cfg.n_prefix_embeds,
                ref_cfg.d_model)).astype(np.float32)
        loss, grads = jax.value_and_grad(
            lambda p, c=ref_cfg, b=batch: ref_decoder.train_loss(
                p, c, {k: jnp.asarray(v) for k, v in b.items()}))(params)
        want[name] = (float(loss), {
            p: np.asarray(g) for p, g in _flat(jax.tree.map(np.asarray,
                                                            grads)).items()})
        arrays.update({f"{name}/{k}": v for k, v in batch.items()})
        arrays.update({f"{name}/p/" + "/".join(p): a
                       for p, a in _flat(params).items()})
    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, **arrays)
    _spawn(_loss_head_worker, 4, 4, str(tmp_path / "store"), str(inp),
           str(out))
    with np.load(out) as f:
        got = dict(f)
    for name, arch, vocab in LOSS_CASES:
        want_loss, want_grads = want[name]
        np.testing.assert_allclose(got[f"{name}/loss_sharded"], want_loss,
                                   rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(got[f"{name}/loss_plain"], want_loss,
                                   rtol=1e-5, err_msg=name)
        assert len(want_grads) > 0
        for path, g in want_grads.items():
            key = "/".join(path)
            sharded = got[f"{name}/grad_sharded/{key}"]
            np.testing.assert_allclose(sharded,
                                       got[f"{name}/grad_plain/{key}"],
                                       atol=1e-5, rtol=1e-5,
                                       err_msg=f"{name} {key}")
            np.testing.assert_allclose(sharded, g, atol=1e-5, rtol=1e-5,
                                       err_msg=f"{name} {key} vs reference")
        numels = got[f"{name}/collective_numels"]
        assert len(numels) and LOSS_B * LOSS_CHUNK * vocab not in numels, (
            name, numels)
        for step in ("prefill", "decode"):
            np.testing.assert_allclose(got[f"{name}/{step}_sharded"],
                                       got[f"{name}/{step}_plain"],
                                       atol=1e-5, rtol=1e-5,
                                       err_msg=f"{name} {step}")
            vdim = got[f"{name}/{step}_sharded"].ndim - 1
            model = f"Shard({vdim})" if vocab % 2 == 0 else "Replicate"
            assert list(got[f"{name}/{step}_placements"]) == [
                "Shard(0)", model], (name, step)


def _one_device_worker(rank, world, store, out):
    """qwen2-0.5b and musicgen smoke (with its prefix), in f32 and bf16,
    on a (1, 1) mesh, sharded and unsharded on random weights: the loss
    head alone (`chunked_ce_loss` on the final activations, and its
    gradients), `train_loss` and every gradient of it, and the prefill
    logits."""
    _init(rank, world, store)
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel.sharding import distribute_params

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach()

    res = {}
    mesh = make_host_mesh(1, device="cpu")
    for arch in ("qwen2-0.5b", "musicgen-medium"):
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(get_config(arch).smoke(), dtype=dtype,
                                      loss_chunk=LOSS_CHUNK)
            params = decoder.init_params(torch.Generator().manual_seed(0), cfg)
            gen = torch.Generator().manual_seed(1)
            nq = (cfg.n_codebooks,) if cfg.n_codebooks else ()
            batch = {k: torch.randint(0, cfg.vocab_size,
                                      (LOSS_B, LOSS_T, *nq), generator=gen)
                     for k in ("tokens", "targets")}
            if cfg.n_prefix_embeds:
                batch["prefix"] = torch.randn(
                    LOSS_B, cfg.n_prefix_embeds, cfg.d_model, generator=gen)
            xs = torch.randn(LOSS_B, LOSS_T, cfg.d_model,
                             generator=gen).to(cfg.torch_dtype)
            targets = batch["targets"][..., 0] if nq else batch["targets"]
            for label, ps in (("sharded", distribute_params(params, mesh)),
                              ("plain", params)):
                key = f"{arch}/{dtype}/{label}"
                head = (ps["head"][0] if nq else ps["head"]).detach()
                head.requires_grad_(True)
                x = xs.clone().requires_grad_(True)
                loss = layers.chunked_ce_loss(
                    head, decoder._batch_layout(layers.replicated_like(
                        x, head)), targets, cfg.loss_chunk)
                loss.backward()
                res[f"{key}/head_loss"] = whole(loss).float()
                res[f"{key}/dx"] = x.grad.float()
                res[f"{key}/dhead"] = whole(head.grad).float()
                leaves = _flat(ps)
                for t in leaves.values():
                    t.requires_grad_(True)
                loss = decoder.train_loss(ps, cfg, batch, use_kernels=False)
                loss.backward()
                res[f"{key}/loss"] = loss.detach().float()
                for path, t in leaves.items():
                    res[f"{key}/grad/" + "/".join(path)] = whole(
                        t.grad).float()
                    t.requires_grad_(False)
                with torch.no_grad():
                    res[f"{key}/prefill"] = whole(decoder.prefill(
                        ps, cfg, batch["tokens"], batch.get("prefix"),
                        use_kernels=False)[0]).float()
    np.savez(out, **{k: v.numpy() for k, v in res.items()})
    dist.destroy_process_group()


def test_one_device_loss_head_is_the_plain_path(tmp_path):
    """On a one-device mesh nothing splits the vocabulary, the batch or
    d, and the sharded loss head runs the plain path's arithmetic
    (`torch.logsumexp` and its backward), and the sharded embedding
    `F.embedding`'s (its lookup, and `embedding_dense_backward`): for
    qwen2-0.5b's head and one of musicgen's codebook heads (smoke, f32
    and bf16), the loss and its gradients in x and in the head are bit
    for bit the unsharded port's, and so are `train_loss`, every gradient
    of it (the embedding table's, musicgen's 4 codebook tables and prefix
    projection included; qwen2-0.5b's f32 key bias within 1e-8) and the
    prefill logits."""
    out = tmp_path / "out.npz"
    _spawn(_one_device_worker, 1, 1, str(tmp_path / "store"), str(out))
    with np.load(out) as f:
        got = dict(f)
    plain = [k for k in got if "/plain/" in k]
    for arch, leaves in (("qwen2-0.5b", ("embed",)),
                         ("musicgen-medium", ("embed", "prefix_proj"))):
        for dtype in ("float32", "bfloat16"):
            key = f"{arch}/{dtype}/plain/"
            grads = [k for k in plain if k.startswith(key + "grad/")]
            assert len([k for k in plain if k.startswith(key)]) == 5 + len(
                grads) and len(grads) > 10
            assert all(f"{key}grad/{leaf}" in grads for leaf in leaves)
    for k in plain:
        if k == "qwen2-0.5b/float32/plain/grad/layers/attn/bk":
            # the sharded attention's key bias gradient sums its rows in
            # another order on the CPU, here as before the embedding was
            # sharded (2.8e-9 apart)
            np.testing.assert_allclose(
                got[k.replace("/plain/", "/sharded/")], got[k], atol=1e-8,
                rtol=0, err_msg=k)
            continue
        np.testing.assert_array_equal(got[k.replace("/plain/", "/sharded/")],
                                      got[k], err_msg=k)


def test_mesh_train_rehearsal():
    """`tools/mesh_train.py --device cpu --smoke`: qwen2-0.5b smoke on 4
    gloo ranks as (data, model) = (2, 2). The sharded gradients hold
    phase 14.3's criterion against the f32 ones, the collective bytes of
    the forward and backward and of a train step are counted, and each
    of the AdamW steps' losses on the mesh is within `LOSS_REL` of one
    process's unsharded step."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "mesh_train.py"),
         "--device", "cpu", "--smoke"], capture_output=True, text=True,
        timeout=300, cwd=root, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])["mesh_train"]
    assert got["ok"] and not got["bad_leaves"], got
    assert got["mesh"] == [2, 2] and got["cards"] == 4
    assert got["grad_collective_bytes"] > 0
    assert got["step_collective_bytes"] > 0
    assert len(got["step_losses"]) == len(got["unsharded_step_losses"]) == 3
    assert [t["src"] for t in got["timed"]] == [os.path.join(root, "src")]


def _stage_fn(sp, x):
    for w in sp:
        x = torch.tanh(x @ w)
    return x


def _pipeline_worker(rank, world, store, inp, out):
    _init(rank, world, store)
    from torch.distributed.device_mesh import init_device_mesh
    with np.load(inp) as f:
        W, xs = torch.from_numpy(f["W"]), torch.from_numpy(f["xs"])
    res = {}
    for name, shape, axes in (("4", (4,), ("stage",)),
                              ("1", (4, 1), ("data", "stage"))):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        m = shape[-1]
        fn = pipeline.pipelined_forward(_stage_fn, mesh, m, xs.shape[0])
        res[name] = fn(pipeline.split_stages(W, m), xs)
    if rank == 0:
        np.savez(out, **{k: v.numpy() for k, v in res.items()})
    dist.destroy_process_group()


def test_pipeline_equals_reference_sequential(tmp_path):
    """tests/test_distribution.py:56-88 on 4 gloo ranks: the GPipe schedule
    over a 4-stage mesh equals the reference's sequential scan at 1e-5,
    and over a 1-stage axis (identity handoff) too."""
    jax, _ = _ref()
    import jax.numpy as jnp
    n_stages, n_micro, mb, d, L = 4, 8, 2, 16, 8
    rng = np.random.default_rng(0)
    W = (rng.normal(size=(L, d, d)) * (d ** -0.5)).astype(np.float32)
    xs = rng.normal(size=(n_micro, mb, d)).astype(np.float32)

    def body(h, w):
        return jnp.tanh(h @ w), None
    want = np.stack([np.asarray(jax.lax.scan(body, xs[m], W)[0])
                     for m in range(n_micro)])
    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, W=W, xs=xs)
    _spawn(_pipeline_worker, n_stages, n_stages, str(tmp_path / "store"),
           str(inp), str(out))
    with np.load(out) as f:
        for name in ("4", "1"):
            assert float(np.abs(f[name] - want).max()) < 1e-5, name


def test_pipeline_utilization_equals_reference():
    pytest.importorskip("jax")
    from repro.parallel.pipeline import pipeline_utilization as ref_util
    for M in (1, 2, 4, 8, 9, 27, 64):
        for m in (1, 2, 3, 4, 8, 16):
            assert pipeline.pipeline_utilization(M, m) == ref_util(M, m)
    assert abs(pipeline.pipeline_utilization(9, 4) - 0.75) < 1e-9


def test_split_stages_shapes_and_refusal():
    W = torch.arange(8 * 3 * 2, dtype=torch.float32).reshape(8, 3, 2)
    st = pipeline.split_stages(dict(w=W, b=(W[:, 0],)), 4)
    assert st["w"].shape == (4, 2, 3, 2) and st["b"][0].shape == (4, 2, 2)
    assert torch.equal(st["w"].reshape(8, 3, 2), W)
    with pytest.raises(ValueError, match="do not split"):
        pipeline.split_stages(W, 3)

