"""The MoE, RWKV6 and Mamba2 mixers on DTensors against the JAX package:
small configs of each family, on gloo process groups of 2 ranks on the
CPU, as meshes (data, model) (1, 2) and (2, 1), and the MoE configs on 4
ranks as (2, 2).

The reference's numbers (logits of prefill and 3 decode steps, the
training loss) come from `repro` in this process; the workers never
import jax: weights and inputs reach them in an `np.savez` file, and they
write their results to another (`test_torch_parallel`'s helpers). One
spawn per mesh runs every config; each test reads its part.

Tolerances, f32 atol = rtol = 1e-5: the sharded logits and loss against
the reference's. The sharded gradients against the unsharded port's at
rtol 1e-5 and atol 1e-5 (times the leaf's largest entry where that
exceeds 1) plus twice the unsharded port's own largest distance from the
reference's gradient on that leaf (`jax.grad`): rwkv6's per-head group
norm divides by rows' rms, so its gradients carry f32 rounding enlarged
far past 1e-5 (the unsharded port and the reference differ by 2.1e-5 on
its embedding), and the sharded run rounds its sums in another order.
The MoE configs run at capacity factor 1.0, so their batches drop copies
(`test_sharded_moe_capacity_is_global` shows that the drops change the
reference's loss), and the sharded run must drop the same ones. The
W8A8 MoE's int8 activations are compared too
(`test_sharded_w8a8_quantises_as_unsharded`): its partial products sum
in another order than the unsharded run's, and a last-bit change of an
expert's input could move the round-to-nearest of the activation
quantisation by one int8 step; where f is split, its hidden rows'
scales come from maxima over the whole row, across ranks.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.models import decoder, moe

from test_torch_parallel import _flat, _init, _spawn, _tree

torch.set_num_threads(1)

B, T, STEPS = 4, 16, 3
# name -> (ranks, "model" axis size)
MESHES = {"mesh1x2": (2, 2), "mesh2x1": (2, 1), "mesh2x2": (4, 2)}


def _configs(get):
    """name -> the small config, from `get(arch)` (the port's or the
    reference's `get_config`)."""
    kimi = dataclasses.replace(get("kimi-k2-1t-a32b").smoke(),
                               capacity_factor=1.0)
    return {
        # 2 heads of 64
        "rwkv6": dataclasses.replace(get("rwkv6-7b").smoke(), d_model=128),
        # 4 SSM heads of 32, N 16, one super-block of 2 and a tail layer
        "zamba2": dataclasses.replace(get("zamba2-7b").smoke(), d_model=64,
                                      d_inner=128, n_layers=3),
        # 4 experts (E divides "model"), top-2, a shared expert
        "moe": kimi,
        # 3 experts: the rules fall back to TP on f
        "moe_tp": dataclasses.replace(kimi, n_experts=3),
        "moe_w8a8": dataclasses.replace(kimi, moe_w8a8=True),
        "moe_tp_w8a8": dataclasses.replace(kimi, n_experts=3, moe_w8a8=True),
    }


ARCHS = list(_configs(get_config))
MOE_ARCHS = [a for a in ARCHS if a.startswith("moe")]
# the (arch, mesh) pairs each mesh's workers run: every config on 2 ranks,
# the MoE ones on 4
CASES = [(a, m) for m in MESHES for a in (MOE_ARCHS if m == "mesh2x2"
                                          else ARCHS)]
# W8A8 runs whose int8 activations are compared with the unsharded run's:
# the experts split over "model" (EP), or f over "model" (the TP
# fallback), or f over "data", each rank holding the whole batch's copies
W8A8_TRACES = [("moe_w8a8", "mesh1x2"), ("moe_tp_w8a8", "mesh1x2"),
               ("moe_w8a8", "mesh2x1"), ("moe_w8a8", "mesh2x2")]
# the MoE runs of the capacity check: tokens gathered where f is split
# over "data" (mesh2x1), and each data rank's own tokens where the
# weights are whole over "data" (moe_tp's TP fallback on mesh2x2)
CAPACITY = {"mesh2x1": "moe", "mesh2x2": "moe_tp"}


def _worker(rank, world, store, mesh_name, inp, out):
    _init(rank, world, store)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.parallel.sharding import distribute_params

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach()

    with np.load(inp) as f:
        data = dict(f)
    mesh = make_host_mesh(MESHES[mesh_name][1], device="cpu")
    toks = torch.from_numpy(data["tokens"])
    res, trees = {}, {}
    for name, cfg in _configs(get_config).items():
        if (name, mesh_name) not in CASES:
            continue
        weights = _tree({k[len(name) + 3:]: v for k, v in data.items()
                         if k.startswith(f"p/{name}/")})
        params = params_from_numpy(weights, cfg, "cpu")
        sp = distribute_params(params, mesh)
        trees[name] = (params, sp)
        with torch.no_grad():
            lg, cache = decoder.prefill(sp, cfg, toks, max_len=T + STEPS)
            steps = [whole(lg)]
            for s in range(STEPS):
                lg, cache = decoder.decode_step(
                    sp, cfg, cache, torch.from_numpy(data["decode"][s]),
                    T + s)
                steps.append(whole(lg))
        res[f"{name}/logits"] = torch.stack(steps)
        batch = dict(tokens=toks, targets=torch.from_numpy(data["targets"]))
        if cfg.moe_w8a8:
            for label, ps in (("sharded", sp), ("plain", params)):
                try:
                    decoder.train_loss(ps, cfg, batch)
                except NotImplementedError as e:
                    res[f"{name}/raised_{label}"] = np.array(str(e))
            lp = decoder._layer(sp["layers"], 0)["moe"]
            x = torch.from_numpy(data["moe_x"])
            res[f"{name}/block"] = whole(moe.moe_apply(
                lp, cfg, DTensor.from_local(x, mesh, [Replicate()] * 2)))
            res.update(_w8a8_plain_block(name, cfg, params, x))
            if (name, mesh_name) in W8A8_TRACES:
                res.update(_w8a8_trace(name, cfg, params, sp, data, mesh,
                                       whole))
            continue
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
                t.grad = None
    if mesh_name in CAPACITY:
        # The capacity is the global batch's: the MoE block on the batch
        # split over data drops the copies the whole batch drops, which
        # the data ranks' parts run alone would not.
        cfg = _configs(get_config)[CAPACITY[mesh_name]]
        lp, slp = (decoder._layer(ps["layers"], 0)["moe"]
                   for ps in trees[CAPACITY[mesh_name]])
        x = torch.from_numpy(data["moe_x"])
        n = mesh.size(0)
        h, me = x.shape[0] // n, mesh.get_local_rank(0)
        got = moe.moe_apply(slp, cfg, DTensor.from_local(
            x[me * h:(me + 1) * h], mesh, [Shard(0), Replicate()]))
        res["capacity/sharded"] = whole(got)
        res["capacity/whole"] = moe.moe_apply(lp, cfg, x)
        res["capacity/halves"] = torch.cat([
            moe.moe_apply(lp, cfg, x[j * h:(j + 1) * h]) for j in range(n)])
        xf = x.reshape(-1, cfg.d_model)
        _, idx = moe.route(lp, cfg, xf)
        _, keep = moe.dispatch_slots(idx, moe.capacity(cfg, xf.shape[0]))
        res["capacity/dropped"] = (~keep).sum()
    if rank == 0:
        np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
    dist.destroy_process_group()


def _w8a8_plain_block(name, cfg, params, x):
    """The unsharded W8A8 MoE block of layer 0 on x, and the largest
    change one flipped rounding of its hidden activations can make (its
    largest hidden row scale times the largest of 127 * w2_s, as
    `test_torch_moe`'s bound for the module against the reference)."""
    quant, scales = moe._quant_act, []

    def quant_rec(h, *a):
        q, scale = quant(h, *a)
        scales.append(scale)
        return q, scale
    lp = decoder._layer(params["layers"], 0)["moe"]
    moe._quant_act = quant_rec
    try:
        with torch.no_grad():
            out = moe.moe_apply(lp, cfg, x)
    finally:
        moe._quant_act = quant
    step = float(scales[1].max()) * float((127.0 * lp["w2_s"]).max())
    return {f"{name}/block_plain": out, f"{name}/block_step": step}


def _w8a8_trace(name, cfg, params, sp, data, mesh, whole):
    """The W8A8 MoE's prefill and decode steps run again, sharded (`sp`)
    and unsharded (`params`), with every call of the MoE block and of the
    activation quantisation recorded. Returns the sharded run's block
    inputs and outputs (whole tensors, in call order) and, summed over
    the ranks, how many of the int8 activations (expert inputs and hidden
    rows) of each rank's experts and slice of f differ between the runs,
    their largest difference in int8 steps, and the largest difference of
    the blocks' float inputs. Each rank must hold the whole batch's
    copies of its experts (the experts or f split, no data rank keeping
    its own tokens)."""
    quant, apply = moe._quant_act, decoder.moe_apply
    runs = {"sharded": dict(q=[], io=[]), "plain": dict(q=[], io=[])}

    def run(label, ps):
        log = runs[label]

        def quant_rec(x, *a):
            q, scale = quant(x, *a)
            log["q"].append(q)
            return q, scale

        def apply_rec(p, c, x, use_kernels=True):
            out = apply(p, c, x, use_kernels)
            log["io"].append((whole(x), whole(out)))
            return out
        moe._quant_act, decoder.moe_apply = quant_rec, apply_rec
        try:
            with torch.no_grad():
                toks = torch.from_numpy(data["tokens"])
                _, cache = decoder.prefill(ps, cfg, toks, max_len=T + STEPS)
                for s in range(STEPS):
                    _, cache = decoder.decode_step(
                        ps, cfg, cache, torch.from_numpy(data["decode"][s]),
                        T + s)
        finally:
            moe._quant_act, decoder.moe_apply = quant, apply
    run("sharded", sp)
    run("plain", params)
    qs, qp = runs["sharded"]["q"], runs["plain"]["q"]
    assert len(qs) == len(qp) > 0
    # this rank's index among the experts' and f's slices: the mesh dims
    # that split the stacked w1 [n, E, d, f] on E or on f, major first
    e_me = f_me = 0
    for i, pl in enumerate(sp["layers"]["moe"]["w1"].placements):
        r, n = mesh.get_local_rank(i), mesh.size(i)
        e_me = e_me * n + r if pl.is_shard(1) else e_me
        f_me = f_me * n + r if pl.is_shard(3) else f_me
    n_diff, n_all, step = 0, 0, 0
    for a, b in zip(qs, qp, strict=True):
        e_l, f_l = a.shape[0], a.shape[-1]
        b = b[e_me * e_l:(e_me + 1) * e_l]
        if b.shape[-1] != f_l:      # hidden rows: this rank's slice of f
            b = b[..., f_me * f_l:(f_me + 1) * f_l]
        assert a.shape == b.shape, (a.shape, b.shape)
        d = (a.int() - b.int()).abs()
        n_diff += int((d > 0).sum())
        n_all += d.numel()
        step = max(step, int(d.max()))
    counts = torch.tensor([n_diff, n_all])
    dist.all_reduce(counts)
    top = torch.tensor([step])
    dist.all_reduce(top, op=dist.ReduceOp.MAX)
    io_s, io_p = runs["sharded"]["io"], runs["plain"]["io"]
    res = {f"{name}/q_diff": counts[0], f"{name}/q_all": counts[1],
           f"{name}/q_step": top[0],
           f"{name}/x_gap": max(float((a[0] - b[0]).abs().max())
                                for a, b in zip(io_s, io_p, strict=True))}
    for j, (x, y) in enumerate(io_s):
        res[f"{name}/io_x/{j}"], res[f"{name}/io_y/{j}"] = x, y
    return res


@pytest.fixture(scope="module")
def reference():
    """The reference's weights and numbers for every config, and the
    inputs shared by both meshes."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as ref_get_config
    from repro.models import decoder as ref_decoder
    from repro.models import moe as ref_moe
    rng = np.random.default_rng(1)
    cfgs = _configs(ref_get_config)
    V = min(c.vocab_size for c in cfgs.values())
    toks = rng.integers(0, V, (B, T)).astype(np.int64)
    targets = rng.integers(0, V, (B, T)).astype(np.int64)
    dec = rng.integers(0, V, (STEPS, B, 1)).astype(np.int64)
    d = cfgs["moe"].d_model
    moe_x = rng.normal(size=(B, T, d)).astype(np.float32)
    inputs = dict(tokens=toks, targets=targets, decode=dec, moe_x=moe_x)
    want = {}
    for name, cfg in cfgs.items():
        params = jax.tree.map(np.asarray, ref_decoder.init_params(
            jax.random.PRNGKey(0), cfg))
        inputs.update({f"p/{name}/" + "/".join(p): a
                       for p, a in _flat(params).items()})
        lg, cache = ref_decoder.prefill(params, cfg, toks, max_len=T + STEPS)
        steps = [np.asarray(lg)]
        for s in range(STEPS):
            lg, cache = ref_decoder.decode_step(params, cfg, cache, dec[s],
                                                T + s)
            steps.append(np.asarray(lg))
        want[f"{name}/logits"] = np.stack(steps)
        batch = dict(tokens=toks, targets=targets)
        want[f"{name}/loss"] = float(ref_decoder.train_loss(params, cfg,
                                                            batch))
        if not cfg.moe_w8a8:
            grads = jax.grad(lambda p, cfg=cfg: ref_decoder.train_loss(
                p, cfg, batch))(params)
            want.update({f"{name}/grad/" + "/".join(p): np.asarray(a)
                         for p, a in _flat(grads).items()})
        if name.startswith("moe"):
            lp = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
            want[f"{name}/block"] = np.asarray(ref_moe.moe_apply(lp, cfg,
                                                                 moe_x))
            full = dataclasses.replace(cfg, capacity_factor=cfg.n_experts)
            want[f"{name}/loss_no_drops"] = float(ref_decoder.train_loss(
                params, full, batch))
    return inputs, want


@pytest.fixture(scope="module")
def sharded(reference, tmp_path_factory):
    """mesh name -> the workers' results on that mesh (run on demand)."""
    runs = {}

    def get(mesh):
        if mesh not in runs:
            tmp = tmp_path_factory.mktemp(mesh)
            inp, out = tmp / "in.npz", tmp / "out.npz"
            np.savez(inp, **reference[0])
            world = MESHES[mesh][0]
            _spawn(_worker, world, world, str(tmp / "store"), mesh, str(inp),
                   str(out))
            with np.load(out) as f:
                runs[mesh] = dict(f)
        return runs[mesh]
    return get


@pytest.mark.parametrize("arch,mesh", CASES,
                         ids=[f"{a}-{m}" for a, m in CASES])
def test_sharded_mixer_equals_reference(reference, sharded, arch, mesh):
    """Prefill and 3 decode steps on DTensor parameters and caches give
    the reference's logits; `train_loss` gives the reference's loss and
    the sharded gradients equal the unsharded port's (W8A8: its int8
    experts are not trainable, sharded or not)."""
    _, want = reference
    got = sharded(mesh)
    np.testing.assert_allclose(got[f"{arch}/logits"], want[f"{arch}/logits"],
                               atol=1e-5, rtol=1e-5)
    if arch.endswith("w8a8"):
        for label in ("sharded", "plain"):
            assert "not trainable" in str(got[f"{arch}/raised_{label}"])
        # The MoE block on random rows: the unsharded port's at 1e-5; and
        # the reference's at 1e-5, or, where the unsharded port's own
        # silu lands an ulp across a rounding boundary of the hidden
        # quantisation (moe_tp_w8a8 here), within the one int8 step that
        # `test_torch_moe` allows the unsharded module.
        np.testing.assert_allclose(got[f"{arch}/block"],
                                   got[f"{arch}/block_plain"], atol=1e-5,
                                   rtol=1e-5)
        tol = (1e-5 if arch == "moe_w8a8"
               else float(got[f"{arch}/block_step"]) + 2e-5)
        assert float(got[f"{arch}/block_step"]) > 0
        np.testing.assert_allclose(got[f"{arch}/block"],
                                   want[f"{arch}/block"], atol=tol,
                                   rtol=1e-5)
        return
    np.testing.assert_allclose(got[f"{arch}/loss_sharded"],
                               want[f"{arch}/loss"], rtol=1e-5)
    grads = [k for k in got if k.startswith(f"{arch}/grad_plain/")]
    assert grads
    for k in grads:
        plain = got[k]
        ref = want[k.replace("grad_plain", "grad", 1)]
        atol = (1e-5 * max(1.0, float(np.abs(plain).max()))
                + 2 * float(np.abs(plain - ref).max()))
        np.testing.assert_allclose(
            got[k.replace("grad_plain", "grad_sharded", 1)], plain,
            atol=atol, rtol=1e-5, err_msg=k)


def _check_w8a8_trace(reference, sharded, arch, mesh):
    """Every MoE block of the W8A8 run `arch` on `mesh` gives the
    reference's block output on the same input at 1e-5, and the int8
    activations of each rank's experts (and slice of f) equal the
    unsharded run's. Returns the largest difference of the blocks' float
    inputs between the sharded and the unsharded run."""
    import jax
    from repro.configs import get_config as ref_get_config
    from repro.models import moe as ref_moe
    inputs, _ = reference
    got = sharded(mesh)
    cfg = _configs(ref_get_config)[arch]
    prefix = f"p/{arch}/layers/moe/"
    stack = _tree({k[len(prefix):]: v for k, v in inputs.items()
                   if k.startswith(prefix)})
    n = sum(1 for k in got if k.startswith(f"{arch}/io_x/"))
    assert n == (1 + STEPS) * cfg.n_layers
    for j in range(n):
        lp = jax.tree.map(lambda a, j=j: a[j % cfg.n_layers], stack)
        x = got[f"{arch}/io_x/{j}"]
        np.testing.assert_allclose(
            got[f"{arch}/io_y/{j}"],
            np.asarray(ref_moe.moe_apply(lp, cfg, x)), atol=1e-5, rtol=1e-5,
            err_msg=f"call {j}")
    assert int(got[f"{arch}/q_all"]) > 0
    assert int(got[f"{arch}/q_diff"]) == int(got[f"{arch}/q_step"]) == 0
    return float(got[f"{arch}/x_gap"])


def test_sharded_w8a8_quantises_as_unsharded(reference, sharded):
    """The W8A8 MoE on the (1, 2) mesh, its experts split over "model":
    every MoE block of the sharded prefill and decode steps gives the
    reference's block output on the same input at 1e-5, and the int8
    activations of each rank's experts equal the unsharded run's, though
    the blocks' float inputs differ in their last bits."""
    gap = _check_w8a8_trace(reference, sharded, "moe_w8a8", "mesh1x2")
    assert 0 < gap < 1e-5


@pytest.mark.parametrize("arch,mesh", W8A8_TRACES[1:],
                         ids=[f"{a}-{m}" for a, m in W8A8_TRACES[1:]])
def test_sharded_w8a8_quantises_as_unsharded_on_f_slices(reference, sharded,
                                                         arch, mesh):
    """As `test_sharded_w8a8_quantises_as_unsharded`, where each rank
    holds a slice of f: over "model" in the TP fallback (3 experts), over
    "data" (2, 1), and both E and f split (2, 2). The hidden rows' int8
    scales are the maxima over the whole rows, so every int8 activation
    of a rank's slice equals the unsharded run's."""
    assert _check_w8a8_trace(reference, sharded, arch, mesh) < 1e-5


def test_sharded_moe_capacity_is_global(reference, sharded):
    """On the (2, 1) mesh each data rank holds half the batch (gathered
    where the experts' f is split over "data"). At capacity
    factor 1.0 the whole batch drops copies (and the drops change the
    reference's loss); the sharded MoE block drops the same copies as the
    whole batch (1e-6 from the unsharded block, 1e-5 from the
    reference's), where two half batches run alone would not."""
    _check_capacity(reference, sharded, "mesh2x1", 1e-6)


def test_sharded_moe_capacity_is_global_on_per_rank_tokens(reference,
                                                           sharded):
    """As `test_sharded_moe_capacity_is_global`, on the (2, 2) mesh with
    3 experts: the rules fall back to TP on f over "model" and leave the
    expert weights whole over "data", so each data rank keeps its own
    tokens and their slots count the copies of the data ranks before it
    (`dispatch_slots(offset=)`). The block is a partial sum over "model"
    here, so it is held to the unsharded block at the file's 1e-5."""
    _check_capacity(reference, sharded, "mesh2x2", 1e-5)


def _check_capacity(reference, sharded, mesh, tol):
    _, want = reference
    got = sharded(mesh)
    arch = CAPACITY[mesh]
    assert int(got["capacity/dropped"]) > 0
    assert abs(want[f"{arch}/loss"] - want[f"{arch}/loss_no_drops"]) > 1e-4
    np.testing.assert_allclose(got["capacity/sharded"],
                               got["capacity/whole"], atol=tol, rtol=tol)
    np.testing.assert_allclose(got["capacity/sharded"],
                               want[f"{arch}/block"], atol=1e-5, rtol=1e-5)
    assert np.abs(got["capacity/halves"] - got["capacity/whole"]).max() > 1e-3
