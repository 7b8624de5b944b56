"""The MoE, RWKV6 and Mamba2 mixers on DTensors against the JAX package:
small configs of each family, on gloo process groups of 2 ranks on the
CPU, as meshes (data, model) (1, 2) and (2, 1).

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
reference's loss), and the sharded run must drop the same ones. On the
(1, 2) mesh the W8A8 MoE's int8 activations are compared too
(`test_sharded_w8a8_quantises_as_unsharded`): its row-parallel products
sum in another order than the unsharded run's, and a last-bit change of
an expert's input could move the round-to-nearest of the activation
quantisation by one int8 step.
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
MESHES = {"mesh1x2": 2, "mesh2x1": 1}          # name -> "model" axis size


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
    }


ARCHS = list(_configs(get_config))


def _worker(rank, world, store, model, inp, out):
    _init(rank, world, store)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.parallel.sharding import distribute_params

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach()

    with np.load(inp) as f:
        data = dict(f)
    mesh = make_host_mesh(model, device="cpu")
    toks = torch.from_numpy(data["tokens"])
    res, moe_trees = {}, None
    for name, cfg in _configs(get_config).items():
        weights = _tree({k[len(name) + 3:]: v for k, v in data.items()
                         if k.startswith(f"p/{name}/")})
        params = params_from_numpy(weights, cfg, "cpu")
        sp = distribute_params(params, mesh)
        if name == "moe":
            moe_trees = (params, sp)
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
            if model == 2:
                res.update(_w8a8_trace(name, cfg, params, sp, data, rank,
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
    if model == 1:
        # The capacity is the global batch's: the MoE block on the batch
        # split over data drops the copies the whole batch drops, which
        # two half batches run alone would not.
        cfg = _configs(get_config)["moe"]
        lp, slp = (decoder._layer(ps["layers"], 0)["moe"]
                   for ps in moe_trees)
        x = torch.from_numpy(data["moe_x"])
        h = x.shape[0] // 2
        got = moe.moe_apply(slp, cfg, DTensor.from_local(
            x[rank * h:(rank + 1) * h], mesh, [Shard(0), Replicate()]))
        res["capacity/sharded"] = whole(got)
        res["capacity/whole"] = moe.moe_apply(lp, cfg, x)
        res["capacity/halves"] = torch.cat([moe.moe_apply(lp, cfg, x[:h]),
                                            moe.moe_apply(lp, cfg, x[h:])])
        xf = x.reshape(-1, cfg.d_model)
        _, idx = moe.route(lp, cfg, xf)
        _, keep = moe.dispatch_slots(idx, moe.capacity(cfg, xf.shape[0]))
        res["capacity/dropped"] = (~keep).sum()
    if rank == 0:
        np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
    dist.destroy_process_group()


def _w8a8_trace(name, cfg, params, sp, data, rank, whole):
    """The W8A8 MoE's prefill and decode steps run again, sharded (`sp`)
    and unsharded (`params`) on the experts split over "model", with
    every call of the MoE block and of the activation quantisation
    recorded. Returns the sharded run's block inputs and outputs (whole
    tensors, in call order) and, summed over both ranks, how many of the
    int8 activations (expert inputs and hidden rows) of each rank's
    experts differ between the runs, their largest difference in int8
    steps, and the largest difference of the blocks' float inputs."""
    quant, apply = moe._quant_act, decoder.moe_apply
    runs = {"sharded": dict(q=[], io=[]), "plain": dict(q=[], io=[])}

    def run(label, ps):
        log = runs[label]

        def quant_rec(x):
            q, scale = quant(x)
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
    n_diff, n_all, step = 0, 0, 0
    for a, b in zip(qs, qp, strict=True):
        e_l = a.shape[0]
        b = b[rank * e_l:(rank + 1) * e_l]
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
            _spawn(_worker, 2, 2, str(tmp / "store"), MESHES[mesh], str(inp),
                   str(out))
            with np.load(out) as f:
                runs[mesh] = dict(f)
        return runs[mesh]
    return get


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_mixer_equals_reference(reference, sharded, arch, mesh):
    """Prefill and 3 decode steps on DTensor parameters and caches give
    the reference's logits; `train_loss` gives the reference's loss and
    the sharded gradients equal the unsharded port's (W8A8: its int8
    experts are not trainable, sharded or not)."""
    _, want = reference
    got = sharded(mesh)
    np.testing.assert_allclose(got[f"{arch}/logits"], want[f"{arch}/logits"],
                               atol=1e-5, rtol=1e-5)
    if arch == "moe_w8a8":
        for label in ("sharded", "plain"):
            assert "not trainable" in str(got[f"{arch}/raised_{label}"])
        np.testing.assert_allclose(got[f"{arch}/block"],
                                   want[f"{arch}/block"], atol=1e-5,
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


def test_sharded_w8a8_quantises_as_unsharded(reference, sharded):
    """The W8A8 MoE on the (1, 2) mesh, its experts split over "model":
    every MoE block of the sharded prefill and decode steps gives the
    reference's block output on the same input at 1e-5, and the int8
    activations of each rank's experts equal the unsharded run's, though
    the blocks' float inputs differ in their last bits."""
    import jax
    from repro.configs import get_config as ref_get_config
    from repro.models import moe as ref_moe
    inputs, _ = reference
    got = sharded("mesh1x2")
    arch = "moe_w8a8"
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
    assert 0 < float(got[f"{arch}/x_gap"]) < 1e-5
    assert int(got[f"{arch}/q_all"]) > 0
    assert int(got[f"{arch}/q_diff"]) == int(got[f"{arch}/q_step"]) == 0


def test_sharded_moe_capacity_is_global(reference, sharded):
    """On the (2, 1) mesh each data rank holds half the batch. At capacity
    factor 1.0 the whole batch drops copies (and the drops change the
    reference's loss); the sharded MoE block drops the same copies as the
    whole batch (1e-6 from the unsharded block, 1e-5 from the
    reference's), where two half batches run alone would not."""
    _, want = reference
    got = sharded("mesh2x1")
    assert int(got["capacity/dropped"]) > 0
    assert abs(want["moe/loss"] - want["moe/loss_no_drops"]) > 1e-4
    np.testing.assert_allclose(got["capacity/sharded"],
                               got["capacity/whole"], atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got["capacity/sharded"], want["moe/block"],
                               atol=1e-5, rtol=1e-5)
    assert np.abs(got["capacity/halves"] - got["capacity/whole"]).max() > 1e-3
