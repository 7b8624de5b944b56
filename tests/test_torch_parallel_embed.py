"""The token embedding on DTensors against the JAX package: every table
placement that the reference's rule gives, on gloo process groups of 2
ranks on the CPU as meshes (data, model) (1, 2) and (2, 1), and of 4 ranks
as (2, 2).

The cases (`_configs`), f32 smoke configs at 2 layers:
- "vocab": qwen2-0.5b at 512 words, V split over "model" and d over the
  FSDP axes; the rows are few, so the table stays and the looked-up rows
  move;
- "gathered": the same at 64 words, where the table's slice is no larger
  than a rank's rows, so it is gathered over the FSDP axes and each rank
  looks up its own rows;
- "columns": internvl2-26b at 509 words (V does not divide "model": d is
  split there) with its prefix;
- "whole": qwen2-0.5b at 509 words and d 63 (neither divides "model"; on
  (2, 1) the table is whole over "data");
- "codebooks": musicgen-medium, 4 codebook tables and a prefix.

The reference's numbers (the loss and every gradient of `train_loss`, the
logits of a prefill and 2 decode steps) come from `repro` in this process;
the workers never import jax: weights and inputs reach them in an
`np.savez` file, and they write their results to another. One spawn per
mesh runs every case; each test reads its part. Tolerances, f32 atol =
rtol = 1e-5, as `test_torch_parallel`.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _ref_cpu  # noqa: F401  (pins the reference to the CPU)

from repro_torch.configs import get_config
from repro_torch.models import decoder, layers

from test_torch_parallel import _flat, _init, _spawn, _tree

torch.set_num_threads(1)

B, T, STEPS = 4, 16, 2
# name -> (ranks, "model" axis size)
MESHES = {"mesh1x2": (2, 2), "mesh2x1": (2, 1), "mesh2x2": (4, 2)}


def _configs(get):
    """name -> the small config, from `get(arch)` (the port's or the
    reference's `get_config`)."""
    qwen = get("qwen2-0.5b").smoke()
    return {
        "vocab": dataclasses.replace(qwen, vocab_size=512),
        "gathered": dataclasses.replace(qwen, vocab_size=64),
        "columns": dataclasses.replace(get("internvl2-26b").smoke(),
                                       vocab_size=509),
        "whole": dataclasses.replace(qwen, vocab_size=509, d_model=63),
        "codebooks": get("musicgen-medium").smoke(),
    }


CASES = [(c, m) for c in ("vocab", "gathered", "columns", "whole",
                          "codebooks") for m in MESHES]


def _placements(x) -> np.ndarray:
    return np.array([f"Shard({p.dim})" if p.is_shard() else
                     "Replicate" if p.is_replicate() else "Partial"
                     for p in x.placements])


def _worker(rank, world, store, mesh_name, inp, out):
    _init(rank, world, store)
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.parallel.sharding import distribute_params

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach()

    with np.load(inp) as f:
        data = dict(f)
    mesh = make_host_mesh(MESHES[mesh_name][1], device="cpu")
    res = {}
    for name, cfg in _configs(get_config).items():
        params = params_from_numpy(_tree({
            k[len(name) + 3:]: v for k, v in data.items()
            if k.startswith(f"p/{name}/")}), cfg, "cpu")
        batch = {k: torch.from_numpy(data[f"{name}/{k}"])
                 for k in ("tokens", "targets", "prefix")
                 if f"{name}/{k}" in data}
        P = batch["prefix"].shape[1] if "prefix" in batch else 0
        for label, ps in (("sharded", distribute_params(params, mesh)),
                          ("plain", params)):
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
                                            max_len=P + T + STEPS)
                steps = [lg]
                for s, nt in enumerate(data[f"{name}/decode"]):
                    lg, cache = decoder.decode_step(
                        ps, cfg, cache, torch.from_numpy(nt), P + T + s)
                    steps.append(lg)
            res[f"{name}/logits_{label}"] = torch.stack(
                [whole(x) for x in steps])
            if label == "sharded":
                table = ps["embed"]
                x = decoder._embed(ps, cfg, batch["tokens"],
                                   batch.get("prefix"))
                res[f"{name}/layout"] = _placements(x)
                res[f"{name}/batch_layout"] = _placements(
                    decoder._batch_layout(x))
                res[f"{name}/table_moves"] = torch.tensor(
                    layers._table_moves(table, B, T))
    if rank == 0:
        np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference():
    """The reference's weights, inputs and numbers for every case."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as ref_get_config
    from repro.models import decoder as ref_decoder
    rng = np.random.default_rng(11)
    inputs, want = {}, {}
    for name, cfg in _configs(ref_get_config).items():
        V = cfg.vocab_size
        nq = (cfg.n_codebooks,) if cfg.n_codebooks else ()
        toks = rng.integers(0, V, (B, T, *nq))
        # the first and last ids of each "model" rank's slice of V
        toks[:, :4] = np.array([0, V // 2 - 1, V // 2, V - 1]).reshape(
            1, 4, *(1,) * len(nq))
        batch = dict(tokens=toks.astype(np.int64),
                     targets=rng.integers(0, V, (B, T, *nq)).astype(np.int64))
        if cfg.n_prefix_embeds:
            batch["prefix"] = rng.normal(size=(
                B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
        dec = rng.integers(0, V, (STEPS, B, 1, *nq)).astype(np.int64)
        params = jax.tree.map(np.asarray, ref_decoder.init_params(
            jax.random.PRNGKey(4), cfg))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        loss, grads = jax.value_and_grad(
            lambda p, c=cfg, b=jb: ref_decoder.train_loss(p, c, b))(params)
        want[f"{name}/loss"] = float(loss)
        want.update({f"{name}/grad/" + "/".join(p): np.asarray(g)
                     for p, g in _flat(jax.tree.map(np.asarray,
                                                    grads)).items()})
        P = cfg.n_prefix_embeds if "prefix" in batch else 0
        lg, cache = ref_decoder.prefill(params, cfg, batch["tokens"],
                                        batch.get("prefix"),
                                        max_len=P + T + STEPS)
        steps = [np.asarray(lg)]
        for s in range(STEPS):
            lg, cache = ref_decoder.decode_step(params, cfg, cache, dec[s],
                                                P + T + s)
            steps.append(np.asarray(lg))
        want[f"{name}/logits"] = np.stack(steps)
        inputs.update({f"{name}/{k}": v for k, v in batch.items()})
        inputs[f"{name}/decode"] = dec
        inputs.update({f"p/{name}/" + "/".join(p): a
                       for p, a in _flat(params).items()})
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


@pytest.mark.parametrize("case,mesh", CASES,
                         ids=[f"{c}-{m}" for c, m in CASES])
def test_sharded_embedding_equals_reference(reference, sharded, case, mesh):
    """`train_loss` on DTensor parameters gives the reference's loss, and
    every gradient (the table's included) the reference's and the
    unsharded port's; the logits of a prefill and 2 decode steps are the
    reference's."""
    _, want = reference
    got = sharded(mesh)
    np.testing.assert_allclose(got[f"{case}/loss_sharded"],
                               want[f"{case}/loss"], rtol=1e-5)
    grads = [k for k in want if k.startswith(f"{case}/grad/")]
    assert f"{case}/grad/embed" in grads
    for k in grads:
        sharded_grad = got[k.replace("/grad/", "/grad_sharded/", 1)]
        np.testing.assert_allclose(sharded_grad, want[k], atol=1e-5,
                                   rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(
            sharded_grad, got[k.replace("/grad/", "/grad_plain/", 1)],
            atol=1e-5, rtol=1e-5, err_msg=k)
    for label in ("sharded", "plain"):
        np.testing.assert_allclose(got[f"{case}/logits_{label}"],
                                   want[f"{case}/logits"], atol=1e-5,
                                   rtol=1e-5, err_msg=label)


# Whether the table moves (is gathered over the FSDP axes) on each mesh:
# its slice's rows (all codebooks') against a rank's B_local x T rows.
TABLE_MOVES = {
    ("vocab", "mesh1x2"): False, ("vocab", "mesh2x1"): False,
    ("vocab", "mesh2x2"): False, ("gathered", "mesh1x2"): True,
    ("gathered", "mesh2x1"): False, ("gathered", "mesh2x2"): True,
    ("columns", "mesh1x2"): False, ("columns", "mesh2x1"): False,
    ("columns", "mesh2x2"): False, ("whole", "mesh1x2"): False,
    ("whole", "mesh2x1"): False, ("whole", "mesh2x2"): False,
    ("codebooks", "mesh1x2"): False, ("codebooks", "mesh2x1"): False,
    ("codebooks", "mesh2x2"): False}


@pytest.mark.parametrize("case,mesh", CASES,
                         ids=[f"{c}-{m}" for c, m in CASES])
def test_sharded_embedding_is_in_the_batch_layout(sharded, case, mesh):
    """The embeddings (after the prefix) come out in the batch layout, B
    over "data" (B 4 divides it) and replicated over "model", so that
    `_batch_layout` moves nothing; the table moves where its slice is no
    larger than a rank's rows, else the rows move."""
    got = sharded(mesh)
    want = ["Shard(0)", "Replicate"]
    assert list(got[f"{case}/layout"]) == want
    assert list(got[f"{case}/batch_layout"]) == want
    assert bool(got[f"{case}/table_moves"]) == TABLE_MOVES[case, mesh]
