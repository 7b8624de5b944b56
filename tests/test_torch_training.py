"""The port's training path against the JAX package's, on the CPU: AdamW
(schedule, global norm, one update), the data stream, checkpoints in both
directions, the train loop's history, resuming from a checkpoint, and the
guards of what does not train.

Tolerances: AdamW rtol 1e-6 in f32 (the same operations in the same
order; transcendental functions may differ by an ulp), bf16 parameters
bit for bit (one rounding of the same f32 value); the data stream and
checkpoints bit for bit; the 5-step loss and grad-norm history rtol 1e-4
(five steps of f32 training, each a few thousand reductions in another
order). The reference runs with 64-bit types off (`jax.enable_x64(False)`):
another test file in the same process may have turned them on.
"""
import dataclasses
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro_torch  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import decoder as ref_decoder  # noqa: E402
from repro.training import checkpoint as ref_checkpoint  # noqa: E402
from repro.training import data as ref_data  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro.training.train_loop import train as ref_train  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import decoder  # noqa: E402
from repro_torch.models.weights import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)
from repro_torch.training import checkpoint, data, optimizer  # noqa: E402
from repro_torch.training.train_loop import (as_trainable,  # noqa: E402
                                              batch_on, make_train_step,
                                              train)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
NEW_MODULES = ("repro_torch.training", "repro_torch.training.data",
               "repro_torch.training.optimizer",
               "repro_torch.training.checkpoint",
               "repro_torch.training.train_loop",
               "repro_torch.launch.train", "repro_torch.kernels._grad",
               "repro_torch.kernels.flash_attention_bwd.kernel",
               "repro_torch.kernels.flash_attention_bwd.ops",
               "repro_torch.kernels.flash_attention_bwd.ref")


@pytest.fixture(autouse=True)
def _x64_off():
    with jax.enable_x64(False):
        yield


def _bf16_bits(a) -> np.ndarray:
    """A bf16 array (ml_dtypes, `V2` void or torch) as its uint16 bits."""
    if isinstance(a, torch.Tensor):
        return a.detach().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


# ------------------------------------------------------------------ AdamW

OPT = dict(lr=3e-3, warmup_steps=10, total_steps=100, grad_clip=1.0)


@pytest.mark.parametrize("step", [0, 9, 10, 55, 100])
def test_schedule_matches_reference(step):
    ref_cfg, cfg = ref_opt.AdamWConfig(**OPT), optimizer.AdamWConfig(**OPT)
    want = ref_opt.schedule(ref_cfg, jnp.int32(step))
    got = optimizer.schedule(cfg, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


SHAPES = dict(w=(6, 5), b=(7,), wb=(4, 9), nb=(5,), n=dict(v=(3, 2, 4)))
# Leaves of odd sizes spanning several pieces of 1,000 elements (a short
# last piece), f32 and bf16, a matrix and a vector.
LARGE = dict(SHAPES, big=(41, 103), bigb=(37, 109), vec=(2_503,))


def _opt_tree(rng, grad_scale, shapes=SHAPES):
    """Parameters (f32 and bf16, 1-D and 2-D), gradients and a state after
    a few steps, as numpy f32 (bf16 leaves' values already bf16)."""
    bf16 = {"wb", "nb", "bigb"}

    def tree(fn, shp=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(k, v)
                for k, v in shp.items()}

    def rnd(k, shp, scale=1.0):
        x = (scale * rng.normal(size=shp)).astype(np.float32)
        if k in bf16:
            x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        return x

    params = tree(rnd)
    grads = tree(lambda k, s: rnd(k, s, grad_scale))
    mu = tree(lambda k, s: (0.01 * rng.normal(size=s)).astype(np.float32))
    nu = tree(lambda k, s: (1e-4 * rng.random(size=s)).astype(np.float32))
    return params, grads, mu, nu, bf16


def _to_jax(tree, bf16):
    return {k: _to_jax(v, bf16) if isinstance(v, dict) else
            jnp.asarray(v, jnp.bfloat16 if k in bf16 else jnp.float32)
            for k, v in tree.items()}


def _to_torch(tree, bf16):
    return {k: _to_torch(v, bf16) if isinstance(v, dict) else
            torch.from_numpy(np.array(v)).to(
                torch.bfloat16 if k in bf16 else torch.float32)
            for k, v in tree.items()}


def _check_apply_updates(grad_scale, shapes=SHAPES, change_rtol=0.0):
    """One update of the port against the reference's on the same tree:
    in place (the returned weights and moments are the tensors given,
    their storage too), bf16 weights bit for bit, f32 at rtol 1e-6 (plus
    `change_rtol` of each element's change in the step)."""
    rng = np.random.default_rng(7)
    params, grads, mu, nu, bf16 = _opt_tree(rng, grad_scale, shapes)
    ref_cfg, cfg = ref_opt.AdamWConfig(**OPT), optimizer.AdamWConfig(**OPT)
    f32 = set()                 # the moments are f32 for every leaf
    w_p, w_s, w_m = ref_opt.apply_updates(
        ref_cfg, _to_jax(params, bf16), _to_jax(grads, bf16),
        dict(mu=_to_jax(mu, f32), nu=_to_jax(nu, f32), step=jnp.int32(12)))
    given = dict(params=_to_torch(params, bf16),
                 mu=_to_torch(mu, f32), nu=_to_torch(nu, f32))
    ptrs = {k: [t.data_ptr() for t in optimizer.leaves(v)]
            for k, v in given.items()}
    objs = {k: optimizer.leaves(v) for k, v in given.items()}
    state = dict(mu=given["mu"], nu=given["nu"],
                 step=torch.tensor(12, dtype=torch.int32))
    g_p, g_s, g_m = optimizer.apply_updates(
        cfg, given["params"], _to_torch(grads, bf16), state)
    assert g_p is given["params"] and g_s is state
    for k, tree in (("params", g_p), ("mu", g_s["mu"]), ("nu", g_s["nu"])):
        out = optimizer.leaves(tree)
        assert all(a is b for a, b in zip(out, objs[k], strict=True)), k
        assert [t.data_ptr() for t in out] == ptrs[k], k
    clipped = float(w_m["grad_norm"]) > OPT["grad_clip"]
    assert clipped == (grad_scale > 1)
    np.testing.assert_allclose(g_m["grad_norm"].item(),
                               float(w_m["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(g_m["lr"].item(), float(w_m["lr"]), rtol=1e-6)
    assert int(g_s["step"]) == int(w_s["step"]) == 13
    got, want = optimizer.leaves(g_p), jax.tree.leaves(w_p)
    names = sorted(shapes)
    old = {"params": params, "mu": mu, "nu": nu}

    def close(key, k, g, w, atol, name):
        """|g - w| <= atol + 1e-6 |w| (+ change_rtol of the change)."""
        w = np.asarray(w)
        atol = atol + change_rtol * np.abs(w - jax.tree.leaves(old[key])[k])
        bad = ~np.isclose(g.numpy(), w, rtol=1e-6, atol=atol)
        assert not bad.any(), (name, int(bad.sum()), g.numpy()[bad][:4],
                               w[bad][:4])

    for k, (name, g, w) in enumerate(zip(names, got, want, strict=True)):
        if g.dtype == torch.bfloat16:
            assert np.array_equal(_bf16_bits(g), _bf16_bits(w)), name
        else:
            close("params", k, g, w, 0.0, name)
    for key in ("mu", "nu"):
        for k, (g, w) in enumerate(zip(optimizer.leaves(g_s[key]),
                                       jax.tree.leaves(w_s[key]),
                                       strict=True)):
            assert g.dtype == torch.float32
            close(key, k, g, w, 1e-12, f"{key} {names[k]}")


@pytest.mark.parametrize("grad_scale", [10.0, 0.01], ids=["clipped",
                                                           "unclipped"])
def test_apply_updates_matches_reference(grad_scale):
    _check_apply_updates(grad_scale)


@pytest.mark.parametrize("grad_scale", [10.0, 0.001], ids=["clipped",
                                                            "unclipped"])
def test_apply_updates_in_pieces_matches_reference(grad_scale, monkeypatch):
    """Leaves larger than a piece (1,000 elements here) are updated a
    piece at a time over their flat storage: the reference's whole-leaf
    values. f32 elements also take 1e-6 of their change in the step:
    clipped, the port's and the reference's global norms sum in other
    orders and differ in their last bits, which moves each change by
    ~1e-7 of itself, and among these ~12,000 elements some weights and
    moments land near zero, where that is more than 1e-6 of the value."""
    monkeypatch.setattr(optimizer, "PIECE", 1000)
    assert len(optimizer._pieces(torch.zeros(LARGE["vec"]))) == 3
    _check_apply_updates(grad_scale, LARGE, change_rtol=1e-6)


def test_global_norm_and_state_match_reference():
    rng = np.random.default_rng(1)
    params, grads, _, _, bf16 = _opt_tree(rng, 3.0)
    np.testing.assert_allclose(
        optimizer.global_norm(_to_torch(grads, bf16)).item(),
        float(ref_opt.global_norm(_to_jax(grads, bf16))), rtol=1e-6)
    state = optimizer.init_state(_to_torch(params, bf16))
    want = ref_opt.init_state(_to_jax(params, bf16))
    for g, w in zip(optimizer.leaves(state["mu"]),
                    jax.tree.leaves(want["mu"]), strict=True):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert not g.any()
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("n_codebooks", [0, 4])
def test_data_stream_matches_reference(n_codebooks):
    kw = dict(vocab_size=997, seq_len=130, batch_size=3,
              n_codebooks=n_codebooks, seed=5)
    ref = ref_data.PackedStream(ref_data.DataConfig(**kw))
    got = data.PackedStream(data.DataConfig(**kw))
    for step in (0, 7):
        a, b = got.batch(step), ref.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


# ------------------------------------------------------------ train loop

def _qwen_smoke():
    ref_cfg, cfg = (ref_get_config("qwen2-0.5b").smoke(),
                    get_config("qwen2-0.5b").smoke())
    tree = jax.tree.map(np.asarray, ref_decoder.init_params(
        jax.random.PRNGKey(0), ref_cfg))
    return ref_cfg, cfg, tree


def _stream(cfg, mod):
    return mod.PackedStream(mod.DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=64, batch_size=4))


TRAIN_OPT = dict(lr=3e-3, total_steps=5, warmup_steps=1)


def test_train_loop_matches_reference_history():
    """5 steps from the reference's initial params on the same stream:
    the loss and grad-norm histories agree, and the loss falls by more
    than 0.2 (the reference's own criterion)."""
    ref_cfg, cfg, tree = _qwen_smoke()
    _, want = ref_train(ref_cfg, ref_opt.AdamWConfig(**TRAIN_OPT),
                        _stream(cfg, ref_data), 5, log_every=1,
                        params=jax.tree.map(jnp.asarray, tree))
    _, got = train(cfg, optimizer.AdamWConfig(**TRAIN_OPT),
                   _stream(cfg, data), 5, log_every=1,
                   params=params_from_numpy(tree, cfg, "cpu"), device="cpu")
    assert [h.keys() for h in got] == [h.keys() for h in want]
    assert [h["step"] for h in got] == list(range(5))
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose([h[key] for h in got],
                                   [h[key] for h in want], rtol=1e-4,
                                   err_msg=key)
    assert got[-1]["loss"] < got[0]["loss"] - 0.2


def test_train_step_returns_its_input_objects():
    """The step consumes its params and optimizer state as the reference's
    donated jit does: it returns the same objects, updated in place, the
    weights still leaves that require a gradient."""
    _, cfg, tree = _qwen_smoke()
    params = as_trainable(params_from_numpy(tree, cfg, "cpu"))
    state = optimizer.init_state(params)
    before = [t.detach().clone() for t in optimizer.leaves(params)]
    objs = [optimizer.leaves(params), optimizer.leaves(state["mu"]),
            optimizer.leaves(state["nu"]), state["step"]]
    step = make_train_step(cfg, optimizer.AdamWConfig(**TRAIN_OPT))
    batch = batch_on(_stream(cfg, data).batch(0), torch.device("cpu"))
    p, s, m = step(params, state, batch)
    assert p is params and s is state and s["step"] is objs[3]
    assert int(s["step"]) == 1 and np.isfinite(float(m["loss"]))
    for k, tree in enumerate((p, s["mu"], s["nu"])):
        assert all(a is b for a, b in zip(optimizer.leaves(tree), objs[k],
                                          strict=True))
    for t, old in zip(optimizer.leaves(p), before, strict=True):
        assert t.is_leaf and t.requires_grad
    assert any(not torch.equal(t.detach(), old)
               for t, old in zip(optimizer.leaves(p), before))


def test_train_updates_the_trees_it_is_handed():
    """Three `train` steps from handed params and optimizer state: the
    history equals the reference's (as the 5-step test), the returned
    state is the handed dict and the returned weights the handed tensors'
    storage, now holding the step-3 weights."""
    ref_cfg, cfg, tree = _qwen_smoke()
    _, want = ref_train(ref_cfg, ref_opt.AdamWConfig(**TRAIN_OPT),
                        _stream(cfg, ref_data), 3, log_every=1,
                        params=jax.tree.map(jnp.asarray, tree))
    params = params_from_numpy(tree, cfg, "cpu")
    state = optimizer.init_state(params)
    ptrs = [t.data_ptr() for t in optimizer.leaves(params)]
    got_p, got, got_s = train(cfg, optimizer.AdamWConfig(**TRAIN_OPT),
                              _stream(cfg, data), 3, log_every=1,
                              params=params, opt_state=state, device="cpu",
                              return_state=True)
    assert got_s is state and int(state["step"]) == 3
    assert [t.data_ptr() for t in optimizer.leaves(got_p)] == ptrs
    assert all(torch.equal(a.detach(), b) for a, b in zip(
        optimizer.leaves(got_p), optimizer.leaves(params), strict=True))
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose([h[key] for h in got],
                                   [h[key] for h in want], rtol=1e-4,
                                   err_msg=key)


def test_resume_from_checkpoint_equals_uninterrupted(tmp_path):
    """Steps 4-5 after restoring the step-3 checkpoint equal those of an
    uninterrupted run (the stream is pure in the step)."""
    _, cfg, tree = _qwen_smoke()
    opt = optimizer.AdamWConfig(**TRAIN_OPT)
    run = dict(log_every=1, device="cpu")
    _, full = train(cfg, opt, _stream(cfg, data), 5,
                    params=params_from_numpy(tree, cfg, "cpu"), **run)
    ck = str(tmp_path / "ck")
    train(cfg, opt, _stream(cfg, data), 3, ckpt_path=ck, ckpt_every=3,
          params=params_from_numpy(tree, cfg, "cpu"), **run)
    saved, meta = checkpoint.restore(ck, "cpu")
    assert meta == dict(step=3, arch=cfg.name)
    _, rest = train(cfg, opt, _stream(cfg, data), 5,
                    params=saved["params"], opt_state=saved["opt_state"],
                    **run)
    assert [h["step"] for h in rest] == [3, 4]
    for a, b in zip(rest, full[3:]):
        for key in ("loss", "grad_norm", "lr"):
            assert a[key] == b[key], key


# ------------------------------------------------------------ checkpoints

def _ckpt_tree(rng):
    """params with bf16 and f32 leaves and an AdamW state, numpy f32."""
    return dict(
        params=dict(embed=rng.normal(size=(11, 6)).astype(np.float32),
                    layers=dict(w=rng.normal(size=(2, 6, 6)).astype(
                        np.float32), ln=np.ones((2, 6), np.float32))),
        opt_state=dict(mu=dict(w=rng.normal(size=(2, 6, 6)).astype(
            np.float32)), step=np.int32(3)))


def _jax_tree(t):
    """bf16 for the params' matrices, as the reference keeps them."""
    p = t["params"]
    return dict(params=dict(
        embed=jnp.asarray(p["embed"], jnp.bfloat16),
        layers=dict(w=jnp.asarray(p["layers"]["w"], jnp.bfloat16),
                    ln=jnp.asarray(p["layers"]["ln"]))),
        opt_state=dict(mu=dict(w=jnp.asarray(t["opt_state"]["mu"]["w"])),
                       step=jnp.int32(3)))


def _torch_tree(t):
    p = t["params"]
    return dict(params=dict(
        embed=torch.from_numpy(p["embed"]).bfloat16(),
        layers=dict(w=torch.from_numpy(p["layers"]["w"]).bfloat16(),
                    ln=torch.from_numpy(p["layers"]["ln"]))),
        opt_state=dict(mu=dict(w=torch.from_numpy(t["opt_state"]["mu"]["w"])),
                       step=torch.tensor(3, dtype=torch.int32)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_reference_checkpoint_loads_into_the_port(tmp_path):
    want = _jax_tree(_ckpt_tree(np.random.default_rng(0)))
    ref_checkpoint.save(str(tmp_path), want, meta=dict(step=3, arch="x"))
    got, meta = checkpoint.restore(str(tmp_path), "cpu")
    assert meta == dict(step=3, arch="x")
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for name in w:
        wn = np.asarray(w[name])
        if wn.dtype.name == "bfloat16":
            assert g[name].dtype == torch.bfloat16, name
            assert np.array_equal(_bf16_bits(g[name]), _bf16_bits(wn)), name
        else:
            assert g[name].numpy().dtype == wn.dtype, name
            assert np.array_equal(g[name].numpy(), wn), name


def test_port_checkpoint_loads_into_the_reference(tmp_path):
    """The reference's restore hands bf16 leaves back as 2-byte void
    (`V2`, for its own checkpoints too): viewed as bf16 they are the
    port's bits."""
    tree = _torch_tree(_ckpt_tree(np.random.default_rng(1)))
    checkpoint.save(str(tmp_path), tree, meta=dict(step=3))
    got, meta = ref_checkpoint.restore(str(tmp_path))
    assert meta == dict(step=3)
    g, w = _flat(got), _flat(tree)
    assert g.keys() == w.keys()
    for name, t in w.items():
        if t.dtype == torch.bfloat16:
            assert g[name].dtype == np.dtype("V2"), name
            assert np.array_equal(_bf16_bits(g[name]), _bf16_bits(t)), name
        else:
            assert np.array_equal(g[name], t.numpy()), name
            assert g[name].dtype == t.numpy().dtype, name


def test_checkpoint_manifest_equals_reference(tmp_path):
    t = _ckpt_tree(np.random.default_rng(2))
    ref_checkpoint.save(str(tmp_path / "ref"), _jax_tree(t),
                        meta=dict(step=3), shard_mb=0)
    checkpoint.save(str(tmp_path / "port"), _torch_tree(t),
                    meta=dict(step=3), shard_mb=0)
    man = [json.loads((tmp_path / d / "manifest.json").read_text())
           for d in ("ref", "port")]
    assert man[0] == man[1]
    assert man[0]["n_shards"] > 1


def test_params_to_numpy_inverts_params_from_numpy():
    rng = np.random.default_rng(4)
    tree = dict(a=rng.normal(size=(3, 4)).astype(np.float32),
                b=dict(c=np.asarray(jnp.asarray(rng.normal(size=(5,)),
                                                jnp.bfloat16))))
    cfg = get_config("qwen2-0.5b").smoke()
    params = params_from_numpy(tree, cfg, "cpu")
    assert params["b"]["c"].dtype == torch.bfloat16
    back = params_to_numpy(params)
    assert np.array_equal(back["a"], tree["a"])
    assert back["b"]["c"].dtype == np.dtype("V2")
    assert np.array_equal(_bf16_bits(back["b"]["c"]), _bf16_bits(tree["b"]["c"]))
    again = params_from_numpy(back, cfg, "cpu")
    assert torch.equal(again["b"]["c"], params["b"]["c"])


# ----------------------------------------------------------------- guards

def test_w8a8_config_does_not_train():
    cfg = get_config("kimi-k2-1t-a32b").smoke()
    cfg = type(cfg)(**{**cfg.__dict__, "moe_w8a8": True})
    toks = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="int8"):
        decoder.train_loss({}, cfg, dict(tokens=toks, targets=toks))


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b"])
def test_recurrent_configs_refuse_cuda_kernels(arch):
    """The recurrent configs train on every device and path now that both
    scans have a backward kernel (the check no longer asks which device or
    path); the same config with W8A8 experts still raises. The name is
    the one this test had when the check refused them on CUDA."""
    cfg = get_config(arch).smoke()
    decoder.check_trainable(cfg)
    with pytest.raises(NotImplementedError, match="int8"):
        decoder.check_trainable(dataclasses.replace(cfg, moe_w8a8=True))


def test_launcher_trains_on_the_cpu(capsys):
    assert train_launcher.main(["--arch", "qwen2-0.5b", "--smoke",
                                "--device", "cpu", "--steps", "3",
                                "--seq", "32", "--batch", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2          # step 0 and the last step
    assert all(ln.startswith("step=") and "loss=" in ln
               and "grad_norm=" in ln for ln in lines)


STEP_LINE = (r"step=\s*(\d+) loss=[0-9.]+ grad_norm=[0-9.]+ "
             r"lr=[0-9.]+e[-+][0-9]+ wall=[0-9.]+s")


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "internvl2-26b",
                                  "musicgen-medium"])
def test_launcher_trains_the_moe_prefix_and_codebook_families(arch):
    """`python -m repro_torch.launch.train --smoke --device cpu --steps 3`
    as a user runs it: rc 0 and the lines of the reference launcher's
    format for the steps its loop logs (step 0 and the last: log_every is
    10 in both loops). Losses are not compared with the reference's
    launcher: the two draw their weights separately."""
    import re
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--smoke", "--device", "cpu", "--steps", "3"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    steps = [re.fullmatch(STEP_LINE, ln) for ln in lines]
    assert all(steps), lines
    assert [int(m.group(1)) for m in steps] == [0, 2]
    losses = [float(re.search(r"loss=([0-9.]+)", ln).group(1))
              for ln in lines]
    assert all(np.isfinite(losses))


def test_launcher_and_loop_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_launcher.main(["--arch", "qwen2-0.5b", "--smoke", "--steps",
                             "1"])
    cfg = get_config("qwen2-0.5b").smoke()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(cfg, optimizer.AdamWConfig(), _stream(cfg, data), 1)


def test_training_modules_import_without_jax():
    mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")]
    for m in NEW_MODULES:
        assert m in mods, m
    code = ("import importlib, sys; sys.modules['jax'] = None; "
            f"[importlib.import_module(m) for m in {list(NEW_MODULES)!r}]; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules); print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
