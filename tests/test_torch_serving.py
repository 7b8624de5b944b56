"""The port's serving engine and launcher, and the port's independence
from JAX: the engine emits the reference engine's greedy tokens for the
same batch and weights; the launcher runs on the CPU only when asked to;
no module of `repro_torch`, nor `chip_smoke.py`, imports jax or repro."""
import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _ref_cpu  # noqa: F401  (pins the reference to the CPU)

import repro_torch
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models.weights import params_from_numpy
from repro_torch.serving.engine import Engine, Request

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _requests(cfg, lens, new_tokens):
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, n
                                               ).astype(np.int32),
                    max_new_tokens=new_tokens)
            for i, n in enumerate(lens)]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "rwkv6-7b", "zamba2-7b"])
def test_engine_matches_reference_greedy_tokens(arch):
    """Mirror of test_training_serving's engine test, held against the
    reference engine: identical batch (ragged prompts, left-padded) and
    identical weights give identical greedy tokens. The prompts (8, 5,
    11) are shorter than both scans' chunks, which the reference needs."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as ref_get_config
    from repro.models import decoder as ref_decoder
    from repro.serving.engine import Engine as RefEngine
    from repro.serving.engine import Request as RefRequest

    ref_cfg, cfg = ref_get_config(arch).smoke(), get_config(arch).smoke()
    tree = jax.tree.map(np.asarray, ref_decoder.init_params(
        jax.random.PRNGKey(0), ref_cfg))
    lens, new = [8, 5, 11], 6
    want = RefEngine(ref_cfg, jax.tree.map(jax.numpy.asarray, tree),
                     max_len=48, max_batch=4).generate(
        [RefRequest(r.rid, r.prompt, r.max_new_tokens)
         for r in _requests(cfg, lens, new)])
    got = Engine(cfg, params_from_numpy(tree, cfg, "cpu"), max_len=48,
                 max_batch=4).generate(_requests(cfg, lens, new))
    for g, w in zip(got, want, strict=True):
        assert len(g.output) == new
        assert g.output == w.output
        assert g.first_token_s is not None and g.done_s is not None
        assert g.first_token_s <= g.done_s


def test_engine_rejects_what_it_cannot_serve():
    cfg = get_config("qwen2-0.5b").smoke()
    eng = serve.build_engine(cfg, torch.device("cpu"), seed=0, max_len=16,
                             max_batch=2)
    with pytest.raises(ValueError, match="max_batch"):
        eng.generate(_requests(cfg, [4, 4, 4], 2))
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(_requests(cfg, [12], 8))
    with pytest.raises(NotImplementedError):     # codebook tokens
        Engine(get_config("musicgen-medium").smoke(), eng.params, 16, 2)


def test_launcher_runs_on_cpu_when_asked(capsys):
    assert serve.main(["--smoke", "--device", "cpu", "--requests", "2",
                       "--prompt-len", "8", "--new-tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "AGH plan" in out and "served 2 requests" in out


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b"])
def test_launcher_serves_recurrent_archs_on_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "2", "--prompt-len", "70",
                       "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert f"served 2 requests on {arch}-smoke" in out


def test_launcher_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.resolve_device("cuda")


def _port_modules() -> list[str]:
    """Every module of the port but the `__main__` of a `python -m`
    entry point, which runs its program when imported."""
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")
        if not m.name.endswith(".__main__")]


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    for m in ("repro_torch.kernels.flash_attention.kernel",
              "repro_torch.planner.api", "repro_torch.risk.solver",
              "repro_torch.core.tier_tensors", "repro_torch.core.tier_kernels",
              "repro_torch.core.tier_engine", "repro_torch.core.forecast",
              "repro_torch.core.queueing", "repro_torch.core.evaluate",
              "repro_torch.core.rolling", "repro_torch.planner.session",
              "repro_torch.serving.types", "repro_torch.serving.router",
              "repro_torch.serving.stations", "repro_torch.serving.simulator",
              "repro_torch.serving.controller", "repro_torch.serving.driver",
              "repro_torch.models.moe",
              "repro_torch.kernels.int8_grouped_matmul.kernel",
              "repro_torch.kernels.int8_grouped_matmul.ops",
              "repro_torch.kernels.int8_grouped_matmul.ref",
              "repro_torch.launch.specs", "repro_torch.launch.dryrun",
              "repro_torch.launch.sweep", "repro_torch.analysis.op_stats",
              "repro_torch.analysis.roofline",
              "repro_torch.analysis.lint.cli",
              "repro_torch.analysis.lint.checkers.jit_purity"):
        assert m in mods, m
    code = ("import importlib, sys; sys.modules['jax'] = None; "
            f"[importlib.import_module(m) for m in {mods!r}]; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules); print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_planner_and_serving_layers_import_without_torch():
    """`import repro_torch.serving` and the lazy root exports (`plan`,
    `PlanSession`, `serve`, ...) are numpy-only: torch loads with the
    engine or the allocator tier, not before."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['torch'] = None; "
            "import repro_torch.serving, repro_torch.core.tier; "
            "from repro_torch import (plan, PlanSession, serve, ServeResult, "
            "TrafficSpec, ControllerSpec, Station); "
            "from repro_torch.planner import PlanOptions; "
            "from repro_torch.core import random_instance; "
            "plan(instance=random_instance(4, 3, 4, seed=0)); "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imports(path: Path) -> set[str]:
    """Top-level names of every absolute import in a Python file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_port_file_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        bad = _imports(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(REPO)} imports {sorted(bad)}"
