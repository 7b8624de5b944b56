"""The port's tests compute the JAX reference's answers on the CPU.

Every port test module that imports jax or the reference (`repro`) in its
own process imports `_ref_cpu` first, which pins jax to its CPU backend
before any backend starts; a module run with no `JAX_PLATFORMS` in its
environment still computes the reference on the CPU; and a backend of
another platform, started before the pin, is refused.
"""
import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import _ref_cpu

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
PORT_TESTS = sorted(p.name for p in TESTS.glob("test_torch_*.py"))


def _reference_imports(tree: ast.Module) -> list[ast.AST]:
    """The module's statements, at any depth, that import jax or `repro`
    or ask pytest for jax."""
    out = []
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            names = [a.name for a in n.names]
        elif isinstance(n, ast.ImportFrom) and n.level == 0:
            names = [n.module]
        elif (isinstance(n, ast.Call)
              and ast.unparse(n.func) == "pytest.importorskip"):
            names = [ast.literal_eval(n.args[0])]
        else:
            continue
        if any(m.split(".")[0] in ("jax", "repro") for m in names):
            out.append(n)
    return out


@pytest.mark.parametrize("name", PORT_TESTS)
def test_port_test_module_pins_before_it_imports_the_reference(name):
    """A module that reaches jax or `repro` in its own process imports
    `_ref_cpu` at its top level, above every such import."""
    tree = ast.parse((TESTS / name).read_text())
    uses = _reference_imports(tree)
    pins = [n.lineno for n in tree.body if isinstance(n, ast.Import)
            and [a.name for a in n.names] == ["_ref_cpu"]]
    if not uses:
        assert name == "test_torch_cuda.py", name
        return
    assert len(pins) == 1, name
    assert pins[0] < min(n.lineno for n in uses), name


def test_a_module_run_without_jax_platforms_computes_on_the_cpu():
    """`tests/test_torch_decode_merge.py`, imported and run in a process
    whose environment has no `JAX_PLATFORMS`: its test that computes the
    reference's decode attention runs, and jax's backend there is the
    CPU's, by the pin alone."""
    code = """
        import json, os, sys
        assert "JAX_PLATFORMS" not in os.environ
        sys.path.insert(0, TESTS)
        import torch
        torch.set_num_threads(1)
        import test_torch_decode_merge as m
        m.test_merge_of_slot_ranges_is_the_whole_cache("flat", 20, 4)
        import jax
        print(json.dumps(dict(backend=jax.default_backend(),
                              platforms=jax.config.jax_platforms,
                              devices=[d.platform for d in jax.devices()],
                              env=os.environ.get("JAX_PLATFORMS"))))
    """.replace("TESTS", repr(str(TESTS)))
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env.update(PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == dict(backend="cpu", platforms="cpu", devices=["cpu"],
                       env="cpu"), got


def test_reference_in_this_process_is_on_the_cpu():
    jax = pytest.importorskip("jax")
    _ref_cpu.pin()
    assert os.environ["JAX_PLATFORMS"] == "cpu"
    assert jax.config.jax_platforms == "cpu"
    assert jax.default_backend() == "cpu"


@pytest.mark.parametrize("platforms,default", [
    ({"cpu", "gpu"}, "gpu"), ({"gpu"}, "gpu"), ({"cpu", "cuda"}, "cpu"),
    ({"tpu"}, "tpu")])
def test_a_backend_started_elsewhere_is_refused(platforms, default):
    """A backend of another platform, started before the pin, fails the
    pin: the reference's numbers would come from that device."""
    with pytest.raises(RuntimeError, match="before the reference was pinned"):
        _ref_cpu.check_started(platforms, default)
    _ref_cpu.check_started({"cpu"}, "cpu")
