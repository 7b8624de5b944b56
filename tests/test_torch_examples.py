"""The two example drivers' port twins on the CPU, as subprocesses.

`examples/serve_e2e_torch.py` plans, deploys and serves through
`repro_torch`: its plan and pair lines are those of the reference's
`examples/serve_e2e.py` on the same flags (the plan's wall time aside),
and it prints an attainment line for each query type it served.
`examples/train_demo_torch.py` builds the reference demo's ~100M f32
config (the same parameter count) and its loss falls. Both refuse to run
without a card unless `--device cpu` is given.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"
SERVE_FLAGS = ("--requests", "4", "--new-tokens", "4")


def run(script: str, *args: str, jax: bool = False
        ) -> subprocess.CompletedProcess:
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", "/tmp"), "OMP_NUM_THREADS": "2"}
    if jax:
        env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, str(EXAMPLES / script), *args],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=300, env=env)


def plan_lines(stdout: str) -> list[str]:
    """The [plan] line (its wall time masked) and the pair lines under it."""
    lines = stdout.splitlines()
    at = next(i for i, line in enumerate(lines) if line.startswith("[plan]"))
    out = [re.sub(r"AGH in [0-9.]+s", "AGH in <wall>s", lines[at])]
    for line in lines[at + 1:]:
        if not line.startswith("  "):
            break
        out.append(line)
    return out


@pytest.fixture(scope="module")
def serve_runs():
    pytest.importorskip("jax")
    port = run("serve_e2e_torch.py", *SERVE_FLAGS, "--device", "cpu")
    ref = run("serve_e2e.py", *SERVE_FLAGS, jax=True)
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    return port.stdout, ref.stdout


def test_serve_twin_plans_the_reference_s_fleet(serve_runs):
    port, ref = serve_runs
    got = plan_lines(port)
    assert got == plan_lines(ref)
    assert len(got) == 3        # the [plan] line and two deployed pairs
    assert "llama3-8b @ RTX4090-INT4 TP=4" in got[1]
    assert "llama3-34b @ RTX4090-INT4 TP=2" in got[2]


def test_serve_twin_serves_and_reports_attainment(serve_runs):
    port, ref = serve_runs
    assert "[deploy] 2 engines up on cpu" in port
    served = re.search(r"\[serve\] 4 requests, (\d+) tokens", port)
    assert served and int(served.group(1)) == 4 * 4
    attain = re.findall(r"^  (\S+)\s+TTFT p50=\s*[0-9.]+ms  \(plan SLO "
                        r"[0-9.]+s\)$", port, flags=re.M)
    want = re.findall(r"^  (\S+)\s+TTFT p50=", ref, flags=re.M)
    assert attain and attain == want    # same routing, same types served
    # on the CPU the plain versions run: no kernel launches
    assert "[kernels] flash_attention=0 decode_attention=0" in port


def test_train_twin_builds_the_reference_config_and_learns(tmp_path):
    from repro.configs import get_config
    cfg = dataclasses.replace(
        get_config("qwen2-0.5b"),
        name="qwen2-100m", n_layers=12, d_model=512, n_heads=8,
        n_kv_heads=2, head_dim=64, d_ff=2048, vocab_size=32768,
        dtype="float32", loss_chunk=128)
    out = run("train_demo_torch.py", "--steps", "3", "--batch", "2",
              "--seq", "64", "--device", "cpu", "--ckpt",
              str(tmp_path / "ckpt"))
    assert out.returncode == 0, out.stderr
    assert f"params={cfg.param_count()/1e6:.1f}M" in out.stdout
    m = re.search(r"loss: ([0-9.]+) -> ([0-9.]+) over 3 steps", out.stdout)
    assert m and float(m.group(2)) < float(m.group(1))


@pytest.mark.parametrize("script", ["serve_e2e_torch.py",
                                    "train_demo_torch.py"])
def test_twins_raise_without_a_card(script):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = run(script, "--steps", "1") if script.startswith("train") \
        else run(script)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr


@pytest.mark.parametrize("script", ["serve_e2e_torch.py",
                                    "train_demo_torch.py"])
def test_twins_import_neither_jax_nor_the_reference(script):
    tree = ast.parse((EXAMPLES / script).read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "repro"}
