"""The port's invariant checker (`repro_torch.analysis.lint`) against the
reference's (`repro.analysis.lint`).

The framework is the reference's, so on the reference's RPR0xx-2xx
fixtures both give the same findings; both register the same 17 codes
(the reference lints the port's files too and rejects a suppression of a
code it does not know). The translated rules fire on torch fixtures under
tests/lint_fixtures/repro_torch/ and stay silent on their clean twins; the
device-program table covers every `jax.jit` / `pl.pallas_call` site of
the reference; a host sync or an f32 cast injected into the real
`decode_step` / `_pdhg_block` is caught; the committed port lints clean.
No jax: neither checker imports it.
"""
from __future__ import annotations

import ast
import collections
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import _ref_cpu  # noqa: F401  (pins the reference to the CPU)

from repro.analysis import lint as ref_lint
from repro.analysis.lint.registry import known_code_prefixes as ref_known_codes
from repro_torch.analysis.lint import (all_rules, lint_file, lint_source,
                                       run_paths)
from repro_torch.analysis.lint.checkers import jit_purity
from repro_torch.analysis.lint.suppress import parse_suppressions

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src"
PORT = SRC / "repro_torch"
LINT = PORT / "analysis" / "lint"
REF_LINT = SRC / "repro" / "analysis" / "lint"
FIXTURES = REPO / "tests" / "lint_fixtures"
TORCH_FIX = FIXTURES / "repro_torch"

DECODER = "x/repro_torch/models/decoder.py"
DECODE_KERNEL = "x/repro_torch/kernels/decode_attention/kernel.py"


def found(report) -> list[tuple[str, int, int]]:
    return [(d.rule, d.line, d.col) for d in report.diagnostics]


def lint_fixture(rel: str, posix: str | None):
    """A torch fixture, linted at its own path or under `posix` (the path
    of the port file whose device-program entry it mimics)."""
    path = TORCH_FIX / rel
    if posix is None:
        return lint_file(path)
    return lint_source(path.read_text(), display=str(path), posix=posix)


# ------------------------------------------------------------- framework

# The framework files are the reference's, but for the package name in
# their docstrings and the CLI's program name.
RENAMES = (("repro.analysis.lint", "repro_torch.analysis.lint"),
           ("`repro.planner.registry`", "`repro_torch.planner.registry`"),
           ("`repro.core.contracts`", "`repro_torch.core.contracts`"))


@pytest.mark.parametrize("rel", [
    "__main__.py", "cli.py", "diagnostics.py", "registry.py", "runner.py",
    "suppress.py", "checkers/__init__.py", "checkers/state_mutation.py"])
def test_framework_file_is_the_reference_s(rel):
    want = (REF_LINT / rel).read_text()
    for old, new in RENAMES:
        want = want.replace(old, new)
    assert (LINT / rel).read_text() == want


def test_rule_codes_equal_the_reference_s():
    assert [r.code for r in all_rules()] \
        == [r.code for r in ref_lint.all_rules()]
    assert len(all_rules()) == 17       # RPR000-003 and the 13 checker codes


@pytest.mark.parametrize("fixture", sorted(
    p.name for p in (FIXTURES / "repro" / "core").glob("*.py")))
def test_reference_core_fixtures_give_the_reference_s_findings(fixture):
    """RPR0xx (suppressions), 1xx (state mutation) and 2xx (determinism):
    the same (rule, line, col) list from both checkers, the port's given
    the fixture at its repro_torch/ path."""
    src = (FIXTURES / "repro" / "core" / fixture).read_text()
    want = ref_lint.lint_source(src, display=fixture,
                                posix=f"x/repro/core/{fixture}")
    got = lint_source(src, display=fixture,
                      posix=f"x/repro_torch/core/{fixture}")
    assert found(got) == found(want)
    assert [s.reason for _, s in got.suppressed] \
        == [s.reason for _, s in want.suppressed]


# --------------------------------------------------------- torch fixtures

BAD = {
    # fixture: (posix to lint it under, or None for its own path; counts)
    "core/bad_determinism.py": (None, {"RPR201": 6}),
    "core/tier_bad_dtype.py": (None, {"RPR301": 3, "RPR302": 4}),
    "risk/bad_dtype.py": (None, {"RPR301": 2, "RPR302": 1}),
    "models/bad_decode_step.py": (DECODER, {"RPR401": 3, "RPR402": 3,
                                            "RPR403": 1}),
    "kernels/bad_launcher.py": (DECODE_KERNEL, {"RPR401": 1, "RPR402": 2}),
}
CLEAN = {
    "core/clean_determinism.py": None,
    "core/tier_clean_dtype.py": None,
    "risk/clean_dtype.py": None,
    "models/clean_decode_step.py": DECODER,
    "kernels/clean_launcher.py": DECODE_KERNEL,
}


@pytest.mark.parametrize("rel", sorted(BAD))
def test_torch_rules_fire_on_bad_fixtures(rel):
    posix, want = BAD[rel]
    got = collections.Counter(d.rule for d in lint_fixture(rel,
                                                           posix).diagnostics)
    assert dict(got) == want


@pytest.mark.parametrize("rel", sorted(CLEAN))
def test_torch_rules_stay_silent_on_clean_twins(rel):
    assert found(lint_fixture(rel, CLEAN[rel])) == []


@pytest.mark.parametrize("posix,want", [
    ("x/repro_torch/models/free.py", []),           # out of every scope
    ("x/repro_torch/kernels/k.py", ["RPR301"]),     # f32 allowed, 301 not
    ("x/repro_torch/core/tier_kernels.py", ["RPR301", "RPR302"]),
    ("x/repro_torch/risk/solver.py", ["RPR301", "RPR302"]),
])
def test_dtype_rules_are_path_scoped(posix, want):
    src = ("import torch\n\ndef f(x):\n"
           "    return torch.zeros(3), x.to(torch.float32)\n")
    assert [d.rule for d in lint_source(src, display="s.py",
                                        posix=posix).diagnostics] == want


def test_torch_determinism_is_path_scoped():
    src = (TORCH_FIX / "core/bad_determinism.py").read_text()
    assert found(lint_source(src, display="m.py",
                             posix="x/repro_torch/models/m.py")) == []


def test_rpr303_finds_no_torch_hazard():
    """RPR303 stays registered and fires on nothing: a Python float in a
    torch op is a wrapped number that never decides the dtype, so an f64
    program stays f64; the float only becomes an f32 tensor when made one
    on its own, which RPR301 flags."""
    assert "RPR303" in {r.code for r in all_rules()}
    src = (FIXTURES / "repro/core/xla/bad_dtype.py").read_text()
    ref = ref_lint.lint_source(src, display="d.py",
                               posix="x/repro/core/xla/d.py")
    assert "RPR303" in [d.rule for d in ref.diagnostics]
    torch_src = ("import torch\n\ndef _candidate_kernel(v, s):\n"
                 "    return v * s\n\ndef caller(v):\n"
                 "    return _candidate_kernel(v, 0.5), torch.tensor(0.5)\n")
    got = lint_source(torch_src, display="r.py",
                      posix="x/repro_torch/risk/solver.py")
    assert [d.rule for d in got.diagnostics] == ["RPR301"]
    f64 = torch.ones(3, dtype=torch.float64)
    assert (f64 * 0.5).dtype == torch.float64
    assert torch.where(f64 > 0, f64, 1.0).dtype == torch.float64
    assert torch.tensor(0.5).dtype == torch.float32


# --------------------------------------------------------- device programs

def _reference_device_sites() -> set[str]:
    """Every `jax.jit` (a call, a decorator, `functools.partial(jax.jit,
    ...)`) and `pl.pallas_call` site of src/repro, as path:line."""
    sites = set()
    for f in sorted((SRC / "repro").rglob("*.py")):
        rel = f.relative_to(REPO).as_posix()
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Call) and ast.unparse(node.func) in (
                    "jax.jit", "pl.pallas_call"):
                sites.add(f"{rel}:{node.lineno}")
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    if ast.unparse(dec) == "jax.jit" or (
                            isinstance(dec, ast.Call)
                            and ast.unparse(dec.func) == "functools.partial"
                            and dec.args
                            and ast.unparse(dec.args[0]) == "jax.jit"):
                        sites.add(f"{rel}:{dec.lineno}")
    return sites


def test_every_reference_device_site_has_a_counterpart():
    sites = _reference_device_sites()
    assert len(sites) == 19     # 15 jax.jit + 4 pl.pallas_call
    tabled = {s for p in jit_purity.DEVICE_PROGRAMS for s in p.stands_for}
    without = {s for s, why in jit_purity.NO_COUNTERPART if why}
    assert sites - tabled - without == set()
    assert (tabled | without) - sites == set()      # no stale site


@pytest.mark.parametrize("program", jit_purity.DEVICE_PROGRAMS,
                         ids=lambda p: f"{p.path}:{p.functions[0]}")
def test_device_program_table_names_real_functions(program):
    tree = ast.parse((PORT / program.path).read_text())
    defs = jit_purity._qualified_defs(tree)
    assert set(program.functions) <= set(defs)


INJECT = {
    "decode_step .item()": (
        "models/decoder.py", DECODER,
        "    h = _run_layers(params, cfg, x, cache, int(pos), use_kernels)\n",
        "    n = tokens.max().item()\n", "RPR402"),
    "_VocabParallelNLL.backward .item()": (
        "models/layers.py", "x/repro_torch/models/layers.py",
        "        x, head, tc, logz = ctx.saved_tensors\n",
        "        n = g.item()\n", "RPR402"),
    "_VocabParallelEmbed.backward .item()": (
        "models/layers.py", "x/repro_torch/models/layers.py",
        "        (t,) = ctx.saved_tensors\n", "        n = g.sum().item()\n",
        "RPR402"),
    "merge_decode_parts .item()": (
        "models/layers.py", "x/repro_torch/models/layers.py",
        "    lse = lse.float()\n", "    n = lse.max().item()\n", "RPR402"),
    "_hd_split_decode .item()": (
        "models/layers.py", "x/repro_torch/models/layers.py",
        "    return hd_slice_attend(s, vc, pos, k_pos, scale, use_kernels)\n",
        "    n = s.max().item()\n", "RPR402"),
    "hd_slice_attend .item()": (
        "models/layers.py", "x/repro_torch/models/layers.py",
        "    B, KV, G, _ = s.shape\n", "    n = s.max().item()\n", "RPR402"),
    "decode_softmax_pv_hd launcher .item()": (
        "kernels/decode_attention_hd/kernel.py",
        "x/repro_torch/kernels/decode_attention_hd/kernel.py",
        "    n_split, split_len = split(B, KV, S, _n_sm(v.device))\n",
        "    n = k_pos.max().item()\n", "RPR402"),
    "_pdhg_block torch.float32": (
        "risk/solver.py", "x/repro_torch/risk/solver.py",
        "    tau = tau0 / omega[:, None]\n",
        "    vs = vs.to(torch.float32)\n", "RPR302"),
}


@pytest.mark.parametrize("name", sorted(INJECT))
def test_injected_host_sync_and_f32_cast_are_caught(name):
    rel, posix, anchor, line, rule = INJECT[name]
    src = (PORT / rel).read_text()
    assert src.count(anchor) == 1
    before = lint_source(src, display=rel, posix=posix)
    assert found(before) == []
    at = src[:src.index(anchor)].count("\n") + 1
    bad = src.replace(anchor, line + anchor)
    got = lint_source(bad, display=rel, posix=posix)
    assert [(d.rule, d.line) for d in got.diagnostics] == [(rule, at)]


# ---------------------------------------------------------- committed tree

def test_port_tree_lints_clean():
    result = run_paths([PORT])
    assert result.exit_code == 0, "\n".join(
        d.format() for d in result.diagnostics)
    assert result.files_checked > 100
    supps = [s for r in result.reports for _, s in r.suppressed]
    assert all(s.reason for s in supps)
    engine = [d for r in result.reports for d, _ in r.suppressed
              if r.display.endswith("serving/engine.py")]
    assert [d.rule for d in engine] == ["RPR402", "RPR402"]


def test_port_suppresses_only_codes_the_reference_knows():
    known = ref_known_codes()
    codes = set()
    for f in sorted(PORT.rglob("*.py")):
        supps, bad = parse_suppressions(str(f), f.read_text())
        assert bad == [], f
        codes.update(c for s in supps for c in s.codes)
    assert codes and codes <= known


# ---------------------------------------------------------------------- CLI

def run_cli(*argv: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", *argv],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})


@pytest.mark.parametrize("args,rc,shown,hidden", [
    (("src/repro_torch",), 0, (), ("RPR",)),
    (("tests/lint_fixtures/repro_torch/core/bad_determinism.py",), 1,
     ("RPR201",), ()),
    (("tests/lint_fixtures/repro_torch/core/tier_bad_dtype.py", "--select",
      "RPR302"), 1, ("RPR302",), ("RPR301",)),
    (("tests/lint_fixtures/repro_torch/core/tier_bad_dtype.py", "--select",
      "RPR4"), 0, (), ("RPR30",)),
    (("--list-rules",), 0, ("RPR000", "RPR101", "RPR201", "RPR301",
                            "RPR303", "RPR401", "RPR403"), ()),
])
def test_cli_exit_codes_select_and_list_rules(args, rc, shown, hidden):
    out = run_cli(*args)
    assert out.returncode == rc, out.stdout + out.stderr
    for code in shown:
        assert code in out.stdout
    for code in hidden:
        assert code not in out.stdout


def test_cli_summary_json(tmp_path):
    dest = tmp_path / "summary.json"
    run_cli("tests/lint_fixtures/repro_torch/core/tier_bad_dtype.py",
            "--summary-json", str(dest))
    data = json.loads(dest.read_text())
    assert data["by_rule"] == {"RPR301": 3, "RPR302": 4}
