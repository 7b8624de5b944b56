"""The lint runner: file walk, checker dispatch, suppressions, baseline.

`run_paths` is the single entry both the CLI and the test-suite use.
Per file: parse, collect suppressions (malformed ones are diagnostics
themselves), run every in-scope checker, then filter — per-file ignores
first (the frozen scalar oracle is exempt wholesale), then inline
suppressions, then the baseline.  What survives is the exit-code-1 set.
"""
from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path
from typing import Iterable, Sequence

from .diagnostics import Diagnostic, fingerprint
from .registry import (FileContext, all_checkers, known_code_prefixes,
                       select_filter)
from .suppress import Suppression, effective_line, parse_suppressions

#: (posix substring, rule-code prefixes) pairs exempted wholesale.
#: `_scalar_ref.py` is the frozen scalar oracle — kept byte-stable as the
#: equivalence anchor, so it can neither adopt @mutates decorators nor
#: carry suppression comments; its direct State writes ARE the reference
#: semantics the mutators are checked against.
PER_FILE_IGNORES: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("repro/core/_scalar_ref.py", ("RPR",)),
)

#: meta rules (suppression hygiene / parse errors) are never suppressible
_UNSUPPRESSIBLE = ("RPR000", "RPR001", "RPR002", "RPR003")


@dataclasses.dataclass
class FileReport:
    display: str
    diagnostics: list[Diagnostic]
    suppressed: list[tuple[Diagnostic, Suppression]]
    baselined: list[Diagnostic]


@dataclasses.dataclass
class LintResult:
    reports: list[FileReport]
    files_checked: int
    new_fingerprints: list[str]

    @property
    def diagnostics(self) -> list[Diagnostic]:
        return [d for r in self.reports for d in r.diagnostics]

    @property
    def suppressed_count(self) -> int:
        return sum(len(r.suppressed) for r in self.reports)

    @property
    def baselined_count(self) -> int:
        return sum(len(r.baselined) for r in self.reports)

    @property
    def exit_code(self) -> int:
        return 1 if self.diagnostics else 0

    def summary(self) -> dict:
        by_rule: dict[str, int] = {}
        for d in self.diagnostics:
            by_rule[d.rule] = by_rule.get(d.rule, 0) + 1
        return {
            "files_checked": self.files_checked,
            "diagnostics": len(self.diagnostics),
            "suppressed": self.suppressed_count,
            "baselined": self.baselined_count,
            "by_rule": dict(sorted(by_rule.items())),
        }


def iter_py_files(paths: Sequence[str | Path]) -> list[Path]:
    out: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(sorted(q for q in p.rglob("*.py")
                              if "__pycache__" not in q.parts))
        elif p.suffix == ".py":
            out.append(p)
    return out


def lint_file(path: Path, select: Iterable[str] | None = None,
              display: str | None = None) -> FileReport:
    display = display if display is not None else str(path)
    posix = path.resolve().as_posix()
    source = path.read_text(encoding="utf-8")
    return lint_source(source, display=display, posix=posix,
                       select=select, path=path)


def lint_source(source: str, *, display: str, posix: str,
                select: Iterable[str] | None = None,
                path: Path | None = None) -> FileReport:
    """Lint one already-read source blob (the test-suite entry point)."""
    keep = select_filter(list(select) if select else None)
    try:
        tree = ast.parse(source)
    except SyntaxError as exc:
        d = Diagnostic(display, exc.lineno or 1, exc.offset or 0,
                       "RPR000", f"syntax error: {exc.msg}")
        return FileReport(display, [d], [], [])

    ctx = FileContext(path=path or Path(display), display=display,
                      posix=posix, source=source, tree=tree,
                      lines=source.splitlines())
    supps, supp_diags = parse_suppressions(display, source)

    diags: list[Diagnostic] = list(supp_diags)
    for checker in all_checkers():
        if not checker.applies_to(posix):
            continue
        for d in checker.check(ctx):
            if keep(d.rule):
                diags.append(d)

    # Unknown codes in suppressions (RPR003) — checked against the full
    # rule table so a suppression cannot rot silently.
    known = known_code_prefixes()
    for s in supps:
        for c in s.codes:
            if c not in known:
                diags.append(Diagnostic(
                    display, s.line, 0, "RPR003",
                    f"suppression names unknown rule {c!r}"))

    # Per-file ignores.
    for pat, prefixes in PER_FILE_IGNORES:
        if pat in posix:
            diags = [d for d in diags
                     if not any(d.rule.startswith(p) for p in prefixes)
                     or d.rule in _UNSUPPRESSIBLE]

    # Inline suppressions.  A standalone suppression comment governs the
    # next line that actually holds code (comment blocks chain through).
    code_lines = [i for i, t in enumerate(ctx.lines, 1)
                  if t.strip() and not t.lstrip().startswith("#")]
    line_of = {id(s): effective_line(s, code_lines) for s in supps}
    kept: list[Diagnostic] = []
    suppressed: list[tuple[Diagnostic, Suppression]] = []
    for d in sorted(diags, key=lambda d: (d.line, d.col, d.rule)):
        if d.rule in _UNSUPPRESSIBLE:
            kept.append(d)
            continue
        hit = next((s for s in supps
                    if line_of[id(s)] == d.line and s.matches(d.rule)),
                   None)
        if hit is not None:
            hit.used = True
            suppressed.append((d, hit))
        else:
            kept.append(d)
    return FileReport(display, kept, suppressed, [])


def run_paths(paths: Sequence[str | Path],
              select: Iterable[str] | None = None,
              baseline: str | Path | None = None) -> LintResult:
    files = iter_py_files(paths)
    reports = [lint_file(f, select=select) for f in files]

    base_fps: set[str] = set()
    if baseline is not None and Path(baseline).exists():
        data = json.loads(Path(baseline).read_text(encoding="utf-8"))
        base_fps = set(data.get("fingerprints", []))

    new_fps: list[str] = []
    for rep in reports:
        occ: dict[tuple[str, str, str], int] = {}
        remaining: list[Diagnostic] = []
        try:
            lines = Path(rep.display).read_text(
                encoding="utf-8").splitlines()
        except OSError:
            lines = []
        for d in rep.diagnostics:
            text = lines[d.line - 1] if 0 < d.line <= len(lines) else ""
            key = (d.path, d.rule, text.strip())
            n = occ.get(key, 0)
            occ[key] = n + 1
            fp = fingerprint(d, text, n)
            new_fps.append(fp)
            if fp in base_fps and d.rule not in _UNSUPPRESSIBLE:
                rep.baselined.append(d)
            else:
                remaining.append(d)
        rep.diagnostics = remaining
    return LintResult(reports, files_checked=len(files),
                      new_fingerprints=new_fps)


def write_baseline(result: LintResult, path: str | Path) -> None:
    """Freeze the current finding set as the baseline file."""
    Path(path).write_text(json.dumps(
        {"version": 1, "fingerprints": sorted(result.new_fingerprints)},
        indent=2) + "\n", encoding="utf-8")
