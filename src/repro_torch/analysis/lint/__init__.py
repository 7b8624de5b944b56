"""AST-based invariant checker for the repro_torch port.

The reference's checker (`repro.analysis.lint`) with its rules given
their torch meaning: sanctioned State/DestCache mutation (RPR1xx),
deterministic engine paths, torch's global generator included (RPR2xx),
f64 dtype discipline in the allocator tier and the risk solver (RPR3xx),
and no host sync inside a device program (RPR4xx).  The codes, the
suppression syntax and the CLI are the reference's.  See
src/repro_torch/README.md "Invariants & static enforcement" for the
contract-to-rule map and the suppression policy.

Usage::

    python -m repro_torch.analysis.lint src/repro_torch
    python -m repro_torch.analysis.lint --select RPR402,RPR3 src/repro_torch/risk/
    python -m repro_torch.analysis.lint --list-rules

Programmatic: `run_paths` / `lint_source` return structured reports.
"""
from .diagnostics import Diagnostic, Rule
from .registry import (BaseChecker, FileContext, all_checkers, all_rules,
                       register_checker)
from .runner import (LintResult, lint_file, lint_source, run_paths,
                     write_baseline)

__all__ = [
    "BaseChecker", "Diagnostic", "FileContext", "LintResult", "Rule",
    "all_checkers", "all_rules", "lint_file", "lint_source",
    "register_checker", "run_paths", "write_baseline",
]
