"""Diagnostic and rule primitives of the invariant checker.

A `Rule` is a stable code + one-line contract statement; a `Diagnostic`
is one finding pinned to ``path:line:col``.  Baselines match findings by
*fingerprint* — a hash of (path, rule, normalized source line, occurrence
index) — so a baseline survives unrelated edits that shift line numbers
but expires when the offending line itself changes.
"""
from __future__ import annotations

import dataclasses
import hashlib


@dataclasses.dataclass(frozen=True)
class Rule:
    """One checkable invariant: stable code, short name, contract text."""
    code: str           # "RPR101"
    name: str           # "unsanctioned-state-write"
    summary: str        # one-line contract statement

    def __post_init__(self) -> None:
        if not (self.code.startswith("RPR") and self.code[3:].isdigit()):
            raise ValueError(f"rule codes are RPR<digits>, got {self.code!r}")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: ``path:line:col: CODE message``."""
    path: str
    line: int
    col: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} " \
               f"{self.message}"


def fingerprint(diag: Diagnostic, line_text: str, occurrence: int) -> str:
    """Stable baseline key for `diag`.

    ``line_text`` is the diagnostic's source line (stripped, so pure
    re-indentation does not expire a baseline); ``occurrence`` counts
    identical (path, rule, line_text) triples from the top of the file,
    disambiguating repeated findings on identical lines.
    """
    payload = f"{diag.path}\x1f{diag.rule}\x1f{line_text.strip()}" \
              f"\x1f{occurrence}"
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()[:16]
