"""Inline suppression syntax: ``# repro-lint: ignore[RPR203] -- reason``.

A suppression silences matching diagnostics on its own line, or — when
the comment stands alone on a line — on the next line that carries code.
The ``-- reason`` clause is MANDATORY: a bare ``ignore[...]`` is itself
a diagnostic (RPR002) and suppresses nothing, so every silenced finding
carries its justification in the source.  Codes may be exact
(``RPR203``) or a family prefix (``RPR2``); unknown codes raise RPR003
at lint time so suppressions cannot rot silently.

Comments are found with `tokenize`, not string search, so a
``repro-lint:`` inside a string literal is never misparsed.
"""
from __future__ import annotations

import dataclasses
import io
import re
import tokenize

from .diagnostics import Diagnostic

MARKER = "repro-lint:"

_IGNORE_RE = re.compile(
    r"#\s*repro-lint:\s*ignore\[(?P<codes>[^\]]*)\]"
    r"(?:\s*--\s*(?P<reason>.*))?\s*$")
_CODE_RE = re.compile(r"^RPR\d*$")


@dataclasses.dataclass
class Suppression:
    """One parsed ``ignore[...]`` comment."""
    line: int                   # line the comment sits on
    codes: tuple[str, ...]      # exact codes or RPR-prefix families
    reason: str
    standalone: bool            # comment-only line: applies to next line
    used: bool = False

    def matches(self, rule: str) -> bool:
        return any(rule == c or rule.startswith(c) for c in self.codes)


def parse_suppressions(path: str, source: str
                       ) -> tuple[list[Suppression], list[Diagnostic]]:
    """All suppressions in `source`, plus diagnostics for malformed ones.

    RPR001 — a ``repro-lint:`` comment that is not valid ``ignore[...]``
    syntax; RPR002 — an ``ignore[...]`` with no ``-- reason``.  Malformed
    suppressions are reported and NOT honored.
    """
    supps: list[Suppression] = []
    diags: list[Diagnostic] = []
    try:
        tokens = list(tokenize.generate_tokens(
            io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return [], []           # unparseable files are reported upstream
    for tok in tokens:
        if tok.type != tokenize.COMMENT or MARKER not in tok.string:
            continue
        line_no, col = tok.start
        standalone = tok.line[:col].strip() == ""
        m = _IGNORE_RE.search(tok.string)
        if m is None:
            diags.append(Diagnostic(
                path, line_no, col, "RPR001",
                f"malformed repro-lint comment {tok.string.strip()!r}: "
                f"expected '# repro-lint: ignore[CODE,...] -- reason'"))
            continue
        codes = tuple(c.strip() for c in m.group("codes").split(",")
                      if c.strip())
        bad = [c for c in codes if not _CODE_RE.fullmatch(c)]
        if not codes or bad:
            diags.append(Diagnostic(
                path, line_no, col, "RPR001",
                f"suppression codes must be RPR-codes or RPR-prefixes, "
                f"got {list(codes)!r}"))
            continue
        reason = (m.group("reason") or "").strip()
        if not reason:
            diags.append(Diagnostic(
                path, line_no, col, "RPR002",
                "bare suppression rejected: add '-- <reason>' (the "
                "justification ships with the silenced finding)"))
            continue
        supps.append(Suppression(line_no, codes, reason, standalone))
    return supps, diags


def effective_line(supp: Suppression, code_lines: list[int]) -> int:
    """The source line `supp` governs.

    Same-line comments govern their own line; standalone comments govern
    the next line that holds code (from the sorted ``code_lines`` index).
    """
    if not supp.standalone:
        return supp.line
    for ln in code_lines:
        if ln > supp.line:
            return ln
    return supp.line
