"""AST helpers the translated checkers share: dotted names resolved
through a file's imports, so ``F.one_hot`` and ``from torch import rand``
are read as ``torch.nn.functional.one_hot`` and ``torch.rand``."""
from __future__ import annotations

import ast


def dotted(node: ast.expr) -> tuple[str, ...]:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return tuple(reversed(parts))


def import_aliases(tree: ast.Module) -> dict[str, tuple[str, ...]]:
    """Local name -> the dotted module path or object it is bound to, for
    every absolute import in the file (``import torch.nn.functional as
    F`` binds "F" to ("torch", "nn", "functional"))."""
    out: dict[str, tuple[str, ...]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = tuple(a.name.split("."))
                else:
                    head = a.name.split(".")[0]
                    out[head] = (head,)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            for a in node.names:
                out[a.asname or a.name] = (*node.module.split("."), a.name)
    return out


def resolved(node: ast.expr, aliases: dict[str, tuple[str, ...]]
             ) -> tuple[str, ...]:
    """`dotted(node)` with its first name replaced by what it imports."""
    dd = dotted(node)
    if dd and dd[0] in aliases:
        return (*aliases[dd[0]], *dd[1:])
    return dd


def keyword(node: ast.Call, name: str) -> ast.expr | None:
    return next((kw.value for kw in node.keywords if kw.arg == name), None)
