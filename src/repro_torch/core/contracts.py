"""Mutation contracts for the allocation engine's shared state objects.

The engine's bit-identity guarantees (scalar ref == numpy == xla,
incremental DestCache == always-rescan) hold only if `State` and
`DestCache` fields are written exclusively by a small, known set of
mutators whose effects the undo log and the cache invalidation protocol
account for.  `@mutates("q", "cfg", ...)` declares that write-set on the
mutator itself:

* at runtime the decorator is a no-op (zero overhead on the hot path) —
  it only records the declared field names on ``fn.__mutates__``;
* statically, ``repro.analysis.lint`` reads the decorator from the AST:
  a write to a State/DestCache field outside a decorated mutator is
  RPR101, a write the decorator does not declare is RPR102, and a
  declared field the body never writes is RPR103.

The decorator is deliberately dumb: no wrapping, no signature changes,
no introspection of the target — `fn` comes back the same object, so
jit, pickling for process pools, and `functools.partial` all see the
undecorated function.
"""
from __future__ import annotations

from typing import Callable, TypeVar

F = TypeVar("F", bound=Callable)


def mutates(*fields: str) -> Callable[[F], F]:
    """Declare the exact State/DestCache fields a mutator may write.

    ``fields`` are attribute names (``"q"``, ``"cfg_dirty"``, ...).  The
    declaration is the *complete* write-set: the static checker flags
    both undeclared writes and unused declarations, so the decorator
    stays an accurate, machine-checked piece of documentation.
    """
    if not fields:
        raise ValueError("@mutates needs at least one field name")
    for f in fields:
        if not (isinstance(f, str) and f.isidentifier()):
            raise ValueError(f"@mutates field names must be identifiers, "
                             f"got {f!r}")
    declared = frozenset(fields)

    def mark(fn: F) -> F:
        fn.__mutates__ = declared  # type: ignore[attr-defined]
        return fn

    return mark
