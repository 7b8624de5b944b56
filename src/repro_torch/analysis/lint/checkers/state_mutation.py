"""State-mutation discipline (RPR101-103).

`State` and `DestCache` carry the incremental aggregates every engine
tier trusts bitwise; any write outside the sanctioned mutators silently
desynchronizes the undo log / cache-invalidation protocol.  The
sanctioned set is declared in the source itself: a function decorated
``@mutates("q", "cfg", ...)`` (see `repro_torch.core.contracts`) may write
exactly the declared fields.  Everything else must route through the
mutators.

Tracked objects are found syntactically — parameters annotated
``State``/``DestCache`` (any qualification, optional/union forms),
``self`` inside those classes, and locals assigned from the known
constructors (``State(...)``, ``State.fresh(...)``, ``DestCache(...)``,
``deployment_state(...)``).  A "write" is an attribute assignment or
aug-assignment, a subscript store through an attribute, or a mutating
method call (``.add``/``.discard``/``.fill``/...) on an attribute.
``__init__``/``__post_init__`` of the tracked classes are exempt
(construction is not mutation).
"""
from __future__ import annotations

import ast
from typing import Iterator

from ..diagnostics import Diagnostic, Rule
from ..registry import BaseChecker, FileContext, register_checker

TRACKED_CLASSES = frozenset({"State", "DestCache"})

#: calls whose result is a tracked object: name -> class
CONSTRUCTORS = {
    "State": "State",
    "DestCache": "DestCache",
    "deployment_state": "State",
}

#: attribute-method calls that mutate their receiver in place
MUTATING_METHODS = frozenset({
    "add", "discard", "remove", "clear", "update", "pop", "popitem",
    "append", "extend", "insert", "sort", "reverse", "fill", "setflags",
    "setdefault", "difference_update", "intersection_update",
    "symmetric_difference_update", "resize", "partial_sort",
})

_EXEMPT_METHODS = frozenset({"__init__", "__post_init__"})


def _terminal_name(node: ast.expr) -> str | None:
    """`Name` id, or the final attribute of a dotted path."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _annotation_class(ann: ast.expr | None) -> str | None:
    """The tracked class an annotation names, through quotes, Optional,
    and `| None` unions."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return None
    if isinstance(ann, (ast.Name, ast.Attribute)):
        t = _terminal_name(ann)
        return t if t in TRACKED_CLASSES else None
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return (_annotation_class(ann.left)
                or _annotation_class(ann.right))
    if isinstance(ann, ast.Subscript):        # Optional[State]
        t = _terminal_name(ann.value)
        if t == "Optional":
            return _annotation_class(ann.slice)
    return None


def _constructor_class(value: ast.expr) -> str | None:
    """Tracked class built by `value`, if it is a known constructor call
    (``State(...)``, ``State.fresh(...)``, ``deployment_state(...)``)."""
    if not isinstance(value, ast.Call):
        return None
    fn = value.func
    if isinstance(fn, ast.Attribute) and fn.attr == "fresh":
        base = _terminal_name(fn.value)
        if base in TRACKED_CLASSES:
            return base
    t = _terminal_name(fn)
    return CONSTRUCTORS.get(t) if t is not None else None


def _mutates_decl(fn: ast.FunctionDef) -> frozenset[str] | None:
    """The declared write-set of an ``@mutates(...)`` decorator, if any."""
    for dec in fn.decorator_list:
        if not isinstance(dec, ast.Call):
            continue
        if _terminal_name(dec.func) != "mutates":
            continue
        fields = set()
        for a in dec.args:
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                fields.add(a.value)
        return frozenset(fields)
    return None


def _iter_writes(body: list[ast.stmt], tracked: dict[str, str]
                 ) -> Iterator[tuple[ast.AST, str, str]]:
    """(node, object_name, field) for every tracked-field write in `body`,
    skipping nested function/class definitions (analyzed separately)."""

    def base_field(target: ast.expr) -> tuple[str, str] | None:
        # st.f = / st.f += ...
        if isinstance(target, ast.Attribute) \
                and isinstance(target.value, ast.Name) \
                and target.value.id in tracked:
            return target.value.id, target.attr
        # st.f[...] = / st.f[...] += ...
        if isinstance(target, ast.Subscript):
            return base_field(target.value)
        return None

    for node in _walk_shallow(body):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                    else [t]
                for e in elts:
                    bf = base_field(e)
                    if bf is not None:
                        yield node, bf[0], bf[1]
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in MUTATING_METHODS:
            bf = base_field(node.func.value)
            if bf is not None:
                yield node, bf[0], bf[1]


_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def _add_constructor_locals(body: list[ast.stmt],
                            tracked: dict[str, str]) -> None:
    """Add names bound by tracked-class constructor calls in `body`."""
    for node in _walk_shallow(body):
        if isinstance(node, ast.Assign):
            cls = _constructor_class(node.value)
            if cls is not None:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        tracked[t.id] = cls


def _walk_shallow(body: list[ast.stmt]) -> Iterator[ast.AST]:
    """ast.walk over the statements of ONE scope: neither nested
    def/class nodes nor their bodies are entered."""
    stack: list[ast.AST] = [n for n in body if not isinstance(n, _DEFS)]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, _DEFS):
                stack.append(child)


@register_checker
class StateMutationChecker(BaseChecker):
    rules = (
        Rule("RPR101", "unsanctioned-state-write",
             "State/DestCache fields may only be written inside "
             "@mutates-decorated mutators"),
        Rule("RPR102", "undeclared-mutation",
             "a @mutates function may write only its declared fields"),
        Rule("RPR103", "unused-mutation-declaration",
             "every @mutates-declared field must actually be written"),
    )

    def check(self, ctx: FileContext) -> Iterator[Diagnostic]:
        yield from self._scan(ctx, ctx.tree.body, tracked={},
                              declared=None, owner=None)

    def _scan(self, ctx: FileContext, body: list[ast.stmt],
              tracked: dict[str, str], declared: frozenset[str] | None,
              owner: str | None) -> Iterator[Diagnostic]:
        """One scope: report its writes, then recurse into nested scopes
        with inherited tracked bindings / declaration."""
        # Locals bound by known constructors join the tracked set.
        tracked = dict(tracked)
        _add_constructor_locals(body, tracked)

        seen_fields: set[str] = set()
        for node, obj, field in _iter_writes(body, tracked):
            seen_fields.add(field)
            if declared is None:
                yield Diagnostic(
                    ctx.display, node.lineno, node.col_offset, "RPR101",
                    f"write to {tracked[obj]} field '{obj}.{field}' "
                    f"outside a @mutates mutator (route through "
                    f"core.mechanisms, or decorate and declare)")
            elif field not in declared:
                yield Diagnostic(
                    ctx.display, node.lineno, node.col_offset, "RPR102",
                    f"'{obj}.{field}' written but not declared by "
                    f"@mutates on this function")

        # Nested scopes.
        for node in _walk_all_defs(body):
            if isinstance(node, ast.ClassDef):
                cls_tracked = dict(tracked)
                is_tracked_cls = node.name in TRACKED_CLASSES
                for item in node.body:
                    if not isinstance(item, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)):
                        continue
                    yield from self._scan_function(
                        ctx, item, cls_tracked,
                        owner=node.name if is_tracked_cls else None)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._scan_function(ctx, node, tracked,
                                               owner=owner,
                                               inherited=declared)

    def _scan_function(self, ctx: FileContext, fn: ast.FunctionDef,
                       tracked: dict[str, str], owner: str | None,
                       inherited: frozenset[str] | None = None
                       ) -> Iterator[Diagnostic]:
        tracked = dict(tracked)
        args = fn.args
        for a in (*args.posonlyargs, *args.args, *args.kwonlyargs):
            cls = _annotation_class(a.annotation)
            if cls is not None:
                tracked[a.arg] = cls
        if owner is not None and (args.posonlyargs or args.args):
            first = (args.posonlyargs or args.args)[0].arg
            tracked.setdefault(first, owner)

        if owner is not None and fn.name in _EXEMPT_METHODS:
            return      # construction is not mutation

        declared = _mutates_decl(fn)
        if declared is None:
            declared = inherited        # closures inside a mutator
        if declared is not None:
            full = dict(tracked)
            _add_constructor_locals(fn.body, full)
            written = {f for _, _, f in _iter_writes(fn.body, full)}
            for missing in sorted(declared - written):
                # Declared-but-unwritten fields may be written by nested
                # helpers; only flag when no nested def exists.
                if not any(True for _ in _walk_all_defs(fn.body)):
                    yield Diagnostic(
                        ctx.display, fn.lineno, fn.col_offset, "RPR103",
                        f"@mutates declares '{missing}' but the body "
                        f"never writes it")
        yield from self._scan(ctx, fn.body, tracked, declared, owner)


def _walk_all_defs(body: list[ast.stmt]) -> Iterator[ast.stmt]:
    """Function/class definitions belonging to this scope: direct members
    of `body` plus defs nested under non-def statements (`if`-guarded
    defs), without crossing another def/class boundary."""
    stack: list[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, _DEFS):
            yield node          # a scope of its own: do not descend
            continue
        stack.extend(ast.iter_child_nodes(node))
