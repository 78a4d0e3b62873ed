"""Lock-discipline pass: guarded attributes must be accessed under the
lock.

The serving/telemetry stack's threading contract is attribute-level:
a class that mutates state under ``with self._lock`` (the scheduler's
queue, the tracer's ring, the registry's series maps) promises that
*every* access of that state happens under the lock. This pass makes
the contract checkable:

1. **Guard inference.** Within each class, any attribute *written*
   inside a ``with self.<something-lockish>`` block — direct
   assignment, augmented assignment, subscript store, delete, or a
   mutating method call (``self._buf.append(...)``) — is *guarded*.
2. **Access check.** Every other read or write of a guarded attribute
   in that class must itself sit inside a ``with self.<lock>`` block,
   or in a method that is exempt by convention:

   - ``__init__`` (construction precedes sharing — no other thread can
     hold a reference yet);
   - methods named ``*_locked`` (the callee-runs-under-the-caller's-
     lock convention, e.g. ``SloMonitor._alerts_locked``).

False-positive escape hatches, in preference order: rename the helper
to ``*_locked`` when it genuinely only runs under the lock; a
``# analysis: unguarded-ok`` comment for individually-justified lines
(e.g. a documented racy monitor read); a baseline entry when the
pattern is structural.

Known imprecision (kept deliberately — the pass must stay simple
enough to trust): any ``with self.<lock>`` counts as "under the lock",
even if the class has several locks; aliasing (``q = self._q`` hoisted
out of the lock) is invisible; cross-object accesses
(``other.attr``) are out of scope.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Set

from distkeras_torch.analysis.core import Finding, Pass, SourceFile

# method names on an attribute that count as writing through it
_MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "update", "setdefault", "pop", "popleft", "popitem", "remove",
    "discard", "clear", "sort", "reverse", "put", "put_nowait",
    "write", "writelines", "flush",
}

_EXEMPT_METHODS = {"__init__", "__post_init__", "__new__"}


def _is_self_attr(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self")


def _is_lock_attr(node: ast.AST) -> bool:
    return _is_self_attr(node) and "lock" in node.attr.lower()


class _MethodScanner(ast.NodeVisitor):
    """Walk one method body tracking whether the current node sits
    inside a ``with self.<lock>`` block, and collect (attr, line,
    is_write, under_lock) access events for ``self.<attr>``."""

    def __init__(self):
        self.events: List[tuple] = []  # (attr, line, is_write, locked)
        self._lock_depth = 0

    # -- lock regions --------------------------------------------------------

    def visit_With(self, node: ast.With):
        locked = any(_is_lock_attr(item.context_expr)
                     for item in node.items)
        for item in node.items:
            self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        if locked:
            self._lock_depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if locked:
            self._lock_depth -= 1

    visit_AsyncWith = visit_With

    # nested defs run later (possibly on another thread): their bodies
    # are scanned as part of the same method but never inherit the
    # enclosing lock region
    def visit_FunctionDef(self, node):
        saved, self._lock_depth = self._lock_depth, 0
        self.generic_visit(node)
        self._lock_depth = saved

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    # -- accesses ------------------------------------------------------------

    def _note(self, attr: str, line: int, is_write: bool):
        if "lock" in attr.lower():
            return  # the lock itself is not guarded state
        self.events.append((attr, line, is_write, self._lock_depth > 0))

    def visit_Attribute(self, node: ast.Attribute):
        if _is_self_attr(node):
            is_write = isinstance(node.ctx, (ast.Store, ast.Del))
            self._note(node.attr, node.lineno, is_write)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript):
        # self._series[key] = v / del self._q[0]: a write through the
        # attribute even though the Attribute node itself is a Load
        if (isinstance(node.ctx, (ast.Store, ast.Del))
                and _is_self_attr(node.value)):
            self._note(node.value.attr, node.lineno, True)
            self.visit(node.slice)
            return
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        # self._buf.append(x): mutation through the attribute
        fn = node.func
        if (isinstance(fn, ast.Attribute) and fn.attr in _MUTATORS
                and _is_self_attr(fn.value)):
            self._note(fn.value.attr, node.lineno, True)
            for a in node.args:
                self.visit(a)
            for kw in node.keywords:
                self.visit(kw)
            return
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        # self.dropped += 1 is a read-modify-write
        if _is_self_attr(node.target):
            self._note(node.target.attr, node.lineno, True)
            self.visit(node.value)
            return
        self.generic_visit(node)


class LockDisciplinePass(Pass):
    rule = "lock-discipline"
    suppression = "unguarded-ok"

    def run(self, src: SourceFile) -> Iterator[Finding]:
        for cls in ast.walk(src.tree):
            if isinstance(cls, ast.ClassDef):
                yield from self._check_class(src, cls)

    def _check_class(self, src: SourceFile,
                     cls: ast.ClassDef) -> Iterator[Finding]:
        methods = [n for n in cls.body
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))]
        scans = {}
        for m in methods:
            sc = _MethodScanner()
            for stmt in m.body:
                sc.visit(stmt)
            scans[m.name] = sc
        guarded: Set[str] = set()
        for name, sc in scans.items():
            if name in _EXEMPT_METHODS:
                continue
            for attr, _line, is_write, locked in sc.events:
                if is_write and locked:
                    guarded.add(attr)
        if not guarded:
            return
        for m in methods:
            if m.name in _EXEMPT_METHODS or m.name.endswith("_locked"):
                continue
            for attr, line, is_write, locked in scans[m.name].events:
                if attr in guarded and not locked:
                    kind = "written" if is_write else "read"
                    # method-granular key: a baseline entry accepting
                    # one method's access can't mask a future unguarded
                    # access elsewhere in the class
                    yield Finding(
                        rule=self.rule, path=src.rel, line=line,
                        key=f"{cls.name}.{attr}@{m.name}",
                        message=(
                            f"{cls.name}.{attr} is {kind} in "
                            f"{m.name}() outside the lock, but is "
                            f"written under `with self.<lock>` "
                            f"elsewhere in the class"
                        ),
                    )
