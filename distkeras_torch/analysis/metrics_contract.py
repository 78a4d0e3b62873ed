"""Metric-contract pass: telemetry families as one cross-file model.

Metric names are free strings: the engine declares
``serving_requests_total`` in one module, the scheduler declares the
same family in another, the SLO default rules reference it by name in
a third, and the router's ``stats()`` re-gets families by literal name
to read them. The registry's get-or-create enforces consistency *at
runtime* — but only on code paths that actually run together, so a
drifted copy sits latent until the right pair of subsystems meets in
one process. This pass folds every call site in the scanned tree into
one model of the metric namespace and flags the deviants:

- ``label-mismatch.<family>`` — one family declared with different
  ``labelnames`` at different sites, or a ``.labels(...)`` use whose
  key set differs from the declaration (the registry would raise at
  runtime; statically the *first* process to import both sites dies);
- ``kind-mismatch.<family>`` — one name declared as counter in one
  place and gauge/histogram in another;
- ``unknown-family.<family>`` — a read-side reference
  (``registry.get("name")``, an ``SloRule`` metric name, a
  ``_counter_total("name")`` lookup) to a family no site declares:
  the read silently answers "no data" forever;
- ``never-written.<family>`` — a family declared somewhere but with
  no reachable ``inc``/``set``/``observe`` anywhere in the tree: it
  exports a permanent zero through exposition and ``stats()`` (the
  declared-but-dead drift this pass exists to catch — exposition
  renders the whole registry, so a dead family *looks* live on every
  dashboard).

Resolution is per-binding: ``self._m_x = reg.counter(...)`` then
``self._m_x.inc()`` ties the write to the family, as do module-global
bindings, ``.labels(...)``-bound children cached on attributes, dicts
of bound children (``{ph: m.labels(phase=ph) for ph in (...)}``), and
inline ``reg.counter(...).labels(...).inc()`` chains. Dynamic
receivers the pass cannot resolve are ignored, never flagged.
Suppress with ``# analysis: metric-ok``.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from distkeras_torch.analysis.core import (
    Finding,
    ProjectPass,
    SourceFile,
)

_DECL_METHODS = {"counter": "counter", "gauge": "gauge",
                 "histogram": "histogram"}
_WRITE_METHODS = {"inc", "set", "observe"}


def _const_str(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _labelnames_of(call: ast.Call) -> Optional[Tuple[str, ...]]:
    """The declaration's labelnames as a tuple of literals; ``()``
    when omitted (the registry default); None when dynamic."""
    for kw in call.keywords:
        if kw.arg == "labelnames":
            v = kw.value
            if isinstance(v, (ast.Tuple, ast.List)):
                out = []
                for el in v.elts:
                    s = _const_str(el)
                    if s is None:
                        return None
                    out.append(s)
                return tuple(out)
            return None
    return ()


def _decl_call(node) -> Optional[Tuple[str, str, Optional[Tuple[str, ...]]]]:
    """``<recv>.counter|gauge|histogram("name", ...)`` ->
    (family, kind, labelnames)."""
    if (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _DECL_METHODS
            and node.args):
        name = _const_str(node.args[0])
        if name is not None:
            return name, _DECL_METHODS[node.func.attr], _labelnames_of(node)
    return None


@dataclass
class Family:
    name: str
    kinds: Dict[str, Tuple[str, int]] = field(default_factory=dict)
    # labelnames variant -> first (path, line) declaring it
    labelsets: Dict[Tuple[str, ...], Tuple[str, int]] = (
        field(default_factory=dict))
    written: bool = False
    # .labels(...) use sites: (keys, path, line)
    label_uses: List[Tuple[Tuple[str, ...], str, int]] = (
        field(default_factory=list))


class _FileScan(ast.NodeVisitor):
    """One file's declarations, bindings, writes, and read refs."""

    def __init__(self, src: SourceFile):
        self.src = src
        self.cls: Optional[str] = None
        # binding symbol -> family. Symbols: ("attr", cls, name) for
        # self.<name> inside cls, ("name", scope-qual, name) for plain
        # locals/globals (qual "" at module level).
        self.bindings: Dict[tuple, str] = {}
        self.decls: List[Tuple[str, str, Optional[Tuple[str, ...]],
                               int]] = []
        self.writes: Set[str] = set()
        self.label_uses: List[Tuple[str, Tuple[str, ...], int]] = []
        self.reads: List[Tuple[str, int]] = []
        self._qual: List[str] = []

    # -- binding resolution ---------------------------------------------

    def _resolve(self, node) -> Optional[str]:
        """Family name an expression evaluates to a metric/bound-child
        of, or None when unresolvable."""
        decl = _decl_call(node)
        if decl is not None:
            return decl[0]
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            if node.func.attr == "labels":
                return self._resolve(node.func.value)
        if isinstance(node, ast.Attribute):
            if (isinstance(node.value, ast.Name)
                    and node.value.id == "self" and self.cls):
                return self.bindings.get(("attr", self.cls, node.attr))
            return None
        if isinstance(node, ast.Name):
            for qual in (".".join(self._qual), ""):
                fam = self.bindings.get(("name", qual, node.id))
                if fam is not None:
                    return fam
            return None
        if isinstance(node, ast.Subscript):
            # dict-of-bound-children: self._m_cp[phase]
            return self._resolve(node.value)
        return None

    def _bind_target(self, tgt, fam: str):
        if (isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self" and self.cls):
            self.bindings[("attr", self.cls, tgt.attr)] = fam
        elif isinstance(tgt, ast.Name):
            self.bindings[("name", ".".join(self._qual), tgt.id)] = fam

    # -- visitors -------------------------------------------------------

    def visit_ClassDef(self, node: ast.ClassDef):
        prev, self.cls = self.cls, node.name
        self._qual.append(node.name)
        self.generic_visit(node)
        self._qual.pop()
        self.cls = prev

    def visit_FunctionDef(self, node: ast.FunctionDef):
        self._qual.append(node.name)
        self.generic_visit(node)
        self._qual.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node: ast.Assign):
        fam = self._resolve(node.value)
        if fam is None and isinstance(node.value, (ast.Dict,
                                                   ast.DictComp)):
            vals = (node.value.values
                    if isinstance(node.value, ast.Dict)
                    else [node.value.value])
            for v in vals:
                fam = self._resolve(v)
                if fam is not None:
                    break
        if fam is not None:
            for tgt in node.targets:
                self._bind_target(tgt, fam)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        decl = _decl_call(node)
        if decl is not None:
            self.decls.append((*decl, node.lineno))
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in _WRITE_METHODS:
                fam = self._resolve(node.func.value)
                if fam is not None:
                    self.writes.add(fam)
            elif attr == "labels":
                fam = self._resolve(node.func.value)
                if fam is not None and not any(
                        kw.arg is None for kw in node.keywords):
                    keys = tuple(sorted(kw.arg for kw in node.keywords))
                    self.label_uses.append((fam, keys, node.lineno))
            elif attr == "get" and node.args:
                # read-side registry lookup: self.registry.get("name")
                recv = node.func.value
                is_registry = (
                    (isinstance(recv, ast.Name)
                     and recv.id in ("registry", "reg"))
                    or (isinstance(recv, ast.Attribute)
                        and recv.attr in ("registry", "_registry"))
                )
                name = _const_str(node.args[0])
                if is_registry and name is not None:
                    self.reads.append((name, node.lineno))
            elif attr == "_counter_total" and node.args:
                name = _const_str(node.args[0])
                if name is not None:
                    self.reads.append((name, node.lineno))
        # SloRule("rule", "metric_family", ...) metric references
        callee = node.func
        callee_name = (callee.id if isinstance(callee, ast.Name)
                       else callee.attr
                       if isinstance(callee, ast.Attribute) else None)
        if callee_name == "SloRule" and len(node.args) >= 2:
            name = _const_str(node.args[1])
            if name is not None:
                self.reads.append((name, node.lineno))
        self.generic_visit(node)


class MetricContractPass(ProjectPass):
    rule = "metric-contract"
    suppression = "metric-ok"

    # the registry module defines the machinery, not call sites
    exclude_suffixes = ("telemetry/registry.py",)

    def run_project(self, srcs: Sequence[SourceFile],
                    ) -> Iterator[Finding]:
        families: Dict[str, Family] = {}
        reads: List[Tuple[str, str, int]] = []
        any_decl_seen = False
        for src in srcs:
            if src.rel.endswith(self.exclude_suffixes):
                continue
            scan = _FileScan(src)
            scan.visit(src.tree)
            for name, kind, labelnames, line in scan.decls:
                any_decl_seen = True
                fam = families.setdefault(name, Family(name))
                fam.kinds.setdefault(kind, (src.rel, line))
                if labelnames is not None:
                    fam.labelsets.setdefault(labelnames, (src.rel, line))
            for name in scan.writes:
                families.setdefault(name, Family(name)).written = True
            for name, keys, line in scan.label_uses:
                families.setdefault(name, Family(name)).label_uses.append(
                    (keys, src.rel, line))
            for name, line in scan.reads:
                reads.append((name, src.rel, line))
        if not any_decl_seen:
            return                      # nothing metric-shaped scanned

        for name, fam in sorted(families.items()):
            if len(fam.kinds) > 1:
                kinds = sorted(fam.kinds)
                path, line = fam.kinds[kinds[1]]
                yield Finding(
                    rule=self.rule, path=path, line=line,
                    key=f"kind-mismatch.{name}",
                    message=(
                        f"metric {name!r} declared as "
                        f"{' and '.join(kinds)} at different sites "
                        f"(registry raises when both run)"
                    ),
                )
            if len(fam.labelsets) > 1:
                variants = sorted(fam.labelsets.items())
                path, line = variants[1][1]
                yield Finding(
                    rule=self.rule, path=path, line=line,
                    key=f"label-mismatch.{name}",
                    message=(
                        f"metric {name!r} declared with conflicting "
                        f"labelnames "
                        f"{' vs '.join(str(v[0]) for v in variants)}"
                    ),
                )
            declared = {frozenset(ls) for ls in fam.labelsets}
            for keys, path, line in fam.label_uses:
                if declared and frozenset(keys) not in declared:
                    yield Finding(
                        rule=self.rule, path=path, line=line,
                        key=f"label-mismatch.{name}.{'.'.join(keys)}",
                        message=(
                            f".labels({', '.join(keys)}) on metric "
                            f"{name!r} does not match its declared "
                            f"labelnames "
                            f"{sorted(sorted(ls) for ls in declared)}"
                        ),
                    )
            if fam.kinds and not fam.written:
                path, line = next(iter(fam.kinds.values()))
                yield Finding(
                    rule=self.rule, path=path, line=line,
                    key=f"never-written.{name}",
                    message=(
                        f"metric {name!r} is declared but no reachable "
                        f"inc/set/observe writes it: exposition and "
                        f"stats() export a permanent zero"
                    ),
                )
        for name, path, line in sorted(reads):
            fam = families.get(name)
            if fam is None or not fam.kinds:
                yield Finding(
                    rule=self.rule, path=path, line=line,
                    key=f"unknown-family.{name}",
                    message=(
                        f"read-side reference to metric {name!r}, "
                        f"which no scanned site declares: the read "
                        f"silently answers no-data forever"
                    ),
                )
