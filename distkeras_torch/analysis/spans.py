"""Span-contract pass: trace span names vs the critical-path partition.

``critical_path()`` (telemetry/trace.py) partitions a request's wall
time over a *closed* set of span names — ``queued``/``prefill``/
``decode``/``stream``/``router.stream`` plus the ``device_ms``
attribute — and everything it does not recognize silently lands in the
residual ``router`` phase. The span names themselves are free strings
at forty-odd ``tracer.record(...)`` sites across engine, scheduler,
server, router, SLO monitor, and the PS transport; rename one, or add
a timed span under a new name, and per-request attribution quietly
loses that time with no error anywhere. This pass closes the loop:

- ``unattributed-span.<name>`` — a span recorded with a *non-zero*
  duration whose name the ``critical_path()`` partition does not
  know. Zero-duration spans (markers like ``finish``,
  ``router.route``, ``slo.alert`` — recorded with a literal ``0.0``)
  are exempt: they carry no time to attribute. Dynamic names
  (f-strings) are matched on their literal prefix and reported as
  ``<prefix>*``.
- ``unknown-phase.<value>`` — a ``.labels(phase=...)`` value on the
  critical-path histogram family that is not in
  ``CRITICAL_PATH_PHASES``: the engine/server/router fill one shared
  family, and a drifted label value creates a series no
  ``stats()["critical_path_ms"]`` reader or dashboard knows.

The partition itself is *extracted*, not hard-coded: the pass reads
the string literals inside the scanned tree's ``critical_path``
function and the ``CRITICAL_PATH_PHASES`` tuple, so the checker
follows the partition wherever it evolves. A scan set without
``critical_path`` (isolated fixtures) yields no findings. Suppress
with ``# analysis: span-ok``.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from distkeras_torch.analysis.core import (
    Finding,
    ProjectPass,
    SourceFile,
)


def _const_str(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _is_tracer_recv(node) -> bool:
    """True when the receiver chain names a tracer (``tracer.``,
    ``self.tracer.``, ``self.engine.tracer.`` ...) — distinguishes
    ``Tracer.record`` from e.g. ``FlightRecorder.record``."""
    while isinstance(node, ast.Attribute):
        if node.attr == "tracer":
            return True
        node = node.value
    return isinstance(node, ast.Name) and node.id == "tracer"


def _span_name(node) -> Optional[Tuple[str, bool]]:
    """(name, is_prefix) from a span-name argument: a literal, or an
    f-string's leading literal part (prefix match)."""
    s = _const_str(node)
    if s is not None:
        return s, False
    if isinstance(node, ast.JoinedStr) and node.values:
        head = node.values[0]
        s = _const_str(head)
        if s:
            return s, True
    return None


def _zero_duration(node) -> bool:
    return (isinstance(node, ast.Constant)
            and isinstance(node.value, (int, float))
            and float(node.value) == 0.0)


def _partition_names(srcs: Sequence[SourceFile],
                     ) -> Tuple[Optional[Set[str]], Optional[Set[str]]]:
    """(span names critical_path() recognizes, CRITICAL_PATH_PHASES
    values) extracted from whichever scanned file defines them."""
    known: Optional[Set[str]] = None
    phases: Optional[Set[str]] = None
    for src in srcs:
        for node in ast.walk(src.tree):
            if (isinstance(node, ast.FunctionDef)
                    and node.name == "critical_path"):
                names = set()
                for sub in ast.walk(node):
                    s = _const_str(sub)
                    if s is not None:
                        names.add(s)
                known = names if known is None else known | names
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if (isinstance(tgt, ast.Name)
                            and tgt.id == "CRITICAL_PATH_PHASES"
                            and isinstance(node.value,
                                           (ast.Tuple, ast.List))):
                        vals = {_const_str(e) for e in node.value.elts}
                        vals.discard(None)
                        phases = vals
    if known is not None and phases is not None:
        known |= phases
    return known, phases


class _PhaseLabels(ast.NodeVisitor):
    """``.labels(phase=<value>)`` sites, resolving comprehension
    targets iterated over literal tuples (the engine caches bound
    children in a dictcomp)."""

    def __init__(self):
        self.values: List[Tuple[str, int]] = []
        self._comp_vars: Dict[str, List[str]] = {}

    def _literal_iter(self, it) -> Optional[List[str]]:
        if isinstance(it, (ast.Tuple, ast.List)):
            out = [_const_str(e) for e in it.elts]
            if all(v is not None for v in out):
                return out
        return None

    def visit_DictComp(self, node: ast.DictComp):
        self._enter_comp(node, node.generators)

    def visit_ListComp(self, node: ast.ListComp):
        self._enter_comp(node, node.generators)

    def visit_SetComp(self, node: ast.SetComp):
        self._enter_comp(node, node.generators)

    def visit_GeneratorExp(self, node: ast.GeneratorExp):
        self._enter_comp(node, node.generators)

    def _enter_comp(self, node, generators):
        added = []
        for gen in generators:
            vals = self._literal_iter(gen.iter)
            if vals is not None and isinstance(gen.target, ast.Name):
                self._comp_vars[gen.target.id] = vals
                added.append(gen.target.id)
        self.generic_visit(node)
        for name in added:
            self._comp_vars.pop(name, None)

    def visit_Call(self, node: ast.Call):
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr == "labels"):
            for kw in node.keywords:
                if kw.arg != "phase":
                    continue
                v = _const_str(kw.value)
                if v is not None:
                    self.values.append((v, node.lineno))
                elif (isinstance(kw.value, ast.Name)
                      and kw.value.id in self._comp_vars):
                    for v in self._comp_vars[kw.value.id]:
                        self.values.append((v, node.lineno))
        self.generic_visit(node)


class SpanContractPass(ProjectPass):
    rule = "span-contract"
    suppression = "span-ok"

    def run_project(self, srcs: Sequence[SourceFile],
                    ) -> Iterator[Finding]:
        known, phases = _partition_names(srcs)
        if known is None:
            return                      # no partition in the scan set
        for src in srcs:
            # the partition's own module records nothing to check and
            # Tracer.span's internal self.record uses a variable name
            recorded: List[Tuple[str, bool, int]] = []
            for node in ast.walk(src.tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and _is_tracer_recv(node.func.value)):
                    continue
                if node.func.attr == "record" and len(node.args) >= 4:
                    named = _span_name(node.args[1])
                    if named is None:
                        continue
                    if _zero_duration(node.args[3]):
                        continue        # marker span: no time carried
                    recorded.append((*named, node.lineno))
                elif node.func.attr == "span" and len(node.args) >= 2:
                    named = _span_name(node.args[1])
                    if named is not None:
                        recorded.append((*named, node.lineno))
            for name, is_prefix, line in recorded:
                if is_prefix:
                    hit = any(k.startswith(name) for k in known)
                    shown = name + "*"
                else:
                    hit = name in known
                    shown = name
                if not hit:
                    yield Finding(
                        rule=self.rule, path=src.rel, line=line,
                        key=f"unattributed-span.{shown}",
                        message=(
                            f"span {shown!r} is recorded with a real "
                            f"duration but critical_path() does not "
                            f"know it: its time silently lands in the "
                            f"residual phase"
                        ),
                    )
            if phases:
                pl = _PhaseLabels()
                pl.visit(src.tree)
                for value, line in pl.values:
                    if value not in phases:
                        yield Finding(
                            rule=self.rule, path=src.rel, line=line,
                            key=f"unknown-phase.{value}",
                            message=(
                                f".labels(phase={value!r}) is not a "
                                f"CRITICAL_PATH_PHASES value: the "
                                f"series falls outside every critical-"
                                f"path reader"
                            ),
                        )
