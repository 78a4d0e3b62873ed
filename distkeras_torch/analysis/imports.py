"""Import-hygiene pass: layer boundaries, enforced at the import site.

Two declared boundaries, both prose in ARCHITECTURE.md until now:

1. **Stdlib-only layers.** ``telemetry/`` must import no third-party
   module (instrumentation must never perturb device code, and every
   subsystem must be able to import it without cycles), and the fabric
   layer (``serving/router.py``, ``serving/fleet.py``,
   ``serving/controller.py``) shares the constraint so a router or
   fleet-controller process never needs jax on its path *directly*. Intra-package imports are allowed (layering between
   package modules is a different concern); any other non-stdlib
   import is flagged.
2. **No test imports in package code.** ``distkeras_torch/`` must never
   import from ``tests/`` (or ``conftest``): the package has to work
   installed, where the test tree does not exist.

Stdlib membership comes from ``sys.stdlib_module_names``
(Python >= 3.10). Imports are collected from the whole tree, so
function-local and ``try/except ImportError`` imports are checked too
— a lazily-imported third-party dependency still violates a declared
stdlib-only surface. Suppress with ``# analysis: import-ok``.
"""

from __future__ import annotations

import ast
import sys
from typing import Iterator, List, Sequence, Tuple

from distkeras_torch.analysis.core import Finding, Pass, SourceFile

_STDLIB = frozenset(sys.stdlib_module_names)

# path suffixes (relative, '/'-separated) declared stdlib-only
DEFAULT_STDLIB_ONLY = (
    "distkeras_torch/telemetry/",
    "distkeras_torch/serving/router.py",
    "distkeras_torch/serving/fleet.py",
    "distkeras_torch/serving/controller.py",
)

# roots package code must never import from
_FORBIDDEN_ROOTS = ("tests", "conftest")


def _imports(tree: ast.Module) -> List[Tuple[str, int]]:
    """Every imported top-level module name with its line (absolute
    imports only; explicit relative imports have level > 0 and resolve
    within the package by construction)."""
    out: List[Tuple[str, int]] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out.append((alias.name, node.lineno))
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                out.append((node.module, node.lineno))
    return out


class ImportHygienePass(Pass):
    rule = "import-hygiene"
    suppression = "import-ok"

    def __init__(self, package: str = "distkeras_torch",
                 stdlib_only: Sequence[str] = DEFAULT_STDLIB_ONLY):
        self.package = package
        self.stdlib_only = tuple(stdlib_only)

    def _is_stdlib_only_file(self, rel: str) -> bool:
        return any(
            rel.startswith(pfx) if pfx.endswith("/") else rel == pfx
            for pfx in self.stdlib_only
        )

    def run(self, src: SourceFile) -> Iterator[Finding]:
        in_package = src.rel.startswith(self.package + "/")
        if not in_package:
            return
        stdlib_only = self._is_stdlib_only_file(src.rel)
        for module, line in _imports(src.tree):
            root = module.split(".")[0]
            if root in _FORBIDDEN_ROOTS:
                yield Finding(
                    rule=self.rule, path=src.rel, line=line,
                    key=f"tests-import.{module}",
                    message=(
                        f"package code imports {module!r}: the test "
                        f"tree does not exist in an installed package"
                    ),
                )
                continue
            if not stdlib_only:
                continue
            if root == self.package or root in _STDLIB:
                continue
            yield Finding(
                rule=self.rule, path=src.rel, line=line,
                key=f"third-party.{root}",
                message=(
                    f"{src.rel} is a declared stdlib-only layer but "
                    f"imports third-party module {module!r}"
                ),
            )
