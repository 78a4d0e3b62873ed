"""Recompile-hazard pass, the port's counterpart: cache keys stay
hashable and value-stable.

The reference keys its compiled tick functions on hashable, value-stable
arguments; a list or a fresh closure on that path means a ``TypeError``
or a retrace per call. Eager torch compiles nothing by default, but the
same contract holds wherever the port caches on its arguments:

1. calls to module functions decorated with ``functools.lru_cache`` /
   ``functools.cache`` (``ops/splash_prefill._sm_count``, keyed on a
   device index) — an unhashable argument raises, a freshly built one
   (an f-string, a lambda) misses the cache every call;
2. ``torch.compile(...)`` and ``torch.cuda.graph(...)`` call sites — a
   lambda or a comprehension built per call is a new function or pool
   object each time, so every call compiles or captures anew;
3. calls through a compiled function: a local or module name bound from
   ``torch.compile(f)``, or a def decorated ``@torch.compile`` /
   ``@torch.compile(...)``. Dynamo guards on the *values* of Python
   containers and strings in its arguments, so a list, dict, set,
   comprehension or f-string built at the call site recompiles whenever
   its contents change — the eager twin of a jit ``static_argnums``
   position.

Flagged argument shapes, as in the reference: literal lists / dicts /
sets, comprehensions, generator expressions, lambdas, f-strings, tuples
containing one, and locals last assigned from one.

On the tree this pass was written for it finds nothing: the port has
one ``lru_cache`` (``_sm_count``, called with an int) and no
``torch.compile`` or CUDA-graph call site. It stands guard for the
first one. Suppress a justified case with ``# analysis: recompile-ok``.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set

from distkeras_torch.analysis.core import Finding, Pass, SourceFile

# expression node types that are unhashable or freshly constructed
_HAZARD_NODES = (
    ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp,
    ast.GeneratorExp, ast.Lambda, ast.JoinedStr,
)

_HAZARD_NAMES = {
    ast.List: "list literal", ast.Dict: "dict literal",
    ast.Set: "set literal", ast.ListComp: "list comprehension",
    ast.DictComp: "dict comprehension", ast.SetComp: "set comprehension",
    ast.GeneratorExp: "generator expression", ast.Lambda: "lambda",
    ast.JoinedStr: "f-string (fresh per call)",
}

_CACHE_DECORATORS = ("functools.lru_cache", "lru_cache", "functools.cache",
                     "cache")
_COMPILE = ("torch.compile", "compile")
_CAPTURE = ("torch.cuda.graph", "torch.cuda.CUDAGraph",
            "torch.cuda.make_graphed_callables")


def _dotted(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _decorated(fn, names) -> bool:
    for dec in fn.decorator_list:
        d = dec.func if isinstance(dec, ast.Call) else dec
        if _dotted(d) in names:
            return True
    return False


def _compiles(node: ast.AST) -> bool:
    """``torch.compile(f, ...)`` — a call that returns a compiled
    callable (the bare name ``compile`` only with a torch-ish first
    argument, so Python's builtin ``compile(source, ...)`` stays out)."""
    if not isinstance(node, ast.Call):
        return False
    callee = _dotted(node.func)
    if callee == "torch.compile":
        return True
    return (callee == "compile" and bool(node.args)
            and not isinstance(node.args[0], (ast.Constant, ast.JoinedStr)))


def _hazard(node: ast.AST,
            local_hazards: Dict[str, str]) -> Optional[str]:
    """Why this argument expression is a cache-key hazard, or None.
    Tuples are checked recursively (a tuple of lists is as unhashable
    as the list)."""
    if isinstance(node, _HAZARD_NODES):
        return _HAZARD_NAMES[type(node)]
    if isinstance(node, ast.Name) and node.id in local_hazards:
        return f"variable holding a {local_hazards[node.id]}"
    if isinstance(node, ast.Tuple):
        for el in node.elts:
            why = _hazard(el, local_hazards)
            if why:
                return f"tuple containing a {why}"
    return None


class RecompileHazardPass(Pass):
    rule = "recompile-hazard"
    suppression = "recompile-ok"

    def run(self, src: SourceFile) -> Iterator[Finding]:
        cached: Set[str] = set()
        compiled: Set[str] = set()
        sites = False
        for node in ast.walk(src.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if _decorated(node, _CACHE_DECORATORS):
                    cached.add(node.name)
                if _decorated(node, _COMPILE):
                    compiled.add(node.name)
            elif isinstance(node, ast.Call) and not sites:
                sites = _compiles(node) or _dotted(node.func) in _CAPTURE
        for node in src.tree.body:
            # module-level ``fast = torch.compile(f)``
            if (isinstance(node, ast.Assign) and _compiles(node.value)):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        compiled.add(t.id)
        if not (cached or compiled or sites):
            return  # nothing in this file keys a cache on its arguments
        for node in ast.walk(src.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_function(src, node, cached,
                                                compiled)

    def _check_function(self, src: SourceFile, fn, cached: Set[str],
                        module_compiled: Set[str]) -> Iterator[Finding]:
        compiled = set(module_compiled)
        local_hazards: Dict[str, str] = {}
        for stmt in ast.walk(fn):
            if not (isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)):
                continue
            name = stmt.targets[0].id
            if _compiles(stmt.value):
                compiled.add(name)
                continue
            if isinstance(stmt.value, _HAZARD_NODES):
                local_hazards[name] = _HAZARD_NAMES[type(stmt.value)]
            else:
                local_hazards.pop(name, None)

        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            callee = _dotted(node.func)
            short = callee.split(".")[-1]
            if short in cached:
                what = f"cache-keyed call {short}()"
            elif _compiles(node) or callee in _CAPTURE:
                what = f"{callee}() (a fresh object compiles or captures anew)"
            elif short in compiled:
                what = (f"compiled {short}() (dynamo guards on container "
                        f"and string values: a change recompiles)")
            else:
                continue
            checked = list(enumerate(node.args)) + [
                (kw.arg, kw.value) for kw in node.keywords]
            for where, arg in checked:
                why = _hazard(arg, local_hazards)
                if why:
                    yield Finding(
                        rule=self.rule, path=src.rel, line=arg.lineno,
                        key=f"{fn.name}.{short}",
                        message=(
                            f"{why} flows into {what} (arg {where}) in "
                            f"{fn.name}() — cache keys must be hashable "
                            f"and value-stable"),
                    )
