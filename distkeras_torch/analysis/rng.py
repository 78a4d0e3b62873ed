"""RNG-discipline pass, the port's counterpart: every draw on the
serving and model paths comes from an explicit ``torch.Generator``, and
a slot's generator is seeded only at admission.

The engine's parity guarantee (engine streams == solo ``generate()``
streams, sampled rows included) rests on each slot owning its draws:
slot ``s`` samples with ``self._gens[s]`` (``self._draft_gens[s]`` for
the draft model), seeded from the request's ``seed`` when the request
is admitted and advanced only by that slot's own draws. Two shapes
break it without failing anything on the spot:

- **a draw from the global RNG** — ``torch.rand`` / ``randn`` /
  ``randint`` / ``randperm`` / ``normal`` / ``multinomial`` /
  ``bernoulli`` / ``poisson``, the in-place ``normal_`` / ``uniform_`` /
  ``exponential_`` / ``bernoulli_`` / ``random_`` / ... (``nn.init``'s
  among them) — called without ``generator=``, and every ``*_like``
  draw (which takes no generator). Such a draw reads the process-wide
  generator, so a stream's tokens depend on whatever else drew before
  it: another engine, a test, a weight init;
- **a slot generator reseeded or restored outside admission** —
  ``manual_seed`` / ``set_state`` on an element of a ``self.<attr>``
  list of ``torch.Generator`` s, anywhere but in ``_admit`` and the
  same-file functions it reaches (``_prefill_into``,
  ``_chunked_enter``). A reseed mid-stream replays the stream's draws
  from its first token.

Scope: files under ``serving/`` and ``models/`` (the sampling and
initialization code); training data shuffles elsewhere keep their own
conventions.

The reference's central rule — a PRNG key consumed twice with no
rebinding between — has no torch hazard: a ``torch.Generator`` is
stateful and every draw advances it, so there is no key to reuse; the
same draw twice is impossible without restoring its state, which the
second rule covers. Suppress a justified case with
``# analysis: rng-ok``.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Sequence, Set

from distkeras_torch.analysis.core import Finding, Pass, SourceFile

# random draws that take ``generator=`` (functions and methods alike)
DRAWS = {
    "rand", "randn", "randint", "randperm", "normal", "multinomial",
    "bernoulli", "poisson", "normal_", "uniform_", "exponential_",
    "bernoulli_", "random_", "geometric_", "cauchy_", "log_normal_",
    "trunc_normal_", "xavier_uniform_", "xavier_normal_",
    "kaiming_uniform_", "kaiming_normal_", "orthogonal_", "sparse_",
}
# random draws that cannot take one: always the global RNG
GLOBAL_ONLY = {"rand_like", "randn_like", "randint_like"}
RESEEDS = {"manual_seed", "set_state", "seed"}
ADMISSION_ROOT = "_admit"


def _dotted(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _makes_generator(node: ast.AST) -> bool:
    """``torch.Generator(...)``, possibly chained (``.manual_seed(0)``)."""
    while isinstance(node, ast.Call):
        if _dotted(node.func).split(".")[-1] == "Generator":
            return True
        if not isinstance(node.func, ast.Attribute):
            return False
        node = node.func.value
    return False


def _slot_generator_attrs(tree: ast.Module) -> Set[str]:
    """``self.<attr>`` names assigned a list of generators."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        v = node.value
        elts = ([v.elt] if isinstance(v, ast.ListComp)
                else v.elts if isinstance(v, ast.List) else [])
        if not elts or not all(_makes_generator(e) for e in elts):
            continue
        for t in node.targets:
            if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                out.add(t.attr)
    return out


def _admission_functions(tree: ast.Module) -> Set[str]:
    """``_admit`` and every same-file function it reaches."""
    defs: Dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, node)
    if ADMISSION_ROOT not in defs:
        return set()
    seen, todo = {ADMISSION_ROOT}, [ADMISSION_ROOT]
    while todo:
        for node in ast.walk(defs[todo.pop()]):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = (f.id if isinstance(f, ast.Name)
                    else f.attr if (isinstance(f, ast.Attribute)
                                    and isinstance(f.value, ast.Name)
                                    and f.value.id == "self")
                    else None)
            if name in defs and name not in seen:
                seen.add(name)
                todo.append(name)
    return seen


def _slot_subscript(node: ast.AST, attrs: Set[str]) -> Optional[str]:
    """The slot-generator attr of ``self.<attr>[...]``, else None."""
    if (isinstance(node, ast.Subscript)
            and isinstance(node.value, ast.Attribute)
            and isinstance(node.value.value, ast.Name)
            and node.value.value.id == "self"
            and node.value.attr in attrs):
        return node.value.attr
    return None


class RngDisciplinePass(Pass):
    rule = "rng-discipline"
    suppression = "rng-ok"

    def __init__(self, scopes: Sequence[str] = ("serving", "models")):
        self.scopes = tuple(scopes)

    def _in_scope(self, rel: str) -> bool:
        return any(part in self.scopes for part in rel.split("/")[:-1])

    def run(self, src: SourceFile) -> Iterator[Finding]:
        if not self._in_scope(src.rel):
            return
        attrs = _slot_generator_attrs(src.tree)
        admission = _admission_functions(src.tree) if attrs else set()
        for fn in ast.walk(src.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._global_draws(src, fn)
                if attrs and fn.name not in admission:
                    yield from self._reseeds(src, fn, attrs)

    def _own_calls(self, fn) -> Iterator[ast.Call]:
        """Calls in ``fn`` itself, not in a nested def (scanned alone)."""
        stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(node, ast.Call):
                yield node
            stack.extend(ast.iter_child_nodes(node))

    def _global_draws(self, src: SourceFile, fn) -> Iterator[Finding]:
        for call in self._own_calls(fn):
            name = _dotted(call.func).split(".")[-1] or getattr(
                call.func, "attr", "")
            explicit = any(kw.arg == "generator" for kw in call.keywords)
            if name in GLOBAL_ONLY or (name in DRAWS and not explicit):
                yield Finding(
                    rule=self.rule, path=src.rel, line=call.lineno,
                    key=f"{fn.name}.{name}:global-rng",
                    message=(
                        f"{name}() in {fn.name}() draws from the global "
                        f"RNG (no generator=): the draw depends on every "
                        f"other draw in the process — pass the slot's or "
                        f"the call's own torch.Generator"),
                )

    def _reseeds(self, src: SourceFile, fn,
                 attrs: Set[str]) -> Iterator[Finding]:
        # locals bound to a slot generator: g = self._gens[s], or a loop
        # over self._gens
        local: Dict[str, str] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                attr = _slot_subscript(node.value, attrs)
                if attr:
                    local[node.targets[0].id] = attr
            elif isinstance(node, (ast.For, ast.comprehension)) \
                    and isinstance(node.target, ast.Name):
                it = node.iter
                if (isinstance(it, ast.Attribute)
                        and isinstance(it.value, ast.Name)
                        and it.value.id == "self" and it.attr in attrs):
                    local[node.target.id] = it.attr
        for call in self._own_calls(fn):
            f = call.func
            if not (isinstance(f, ast.Attribute) and f.attr in RESEEDS):
                continue
            attr = _slot_subscript(f.value, attrs)
            if attr is None and isinstance(f.value, ast.Name):
                attr = local.get(f.value.id)
            if attr is None:
                continue
            yield Finding(
                rule=self.rule, path=src.rel, line=call.lineno,
                key=f"{fn.name}.{attr}:{f.attr}",
                message=(
                    f"{fn.name}() calls {f.attr}() on a slot generator "
                    f"(self.{attr}[...]) outside admission: a slot's "
                    f"stream is seeded once, when its request is "
                    f"admitted, and advanced only by its own draws"),
            )
