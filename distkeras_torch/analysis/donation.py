"""Donation-safety pass, the port's counterpart: a pinned buffer handed
to an asynchronous copy is not the host's again until a fence.

The reference guards buffers donated to jitted calls: after the call
the device buffer may alias the output, so reading the old reference
is undefined. Eager torch donates nothing; its hazard of the same shape
is the asynchronous copy. Every host->device control copy of the
engine goes through a pinned buffer with ``non_blocking=True``
(``ServingEngine._to_device``, ``_upload_blocks``, the staged weights of
``update_weights``) and every readback through a pinned destination
(``_d2h``, ``_gather_blocks``). The copy is only *queued*: the DMA
engine reads the source, or writes the destination, whenever the stream
reaches it. So, until a fence — ``torch.cuda.synchronize()`` or the
``synchronize()`` of the event or stream that follows the copy —

- a **write to the pinned source** of a host->device copy changes what
  the device receives (a plan that refills its control buffer after
  queueing the upload ships the NEXT tick's control data to this one);
- a **read of the pinned destination** of a device->host copy sees
  whatever bytes have landed so far.

Neither crashes, and on the CPU (where the engine copies plainly) the
tests never see it. This pass flags, inside one function, any such write
or read that comes after the copy in source order and before the next
fence. Handing the buffer to its owner is not an access: returning it,
appending it to a list (``self._staged`` keeps every upload's source
alive until its tick is reconciled), putting it in a record. Nor is
reading its metadata (``.shape``, ``.dtype``). The owner's rule holds
after a handoff too: the buffer is the copy's until the fence.

Pinned buffers are locals bound from ``torch.empty/zeros/...(...,
pin_memory=<anything but False>)`` or ``<tensor>.pin_memory()``
(directly, in a list comprehension, or in either arm of a conditional
expression), and loop variables over such lists. A copy is asynchronous
when its ``non_blocking=`` is anything but ``False``; its direction
follows which side is pinned: ``src.to(<device>, non_blocking=...)``
and ``dst.copy_(src, ...)`` with ``src`` pinned are uploads, ``dst.copy_(
src, ...)`` with ``dst`` pinned is a readback. A rebinding of the name
ends its tracking (the next loop iteration's fresh buffer).

The reference's second half — donated inputs captured into an in-flight
record, checked because XLA executables are captured with their
buffers — has nothing to check here: the port captures no CUDA graph
(no ``torch.cuda.graph`` / ``CUDAGraph`` call site), so a record holds
plain tensor references and the caching allocator keeps them alive.

Flow sensitivity is line-ordered within one function (no CFG), like the
reference's. Suppress a justified case with ``# analysis: donation-ok``.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Tuple

from distkeras_torch.analysis.core import Finding, Pass, SourceFile

_PIN_FACTORIES = {"empty", "zeros", "ones", "full", "empty_like",
                  "zeros_like", "ones_like", "full_like", "empty_strided",
                  "tensor", "as_tensor"}
# taking a buffer's metadata reads no bytes
_META = {"shape", "dtype", "device", "ndim", "is_pinned", "numel", "size",
         "element_size", "data_ptr", "nbytes", "dim", "stride"}
# calls that hand a buffer to an owner (a list, a record) without
# reading it
_HANDOFF_METHODS = {"append", "appendleft", "extend", "insert", "put"}


def _dotted(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _expr_key(node: ast.AST) -> Optional[str]:
    """Identity of a buffer expression: 'name' or 'self.attr'."""
    if isinstance(node, ast.Name):
        return node.id
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)):
        return f"{node.value.id}.{node.attr}"
    return None


def _is_false(node: Optional[ast.AST]) -> bool:
    return isinstance(node, ast.Constant) and node.value is False


def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _pinned_expr(node: ast.AST) -> bool:
    """An expression that makes a pinned host tensor (or a list of
    them)."""
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "pin_memory":
            return True
        if _dotted(f).split(".")[-1] in _PIN_FACTORIES:
            pin = _kw(node, "pin_memory")
            return pin is not None and not _is_false(pin)
        return False
    if isinstance(node, ast.IfExp):
        return _pinned_expr(node.body) or _pinned_expr(node.orelse)
    if isinstance(node, (ast.ListComp, ast.GeneratorExp)):
        return _pinned_expr(node.elt)
    if isinstance(node, (ast.List, ast.Tuple)):
        return bool(node.elts) and all(_pinned_expr(e) for e in node.elts)
    return False


def _async(call: ast.Call) -> bool:
    nb = _kw(call, "non_blocking")
    if nb is None and isinstance(call.func, ast.Attribute):
        # positional non_blocking: copy_(src, True), to(dev, dtype, True)
        pos = {"copy_": 1, "to": 2}.get(call.func.attr)
        if pos is not None and len(call.args) > pos:
            nb = call.args[pos]
    return nb is not None and not _is_false(nb)


def _parents(fn) -> Dict[int, ast.AST]:
    out: Dict[int, ast.AST] = {}
    for node in ast.walk(fn):
        for child in ast.iter_child_nodes(node):
            out[id(child)] = node
    return out


def _stmt_end(stmt_of: Dict[int, ast.stmt], node: ast.AST) -> int:
    stmt = stmt_of.get(id(node))
    return getattr(stmt, "end_lineno", None) or node.lineno


class DonationSafetyPass(Pass):
    rule = "donation-safety"
    suppression = "donation-ok"

    def run(self, src: SourceFile) -> Iterator[Finding]:
        for node in ast.walk(src.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_function(src, node)

    @staticmethod
    def copies(fn) -> List[Tuple[str, str, int]]:
        """The asynchronous copies of one function: ``(direction, buffer,
        line)`` with direction ``"h2d"`` (the pinned buffer is the
        source) or ``"d2h"`` (it is the destination), in source order."""
        return [(d, b, ln) for d, b, ln, _ in
                DonationSafetyPass._events(fn)[0]]

    @staticmethod
    def _events(fn):
        """(copies, pinned roots, alias map, stmt map) of one function.
        Aliases map a loop variable onto the pinned list it walks."""
        pinned: Dict[str, bool] = {}
        alias: Dict[str, str] = {}
        calls = [node for node in ast.walk(fn)
                 if isinstance(node, ast.Call)
                 and isinstance(node.func, ast.Attribute)
                 and node.func.attr in ("to", "copy_") and _async(node)]
        if not calls:
            return [], pinned, alias, {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and _pinned_expr(node.value):
                for t in node.targets:
                    k = _expr_key(t)
                    if k is not None:
                        pinned[k] = True
            elif isinstance(node, (ast.For, ast.comprehension)):
                it, tgt = node.iter, node.target
                pairs = [(tgt, it)]
                if (isinstance(it, ast.Call) and _dotted(it.func) == "zip"
                        and isinstance(tgt, ast.Tuple)
                        and len(tgt.elts) == len(it.args)):
                    pairs = list(zip(tgt.elts, it.args))
                for t, i in pairs:
                    tk, ik = _expr_key(t), _expr_key(i)
                    if tk is not None and ik is not None and pinned.get(ik):
                        pinned[tk] = True
                        alias[tk] = ik
        # each node's innermost statement: the walk is breadth-first, so
        # an inner statement overwrites the one that holds it
        stmt_of: Dict[int, ast.stmt] = {}
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.stmt):
                for sub in ast.walk(stmt):
                    stmt_of[id(sub)] = stmt
        copies = []
        for node in calls:
            recv = _expr_key(node.func.value)
            end = _stmt_end(stmt_of, node)
            if node.func.attr == "to":
                if recv is not None and pinned.get(recv):
                    copies.append(("h2d", recv, end, node))
                continue
            srcs = node.args[:1] or [kw.value for kw in node.keywords
                                     if kw.arg == "src"]
            sk = _expr_key(srcs[0]) if srcs else None
            if sk is not None and pinned.get(sk):
                copies.append(("h2d", sk, end, node))
            if recv is not None and pinned.get(recv):
                copies.append(("d2h", recv, end, node))
        copies.sort(key=lambda c: c[2])
        return copies, pinned, alias, stmt_of

    def _check_function(self, src: SourceFile, fn) -> Iterator[Finding]:
        copies, _pinned, alias, stmt_of = self._events(fn)
        if not copies:
            return
        parent = _parents(fn)
        fences = sorted(
            node.lineno for node in ast.walk(fn)
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "synchronize")
        group = lambda k: alias.get(k, k)  # noqa: E731
        seen = set()
        for direction, buf, line, call in copies:
            root = group(buf)
            if (direction, root) in seen:
                continue
            fence = next((f for f in fences if f > line), None)
            names = {k for k in set(alias) | {root} if group(k) == root}
            rebinds = [n.lineno for n in ast.walk(fn)
                       if _expr_key(n) in names
                       and isinstance(getattr(n, "ctx", None), ast.Store)
                       and not isinstance(parent.get(id(n)), ast.AugAssign)
                       and n.lineno > line]
            stop = min([x for x in (fence, *rebinds) if x is not None],
                       default=None)
            for node in ast.walk(fn):
                key = _expr_key(node)
                inplace = isinstance(parent.get(id(node)), ast.AugAssign)
                if (key not in names
                        or not (inplace or isinstance(
                            getattr(node, "ctx", None), ast.Load))
                        or node.lineno <= line
                        or (stop is not None and node.lineno >= stop)):
                    continue
                if direction == "h2d":
                    hit = self._writes(node, parent)
                    what = (f"pinned source {key} of the non-blocking "
                            f"upload at line {call.lineno} is written")
                else:
                    hit = self._reads(node, parent)
                    what = (f"pinned destination {key} of the "
                            f"non-blocking readback at line "
                            f"{call.lineno} is read")
                if not hit:
                    continue
                seen.add((direction, root))
                yield Finding(
                    rule=self.rule, path=src.rel, line=node.lineno,
                    key=f"{fn.name}.{root}:{direction}",
                    message=(
                        f"{what} in {fn.name}() before any fence — the "
                        f"copy is only queued; synchronize its event or "
                        f"stream first, or copy into a fresh buffer"),
                )
                break  # one finding per buffer is enough

    @staticmethod
    def _writes(node: ast.AST, parent: Dict[int, ast.AST]) -> bool:
        """Whether this use of a buffer name writes its bytes: ``b += x``,
        ``b[i] = x``, ``b.numpy()[...] = x``, an in-place method
        (``b.fill_(0)``, ``b.copy_(x)``)."""
        p = parent.get(id(node))
        if isinstance(p, ast.AugAssign):
            return p.target is node
        inner = node
        if isinstance(p, ast.Attribute):
            q = parent.get(id(p))
            if not (isinstance(q, ast.Call) and q.func is p):
                return False
            if p.attr.endswith("_") and not p.attr.startswith("_"):
                return True  # in-place op
            if p.attr not in ("numpy", "view"):
                return False
            inner = q  # b.numpy()[...] = x writes b
        outer = parent.get(id(inner))
        return (isinstance(outer, ast.Subscript) and outer.value is inner
                and (isinstance(outer.ctx, ast.Store)
                     or isinstance(parent.get(id(outer)), ast.AugAssign)))

    @staticmethod
    def _reads(node: ast.AST, parent: Dict[int, ast.AST]) -> bool:
        """Whether this load of a buffer name reads its bytes: anything
        but a handoff (return, a list append, a record constructor's
        argument, an assignment into an attribute or container) or a
        metadata lookup."""
        p = parent.get(id(node))
        if isinstance(p, (ast.Return, ast.Tuple, ast.List)):
            return isinstance(p, (ast.Tuple, ast.List)) and (
                DonationSafetyPass._reads(p, parent))
        if isinstance(p, ast.Attribute):
            return p.attr not in _META
        if isinstance(p, ast.Call):
            f = p.func
            if isinstance(f, ast.Attribute) and f.attr in _HANDOFF_METHODS:
                return False
            return not _dotted(f).split(".")[-1][:1].isupper()
        if isinstance(p, (ast.Assign, ast.AnnAssign)):
            return False  # aliasing or handing off, not reading bytes
        if isinstance(p, ast.keyword):
            call = parent.get(id(p))
            return not (isinstance(call, ast.Call) and _dotted(
                call.func).split(".")[-1][:1].isupper())
        return True
