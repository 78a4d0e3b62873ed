"""Host-sync-hazard pass: plan/dispatch bodies must never block on the
device — the port's counterpart of the reference's pass, written for
eager PyTorch.

The pipelined engine loop rests on one rule: everything before the
dispatch (``_plan_dispatch_mixed`` / ``_plan_dispatch_decode`` /
``_plan_dispatch_multi`` / ``_plan_dispatch_spec``) plans from *host*
state only, and the deferred readback happens exclusively at
``_reconcile`` time, through the pinned buffer and the event that
``_d2h`` queued right behind the tick. One ``.item()`` hoisted into a
plan body blocks the host until every kernel already queued has run —
inside the very function whose whole point is to run while tick N is
still on the card. The overlap quietly disappears; nothing fails.

This pass walks every ``_plan_dispatch*`` function and everything it
calls *in the same file* (``self.<method>(...)`` and module-level
helpers, transitively) and flags the blocking shapes:

- ``.item()`` / ``.tolist()`` / ``.numpy()`` / ``.cpu()`` /
  ``.to("cpu")`` of a device value — a device-to-host readback;
- ``np.asarray(...)`` / ``np.array(...)`` / ``int(...)`` /
  ``float(...)`` / ``bool(...)`` of a device value, and a device value
  used as a truth value (``if``, ``while``, ``assert``, a conditional
  expression or a comprehension's filter: ``Tensor.__bool__``);
- ``torch.cuda.synchronize()`` and any ``<event or stream>
  .synchronize()`` — explicit barriers, flagged wherever they stand.

Unlike JAX, where every ``np.asarray`` in plan scope is a readback,
eager torch plans are full of numpy: host lists of block ids, packed
control arrays, the n-gram drafter's history. So readbacks are judged
by what they read. A file-wide, flow-insensitive taint analysis marks
the *device values*:

- a torch factory given a ``device=`` other than ``"cpu"``
  (``torch.zeros(..., device=self._device)``), a ``.to(<device>)`` /
  ``.cuda()`` move;
- anything computed from a device value: arithmetic, indexing, a
  method call on it, a call that takes it as an argument (the model's
  forward, ``torch.argmax``, ``_unpack_i32``), a container holding one;
- a ``self.<attr>`` assigned a device value anywhere in the file, a
  record field of a name some same-file constructor call is given a
  device value for (``_InflightTick(toks=toks)`` makes ``rec.toks`` one),
  a parameter that some same-file call site passes a device value, a
  same-file function that returns one.

Host values stay clean: numpy arrays and whatever numpy returns, Python
lists and numbers, tensor metadata (``.shape``, ``.dtype``,
``.device``, ``.size()``, ``.numel()``), instances of classes (a record
such as ``_InflightTick`` is not a tensor; only its device fields are),
and what a readback returns.
Tuple unpacking taints every target, so a mixed tuple over-approximates
toward findings, never away from them.

Findings are keyed ``<plan root>:<site function>.<shape>`` so a hazard
inside a shared helper names the plan path that reaches it. A justified
site takes the standard ``# analysis: host-sync-ok`` suppression.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from distkeras_torch.analysis.core import Finding, Pass, SourceFile

PLAN_PREFIX = "_plan_dispatch"

_NP_NAMES = {"np", "numpy"}
_NP_READBACKS = {"asarray", "array"}
_CAST_READBACKS = {"int", "float", "bool"}
_METHOD_READBACKS = {"item", "tolist", "numpy", "cpu"}
_CONTAINER_ADDS = {"append", "appendleft", "extend"}
# calls whose result is host data whatever they are given
_HOST_BUILTINS = {"int", "float", "bool", "len", "isinstance", "type", "id",
                  "str", "repr", "hasattr", "callable", "range", "print",
                  "format", "hash", "round", "abs"}
# tensor metadata: reading it never touches device memory
_META_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
               "requires_grad", "is_leaf", "grad_fn"}
_META_METHODS = {"size", "dim", "numel", "nelement", "element_size",
                 "data_ptr", "stride", "is_contiguous", "get_device",
                 "is_pinned", "storage_offset", "synchronize", "record",
                 "query", "wait", "record_event", "wait_event",
                 "wait_stream"}


def _walk_shallow(fn: ast.FunctionDef) -> Iterator[ast.AST]:
    """Walk a function body without descending into nested function
    defs or lambdas: those are scanned as their own functions (a nested
    def runs where it is called, not where it is defined)."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _dotted(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _callee_name(node: ast.Call) -> Optional[Tuple[str, bool]]:
    """(name, is_self_method) for calls resolvable within one file."""
    f = node.func
    if isinstance(f, ast.Name):
        return f.id, False
    if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
            and f.value.id == "self"):
        return f.attr, True
    return None


def _collect_defs(tree: ast.Module) -> Dict[str, ast.FunctionDef]:
    """Every function def in the file by name: module-level functions
    and methods alike (a name collision only widens the scope
    checked)."""
    defs: Dict[str, ast.FunctionDef] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, node)
    return defs


def _target_names(target: ast.AST) -> List[str]:
    """The names an assignment target binds (``x``, ``a, *b``), and
    the container ``x`` of ``x[i] = ...``."""
    if isinstance(target, ast.Subscript):
        target = target.value
        return [target.id] if isinstance(target, ast.Name) else []
    return [n.id for n in ast.walk(target)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)]


def _is_class_name(callee: str, classes: Set[str]) -> bool:
    short = callee.split(".")[-1]
    return short in classes or short[:1].isupper()


def _positional_params(fn: ast.FunctionDef, method_call: bool) -> List[str]:
    params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
    if method_call and params and params[0] in ("self", "cls"):
        params = params[1:]
    return params


def _to_kind(call: ast.Call, is_dev) -> str:
    """What a ``.to(...)`` call does: ``"cpu"`` (a readback),
    ``"device"`` (a move onto a device), or ``"dtype"`` (a cast that
    stays where the tensor is)."""
    target = call.args[0] if call.args else None
    for kw in call.keywords:
        if kw.arg == "device":
            target = kw.value
    if target is None:
        return "dtype"
    if isinstance(target, ast.Constant) and isinstance(target.value, str):
        return "cpu" if target.value == "cpu" else "device"
    if isinstance(target, ast.Call) and _dotted(target.func) in (
            "torch.device", "device"):
        a = target.args[0] if target.args else None
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return "cpu"
        return "device"
    name = _dotted(target)
    last = name.split(".")[-1].lower()
    if name.startswith("torch.") or "dtype" in last:
        return "dtype"
    if "dev" in last:
        return "device"
    return "device" if is_dev(target) else "dtype"


class DeviceTaint:
    """The file-wide device-value facts (see the module docstring),
    solved to a fixpoint: ``attrs`` (``self.<attr>`` names holding
    device values), ``fields`` (record fields constructed from one),
    ``returns`` (same-file functions returning one), ``params`` (per
    function name) and ``locals`` (per function node)."""

    def __init__(self, tree: ast.Module):
        self.defs = _collect_defs(tree)
        self.classes = {n.name for n in ast.walk(tree)
                        if isinstance(n, ast.ClassDef)}
        self.fns = [n for n in ast.walk(tree)
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        # each function's own nodes, walked once for every round below
        self._nodes = {id(fn): list(_walk_shallow(fn)) for fn in self.fns}
        self.attrs: Set[str] = set()
        self.fields: Set[str] = set()
        self.returns: Set[str] = set()
        self.params: Dict[str, Set[str]] = {}
        self.locals: Dict[int, Set[str]] = {}
        changed = True
        while changed:
            changed = False
            for fn in self.fns:
                changed |= self._scan(fn)

    # -- the facts -----------------------------------------------------------

    def is_dev(self, node: ast.AST, fn) -> bool:
        """Whether ``node`` (an expression inside ``fn``) may hold a
        device value."""
        dev = lambda n: self.is_dev(n, fn)  # noqa: E731
        if isinstance(node, ast.Name):
            return (node.id in self.locals.get(id(fn), ())
                    or node.id in self.params.get(fn.name, ()))
        if isinstance(node, ast.Attribute):
            if node.attr in _META_ATTRS:
                return False
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                return node.attr in self.attrs
            return node.attr in self.fields or dev(node.value)
        if isinstance(node, ast.Subscript):
            return dev(node.value)
        if isinstance(node, ast.Call):
            return self._call_is_dev(node, fn)
        if isinstance(node, ast.BinOp):
            return dev(node.left) or dev(node.right)
        if isinstance(node, ast.UnaryOp):
            return not isinstance(node.op, ast.Not) and dev(node.operand)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return any(dev(n) for n in [node.left] + node.comparators)
        if isinstance(node, ast.BoolOp):
            return any(dev(v) for v in node.values)
        if isinstance(node, ast.IfExp):
            return dev(node.body) or dev(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(dev(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return any(dev(v) for v in node.values)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return dev(node.elt)
        if isinstance(node, ast.DictComp):
            return dev(node.value)
        if isinstance(node, (ast.Starred, ast.NamedExpr, ast.Await)):
            return dev(node.value)
        return False

    def _args_dev(self, call: ast.Call, fn) -> bool:
        return any(self.is_dev(a, fn) for a in call.args) or any(
            self.is_dev(kw.value, fn) for kw in call.keywords)

    def _call_is_dev(self, call: ast.Call, fn) -> bool:
        f = call.func
        callee = _dotted(f)
        root = callee.split(".")[0]
        if root in _NP_NAMES:
            return False  # numpy returns host arrays
        if isinstance(f, ast.Name):
            if f.id in _HOST_BUILTINS:
                return False
            if _is_class_name(f.id, self.classes):
                return False  # a record: its fields are tracked by name
            if f.id in self.defs:
                return f.id in self.returns
            return self._args_dev(call, fn)
        if isinstance(f, ast.Attribute):
            m, recv = f.attr, f.value
            if m in _METHOD_READBACKS or m in _META_METHODS:
                return False
            if m == "to":
                kind = _to_kind(call, lambda n: self.is_dev(n, fn))
                if kind == "cpu":
                    return False
                if kind == "device":
                    return True
                return self.is_dev(recv, fn) or self._args_dev(call, fn)
            if m == "cuda":
                return True
            if isinstance(recv, ast.Name) and recv.id == "self":
                if m in self.defs:
                    return m in self.returns
                return self._args_dev(call, fn)
            if root == "torch" or root == "F":
                if _is_class_name(callee, self.classes):
                    return False  # torch.Generator, torch.cuda.Event
                for kw in call.keywords:
                    if kw.arg == "device" and not (
                            isinstance(kw.value, ast.Constant)
                            and kw.value.value == "cpu"):
                        return True
                return self._args_dev(call, fn)
            return self.is_dev(recv, fn) or self._args_dev(call, fn)
        return self._args_dev(call, fn)

    # -- solving -------------------------------------------------------------

    def _bind(self, fn, names: List[str]) -> bool:
        mine = self.locals.setdefault(id(fn), set())
        new = [n for n in names if n not in mine]
        mine.update(new)
        return bool(new)

    def _scan(self, fn) -> bool:
        changed = False
        for node in self._nodes[id(fn)]:
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                if node.value is None or not self.is_dev(node.value, fn):
                    continue
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    for leaf in ast.walk(t):
                        if (isinstance(leaf, ast.Attribute)
                                and isinstance(leaf.ctx, ast.Store)
                                and isinstance(leaf.value, ast.Name)
                                and leaf.value.id == "self"
                                and leaf.attr not in self.attrs):
                            self.attrs.add(leaf.attr)
                            changed = True
                    changed |= self._bind(fn, _target_names(t))
            elif isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension)):
                changed |= self._bind_iter(fn, node.target, node.iter)
            elif isinstance(node, ast.NamedExpr):
                if self.is_dev(node.value, fn):
                    changed |= self._bind(fn, [node.target.id])
            elif isinstance(node, ast.withitem):
                if (node.optional_vars is not None
                        and self.is_dev(node.context_expr, fn)):
                    changed |= self._bind(fn,
                                          _target_names(node.optional_vars))
            elif isinstance(node, ast.Return):
                if (node.value is not None and fn.name not in self.returns
                        and self.is_dev(node.value, fn)):
                    self.returns.add(fn.name)
                    changed = True
            elif isinstance(node, ast.Call):
                changed |= self._bind_params(node, fn)
                changed |= self._bind_call_effects(node, fn)
        return changed

    def _bind_call_effects(self, call: ast.Call, fn) -> bool:
        """A device value put into a container (``out.append(t)``) taints
        the container; one passed to a record's constructor by keyword
        (``_InflightTick(toks=toks)``) taints that field name."""
        f = call.func
        changed = False
        if (isinstance(f, ast.Attribute) and f.attr in _CONTAINER_ADDS
                and self._args_dev(call, fn)):
            recv = f.value
            if isinstance(recv, ast.Name):
                changed |= self._bind(fn, [recv.id])
            elif (isinstance(recv, ast.Attribute)
                  and isinstance(recv.value, ast.Name)
                  and recv.value.id == "self"
                  and recv.attr not in self.attrs):
                self.attrs.add(recv.attr)
                changed = True
        if _is_class_name(_dotted(f), self.classes):
            for kw in call.keywords:
                if (kw.arg is not None and kw.arg not in self.fields
                        and self.is_dev(kw.value, fn)):
                    self.fields.add(kw.arg)
                    changed = True
        return changed

    def _bind_iter(self, fn, target: ast.AST, it: ast.AST) -> bool:
        """Loop targets: ``zip`` and ``enumerate`` bind element-wise (the
        index of ``enumerate`` is a host int); any other iterable taints
        every target when it holds device values."""
        if (isinstance(target, ast.Tuple) and isinstance(it, ast.Call)
                and isinstance(it.func, ast.Name) and not it.keywords):
            if it.func.id == "zip" and len(it.args) == len(target.elts):
                return any([self._bind_iter(fn, t, ast.List(elts=[a]))
                            for t, a in zip(target.elts, it.args)])
            if it.func.id == "enumerate" and len(target.elts) == 2:
                return self._bind_iter(fn, target.elts[1],
                                       ast.List(elts=it.args[:1]))
        if isinstance(it, ast.List) and len(it.elts) == 1:
            it = it.elts[0]  # the one iterable a zip/enumerate arm holds
        if self.is_dev(it, fn):
            return self._bind(fn, _target_names(target))
        return False

    def _bind_params(self, call: ast.Call, fn) -> bool:
        cal = _callee_name(call)
        if cal is None or cal[0] not in self.defs:
            return False
        target = self.defs[cal[0]]
        names = _positional_params(target, cal[1])
        got = self.params.setdefault(target.name, set())
        before = len(got)
        for i, a in enumerate(call.args):
            if i < len(names) and self.is_dev(a, fn):
                got.add(names[i])
        kwonly = {a.arg for a in target.args.kwonlyargs}
        for kw in call.keywords:
            if (kw.arg is not None and (kw.arg in names or kw.arg in kwonly)
                    and self.is_dev(kw.value, fn)):
                got.add(kw.arg)
        return len(got) != before


class HostSyncHazardPass(Pass):
    rule = "host-sync-hazard"
    suppression = "host-sync-ok"

    def run(self, src: SourceFile) -> Iterator[Finding]:
        defs = _collect_defs(src.tree)
        roots = sorted(n for n in defs if n.startswith(PLAN_PREFIX))
        if not roots:
            return
        taint = DeviceTaint(src.tree)
        for root in roots:
            # reachable same-file functions, breadth-first
            order: List[str] = [root]
            seen: Set[str] = {root}
            i = 0
            while i < len(order):
                fn = defs[order[i]]
                i += 1
                for node in _walk_shallow(fn):
                    if isinstance(node, ast.Call):
                        cal = _callee_name(node)
                        if (cal is not None and cal[0] in defs
                                and cal[0] not in seen):
                            seen.add(cal[0])
                            order.append(cal[0])
            for name in order:
                yield from self._scan_fn(src, taint, root, defs[name])

    def _scan_fn(self, src: SourceFile, taint: DeviceTaint, root: str,
                 fn: ast.FunctionDef) -> Iterator[Finding]:
        where = (fn.name if fn.name == root
                 else f"{fn.name} (reached from {root})")
        dev = lambda n: taint.is_dev(n, fn)  # noqa: E731
        for node in _walk_shallow(fn):
            tests = []
            if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
                tests = [node.test]
            elif isinstance(node, ast.comprehension):
                tests = list(node.ifs)
            for t in tests:
                for cond in self._truth_operands(t):
                    if dev(cond):
                        yield self._finding(
                            src, cond, root, fn, "bool",
                            f"{where} tests a device value's truth "
                            f"(Tensor.__bool__): a one-element blocking "
                            f"sync in plan scope")
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            callee = _dotted(f)
            if callee == "torch.cuda.synchronize":
                yield self._finding(
                    src, node, root, fn, "cuda.synchronize",
                    f"{where} calls torch.cuda.synchronize(): a device "
                    f"barrier in plan scope")
            elif isinstance(f, ast.Attribute) and f.attr == "synchronize":
                yield self._finding(
                    src, node, root, fn, "synchronize",
                    f"{where} calls {callee or '<expr>'}.synchronize(): "
                    f"the host waits for the event or stream in plan "
                    f"scope (wait in _reconcile)")
            elif (isinstance(f, ast.Attribute) and f.attr in _NP_READBACKS
                  and isinstance(f.value, ast.Name)
                  and f.value.id in _NP_NAMES and node.args
                  and dev(node.args[0])):
                yield self._finding(
                    src, node, root, fn, f"np.{f.attr}",
                    f"{where} materializes a device value on the host "
                    f"via np.{f.attr}: a blocking device sync in plan "
                    f"scope (defer the readback to _reconcile)")
            elif (isinstance(f, ast.Name) and f.id in _CAST_READBACKS
                  and len(node.args) == 1 and dev(node.args[0])):
                yield self._finding(
                    src, node, root, fn, f.id,
                    f"{where} casts a device value with {f.id}(): a "
                    f"one-element blocking sync in plan scope")
            elif (isinstance(f, ast.Attribute)
                  and f.attr in _METHOD_READBACKS and dev(f.value)):
                yield self._finding(
                    src, node, root, fn, f.attr,
                    f"{where} calls .{f.attr}() on a device value: a "
                    f"blocking device-to-host readback in plan scope")
            elif (isinstance(f, ast.Attribute) and f.attr == "to"
                  and dev(f.value) and _to_kind(node, dev) == "cpu"):
                yield self._finding(
                    src, node, root, fn, "to_cpu",
                    f"{where} moves a device value to the CPU with "
                    f".to('cpu'): a blocking readback in plan scope")

    @staticmethod
    def _truth_operands(test: ast.AST) -> List[ast.AST]:
        """The operands whose truth a test evaluates: each side of
        ``and`` / ``or``, under ``not``."""
        if isinstance(test, ast.BoolOp):
            out: List[ast.AST] = []
            for v in test.values:
                out.extend(HostSyncHazardPass._truth_operands(v))
            return out
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return HostSyncHazardPass._truth_operands(test.operand)
        return [test]

    def _finding(self, src: SourceFile, node, root: str,
                 fn: ast.FunctionDef, shape: str, msg: str) -> Finding:
        return Finding(
            rule=self.rule, path=src.rel, line=node.lineno,
            key=f"{root}:{fn.name}.{shape}", message=msg,
        )
