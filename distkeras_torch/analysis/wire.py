"""Wire-contract pass: the framed-msgpack op protocol as one model.

The serving protocol exists in three hand-written copies: the dispatch
chain in ``LMServer._handle``, the proxy chain in ``Router._handle``
(the router's "wire-compatible front door" claim), and the payload builders
in every ``ServingClient`` method. Nothing ties them together — drop a
router arm and clients against the fleet break while clients against a
bare server keep passing; rename a request field and the handler
silently reads a default. In the *Bugs as Deviant Behavior* spirit,
this pass re-derives the contract from the code itself and flags the
copies that deviate:

- ``unhandled-op.<op>`` — a client method sends an op no LMServer arm
  handles;
- ``unreachable-op.<op>`` — an LMServer arm handles an op no client
  method can send (dead protocol surface, or a missing client API);
- ``unproxied-op.<op>`` — an LMServer op with no Router arm: the
  router is no longer protocol-compatible (an arm that answers a typed
  refusal — e.g. ``flight`` — still counts as proxied);
- ``unsent-field.<op>.<field>`` — a handler reads a request field no
  client site for that op sends (checked only when every client site
  for the op is fully static: ``generate``'s ``**kw`` pass-through
  makes its field set open);
- ``unset-reply.<Class>.<op>.<key>`` — a client method reads a reply
  key some handler's success replies never set (arms that only refuse
  — all replies ``"ok": 0`` — are skipped: the client's read path is
  unreachable against them);
- ``unset-stream-key.<key>`` — the client's frame demultiplexer reads
  a stream-frame key the server's pump never sends;
- ``missing-unknown-op-arm.<Class>`` — a dispatch chain without the
  terminal typed ``{"error": "unknown_op", "op": ...}`` arm (without
  it the "handled op set" is open-ended and none of the above is
  exact);
- ``doc-drift.(missing|stale).<op>`` — the hand-written op table in
  ``server.py``'s module docstring disagrees with the dispatch chain.

Classes are found by *name* (``LMServer`` / ``Router`` /
``ServingClient``) in whatever file set is scanned, so the pass works
on the installed package and on mutated copies in tests alike; a scan
set containing none of them yields no findings.

The same extraction feeds ``python -m distkeras_torch.analysis
protocol``: :func:`extract_protocol` structures the op table and
:func:`render_protocol_md` renders it as the authoritative generated
``distkeras_torch/analysis/PROTOCOL.md`` (drift-checked in CI). Suppress findings with
``# analysis: wire-ok``.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from distkeras_torch.analysis.core import (
    Finding,
    ProjectPass,
    SourceFile,
)

SERVER_CLASS = "LMServer"
ROUTER_CLASS = "Router"
CLIENT_CLASS = "ServingClient"

# request keys that are dispatch plumbing, not payload fields
_DISPATCH_KEYS = {"op"}


def _const_str(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _dict_get_call(node, recv: str) -> Optional[Tuple[str, int]]:
    """``<recv>.get("key", ...)`` -> (key, line)."""
    if (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "get"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == recv
            and node.args):
        key = _const_str(node.args[0])
        if key is not None:
            return key, node.lineno
    return None


def _subscript_read(node, recv: str) -> Optional[Tuple[str, int]]:
    """``<recv>["key"]`` -> (key, line)."""
    if (isinstance(node, ast.Subscript)
            and isinstance(node.value, ast.Name)
            and node.value.id == recv):
        key = _const_str(node.slice)
        if key is not None:
            return key, node.lineno
    return None


@dataclass
class HandlerArm:
    """One ``elif op == "<name>"`` arm of a server dispatch chain."""

    op: str
    line: int
    handler: str                       # Class._handle or delegate method
    # field -> ("required"|"optional", line): msg["f"] vs msg.get("f")
    fields: Dict[str, Tuple[str, int]] = field(default_factory=dict)
    reply_keys: Set[str] = field(default_factory=set)   # from ok:1 replies
    reply_wildcard: bool = False       # a **expr rode a success reply
    refusal_only: bool = True          # no ok:1 reply anywhere in the arm


@dataclass
class ServerModel:
    name: str
    path: str
    line: int                          # the _handle def
    arms: Dict[str, HandlerArm] = field(default_factory=dict)
    has_unknown_arm: bool = False
    stream_keys: Set[str] = field(default_factory=set)
    error_codes: Set[str] = field(default_factory=set)
    doc_ops: Dict[str, int] = field(default_factory=dict)  # op -> doc line


@dataclass
class ClientOp:
    op: str
    method: str
    path: str
    line: int
    sends: Dict[str, int] = field(default_factory=dict)    # field -> line
    wildcard: bool = False             # msg.update(<dynamic>) widened it
    reads: Dict[str, int] = field(default_factory=dict)    # reply key -> line


@dataclass
class ClientModel:
    name: str
    path: str
    ops: Dict[str, ClientOp] = field(default_factory=dict)
    stream_reads: Dict[str, int] = field(default_factory=dict)


# -- server-side extraction --------------------------------------------------


def _reply_dicts(body: Sequence[ast.stmt], send_attrs=("_send",
                                                       "_send_entry"),
                 ) -> Iterator[ast.Dict]:
    """Every dict literal passed to a reply-send helper in ``body``."""
    for stmt in body:
        for node in ast.walk(stmt):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in send_attrs):
                for arg in node.args:
                    if isinstance(arg, ast.Dict):
                        yield arg


def _classify_reply(d: ast.Dict) -> Tuple[Optional[int], Set[str], bool]:
    """(ok value or None, literal keys, has-wildcard) for one reply."""
    ok: Optional[int] = None
    keys: Set[str] = set()
    wildcard = False
    for k, v in zip(d.keys, d.values):
        if k is None:                  # {**expr}
            wildcard = True
            continue
        key = _const_str(k)
        if key is None:
            continue
        keys.add(key)
        if key == "ok" and isinstance(v, ast.Constant):
            try:
                ok = int(v.value)
            except (TypeError, ValueError):
                ok = None
    return ok, keys, wildcard


def _collect_msg_fields(body: Sequence[ast.stmt],
                        fields: Dict[str, Tuple[str, int]]):
    for stmt in body:
        for node in ast.walk(stmt):
            got = _dict_get_call(node, "msg")
            if got is not None:
                fields.setdefault(got[0], ("optional", got[1]))
                continue
            sub = _subscript_read(node, "msg")
            if sub is not None:
                # a .get seen first keeps the field optional: the
                # guarded-subscript idiom (None if msg.get(f) is None
                # else msg[f]) reads the field only when present
                fields.setdefault(sub[0], ("required", sub[1]))


def _arm_scan(arm: HandlerArm, body: Sequence[ast.stmt],
              cls: ast.ClassDef, seen: Set[str],
              errors: Set[str]):
    """Fold one arm body (plus delegate methods receiving ``msg``)
    into the arm model."""
    _collect_msg_fields(body, arm.fields)
    for d in _reply_dicts(body):
        ok, keys, wildcard = _classify_reply(d)
        if ok == 0:
            for k, v in zip(d.keys, d.values):
                if k is not None and _const_str(k) == "error":
                    code = _const_str(v)
                    if code is not None:
                        errors.add(code)
            continue
        arm.refusal_only = False
        arm.reply_keys |= keys - {"ok"}
        arm.reply_wildcard = arm.reply_wildcard or wildcard
    # delegate helpers: self._op_x(conn, lock, msg) and friends
    for stmt in body:
        for node in ast.walk(stmt):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "self"):
                continue
            if not any(isinstance(a, ast.Name) and a.id == "msg"
                       for a in node.args):
                continue
            name = node.func.attr
            if name in seen:
                continue
            seen.add(name)
            for item in cls.body:
                if (isinstance(item, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))
                        and item.name == name):
                    arm.handler += f"+{cls.name}.{name}"
                    _arm_scan(arm, item.body, cls, seen, errors)


def _dispatch_chain(fn: ast.FunctionDef) -> Optional[ast.If]:
    """The ``if op == "...": / elif ...`` chain inside a ``_handle``
    body — the innermost If whose test compares a name against a
    string constant with ``==``."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.If):
            continue
        t = node.test
        if (isinstance(t, ast.Compare) and len(t.ops) == 1
                and isinstance(t.ops[0], ast.Eq)
                and isinstance(t.left, ast.Name)
                and _const_str(t.comparators[0]) is not None):
            return node
    return None


def _extract_server(src: SourceFile, cls: ast.ClassDef) -> ServerModel:
    model = ServerModel(name=cls.name, path=src.rel, line=cls.lineno)
    handle = None
    for item in cls.body:
        if (isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                and item.name == "_handle"):
            handle = item
    if handle is None:
        return model
    model.line = handle.lineno
    node = _dispatch_chain(handle)
    while node is not None:
        op = _const_str(node.test.comparators[0])
        arm = model.arms.setdefault(op, HandlerArm(
            op=op, line=node.lineno, handler=f"{cls.name}._handle"))
        _arm_scan(arm, node.body, cls, set(), model.error_codes)
        orelse = node.orelse
        if len(orelse) == 1 and isinstance(orelse[0], ast.If):
            nxt = orelse[0]
            if _const_str(getattr(nxt.test, "comparators", [None])[0]
                          if isinstance(nxt.test, ast.Compare)
                          else None) is not None:
                node = nxt
                continue
            orelse = [nxt]
        # terminal else arm: typed unknown_op reply?
        for d in _reply_dicts(orelse):
            _, keys, _ = _classify_reply(d)
            for k, v in zip(d.keys, d.values):
                if (k is not None and _const_str(k) == "error"
                        and _const_str(v) == "unknown_op"
                        and "op" in keys):
                    model.has_unknown_arm = True
            for k, v in zip(d.keys, d.values):
                if k is not None and _const_str(k) == "error":
                    code = _const_str(v)
                    if code is not None:
                        model.error_codes.add(code)
        node = None
    # typed error codes also ride the except clauses around the chain
    for d in _reply_dicts(handle.body):
        ok, _, _ = _classify_reply(d)
        if ok == 0:
            for k, v in zip(d.keys, d.values):
                if k is not None and _const_str(k) == "error":
                    code = _const_str(v)
                    if code is not None:
                        model.error_codes.add(code)
    # stream frames: dict literals the pump pushes (no "ok" key)
    for item in cls.body:
        if (isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                and item.name == "_pump"):
            for d in _reply_dicts(item.body):
                ok, keys, _ = _classify_reply(d)
                if ok is None and "ok" not in keys:
                    model.stream_keys |= keys
    # the hand-written op table in the module docstring
    doc = ast.get_docstring(src.tree, clean=False) or ""
    for m in re.finditer(r"\{\"op\":\s*\"(\w+)\"", doc):
        line = doc.count("\n", 0, m.start()) + 1  # docstring opens L1
        model.doc_ops.setdefault(m.group(1), line)
    return model


# -- client-side extraction --------------------------------------------------


def _payload_of(method: ast.FunctionDef, call: ast.Call,
                ) -> Tuple[Optional[str], Dict[str, int], bool]:
    """(op, fields sent with lines, wildcard) for one ``self._call``
    payload — an inline dict literal, or a local ``msg`` dict built
    from a literal plus ``msg["k"] = ...`` / ``msg.update(...)``."""
    fields: Dict[str, int] = {}
    op = None
    wildcard = False

    def eat_dict(d: ast.Dict):
        nonlocal op, wildcard
        for k, v in zip(d.keys, d.values):
            if k is None:
                wildcard = True
                continue
            key = _const_str(k)
            if key is None:
                continue
            if key == "op":
                op = _const_str(v)
            else:
                fields.setdefault(key, k.lineno)

    arg = call.args[0] if call.args else None
    if isinstance(arg, ast.Dict):
        eat_dict(arg)
        return op, fields, wildcard
    if not isinstance(arg, ast.Name):
        return None, fields, True
    var = arg.id
    for node in ast.walk(method):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for tgt in targets:
                if (isinstance(tgt, ast.Name) and tgt.id == var
                        and isinstance(node.value, ast.Dict)):
                    eat_dict(node.value)
                sub = _subscript_read(tgt, var)
                if sub is not None:
                    fields.setdefault(sub[0], sub[1])
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "update"
              and isinstance(node.func.value, ast.Name)
              and node.func.value.id == var):
            if node.args and isinstance(node.args[0], ast.Dict):
                eat_dict(node.args[0])
            else:
                wildcard = True          # dynamic widening (**kw style)
    return op, fields, wildcard


def _reply_reads(method: ast.FunctionDef, call: ast.Call,
                 ) -> Dict[str, int]:
    """Reply keys the method reads off this ``_call`` result: direct
    ``self._call(...)["key"]`` subscripts, or reads through the local
    the result was assigned to."""
    reads: Dict[str, int] = {}
    var: Optional[str] = None
    for node in ast.walk(method):
        if isinstance(node, ast.Subscript) and node.value is call:
            key = _const_str(node.slice)
            if key is not None:
                reads.setdefault(key, node.lineno)
        if isinstance(node, ast.Assign) and node.value is call:
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    var = tgt.id
    if var is not None:
        for node in ast.walk(method):
            sub = _subscript_read(node, var)
            if sub is not None:
                reads.setdefault(*sub)
                continue
            got = _dict_get_call(node, var)
            if got is not None:
                reads.setdefault(*got)
    return reads


def _extract_client(src: SourceFile, cls: ast.ClassDef) -> ClientModel:
    model = ClientModel(name=cls.name, path=src.rel)
    for item in cls.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if item.name == "_read_loop":
            # the stream demultiplexer: keys read off tagged frames
            for node in ast.walk(item):
                sub = _subscript_read(node, "msg")
                if sub is not None:
                    model.stream_reads.setdefault(*sub)
                    continue
                got = _dict_get_call(node, "msg")
                if got is not None:
                    model.stream_reads.setdefault(*got)
                if (isinstance(node, ast.Compare)
                        and len(node.ops) == 1
                        and isinstance(node.ops[0], ast.In)
                        and isinstance(node.comparators[0], ast.Name)
                        and node.comparators[0].id == "msg"):
                    key = _const_str(node.left)
                    if key is not None:
                        model.stream_reads.setdefault(key, node.lineno)
            continue
        if item.name == "_call":
            continue                    # the generic channel, not an op
        for node in ast.walk(item):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "_call"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "self"):
                continue
            op, sends, wildcard = _payload_of(item, node)
            if op is None:
                continue
            copx = model.ops.setdefault(op, ClientOp(
                op=op, method=item.name, path=src.rel,
                line=node.lineno))
            copx.sends.update(sends)
            copx.wildcard = copx.wildcard or wildcard
            copx.reads.update(_reply_reads(item, node))
    return model


# -- the protocol model ------------------------------------------------------


@dataclass
class Protocol:
    server: Optional[ServerModel] = None
    router: Optional[ServerModel] = None
    client: Optional[ClientModel] = None


def extract_protocol(srcs: Sequence[SourceFile]) -> Protocol:
    proto = Protocol()
    for src in srcs:
        for node in src.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            if node.name == SERVER_CLASS:
                proto.server = _extract_server(src, node)
            elif node.name == ROUTER_CLASS:
                proto.router = _extract_server(src, node)
            elif node.name == CLIENT_CLASS:
                proto.client = _extract_client(src, node)
    return proto


class WireContractPass(ProjectPass):
    rule = "wire-contract"
    suppression = "wire-ok"

    def run_project(self, srcs: Sequence[SourceFile],
                    ) -> Iterator[Finding]:
        proto = extract_protocol(srcs)
        server, router, client = proto.server, proto.router, proto.client

        def finding(path, line, key, msg):
            return Finding(rule=self.rule, path=path, line=line,
                           key=key, message=msg)

        if client is not None and server is not None:
            for op, cop in sorted(client.ops.items()):
                if op not in server.arms:
                    yield finding(
                        client.path, cop.line, f"unhandled-op.{op}",
                        f"{client.name}.{cop.method} sends op {op!r} "
                        f"but {server.name}._handle has no arm for it",
                    )
            for op, arm in sorted(server.arms.items()):
                if op not in client.ops:
                    yield finding(
                        server.path, arm.line, f"unreachable-op.{op}",
                        f"{server.name} handles op {op!r} but no "
                        f"{client.name} method sends it (dead protocol "
                        f"surface or missing client API)",
                    )
        if server is not None and router is not None:
            for op, arm in sorted(server.arms.items()):
                if op not in router.arms:
                    yield finding(
                        router.path, router.line, f"unproxied-op.{op}",
                        f"{router.name}._handle has no arm for "
                        f"{server.name} op {op!r}: the router is not "
                        f"protocol-compatible for it",
                    )
        # request fields: handler reads nothing can send
        if client is not None:
            for model in (server, router):
                if model is None:
                    continue
                for op, arm in sorted(model.arms.items()):
                    cop = client.ops.get(op)
                    if cop is None or cop.wildcard:
                        continue
                    for f, (_, line) in sorted(arm.fields.items()):
                        if f in _DISPATCH_KEYS or f in cop.sends:
                            continue
                        yield finding(
                            model.path, line,
                            f"unsent-field.{op}.{f}",
                            f"{arm.handler} reads request field {f!r} "
                            f"of op {op!r} but {client.name}."
                            f"{cop.method} never sends it",
                        )
        # reply keys: client reads nothing sets
        if client is not None:
            for model in (server, router):
                if model is None:
                    continue
                for op, cop in sorted(client.ops.items()):
                    arm = model.arms.get(op)
                    if (arm is None or arm.refusal_only
                            or arm.reply_wildcard):
                        continue
                    for key, line in sorted(cop.reads.items()):
                        if key in arm.reply_keys:
                            continue
                        yield finding(
                            client.path, line,
                            f"unset-reply.{model.name}.{op}.{key}",
                            f"{client.name}.{cop.method} reads reply "
                            f"key {key!r} of op {op!r} but "
                            f"{arm.handler}'s success replies never "
                            f"set it",
                        )
            if server is not None and client.stream_reads:
                for key, line in sorted(client.stream_reads.items()):
                    if key not in server.stream_keys:
                        yield finding(
                            client.path, line,
                            f"unset-stream-key.{key}",
                            f"{client.name}._read_loop reads stream-"
                            f"frame key {key!r} but {server.name}._pump "
                            f"never sends it",
                        )
        for model in (server, router):
            if model is not None and model.arms \
                    and not model.has_unknown_arm:
                yield finding(
                    model.path, model.line,
                    f"missing-unknown-op-arm.{model.name}",
                    f"{model.name}._handle dispatch has no terminal "
                    f'typed {{"error": "unknown_op", "op": ...}} arm: '
                    f"the handled op set is open-ended",
                )
        # docstring op table drift (the server file's hand-written one)
        if server is not None and server.doc_ops:
            for op, arm in sorted(server.arms.items()):
                if op not in server.doc_ops:
                    yield finding(
                        server.path, arm.line, f"doc-drift.missing.{op}",
                        f"op {op!r} is handled but absent from the "
                        f"module docstring's op table",
                    )
            for op, line in sorted(server.doc_ops.items()):
                if op not in server.arms:
                    yield finding(
                        server.path, line, f"doc-drift.stale.{op}",
                        f"module docstring documents op {op!r} which "
                        f"no dispatch arm handles",
                    )


# -- PROTOCOL.md rendering ---------------------------------------------------


def render_protocol_md(proto: Protocol) -> str:
    """The extracted protocol as the authoritative markdown op
    reference. Deterministic: regenerating from an unchanged tree
    yields byte-identical output (the CI drift check relies on it)."""
    out: List[str] = []
    w = out.append
    w("# Serving wire protocol")
    w("")
    w("<!-- GENERATED by `python -m distkeras_torch.analysis protocol` "
      "— do not edit. -->")
    w("<!-- Extracted from LMServer._handle / Router._handle / "
      "ServingClient by the wire-contract pass; CI fails on drift. -->")
    w("")
    w("All frames are msgpack dicts over the length-framed TCP "
      "transport (`distkeras_torch.networking`). Requests carry `op`; "
      "acks answer `ok: 1` with the op's reply keys, or `ok: 0` with "
      "a typed `error`.")
    w("")
    server, router, client = proto.server, proto.router, proto.client
    ops: Set[str] = set()
    if server:
        ops |= set(server.arms)
    if router:
        ops |= set(router.arms)
    if client:
        ops |= set(client.ops)
    w("## Ops")
    w("")
    w("| op | client method | request fields | ok-reply keys | "
      "LMServer | Router |")
    w("|---|---|---|---|---|---|")
    for op in sorted(ops):
        cop = client.ops.get(op) if client else None
        arm = server.arms.get(op) if server else None
        rarm = router.arms.get(op) if router else None
        fields = dict(arm.fields) if arm else {}
        if rarm:
            for f, v in rarm.fields.items():
                fields.setdefault(f, v)
        fcell = ", ".join(
            f"`{f}`" + ("?" if fields[f][0] == "optional" else "")
            for f in sorted(fields)) or "—"
        reply = set(arm.reply_keys) if arm else set()
        if rarm:
            reply |= rarm.reply_keys
        rcell = ", ".join(f"`{k}`" for k in sorted(reply)) or "—"
        if arm and arm.reply_wildcard or rarm and rarm.reply_wildcard:
            rcell += ", …"

        def hcell(a):
            if a is None:
                return "✗"
            return "refuses" if a.refusal_only else "✓"

        w(f"| `{op}` | "
          f"{'`.' + cop.method + '()`' if cop else '—'} | "
          f"{fcell} | {rcell} | {hcell(arm)} | {hcell(rarm)} |")
    w("")
    w("`field?` = read with `.get` (optional); bare = subscripted "
      "(required). `refuses` = the arm exists but only answers a "
      "typed `ok: 0` refusal. `…` = a handler merges additional keys "
      "dynamically.")
    w("")
    if server and server.stream_keys:
        w("## Stream frames")
        w("")
        w("Token streams ride the same connection, tagged per request "
          "(no `ok` key):")
        w("")
        keys = ", ".join(f"`{k}`" for k in sorted(server.stream_keys))
        w(f"- server pump frame keys: {keys}")
        if client and client.stream_reads:
            reads = ", ".join(f"`{k}`"
                              for k in sorted(client.stream_reads))
            w(f"- client demultiplexer reads: {reads}")
        w("")
    codes: Set[str] = set()
    for model in (server, router):
        if model:
            # identifier-shaped literals are typed codes; anything
            # with spaces is a free-form message, not protocol surface
            codes |= {c for c in model.error_codes
                      if re.fullmatch(r"[a-z][a-z0-9_]*", c)}
    if codes:
        w("## Typed error codes")
        w("")
        w("`ok: 0` replies carry `error`; these literal codes map to "
          "typed client exceptions (anything else raises plain "
          "`RuntimeError`):")
        w("")
        for c in sorted(codes):
            w(f"- `{c}`")
        w("")
    w("Regenerate with: `python -m distkeras_torch.analysis protocol "
      "--out distkeras_torch/analysis/PROTOCOL.md`; check with `--check distkeras_torch/analysis/PROTOCOL.md`.")
    w("")
    return "\n".join(out)
