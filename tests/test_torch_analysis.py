"""The port's static analysis (``distkeras_torch/analysis/``) on the CPU:

- the five neutral modules, the import pass and the wire pass are the
  reference's text with the package renamed, plus declared substitutions
  (the wire pass's op reference path, two docstring phrases);
- each of the nine passes flags a violation planted in a copy of a REAL
  port file (the discipline of ``tests/test_analysis.py`` and
  ``tests/test_contracts.py``), and the four rewritten for torch leave
  the unmodified files clean — ``np.asarray`` of the host list of block
  ids in ``ServingEngine._upload_blocks`` included;
- ``python -m distkeras_torch.analysis --strict`` exits 0 on the tree,
  with the port's own baseline, and ``protocol --check`` round-trips the
  port's own op reference;
- against the JAX package: the reference's neutral passes and their
  copies give the same findings over ``distkeras_torch/``, and the two
  wire extractions differ only in the request fields of ``export_kv``
  and ``import_kv`` (the port's handlers read them where the
  extractor sees the reads);
- ``ServingEngine.mark_steady()`` / ``recompiles_since_mark()``: empty
  after a CPU warm-up, a forced ``note()`` shows.
"""

import json
import os
import shutil
import textwrap

import numpy as np
import pytest

import distkeras_torch
from distkeras_torch.analysis import default_passes
from distkeras_torch.analysis import analyze
from distkeras_torch.analysis.__main__ import main as analysis_main
from distkeras_torch.analysis.core import iter_source_files
from distkeras_torch.analysis.donation import DonationSafetyPass
from distkeras_torch.analysis.hostsync import HostSyncHazardPass
from distkeras_torch.analysis.imports import ImportHygienePass
from distkeras_torch.analysis.locks import LockDisciplinePass
from distkeras_torch.analysis.metrics_contract import MetricContractPass
from distkeras_torch.analysis.recompile import RecompileHazardPass
from distkeras_torch.analysis.rng import RngDisciplinePass
from distkeras_torch.analysis.spans import SpanContractPass
from distkeras_torch.analysis.wire import WireContractPass, extract_protocol

PKG = os.path.dirname(os.path.abspath(distkeras_torch.__file__))
ROOT = os.path.dirname(PKG)
REF = os.path.join(ROOT, "distkeras_tpu")
ENGINE = os.path.join(PKG, "serving", "engine.py")
SERVER = os.path.join(PKG, "serving", "server.py")
ROUTER = os.path.join(PKG, "serving", "router.py")
TRACE = os.path.join(PKG, "telemetry", "trace.py")
SPLASH = os.path.join(PKG, "ops", "splash_prefill.py")

# module -> the lines that differ from the reference's beyond the package
# rename, by line number, as the port has them: the port's op reference
# (wire.py :45, :688), and two docstring phrases that name the reference's
# history (core.py :187-188, wire.py :5)
COPIES = {
    "core": {
        187: "        keep their justification, new keys get a TODO marker a",
        188: "        maintainer must replace. Returns the entry count "
             "written.\"\"\"",
    },
    "locks": {}, "spans": {}, "metrics_contract": {}, "lockorder": {},
    "imports": {},
    "wire": {
        5: "(the router's \"wire-compatible front door\" claim), and the "
           "payload builders",
        45: "``distkeras_torch/analysis/PROTOCOL.md`` (drift-checked in CI). "
            "Suppress findings with",
        688: "      \"--out distkeras_torch/analysis/PROTOCOL.md`; check with "
             "`--check distkeras_torch/analysis/PROTOCOL.md`.\")",
    },
}


@pytest.mark.parametrize("name", sorted(COPIES))
def test_copied_modules_match_reference(name):
    """Each copied module equals the reference's once ``distkeras_tpu``
    reads ``distkeras_torch``, except at the declared lines."""
    with open(os.path.join(REF, "analysis", name + ".py")) as f:
        ref = f.read().replace("distkeras_tpu", "distkeras_torch")
    with open(os.path.join(PKG, "analysis", name + ".py")) as f:
        mine = f.read()
    ref_lines, my_lines = ref.split("\n"), mine.split("\n")
    assert len(ref_lines) == len(my_lines)
    differ = {i + 1: b for i, (a, b) in enumerate(zip(ref_lines, my_lines))
              if a != b}
    assert differ == COPIES[name]


def test_default_passes_keep_the_reference_rules():
    """The nine passes keep the reference's rule ids and suppression
    slugs, in its report order."""
    from distkeras_tpu.analysis import default_passes as ref_passes

    mine = [(p.rule, p.suppression) for p in default_passes()]
    assert mine == [(p.rule, p.suppression) for p in ref_passes()]
    assert len(set(mine)) == 9


# -- seeded violations in copies of real port files ------------------------


def _seed(tmp_path, src, old, new, rel=None):
    """Copy a real port file to ``tmp_path/distkeras_torch/<rel>`` with
    one edit; the anchor must exist, so a refactor that moves it fails
    here loudly."""
    rel = rel or os.path.relpath(src, PKG)
    text = open(src).read()
    seeded = text.replace(old, new, 1)
    assert seeded != text, f"anchor not found in {src}: {old!r}"
    dst = tmp_path / "distkeras_torch" / rel
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(seeded)
    return str(dst)


def _copy(tmp_path, src):
    dst = tmp_path / "distkeras_torch" / os.path.relpath(src, PKG)
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(src, dst)
    return str(dst)


def _keys(findings):
    return {f.key for f in findings}


_PLAN_ANCHOR = ("        S = self.slots\n        cfgs = self._cfgs()\n"
                "        n_dec = sum(1 for st in self._slots if st and "
                "st.decoding)\n")


@pytest.mark.parametrize("line, key", [
    ("        peek = self._last_logits[0, 0].item()\n",
     "_plan_dispatch_mixed:_plan_dispatch_mixed.item"),
    ("        if self._last_logits.isnan().any():\n            pass\n",
     "_plan_dispatch_mixed:_plan_dispatch_mixed.bool"),
    ("        torch.cuda.synchronize()\n",
     "_plan_dispatch_mixed:_plan_dispatch_mixed.cuda.synchronize"),
    ("        peek = np.asarray(self._last_logits)\n",
     "_plan_dispatch_mixed:_plan_dispatch_mixed.np.asarray"),
])
def test_hostsync_flags_readback_hoisted_into_plan(tmp_path, line, key):
    """A readback of a device value (or a barrier) hoisted into
    ``_plan_dispatch_mixed`` is pinned to that function."""
    e = _seed(tmp_path, ENGINE, _PLAN_ANCHOR, _PLAN_ANCHOR + line)
    findings = analyze([e], passes=[HostSyncHazardPass()])
    assert key in _keys(findings), [f.render() for f in findings]
    assert all(f.key.startswith("_plan_dispatch_mixed:")
               for f in findings), [f.render() for f in findings]


def test_hostsync_follows_device_values_into_helpers(tmp_path):
    """A readback inside a same-file helper names the plan that reaches
    it; the taint follows the device tensor through a parameter, while
    ``np.asarray`` of the host list beside it stays clean."""
    e = _seed(tmp_path, ENGINE,
              "        idx = self._to_device(np.asarray(dsts, np.int64))\n",
              "        idx = self._to_device(np.asarray(dsts, np.int64))\n"
              "        first = int(idx[0])\n")
    keys = _keys(analyze([e], passes=[HostSyncHazardPass()]))
    assert keys == {"_plan_dispatch_mixed:_upload_blocks.int",
                    "_plan_dispatch_spec:_upload_blocks.int"}


def test_hostsync_host_values_are_not_tainted(tmp_path):
    p = tmp_path / "distkeras_torch" / "m.py"
    p.parent.mkdir(parents=True)
    p.write_text(textwrap.dedent("""
        import numpy as np
        import torch

        class E:
            def __init__(self):
                self.dev = torch.zeros(4, device="cuda")

            def _plan_dispatch_x(self, blocks):
                ids = np.asarray(blocks, np.int64)      # host list
                n = int(ids.sum())                      # host numpy
                hist = np.zeros(3).tolist()             # host numpy
                if len(blocks) and n:                   # host truth
                    pass
                self._helper(self.dev + 1)

            def _helper(self, t):
                return t.sum().item()                   # device: flagged
    """))
    findings = analyze([str(p)], passes=[HostSyncHazardPass()])
    assert _keys(findings) == {"_plan_dispatch_x:_helper.item"}


def test_rng_flags_a_draw_without_its_generator(tmp_path):
    """Dropping ``generator=`` from the verify's accept uniforms makes
    the draw read the global RNG."""
    e = _seed(tmp_path, ENGINE,
              "torch.rand(k, generator=gens[s], device=dev)",
              "torch.rand(k, device=dev)")
    assert e.endswith(os.path.join("serving", "engine.py"))
    # scan the copy's package root: the rule's scope is by package path
    findings = analyze([str(tmp_path / "distkeras_torch")],
                       passes=[RngDisciplinePass()])
    assert _keys(findings) == {"_spec_accept.rand:global-rng"}


def test_rng_flags_a_reseed_outside_admission(tmp_path):
    e = _seed(tmp_path, ENGINE, _PLAN_ANCHOR,
              _PLAN_ANCHOR + "        self._gens[0].manual_seed(1)\n")
    assert e.endswith(os.path.join("serving", "engine.py"))
    findings = analyze([str(tmp_path / "distkeras_torch")],
                       passes=[RngDisciplinePass()])
    assert _keys(findings) == {"_plan_dispatch_mixed._gens:manual_seed"}


def test_rng_scope_is_serving_and_models(tmp_path):
    """The same draw outside ``serving/`` and ``models/`` is not this
    rule's business."""
    src = "import torch\n\ndef f():\n    return torch.rand(3)\n"
    for sub in ("models", "data"):
        p = tmp_path / "distkeras_torch" / sub / "m.py"
        p.parent.mkdir(parents=True)
        p.write_text(src)
        found = analyze([str(tmp_path / "distkeras_torch")],
                        passes=[RngDisciplinePass()])
        assert len(found) == 1, [f.render() for f in found]
        assert found[0].path == "distkeras_torch/models/m.py"


def test_donation_flags_a_write_after_the_upload(tmp_path):
    """The pinned source of ``_to_device``'s non-blocking copy written
    after the copy is queued."""
    e = _seed(tmp_path, ENGINE,
              "        return pinned.to(self._device, non_blocking=True)\n",
              "        dev = pinned.to(self._device, non_blocking=True)\n"
              "        pinned.fill_(0)\n"
              "        return dev\n")
    findings = analyze([e], passes=[DonationSafetyPass()])
    assert _keys(findings) == {"_to_device.pinned:h2d"}


def test_donation_flags_a_read_before_the_fence(tmp_path):
    """``_d2h``'s pinned destinations read before their event."""
    e = _seed(tmp_path, ENGINE,
              "    ev = torch.cuda.Event()\n    ev.record(",
              "    peek = hosts[0].sum()\n"
              "    ev = torch.cuda.Event()\n    ev.record(")
    findings = analyze([e], passes=[DonationSafetyPass()])
    assert _keys(findings) == {"_d2h.hosts:d2h"}


def test_donation_sees_every_engine_copy_site():
    """The pass recognizes the engine's five asynchronous copy sites
    (and finds them clean: ``test_cli_strict_clean``)."""
    import ast

    tree = ast.parse(open(ENGINE).read())
    sites = {fn.name: DonationSafetyPass.copies(fn) for fn in ast.walk(tree)
             if isinstance(fn, ast.FunctionDef)
             and DonationSafetyPass.copies(fn)}
    assert {k: [(d, b) for d, b, _ in v] for k, v in sites.items()} == {
        "_d2h": [("d2h", "h")], "update_weights": [("h2d", "host")],
        "_gather_blocks": [("d2h", "h")],
        "_upload_blocks": [("h2d", "stacked")],
        "_to_device": [("h2d", "pinned")]}


def test_recompile_flags_an_unhashable_lru_cache_argument(tmp_path):
    s = _seed(tmp_path, SPLASH,
              "return _sm_count(torch.cuda.current_device() if index is None "
              "else index)",
              "return _sm_count([index])")
    findings = analyze([s], passes=[RecompileHazardPass()])
    assert _keys(findings) == {"sm_count._sm_count"}


def test_recompile_flags_fresh_arguments_of_compiled_calls(tmp_path):
    p = tmp_path / "distkeras_torch" / "m.py"
    p.parent.mkdir(parents=True)
    p.write_text(textwrap.dedent("""
        import torch

        fast = torch.compile(lambda x, dims: x.sum(dims))

        def step(x, k):
            torch.compile(lambda y: y * 2)
            return fast(x, (0,)) + fast(x, [k])
    """))
    findings = analyze([str(p)], passes=[RecompileHazardPass()])
    assert _keys(findings) == {"step.compile", "step.fast"}


def test_span_flags_a_renamed_decode_span(tmp_path):
    e = _seed(tmp_path, ENGINE,
              'req.trace_id, "decode", decode_t0, decode_ms,',
              'req.trace_id, "decode2", decode_t0, decode_ms,')
    findings = analyze([e, _copy(tmp_path, TRACE)],
                       passes=[SpanContractPass()])
    hits = [f for f in findings if f.key == "unattributed-span.decode2"]
    assert hits and hits[0].path.endswith("engine.py")


def test_wire_flags_a_dropped_router_arm(tmp_path):
    r = _seed(tmp_path, ROUTER, 'elif op == "trace_dump":',
              'elif op == "trace_dump_disabled":')
    findings = analyze([_copy(tmp_path, SERVER), r],
                       passes=[WireContractPass()])
    hits = [f for f in findings if f.key == "unproxied-op.trace_dump"]
    assert hits and "Router._handle" in hits[0].message


def test_metric_flags_a_label_renamed_at_one_site(tmp_path):
    r = _seed(tmp_path, ROUTER, "decision=decision).inc()",
              "why=decision).inc()")
    findings = analyze([r], passes=[MetricContractPass()])
    assert any(f.key.startswith("label-mismatch.router_requests_routed_total")
               for f in findings), [f.render() for f in findings]


def test_lock_flags_an_unguarded_read(tmp_path):
    s = _seed(tmp_path, SERVER,
              "        with self._conns_lock:\n            conns = "
              "list(self._conns)\n",
              "        conns = list(self._conns)\n")
    findings = analyze([s], passes=[LockDisciplinePass()])
    assert "LMServer._conns@stop" in _keys(findings)


def test_imports_flag_torch_in_a_stdlib_layer(tmp_path):
    reg = os.path.join(PKG, "telemetry", "registry.py")
    t = _seed(tmp_path, reg, "import threading\n",
              "import threading\n\nimport torch\n")
    findings = analyze([str(tmp_path / "distkeras_torch")],
                       passes=[ImportHygienePass()])
    assert _keys(findings) == {"third-party.torch"}
    assert findings[0].path == "distkeras_torch/telemetry/registry.py"
    assert t.endswith("registry.py")


# -- the real tree -----------------------------------------------------------


def test_cli_strict_clean(capsys):
    """``python -m distkeras_torch.analysis --strict`` exits 0 on the
    installed package with the port's baseline: the five baselined
    findings mirror the reference's, every one justified. ``report
    --json`` lists the nine rules, and none of them reports
    ``serving/engine.py`` (its ``np.asarray`` of a host list of block
    ids in plan scope included)."""
    assert analysis_main(["--strict"]) == 0
    out = capsys.readouterr().out
    assert "5 finding(s) — 0 new, 5 baselined" in out
    base = os.path.join(PKG, "analysis", "baseline.txt")
    lines = [ln for ln in open(base) if ln.strip() and ln[0] != "#"]
    assert len(lines) == 5
    assert all("TODO" not in ln for ln in lines)
    assert analysis_main(["report", "--json", ENGINE]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["rules"] == [p.rule for p in default_passes()]
    assert len(rep["rules"]) == 9
    assert rep["findings"] == [] and rep["new"] == 0


def test_protocol_doc_round_trips(capsys):
    """``protocol --check`` defaults to the port's own op reference."""
    assert analysis_main(["protocol", "--check"]) == 0
    assert "up to date" in capsys.readouterr().out


def test_neutral_passes_agree_with_the_reference():
    """The reference's lock, span, metric and wire passes and their
    copies give the same findings over ``distkeras_torch/``."""
    from distkeras_tpu.analysis import analyze as ref_analyze
    from distkeras_tpu.analysis.locks import LockDisciplinePass as RL
    from distkeras_tpu.analysis.metrics_contract import (
        MetricContractPass as RM)
    from distkeras_tpu.analysis.spans import SpanContractPass as RS
    from distkeras_tpu.analysis.wire import WireContractPass as RW

    def rows(fs):
        return [(f.rule, f.path, f.line, f.key, f.message) for f in fs]

    mine = analyze([PKG], passes=[LockDisciplinePass(), SpanContractPass(),
                                  MetricContractPass(), WireContractPass()])
    theirs = ref_analyze([PKG], passes=[RL(), RS(), RM(), RW()])
    assert rows(mine) == rows(theirs)
    assert len(mine) == 5


def test_wire_extractions_differ_only_in_kv_request_fields():
    """Ops, proxied flags, reply keys and client sends agree between the
    reference's extraction (of its package) and the port's (of the
    port); request fields differ in exactly two rows: the port's
    handlers read ``export_kv``'s ``prompt`` and ``import_kv``'s
    ``blocks`` and ``prompt`` outside a lambda, where the extractor
    sees them."""
    from distkeras_tpu.analysis.core import (
        iter_source_files as ref_files)
    from distkeras_tpu.analysis.wire import extract_protocol as ref_extract

    ref = ref_extract(ref_files([os.path.join(REF, "serving")]))
    mine = extract_protocol(iter_source_files([os.path.join(PKG,
                                                            "serving")]))
    for side in ("server", "router"):
        a, b = getattr(ref, side), getattr(mine, side)
        assert sorted(a.arms) == sorted(b.arms)
        assert a.has_unknown_arm == b.has_unknown_arm
        assert a.stream_keys == b.stream_keys
        for op in a.arms:
            ra, ma = a.arms[op], b.arms[op]
            assert (ra.reply_keys, ra.reply_wildcard, ra.refusal_only) == (
                ma.reply_keys, ma.reply_wildcard, ma.refusal_only), op
    assert sorted(ref.client.ops) == sorted(mine.client.ops)
    for op, cop in ref.client.ops.items():
        assert set(cop.sends) == set(mine.client.ops[op].sends), op
        assert set(cop.reads) == set(mine.client.ops[op].reads), op
    def rows(proto):
        """Request fields per op as the op reference renders them: the
        LMServer arm's, then the Router arm's for fields it lacks."""
        out = {}
        for side in ("server", "router"):
            for op, arm in getattr(proto, side).arms.items():
                row = out.setdefault(op, {})
                for f, (kind, _) in arm.fields.items():
                    row.setdefault(f, kind)
        return out

    theirs, ours = rows(ref), rows(mine)
    assert sorted(theirs) == sorted(ours)
    assert {op: (theirs[op], ours[op]) for op in theirs
            if theirs[op] != ours[op]} == {
        "export_kv": ({}, {"prompt": "required"}),
        "import_kv": ({}, {"blocks": "required", "prompt": "required"}),
    }
    # per arm, one more: the port's LMServer reads reconfigure's role
    # itself, where the reference's reads it inside a lambda (its row
    # is equal: the Router's arm reads the field in both packages)
    arm_drift = {
        op for op, arm in ref.server.arms.items()
        if set(arm.fields) != set(mine.server.arms[op].fields)}
    assert arm_drift == {"export_kv", "import_kv", "reconfigure"}
    assert "role" in ref.router.arms["reconfigure"].fields


# -- the engine's recompile counter -----------------------------------------


def test_engine_recompiles_since_mark_on_the_cpu():
    """After a warm-up and ``mark_steady()``, more traffic builds,
    loads and first-launches nothing on the CPU: the dict is empty and
    ``stats()`` carries it; a forced note shows in it."""
    import torch

    from distkeras_torch import telemetry
    from distkeras_torch.models import get_model
    from distkeras_torch.serving import ServingEngine
    from distkeras_torch.telemetry.runtime import recompiles

    lm = get_model("transformer_lm", dtype=torch.float32, device="cpu",
                   seed=0, vocab_size=61, d_model=32, num_heads=2,
                   num_layers=1, max_len=48)
    eng = ServingEngine(lm, slots=2, paged=True, block_size=8,
                        prefill_chunk=8, device="cpu",
                        registry=telemetry.MetricRegistry(),
                        tracer=telemetry.Tracer(), flight=True)
    rng = np.random.default_rng(0)

    def burst():
        for _ in range(3):
            eng.submit(rng.integers(0, 61, size=11).astype(np.int32), 5)
        eng.drain()

    burst()
    eng.mark_steady()
    burst()
    assert eng.recompiles_since_mark() == {}
    st = eng.stats()
    assert st["recompiles_since_mark"] == {}
    assert isinstance(st["recompiles"], dict)
    recompiles.note("kernel.test_forced")
    assert eng.recompiles_since_mark() == {"kernel.test_forced": 1}
    assert eng.stats()["recompiles_since_mark"] == {"kernel.test_forced": 1}
    snaps = [r for r in eng.flight.snapshots() if r.get("kind") == "tick"]
    assert snaps and all("recompiles" in r for r in snaps)
