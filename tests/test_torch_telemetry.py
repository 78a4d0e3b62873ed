"""The port's engine and server telemetry on the CPU — the serving cases
of the reference's ``tests/test_telemetry.py`` over the port (the
stdlib telemetry modules themselves are copies, held equal in
``tests/test_torch_imports.py``), run under the lock-order detector:

- a port engine emits the queued / prefill / decode / finish span chain
  and the serving metric families, the recompile gauge among them;
- an expired request is traced and counted;
- one Prometheus endpoint scrapes a live port ``LMServer`` while a
  client streams from it: text, JSON, traces, health and a 404.
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_lockorder_util import lock_order  # noqa: E402,F401

from distkeras_torch import telemetry  # noqa: E402
from distkeras_torch.models import get_model  # noqa: E402
from distkeras_torch.serving import (  # noqa: E402
    LMServer,
    ServingClient,
    ServingEngine,
)
from torch_spawn_util import one_thread  # noqa: E402,F401

KW = dict(vocab_size=64, d_model=32, num_heads=2, num_layers=2, max_len=48)


def _engine(**kw):
    lm = get_model("transformer_lm", dtype=torch.float32, device="cpu",
                   seed=0, **KW)
    reg, tr = telemetry.MetricRegistry(), telemetry.Tracer()
    kw.setdefault("slots", 2)
    return ServingEngine(lm, device="cpu", registry=reg, tracer=tr,
                         **kw), reg, tr


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.read().decode()


def test_engine_emits_span_chain_and_metrics():
    eng, reg, tr = _engine()
    reqs = [eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=4)
            for _ in range(3)]
    eng.drain()
    for req in reqs:
        req.stream.tokens(timeout=10)
        chain = {s["span"]: s for s in tr.dump(trace=req.trace_id)}
        assert {"queued", "prefill", "decode", "finish"} <= set(chain)
        assert chain["decode"]["tokens"] == 4
        assert chain["finish"]["reason"] == "length"
        assert chain["finish"]["slot"] in (0, 1)
    assert reg.counter("serving_ticks_total").value == eng.ticks
    assert reg.counter("serving_tokens_total").value == 12
    assert reg.counter("serving_requests_total",
                       labelnames=("reason",)).labels(
                           reason="length").value == 3
    assert reg.histogram("serving_ttft_ms").value["count"] == 3
    assert reg.gauge("serving_slot_occupancy").value == 0  # drained
    # the recompile gauge is refreshed on the memory-sample ticks: on the
    # CPU no kernel is built, loaded or launched by the engine
    assert "jax_recompiles" in reg.collect()
    assert eng.stats()["recompiles_since_mark"] == {}


def test_expired_request_traced():
    eng, reg, tr = _engine(slots=1)
    req = eng.submit(np.zeros(4, np.int32), max_new_tokens=2,
                     deadline_s=0.0)
    time.sleep(0.01)
    eng.drain()
    assert req.stream.tokens(timeout=10) == []
    chain = {s["span"] for s in tr.dump(trace=req.trace_id)}
    assert chain == {"queued", "finish"}
    assert reg.counter("serving_requests_total",
                       labelnames=("reason",)).labels(
                           reason="expired").value == 1


def test_http_endpoint_scrapes_live_server(lock_order):
    """One Prometheus endpoint over a live port LMServer: queue depth,
    slot occupancy, latency histograms and the request's trace. The
    detector saw the port's own locks nest, and no cycle among them."""
    eng, reg, tr = _engine()
    srv = LMServer(eng).start()
    http = telemetry.TelemetryServer(registry=reg, tracer=tr).start()
    client = None
    try:
        client = ServingClient("127.0.0.1", srv.port, timeout=60)
        rid = client.generate(list(range(1, 6)), max_new_tokens=4)
        toks, reason = client.result(rid, timeout=60)
        assert len(toks) == 4 and reason == "length"
        deadline = time.monotonic() + 5.0
        while True:
            code, text = _get(f"http://127.0.0.1:{http.port}/metrics")
            if ("serving_ttft_ms_count 1" in text
                    or time.monotonic() > deadline):
                break
            time.sleep(0.02)
        assert code == 200
        for family in ("serving_queue_depth", "serving_slot_occupancy",
                       "serving_ttft_ms_count 1", "jax_recompiles"):
            assert family in text
        code, text = _get(f"http://127.0.0.1:{http.port}/metrics.json")
        snap = json.loads(text)
        assert snap["serving_tokens_total"]["series"][0]["value"] == 4
        tid = client.trace_of(rid)
        code, text = _get(f"http://127.0.0.1:{http.port}/traces?trace={tid}")
        spans = {s["span"] for s in json.loads(text)}
        assert {"queued", "prefill", "decode", "finish"} <= spans
        assert _get(f"http://127.0.0.1:{http.port}/healthz")[1] == "ok"
        with pytest.raises(urllib.error.HTTPError):
            _get(f"http://127.0.0.1:{http.port}/nope")
    finally:
        if client is not None:
            client.close()
        http.stop()
        srv.stop()
    # ServingClient._call takes its send lock under its call lock: the
    # detector is armed and recorded that ordering
    assert lock_order.edge_count() >= 1
