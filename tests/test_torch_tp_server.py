"""``LMServer`` over a tensor-parallel engine in the port, on the CPU: two
gloo ranks each build the same ``ServingEngine(mesh=make_mesh({"model":
2}))`` and the same ``LMServer(engine)``; rank 0 (the leader) serves the
wire and rank 1 (the follower) follows its lock-step loop and waits in
``join()``.

The ranks are spawned ONCE for the module (``tp_server``, with a timeout
of its own that names the stalled ranks) and import no JAX; rank 0 also
plays the clients. The test process then holds what they wrote against
references it computes itself: greedy streams against the JAX
reference's ``LMServer`` over its own ``ServingEngine(mesh=make_mesh(
{"model": 2}))`` on the bridged weights, seeded sampled streams against
the port's tp=1 server (JAX's RNG differs), and streams after a push or
a migration against the port's ``generate()`` on the pushed weights.
Every comparison is token for token. Cases:

- both layouts, and the pipelined, multi-step and n-gram engines:
  greedy and sampled requests from one client, with a rank-local
  closure queued on the leader's loop all the while, the follower's kept
  streams and tick count equal to the leader's;
- a push, then a KV export -> import over the wire each way between the
  tp=2 server and a tp=1 server (the wire forms of the reference's
  ``test_swap_parity_tp4`` and ``test_migration_parity_tp4`` at tp=2),
  landing on both ranks;
- queue-full and draining refusals on the leader, the follower admitting
  none of the refused requests;
- a request staged while the boundary that applies a drain runs: the
  engine does not read ``drained`` until that request is done;
- ``stop()`` on the leader ending both loops;
- the control group's two broadcasts: a step record longer than one
  head, and tensors of several dtypes over more than one bucket, bit for
  bit;
- a follower killed mid-stream (SIGKILL): the leader's loop ends with a
  flight postmortem well inside the control group's timeout, its streams end
  ``error`` and later submits are refused.
"""

import datetime
import glob
import json
import os
import signal
import threading
import time
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from distkeras_torch import bridge, telemetry  # noqa: E402
from distkeras_torch.models import get_model  # noqa: E402
from distkeras_torch.parallel.mesh import (  # noqa: E402
    CONTROL_TIMEOUT_S,
    make_mesh,
)
from distkeras_torch.serving import (  # noqa: E402
    DrainingError,
    FIFOScheduler,
    LMServer,
    OverloadedError,
    ServingClient,
    ServingEngine,
)

from torch_spawn_util import spawn_ranks  # noqa: E402

WORLD = 2
TIMEOUT_S = 180
V = 64
KW = dict(vocab_size=V, d_model=32, num_heads=4, num_kv_heads=2,
          num_layers=2, max_len=64, pos_emb="rope")
BS = 8
GREEDY = [dict(max_new_tokens=7), dict(max_new_tokens=5),
          dict(max_new_tokens=8)]
SAMPLED = [dict(max_new_tokens=6, temperature=1.0, seed=3),
           dict(max_new_tokens=7, temperature=0.8, seed=7, top_k=8),
           dict(max_new_tokens=5, temperature=0.9, seed=11, top_p=0.9)]


# the engines served at tp=2 and held to the tp=1 server: both layouts,
# and the modes that change what a step does (two ticks in flight, k
# decode tokens a tick, drafted tokens verified)
MODES = {"paged": dict(paged=True), "slot": dict(paged=False),
         "pipelined": dict(paged=True, pipeline=True),
         "multi_step": dict(paged=True, multi_step_k=4),
         "ngram": dict(paged=True, draft="ngram", spec_k=4)}


def _model(seed=0):
    return get_model("transformer_lm", seed=seed, dtype=torch.float32,
                     device="cpu", **KW)


def _prompts():
    rng = np.random.default_rng(0)
    sys_ = rng.integers(0, V, size=BS)
    return [np.concatenate([sys_, rng.integers(0, V, size=n)]).astype(
        np.int32) for n in (9, 5, 13, 3, 11, 6)]


def _migrant():
    return np.random.default_rng(2).integers(0, V, size=28).astype(np.int32)


def _engine(pm, mesh=None, **kw):
    kw = dict(dict(slots=2, block_size=BS, prefill_chunk=4), **kw)
    where = dict(mesh=mesh) if mesh is not None else dict(device="cpu")
    return ServingEngine(pm, registry=telemetry.MetricRegistry(),
                         tracer=telemetry.Tracer(), **where, **kw)


def _client(port):
    return ServingClient("127.0.0.1", port, timeout=60,
                         request_timeout=60)


def _wire(client, reqs):
    rids = [client.generate(p, **c) for p, c in reqs]
    return rids, [client.result(r) for r in rids]


def _follower(eng, srv):
    """The follower's side of a case: wait for the leader to stop, then
    report the loop's end, its ticks and its kept streams by rid."""
    srv.join()
    return {"ended": not srv._loop.is_alive(),
            "error": repr(srv.loop_error) if srv.loop_error else None,
            "ticks": eng.ticks,
            "streams": {str(rid): [toks, reason]
                        for rid, toks, reason in eng.lockstep_streams},
            "stats": {k: v for k, v in eng.stats().items()
                      if k in ("weight_version", "role", "prefix_hit_tokens",
                               "kv_blocks_imported", "kv_blocks_exported",
                               "requests_completed", "draining")}}


def _stopped(eng, srv):
    t0 = time.perf_counter()
    srv.stop(timeout=30.0)
    return {"ended": not srv._loop.is_alive(),
            "error": repr(srv.loop_error) if srv.loop_error else None,
            "stop_s": time.perf_counter() - t0, "ticks": eng.ticks}


def _serve_case(rank, mesh, mode):
    """Greedy and sampled requests from one client on one engine mode."""
    eng = _engine(_model(), mesh, **MODES[mode])
    srv = LMServer(eng).start()
    if rank:
        return _follower(eng, srv)
    # a rank-local closure on the leader's loop all the while, each one
    # queuing the next before it returns: one is queued whenever a step
    # plans, and must not change what it plans
    done = threading.Event()

    def closure():
        if not done.is_set():
            again()
            time.sleep(0.002)

    def again():
        threading.Thread(target=eng.call_in_loop, args=(closure,),
                         daemon=True).start()

    again()
    c = _client(srv.port)
    prompts = _prompts()
    reqs = list(zip(prompts, GREEDY + SAMPLED))
    rids, got = _wire(c, reqs)
    c.close()
    done.set()
    return dict(_stopped(eng, srv), rids=rids, streams=got)


def _migrate_case(rank, mesh, out):
    """A push to the tp=2 server, then an export -> import over the wire
    each way between it and a tp=1 server on rank 0 carrying the same
    pushed weights."""
    eng = _engine(_model(), mesh, paged=True)
    srv = LMServer(eng).start()
    if rank:
        return _follower(eng, srv)
    new = bridge.params_to_jax(_model(seed=2))
    one = _engine(_model(), paged=True)
    one_srv = LMServer(one).start()
    c2, c1 = _client(srv.port), _client(one_srv.port)
    res = {"push": c2.push_weights(new, version=2),
           "push_one": c1.push_weights(new, version=2)}
    prompts = _prompts()
    _, res["after_push"] = _wire(c2, [(p, c) for p, c in zip(prompts,
                                                             GREEDY)])
    prompt = _migrant()
    greedy = dict(max_new_tokens=6)
    for i, (tag, src, dst) in enumerate((("tp2_to_tp1", c2, c1),
                                         ("tp1_to_tp2", c1, c2))):
        if i:  # a swap retires the prefix cache: start both cold again
            for cl in (c1, c2):
                cl.push_weights(new, version=3)
        src.result(src.generate(prompt, max_new_tokens=1))
        exp = src.export_kv(prompt)
        imp = dst.import_kv(prompt, exp["blocks"])
        toks, reason = dst.result(dst.generate(prompt, **greedy))
        res[tag] = {"exported": exp["tokens"], "imported": imp["tokens"],
                    "stream": toks, "reason": reason}
    res["tp1_hit"] = one.prefix_hit_tokens
    res["stats"] = {k: v for k, v in eng.stats().items()
                    if k in ("weight_version", "prefix_hit_tokens",
                             "kv_blocks_imported", "kv_blocks_exported")}
    for cl in (c1, c2):
        cl.close()
    one_srv.stop()
    return dict(_stopped(eng, srv), **res)


def _refusal_case(rank, mesh):
    """One slot, a queue of two: with the leader's loop held, two
    submits are staged and the third is refused as overloaded; after a
    drain, submits are refused as draining."""
    eng = _engine(_model(), mesh, slots=1,
                  scheduler=FIFOScheduler(max_queue_depth=2))
    srv = LMServer(eng).start()
    if rank:
        return _follower(eng, srv)
    held, release = threading.Event(), threading.Event()

    def hold():  # rank-local: touches nothing the ranks share
        held.set()
        release.wait(60)

    threading.Thread(target=eng.call_in_loop, args=(hold, 60.0),
                     daemon=True).start()
    held.wait(60)
    c = _client(srv.port)
    prompts = _prompts()
    accepted = [c.generate(prompts[i], max_new_tokens=4) for i in (0, 1)]
    refused = {}
    try:
        c.generate(prompts[2], max_new_tokens=4)
    except OverloadedError as e:
        refused["overloaded"] = e.queue_depth
    depth = eng.stats()["queue_depth"]
    release.set()
    c.drain()
    try:
        c.generate(prompts[3], max_new_tokens=4)
    except DrainingError:
        refused["draining"] = True
    done = [c.result(r) for r in accepted]
    c.undrain()
    c.close()
    return dict(_stopped(eng, srv), accepted=accepted, refused=refused,
                done=done, depth_while_held=depth)


def _staged_drain_case(rank, mesh):
    """A request staged after the boundary that applies a drain took the
    staged list: one step record carries [hold, begin_drain, probe]; the
    request arrives while ``hold`` runs (admissions still open), so it
    stays staged past the drain, and ``probe`` reads ``drained`` then.
    The loop is held meanwhile by ``hold0``, so the three queue in that
    order into one record."""
    eng = _engine(_model(), mesh)
    srv = LMServer(eng).start()
    if rank:
        return _follower(eng, srv)
    ev = {k: threading.Event() for k in ("held0", "go0", "held", "go")}
    seen = {}

    def hold0():  # rank-local closures: they touch nothing shared
        ev["held0"].set()
        ev["go0"].wait(60)

    def hold():
        ev["held"].set()
        ev["go"].wait(60)

    def probe():
        seen.update(drained=eng.drained, draining=eng.draining,
                    depth=eng.stats()["queue_depth"])

    def queue(fn, *args):
        n = len(eng._ctrl)
        threading.Thread(target=fn, args=args, daemon=True).start()
        deadline = time.monotonic() + 30
        while len(eng._ctrl) == n and time.monotonic() < deadline:
            time.sleep(0.001)

    queue(eng.call_in_loop, hold0)
    ev["held0"].wait(60)
    queue(eng.call_in_loop, hold)
    queue(eng.control, "begin_drain")
    queue(eng.call_in_loop, probe)
    ev["go0"].set()
    ev["held"].wait(60)
    c = _client(srv.port)
    rid = c.generate(_prompts()[0], max_new_tokens=4)
    ev["go"].set()
    toks, reason = c.result(rid)
    deadline = time.monotonic() + 30
    while not eng.drained and time.monotonic() < deadline:
        time.sleep(0.005)
    drained_after = eng.drained
    c.close()
    return dict(_stopped(eng, srv), rid=rid, tokens=len(toks),
                reason=reason, probe=seen, drained_after=drained_after)


def _collectives_case(rank, mesh):
    """A record past the first broadcast's head, and tensors of four
    dtypes (one larger than a bucket) over the control group: what every
    rank received, as digests."""
    import hashlib

    from distkeras_torch.parallel import collectives as C

    group = mesh.control_group("model")
    rec = {"admits": [np.arange(3000, dtype=np.int32)], "ops": ["x"] * 9}
    got = C.broadcast_object(rec if rank == 0 else None, group)
    gen = torch.Generator().manual_seed(5)
    src = [torch.randn(7, 5, generator=gen).to(torch.bfloat16),
           torch.randint(-128, 127, (33,), generator=gen).to(torch.int8),
           torch.rand(4, generator=gen) > 0.5,
           torch.randn(C.BCAST_BUCKET_BYTES // 4 + 3, generator=gen)]
    outs = C.broadcast_tensors(src if rank == 0 else None,
                               C.tensor_specs(src), group)
    return {"record": bool(got["ops"] == rec["ops"] and np.array_equal(
                got["admits"][0], rec["admits"][0])),
            "tensors": [hashlib.sha256(t.view(-1).view(torch.uint8)
                                       .numpy().tobytes()).hexdigest()
                        for t in outs],
            "dtypes": [str(t.dtype) for t in outs]}


def _kill_case(rank, mesh, out, tmp):
    """The follower SIGKILLs itself once the leader's request is
    decoding; the leader's loop must end, with a postmortem, within the
    control group's timeout."""
    eng = _engine(_model(), mesh, postmortem_dir=tmp)
    srv = LMServer(eng).start()
    if rank:
        deadline = time.monotonic() + 60
        while eng.ticks < 3 and time.monotonic() < deadline:
            time.sleep(0.001)
        with open(os.path.join(out, "killed.json"), "w") as fh:
            json.dump({"t": time.time(), "ticks": eng.ticks}, fh)
        os.kill(os.getpid(), signal.SIGKILL)
    c = _client(srv.port)
    rid = c.generate(_prompts()[0], max_new_tokens=40)
    toks, reason = c.result(rid)
    srv.join(timeout=2 * CONTROL_TIMEOUT_S)
    ended_t = time.time()
    killed = json.load(open(os.path.join(out, "killed.json")))
    try:
        c.result(c.generate(_prompts()[1], max_new_tokens=2))
        later = "served"
    except RuntimeError as e:
        later = str(e)
    c.close()
    srv.stop(timeout=5.0)
    return {"reason": reason, "tokens": len(toks),
            "ended": not srv._loop.is_alive(),
            "error": repr(srv.loop_error),
            "end_after_kill_s": ended_t - killed["t"],
            "postmortems": len(glob.glob(os.path.join(
                tmp, "distkeras-postmortem-*-crash-*"))),
            "later_submit": later}


def _entry(rank, init, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    res = {}
    try:
        mesh = make_mesh({"model": WORLD})
        for mode in MODES:
            res[mode] = _serve_case(rank, mesh, mode)
        res["migrate"] = _migrate_case(rank, mesh, out)
        res["refusal"] = _refusal_case(rank, mesh)
        res["staged_drain"] = _staged_drain_case(rank, mesh)
        res["collectives"] = _collectives_case(rank, mesh)
        with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
            json.dump(res, fh)
        tmp = os.path.join(out, f"postmortem{rank}")
        os.makedirs(tmp, exist_ok=True)
        res["kill"] = _kill_case(rank, mesh, out, tmp)
        with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
            json.dump(res, fh)
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def tp_server(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp_server"))
    spawn_ranks(_entry, WORLD, out, TIMEOUT_S, killed=(1,))
    return [json.load(open(os.path.join(out, f"rank{r}.json")))
            for r in range(WORLD)]


def _jax_server_streams(paged, reqs):
    """Greedy streams of the JAX reference's LMServer over its own tp=2
    mesh engine, on the port model's weights bridged into flax."""
    import torch_engine_util as U
    from distkeras_tpu.parallel.mesh import make_mesh as jax_mesh
    from distkeras_tpu.serving import LMServer as JaxServer
    from distkeras_tpu.serving import ServingClient as JaxClient

    jm, params, _ = U.pair(seed=0, base=KW)
    eng = U.jax_engine(jm, params, paged=paged, prefill_chunk=4,
                       mesh=jax_mesh({"model": 2}))
    srv = JaxServer(eng).start()
    try:
        c = JaxClient("127.0.0.1", srv.port, timeout=60)
        rids = [c.generate(p, **cfg) for p, cfg in reqs]
        out = [c.result(r)[0] for r in rids]
        c.close()
    finally:
        srv.stop()
    return out


def _port_server_streams(mode, reqs):
    """Streams of the port's tp=1 LMServer on the same weights."""
    srv = LMServer(_engine(_model(), **MODES[mode])).start()
    try:
        c = _client(srv.port)
        _, got = _wire(c, reqs)
        c.close()
    finally:
        srv.stop()
    return [t for t, _ in got]


def _generate(pm, prompt, n):
    from distkeras_torch.models.transformer import generate

    return generate(pm, torch.as_tensor(prompt)[None], n)[
        0, len(prompt):].tolist()


@pytest.mark.parametrize("layout", ["paged", "slot"])
def test_tp2_server_greedy_streams_equal_the_jax_tp2_server(tp_server,
                                                            layout):
    lead = tp_server[0][layout]
    reqs = list(zip(_prompts(), GREEDY))
    want = _jax_server_streams(layout == "paged", reqs)
    got = [t for t, _ in lead["streams"][:len(GREEDY)]]
    assert got == want
    assert all(r == "length" for _, r in lead["streams"])


@pytest.mark.parametrize("layout", list(MODES))
def test_tp2_server_sampled_streams_equal_the_tp1_server(tp_server, layout):
    lead = tp_server[0][layout]
    reqs = list(zip(_prompts(), GREEDY + SAMPLED))
    want = _port_server_streams(layout, reqs)
    assert [t for t, _ in lead["streams"]] == want
    assert all(r == "length" for _, r in lead["streams"])


@pytest.mark.parametrize("layout", list(MODES))
def test_follower_streams_and_ticks_equal_the_leaders(tp_server, layout):
    lead, fol = tp_server[0][layout], tp_server[1][layout]
    assert fol["ended"] and fol["error"] is None
    assert fol["ticks"] == lead["ticks"] > 0
    assert {str(r): [t, reason] for r, (t, reason) in zip(
        lead["rids"], lead["streams"])} == fol["streams"]


def test_push_and_migration_land_on_both_ranks(tp_server):
    lead, fol = tp_server[0]["migrate"], tp_server[1]["migrate"]
    assert lead["push"]["version"] == 2
    new = _model(seed=2)
    assert [t for t, _ in lead["after_push"]] == [
        _generate(new, p, c["max_new_tokens"])
        for p, c in zip(_prompts(), GREEDY)]
    want = _generate(new, _migrant(), 6)
    for tag in ("tp2_to_tp1", "tp1_to_tp2"):
        m = lead[tag]
        assert m["exported"] == m["imported"] == 24, tag
        assert m["stream"] == want and m["reason"] == "length", tag
    assert lead["tp1_hit"] == 24
    # the follower imported, hit and swapped as the leader did
    assert fol["stats"]["weight_version"] == lead["stats"][
        "weight_version"] >= 2
    for key in ("prefix_hit_tokens", "kv_blocks_imported",
                "kv_blocks_exported"):
        assert fol["stats"][key] == lead["stats"][key] > 0, key
    assert fol["ticks"] == lead["ticks"]


def test_refusals_on_the_leader_reach_no_follower(tp_server):
    lead, fol = tp_server[0]["refusal"], tp_server[1]["refusal"]
    # the overload reply's depth counts the two staged admissions
    assert lead["refused"] == {"overloaded": 2, "draining": True}
    assert lead["depth_while_held"] == 2
    assert [r for _, r in lead["done"]] == ["length", "length"]
    assert sorted(fol["streams"]) == sorted(str(r) for r in
                                            lead["accepted"])
    assert fol["stats"]["requests_completed"] == 2
    assert fol["stats"]["draining"] is False


def test_a_request_staged_past_a_drain_keeps_the_engine_undrained(
        tp_server):
    lead, fol = tp_server[0]["staged_drain"], tp_server[1]["staged_drain"]
    assert lead["probe"] == {"drained": False, "draining": True, "depth": 1}
    assert lead["reason"] == "length" and lead["tokens"] == 4
    assert lead["drained_after"]
    assert list(fol["streams"]) == [str(lead["rid"])]
    assert fol["ticks"] == lead["ticks"]


def test_stop_on_the_leader_ends_both_loops(tp_server):
    for case in list(MODES) + ["migrate", "refusal", "staged_drain"]:
        lead, fol = tp_server[0][case], tp_server[1][case]
        assert lead["ended"] and lead["error"] is None, case
        assert fol["ended"] and fol["error"] is None, case
        assert lead["stop_s"] < 10.0, case


def test_control_group_broadcasts_arrive_bit_for_bit(tp_server):
    lead, fol = tp_server[0]["collectives"], tp_server[1]["collectives"]
    assert lead["record"] and fol["record"]
    assert fol["tensors"] == lead["tensors"]
    assert fol["dtypes"] == ["torch.bfloat16", "torch.int8", "torch.bool",
                             "torch.float32"]


def test_a_killed_follower_ends_the_leaders_loop_with_a_postmortem(
        tp_server):
    k = tp_server[0]["kill"]
    assert k["ended"] and k["error"] != "None"
    assert k["end_after_kill_s"] < CONTROL_TIMEOUT_S / 6
    assert k["postmortems"] == 1
    assert k["reason"] == "error" and k["tokens"] < 40
    assert "lock-step loop ended" in k["later_submit"]
