"""The port's multi-process runtime (``distkeras_torch/runtime.py``) and
``Job`` (``distkeras_torch/job_deployment.py``) on the CPU:

- the ``DK_TPU_*`` environment parses to the reference's context, and
  ``Job.environment_for`` / ``command_for`` equal the reference's;
- a ``Job`` launch of two local processes over gloo (one ``python``
  each, no jax in them) runs ``DataParallelTrainer`` from a shard
  directory: each rank streams the reference's stride of shards, capped
  at the reference's batch count; both ranks end with identical
  parameters, equal (1e-5: the all-reduce sums in another order) to one
  process trained on the same global batches; then an ``ADAG`` run wires
  itself through ``runtime.current()``: rank 0 owns and serves the
  center, rank 1 trains through the proxy, and the center counts a
  commit for every window of both processes.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distkeras_torch import job_deployment as tj  # noqa: E402
from distkeras_torch import runtime as trt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"DK_TPU_COORDINATOR": "10.0.0.1:9885", "DK_TPU_PROCESS_ID": "3",
       "DK_TPU_NUM_PROCESSES": "4", "DK_TPU_PS_ADDRESS": "10.0.0.1:9886",
       "DK_TPU_SECRET": "s3cret"}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_environment_parses_like_the_reference(monkeypatch):
    from distkeras_tpu import runtime as jrt

    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    try:
        got = trt.initialize(init_distributed=False, device="cpu")
        want = jrt.initialize(init_jax_distributed=False)
        for f in ("process_id", "num_processes", "coordinator",
                  "ps_address", "secret", "is_coordinator", "ps_hostport"):
            assert getattr(got, f) == getattr(want, f), f
        assert trt.current() is got and got.device == torch.device("cpu")
        assert trt.initialize() is got  # idempotent
    finally:
        trt.shutdown()
        jrt.shutdown()
    assert trt.current() is None
    monkeypatch.setenv("DK_TPU_NUM_PROCESSES", "1")
    assert trt.initialize(device="cpu") is None
    monkeypatch.setenv("DK_TPU_NUM_PROCESSES", "2")
    monkeypatch.delenv("DK_TPU_PS_ADDRESS")
    with pytest.raises(ValueError, match="DK_TPU_PS_ADDRESS"):
        trt.initialize(device="cpu")


@pytest.mark.parametrize("hosts", [None, ["local", "local"],
                                   ["user@h0", "h1", "h2"]])
def test_job_commands_match_the_reference(hosts):
    from distkeras_tpu import job_deployment as jj

    kw = dict(script="train it.py", script_args=["--x", "a b"], hosts=hosts,
              coordinator_port=1234, ps_port=5678,
              env={"DK_TPU_SECRET": "k", "EXTRA": "1"}, python="py3")
    t, j = tj.Job(**kw), jj.Job(**kw)
    for pid in range(len(t.hosts)):
        assert t.environment_for(pid) == j.environment_for(pid)
        assert t.command_for(pid) == j.command_for(pid)
    assert len(tj.Job("s.py").env["DK_TPU_SECRET"]) == 32


SCRIPT = r'''
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from distkeras_torch import runtime, trainers
from distkeras_torch.data.shard_io import ShardedDataset
from distkeras_torch.data.dataset import PartitionedDataset
from distkeras_torch.models import get_model
from distkeras_torch.ops import rules

ctx = runtime.initialize(device="cpu")
out, shards = sys.argv[1], sys.argv[2]
sd = ShardedDataset(shards)
def mlp():
    return get_model("mlp", features=(16,), num_classes=4, in_features=8,
                     dtype=torch.float32, device="cpu", seed=1)
dp = trainers.DataParallelTrainer(mlp(), batch_size=8, num_epoch=2,
                                  learning_rate=0.05)
seen = []
orig = dp._stream_windows
def spy(sds, worker, n, r, shuffle, start):
    windows = orig(sds, worker, n, r, shuffle, start)
    def wrapped(epoch):
        for xs, ys in windows(epoch):
            seen.append(len(xs))
            yield xs, ys
    return wrapped
dp._stream_windows = spy
dp.train(sd)
ps = trainers.ADAG(mlp(), num_workers=1, communication_window=2,
                   batch_size=8, num_epoch=1, learning_rate=0.05)
rows = sd.load()
ps.train(PartitionedDataset.from_arrays(
    {c: rows.column(c)[ctx.process_id::2] for c in sd.columns}))
json.dump({"rank": ctx.process_id, "batches": sum(seen),
           "history": dp.history,
           "dp": {k: v.tolist() for k, v in rules.flatten(dp.params).items()},
           "ps": {k: v.tolist() for k, v in rules.flatten(ps.params).items()},
           "ps_steps": len(ps.history),
           # the owner's count (a proxy would ask the stopped service)
           "commits": (ps.parameter_server.num_updates
                       if ctx.is_coordinator else None),
           "owner": type(ps.parameter_server).__name__},
          open(f"{out}/rank{ctx.process_id}.json", "w"))
runtime.shutdown()
'''


def test_two_process_job_over_gloo(tmp_path):
    from distkeras_torch import trainers as tt
    from distkeras_torch.data.dataset import PartitionedDataset
    from distkeras_torch.data.shard_io import ShardedDataset, write_shards
    from distkeras_torch.models import get_model
    from distkeras_torch.ops import rules

    rng = np.random.default_rng(0)
    rows = [40, 24, 33, 17, 29]  # ragged: the strides' batch counts differ
    parts = [{"features": rng.normal(size=(r, 8)).astype(np.float32),
              "label": np.eye(4, dtype=np.float32)[rng.integers(0, 4, r)]}
             for r in rows]
    sd = ShardedDataset(write_shards(PartitionedDataset(parts),
                                     str(tmp_path / "s")))
    script = tmp_path / "job.py"
    script.write_text(SCRIPT)
    job = tj.Job(str(script), [str(tmp_path), sd.directory],
                 hosts=["local", "local"], coordinator_port=_free_port(),
                 ps_port=_free_port(), python=sys.executable,
                 env={"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    procs = job.run(wait=False)
    try:
        codes = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0, 0]
    res = [json.load(open(tmp_path / f"rank{r}.json")) for r in (0, 1)]

    # the reference's stride and cap (trainers.py · DataParallelTrainer)
    cap = min(sum(rows[s] for s in range(p, 5, 2)) // 8 for p in range(2))
    assert cap == min((40 + 33 + 29) // 8, (24 + 17) // 8) == 5
    assert [r["batches"] for r in res] == [2 * cap, 2 * cap]
    assert res[0]["history"] == res[1]["history"]
    assert res[0]["dp"] == res[1]["dp"]

    # one process over the same global batches: rank 0's then rank 1's
    # rows of each step, at twice the batch
    streams = [[b for _, b in zip(range(cap), sd.batches(
        8, shards=list(range(r, 5, 2))))] for r in (0, 1)]
    glob = {c: np.concatenate([np.concatenate([streams[0][i][c],
                                               streams[1][i][c]])
                               for i in range(cap)])
            for c in ("features", "label")}
    one = tt.DataParallelTrainer(
        get_model("mlp", features=(16,), num_classes=4, in_features=8,
                  dtype=torch.float32, device="cpu", seed=1),
        batch_size=16, num_epoch=2, learning_rate=0.05)
    one.train(PartitionedDataset.from_arrays(glob))
    want = rules.flatten(one.params)
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(res[0]["dp"][k]), v,
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        [r["loss"] for r in res[0]["history"]],
        [r["loss"] for r in one.history], rtol=1e-5, atol=1e-6)

    # the auto-wired PS: the coordinator owns the center, rank 1 proxies;
    # the center took one commit a window (2 steps) from both processes
    # (rank 1 read it when its own worker finished, so its copy may
    # predate rank 0's last commits)
    assert res[0]["owner"] == "ADAGParameterServer"
    assert res[1]["owner"] == "RemoteParameterServer"
    assert res[0]["commits"] == sum(-(-r["ps_steps"] // 2) for r in res)
    for r in res:
        assert all(np.all(np.isfinite(np.asarray(v))) for v in
                   r["ps"].values())
