"""The ``train`` kind: a training step of the port, timed over windows.

Set-up builds ONE program (model, optimizer, step) holding the seed's
weights and drives it through its first steps with the window's own
call, on rows that all differ: a window of one step, whose optimizer
state gives the first gradient, then a whole window of ``window``
steps as the timed path runs it; it reads every step's loss and the
weights' change after the last. One more window warms the timed
shape. The window then runs whole windows of the step on a pool
of seeded rows, reading each window's losses as ``LMTrainer`` does,
until ``--seconds`` have passed; ``train_step_ms`` is the window's
wall time over the steps it completed. With ``--trace 1`` further
windows run under the profiler: first tracing the device alone (its
busy and idle time), then the host too (groups, ranges, breakdown).

Once the window has closed and the peak memory is read, the program is
freed and the plain reference (``gpubench.reference``) follows the same
first steps from the same seed; ``gpubench.compare.train_numbers``
holds the two against the cell's limits.

Data parallelism (``dp > 1``): one process a card, NCCL over a TCP
rendezvous on a free localhost port, ``make_mesh({"dp": dp, "sp": 1})``; every
rank is handed the global batch and the program takes its rows. Rank 0
decides when the window closes and reports; the reference's ranks each
follow their own rows and sum over the group.
"""

from __future__ import annotations

import os
import socket
import time
import traceback

import torch

from gpubench import compare, faults, work
from gpubench.programs import TrainProgram
from gpubench.reference import cnn as ref_cnn
from gpubench.reference import lm as ref_lm
from gpubench.reference import precision
from gpubench.reference.train import follow
from gpubench.runner import Run, free, memory_peak, peaks_of
from gpubench.trace import profile
from gpubench.weights import (cnn_batches, cnn_specs, lm_specs, lm_tokens,
                              make_flat, views)


def specs_of(cfg: dict):
    return lm_specs(cfg) if cfg["model"] == "transformer_lm" else cnn_specs(cfg)


def check_steps(traffic: dict) -> int:
    """The steps that ``correct`` follows: one step alone, then one
    whole window."""
    return 1 + traffic["window"]


def batches(cfg: dict, traffic: dict, seed: int, device):
    """The run's rows: the checked steps, then ``pool_windows`` windows;
    a tuple of ``[steps, rows, ...]``."""
    n = check_steps(traffic) + traffic["pool_windows"] * traffic["window"]
    if cfg["model"] == "transformer_lm":
        return (lm_tokens(seed, n, traffic["batch"], traffic["seq"],
                          cfg["vocab_size"], device),)
    return cnn_batches(seed, n, traffic["batch"], cfg["input_shape"],
                       cfg["num_classes"], device)


def step_flops(cfg: dict, traffic: dict) -> float:
    """One rank's optimizer step, from the shapes."""
    B = traffic["batch"] // traffic["dp"]
    if cfg["model"] == "transformer_lm":
        return work.lm_train_step_flops(cfg, B, traffic["seq"])
    return work.cnn_train_step_flops(cfg, B)


def reference(run: Run, data, device, rows: slice, group=None,
              prec=precision.F32) -> dict:
    """The reference's first steps on ``rows`` of the global batch."""
    cfg, traffic = run.cell.config, run.cell.traffic
    precision.strict()
    if cfg["model"] == "transformer_lm":
        def loss_sum(w, tokens, prec):
            return ref_lm.loss_sum(w, tokens, cfg, prec)
    else:
        def loss_sum(w, x, y, prec):
            return ref_cnn.loss_sum(w, x, y, cfg, prec)
    return follow(specs_of(cfg), run.seed, device, loss_sum,
                  lambda s: tuple(t[s][rows] for t in data),
                  check_steps(traffic), traffic["optimizer"],
                  traffic["reference_rows_per_block"], group, prec)


def _window(data, traffic: dict, i: int):
    W, c = traffic["window"], check_steps(traffic)
    a = c + (i % traffic["pool_windows"]) * W
    return tuple(t[a:a + W] for t in data)


def rank_main(run: Run, rank: int = 0, world: int = 1, group=None,
              mesh=None, checks_only: bool = False) -> dict:
    """The whole run on one rank; rank 0's result carries the cell's.
    ``checks_only`` stops after the first steps (no window), for the
    readings that set the limits."""
    with faults.planted(run.fault):
        return _rank_main(run, rank, world, group, mesh, checks_only)


def _rank_main(run: Run, rank: int, world: int, group, mesh,
               checks_only: bool) -> dict:
    cfg, traffic = run.cell.config, run.cell.traffic
    dev = run.device(rank)
    specs = specs_of(cfg)
    flat = make_flat(specs, run.seed, dev)
    program = TrainProgram(cfg, traffic, views(flat, specs), dev, mesh)
    data = batches(cfg, traffic, run.seed, dev)
    # the first steps, through the window's own call: one step alone,
    # then one whole window as the timed path runs it
    losses = [float(program.step(tuple(t[:1] for t in data))[-1])]
    grads = program.grad_norms()
    out = program.step(tuple(t[1:check_steps(traffic)] for t in data))
    losses += [float(x) for x in out.cpu()]
    start = views(flat, specs)
    with torch.no_grad():
        norms = torch.stack([(p.detach() - start[n]).double().norm()
                             for n, p in program.named()]).cpu()
    delta = {n: float(v) for (n, _), v in zip(program.named(), norms)}
    del start, flat
    prog = {"losses": losses, "grad_norms": grads, "delta_norms": delta}
    if checks_only:
        del program
        free()
        return _checks(run, data, rank, world, group, prog)
    # warm the timed shape on the pool's rows
    float(program.step(_window(data, traffic, 0))[-1])
    run.sync()
    t_ready = time.time()
    # the window
    W = traffic["window"]
    steps, i, finite = 0, 0, True
    flag = torch.zeros(1, device=dev)
    t0 = time.perf_counter()
    while True:
        out = program.step(_window(data, traffic, i)).cpu()
        finite = finite and bool(torch.isfinite(out).all())
        steps += W
        i += 1
        if group is not None:
            flag.fill_(float(time.perf_counter() - t0 >= run.seconds))
            torch.distributed.broadcast(flag, 0, group=group)
            if flag.item():
                break
        elif time.perf_counter() - t0 >= run.seconds:
            break
    run.sync()
    elapsed = time.perf_counter() - t0
    result = {"setup_s": t_ready - run.t0, "steps": steps,
              "step_s": elapsed / steps, "finite": finite}
    if run.trace:
        n = traffic["trace_windows"]

        def traced(first):
            def go():
                for k in range(n):
                    program.step(_window(data, traffic, first + k))
            return go

        busy = profile(traced(i), run.trace_path(rank, "device"), cpu=False)
        result["busy"] = {k: busy[k] for k in ("busy_s", "window_s")}
        result["summary"] = profile(traced(i + n), run.trace_path(rank))
        result["traced_steps"] = n * W
    result["memory_peak_bytes"] = memory_peak(run, rank)
    # the program's state goes before the reference runs
    del program
    free()
    result.update(_checks(run, data, rank, world, group, prog))
    return result


def _checks(run: Run, data, rank: int, world: int, group, prog) -> dict:
    """The reference's first steps on this rank's rows of the batches."""
    traffic = run.cell.traffic
    B = traffic["batch"] // world
    check = tuple(t[:check_steps(traffic)] for t in data)
    del data
    ref = reference(run, check, run.device(rank),
                    slice(rank * B, (rank + 1) * B), group)
    return {"prog": prog, "ref": ref, "check": check}


def control_readings(run: Run, check, ref: dict, rank: int = 0,
                     world: int = 1, group=None) -> dict:
    """The numbers of the control (the reference in fp8 in the program's
    place) and of the faults planted in the reference: half of each
    rank's rows left out; every step of the checked window fed that
    window's first rows (a stale feed inside the window); under data
    parallelism each rank's own rows alone (the exchange left out). A
    state left unchanged reads 1 on ``delta_gap`` by construction."""
    B = run.cell.traffic["batch"] // world
    dev = run.device(rank)
    rows = slice(rank * B, (rank + 1) * B)
    half = slice(rank * B, rank * B + max(1, B // 2))
    stale = [0] + [1] * run.cell.traffic["window"]
    out = {"fp8": reference(run, check, dev, rows, group, precision.FP8),
           "half_batch": reference(run, check, dev, half, group),
           "stale_feed": reference(run, tuple(t[stale] for t in check),
                                   dev, rows, group)}
    if world > 1:
        out["no_allreduce"] = reference(run, check, dev, rows, None)
    return {k: compare.train_numbers(v, ref) for k, v in out.items()}


def _finish(run: Run, res: dict, busy: list):
    """The cell's result from rank 0's (``busy``: each rank's busy
    seconds in the kernel-only traced window)."""
    cfg, traffic = run.cell.config, run.cell.traffic
    run.attempted = res["steps"]
    run.failed = 0 if res["finite"] else res["steps"]
    run.e2e = {"train_step_ms": res["step_s"] * 1e3,
               "setup_s": res["setup_s"]}
    run.numbers = compare.train_numbers(res["prog"], res["ref"])
    run.extra_ok = res["finite"]
    if run.trace:
        s = res["summary"]
        run.busy_s = sum(busy) / len(busy)
        run.window_s = res["busy"]["window_s"]
        B = traffic["batch"] // traffic["dp"]
        attn = (work.causal_attn_train(cfg, B, traffic["seq"])
                if cfg["model"] == "transformer_lm" else None)
        run.record = {"kind": "train", "summary": s, "busy": res["busy"],
                      "steps": res["traced_steps"],
                      "step_s": res["step_s"],
                      "step_flops": step_flops(cfg, traffic),
                      "attn_work": attn, "peaks": peaks_of(run)}


def run(r: Run) -> None:
    """Measure the cell: in this process, or one process a card."""
    traffic = r.cell.traffic
    dp = traffic["dp"]
    r.count = dp
    if r.device_type == "cuda":
        r.device_name = torch.cuda.get_device_name(0) if dp == 1 else ""
    if dp == 1:
        res = rank_main(r)
        res.pop("check")
        r.memory_peak_bytes = res["memory_peak_bytes"]
        _finish(r, res, [res.get("busy", {}).get("busy_s")])
        return
    results = spawn(r, dp)
    res = results[0]
    r.device_name = res["device_name"]
    r.memory_peak_bytes = max(x["memory_peak_bytes"] for x in results)
    _finish(r, res, [x.get("busy", {}).get("busy_s") for x in results])


# -- data parallelism: one process a card ------------------------------------


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(run: Run, rank: int, world: int, port: int, queue, job):
    try:
        import torch.distributed as dist

        cuda = run.device_type == "cuda"
        if cuda:
            torch.cuda.set_device(rank)
        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        try:
            from distkeras_torch.parallel.mesh import make_mesh

            mesh = make_mesh({"dp": world, "sp": 1})
            group = dist.new_group(list(range(world)))
            if job is None:
                res = rank_main(run, rank, world, group, mesh)
            else:
                res = {"seeds": job(run, rank, world, group, mesh)}
            res.pop("check", None)
            res["device_name"] = (torch.cuda.get_device_name(rank) if cuda
                                  else "cpu")
            from gpubench import guard

            res["forbidden"] = guard.loaded()
            queue.put((rank, res))
        finally:
            dist.destroy_process_group()
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def spawn(run: Run, world: int, timeout: float = 300.0, job=None) -> list:
    """Run :func:`rank_main` (or ``job(run, rank, world, group, mesh)``, a
    module-level function) in ``world`` processes; their results by
    rank. Every process has ended when this returns."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    os.environ["NCCL_SHM_DISABLE"] = "1"
    procs = [ctx.Process(target=_rank_entry,
                         args=(run, r, world, port, queue, job),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.time() + timeout
    try:
        while len(results) < world:
            left = deadline - time.time()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(results))} "
                                   f"did not report within {timeout} s")
            try:
                rank, res = queue.get(timeout=min(left, 5.0))
            except Exception:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} exited with "
                                       f"{[procs[r].exitcode for r in dead]}")
                continue
            if "error" in res:
                raise RuntimeError(f"rank {rank} failed:\n{res['error']}")
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    for r in results.values():
        if r.get("forbidden"):
            raise RuntimeError(f"a rank loaded {r['forbidden']}")
    return [results[r] for r in range(world)]
