"""Spawning gloo ranks for the port's multi-process tests
(``tests/test_torch_tp*.py``): one spawn per test module, under a
timeout of its own; and the one-thread fixture the port's test modules
share. Imports no JAX: the ranks import the test module that calls it."""

import os
import signal
import time

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors gain nothing from intra-op threads, and the suite
    runs several test processes at once: run each importing module on
    one torch thread, and every process it starts too (their rank
    threads follow ``OMP_NUM_THREADS``); then restore both."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env


def _errors(out, default):
    errs = [open(os.path.join(out, f)).read()
            for f in sorted(os.listdir(out)) if f.endswith(".err")]
    return AssertionError("\n".join(errs) or default)


def spawn_ranks(entry, world, out, timeout_s, *args, killed=()):
    """Run ``entry(rank, init, out, *args)`` on ``world`` gloo ranks
    under a timeout (each rank writes its results under ``out``); a rank
    that fails or stalls fails the caller with its name (and its
    traceback, when it wrote one to ``out/rank<r>.err``). The ranks in
    ``killed`` are expected to end by SIGKILL (a case that kills one):
    the others then run on to their end."""
    ctx = torch.multiprocessing.spawn(
        entry, args=(f"file://{out}/rendezvous", out) + args, nprocs=world,
        join=False)
    deadline = time.monotonic() + timeout_s
    try:
        if killed:
            # join() would terminate every rank at the first death
            procs = ctx.processes
            while any(p.is_alive() for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.exitcode not in (None, 0) and not (
                           r in killed and p.exitcode == -signal.SIGKILL)]
                if bad:
                    raise _errors(out, f"ranks {bad} failed")
                if time.monotonic() > deadline:
                    stalled = [r for r, p in enumerate(procs)
                               if p.is_alive()]
                    raise AssertionError(f"ranks {stalled} of {world} "
                                         f"stalled past {timeout_s} s")
                time.sleep(0.1)
            bad = [r for r, p in enumerate(procs) if p.exitcode != 0
                   and not (r in killed and p.exitcode == -signal.SIGKILL)]
            if bad:
                raise _errors(out, f"ranks {bad} failed")
            return
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                stalled = [r for r, p in enumerate(ctx.processes)
                           if p.is_alive()]
                raise AssertionError(
                    f"ranks {stalled} of {world} stalled past {timeout_s} s")
    except torch.multiprocessing.ProcessRaisedException as e:
        raise _errors(out, str(e)) from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
