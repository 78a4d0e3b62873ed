"""Spawning gloo ranks for the port's multi-process tests
(``tests/test_torch_tp*.py``): one spawn per test module, under a
timeout of its own. Imports no JAX: the ranks import the test module
that calls it."""

import os
import time

import torch


def spawn_ranks(entry, world, out, timeout_s, *args):
    """Run ``entry(rank, init, out, *args)`` on ``world`` gloo ranks
    under a timeout (each rank writes its results under ``out``); a rank
    that fails or stalls fails the caller with its name (and its
    traceback, when it wrote one to ``out/rank<r>.err``)."""
    ctx = torch.multiprocessing.spawn(
        entry, args=(f"file://{out}/rendezvous", out) + args, nprocs=world,
        join=False)
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                stalled = [r for r, p in enumerate(ctx.processes)
                           if p.is_alive()]
                raise AssertionError(
                    f"ranks {stalled} of {world} stalled past {timeout_s} s")
    except torch.multiprocessing.ProcessRaisedException as e:
        errs = [open(os.path.join(out, f)).read()
                for f in sorted(os.listdir(out)) if f.endswith(".err")]
        raise AssertionError("\n".join(errs) or str(e)) from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
