"""Faults planted in the program, for the tests that show a run with a
broken timed path comes out not correct. A run plants none unless its
caller names one; the command line cannot.

- ``unchanged``: the optimizers' step returns the state unchanged;
- ``half_batch``: half of each batch left out, the mean taken over the
  rest;
- ``stale_feed``: every step of a window trains on the window's first
  rows (a window of one step is untouched);
- ``no_allreduce``: the data-parallel step's gradient exchange left out;
- ``alter_token``: each served token altered where it is produced.
"""

from __future__ import annotations

import contextlib
from typing import Optional

FAULTS = ("unchanged", "half_batch", "stale_feed", "no_allreduce",
          "alter_token")


@contextlib.contextmanager
def planted(fault: Optional[str]):
    """Plant ``fault`` for the duration of the block (nothing for None)."""
    if fault is None:
        yield
        return
    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    try:
        _plant(fault, patch)
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


def _plant(fault: str, patch) -> None:
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    if fault == "unchanged":
        from distkeras_torch.utils import losses

        for cls in (losses.Adam, losses.SGD):
            patch(cls, "step", lambda self, closure=None: None)
    elif fault == "half_batch":
        from distkeras_torch import workers
        from distkeras_torch.parallel import spmd

        targets = spmd._next_token_targets

        def half_targets(tokens, *a, **kw):
            t, mask = targets(tokens, *a, **kw)
            mask = mask.clone()
            mask[mask.shape[0] // 2:] = 0.0
            return t, mask

        patch(spmd, "_next_token_targets", half_targets)
        step_fn = workers._step_fn

        def half_step_fn(module, loss_fn, *a, **kw):
            def half_loss(logits, y):
                n = max(1, logits.shape[0] // 2)
                return loss_fn(logits[:n], y[:n])

            return step_fn(module, half_loss, *a, **kw)

        patch(workers, "_step_fn", half_step_fn)
    elif fault == "stale_feed":
        from distkeras_torch import workers
        from distkeras_torch.parallel import spmd

        def first_rows(x):
            return x[:1].expand_as(x).contiguous()

        make_lm = spmd.make_lm_train_step

        def stale_lm(*a, **kw):
            step = make_lm(*a, **kw)
            return lambda tokens: step(first_rows(tokens))

        patch(spmd, "make_lm_train_step", stale_lm)
        make_window = workers.make_window_step

        def stale_window(*a, **kw):
            window = make_window(*a, **kw)
            return lambda xs, ys: window(first_rows(xs), first_rows(ys))

        patch(workers, "make_window_step", stale_window)
    elif fault == "no_allreduce":
        from distkeras_torch.parallel import spmd

        patch(spmd, "reduce_grads", lambda params, group=None: 0)
    elif fault == "alter_token":
        from distkeras_torch.serving import scheduler

        put = scheduler.TokenStream._put
        patch(scheduler.TokenStream, "_put",
              lambda self, tok: put(self, tok ^ 1))
