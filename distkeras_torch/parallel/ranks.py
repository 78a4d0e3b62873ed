"""The rank processes of one multi-process program on this host.

A tensor-parallel program runs one process a rank: ``python <script>
<flag> <cfg.json> <rank>`` for each rank, with this package on
``PYTHONPATH``, each logging to ``<out>/rank<r>.log`` and writing its
result to ``<out>/rank<r>.json`` (``out`` is ``cfg['out']``, a
directory the caller made; it is removed on :meth:`Ranks.close`). The
parent and the ranks may also leave each other small JSON files there
(:func:`post`, :func:`await_posted`). A rank that fails fails the
parent with an ``AssertionError`` (as a failed check of the program's
own does), quoting every rank that failed, the first to fail first (the
others' collectives then lose it); ranks still running at a deadline
are named as stalled; every rank is killed on the way out.

Imports no ``torch``: the ranks do.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from typing import List, Optional, Sequence

# the directory holding the distkeras_torch package
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def rank_threads(world: int) -> int:
    """Intra-op threads for one of ``world`` rank processes on this host:
    ``OMP_NUM_THREADS`` when it is set, else an equal share of the
    cores."""
    env = os.environ.get("OMP_NUM_THREADS", "")
    if env.isdigit() and int(env) > 0:
        return int(env)
    return max(1, (os.cpu_count() or 2) // world)


def post(out: str, name: str, obj=None):
    """Leave ``obj`` as JSON at ``out/name`` (whole or not at all)."""
    tmp = os.path.join(out, f".{name}.tmp")
    with open(tmp, "w") as fh:
        json.dump(obj, fh)
    os.replace(tmp, os.path.join(out, name))


def await_posted(out: str, name: str, timeout_s: float, alive=None):
    """The JSON at ``out/name``, once another process posted it (None as
    soon as ``alive()`` turns false)."""
    deadline = time.monotonic() + timeout_s
    path = os.path.join(out, name)
    while not os.path.exists(path):
        if alive is not None and not alive():
            return None
        if time.monotonic() > deadline:
            raise AssertionError(f"nothing posted as {name} within "
                                 f"{timeout_s} s")
        time.sleep(0.02)
    return json.load(open(path))


class Ranks:
    """``world`` ranks of ``script`` (``<python> <script> <flag>
    <out>/cfg.json <rank>``), started at once; ``name`` heads every
    failure. ``python`` is the command a rank starts with (default: this
    interpreter)."""

    def __init__(self, name: str, script: str, flag: str, cfg: dict,
                 world: int, python: Optional[Sequence[str]] = None):
        self.name, self.world = name, world
        self.out = cfg["out"]
        path = os.path.join(self.out, "cfg.json")
        with open(path, "w") as fh:
            json.dump(cfg, fh)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [_ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        cmd = list(python or [sys.executable])
        self.logs = [open(os.path.join(self.out, f"rank{r}.log"), "w")
                     for r in range(world)]
        self.t0 = time.perf_counter()
        self.procs = [subprocess.Popen(
            cmd + [script, flag, path, str(r)], env=env,
            stdout=self.logs[r], stderr=subprocess.STDOUT)
            for r in range(world)]

    def seconds(self) -> float:
        return time.perf_counter() - self.t0

    def failure(self, grace: float = 0.0) -> Optional[AssertionError]:
        """An AssertionError quoting every rank that failed (the first to
        fail first: the others' collectives then lose it, so each gets
        ``grace`` seconds to end), or None when none did."""
        def failed():
            return [r for r, p in enumerate(self.procs)
                    if p.poll() not in (None, 0)]

        first, end = failed(), time.monotonic() + grace
        while time.monotonic() < end and any(p.poll() is None
                                             for p in self.procs):
            time.sleep(0.05)
            first = first or failed()
        bad = first + [r for r in failed() if r not in first]
        if not bad:
            return None
        for fh in self.logs:
            fh.flush()
        return AssertionError("".join(
            f"{self.name}: rank {r} failed (exit "
            f"{self.procs[r].returncode}):\n"
            f"{open(os.path.join(self.out, f'rank{r}.log')).read()[-4000:]}"
            "\n" for r in bad))

    def _check(self, deadline: float, what: str):
        err = self.failure(grace=2.0 if any(
            p.poll() not in (None, 0) for p in self.procs) else 0.0)
        if err is not None:
            raise err
        if time.monotonic() > deadline:
            stalled = [r for r, p in enumerate(self.procs)
                       if p.poll() is None]
            raise AssertionError(f"{self.name}: ranks {stalled} stalled "
                                 f"past the deadline {what}")

    def post(self, name: str, obj=None):
        post(self.out, name, obj)

    def await_file(self, name: str, timeout_s: float):
        """The JSON a rank posted as ``name``, once it is there."""
        deadline = time.monotonic() + timeout_s
        path = os.path.join(self.out, name)
        while not os.path.exists(path):
            self._check(deadline, f"(waiting for {name})")
            time.sleep(0.02)
        return json.load(open(path))

    def wait(self, timeout_s: float) -> List[dict]:
        """Every rank's JSON result, once all have ended."""
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in self.procs):
            self._check(deadline, f"of {timeout_s} s")
            time.sleep(0.1)
        self._check(deadline, "")
        return [json.load(open(os.path.join(self.out, f"rank{r}.json")))
                for r in range(self.world)]

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fh in self.logs:
            fh.close()
        shutil.rmtree(self.out, ignore_errors=True)


def run_ranks(name: str, script: str, flag: str, cfg: dict, world: int,
              timeout_s: float, python: Optional[Sequence[str]] = None):
    """Start the ranks, wait for them and clean up: ``(each rank's JSON
    result, seconds)``."""
    ranks = Ranks(name, script, flag, cfg, world, python)
    try:
        return ranks.wait(timeout_s), ranks.seconds()
    finally:
        ranks.close()
