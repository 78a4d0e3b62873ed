"""Dynamic lock-order detector: record the acquisition graph, fail on
cycles.

The static lock pass checks that guarded state stays under its lock;
it cannot see *ordering* — thread A taking the scheduler lock then a
registry lock while thread B takes them the other way deadlocks only
under the right interleaving, which a test suite may never hit. The
classic fix is to detect the *potential*: maintain a directed graph of
lock-ordering edges (an edge L1→L2 each time L2 is acquired while L1
is held) across all threads, and flag any cycle — a lock-order
inversion is a deadlock waiting for its interleaving, whether or not
the test deadlocked.

Opt-in instrumentation, zero overhead when not installed:
:meth:`LockOrderDetector.install` monkeypatches ``threading.Lock`` /
``threading.RLock`` with a factory that wraps *only locks allocated
from this repo's code* (the caller's frame must come from
``distkeras_torch/`` or ``tests/`` — stdlib internals like
``queue.Queue``'s mutex keep real locks, so neither overhead nor graph
noise leaks in). Wrapped locks report acquire/release to the
detector, which keys the graph by **allocation site** (``file:line``)
rather than instance — a thousand per-request locks from one site are
one node, and an inversion between two *instances* of the same site is
still a cycle (the self-edge).

Scope and caveats:

- Locks allocated before ``install()`` (module-global registries) are
  invisible; the serving/router/telemetry suites construct their
  engines, clients, and registries inside tests, which is where the
  interesting ordering lives.
- ``uninstall()`` restores ``threading`` and disables recording on
  every wrapper already handed out, so long-lived objects created
  during one test can't report into a later test's detector.
- Cycle *detection* runs at edge-insert time (new edges only), so the
  steady-state cost per acquire is one set lookup.

The conftest fixture enables this for ``tests/test_serving.py``,
``tests/test_router.py``, and ``tests/test_telemetry.py`` and asserts
:attr:`cycles` is empty at teardown; everywhere else nothing is
installed and ``threading`` is untouched.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock


class LockOrderError(AssertionError):
    """A lock-order inversion (cycle in the acquisition graph)."""


class _TrackedLock:
    """Wrapper reporting acquire/release to its detector. Supports the
    full Lock/RLock surface the stack uses (context manager, blocking
    and timeout acquires, ``locked``)."""

    __slots__ = ("_lock", "site", "_det")

    def __init__(self, real, site: str, det: "LockOrderDetector"):
        self._lock = real
        self.site = site
        self._det = det

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._det._note_acquire(self)
        return ok

    def release(self):
        self._det._note_release(self)
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._lock.locked()

    def __repr__(self):
        return f"<tracked {self._lock!r} from {self.site}>"


class LockOrderDetector:
    """Install/uninstall the instrumentation and hold the global
    acquisition graph. One detector per test (the conftest fixture);
    :attr:`cycles` collects every inversion seen while installed."""

    def __init__(self, packages: Tuple[str, ...] = ("distkeras_torch",
                                                    "tests")):
        self._markers = tuple(os.sep + p + os.sep for p in packages)
        self._enabled = False
        self._installed = False
        # graph over allocation sites; guarded by an UNtracked lock
        self._glock = _REAL_LOCK()
        self._edges: Dict[str, Set[str]] = {}
        self._edge_where: Dict[Tuple[str, str], str] = {}
        # same-site nesting is tracked per instance PAIR: two locks
        # from one allocation site nested in both orders is an
        # inversion, one consistent order is not (wrapper refs are
        # kept so id() reuse can't alias a dead lock onto a live one)
        self._pair_order: Dict[Tuple[int, int], str] = {}
        self._pair_refs: List[object] = []
        self.cycles: List[dict] = []
        self._tls = threading.local()

    # -- lifecycle ----------------------------------------------------------

    def install(self) -> "LockOrderDetector":
        if self._installed:
            return self
        self._enabled = True
        self._installed = True
        threading.Lock = self._make_factory(_REAL_LOCK)
        threading.RLock = self._make_factory(_REAL_RLOCK)
        return self

    def uninstall(self):
        if not self._installed:
            return
        threading.Lock = _REAL_LOCK
        threading.RLock = _REAL_RLOCK
        # wrappers already handed out keep working but go silent, so a
        # thread outliving this test can't report into the next one
        self._enabled = False
        self._installed = False

    def __enter__(self) -> "LockOrderDetector":
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    # -- allocation ---------------------------------------------------------

    def _make_factory(self, real_ctor):
        def factory():
            frame = sys._getframe(1)
            fname = frame.f_code.co_filename
            if self._enabled and any(m in fname for m in self._markers):
                site = (f"{os.path.basename(fname)}:{frame.f_lineno}")
                return _TrackedLock(real_ctor(), site, self)
            return real_ctor()

        return factory

    # -- acquisition graph ---------------------------------------------------

    def _held(self) -> List[_TrackedLock]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _note_acquire(self, lock: _TrackedLock):
        if not self._enabled:
            return
        held = self._held()
        if any(h is lock for h in held):
            held.append(lock)  # RLock reentry: no new ordering edge
            return
        for h in held:
            self._add_edge(h, lock)
        held.append(lock)

    def _note_release(self, lock: _TrackedLock):
        held = getattr(self._tls, "held", None)
        if held:
            for i in range(len(held) - 1, -1, -1):
                if held[i] is lock:
                    del held[i]
                    break

    def _add_edge(self, a: _TrackedLock, b: _TrackedLock):
        src, dst = a.site, b.site
        where = threading.current_thread().name
        if src == dst:
            # two instances of one allocation site: an inversion only
            # if the same pair has nested in the opposite order
            with self._glock:
                if (id(b), id(a)) in self._pair_order:
                    self.cycles.append({
                        "cycle": [src, dst],
                        "new_edge": (src, dst),
                        "thread": where,
                        "edges": {f"{src}->{dst}": where,
                                  f"{dst}->{src}":
                                      self._pair_order[(id(b), id(a))]},
                    })
                elif (id(a), id(b)) not in self._pair_order:
                    self._pair_order[(id(a), id(b))] = where
                    self._pair_refs.extend((a, b))
            return
        with self._glock:
            if dst in self._edges.setdefault(src, set()):
                return  # known edge: steady-state fast path
            self._edges[src].add(dst)
            self._edge_where[(src, dst)] = where
            path = self._find_path_locked(dst, src)
            if path is not None:
                cycle = [src] + path
                self.cycles.append({
                    "cycle": cycle,
                    "new_edge": (src, dst),
                    "thread": where,
                    "edges": {
                        f"{x}->{y}": self._edge_where.get((x, y), "?")
                        for x, y in zip(cycle, cycle[1:])
                    },
                })

    def _find_path_locked(self, start: str,
                          goal: str) -> Optional[List[str]]:
        """DFS path start→goal in the site graph (caller holds
        ``_glock``). start == goal is itself a cycle."""
        if start == goal:
            return [start]
        stack = [(start, [start])]
        seen = {start}
        while stack:
            node, path = stack.pop()
            for nxt in self._edges.get(node, ()):
                if nxt == goal:
                    return path + [goal]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    # -- reporting ----------------------------------------------------------

    def edge_count(self) -> int:
        with self._glock:
            return sum(len(v) for v in self._edges.values())

    def assert_no_cycles(self):
        """Raise :class:`LockOrderError` describing every inversion
        recorded while installed (no-op when the graph is acyclic)."""
        with self._glock:
            cycles = list(self.cycles)
        if not cycles:
            return
        lines = []
        for c in cycles:
            lines.append(
                " -> ".join(c["cycle"])
                + f"  (closing edge {c['new_edge'][0]}->"
                  f"{c['new_edge'][1]} on thread {c['thread']})"
            )
        raise LockOrderError(
            "lock-order inversion(s) detected — these orderings can "
            "deadlock under the right interleaving:\n  "
            + "\n  ".join(lines)
        )
