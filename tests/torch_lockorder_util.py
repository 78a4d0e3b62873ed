"""The dynamic lock-order detector of the port
(:mod:`distkeras_torch.analysis.lockorder`), armed from the suites that
drive the port's cross-thread serving surfaces — the counterparts of the
reference's ``test_serving``, ``test_router`` and ``test_telemetry``, and
the server suites. A suite arms it by importing the fixture::

    from torch_lockorder_util import lock_order  # noqa: F401

Every ``threading.Lock`` / ``RLock`` allocated from ``distkeras_torch``
or test code during a test then reports its acquisition order, and a
cycle in the graph — a lock-order inversion, a deadlock waiting for its
interleaving — fails the test even though nothing deadlocked. Locks
allocated before the test (module-scoped servers, import-time globals)
stay invisible, as in the reference's conftest fixture."""

import pytest

from distkeras_torch.analysis.lockorder import LockOrderDetector


@pytest.fixture(autouse=True)
def lock_order():
    det = LockOrderDetector(packages=("distkeras_torch", "tests"))
    det.install()
    try:
        yield det
    finally:
        det.uninstall()
    det.assert_no_cycles()
