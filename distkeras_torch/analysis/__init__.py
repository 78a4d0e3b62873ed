"""Repo-native static analysis of the port: its invariants as code.

``python -m distkeras_torch.analysis`` runs nine AST passes (stdlib
``ast`` only — no third-party parser, no torch import) over the
``distkeras_torch`` package and checks the result against the port's
own baseline (``distkeras_torch/analysis/baseline.txt``). It is the
counterpart of :mod:`distkeras_tpu.analysis`, with the same rule names,
suppression slugs (``# analysis: <slug>``), baseline format and CLI, so
a reader of one package's report can read the other's.

Five passes are the reference's, copied with the package renamed —
they check Python-level contracts that do not depend on the array
library:

- ``lock-discipline`` — attributes written under ``with self.<lock>``
  must always be accessed under the lock
  (:mod:`distkeras_torch.analysis.locks`);
- ``import-hygiene`` — stdlib-only layers (``telemetry/``, the router,
  the replica manager, the controller) stay stdlib-only; package code
  never imports tests (:mod:`~distkeras_torch.analysis.imports`);
- ``wire-contract`` — the framed-msgpack op protocol re-derived from
  ``LMServer._handle`` / ``Router._handle`` / ``ServingClient`` and
  cross-checked; the same extraction renders the port's op reference,
  ``distkeras_torch/analysis/PROTOCOL.md``, through the ``protocol``
  subcommand (:mod:`~distkeras_torch.analysis.wire`);
- ``metric-contract`` — metric families as one namespace
  (:mod:`~distkeras_torch.analysis.metrics_contract`);
- ``span-contract`` — span names known to the ``critical_path()``
  partition (:mod:`~distkeras_torch.analysis.spans`).

Four are rewritten for eager PyTorch, keeping the reference's rule
names:

- ``host-sync-hazard`` — no blocking readback of a *device* value
  (``.item()``, ``.tolist()``, ``.cpu()``, ``np.asarray``, a truth
  test, ...) and no ``synchronize()`` inside ``_plan_dispatch_*`` or
  its same-file callees; host lists and numpy arrays are told apart
  from device tensors by a taint analysis
  (:mod:`~distkeras_torch.analysis.hostsync`);
- ``donation-safety`` — a pinned buffer handed to a ``non_blocking``
  copy is neither written (upload source) nor read (readback
  destination) before a fence (:mod:`~distkeras_torch.analysis.donation`);
- ``rng-discipline`` — serving and model draws name their
  ``torch.Generator``; a slot's generator is seeded only at admission
  (:mod:`~distkeras_torch.analysis.rng`);
- ``recompile-hazard`` — ``lru_cache`` keys and ``torch.compile`` /
  CUDA-graph arguments stay hashable and value-stable
  (:mod:`~distkeras_torch.analysis.recompile`).

A finding is silenced either by a line-level suppression comment for an
individually justified site, or by a baseline entry (rule/path/key +
justification) for a structural pattern. ``--strict`` exits 1 on any
unbaselined finding or unjustified baseline entry.

The dynamic complement is :mod:`distkeras_torch.analysis.lockorder`
(a copy of the reference's): an opt-in lock-order detector that
instruments ``threading.Lock`` / ``RLock`` allocations in package and
test code, records the acquisition graph, and fails on cycles. The
port's serving, router, tracing and server suites arm it from a fixture
in their own files.
"""

from distkeras_torch.analysis.core import (  # noqa: F401
    AnalysisError,
    Baseline,
    Finding,
    Pass,
    ProjectPass,
    SourceFile,
    analyze,
    split_by_baseline,
)


def default_passes():
    """Fresh instances of every pass, in report order."""
    from distkeras_torch.analysis.donation import DonationSafetyPass
    from distkeras_torch.analysis.hostsync import HostSyncHazardPass
    from distkeras_torch.analysis.imports import ImportHygienePass
    from distkeras_torch.analysis.locks import LockDisciplinePass
    from distkeras_torch.analysis.metrics_contract import MetricContractPass
    from distkeras_torch.analysis.recompile import RecompileHazardPass
    from distkeras_torch.analysis.rng import RngDisciplinePass
    from distkeras_torch.analysis.spans import SpanContractPass
    from distkeras_torch.analysis.wire import WireContractPass

    return [
        LockDisciplinePass(),
        DonationSafetyPass(),
        RngDisciplinePass(),
        RecompileHazardPass(),
        ImportHygienePass(),
        WireContractPass(),
        MetricContractPass(),
        SpanContractPass(),
        HostSyncHazardPass(),
    ]


__all__ = [
    "AnalysisError",
    "Baseline",
    "Finding",
    "Pass",
    "ProjectPass",
    "SourceFile",
    "analyze",
    "split_by_baseline",
    "default_passes",
]
