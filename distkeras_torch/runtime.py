"""Multi-process runtime bootstrap — the port of
:mod:`distkeras_tpu.runtime`, with the same environment contract, so a
:class:`~distkeras_torch.job_deployment.Job` of either package launches
the other's processes.

Environment (written by ``Job.environment_for``):

- ``DK_TPU_COORDINATOR``   host:port of the ``torch.distributed``
  rendezvous (the reference's jax.distributed coordinator)
- ``DK_TPU_PROCESS_ID``    this process's rank
- ``DK_TPU_NUM_PROCESSES`` world size
- ``DK_TPU_PS_ADDRESS``    host:port of the parameter-server service
- ``DK_TPU_SECRET``        optional shared secret for the PS transport

:func:`initialize` reads them, remembers the topology and, for a run of
several processes, calls ``torch.distributed.init_process_group(
init_method="tcp://<coordinator>")`` where the reference calls
``jax.distributed.initialize``: NCCL with this process bound to card
``process_id % device_count`` when the process runs on a card, gloo when
the caller asks for the CPU (``device="cpu"``). The PS trainers read
:func:`current` to wire themselves: the coordinator owns the center and
serves it (:class:`~distkeras_torch.networking.ParameterServerService`),
every other process trains against it through a
:class:`~distkeras_torch.networking.RemoteParameterServer`.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass
class RuntimeContext:
    process_id: int
    num_processes: int
    coordinator: str  # host:port
    ps_address: str  # host:port
    secret: Optional[str] = None
    device: Optional[torch.device] = None

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    @property
    def ps_hostport(self) -> Tuple[str, int]:
        host, port = self.ps_address.rsplit(":", 1)
        return host, int(port)


_context: Optional[RuntimeContext] = None
_dist_initialized = False


def current() -> Optional[RuntimeContext]:
    """The active runtime context, or None in a single-process run."""
    return _context


def initialize(init_distributed: bool = True,
               process_id: Optional[int] = None,
               num_processes: Optional[int] = None,
               coordinator: Optional[str] = None,
               ps_address: Optional[str] = None,
               device=None,
               timeout_s: float = 600.0) -> Optional[RuntimeContext]:
    """Read the ``DK_TPU_*`` environment (or the explicit overrides),
    remember the topology and, for several processes, bring up
    ``torch.distributed``. ``device``: ``None`` (the card; raises without
    one) or ``"cpu"`` (gloo).

    Idempotent: a repeat call returns the existing context. Returns None
    when no multi-process environment is configured."""
    global _context, _dist_initialized
    if _context is not None:
        return _context
    env = os.environ
    num = num_processes if num_processes is not None else int(
        env.get("DK_TPU_NUM_PROCESSES", "1"))
    pid = process_id if process_id is not None else int(
        env.get("DK_TPU_PROCESS_ID", "0"))
    coord = coordinator or env.get("DK_TPU_COORDINATOR", "")
    ps = ps_address or env.get("DK_TPU_PS_ADDRESS", "")
    if num <= 1:
        return None
    if not coord or not ps:
        raise ValueError(
            "multi-process run needs DK_TPU_COORDINATOR and "
            "DK_TPU_PS_ADDRESS (launch via distkeras_torch.job_deployment."
            "Job or export them explicitly)")
    if device is not None and torch.device(device).type == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: runtime.initialize() binds this process "
                "to a card; pass device='cpu' to run over gloo")
        dev = torch.device("cuda", pid % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    ctx = RuntimeContext(process_id=pid, num_processes=num,
                         coordinator=coord, ps_address=ps,
                         secret=env.get("DK_TPU_SECRET") or None, device=dev)
    if init_distributed and not _dist_initialized:
        import torch.distributed as dist

        dist.init_process_group(
            backend, init_method=f"tcp://{coord}", world_size=num,
            rank=pid, timeout=datetime.timedelta(seconds=timeout_s))
        _dist_initialized = True
    _context = ctx
    return ctx


def shutdown():
    """Tear the runtime context down (tests, repeated in-process runs)."""
    global _context, _dist_initialized
    if _dist_initialized:
        import torch.distributed as dist

        dist.destroy_process_group()
        _dist_initialized = False
    _context = None
