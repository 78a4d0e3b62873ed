"""Job deployment — launch training jobs on remote hosts; the port of
:mod:`distkeras_tpu.job_deployment`, with the same environment variables
and the same commands.

Reference: distkeras/job_deployment.py · Job — packages a job and launches
it on a Spark cluster over ssh + spark-submit. Here a Python training
script runs on one or more hosts over ssh (or locally through a
subprocess), each process given the ``DK_TPU_*`` environment that
:func:`distkeras_torch.runtime.initialize` reads: the
``torch.distributed`` rendezvous address, its rank, the world size and the
parameter-server address of the async trainers. ``hosts=["local"] * n``
runs n processes on this host (one card each when they run on cards).
No scheduler integration is assumed.
"""

from __future__ import annotations

import os
import shlex
import subprocess
from typing import Dict, List, Optional, Sequence


class Job:
    """Describe + run a multi-host training job.

    Args:
      script: path to the training script (must exist on the remote hosts
        or be rsync'd by the caller).
      hosts: ssh destinations, one per participating host. ``None`` or
        ``["local"]`` runs a single local process (the test/dev path).
      coordinator_port: port of the ``torch.distributed`` rendezvous (host 0).
      ps_port: parameter-server service port for async trainers.
      env: extra environment for every process.
      python: interpreter to use.
    """

    def __init__(
        self,
        script: str,
        script_args: Sequence[str] = (),
        hosts: Optional[List[str]] = None,
        coordinator_port: int = 9885,
        ps_port: int = 9886,
        env: Optional[Dict[str, str]] = None,
        python: str = "python3",
    ):
        self.script = script
        self.script_args = list(script_args)
        self.hosts = list(hosts) if hosts else ["local"]
        self.coordinator_port = coordinator_port
        self.ps_port = ps_port
        self.env = dict(env or {})
        self.python = python
        # every job gets a shared secret for the PS transport unless the
        # caller provided one — the auto-wired multi-host service binds a
        # routable interface, so it must never come up unauthenticated
        if "DK_TPU_SECRET" not in self.env:
            import secrets

            self.env["DK_TPU_SECRET"] = secrets.token_hex(16)

    # -- command construction (separated for testability) -------------------

    def environment_for(self, process_id: int) -> Dict[str, str]:
        coordinator = (
            "127.0.0.1" if self.hosts[0] == "local" else self.hosts[0].split("@")[-1]
        )
        env = {
            "DK_TPU_COORDINATOR": f"{coordinator}:{self.coordinator_port}",
            "DK_TPU_PROCESS_ID": str(process_id),
            "DK_TPU_NUM_PROCESSES": str(len(self.hosts)),
            "DK_TPU_PS_ADDRESS": f"{coordinator}:{self.ps_port}",
        }
        env.update(self.env)
        return env

    def command_for(self, process_id: int) -> List[str]:
        host = self.hosts[process_id]
        env = self.environment_for(process_id)
        env_prefix = " ".join(
            f"{k}={shlex.quote(v)}" for k, v in sorted(env.items())
        )
        remote_cmd = (
            f"{env_prefix} {self.python} {shlex.quote(self.script)} "
            + " ".join(shlex.quote(a) for a in self.script_args)
        ).strip()
        if host == "local":
            return ["bash", "-c", remote_cmd]
        return ["ssh", "-o", "BatchMode=yes", host, remote_cmd]

    # -- execution ----------------------------------------------------------

    def run(self, wait: bool = True) -> List[subprocess.Popen]:
        """Launch every process (host 0 first — it hosts the coordinator and
        the parameter server). Returns the Popen handles; with ``wait`` the
        call blocks and raises if any process exits nonzero
        (reference: Job.run blocks on spark-submit)."""
        procs = []
        for pid in range(len(self.hosts)):
            cmd = self.command_for(pid)
            procs.append(subprocess.Popen(
                cmd,
                env={**os.environ, **self.environment_for(pid)}
                if self.hosts[pid] == "local" else None,
            ))
        if wait:
            failed = []
            for pid, p in enumerate(procs):
                if p.wait() != 0:
                    failed.append((pid, p.returncode))
            if failed:
                raise RuntimeError(f"job processes failed: {failed}")
        return procs
