"""Host launcher: one rank process per ``--hosts`` entry (counterpart of
veles_tpu/parallel/launcher.py, ``HostLauncher`` :27 and ``launch_hosts``
:116).

The launcher starts N identical processes (a local ``subprocess`` for a
localhost entry, ``ssh`` otherwise), handing each its rank through the
``VELES_*`` environment that ``distributed.initialize_distributed``
reads; host 0's machine is the rendezvous.  If any rank dies the
launcher terminates the rest (gang scheduling) and reports the first
failing exit code: recovery is a restart from a snapshot."""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Dict, List, Optional, Sequence

from ..logger import Logger

_LOCAL = {"localhost", "127.0.0.1", ""}


class HostLauncher(Logger):
    """Launch ``command`` on every host with rank env vars set."""

    def __init__(self, hosts: Sequence[str], *, coordinator_port: int = 9428,
                 ssh_args: Optional[Sequence[str]] = None):
        self.hosts = [h.strip() for h in hosts if h.strip()]
        if not self.hosts:
            raise ValueError("no hosts")
        self.coordinator_port = coordinator_port
        # -tt forces a pty so terminating the ssh client HUPs the remote
        # process (else only the local ssh would die)
        self.ssh_args = list(ssh_args or ("-o", "BatchMode=yes", "-tt"))
        self.procs: List[subprocess.Popen] = []

    def _env_for(self, rank: int) -> Dict[str, str]:
        if self.hosts[0] in _LOCAL:
            # With remote ranks in the gang, "127.0.0.1" would point each
            # one at ITS OWN loopback; give them this host's name.
            any_remote = any(h not in _LOCAL for h in self.hosts)
            import socket
            coord_host = socket.gethostname() if any_remote else "127.0.0.1"
        else:
            coord_host = self.hosts[0]
        return {
            "VELES_COORDINATOR": f"{coord_host}:{self.coordinator_port}",
            "VELES_NUM_PROCESSES": str(len(self.hosts)),
            "VELES_PROCESS_ID": str(rank),
        }

    def launch(self, command: Sequence[str]) -> List[subprocess.Popen]:
        """Start the command on every host; returns the process handles
        (remote hosts run under ssh)."""
        for rank, host in enumerate(self.hosts):
            env_vars = self._env_for(rank)
            if host in _LOCAL:
                env = dict(os.environ)
                env.update(env_vars)
                proc = subprocess.Popen(list(command), env=env)
            else:
                import shlex
                exports = " ".join(f"{k}={v}" for k, v in env_vars.items())
                remote = (f"cd {shlex.quote(os.getcwd())} && {exports} "
                          + " ".join(shlex.quote(c) for c in command))
                proc = subprocess.Popen(
                    ["ssh", *self.ssh_args, host, remote])
            self.info("rank %d on %s: pid %d", rank, host or "localhost",
                      proc.pid)
            self.procs.append(proc)
        return self.procs

    def wait(self, timeout: Optional[float] = None) -> int:
        """Wait for all ranks, polling every process (a failed rank must
        be seen while another waits for it in a collective).  On the
        first non-zero exit the rest are terminated.  Returns the first
        non-zero exit code, else 0."""
        import time as _time
        deadline = None if timeout is None else _time.monotonic() + timeout
        failed = 0
        pending = list(self.procs)
        while pending:
            progressed = False
            for proc in list(pending):
                code = proc.poll()
                if code is None:
                    continue
                progressed = True
                pending.remove(proc)
                if code != 0 and failed == 0:
                    failed = code
                    self.warning("rank %d exited %d; terminating the gang",
                                 self.procs.index(proc), code)
                    for other in pending:
                        other.terminate()
            if pending and not progressed:
                if deadline is not None and _time.monotonic() > deadline:
                    self.terminate()
                    raise subprocess.TimeoutExpired(
                        "gang", timeout if timeout is not None else 0)
                _time.sleep(0.05)
        return failed

    def terminate(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.terminate()


def launch_hosts(hosts: Sequence[str], argv: Sequence[str], *,
                 coordinator_port: int = 9428,
                 timeout: Optional[float] = None) -> int:
    """One-shot: spawn ``python -m veles_tpu_torch <argv>`` per host and
    wait."""
    launcher = HostLauncher(hosts, coordinator_port=coordinator_port)
    launcher.launch([sys.executable, "-m", "veles_tpu_torch", *argv])
    return launcher.wait(timeout)
