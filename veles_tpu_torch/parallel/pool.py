"""Host-process worker pools for meta-workflow evaluation fan-out (the
``CliRunner`` and ``ParallelMap`` of veles_tpu/parallel/pool.py, which
holds no JAX).

One independent training process per evaluation: a bounded local pool
of ``python -m veles_tpu_torch`` subprocesses, each writing its results
dict to a ``--result-file`` the pool reads back.

Device discipline: concurrent subprocesses must not fight over one
card.  ``CliRunner`` therefore pins workers to the CPU by default
(``--device cpu``, where the JAX package sets ``JAX_PLATFORMS=cpu``)
unless the caller passes ``pin_cpu=False`` (a serial caller whose one
job may use the card: the curriculum).  The reference's ``env``
argument (a card per worker, for the GA and ensemble fan-out) comes
with those callers.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

from ..logger import Logger


class CliRunner(Logger):
    """Run ``python -m veles_tpu_torch <argv>`` jobs on up to ``n_workers``
    concurrent subprocesses; returns each job's ``--result-file`` JSON."""

    def __init__(self, n_workers: int = 1,
                 timeout: Optional[float] = None,
                 pin_cpu: bool = True):
        self.n_workers = max(int(n_workers), 1)
        self.timeout = timeout
        # pin_cpu=False: serial callers (curriculum) whose single job may
        # legitimately use the card keep the CLI's default device.
        self.pin_cpu = pin_cpu

    def _run_one(self, argv: Sequence[str], tag: str) -> dict:
        fd, result_path = tempfile.mkstemp(
            prefix=f"veles_job_{tag}_", suffix=".json")
        os.close(fd)
        cmd = [sys.executable, "-m", "veles_tpu_torch", *argv,
               "--result-file", result_path]
        if self.pin_cpu:
            # Pin workers to the CPU even when the argv names a device —
            # concurrent subprocesses must never fight over one card
            # (the last --device wins).
            cmd += ["--device", "cpu"]
        try:
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=self.timeout)
            except subprocess.TimeoutExpired:
                self.warning("job %s timed out after %.0fs", tag,
                             self.timeout)
                return {"error": f"timeout after {self.timeout}s",
                        "returncode": -1}
            if proc.returncode != 0:
                self.warning("job %s failed (rc=%d): %s", tag,
                             proc.returncode, proc.stderr[-2000:])
                return {"error": proc.stderr[-2000:],
                        "returncode": proc.returncode}
            with open(result_path) as f:
                data = f.read()
            return json.loads(data) if data.strip() else {}
        finally:
            try:
                os.unlink(result_path)
            except OSError:
                pass

    def run_jobs(self, jobs: Sequence[Sequence[str]]) -> List[dict]:
        """Execute all jobs; order of results matches order of jobs."""
        if self.n_workers == 1:
            return [self._run_one(j, str(i)) for i, j in enumerate(jobs)]
        with ThreadPoolExecutor(self.n_workers) as ex:
            futs = [ex.submit(self._run_one, j, str(i))
                    for i, j in enumerate(jobs)]
            return [f.result() for f in futs]


class ParallelMap:
    """Thread-pool map for in-process fitness callables whose heavy work
    releases the GIL or blocks on IO/subprocesses (the degenerate
    n_workers=1 case is a plain loop, keeping determinism)."""

    def __init__(self, fn, n_workers: int = 1):
        self.fn = fn
        self.n_workers = max(int(n_workers), 1)

    def __call__(self, items: Sequence) -> List:
        if self.n_workers == 1:
            return [self.fn(x) for x in items]
        with ThreadPoolExecutor(self.n_workers) as ex:
            return list(ex.map(self.fn, items))
