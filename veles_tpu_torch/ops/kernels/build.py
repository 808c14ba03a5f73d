"""Build and load the port's hand-written CUDA kernels.

Each source under ``veles_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds, not minutes).
Libraries land in ``veles_tpu_torch/_build/`` — listed in ``.gitignore`` —
under a name that carries a digest of the source and flags, so an edited
source is rebuilt and an unchanged one is reused.  Nothing is compiled at
import time: :func:`load` builds on first use, and :func:`build` starts one
``nvcc`` per missing source, all at once.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: library name -> source file under csrc/ (``*.cuh`` headers there are
#: shared: a change to one rebuilds every library)
SOURCES = {
    "flash_fwd_tc": "flash_fwd_tc.cu",
    "flash_fwd_tf32x3": "flash_fwd_tf32x3.cu",
    "flash_bwd_dq_tc": "flash_bwd_dq_tc.cu",
    "flash_bwd_dq_tf32x3": "flash_bwd_dq_tf32x3.cu",
    "flash_bwd_dkv_tc": "flash_bwd_dkv_tc.cu",
    "flash_bwd_dkv_tf32x3": "flash_bwd_dkv_tf32x3.cu",
    "paged_attention": "paged_attention.cu",
    "gather_rows": "gather_rows.cu",
    "fused_dropout": "fused_dropout.cu",
    "mean_disp": "mean_disp.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: name -> compiler output of the build this process ran (ptxas register /
#: spill report); empty for a library reused from an earlier build
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    """``nvcc`` from the CUDA toolkit PyTorch was pointed at (CUDA_HOME),
    else from PATH."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the "
            "port's CUDA kernels are built from veles_tpu_torch/csrc at "
            "first use")
    return found


def library_path(name: str) -> Path:
    src = CSRC / SOURCES[name]
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every requested library that is not built yet, one nvcc
    process per source, all started together.  Returns name -> seconds
    of this process's build (0.0 when reused).  Raises with the compiler
    output when a build fails."""
    names = list(SOURCES if names is None else names)
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        took = {n: 0.0 for n in names}
        for name in names:
            target = library_path(name)
            if target.exists():
                continue
            tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / SOURCES[name])]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, target, tmp, proc, time.perf_counter()))

        def finish(job):
            proc, t0 = job[3], job[4]
            log, _ = proc.communicate()
            return log, time.perf_counter() - t0

        # one waiter per nvcc, so each source's seconds are its own
        with ThreadPoolExecutor(max(1, len(jobs))) as pool:
            done = list(pool.map(finish, jobs))
        failed = []
        for (name, target, tmp, proc, _), (log, seconds) in zip(jobs, done):
            took[name] = seconds
            build_logs[name] = log
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {SOURCES[name]} "
                              f"(exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, target)
        if failed:
            raise RuntimeError("\n".join(failed))
        return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(library_path(name)))
            lib.vt_error_string.argtypes = [ctypes.c_int]
            lib.vt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise with the CUDA error text when a launch returned non-zero."""
    if rc != 0:
        msg = lib.vt_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


class LaunchCounter:
    """Plain count of a kernel's launches; the wrapper adds one exactly
    where it launches the kernel, so a run can show that its main path
    went through the kernel.  A kernel built in variants (the flash
    kernels: ``"tc"`` for bf16, ``"tf32x3"`` for float32) names
    the variant it launched, and :meth:`by_variant` counts each."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0
        self._variants: Dict[str, int] = {}

    def inc(self, variant: Optional[str] = None) -> None:
        with self._lock:
            self._n += 1
            if variant is not None:
                self._variants[variant] = self._variants.get(variant, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0
            self._variants = {}

    def state(self):
        """``(count, {variant: count})`` now: what a CUDA-graph capture
        reads before and after, since a capture records launches and runs
        none (``runtime/step_cache.py``)."""
        with self._lock:
            return self._n, dict(self._variants)

    def set_state(self, state) -> None:
        """Back to a :meth:`state` (the capture's recorded calls undone)."""
        with self._lock:
            self._n, self._variants = state[0], dict(state[1])

    def add(self, n: int, variants: Optional[Dict[str, int]] = None) -> None:
        """``n`` launches at once (a graph replay's recorded launches)."""
        with self._lock:
            self._n += n
            for v, c in (variants or {}).items():
                self._variants[v] = self._variants.get(v, 0) + c

    @property
    def count(self) -> int:
        return self._n

    def by_variant(self) -> Dict[str, int]:
        """Launches per variant since the last reset."""
        with self._lock:
            return dict(self._variants)


#: custom op (its default overload) -> (kernel name, cost of one call
#: from the op's arguments): what a cost counter adds when a sealed
#: program calls the op with no wrapper around it
_OP_COSTS: Dict[object, tuple] = {}


def register_op(op, name: str, cost_fn: Callable[..., Dict[str, float]]
                ) -> None:
    """Record ``op`` (a ``torch.library.custom_op``) as kernel ``name``
    whose one call costs ``cost_fn(*op_args)``."""
    _OP_COSTS[op._opoverload] = (name, cost_fn)


def op_cost(func):
    """``(name, cost_fn)`` of a registered kernel op, else None."""
    return _OP_COSTS.get(func)


def active_cost_counter():
    """The innermost cost counter (``runtime.step_cache.CostCounter``, a
    ``TorchDispatchMode``) on this thread's dispatch-mode stack, or None.
    The stack is what autograd hands its worker threads, so a backward
    wrapper finds the counter its forward ran under."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if hasattr(mode, "add_kernel_cost"):
            return mode
    return None


@contextlib.contextmanager
def reporting(name: str, cost: Callable[[], Dict[str, float]]):
    """Around one wrapper call, on either route: under an active cost
    counter, add ``cost()`` (the module's ``cost``: ``{"flops",
    "bytes"}`` of this launch) under ``name`` and keep the counter from
    counting the plain version's own ops, so a step counts the same on
    the CPU and on the card.  Without a counter nothing is computed."""
    counter = active_cost_counter()
    if counter is None:
        yield
        return
    with counter.quiet():
        counter.add_kernel_cost(name, cost())
        yield
