"""Device benchmark & compute-power rating (counterpart of
veles_tpu/runtime/benchmark.py).

The reference's gemm DeviceBenchmark unit (veles/accelerated_units.py:
706-824) rated a device by its GEMM time and kept the ratings in a
per-device DB.  Here the calibration times a chain of dependent
``torch.matmul`` calls per (size, dtype) with CUDA events on the card
(the host clock around a finished chain on the CPU, where a caller asks
for it), and persists the achieved TFLOP/s per device kind
(``torch.cuda.get_device_name()``) under ``root.common.cache_dir``.  The
best measured rate is the MFU denominator (:func:`resolve_peak_tflops`)
unless ``root.common.observe.peak_tflops`` overrides it; the rating
(1000 / the largest GEMM's seconds) survives for job farming.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Sequence

import torch

from ..config import root
from ..logger import Logger
from ..ops import resolve_device

DEFAULT_SIZES = (1024, 2048, 4096)
DEFAULT_DTYPES = ("float32", "bfloat16")
#: dependent GEMMs a timed chain runs, so launch latency amortizes
CHAIN = 32


def device_kind(device=None) -> str:
    """The DB key of ``device``: the card's name, or ``"cpu"``."""
    device = torch.device(device) if device is not None else None
    if device is not None and device.type == "cpu":
        return "cpu"
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(device)


def _gemm_seconds(n: int, dtype: str, reps: int, device) -> float:
    """Best seconds of one n x n GEMM over ``reps`` chains of
    :data:`CHAIN` dependent products (TF32 off for float32: the rate of
    the dtype as the port computes it)."""
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn((n, n), generator=gen) / n ** 0.5).to(
        device=device, dtype=getattr(torch, dtype))
    on_card = device.type == "cuda"

    def chain():
        acc = x
        for _ in range(CHAIN):
            acc = torch.matmul(acc, x)
        return acc

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        chain()                               # warm: cuBLAS handles, heuristics
        best = float("inf")
        for _ in range(reps):
            if on_card:
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                chain()
                t1.record()
                t1.synchronize()
                secs = t0.elapsed_time(t1) / 1e3
            else:
                t = time.perf_counter()
                chain()
                secs = time.perf_counter() - t
            best = min(best, secs / CHAIN)
        return best
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class DeviceBenchmark(Logger):
    """Measure GEMM throughput on ``device`` (default: the card)."""

    def __init__(self, sizes: Sequence[int] = DEFAULT_SIZES,
                 dtypes: Sequence[str] = DEFAULT_DTYPES, reps: int = 3,
                 device=None):
        self.sizes = tuple(sizes)
        self.dtypes = tuple(dtypes)
        self.reps = reps
        self.device = resolve_device(device)

    def run(self) -> Dict:
        entries = []
        for dtype in self.dtypes:
            for n in self.sizes:
                secs = _gemm_seconds(n, dtype, self.reps, self.device)
                tflops = 2.0 * n ** 3 / secs / 1e12
                entries.append({"size": n, "dtype": dtype,
                                "seconds": secs, "tflops": tflops})
                self.info("gemm %dx%d %s: %.3f ms, %.2f TFLOPS",
                          n, n, dtype, secs * 1e3, tflops)
        return {"device_kind": device_kind(self.device),
                "platform": self.device.type,
                "results": entries,
                "computing_power": self.computing_power(entries)}

    @staticmethod
    def computing_power(entries) -> float:
        """Reference rating: 1000 / the GEMM time of the largest
        float32-equivalent problem."""
        best = max(entries, key=lambda e: e["size"] * (
            2 if e["dtype"] == "float32" else 1))
        return 1000.0 / best["seconds"]


def resolve_peak_tflops(device=None) -> float:
    """The MFU denominator: the ``root.common.observe.peak_tflops``
    override when set, else the best rate this device kind measured in
    the GEMM calibration DB (:func:`benchmark_device` writes it), else
    0.0 ("unknown": every MFU consumer then reports 0).  Never measures
    by itself."""
    override = float(root.common.observe.get("peak_tflops", 0.0) or 0.0)
    if override > 0:
        return override
    info = load_device_infos().get(device_kind(device)) or {}
    rates = [float(e.get("tflops", 0.0))
             for e in info.get("results", ()) or ()]
    return max(rates) if rates else 0.0


def mfu_fraction(flops: float, wall_s: float, peak_tflops: float) -> float:
    """Model FLOPs utilization: achieved flops/s over the peak; 0.0
    whenever an input is unknown or degenerate."""
    if flops <= 0 or wall_s <= 0 or peak_tflops <= 0:
        return 0.0
    return (flops / wall_s) / (peak_tflops * 1e12)


def epoch_goodput(flops_per_step: float, steps: float, wall_s: float,
                  peak_tflops: Optional[float] = None) -> Dict:
    """Goodput of one training epoch: achieved flops/s over the wall the
    caller passes (the Trainer's train-phase wall) and MFU against the
    peak."""
    if peak_tflops is None:
        peak_tflops = resolve_peak_tflops()
    total = float(flops_per_step) * float(steps)
    fps = total / wall_s if wall_s > 0 and total > 0 else 0.0
    return {
        "flops_per_step": float(flops_per_step),
        "steps": float(steps),
        "wall_s": float(wall_s),
        "flops_per_sec": fps,
        "peak_tflops": float(peak_tflops),
        "mfu": mfu_fraction(total, wall_s, peak_tflops),
    }


def device_info_path(cache_dir: Optional[str] = None) -> str:
    d = cache_dir or root.common.cache_dir
    return os.path.join(d, "device_infos.json")


def load_device_infos(cache_dir: Optional[str] = None) -> Dict:
    path = device_info_path(cache_dir)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def update_device_info(kind: str, mutate, cache_dir: Optional[str] = None
                       ) -> str:
    """Atomic read-modify-write of one device-kind record: writers
    serialize on a sidecar lock file, and the tmp-write + ``os.replace``
    keeps the DB whole for lock-free readers."""
    import fcntl
    path = device_info_path(cache_dir)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            infos = load_device_infos(cache_dir)
        except json.JSONDecodeError:
            infos = {}
        info = infos.get(kind, {"device_kind": kind})
        mutate(info)
        infos[kind] = info
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(infos, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    return path


def save_device_info(info: Dict, cache_dir: Optional[str] = None) -> str:
    """Persist ``info`` under its device kind (merged under the lock)."""
    return update_device_info(info["device_kind"],
                              lambda rec: rec.update(info), cache_dir)


def benchmark_device(cache_dir: Optional[str] = None, refresh: bool = False,
                     device=None, **kw) -> Dict:
    """The cached rating of ``device`` (default: the card), measured and
    persisted when the DB has none for its kind or ``refresh``."""
    device = resolve_device(device)
    kind = device_kind(device)
    if not refresh:
        cached = load_device_infos(cache_dir).get(kind)
        # a record may hold autotune winners alone (runtime/autotune.py
        # shares it): only a measured GEMM table is a rating
        if cached and cached.get("results"):
            return cached
    info = DeviceBenchmark(device=device, **kw).run()
    save_device_info(info, cache_dir)
    return info
