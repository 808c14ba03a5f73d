"""Per-device op-variant autotuning with a persisted winner DB
(counterpart of veles_tpu/runtime/autotune.py).

An op with several mathematically equivalent formulations (the LRN
window sum as a cumulative-sum difference, a float32 band product or a
band product over bf16-rounded squares, ``ops/lrn.py``) asks
:func:`pick` for the measured winner on the device of its arguments at
their shapes.  Winners persist under the ``autotune`` key of the
per-device-kind DB that ``runtime/benchmark.py`` keeps
(``root.common.cache_dir/device_infos.json``, keyed by
``torch.cuda.get_device_name()`` or ``"cpu"``), so a second build on the
same kind of card measures nothing; an in-process memo answers a repeat
without reading the DB.

:func:`measure` times on the card with CUDA events around ``reps``
calls after a warm-up call, and on the CPU with ``time.perf_counter``.
Each call runs: eager PyTorch neither folds repetitions nor skips
outputs, so the JAX package's in-graph chaining has no counterpart.

The JAX package also autotunes a kernel against its XLA expression
(dropout, mean/disp, the fullbatch gather).  Those picks have no
counterpart here: on the card the port always runs its hand-written
kernel, and the plain PyTorch version of a kernel is the CPU route and a
test witness, never a candidate.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Mapping, Optional, Sequence

import torch

from ..config import root
from ..logger import Logger
from .benchmark import (device_info_path, device_kind, load_device_infos,
                        update_device_info)


class _AutotuneLog(Logger):
    pass


_log = _AutotuneLog()

#: in-process memo: "db path|device kind|op|shapes" -> (winner, the
#: candidate set it won among), so one run never reads the DB (or
#: measures) twice for one decision, and a new candidate is measured
_memo: Dict[str, tuple] = {}


def _shape_key(args: Sequence) -> str:
    parts = []
    for a in args:
        shape = tuple(getattr(a, "shape", ()) or ())
        dtype = str(getattr(a, "dtype", None)).replace("torch.", "")
        parts.append(f"{'x'.join(map(str, shape))}:{dtype}")
    return ",".join(parts)


def _device(args: Sequence) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def measure(fn: Callable, args: Sequence, reps: int = 4,
            iters: int = 3) -> float:
    """Seconds of one ``fn(*args)``, the mean of ``reps * iters`` calls
    after one warm-up call: CUDA events on the card, ``perf_counter`` on
    the CPU."""
    n = reps * iters
    dev = _device(args)
    fn(*args)                       # warm-up (and the first-call costs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    return (time.perf_counter() - t0) / n


def _key(op: str, args: Sequence, cache_dir: Optional[str], device=None):
    kind = device_kind(_device(args) if device is None else device)
    key = f"{op}|{_shape_key(args)}"
    return kind, key, f"{device_info_path(cache_dir)}|{kind}|{key}"


def lookup(op: str, names: Sequence[str], args: Sequence,
           cache_dir: Optional[str] = None, *,
           device=None) -> Optional[str]:
    """The winner for ``op`` from the memo or the DB only, never
    measured; None without a record for exactly this candidate set.
    Only the shapes and dtypes of ``args`` are read (tensors on the meta
    device will do), and their device unless ``device`` is given."""
    kind, key, memo_key = _key(op, args, cache_dir, device)
    hit = _memo.get(memo_key)
    if hit is not None and hit[1] == frozenset(names):
        return hit[0]
    try:
        infos = load_device_infos(cache_dir)
    except (OSError, ValueError):
        return None
    rec = infos.get(kind, {}).get("autotune", {}).get(key)
    if (rec and rec.get("winner") in names
            and set(rec.get("ms", ())) == set(names)):
        _memo[memo_key] = (rec["winner"], frozenset(names))
        return rec["winner"]
    return None


def pick(op: str, candidates: Mapping[str, Callable], args: Sequence,
         default: Optional[str] = None, cache_dir: Optional[str] = None,
         refresh: bool = False) -> str:
    """Name of the fastest candidate for ``op`` on the device of
    ``args``: measured at most once per (device kind, op, argument
    shapes and dtypes, candidate set), then answered from the memo or
    the DB.  ``root.common.autotune = False`` gives ``default`` (the
    first candidate when None); a candidate that fails makes the pick
    ``default``: autotuning never breaks a build."""
    names = list(candidates)
    if default is None:
        default = names[0]
    if len(names) == 1:
        return names[0]
    if not bool(root.common.autotune):
        return default
    kind, key, memo_key = _key(op, args, cache_dir)
    if not refresh:
        cached = lookup(op, names, args, cache_dir)
        if cached is not None:
            return cached
    timings = {}
    try:
        for name in names:
            timings[name] = measure(candidates[name], args)
    except Exception as e:  # noqa: BLE001 — any failing candidate loses
        _log.warning("autotune %s failed (%s: %s); using default %r",
                     op, type(e).__name__, e, default)
        _memo[memo_key] = (default, frozenset(names))
        return default
    winner = min(timings, key=timings.get)
    _log.info("autotune %s on %s: %s -> %s", op, kind,
              {k: f"{v * 1e3:.3f}ms" for k, v in timings.items()}, winner)
    record = {"winner": winner,
              "ms": {k: round(v * 1e3, 4) for k, v in timings.items()}}
    try:
        update_device_info(
            kind, lambda rec: rec.setdefault("autotune", {})
            .__setitem__(key, record), cache_dir)
    except OSError as e:       # a read-only cache dir: the memo holds
        _log.warning("autotune DB not persisted: %s", e)
    _memo[memo_key] = (winner, frozenset(names))
    return winner
