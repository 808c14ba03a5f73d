"""Memory accounting: device-memory gauges and a component ledger
(counterpart of veles_tpu/runtime/memory.py).

Two layers answer "how much device memory is in use, and what is it"
(``GET /memory.json``):

* **device truth**: ``torch.cuda.memory_stats()`` (``allocated_bytes.
  all.current`` / ``.peak`` and ``reserved_bytes.all.current``) and
  ``torch.cuda.mem_get_info()`` for the card's capacity, sampled into
  ``vt_hbm_bytes_{in_use,peak,limit}`` (and ``vt_hbm_bytes_reserved``)
  by an optional poller thread (``root.common.observe.memory_poll_s``)
  and on every ``GET /memory.json``.  On the CPU there is no device
  part;
* **component ledger**: byte counts from shapes (shape x itemsize,
  :func:`tree_bytes`): the engine registers its parameters, its
  serving weight copies, the KV pool, the slot-state buffer, the token
  matrix and the fold-key table; the Trainer its parameters and
  optimizer state.  The ledger is what the device number decomposes
  into.  On the card the gap between the two is named in :meth:`doc`:
  allocated bytes beyond the ledger are activations, workspace and
  the CUDA-graph private pools' live tensors; reserved bytes beyond the
  allocated ones are the caching allocator's free blocks, the graphs'
  pools among them.

Host-side only: accounting never touches a captured step.
"""

from __future__ import annotations

import atexit
import threading
from typing import Dict, Optional

from ..config import root
from ..logger import Logger
from .metrics import registry


def tree_bytes(tree) -> int:
    """Exact payload bytes of a nested dict/list/tuple of tensors, numpy
    arrays or scalars: the sum of ``numel * itemsize`` per leaf, read
    from shapes (no device sync)."""
    import numpy as np
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if tree is None:
        return 0
    numel = getattr(tree, "numel", None)
    if callable(numel) and hasattr(tree, "element_size"):
        return int(numel()) * int(tree.element_size())
    a = np.asarray(tree)
    return int(a.size) * a.dtype.itemsize


class MemoryMonitor(Logger):
    """Process-wide memory view: the device gauges and the component
    ledger, one instance behind :func:`memory_monitor` (the newest
    registration of a name wins, as every process-global gauge here)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._components: Dict[str, int] = {}  # guarded-by: self._lock
        self._stamps: Dict[str, int] = {}      # guarded-by: self._lock
        self._next_stamp = 0                   # guarded-by: self._lock
        self._extras: Dict[str, object] = {}   # guarded-by: self._lock
        self._poller: Optional[threading.Thread] = None  # guarded-by: self._lock
        self._poll_stop = threading.Event()
        self._last_device: Optional[dict] = None  # guarded-by: self._lock
        reg = registry()
        self._g_in_use = reg.gauge(
            "vt_hbm_bytes_in_use",
            "device memory allocated by tensors (torch.cuda.memory_stats "
            "allocated_bytes.all.current)")
        self._g_peak = reg.gauge(
            "vt_hbm_bytes_peak",
            "peak device memory allocated since process start "
            "(allocated_bytes.all.peak)")
        self._g_limit = reg.gauge(
            "vt_hbm_bytes_limit",
            "device memory capacity (torch.cuda.mem_get_info total)")
        self._g_reserved = reg.gauge(
            "vt_hbm_bytes_reserved",
            "device memory the caching allocator holds, CUDA-graph pools "
            "included (reserved_bytes.all.current)")
        self._g_comp = reg.gauge(
            "vt_memory_component_bytes",
            "shape-derived byte ledger by component (engine served "
            "params, KV page pool, slot state, token matrix, fold keys; "
            "trainer params, optimizer state)",
            labels=("component",))

    # -- component ledger ---------------------------------------------------
    def set_component(self, name: str, nbytes: int) -> int:
        """Publish one ledger entry; returns a registration stamp the
        owner passes back to :meth:`drop_component`, so a dying older
        registrant never clobbers the entry a newer one wrote under the
        same name."""
        nbytes = int(nbytes)
        with self._lock:
            self._components[name] = nbytes
            self._next_stamp += 1
            stamp = self._stamps[name] = self._next_stamp
            self._g_comp.labels(component=name).set(nbytes)
        return stamp

    def drop_component(self, name: str,
                       stamp: Optional[int] = None) -> None:
        """Remove a ledger entry when its owner's buffers are released;
        with ``stamp`` only if the entry still belongs to it."""
        with self._lock:
            if stamp is not None and self._stamps.get(name) != stamp:
                return
            self._components.pop(name, None)
            self._stamps.pop(name, None)
            self._g_comp.labels(component=name).set(0)

    def set_extra(self, name: str, value) -> int:
        """A JSON-able annotation shipped in /memory.json beside the
        ledger (the engine's pool geometry), stamped like components."""
        with self._lock:
            self._extras[name] = value
            self._next_stamp += 1
            stamp = self._stamps["extra:" + name] = self._next_stamp
        return stamp

    def drop_extra(self, name: str, stamp: Optional[int] = None) -> None:
        with self._lock:
            if stamp is not None \
                    and self._stamps.get("extra:" + name) != stamp:
                return
            self._extras.pop(name, None)
            self._stamps.pop("extra:" + name, None)

    def components(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._components)

    # -- device truth -------------------------------------------------------
    def sample_device(self) -> Optional[dict]:
        """The card's allocator counters and capacity, summed over the
        visible cards, into the gauges; None without a card."""
        import torch
        if not torch.cuda.is_available():
            return None
        n = torch.cuda.device_count()
        in_use = peak = reserved = limit = 0
        for d in range(n):
            stats = torch.cuda.memory_stats(d)
            in_use += int(stats.get("allocated_bytes.all.current", 0))
            peak += int(stats.get("allocated_bytes.all.peak", 0))
            reserved += int(stats.get("reserved_bytes.all.current", 0))
            limit += int(torch.cuda.mem_get_info(d)[1])
        self._g_in_use.set(in_use)
        self._g_peak.set(peak)
        self._g_limit.set(limit)
        self._g_reserved.set(reserved)
        doc = {"bytes_in_use": in_use, "peak_bytes_in_use": peak,
               "bytes_reserved": reserved, "bytes_limit": limit,
               "devices": n}
        with self._lock:
            self._last_device = doc
        return doc

    def ensure_poller(self, interval_s: Optional[float] = None) -> bool:
        """Start the device poller thread once (daemon; none when
        ``root.common.observe.memory_poll_s`` is 0 or there is no card).
        Returns whether a poller runs.  The poller is stopped and joined
        at interpreter exit: a daemon thread still inside a CUDA call
        when the interpreter finalizes is ended by ``pthread_exit``,
        whose unwinding through PyTorch's C++ frames aborts the process
        ("terminate called without an active exception")."""
        if interval_s is None:
            interval_s = float(root.common.observe.get("memory_poll_s", 2.0))
        if interval_s <= 0 or self.sample_device() is None:
            return False
        with self._lock:
            if self._poller is not None and self._poller.is_alive():
                return True
            stop = self._poll_stop
            stop.clear()

            def loop():
                while not stop.wait(interval_s):
                    try:
                        self.sample_device()
                    except Exception:  # noqa: BLE001 — the poller must
                        pass           # never take the process down

            self._poller = threading.Thread(
                target=loop, name="hbm-poll", daemon=True)
            self._poller.start()
        return True

    def stop_poller(self, timeout: float = 10.0) -> None:
        """Stop the device poller and wait for it to leave its sample."""
        self._poll_stop.set()
        with self._lock:
            poller, self._poller = self._poller, None
        if poller is not None and poller is not threading.current_thread():
            poller.join(timeout)

    # -- the /memory.json document ------------------------------------------
    def doc(self) -> dict:
        """A fresh device sample (or the last one, or null), the
        component ledger, its total and, with a card, the gaps: allocated
        bytes the ledger does not name, and reserved bytes beyond the
        allocated ones."""
        device = self.sample_device()
        with self._lock:
            if device is None:
                device = self._last_device
            components = dict(self._components)
            extras = dict(self._extras)
        total = sum(components.values())
        out = {"device": device, "components": components,
               "component_total_bytes": total}
        if device:
            out["unattributed_bytes"] = max(
                0, device["bytes_in_use"] - total)
            out["reserved_unallocated_bytes"] = max(
                0, device["bytes_reserved"] - device["bytes_in_use"])
            out["gap"] = (
                "unattributed_bytes: allocated beyond the ledger "
                "(activations and workspace, the live tensors of the "
                "CUDA-graph private pools, the staging of a hot swap); "
                "reserved_unallocated_bytes: the caching allocator's free "
                "blocks, the graphs' pools among them")
        for k, v in extras.items():
            if k not in out:    # extras never shadow the doc's own keys
                out[k] = v
        return out


_MONITOR_LOCK = threading.Lock()
_MONITOR: Optional[MemoryMonitor] = None  # guarded-by: _MONITOR_LOCK


def memory_monitor() -> MemoryMonitor:
    """The process memory monitor (what ``GET /memory.json`` renders)."""
    global _MONITOR
    with _MONITOR_LOCK:
        if _MONITOR is None:
            _MONITOR = MemoryMonitor()
            # atexit callbacks run before the interpreter ends daemon
            # threads (see MemoryMonitor.ensure_poller)
            atexit.register(_MONITOR.stop_poller)
        return _MONITOR


def drop_stamped_components(stamps: Dict[str, int],
                            extra_stamps: Optional[Dict[str, int]] = None
                            ) -> None:
    """Finalizer hook: drop the ledger entries (and extras) of one
    registration; a newer registrant's entries survive the stamp
    check."""
    mon = memory_monitor()
    for name, stamp in stamps.items():
        mon.drop_component(name, stamp)
    for name, stamp in (extra_stamps or {}).items():
        mon.drop_extra(name, stamp)
