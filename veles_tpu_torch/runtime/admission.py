"""SLO-driven admission control: the engine's overload *reflex*.

A copy of veles_tpu/runtime/admission.py (214 lines, no JAX).

The serving stack has senses — ``vt_slo_burn_rate`` over rolling
windows, queue-wait histograms, headroom-in-slots — but the only reflex
wired to them was the binary ``observe.slo.degrade_ready`` flip: /ready
goes 503 and a load balancer (hopefully) routes around the whole
replica.  That is the wrong shape for graceful degradation: the Veles
pipeline's signature was *partial* shedding — gates close, units park,
the master drops slaves — not all-or-nothing (PAPER.md).  This module
is the modern counterpart for the DecodeEngine
(docs/serving.md "Overload survival"):

* the controller owns an **admission window** — how many queued
  requests the engine currently accepts, from the full
  ``serve.queue_depth`` down to ``serve.admission.min_window``;
* every ``serve.admission.interval_s`` it reads the worst SLO **burn
  rate** (runtime/slo.py ``SloTracker.max_burn`` — windowed, sample-
  count-guarded) and applies AIMD-style control with **hysteresis**:
  burn at/over ``observe.slo.burn_threshold`` shrinks the window
  multiplicatively (``admission.decrease``); burn must stay under HALF
  the threshold for ``admission.hold_s`` before the window regrows
  (``admission.increase``), and the band in between holds steady — so
  the window neither flaps on a blip nor re-opens into a still-burning
  tail;
* the window is **priority-aware**: while it is fully open every class
  gets the hard ``queue_depth`` (a healthy engine, or one with no SLO
  target, sheds nobody); once a burn closes it, class 0 (the highest)
  keeps the hard bound — the controller never sheds it — while lower
  classes scale with the window, the lowest class down to ``window /
  priorities``: under overload the low classes shed first and
  hardest, which is exactly the contract priority classes sell;
* the shed path stays *honest*: the engine's 429 Retry-After scales by
  :meth:`AdmissionController.backoff_factor` (how far the window is
  closed), so clients back off proportionally to actual congestion.

Everything here is host-side; the clock and the burn source are
injectable, so the hysteresis behavior is pinned by fast deterministic
tests (tests/test_overload.py, tests/test_torch_admission.py).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Optional

from ..config import root


class AdmissionController:
    """AIMD admission-window controller over an SLO burn-rate signal.

    ``burn_fn`` is the sensor (typically ``SloTracker.max_burn``; None
    reads as burn 0 — the window stays fully open).  ``gauge`` is an
    optional registry gauge (``vt_admission_window``) kept in sync with
    the window.  All knob defaults come from
    ``root.common.serve.admission.*`` / ``observe.slo.burn_threshold``.
    Thread-safety: ``tick`` runs on the engine scheduler thread;
    ``allowance`` / ``backoff_factor`` / ``window`` are read from REST
    worker threads — the window is guarded by a lock, and the sensor is
    consulted outside it (it takes registry locks of its own).
    """

    def __init__(self, *, queue_depth: int, priorities: int = 1,
                 burn_fn: Optional[Callable[[], float]] = None,
                 clock=time.monotonic, gauge=None,
                 enabled: Optional[bool] = None,
                 min_window: Optional[int] = None,
                 interval_s: Optional[float] = None,
                 hold_s: Optional[float] = None,
                 decrease: Optional[float] = None,
                 increase: Optional[float] = None,
                 burn_threshold: Optional[float] = None):
        adm = root.common.serve.admission
        self.queue_depth = max(1, int(queue_depth))
        self.priorities = max(1, int(priorities))
        self.enabled = bool(adm.get("enabled", True)
                            if enabled is None else enabled)
        self.min_window = min(self.queue_depth, max(1, int(
            adm.get("min_window", 2)
            if min_window is None else min_window)))
        self.interval_s = float(adm.get("interval_s", 0.25)
                                if interval_s is None else interval_s)
        self.hold_s = float(adm.get("hold_s", 2.0)
                            if hold_s is None else hold_s)
        self.decrease = float(adm.get("decrease", 0.5)
                              if decrease is None else decrease)
        self.increase = float(adm.get("increase", 1.5)
                              if increase is None else increase)
        if not 0.0 < self.decrease < 1.0:
            raise ValueError(
                f"admission.decrease must be in (0, 1), got {self.decrease}")
        if self.increase <= 1.0:
            raise ValueError(
                f"admission.increase must be > 1, got {self.increase}")
        self.burn_threshold = float(
            root.common.observe.slo.get("burn_threshold", 2.0)
            if burn_threshold is None else burn_threshold)
        self._burn_fn = burn_fn
        self._clock = clock
        self._gauge = gauge
        self._lock = threading.Lock()
        self._window = float(self.queue_depth)  # guarded-by: self._lock
        self._last_eval = None  # guarded-by: self._lock
        self._good_since = None  # guarded-by: self._lock
        self._last_burn = 0.0  # guarded-by: self._lock
        if gauge is not None:
            gauge.set(self._window)

    # -- control loop (engine scheduler thread) ------------------------------
    def tick(self, now: Optional[float] = None) -> float:
        """One controller evaluation, internally rate-limited to
        ``interval_s`` (call as often as you like).  Returns the current
        window."""
        now = self._clock() if now is None else now
        with self._lock:
            due = self.enabled and (self._last_eval is None
                                    or now - self._last_eval
                                    >= self.interval_s)
            if due:
                self._last_eval = now
        if not due:
            return self.window()
        # the sensor takes its own (registry) locks — read it unlocked
        burn = float(self._burn_fn()) if self._burn_fn is not None else 0.0
        with self._lock:
            self._last_burn = burn
            w = self._window
            if burn >= self.burn_threshold:
                # overload: shed multiplicatively, forget any recovery
                w = max(float(self.min_window), w * self.decrease)
                self._good_since = None
            elif burn <= 0.5 * self.burn_threshold:
                # recovered — but only re-open after the recovery HELD
                # for hold_s (hysteresis: a window that re-opens into a
                # still-cooling tail just re-burns and flaps)
                if self._good_since is None:
                    self._good_since = now
                elif now - self._good_since >= self.hold_s \
                        and w < self.queue_depth:
                    w = min(float(self.queue_depth),
                            max(w * self.increase, w + 1.0))
            else:
                # the band between half-threshold and threshold: hold
                # the window and keep the recovery clock unarmed
                self._good_since = None
            self._window = w
            if self._gauge is not None:
                self._gauge.set(w)
            return w

    # -- cross-thread reads --------------------------------------------------
    def window(self) -> float:
        with self._lock:
            return self._window if self.enabled else float(self.queue_depth)

    def last_burn(self) -> float:
        with self._lock:
            return self._last_burn

    def allowance(self, priority: int = 0) -> int:
        """The TOTAL queue length (across all classes) at which an
        arrival of class ``priority`` is refused — the engine compares
        it against ``len(queue)``, not against the class's own
        occupancy, so a lower class stops being admitted as soon as the
        whole backlog reaches its (smaller) bound: the backlog that
        remains under a closed window is the work the high classes see
        ahead of them.  (An arrival refused by its bound may still
        displace a queued strictly-lower-class request — the engine's
        rule, not this controller's.)  With the window fully open —
        healthy, disabled, or no SLO target declared — EVERY class gets
        the hard ``queue_depth``: the controller is a true no-op until
        a burn actually closed the window.  Once it has, class 0 (the
        highest) keeps the hard bound — the controller never sheds it —
        while lower classes scale with the window, the lowest hardest:
        class p of P gets ``window * (P - p) / P``.  Under overload the
        low classes shed first and most, which is exactly the contract
        priority classes sell.  Always at least 1 (the hard
        ``queue_depth`` cap is applied by the caller)."""
        p = min(max(int(priority), 0), self.priorities - 1)
        w = self.window()
        if w >= self.queue_depth:
            return self.queue_depth
        if self.priorities == 1:
            # a single class: there is no higher class to protect, so
            # the window bounds everyone — admission control still
            # works with the priority feature off (anything else
            # would leave tick() closing a window nobody reads, with
            # the gauge and stats claiming sheds that never happen)
            return max(1, int(math.ceil(w)))
        if p == 0:
            return self.queue_depth
        share = (self.priorities - p) / self.priorities
        return max(1, int(math.ceil(w * share)))

    def backoff_factor(self) -> float:
        """How far the window is closed (>= 1.0) — the adaptive
        Retry-After multiplier: a half-closed window doubles the
        suggested client backoff."""
        return self.queue_depth / max(self.window(), 1.0)

    def state(self) -> dict:
        """JSON-able controller snapshot for ``stats()`` / benches."""
        w = self.window()
        return {
            "enabled": self.enabled,
            "window": round(w, 2),
            "queue_depth": self.queue_depth,
            "min_window": self.min_window,
            "shedding": w < self.queue_depth,
            "burn": round(self.last_burn(), 3),
            "burn_threshold": self.burn_threshold,
        }
