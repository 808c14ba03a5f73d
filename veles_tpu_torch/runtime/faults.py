"""Deterministic, config-driven fault injection for the training and
serving lifecycle (a copy of veles_tpu/runtime/faults.py, which holds no
JAX, cut to the knobs whose injection points the port has).

Production code consults this switchboard at well-defined injection
points; tests arm it through ``root.common.faults.*`` (or the
:func:`configure` convenience) and get bit-deterministic failures.

Knobs (all off by default; ``root.common.faults`` stays an empty config
node in production, so the :func:`enabled` fast path is one falsy check):

``nan_grad_at_step``
    int or list of ints.  Poison every gradient leaf with NaN at these
    global step numbers.  The train step reads the plan once, when it is
    built (``Workflow.make_train_step``): an armed plan adds a select on
    a per-step flag that the host sets from the step number, in the same
    staging buffer as the learning rate, so the injection adds ZERO
    recaptures — the property the anomaly sentinel's own tests assert.
    Arm it BEFORE the step is built (``Trainer.initialize``); arming
    later hits the already-cached step.
``loader_ioerror_at_batch``
    int or list of ints.  The FIRST fetch attempt of these batch
    indices raises ``OSError`` (once per index per process), so the
    loader's bounded retry recovers.
``truncate_snapshot``
    truthy.  Every ``Snapshotter.save`` truncates its tensors blob to
    half size AFTER the atomic symlink flip — a torn write discovered
    only at restore time (exercises checksum verify + walk-back).
``slow_batch_ms``
    float.  Sleep this many milliseconds inside every batch fetch.
``scheduler_crash``
    truthy.  The decode-engine scheduler loop raises
    :class:`FaultInjected` (once) at its next iteration with pending
    work: every queued and in-flight request fails with
    ``SchedulerCrashed`` (HTTP 500) and a ``scheduler_crash`` status
    event records the cause.
``decode_stall_ms``
    float.  The next decode step sleeps this long before dispatching
    (once per arming), inside the step's timed window, so it lands in
    the decode-step histogram and the wall EWMAs as a real stall would.
``admission_burst``
    int.  The scheduler appends this many synthetic minimal
    lowest-class requests straight to its own queue (once per arming),
    bypassing ``submit``'s shed gate: the backlog already exists.
``kv_transfer_drop``
    int.  The drain's KV-page handoff to a successor (``runtime/
    deploy.py``) fails as a transport error before any bytes move
    (once per arming); the drain goes on.
``kv_transfer_slow_ms``
    float.  The drain's KV-page handoff sleeps this many milliseconds
    first (a slow link).
``replica_crash_at_request``
    int.  The fleet router (``runtime/fleet.py``) kills the replica it
    chose for its Nth routed request (once per arming; only replicas it
    holds a kill handle for: in-process ones).  The dispatch then fails
    over: ejection and resubmission of the request to a survivor.
``replica_slow_ms``
    float.  Every router dispatch to the lowest-id active replica is
    held back this many milliseconds (a persistently slow replica as the
    router sees it); fires per request while armed.
``stream_cut_at_token``
    int.  The router's streaming relay severs the replica leg, as a
    transport failure, after relaying this many token frames (once per
    arming); the relay resumes the suffix on a survivor from the frames
    already delivered.
``stream_stall_ms``
    float.  The streaming relay sleeps this many milliseconds a relayed
    frame (a slow consumer as the replica sees it).

The router's KV-page transfers (remote fetch, the prefill role's leg,
the rolling drain's pre-warm) consult ``kv_transfer_drop`` (the first N
transfers fail; a budget the router keeps) and ``kv_transfer_slow_ms``
too.  The experiment manager's knob comes with the slice that has its
injection point.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

from ..config import root


class FaultInjected(RuntimeError):
    """Raised at a crash point armed via ``root.common.faults``."""


#: one-shot firing memory: (kind, index) pairs that already fired.
#: ``_lock`` also serializes arm/disarm (configure/reset) against the
#: threads consulting the plan mid-run.
_fired: set = set()  # guarded-by: _lock
_lock = threading.Lock()


def _as_steps(v) -> Tuple[int, ...]:
    """Normalize an int / float / iterable knob to a sorted int tuple."""
    if v is None or v is False or v == "":
        return ()
    if isinstance(v, bool):  # True alone names no step
        return ()
    if isinstance(v, (int, float)):
        return (int(v),)
    return tuple(sorted(int(x) for x in v))


class FaultPlan:
    """Immutable snapshot of the armed injection points."""

    __slots__ = ("nan_grad_at_step", "loader_ioerror_at_batch",
                 "truncate_snapshot", "slow_batch_ms", "scheduler_crash",
                 "decode_stall_ms", "admission_burst", "kv_transfer_drop",
                 "kv_transfer_slow_ms", "replica_crash_at_request",
                 "replica_slow_ms", "stream_cut_at_token",
                 "stream_stall_ms")

    def __init__(self, cfg):
        get = cfg.get
        self.nan_grad_at_step = _as_steps(get("nan_grad_at_step"))
        self.loader_ioerror_at_batch = _as_steps(
            get("loader_ioerror_at_batch"))
        self.truncate_snapshot = bool(get("truncate_snapshot", False))
        self.slow_batch_ms = float(get("slow_batch_ms", 0.0) or 0.0)
        self.scheduler_crash = bool(get("scheduler_crash", False))
        self.decode_stall_ms = float(get("decode_stall_ms", 0.0) or 0.0)
        self.admission_burst = int(get("admission_burst", 0) or 0)
        self.kv_transfer_drop = int(get("kv_transfer_drop", 0) or 0)
        self.kv_transfer_slow_ms = float(
            get("kv_transfer_slow_ms", 0.0) or 0.0)
        self.replica_crash_at_request = int(
            get("replica_crash_at_request", 0) or 0)
        self.replica_slow_ms = float(get("replica_slow_ms", 0.0) or 0.0)
        self.stream_cut_at_token = int(get("stream_cut_at_token", 0) or 0)
        self.stream_stall_ms = float(get("stream_stall_ms", 0.0) or 0.0)

    def __bool__(self) -> bool:
        return any(getattr(self, k) for k in self.__slots__)

    def __repr__(self) -> str:
        armed = {k: getattr(self, k) for k in self.__slots__
                 if getattr(self, k)}
        return f"FaultPlan({armed})"


def enabled() -> bool:
    """Cheap is-anything-armed check for hot loops: an empty (or never
    touched) ``root.common.faults`` node is falsy."""
    return bool(root.common.faults)


def get_plan() -> FaultPlan:
    """Build the current plan from ``root.common.faults``.  Cheap enough
    to call per batch; the train step reads it once, when it is built."""
    return FaultPlan(root.common.faults)


def fire_once(kind: str, index: Optional[int] = None) -> bool:
    """True exactly once per (kind, index) for the process lifetime
    (until :func:`reset`) — injected transients must be recoverable by a
    bounded retry."""
    key = (kind, index)
    with _lock:
        if key in _fired:
            return False
        _fired.add(key)
        return True


def _disarm_locked() -> None:  # requires-lock: _lock
    _fired.clear()
    node = root.common.faults
    for k in list(node.keys()):
        delattr(node, k)


def configure(**knobs) -> FaultPlan:
    """Arm injection points programmatically (test convenience): clears
    any previous plan AND the one-shot firing memory, then writes each
    knob into ``root.common.faults``, all under the firing lock."""
    with _lock:
        _disarm_locked()
        for k, v in knobs.items():
            setattr(root.common.faults, k, v)
    return get_plan()


def reset() -> None:
    """Disarm everything and forget what already fired (atomic with
    respect to :func:`fire_once`)."""
    with _lock:
        _disarm_locked()
