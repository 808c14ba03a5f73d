"""StepCache: each train and eval step built once per workflow lifetime,
and each serving engine's decode, prefill, megastep and verify steps
once per engine, and on the card captured once as a CUDA graph
(counterpart of veles_tpu/runtime/step_cache.py:89-299).

The JAX package compiles each step program once, ahead of time, and
never again on a Decision rollback, a ``Trainer.restore`` or a
re-``initialize`` with unchanged shapes.  On Hopper the counterpart of
"compile the step once" is "capture it once": the eager step enqueues
hundreds of small launches from Python, and a replayed CUDA graph
enqueues them all at once.  :meth:`StepCache.get_step` therefore

* on a CUDA device warms the step up on a side stream (on a copy of the
  state, which the warm-up trains), captures one step over the live
  state's tensors and a set of static input tensors into a
  ``torch.cuda.CUDAGraph``, and returns a :class:`CapturedStep`, which
  per step runs the step's host part (learning rate and fault flag into
  the staging tensor, key split, step + 1), writes the batch into the
  static inputs (one ``gather_batch`` launch for a card-resident
  loader), replays the graph and returns the graph's static metric
  tensors.  A capture that fails raises: nothing falls back to the eager
  step without saying so (the JAX package falls back to the jit after a
  failed AOT compile, :218);
* runs the eager step where it cannot capture, and says why in
  :meth:`~StepCache.stats`: on the CPU (``"cpu"``), or with
  ``StepCache(capture=False)`` (the counterpart of ``aot=False``, kept
  for the eager-versus-captured comparison);
* counts one compile (here: one capture, or one eager build) per
  program, as the JAX package's counters do: ``compiles``, ``hits`` and
  ``recompiles`` (a second program of one kind for one workflow).

Each program's cost — ``{"flops", "bytes_accessed"}`` per execution,
the counterpart of XLA's cost analysis (:260-290) — is counted once, by
a :class:`CostCounter` around one eager run of the step: the first
warm-up before a capture, or the first execution of a step that stays
eager (:class:`EagerStep`); no replay pays for it.  :meth:`StepCache.entry_cost`
and :meth:`StepCache.program_cost` read it, and ``vt_program_flops`` /
``vt_program_bytes`` publish it by program.

What keeps a capture valid: the train step writes every updated tensor
into the tensor it read (``ops.optimizers.tree_assign``), and rollback,
restore and the lr multiplier write into those same tensors; the
learning rate, the fault harness's NaN flag and each dropout unit's seed
reach the step through a device staging tensor the host fills before
each replay (``units.workflow.TrainStep``), so a captured step with
dropout draws a new mask every replay.  A state passed in that is not the
captured one is copied into it first, so a re-initialized trainer hits
the cache.  Launch counters count host calls, and a replay makes none:
the cache records each kernel counter's change during capture (by
variant), undoes it (a capture runs nothing) and adds it on every
replay.

Several captured programs may serve in one process at once (the
fleet's in-process replicas: one engine each, each replaying on its own
stream), and a new engine captures while the others replay.  Three
things keep that sound.  Each cache captures on a stream of its own,
which no other live cache captures on: PyTorch keys the cuBLAS
workspace by (handle, stream), a captured product bakes that
workspace's address into the graph, and two engines whose graphs share
one would write it at once (two replicas decoding side by side once
disagreed with their solo tokens that way); the pooled streams are
reused round robin, so a cache claims one no live cache holds.  The
capture runs in the ``"thread_local"`` capture mode, so the CUDA calls
other threads make meanwhile (their read-backs, pinned copies,
allocations on their own streams) neither fail nor break it; in the
default ``"global"`` mode any such call fails.  And the process-wide
:data:`CAPTURE_GATE` keeps replays and eager cached steps out of the
capture window: the launch counters are process-wide, and a replay's
launches counted meanwhile would be recorded as the new program's own.
A replay waits for at most one capture; a capture waits for the replays
in flight to return (their launches, not their device work).  The
cyclic collector is off inside a capture (:func:`without_gc`): a dead
engine's graphs freed by a collection on the capturing thread would
invalidate the capture.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..logger import Logger
from ..ops.kernels.build import op_cost
from ..ops.optimizers import tree_assign, tree_leaves, tree_map
from .metrics import registry

#: eager steps run on a side stream before the capture (lazy
#: initialisation — library loads, cuBLAS workspaces, autograd — must
#: not happen inside it)
WARMUP_STEPS = 2


def tree_signature(tree, path: str = "") -> Tuple:
    """Hashable (path, shape, dtype) of every leaf of a nested
    dict/tuple/list of tensors, arrays or ``Spec``s — the part of a
    step's identity its checksum does not cover."""
    if isinstance(tree, dict):
        return tuple(x for k in sorted(tree)
                     for x in tree_signature(tree[k], f"{path}/{k}"))
    if isinstance(tree, (list, tuple)):
        return tuple(x for i, v in enumerate(tree)
                     for x in tree_signature(v, f"{path}/{i}"))
    return ((path, str(tuple(getattr(tree, "shape", ()))),
             str(getattr(tree, "dtype", type(tree).__name__))),)


def _optimizer_signature(optimizer) -> Tuple:
    """Scalar hyperparameters by value + schedule IDENTITY (an opaque
    closure, as in the JAX package: a rebuilt optimizer misses)."""
    scalars = tuple(sorted(
        (k, v) for k, v in vars(optimizer).items()
        if isinstance(v, (int, float, bool, str))))
    per_unit = getattr(optimizer, "per_unit", None)
    return (type(optimizer).__name__, scalars,
            id(getattr(optimizer, "schedule", None)),
            repr(sorted(per_unit.items())) if per_unit else None)


def _clone(tree):
    return tree_map(lambda x: x.clone() if torch.is_tensor(x)
                    else np.copy(x) if isinstance(x, np.ndarray) else x,
                    tree)


def _pointers(tree):
    return [t.data_ptr() for t in tree_leaves(tree) if torch.is_tensor(t)]


class _CaptureGate:
    """Reader-writer gate: any number of replays at once (readers), or
    one capture (the writer) with none; a waiting capture goes before
    new replays, so a busy fleet cannot starve it."""

    def __init__(self):
        self._cv = threading.Condition()
        self._readers = 0           # guarded-by: self._cv
        self._writer = False        # guarded-by: self._cv
        self._waiting = 0           # guarded-by: self._cv
        self._held = threading.local()  # this thread's replay depth

    @contextlib.contextmanager
    def replay(self):
        depth = getattr(self._held, "n", 0)
        if depth:                   # nested in this thread's own replay
            self._held.n = depth + 1
            try:
                yield
            finally:
                self._held.n = depth
            return
        with self._cv:
            while self._writer or self._waiting:
                self._cv.wait()
            self._readers += 1
        self._held.n = 1
        try:
            yield
        finally:
            self._held.n = 0
            with self._cv:
                self._readers -= 1
                if not self._readers:
                    self._cv.notify_all()

    @contextlib.contextmanager
    def capture(self):
        if getattr(self._held, "n", 0):
            raise RuntimeError("a capture inside a replay of the same "
                               "thread would wait for itself")
        with self._cv:
            self._waiting += 1
            while self._writer or self._readers:
                self._cv.wait()
            self._waiting -= 1
            self._writer = True
        try:
            yield
        finally:
            with self._cv:
                self._writer = False
                self._cv.notify_all()


#: the process's one capture gate (see the module docstring)
CAPTURE_GATE = _CaptureGate()

#: the capture stream of every live StepCache: raw stream handle -> a
#: weak reference to the cache holding it
_CAPTURE_STREAMS: Dict[int, Any] = {}  # guarded-by: _STREAMS_LOCK
_STREAMS_LOCK = threading.Lock()


def _claim_capture_stream(cache, device) -> "torch.cuda.Stream":
    """A pooled stream on ``device`` that no other live cache captures
    on (see the module docstring), claimed for ``cache``."""
    import gc
    for _ in range(2):
        with _STREAMS_LOCK:
            for _ in range(64):         # twice the pool's 32 streams
                s = torch.cuda.Stream(device=device)
                holder = _CAPTURE_STREAMS.get(s.cuda_stream)
                if holder is None or holder() is None:
                    _CAPTURE_STREAMS[s.cuda_stream] = weakref.ref(cache)
                    return s
        # engines and trainers are reference cycles: dead caches may
        # still await the cycle collector
        gc.collect()
    raise RuntimeError("every pooled CUDA stream is the capture stream of "
                       "a live step cache")


@contextlib.contextmanager
def without_gc():
    """The cyclic collector off for a block.  Around a capture: engines
    and trainers are reference cycles, and a collection that frees a dead
    one's CUDA graph, stream or event on the capturing thread makes a
    call the capture forbids and invalidates it ("operation not permitted
    when stream is capturing"); the capture itself allocates enough to
    trigger one.  Around a ``torch.export`` trace, save or load: each
    collection they trigger walks the caller's whole heap (an export
    inside a long process ran 2.2x slower than alone).  The block's
    cycles are collected once it ends."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _counters():
    from ..ops.kernels import KERNELS
    return [k.launches for k in KERNELS]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class CostCounter(TorchDispatchMode):
    """The operations and bytes of what runs under it: every matrix
    product and convolution (and their backwards) by the formulas of
    ``torch.utils.flop_counter``, its bytes those of its inputs and
    outputs; other ops (elementwise, reductions, copies) count nothing.
    The port's kernel wrappers report their own module's ``cost()``
    through :meth:`add_kernel_cost` (``ops.kernels.build.reporting``) on
    either route, and the ops of a plain version inside a wrapper are
    not counted again (:meth:`quiet`), so one step counts the same on
    the CPU and on the card.  ``kernels`` holds each kernel's sums and
    calls."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self._quiet = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kernel = op_cost(func)
        if kernel is not None and not self._quiet:
            # a kernel's custom op outside its wrapper (a sealed program)
            self.add_kernel_cost(kernel[0], kernel[1](*args, **kwargs))
        out = func(*args, **kwargs)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None and not self._quiet:
            self.flops += float(formula(*args, **kwargs, out_val=out))
            self.bytes += float(_nbytes((args, kwargs, out)))
        return out

    @contextlib.contextmanager
    def quiet(self):
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def add_kernel_cost(self, name: str, cost: Dict[str, float]) -> None:
        self.flops += cost["flops"]
        self.bytes += cost["bytes"]
        k = self.kernels.setdefault(name, {"flops": 0.0, "bytes": 0.0,
                                           "calls": 0})
        k["flops"] += cost["flops"]
        k["bytes"] += cost["bytes"]
        k["calls"] += 1

    def result(self) -> Dict[str, Any]:
        return {"flops": self.flops, "bytes_accessed": self.bytes,
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}


_NO_COST = {"flops": 0.0, "bytes_accessed": 0.0, "kernels": {}}


class EagerStep:
    """A step that runs eagerly, called as the step is; its first
    execution runs under a :class:`CostCounter` and records the entry's
    cost (until then the cache reports zeros for it)."""

    captured = False

    def __init__(self, step, cache, full_key):
        self.step, self._cache, self._key = step, cache, full_key

    def __call__(self, *args):
        ent = self._cache._entries.get(self._key)
        if ent is None or ent["cost"] is not None:
            with CAPTURE_GATE.replay():
                return self.step(*args)
        with CAPTURE_GATE.replay(), CostCounter() as cc:
            out = self.step(*args)
        ent["cost"] = cc.result()
        self._cache._publish_cost(self._key[0])
        return out


class CapturedStep:
    """A step captured as a CUDA graph over ``state``'s tensors and the
    static ``inputs``; called as the eager step is: ``(wstate, batch) ->
    (wstate, metrics)`` for train, ``-> outputs`` for the other kinds
    (eval; the engine's serving steps, whose state is the KV caches and
    the slot state).  The returned state is the captured one and the
    outputs are the graph's static output tensors: read them before the
    next call.
    A ``None`` batch replays on what the static inputs hold (the prefill
    step advances its own position index on the card)."""

    captured = True

    def __init__(self, step, graph, state, inputs, outputs, launches):
        self.step, self.graph = step, graph
        self.state, self.inputs, self.outputs = state, inputs, outputs
        self.launches = launches  # [(counter, (n, {variant: n}))]

    def __call__(self, wstate, batch):
        if wstate is not self.state:
            tree_assign(self.state, wstate)
        self.step.begin(self.state)
        if batch is not None:           # None: replay on what they hold
            self.load(batch)
        with CAPTURE_GATE.replay():
            self.graph.replay()
            for counter, (n, variants) in self.launches:
                counter.add(n, variants)
        if self.step.kind == "train":
            return self.state, self.outputs
        return self.outputs

    def load(self, batch) -> None:
        """The batch into the static inputs, on this thread's stream,
        right before the replay that reads them: a card-resident batch
        in one gather launch, tensors (pinned host or device) by
        non-blocking copies."""
        if hasattr(batch, "gather"):
            batch.gather(self.inputs)
            return
        for k, v in batch.items():
            self.inputs[k].copy_(torch.as_tensor(v), non_blocking=True)


class StepCache(Logger):
    """Process-level cache of built (and on the card, captured) steps.

    ``get_step(kind, key, builder, args)`` returns the cached step for
    ``(kind, key)`` or calls ``builder()`` once for a
    ``units.workflow.TrainStep``/``EvalStep`` and captures it against
    ``args = (wstate, inputs)``: the live state and the static input
    tensors (any valid batch, e.g. zeros, of the steps' shapes)."""

    def __init__(self, *, capture: bool = True):
        self.capture = capture
        self._capture_stream = None     # claimed at the first capture
        self._entries: Dict[Any, dict] = {}
        self.compiles = 0
        self.hits = 0
        self.recompiles = 0
        self.compile_wall_s = 0.0
        reg = registry()
        self._m_compiles = reg.counter(
            "vt_compile_total",
            "step programs built (on the card: captured) by kind (train / "
            "eval) across every StepCache in the process",
            labels=("program",))
        self._m_hits = reg.counter(
            "vt_compile_hits_total",
            "step programs served from cache", labels=("program",))
        self._m_recompiles = reg.counter(
            "vt_recompile_total",
            "step programs built again for a workflow that already had "
            "one of that kind", labels=("program",))
        self._g_flops = reg.gauge(
            "vt_program_flops",
            "counted flops of one execution of the step programs of a "
            "kind (matrix products, convolutions and the kernels' own "
            "counts)", labels=("program",))
        self._g_bytes = reg.gauge(
            "vt_program_bytes",
            "counted bytes of one execution of the step programs of a "
            "kind", labels=("program",))

    # -- keys ---------------------------------------------------------------
    def trainer_key(self, workflow, optimizer, wstate, batch_spec,
                    device) -> Tuple:
        """Cache key of a Trainer's steps: the workflow INSTANCE (pinned
        by the entry, so ``id`` stays unique), its checksum, the state and
        batch signatures, the optimizer and the device."""
        return (id(workflow), workflow.checksum(), tree_signature(wstate),
                tree_signature(batch_spec), _optimizer_signature(optimizer),
                str(torch.device(device)))

    # -- the cache ----------------------------------------------------------
    def get_step(self, kind: str, key: Tuple, builder: Callable[[], Any],
                 args: Tuple, *, pin: Tuple = ()):
        """Fetch or build (and on the card capture) the ``kind`` step."""
        full_key = (kind,) + tuple(key)
        ent = self._entries.get(full_key)
        if ent is not None:
            self.hits += 1
            self._m_hits.labels(program=kind).inc()
            return ent["fn"]
        t0 = time.perf_counter()
        step = builder()
        wstate, inputs = args
        on_card = any(t.is_cuda for t in tree_leaves(args)
                      if torch.is_tensor(t))
        if not on_card:
            reason = "cpu"
        elif not self.capture:
            reason = "capture=False"
        elif getattr(step, "capture_reason", None):
            reason = step.capture_reason
        else:
            reason = None
        if reason:
            fn, cost = EagerStep(step, self, full_key), None
        else:
            fn, cost = self._capture(step, wstate, inputs)
        wall = time.perf_counter() - t0
        if any(k[0] == kind and k[1:2] == full_key[1:2]
               for k in self._entries):
            self.recompiles += 1
            self._m_recompiles.labels(program=kind).inc()
        self.compiles += 1
        self.compile_wall_s += wall
        self._m_compiles.labels(program=kind).inc()
        self._entries[full_key] = {"fn": fn, "captured": reason is None,
                                   "reason": reason, "wall_s": wall,
                                   "cost": cost, "pin": pin}
        if reason is None:
            self._publish_cost(kind)
            self.info("captured the %s step in %.2fs (%.3g GFLOP, %.3g MB "
                      "a step)", kind, wall, cost["flops"] / 1e9,
                      cost["bytes_accessed"] / 1e6)
        elif on_card:
            self.warning("the %s step runs eagerly on the card: %s", kind,
                         reason)
        return fn

    def _publish_cost(self, kind: str) -> None:
        kc = self.program_cost(kind)
        self._g_flops.labels(program=kind).set(kc["flops"])
        self._g_bytes.labels(program=kind).set(kc["bytes_accessed"])

    def entry_cost(self, kind: str, key: Tuple) -> Dict[str, Any]:
        """The counted cost of ONE cached program, the entry the caller
        executes: ``{"flops", "bytes_accessed", "kernels"}`` per
        execution (zeros until counted: an eager step counts at its first
        execution).  Use it, not :meth:`program_cost`,
        where superseded programs of a kind stay cached (a rebuilt
        optimizer's old train entry), which the kind's sum would count
        twice."""
        ent = self._entries.get((kind,) + tuple(key))
        return dict(_NO_COST) if ent is None or ent["cost"] is None \
            else ent["cost"]

    def program_cost(self, kind: str) -> Dict[str, Any]:
        """Summed counted cost of this cache's ``kind`` programs per
        execution, every kernel's sums and calls merged; correct where
        every entry of the kind is live (an engine's one program of each
        kind)."""
        out = {"flops": 0.0, "bytes_accessed": 0.0, "kernels": {}}
        for full_key, ent in self._entries.items():
            if full_key[0] != kind or ent["cost"] is None:
                continue
            out["flops"] += ent["cost"]["flops"]
            out["bytes_accessed"] += ent["cost"]["bytes_accessed"]
            for name, k in ent["cost"]["kernels"].items():
                acc = out["kernels"].setdefault(
                    name, {"flops": 0.0, "bytes": 0.0, "calls": 0})
                for f in acc:
                    acc[f] += k[f]
        return out

    def _capture(self, step, wstate, inputs) -> Tuple[CapturedStep, dict]:
        dev = next(t.device for t in tree_leaves((wstate, inputs))
                   if torch.is_tensor(t))
        main = torch.cuda.current_stream(dev)
        if self._capture_stream is None:
            self._capture_stream = _claim_capture_stream(self, dev)
        side = self._capture_stream
        side.wait_stream(main)
        with torch.cuda.stream(side):
            scratch = _clone(wstate)
            ptrs = _pointers(scratch)
            # the first warm-up counts the program's cost
            with CostCounter() as cc:
                step.run(scratch, inputs, step.begin(scratch))
            for _ in range(WARMUP_STEPS - 1):
                step.run(scratch, inputs, step.begin(scratch))
            if _pointers(scratch) != ptrs:
                raise RuntimeError(
                    f"the {step.kind} step rebinds state tensors; a "
                    "captured step must write each one in place")
        main.wait_stream(side)
        del scratch
        counters = _counters()
        graph = torch.cuda.CUDAGraph()
        with CAPTURE_GATE.capture(), without_gc():
            before = [c.state() for c in counters]
            # no cycle collection runs inside the capture (without_gc)
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                # the host part stays out of the graph; nothing the
                # device part reads comes from it but the staging tensor
                outputs = step.run(wstate, inputs, None)
            launches = []
            for c, (n0, v0) in zip(counters, before):
                n1, v1 = c.state()
                if n1 != n0:
                    launches.append((c, (n1 - n0, {
                        v: k - v0.get(v, 0) for v, k in v1.items()
                        if k != v0.get(v, 0)})))
                c.set_state((n0, v0))
        return (CapturedStep(step, graph, wstate, inputs, outputs,
                             launches), cc.result())

    def stats(self) -> Dict[str, Any]:
        """JSON-able summary: the counters (``captures``: the programs
        captured as CUDA graphs), and for the newest program of each kind
        whether it was captured and, if not, why."""
        out: Dict[str, Any] = {
            "programs": len(self._entries), "compiles": self.compiles,
            "captures": sum(e["captured"] for e in self._entries.values()),
            "hits": self.hits, "recompiles": self.recompiles,
            "compile_wall_s": round(self.compile_wall_s, 3)}
        for full_key, ent in self._entries.items():
            out[full_key[0]] = {"captured": ent["captured"],
                                "reason": ent["reason"]}
        return out
