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
  :meth:`~StepCache.stats`: on the CPU (``"cpu"``), with
  ``StepCache(capture=False)`` (the counterpart of ``aot=False``, kept
  for the eager-versus-captured comparison), or where a unit's train
  forward takes a per-step host value (``Unit.capture_blocker``; the
  dropout seed);
* counts one compile (here: one capture, or one eager build) per
  program, as the JAX package's counters do: ``compiles``, ``hits`` and
  ``recompiles`` (a second program of one kind for one workflow).

What keeps a capture valid: the train step writes every updated tensor
into the tensor it read (``ops.optimizers.tree_assign``), and rollback,
restore and the lr multiplier write into those same tensors; the
learning rate and the fault harness's NaN flag reach the step through a
device staging tensor the host fills before each replay
(``units.workflow.TrainStep``).  A state passed in that is not the
captured one is copied into it first, so a re-initialized trainer hits
the cache.  Launch counters count host calls, and a replay makes none:
the cache records each kernel counter's change during capture (by
variant), undoes it (a capture runs nothing) and adds it on every
replay.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..logger import Logger
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


def capture_blocker(workflow, kind: str) -> Optional[str]:
    """Why ``kind``'s step of ``workflow`` cannot be captured, or None:
    the first unit that names a per-step host value its train forward
    takes (an eval forward takes none)."""
    if kind != "train" or workflow is None:
        return None
    for unit in workflow.topo_order():
        if unit.capture_blocker:
            return unit.capture_blocker
    return None


def _clone(tree):
    return tree_map(lambda x: x.clone() if torch.is_tensor(x)
                    else np.copy(x) if isinstance(x, np.ndarray) else x,
                    tree)


def _pointers(tree):
    return [t.data_ptr() for t in tree_leaves(tree) if torch.is_tensor(t)]


def _counters():
    from ..ops.kernels import KERNELS
    return [k.launches for k in KERNELS]


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
                 args: Tuple, *, pin: Tuple = (), workflow=None):
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
        else:
            reason = capture_blocker(workflow, kind)
        fn = step if reason else self._capture(step, wstate, inputs)
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
                                   "pin": pin}
        if reason is None:
            self.info("captured the %s step in %.2fs", kind, wall)
        elif on_card:
            self.warning("the %s step runs eagerly on the card: %s", kind,
                         reason)
        return fn

    def _capture(self, step, wstate, inputs) -> CapturedStep:
        dev = next(t.device for t in tree_leaves((wstate, inputs))
                   if torch.is_tensor(t))
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            scratch = _clone(wstate)
            ptrs = _pointers(scratch)
            for _ in range(WARMUP_STEPS):
                step.run(scratch, inputs, step.begin(scratch))
            if _pointers(scratch) != ptrs:
                raise RuntimeError(
                    f"the {step.kind} step rebinds state tensors; a "
                    "captured step must write each one in place")
        main.wait_stream(side)
        del scratch
        counters = _counters()
        before = [c.state() for c in counters]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            # the host part stays out of the graph; nothing the device
            # part reads comes from it but the staging tensor
            outputs = step.run(wstate, inputs, None)
        launches = []
        for c, (n0, v0) in zip(counters, before):
            n1, v1 = c.state()
            if n1 != n0:
                launches.append((c, (n1 - n0, {
                    v: k - v0.get(v, 0) for v, k in v1.items()
                    if k != v0.get(v, 0)})))
            c.set_state((n0, v0))
        return CapturedStep(step, graph, wstate, inputs, outputs, launches)

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
