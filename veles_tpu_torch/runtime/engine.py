"""Continuous-batching decode engine (a subset of
veles_tpu/runtime/engine.py).

The engine owns a fixed slot batch of KV caches for its lifetime — dense
``(slots, l_max)`` rows, or (the default) a pool of fixed-size pages that
every slot maps through its own page table, with one scratch row that
absorbs the writes of inactive slots.  A scheduler thread owns the
request queue and every device call:

* **priority classes** (engine.py:952-1022, :2009-2252): requests carry
  a class, 0 (highest) to ``priorities - 1``; the queue pops the highest
  class first, FIFO within a class; a hard-full queue lets an arrival
  displace the youngest not-yet-started request of a strictly lower
  class, and the SLO-driven :class:`~.admission.AdmissionController`
  closes the queue window for the low classes first under a burn.  A
  shed answers :class:`EngineOverloaded` with an adaptive Retry-After
  (HTTP 429, :2536-2577);
* **preemption** (:2698-2844): an arrival that finds no free slot, or a
  pool too small for it, preempts the running slot of the lowest class
  strictly below its own (youngest run first), unless even every such
  slot's pages could not host it.  The victim's generated tokens are
  harvested and it is requeued at the front of its class; its resume
  re-prefills prompt + generated so far, so its stream is the
  uninterrupted one;
* **paged pool with a prefix cache** (:2862-3025): refcounted pages, a
  free list and a chained sha256 index over full prompt pages
  (:func:`prefix_page_hashes`).  A request maps the full prompt pages it
  shares read-only and prefills from its first divergent page on into
  private pages — copy-on-write where no page is ever copied, since
  shared pages are only read.  Refcount-0 cached pages stay resident
  until the least recently used one is evicted for a new page; a request
  the pool cannot host while slots are free is refused with 429, its
  cached prefix discounted;
* **prefill from an offset, chunked** (:465-657, :3364-3548): the
  prefill continues at global positions ``start .. start + n - 1`` (the
  prefix-hit boundary, or a chunk boundary) and samples the first token
  at fold position ``P - 1``; prompts longer than ``prefill_chunk`` are
  cut into slices interleaved with decode steps, bitwise an unchunked
  prefill.  It reads the paged cache through the gather path, as the
  JAX package's prefill does (no ``paged_kernel``, :622-624);
* one **decode step** advances every slot, with per-slot greedy /
  temperature / top-k / top-p sampling and eos / length retirement
  inside the step (``make_decode_fn``'s ``step_tail``, :211-243); with
  ``paged_kernel`` the paged read goes through the paged-decode CUDA
  kernel;
* **megastep** (:335-410, :3582-3595, :3893-3935): with
  ``serve.megastep = N > 1`` and every slot busy, nothing queued and no
  prompt mid-chunk, one dispatch runs N micro-steps of the same step
  body, a slot retiring at micro-step i writing only to the scratch page
  from then on;
* **speculative verify** (:246-332, :419-462, :3549-3686, :3845-3891):
  with ``serve.spec.enabled`` an n-gram drafter (:func:`ngram_draft`)
  proposes up to ``spec.k`` tokens per slot from the host's token
  history, and one dispatch runs K + 1 micro-steps that accept the
  longest draft prefix equal to what the sampler picks, plus the bonus
  token, under the JAX package's measured-payoff policy;
* **KV-page transfer** (VTKV1, :140, :3028-3362): full prompt pages
  exported by their chained prefix hashes and imported into another
  engine's pool on the scheduler thread at a step boundary, written into
  the pool tensors in place;
* **streaming** (:767-863, :1667-1712, :3689-3764): a request may open
  a frame feed numbered by global generated-token index, with stop
  sequences matched at flush time (a match may span a flush boundary or
  fall on the prefill's first token), finish reasons ``length`` /
  ``eos`` / ``stop`` / ``deadline`` / ``error``, and the resume form
  ``emitted_prefix`` that continues an interrupted stream bitwise;
* deadlines fail a request loudly (queued, mid-prefill or decoding).

The per-slot state lives on the device as static tensors the steps read
and write: one int32 buffer (position, active flag, temperature, top-k,
top-p, eos, end and the page table of every slot), the (S, l_max) token
matrix and the (S, l_max) table of each slot's ``fold_seed(seed,
position)``, filled on the host when the slot is admitted (folding in
the graph took ~0.45 ms of small kernels a micro-step on an H100).  The
host keeps a mirror of all three; it loads the mirror onto the device
(non-blocking copies from pinned memory) before a dispatch when
admission, retirement, preemption or a deadline changed it, and reads
back positions, active flags, finished flags, counts and the fresh
tokens in one copy after every dispatch.  Stream flushes, stop
matching, the drafter and retirement read the mirror after that copy.

**Hot swap and drain** (engine.py:1879-2010): :meth:`DecodeEngine.
swap_params` replaces the served weights with a tree of the same
signature.  The captured steps read fixed addresses, so the swap checks
the signature first (a mismatch raises ValueError, the old weights still
serving), stages the new tree on the device (from pinned host memory:
the one extra device copy a swap makes) while the old one serves, and
at a dispatch boundary the scheduler thread copies the staged tensors
into the served ones in place, on its own stream, after the last replay of the old version and before the
next: captures stay flat.  The prefix index and imported pages are
dropped and the weights version bumps, so a VTKV1 blob from before the
swap is refused; in-flight slots finish on KV of mixed versions, the
reference's documented trade.  :meth:`DecodeEngine.drain` refuses new
work (:class:`EngineDraining`, HTTP 503), lets queued and in-flight
requests retire and stops the scheduler.  Every finished request leaves
a span (queue wait, prefill, decode) in the process span ring
(``GET /trace.json``), recorded on the host where its outcome counts;
the engine's buffers are in the memory ledger (``GET /memory.json``);
the serving fault knobs (scheduler crash, decode stall, admission burst)
have their injection points here.

On the card the paged layout's steps are captured as CUDA graphs
through :class:`~.step_cache.StepCache` when the engine is built — the
counterpart of the JAX package's "compiled once, flat after warmup":
decode, prefill, and verify and megastep where enabled.  Each token
step is built twice, sampling and greedy-only: the host replays the
greedy-only program when no live slot samples, so an all-greedy batch
pays no noise or filter (the JAX package skips them with ``lax.cond``).
Prefill reads ``[effective prompt | page-table row | position index]``
from one static int32 buffer filled from pinned memory; its one
position step reads its token and position on the card at the index
the graph advances itself, and is replayed once per prompt position.  The dense layout stays eager
(its masked write has a data-dependent shape) with the same step body,
and ``stats()["capture"]`` says so, as it says ``"cpu"`` on the host.

Goodput (engine.py:1383-1390, :2330-2371): a token dispatch records
its program, its starting positions and its wall; the gauges' read
(every 0.25 s on the scheduler tick, and ``stats()``) prices the
dispatches since the last read at their programs' counted bytes
(``StepCache.program_cost``, counted once: before the capture, or at
an eager program's first execution), the paged kernel's part
re-evaluated at the recorded positions (:meth:`DecodeEngine.
_dispatch_bytes`: the kernel reads the K/V of every live position, so
its bytes grow with the context), over their summed wall:
``vt_decode_bandwidth_bytes_per_sec`` (the latest read's; 0 after 2 s
without a token step), ``vt_decode_mbu`` against
``root.common.observe.peak_hbm_gbps``, ``vt_tokens_per_sec_per_chip``
and ``vt_memory_headroom_slots``, published on the scheduler tick and in
``stats()["goodput"]`` / ``stats()["headroom_slots"]``.  The dense
layout builds no program through the cache and reports 0 bytes.

**The batch lane** (engine.py:2044-2140, :2373-2400, :2771-2801): a
request submitted with ``batch=True`` rides the trough-filler class, one
internal class below every interactive priority (queue index
``priorities``).  It enters only while the trough is open (at least
``serve.jobs.min_headroom_slots`` admissible slots and a windowed SLO
burn at most ``serve.jobs.burn_ceiling``; else 429 with the short
``serve.jobs.trough_retry_s`` hint), bypasses the admission window (the
gate is its admission control, the hard queue depth still binds), is
held in the queue while the gate is closed at admission, is the first
victim of a preemption, and never reaches the queue-wait or TTFT
histograms.  It rides the same captured programs as any request.
``stats()["batch"]`` reports the gate, the batch tokens and their rate,
and the batch preemptions.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import hashlib
import json
import threading
import time
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import root
from ..logger import Logger
from ..ops import resolve_device
from ..ops.kernels import paged_attention as _paged
from ..ops.optimizers import tree_map
from ..units.base import Context
from ..units.nn import input_vocab
from . import faults
from .admission import AdmissionController
from .generate import (DecodePlan, fold_keys, fold_seed_array,
                       gumbel_noise, row_seeds, sample_slots,
                       sampling_tensors)
from .memory import drop_stamped_components, memory_monitor, tree_bytes
from .metrics import next_trace_id, registry, span_ring
from .slo import slo_tracker
from .step_cache import StepCache, tree_signature

# KV-page transfer wire magic (engine.py:140): the version byte in the
# tag makes a format bump reject loudly instead of misparsing
_KV_MAGIC = b"VTKV1\x00"

#: parked / cold speculative-drafting probe interval in scheduler ticks
#: (engine.py:419): a workload the drafter cannot pay for decays to plain
#: decode plus one drafting attempt, and one measuring verify step, every
#: this many ticks
_SPEC_PROBE_TICKS = 64


_LIVE_LOCK = threading.Lock()
#: engines whose scheduler thread was started and not yet stopped; an
#: engine leaves the set when it is collected
_LIVE_ENGINES: "weakref.WeakSet[DecodeEngine]" = weakref.WeakSet()
_EXIT_HOOK = False  # guarded-by: _LIVE_LOCK
#: how long the exit hook waits for all engines' threads together: a
#: decode step or capture ends well inside it
_EXIT_JOIN_S = 10.0


def _stop_live_engines() -> None:
    """Stop and join every live engine's scheduler thread.  Registered
    with ``atexit``, which runs before the interpreter ends daemon
    threads: a ``decode-engine`` thread still inside a CUDA call (GIL
    released) at finalization would be ended by ``pthread_exit``, whose
    forced unwind through PyTorch's noexcept frames aborts the process
    (``std::terminate``), as ``runtime/memory.py``'s poller once did."""
    with _LIVE_LOCK:
        engines = list(_LIVE_ENGINES)
    me = threading.current_thread()
    # a caller driving the loop itself is not waited for
    engines = [eng for eng in engines if eng._thread is not me]
    for eng in engines:             # signal all, then join within one wait
        eng._signal_stop()
    deadline = time.monotonic() + _EXIT_JOIN_S
    for eng in engines:
        eng.stop(timeout=max(0.0, deadline - time.monotonic()))


def _register_live(engine) -> None:
    global _EXIT_HOOK
    with _LIVE_LOCK:
        _LIVE_ENGINES.add(engine)
        if not _EXIT_HOOK:
            atexit.register(_stop_live_engines)
            _EXIT_HOOK = True


class EngineOverloaded(RuntimeError):
    """The queue, the admission window or the page pool is full, or the
    batch trough is closed; retry after ``retry_after_s`` seconds (HTTP
    429 + Retry-After in restful.py).  An interactive shed's hint comes
    from :meth:`DecodeEngine._retry_after` (at least 1 s); a closed
    trough's is sub-second, since the trough reopens as soon as a slot
    frees."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = max(0.0, float(retry_after_s))


class EngineStopped(RuntimeError):
    """The engine is not running (never started, or stopped)."""


class EngineDraining(EngineStopped):
    """The engine is draining: in-flight work retires, new work is
    refused (the REST layer's 503 on ``/ready`` and ``/generate``)."""


class SchedulerCrashed(RuntimeError):
    """The scheduler loop died; every pending request failed with this."""


def signature_mismatch(expected, got, limit: int = 6) -> str:
    """Readable diff of two :func:`~.step_cache.tree_signature` results:
    which leaves are missing, unexpected or of another shape or dtype."""
    exp = {p: (s, d) for p, s, d in expected}
    new = {p: (s, d) for p, s, d in got}

    def fmt(sd):  # dtype may be blank (shape-only signatures)
        return f"{sd[0]}/{sd[1]}" if sd[1] else f"{sd[0]}"

    msgs = []
    for p in sorted(set(exp) - set(new)):
        msgs.append(f"{p}: missing (expected {fmt(exp[p])})")
    for p in sorted(set(new) - set(exp)):
        msgs.append(f"{p}: unexpected leaf {fmt(new[p])}")
    for p in sorted(set(exp) & set(new)):
        if exp[p] != new[p]:
            msgs.append(f"{p}: {fmt(new[p])} != expected {fmt(exp[p])}")
    extra = len(msgs) - limit
    if extra > 0:
        msgs = msgs[:limit] + [f"... and {extra} more"]
    return "; ".join(msgs) or "identical signatures"


def prefix_page_hashes(prompt, page_size: int) -> list:
    """Chained sha256 digests of a prompt's FULL ``page_size``-token
    pages: page ``i``'s key covers tokens ``0 .. (i+1)*page_size`` (KV
    content depends on the whole prefix).  Hashes are over the int32
    byte view, as the JAX package's (engine.py:116)."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    psz = int(page_size)
    hashes, h = [], b""
    for i in range(int(prompt.size) // psz):
        h = hashlib.sha256(
            h + prompt[i * psz:(i + 1) * psz].tobytes()).digest()
        hashes.append(h)
    return hashes


class ServeGeometry(NamedTuple):
    slots: int
    l_max: int
    paged: bool
    page_size: int
    pages: int
    paged_kernel: bool = False
    megastep: int = 1

    @property
    def n_ptab(self) -> int:
        return self.l_max // self.page_size if self.paged else 0


def resolve_serve_geometry(slots=None, l_max=None, paged=None, page_size=None, pages=None,
                           paged_kernel=None, megastep=None) -> ServeGeometry:
    """Slot-batch geometry with ``root.common.serve`` defaults — the JAX
    package's resolution (engine.py:683-746) without prefill buckets."""
    serve = root.common.serve
    slots = int(slots if slots is not None else serve.get("slots", 8))
    l_max = int(l_max if l_max is not None else serve.get("l_max", 512))
    if slots < 1 or l_max < 2:
        raise ValueError("need slots >= 1 and l_max >= 2")
    use_paged = bool(serve.get("paged", True) if paged is None else paged)
    psz = int(page_size if page_size is not None
              else serve.get("page_size", 16))
    use_kernel = bool(serve.get("paged_kernel", False)
                      if paged_kernel is None else paged_kernel)
    mega = int(serve.get("megastep", 1) if megastep is None else megastep)
    if mega < 1:
        raise ValueError(f"serve.megastep must be >= 1, got {mega}")
    if not use_paged:
        if paged_kernel:
            raise ValueError(
                "paged_kernel requires the paged KV layout "
                "(root.common.serve.paged / paged=True)")
        return ServeGeometry(slots, l_max, False, psz, 0, False, mega)
    if psz < 1:
        raise ValueError(f"page_size must be >= 1, got {psz}")
    if l_max % psz:
        if page_size is not None:
            raise ValueError(
                f"page_size {psz} must divide l_max {l_max} (the page "
                "table tiles the sequence in whole pages)")
        while l_max % psz:
            psz //= 2
    n_ptab = l_max // psz
    if pages is None:
        pages = serve.get("pages", None)
    pages = int(pages) if pages is not None else slots * n_ptab
    if pages < n_ptab:
        raise ValueError(
            f"page pool of {pages} pages cannot hold one max-length "
            f"request ({n_ptab} pages of {psz} tokens for l_max {l_max})")
    return ServeGeometry(slots, l_max, True, psz, pages, use_kernel, mega)


def ngram_draft(hist, k: int, *, n_max: int = 3, n_min: int = 1):
    """Prompt-lookup / n-gram drafter (engine.py:422-462): the ``k``
    tokens that followed the most recent earlier occurrence of the
    history's trailing n-gram, longest n first, as a (k,) int32 row
    padded with ``-1``; None when no n-gram of any tried length recurs.
    A draft is a guess the verify step checks against the sampler's own
    picks: a bad one costs micro-steps, never tokens.  The search is
    ``bytes.rfind`` over the int32 buffer, with an alignment walk that
    rejects byte-level matches off a 4-byte boundary."""
    hist = np.ascontiguousarray(hist, np.int32)
    L = int(hist.size)
    buf = hist.tobytes()
    for n in range(n_max, n_min - 1, -1):
        if L < n + 2:       # the pattern, an earlier occurrence and at
            continue        # least one continuation token
        pat = buf[(L - n) * 4:]
        # the match must end before the trailing pattern itself
        off = buf.rfind(pat, 0, (L - 1) * 4)
        while off >= 0 and off % 4:
            off = buf.rfind(pat, 0, off + len(pat) - 1)
        if off < 0:
            continue
        start = off // 4 + n
        cont = hist[start:start + k]
        if not cont.size:
            continue
        row = np.full(k, -1, np.int32)
        row[:cont.size] = cont
        return row
    return None


def serving_params(plan: DecodePlan, params, device) -> dict:
    """The decode plan's parameters on ``device``, each weight matrix of
    a unit with a compute dtype stored in that dtype once.  A tensor that
    already lies on ``device`` in its served dtype is served as it is,
    not copied (so a hot swap, which writes into the served tensors,
    writes into it).  A step then casts nothing: the attention's ``w.to(dt)`` returns the stored copy,
    ``ops.dense``'s ``w.to(dt).float()`` widens it, and both give the
    bits the per-step cast of the float32 weight gives (the decode path's
    activations are float32, so ``dense``'s result type is unchanged).
    On the card the casts were a quarter of a captured prefill step's
    device time."""
    units = [u for _, u in plan.seq_handlers] + list(plan.flat_units)
    low = {u.name: u.compute_dtype for u in units
           if getattr(u, "compute_dtype", None) is not None}

    def place(tree, dt=None):
        # a unit's params may nest (a pipeline stack's s<i>/<unit>/...):
        # the innermost unit name on the path picks the dtype
        if isinstance(tree, dict):
            return {k: place(v, low.get(k, dt)) for k, v in tree.items()}
        return tree.to(device, dt) if dt is not None and tree.dim() >= 2 \
            else tree.to(device)

    return {u: place(p, low.get(u)) for u, p in params.items()}


class StagedParams(NamedTuple):
    """A weight tree checked and placed on an engine's device
    (:meth:`DecodeEngine.stage_params`), ready for
    :meth:`DecodeEngine.swap_params`."""
    engine: object
    tree: dict      # the served layout and dtypes, on the device


class _StreamHandle:
    """Incremental token feed for one streaming request
    (engine.py:767-863).  The scheduler thread is the only producer: it
    pushes frames numbered by the GLOBAL generated-token index, so a
    resume seeded from an emitted prefix numbers its first frame one past
    the interrupted run's last.  :meth:`events` always ends with exactly
    one terminal event.  The buffer is bounded: a consumer that stops
    draining gets its stream closed with an overflow error (the request
    itself still retires unary)."""

    __slots__ = ("_cond", "_frames", "next_i", "prompt_tokens",
                 "buffer_tokens", "closed", "finish_reason", "error",
                 "overflowed")

    def __init__(self, start_i: int, prompt_tokens: int,
                 buffer_tokens: int):
        self._cond = threading.Condition()
        self._frames = collections.deque()  # pending (i, token)  # guarded-by: self._cond
        # next global generated index the engine will push; the
        # scheduler thread is the sole writer
        self.next_i = int(start_i)          # guarded-by: self._cond
        self.prompt_tokens = int(prompt_tokens)
        self.buffer_tokens = int(buffer_tokens)
        self.closed = False                 # guarded-by: self._cond
        self.finish_reason = None           # guarded-by: self._cond
        self.error: Optional[str] = None    # guarded-by: self._cond
        self.overflowed = False             # guarded-by: self._cond

    def push(self, start_i: int, tokens) -> int:
        """Append frames numbered ``start_i`` onward, skipping indices
        already pushed; returns the number appended."""
        n = 0
        with self._cond:
            if self.closed:
                return 0
            i = int(start_i)
            for t in tokens:
                if i >= self.next_i:
                    self._frames.append((i, int(t)))
                    self.next_i = i + 1
                    n += 1
                i += 1
            if self.buffer_tokens and len(self._frames) > self.buffer_tokens:
                self.overflowed = True
                self.closed = True
                self.finish_reason = "error"
                self.error = (f"stream buffer overflow: consumer left "
                              f"more than {self.buffer_tokens} frames "
                              "undrained (serve.stream.buffer_tokens)")
            self._cond.notify_all()
        return n

    def close(self, finish_reason: str, error: Optional[str] = None):
        """Mark the stream terminal (the first close wins)."""
        with self._cond:
            if not self.closed:
                self.closed = True
                self.finish_reason = finish_reason
                self.error = error
            self._cond.notify_all()

    def events(self, timeout_s: Optional[float] = None):
        """Every pending ``("token", i, tok)`` frame in index order, then
        exactly one ``("done", finish_reason, error)``.  ``timeout_s``
        bounds the total wait; expiry raises :class:`TimeoutError`."""
        end = None if timeout_s is None else time.monotonic() + timeout_s
        while True:
            with self._cond:
                while not self._frames and not self.closed:
                    rem = 1.0 if end is None else end - time.monotonic()
                    if rem <= 0:
                        raise TimeoutError(
                            "stream consumer timed out waiting for the "
                            "next frame")
                    self._cond.wait(min(rem, 1.0))
                frames = list(self._frames)
                self._frames.clear()
                closed = self.closed
                reason, err = self.finish_reason, self.error
            for i, t in frames:
                yield ("token", i, t)
            if closed:
                yield ("done", reason, err)
                return


class _Request:
    __slots__ = ("prompt", "n_steps", "temperature", "top_k", "top_p",
                 "eos_id", "seed", "deadline", "done", "result", "error",
                 "submitted_at", "admitted_at", "first_token_at",
                 "finished_at", "run_started_at", "slot", "page_row",
                 "prefix_start", "page_hashes", "priority", "gen",
                 "preemptions", "chunk_next", "_eff", "stream", "stop_seqs",
                 "stop_hit", "trace_id", "batch")

    def __init__(self, prompt, n_steps, temperature, top_k, top_p, eos_id,
                 seed, deadline, priority: int = 0, batch: bool = False):
        self.prompt = prompt            # (P,) np.int32
        self.n_steps = n_steps
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_id = eos_id
        self.seed = seed
        self.deadline = deadline        # absolute monotonic seconds
        self.done = threading.Event()
        self.result = None              # np.int32 tokens, prompt included
        self.error: Optional[Exception] = None
        self.submitted_at = time.monotonic()
        self.admitted_at = None         # first admission (left the queue)
        self.first_token_at = None
        self.finished_at = None
        self.run_started_at = None      # latest admission into a slot
        self.slot = None
        self.page_row = None            # paged: this request's page table
        self.prefix_start = 0           # paged: first un-shared position
        self.page_hashes = ()           # paged: chained full-page hashes
        self.priority = int(priority)   # request class, 0 = highest
        # the batch lane's trough class (the internal lowest priority):
        # kept out of the SLO histograms and the Retry-After EWMA
        self.batch = bool(batch)
        # tokens generated before a preemption (or the resume form's
        # emitted prefix): an admission prefills prompt + gen
        self.gen = np.empty(0, np.int32)
        self.preemptions = 0
        self.chunk_next = 0             # next global position to prefill
        self._eff = None                # memoized effective prompt
        self.stream: Optional[_StreamHandle] = None
        self.stop_seqs = ()
        self.stop_hit = False
        self.trace_id = next_trace_id()  # the request's /trace.json track

    @property
    def end_index(self) -> int:
        """Global index of the final token (invariant across
        preemptions)."""
        return int(self.prompt.size) + int(self.n_steps) - 1

    def effective_prompt(self):
        """What an admission prefills: the prompt and every token
        generated before a preemption."""
        if self._eff is None:
            self._eff = (np.concatenate([self.prompt, self.gen])
                         if self.gen.size else self.prompt)
        return self._eff

    def finish(self, result=None, error=None):
        self.result, self.error = result, error
        self.finished_at = time.monotonic()
        self.done.set()


class _PrioQueue:
    """Strict-priority FIFO over ``priorities`` classes (0 = highest),
    engine.py:952-1022.  Not thread-safe on its own: every mutation
    happens under the engine's ``_qlock``."""

    __slots__ = ("_qs",)

    def __init__(self, priorities: int):
        self._qs = [collections.deque()
                    for _ in range(max(1, int(priorities)))]

    def __len__(self):
        return sum(len(q) for q in self._qs)

    def __bool__(self):
        return any(self._qs)

    def __iter__(self):
        for q in self._qs:
            yield from q

    def append(self, req):
        self._qs[req.priority].append(req)

    def appendleft(self, req):
        self._qs[req.priority].appendleft(req)

    def popleft(self):
        for q in self._qs:
            if q:
                return q.popleft()
        return None

    def steal_lower(self, priority: int):
        """Remove and return the youngest not-yet-started queued request
        of the lowest class strictly below ``priority``'s; None when
        nothing displaceable is queued.  A preempted resume
        (``preemptions > 0``) holds committed work and is never
        displaced."""
        for c in range(len(self._qs) - 1, int(priority), -1):
            q = self._qs[c]
            for i in range(len(q) - 1, -1, -1):
                if q[i].preemptions == 0:
                    r = q[i]
                    del q[i]
                    return r
        return None

    def remove_if(self, pred):
        """Remove and return every queued request matching ``pred``."""
        out = []
        for i, q in enumerate(self._qs):
            kept = collections.deque()
            for r in q:
                (out if pred(r) else kept).append(r)
            self._qs[i] = kept
        return out

    def clear(self):
        for q in self._qs:
            q.clear()


def _state_layout(S: int, n_ptab: int) -> dict:
    """Element offsets of each field in the int32 per-slot state buffer.
    ``serial`` counts each slot's admissions: the steps do not read it,
    but an admission always changes the buffer, so the host reloads the
    token and key tables with it."""
    off, out = 0, {}
    for name, n in (("serial", S), ("pos", S), ("active", S),
                    ("temp", S), ("topk", S), ("topp", S), ("eos", S),
                    ("end", S), ("ptab", S * n_ptab)):
        out[name] = (off, off + n)
        off += n
    out["size"] = off
    return out


def _state_views(buf: torch.Tensor, layout: dict, S: int) -> dict:
    """Typed views of the state buffer's fields (writes go through)."""
    f = {k: buf[v[0]:v[1]] for k, v in layout.items() if k != "size"}
    f["temp"] = f["temp"].view(torch.float32)
    f["topp"] = f["topp"].view(torch.float32)
    f["ptab"] = f["ptab"].view(S, f["ptab"].numel() // S)
    return f


class _ServeStep:
    """One of the engine's device steps in the shape ``StepCache`` builds
    and captures: ``begin`` (no host part), ``run`` (the device part)
    and the eager call ``(state, batch) -> outputs``, which first copies
    ``batch``'s tensors (pinned memory on the card) into the static
    inputs unless ``batch`` is None."""

    def __init__(self, engine, inputs: dict):
        self.plan, self.params = engine.plan, engine.params
        self.ctx = engine._ctx
        self.slots, self.n_ptab = engine.slots, engine.n_ptab
        self.l_max, self.page_size = engine.l_max, engine.page_size
        self.paged, self.paged_kernel = engine.paged, engine.paged_kernel
        self.layout = engine._layout
        self.inputs = inputs

    def begin(self, state):
        return None

    def __call__(self, state, batch):
        if batch is not None:
            for k, v in batch.items():
                self.inputs[k].copy_(v, non_blocking=True)
        return self.run(state, self.inputs, None)


class _TokenStep(_ServeStep):
    """``n`` micro-steps of the decode step body over the slot state
    ``{"caches", "st", "toks", "keys"}`` (engine.py:211-243): feed each
    live slot its token at its position, sample with the slot's
    parameters and its seed's fold at that global position (``keys``,
    :func:`~.generate.sample_slots`), write the token at ``pos + 1``,
    retire on eos or the length bound.
    A slot not alive feeds its last token again with its KV write routed
    to the scratch page (paged) or dropped (dense), so its state stays
    unchanged.  ``kind``:

    * ``"decode"`` (n = 1) and ``"megastep"`` (n = N, engine.py:366-397):
      every live slot advances each micro-step; ``count`` is the tokens
      it emitted;
    * ``"verify"`` (n = K + 1, engine.py:284-319): micro-step i < K
      keeps a slot alive only while its sampled token equals its draft
      ``inputs["draft"][:, i]`` (``-1`` never matches); the last one is
      the bonus token; ``count`` is the accepted drafts.

    With ``sampled=False`` (the program ``name`` is ``kind + "_greedy"``)
    every slot takes ``logits.float().argmax(-1)``, bitwise a greedy
    row of the sampling program, without its noise and filter: the host
    replays it when no live slot samples.

    Outputs ``{"rb": int32 [pos | active | finished | count | tokens (S,
    n)]}``, everything the host reads back after the dispatch."""

    def __init__(self, engine, kind: str, n: int, sampled: bool):
        S = engine.slots
        inputs = ({"draft": torch.full((S, n - 1), -1, dtype=torch.int32,
                                       device=engine.device)}
                  if kind == "verify" else {})
        super().__init__(engine, inputs)
        self.kind, self.n, self.vocab = kind, n, engine._vocab
        self.sampled = sampled
        self.name = kind if sampled else kind + "_greedy"
        self.rows = torch.arange(S, device=engine.device)
        self.offsets = torch.arange(n, device=engine.device)

    def run(self, state, inputs, host):
        S, rows = self.slots, self.rows
        f = _state_views(state["st"], self.layout, S)
        toks, caches, pos = state["toks"], state["caches"], f["pos"]
        keys = state["keys"]
        active = f["active"] != 0
        alive = active
        fin = torch.zeros_like(active)
        count = torch.zeros_like(pos)
        outs = []
        draft = inputs.get("draft")
        with torch.no_grad():
            # every micro-step's noise in one pass: a slot alive at
            # micro-step i sits at position pos + i (a slot not alive
            # samples a token nobody reads)
            if self.sampled:
                ahead = (pos.long()[:, None] + self.offsets).clamp(
                    max=self.l_max - 1)
                noise = gumbel_noise(keys.gather(1, ahead).reshape(-1),
                                     self.vocab).view(S, self.n, -1)
            for i in range(self.n):
                p = pos.clone()
                tok = toks[rows, p.long()]
                if self.paged:
                    logits, _ = self.plan.step(
                        self.params, caches, tok, p, self.ctx,
                        pages=(f["ptab"], self.page_size, alive),
                        paged_kernel=self.paged_kernel)
                else:
                    logits, _ = self.plan.step(self.params, caches, tok, p,
                                               self.ctx, write_ok=alive)
                nxt = (sample_slots(logits, f["temp"], f["topk"],
                                    f["topp"], noise[:, i])
                       if self.sampled else logits.float().argmax(-1))
                new_p = torch.where(alive, p + 1, p)
                at = new_p.long().clamp(max=self.l_max - 1)
                toks[rows, at] = torch.where(alive, nxt.to(toks.dtype),
                                             toks[rows, at])
                done = alive & ((nxt == f["eos"]) | (new_p >= f["end"]))
                if draft is None:
                    count += alive
                    alive = alive & ~done
                else:
                    match = alive & (nxt == draft[:, min(i, self.n - 2)]) \
                        if i < self.n - 1 else torch.zeros_like(alive)
                    count += match
                    alive = alive & match & ~done
                fin = fin | done
                pos.copy_(new_p)
                outs.append(nxt.to(torch.int32))
            f["active"].copy_(active & ~fin)
        rb = torch.cat([pos, f["active"], fin.to(torch.int32), count,
                        torch.stack(outs, 1).reshape(-1)])
        return {"rb": rb}


class _PrefillStep(_ServeStep):
    """One prompt position of one slot: ``buf`` = effective prompt
    (l_max) | the slot's page-table row (n_ptab) | position index (1) |
    slot (1).  The step reads its token and position at the index and
    advances the index by one on the card, so a chunk of n positions is
    one load and n calls.  KV goes through the page table, reads through
    the gather path; a recurrent carry is the slot's row of the engine's
    carries, reset at position 0 and carried across chunk slices
    (engine.py:581-648).  Its state is the caches; outputs the (1, V)
    logits of the position."""

    kind = "prefill"

    def __init__(self, engine):
        super().__init__(engine, {"buf": torch.zeros(
            engine.l_max + engine.n_ptab + 2, dtype=torch.int32,
            device=engine.device)})

    def run(self, caches, inputs, host):
        b = inputs["buf"]
        L, n = self.l_max, self.n_ptab
        idx = b[L + n:L + n + 1]
        with torch.no_grad():
            # the step reads the position before the index advances
            logits, _ = self.plan.step(
                self.params, caches, b.index_select(0, idx.long()), idx,
                self.ctx, pages=(b[L:L + n].view(1, n), self.page_size,
                                 None),
                carry_rows=b[L + n + 1:L + n + 2].long())
            idx.add_(1)
        return {"logits": logits}


class DecodeEngine(Logger):
    """Continuous-batching decode engine over a :class:`DecodePlan`.

    ``slots`` / ``l_max`` / ``window_ms`` / ``queue_depth`` /
    ``deadline_s`` / the paged knobs / ``priorities`` / ``preempt`` /
    ``prefill_chunk`` / ``megastep`` default from ``root.common.serve``,
    ``spec`` / ``spec_k`` from ``root.common.serve.spec`` (whose
    ``drafter`` must be ``"ngram"``); ``admission`` injects an
    :class:`AdmissionController` (tests).  ``device`` defaults to the
    CUDA card (``ops.resolve_device``); the workflow state's parameters
    are moved there, and those already there in their served dtype are
    served as they are: a hot swap writes into them, so a caller that
    goes on using the old weights gives the engine a copy.
    ``wstate["params"]`` is then the served tree.  ``capture=False`` keeps the paged steps eager on
    the card (the eager-versus-captured witness).  ``status`` is a
    :class:`~.status.StatusReporter` the scheduler publishes its stats
    to every 0.5 s (and a scheduler crash as an event).  A sealed
    artifact's :class:`~.artifact.ArtifactRunner` is this engine with
    its model hooks (:meth:`_load_model`, :meth:`_make_caches`,
    :meth:`_make_steps`) reading the artifact instead of a workflow."""

    def __init__(self, workflow, wstate, *, slots: Optional[int] = None,
                 l_max: Optional[int] = None,
                 window_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 output_unit: Optional[str] = None,
                 cache_dtype=torch.float32,
                 paged: Optional[bool] = None,
                 page_size: Optional[int] = None,
                 pages: Optional[int] = None,
                 paged_kernel: Optional[bool] = None,
                 priorities: Optional[int] = None,
                 preempt: Optional[bool] = None,
                 prefill_chunk: Optional[int] = None,
                 megastep: Optional[int] = None,
                 spec: Optional[bool] = None,
                 spec_k: Optional[int] = None,
                 admission: Optional[AdmissionController] = None,
                 capture: bool = True,
                 status=None,
                 device=None):
        self.device = resolve_device(device)
        self.status = status
        serve = root.common.serve
        geo = resolve_serve_geometry(slots, l_max, paged=paged,
                                     page_size=page_size, pages=pages,
                                     paged_kernel=paged_kernel,
                                     megastep=megastep)
        self.slots, self.l_max = geo.slots, geo.l_max
        self.paged, self.page_size, self.pages = \
            geo.paged, geo.page_size, geo.pages
        self.n_ptab = geo.n_ptab
        self.paged_kernel = geo.paged_kernel
        self.megastep = geo.megastep
        # speculative decoding (engine.py:1181-1195): the host drafter
        # proposes up to spec_k tokens a slot, one verify step checks them
        self.spec = bool(serve.spec.get("enabled", False)
                         if spec is None else spec)
        self.spec_k = int(serve.spec.get("k", 4)
                          if spec_k is None else spec_k)
        self.spec_drafter = str(serve.spec.get("drafter", "ngram"))
        if self.spec:
            if self.spec_k < 1:
                raise ValueError(
                    f"serve.spec.k must be >= 1, got {self.spec_k}")
            if self.spec_drafter != "ngram":
                raise ValueError(
                    f"unknown speculative drafter {self.spec_drafter!r} "
                    "(supported: 'ngram')")
        self.window_s = float(window_ms if window_ms is not None
                              else serve.get("window_ms", 2.0)) / 1e3
        self.queue_depth = int(queue_depth if queue_depth is not None
                               else serve.get("queue_depth", 64))
        self.deadline_s = float(deadline_s if deadline_s is not None
                                else serve.get("deadline_s", 120.0))
        self.priorities = max(1, int(serve.get("priorities", 3)
                                     if priorities is None else priorities))
        self.preempt = bool(serve.get("preempt", True)
                            if preempt is None else preempt)
        self.prefill_chunk = int(serve.get("prefill_chunk", 256)
                                 if prefill_chunk is None else prefill_chunk)
        if self.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0, got {self.prefill_chunk}")
        self.stream_buffer_tokens = int(
            serve.stream.get("buffer_tokens", 4096))
        self._ctx = Context(train=False)
        self._load_model(workflow, wstate, output_unit)

        S = self.slots
        self._cache_dtype = cache_dtype
        self._caches = self._make_caches(cache_dtype)
        # the per-slot state on the device (one int32 buffer, the token
        # matrix and the fold-key table, which the steps read and write)
        # and its host mirror (scheduler thread); the mirror's pinned
        # staging copies load the device state when the host changed it
        on_card = self.device.type == "cuda"
        self._layout = _state_layout(S, self.n_ptab)
        self._st_stage = torch.zeros(self._layout["size"], dtype=torch.int32,
                                     pin_memory=on_card)
        self._st_synced = np.zeros(self._layout["size"], np.int32)
        self._toks_stage = torch.zeros((S, self.l_max), dtype=torch.int32,
                                       pin_memory=on_card)
        self._toks = self._toks_stage.numpy()   # prompt and tokens a slot
        self._keys_stage = torch.zeros((S, self.l_max), dtype=torch.int64,
                                       pin_memory=on_card)
        # each slot's fold_seed(seed, position) at every position
        self._keys = self._keys_stage.numpy()
        self._pos = np.zeros(S, np.int32)       # index of last written tok
        self._active = np.zeros(S, bool)
        self._temp = np.zeros(S, np.float32)
        self._topk = np.zeros(S, np.int64)
        self._topp = np.ones(S, np.float32)
        self._eos = np.full(S, -1, np.int64)
        self._end = np.zeros(S, np.int64)
        self._serial = np.zeros(S, np.int32)
        self._slot_req: list = [None] * S
        self._dstate = {
            "caches": self._caches,
            "st": torch.zeros(self._layout["size"], dtype=torch.int32,
                              device=self.device),
            "toks": torch.zeros((S, self.l_max), dtype=torch.int32,
                                device=self.device),
            "keys": torch.zeros((S, self.l_max), dtype=torch.int64,
                                device=self.device)}
        # slots whose admission is mid-(chunked-)prefill
        self._chunking: set = set()

        # paged pool: refcounted pages, a free list, the per-slot page
        # table (scratch row = index ``pages``), the prefix index (hash
        # -> page) and its reverse, and an LRU tick per page
        if self.paged:
            self._scratch = self.pages
            self._ptab = np.full((S, self.n_ptab), self._scratch, np.int32)
            self._page_lock = threading.Lock()
            self._page_ref = np.zeros(self.pages, np.int32)  # guarded-by: self._page_lock
            self._page_free = list(range(self.pages))  # guarded-by: self._page_lock
            self._prefix_index: dict = {}  # guarded-by: self._page_lock
            self._page_key: dict = {}      # guarded-by: self._page_lock
            self._page_tick = np.zeros(self.pages, np.int64)  # guarded-by: self._page_lock
            self._tick = 0                 # guarded-by: self._page_lock
            self._prefix_hit_pages = 0     # guarded-by: self._page_lock
            self._prefix_miss_pages = 0    # guarded-by: self._page_lock
            self._evictions = 0            # guarded-by: self._page_lock
            self._cow_admissions = 0       # guarded-by: self._page_lock
            self._pool_rejected = 0        # guarded-by: self._page_lock
            # KV-page transfer: pages that arrived by import_pages (a
            # prefix hit on one counts as a remote hit) and the volume
            self._imported_pages: set = set()  # guarded-by: self._page_lock
            self._remote_hit_pages = 0     # guarded-by: self._page_lock
            self._kv_exported_pages = 0    # guarded-by: self._page_lock
            self._kv_imported_pages = 0    # guarded-by: self._page_lock
            self._kv_export_bytes = 0      # guarded-by: self._page_lock
            self._kv_import_bytes = 0      # guarded-by: self._page_lock
        # staged KV-page imports, applied by the scheduler thread at a
        # step boundary (it owns every cache write); always empty on a
        # dense engine, whose import_pages refuses before staging
        self._kv_imports: collections.deque = collections.deque()  # guarded-by: self._kv_import_lock
        self._kv_import_lock = threading.Lock()
        # the blob's weights version: the parameter tree's signature,
        # framework named (a JAX engine's pages never serve here: the
        # two frameworks' KV rows differ in their last bits), and the
        # hot-swap count
        self._swaps = 0
        self.last_swap_in_flight: Optional[int] = None
        self._draining = False
        # a staged hot swap: (staged tree, done event, new params), set
        # by swap_params, applied by the scheduler at a step boundary
        self._staged = None              # guarded-by: self._swap_lock
        self._swap_lock = threading.Lock()
        self._status_mark = 0.0
        self._kv_sig = hashlib.sha256(repr(
            ("veles_tpu_torch", tree_signature(self.params))).encode()
        ).hexdigest()[:12]

        # one internal class past the submittable range holds the batch
        # lane: victim selection preempts it first and a full queue
        # displaces it first, with no path treating it otherwise
        self._queue = _PrioQueue(self.priorities + 1)  # guarded-by: self._qlock
        self._qlock = threading.Lock()
        self._shed_by_class: dict = {}   # guarded-by: self._qlock
        self._streams: set = set()       # guarded-by: self._qlock
        self._wake = threading.Event()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._died = False
        self._qwait_ewma = 0.0           # scheduler-thread-written
        self._tokens_per_s = 0.0         # scheduler-thread-written
        # tokens a local prefill produces a second (EWMA): the fleet's
        # fetch-versus-reprefill payoff reads it from stats()
        self._prefill_tok_s = 0.0        # scheduler-thread-written
        # the batch lane's token count and rate (0.5 s window)
        self._batch_tok_n = 0            # scheduler-thread-written
        self._batch_tok_s = 0.0          # scheduler-thread-written
        self._batch_rate_mark = (time.monotonic(), 0)

        self._stats_lock = threading.Lock()
        self._n = collections.Counter()   # guarded-by: self._stats_lock
        self._ttft = collections.deque(maxlen=1024)  # guarded-by: self._stats_lock
        self._step_s = collections.deque(maxlen=4096)  # guarded-by: self._stats_lock
        self._replays = collections.Counter()  # guarded-by: self._stats_lock
        self._decode_wall = 0.0           # guarded-by: self._stats_lock
        self._verify_wall = 0.0           # guarded-by: self._stats_lock
        # the speculative policy's measured state (engine.py:1357-1375,
        # scheduler thread): decode and verify wall EWMAs, an accept EWMA
        # that starts optimistic so the first drafts run and measure, and
        # an attempt counter armed so the first tick drafts
        self._step_wall_ewma = 0.0
        self._verify_wall_ewma = 0.0
        self._accept_ewma = 1.0
        # goodput: the token dispatches since the gauges' last read
        # ([(program, positions, active)] and their summed wall, guarded-by:
        # self._stats_lock), the achieved bytes/s the latest read
        # priced, and when the last dispatch ran
        self._bw_pending: list = []
        self._bw_wall = 0.0
        self._last_dispatch = None        # scheduler thread
        self._bw_rate = 0.0
        self._last_step_at = 0.0
        self._goodput_mark = 0.0
        self._ticks_since_attempt = _SPEC_PROBE_TICKS
        self._spec_attempts = 0
        self._spec_rate_mark = (float("-inf"), 0, 0)

        self._init_metrics()
        self._slo = slo_tracker()
        self._admission = (admission if admission is not None
                           else AdmissionController(
                               queue_depth=self.queue_depth,
                               priorities=self.priorities,
                               burn_fn=self._slo.max_burn,
                               gauge=self._g_window))

        # the steps, built (paged, on the card: captured) once for the
        # engine's lifetime — decode, prefill, and megastep and verify
        # where enabled — with the pinned staging buffers of their
        # inputs; the scheduler thread replays them on its own stream
        self.step_cache = StepCache(capture=capture)
        self._stream = torch.cuda.Stream(self.device) if on_card else None
        # each token program twice: sampling, and greedy-only (the
        # sampled half's noise and filter are ~60 small kernels a
        # micro-step, paid for nothing when every live slot is greedy)
        kinds = [("decode", 1)]
        if self.megastep > 1:
            kinds.append(("megastep", self.megastep))
        if self.spec:
            kinds.append(("verify", self.spec_k + 1))
        steps = self._make_steps(kinds)
        key = (id(self), S, self.l_max, self.page_size, self.pages,
               self.paged_kernel, str(cache_dtype), str(self.device))
        self._fns, self._stage = {}, {}
        for step in steps:
            name = getattr(step, "name", step.kind)
            if not self.paged:
                self._fns[name] = step           # dense: eager
            else:
                state = self._caches if step.kind == "prefill" \
                    else self._dstate
                self._fns[name] = self.step_cache.get_step(
                    name, key + (getattr(step, "n", 0),),
                    lambda s=step: s, (state, step.inputs))
            for iname, t in step.inputs.items():
                if iname not in self._stage:     # one per input name
                    self._stage[iname] = torch.zeros(
                        t.shape, dtype=t.dtype, pin_memory=on_card)
        self._micro_steps = dict(kinds)    # paged launches a layer
        # the prefill's staging buffer is read by a copy no sampling
        # waits for on an intermediate chunk: this event fences it
        self._prefill_staged = torch.cuda.Event() \
            if on_card and self.paged else None
        self._register_memory()

    # -- the model: what a sealed artifact's runner supplies instead -------
    def _load_model(self, workflow, wstate, output_unit):
        """The decode plan and the served weights: ``plan``, ``params``
        (the tensors the steps read: the caller's where they already lie
        on the device in the served dtypes), ``wstate``, the signatures
        a swap's tree is held to (the caller's layout or the served
        one), ``_prefix_ok``, ``_input_vocab`` and the head width
        ``_vocab``."""
        self.plan = DecodePlan(workflow, output_unit)
        self.params = serving_params(self.plan, wstate["params"],
                                     self.device)
        self.wstate = dict(wstate, params=self.params)
        self._swap_sigs = (tree_signature(wstate["params"]),
                           tree_signature(self.params))
        # recurrent carried state is position-recurrent from token 0 and
        # is not paged: such a chain takes no prefix shortcut, and its
        # preempted requests re-prefill from token 0 (engine.py:1118)
        self._prefix_ok = not self.plan._rec_units
        # the embedding table's rows: the bound on prompt token ids (the
        # REST guard's), checked in submit before anything is enqueued
        self._input_vocab = input_vocab(workflow, self.params)
        # head width (the logits' last dim): top_k's keep-all sentinel
        self._vocab = int(workflow.specs[self.plan.output].shape[-1])

    def _make_caches(self, cache_dtype) -> dict:
        """The KV pool (paged: ``pages + 1`` rows, the last the scratch
        page) or the dense rows, and the recurrent carries."""
        if self.paged:
            return self.plan.init_caches(
                self.params, self.slots, self.l_max, cache_dtype,
                self.device, kv_rows=self.pages + 1,
                page_size=self.page_size)
        return self.plan.init_caches(self.params, self.slots, self.l_max,
                                     cache_dtype, self.device)

    def _make_steps(self, kinds) -> list:
        """Each token step of ``kinds`` [(kind, micro-steps)] sampling and
        greedy-only, and (paged) the one-position prefill step."""
        steps = [_TokenStep(self, kind, n, sampled)
                 for kind, n in kinds for sampled in (True, False)]
        if self.paged:
            steps.append(_PrefillStep(self))
        return steps

    def _register_memory(self):
        """Publish the engine's byte ledger (``GET /memory.json``): the
        served parameters (shared with the caller's tree where they lay
        on the device in the served dtypes), the KV pool, the slot state
        (the slot-state buffer and the recurrent carries, engine.py:1573
        and :1613), the token matrix and the fold-key table, from
        shapes.  ``stats()["memory"]`` reads this engine's own copy; the
        finalizer drops its entries when the engine is freed."""
        attn = self.plan.attn_keys()
        self._mem_bytes = {
            "serving_params": tree_bytes(self.params),
            "kv_cache": tree_bytes({k: v for k, v in self._caches.items()
                                    if k in attn}),
            "slot_state": tree_bytes(self._dstate["st"]) + tree_bytes(
                {k: v for k, v in self._caches.items() if k not in attn}),
            "token_matrix": tree_bytes(self._dstate["toks"]),
            "fold_keys": tree_bytes(self._dstate["keys"]),
        }
        mem = memory_monitor()
        stamps = {f"engine.{k}": mem.set_component(f"engine.{k}", v)
                  for k, v in self._mem_bytes.items()}
        extra = mem.set_extra("engine", {
            "slots": self.slots, "l_max": self.l_max, "paged": self.paged,
            "cache_dtype": str(self._cache_dtype).replace("torch.", ""),
            **({"pages": self.pages, "page_size": self.page_size}
               if self.paged else {})})
        self._mem_finalizer = weakref.finalize(
            self, drop_stamped_components, stamps, {"engine": extra})
        mem.ensure_poller()

    def _init_metrics(self):
        reg = registry()
        self._m_requests = reg.counter(
            "vt_requests_total",
            "decode requests by terminal outcome (ok, 429 shed, 504 "
            "deadline, crash, stopped)", labels=("outcome",))
        self._m_shed = reg.counter(
            "vt_shed_total", "requests shed (pool 429, admission-window "
            "429, hard-full displacement) by request class",
            labels=("priority",))
        self._m_preempt = reg.counter(
            "vt_preemptions_total",
            "running slots preempted for a higher-class request")
        self._m_batch_preempt = reg.counter(
            "vt_batch_preemptions_total",
            "batch-lane slots preempted so interactive work could be "
            "admitted (subset of vt_preemptions_total)")
        self._g_batch_tps = reg.gauge(
            "vt_batch_tokens_per_sec",
            "recent batch-lane decode throughput (0.5 s window), which "
            "the SLO histograms never see")
        self._m_queue_wait = reg.histogram(
            "vt_request_queue_wait_seconds",
            "time a request waited between submit() and its first "
            "admission into a slot")
        self._m_ttft = reg.histogram(
            "vt_request_ttft_seconds", "submit-to-first-token latency")
        self._m_decode_step = reg.histogram(
            "vt_decode_step_seconds",
            "wall time of one decode step (every slot one position)")
        self._g_window = reg.gauge(
            "vt_admission_window",
            "queued requests the admission controller currently admits")
        self._g_megastep_n = reg.gauge(
            "vt_megastep_n",
            "configured decode micro-steps fused per megastep dispatch "
            "(1 = megastep off)")
        self._g_megastep_n.set(self.megastep)
        self._m_spec_proposed = reg.counter(
            "vt_spec_proposed_total",
            "draft tokens proposed to the speculative verify step")
        self._m_spec_accepted = reg.counter(
            "vt_spec_accepted_total",
            "draft tokens accepted (emitted token matched the proposal)")
        self._g_spec_accept_rate = reg.gauge(
            "vt_spec_accept_rate",
            "accepted / proposed draft tokens over the recent window "
            "(0.5 s; 0 when nothing was proposed)")
        self._m_spec_verify = reg.histogram(
            "vt_spec_verify_step_seconds",
            "wall time of one speculative verify step (every active slot "
            "scores k + 1 positions in one dispatch)")
        self._m_kv_exported = reg.counter(
            "vt_kv_pages_exported_total",
            "prefix pages serialized by export_pages (GET /kv/pages)")
        self._m_kv_imported = reg.counter(
            "vt_kv_pages_imported_total",
            "prefix pages written into the pool by import_pages (PUT "
            "/kv/pages); skipped duplicates and pool-full drops not "
            "included")
        self._m_kv_bytes = reg.counter(
            "vt_kv_transfer_bytes_total",
            "serialized KV-page wire bytes, by transfer direction",
            labels=("direction",))
        self._m_kv_seconds = reg.histogram(
            "vt_kv_transfer_seconds",
            "wall time of one export_pages / import_pages call "
            "(serialize, or validate and apply), by direction",
            labels=("direction",))
        self._m_swaps = reg.counter(
            "vt_engine_swaps_total",
            "hot weight swaps applied at a decode-step boundary")
        self._g_decode_bw = reg.gauge(
            "vt_decode_bandwidth_bytes_per_sec",
            "achieved decode memory traffic: counted bytes over wall "
            "(EWMA), fed by decode, megastep and speculative verify "
            "dispatches")
        self._g_decode_mbu = reg.gauge(
            "vt_decode_mbu",
            "decode model-bandwidth-utilization: achieved bytes/s over "
            "root.common.observe.peak_hbm_gbps (0 = peak unknown)")
        self._g_tps_chip = reg.gauge(
            "vt_tokens_per_sec_per_chip",
            "recent decode throughput per local device")
        self._g_headroom = reg.gauge(
            "vt_memory_headroom_slots",
            "max-length requests the engine can still admit (free "
            "slots, bounded by free+evictable pages when paged)")

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._thread is None:
            if self._stream is not None:
                # the caches, static inputs and graphs were made on the
                # building thread's stream; the scheduler's takes over
                torch.cuda.synchronize(self.device)
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._loop, name="decode-engine", daemon=True)
            self._thread.start()
            _register_live(self)
        return self

    @property
    def started(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _signal_stop(self):
        self._stop_evt.set()
        self._wake.set()

    def stop(self, timeout: float = 30.0):
        """Stop the scheduler thread and wait up to ``timeout`` s for it.
        A thread still running then stays the engine's (``started``) and
        in the exit hook's registry, with a warning."""
        self._signal_stop()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                self.warning("decode-engine thread still running %.1f s "
                             "after stop", timeout)
                return
            self._thread = None
        with _LIVE_LOCK:
            _LIVE_ENGINES.discard(self)

    # -- lifecycle: hot swap and drain (runtime/deploy.py drives these) ----
    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def swaps(self) -> int:
        return self._swaps

    def stage_params(self, params) -> "StagedParams":
        """The first half of :meth:`swap_params`: check ``params`` (a tree
        of tensors or numpy arrays in the workflow state's layout, or in
        the served one) leaf for leaf in path, shape and dtype (a
        mismatch raises ValueError, the old weights still serving), and
        place it on the device in the served tensors' dtypes, fully
        transferred (host data through pinned memory on a side stream,
        which is waited for), while the old weights serve.  The staged
        tree is the only device copy a swap makes: give it host data."""
        params = tree_map(torch.as_tensor, params)
        new_sig = tree_signature(params)
        if new_sig not in self._swap_sigs:
            raise ValueError(
                "hot swap rejected: the parameter tree does not match the "
                "captured programs (same-architecture weights only; a "
                "different architecture needs a fresh engine): "
                + signature_mismatch(self._swap_sigs[0], new_sig))
        return StagedParams(self, self._stage_params(params))

    def swap_params(self, params, *, timeout: Optional[float] = None):
        """Hot weight swap: serve ``params`` (a tree of the workflow
        state's layout, or what :meth:`stage_params` returned) from the
        next dispatch on.

        The captured steps are reused as they are (the StepCache
        counters stay flat): at the next dispatch boundary the scheduler
        thread copies the staged tensors into the served ones in place,
        on the engine's stream, after the last replay of the old weights
        and before the first of the new.  In-flight slots finish on KV
        of mixed versions; cached and imported prefix pages are dropped
        and the weights version (``kv_wver``) bumps.  Blocks until the
        copy is issued or ``timeout`` (default
        ``root.common.serve.swap_timeout_s``) expires, in which case the
        staged tree is withdrawn and the old weights keep serving."""
        if timeout is None:
            timeout = float(root.common.serve.get("swap_timeout_s", 60.0))
        staged = params if isinstance(params, StagedParams) \
            else self.stage_params(params)
        if staged.engine is not self:
            raise ValueError("the staged tree belongs to another engine")
        if not self.started:
            self._flip(staged.tree)
            return
        done = threading.Event()
        with self._swap_lock:
            if self._staged is not None:
                raise RuntimeError(
                    "another swap is already staged and not yet applied")
            self._staged = (staged.tree, done)
        self._wake.set()
        if not done.wait(timeout):
            with self._swap_lock:
                if self._staged is not None and self._staged[1] is done:
                    self._staged = None
                    raise TimeoutError(
                        f"swap not applied within {timeout}s (scheduler "
                        "wedged?); the old version keeps serving")
            # the flip landed between the wait's timeout and the lock

    def _stage_params(self, params) -> dict:
        """``params`` in the served tensors' dtypes on the device, fully
        transferred before this returns: host tensors go through pinned
        memory on a side stream, which is then waited for."""
        on_card = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if on_card else None
        def stage(dst, src):
            if on_card and src.device.type == "cpu":
                src = src.to(dst.dtype).pin_memory()
            out = torch.empty_like(dst)
            out.copy_(src, non_blocking=on_card)
            return out

        with torch.no_grad(), (torch.cuda.stream(side) if on_card
                               else contextlib.nullcontext()):
            staged = tree_map(stage, self.params, params)
        if side is not None:
            side.synchronize()
        return staged

    def _flip(self, staged: dict):
        """Copy the staged tree into the served tensors in place (the
        captured steps keep their addresses), then drop the prefix
        cache and bump the weights version.  On the scheduler thread
        the copies run on its stream, after every replay it issued;
        they are waited for before the staged tensors are freed."""
        with torch.no_grad():
            tree_map(lambda dst, src: dst.copy_(src), self.params, staged)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        # these finish on KV of mixed versions
        self.last_swap_in_flight = self._in_flight()
        self._swaps += 1
        self._m_swaps.inc()
        # cached prefix pages hold KV of the old weights: a stale cached
        # prefix would serve every new request that hits it
        self._invalidate_prefix_cache()

    def _apply_swap(self):
        """Scheduler thread, between dispatches: flip to the staged
        tree, if one waits."""
        with self._swap_lock:
            staged, self._staged = self._staged, None
        if staged is None:
            return
        tree, done = staged
        try:
            self._flip(tree)
        finally:
            done.set()

    def _invalidate_prefix_cache(self):
        """Unregister every cached prefix page (after a swap their KV
        belongs to the previous weights).  Refcount-0 pages return to
        the free list; pages still referenced by in-flight slots keep
        serving those slots and free on release (which checks the
        registration then); imported pages go the same way."""
        if not self.paged:
            return
        with self._page_lock:
            for pid in list(self._page_key):
                del self._prefix_index[self._page_key.pop(pid)]
                if self._page_ref[pid] == 0:
                    self._page_free.append(pid)
            self._imported_pages.clear()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful drain: refuse new work (``submit`` raises
        :class:`EngineDraining`, the REST layer's 503), let queued and
        in-flight requests retire, then stop the scheduler.  True when
        everything retired before ``timeout`` (default
        ``root.common.serve.drain_timeout_s``); on a timeout the engine
        stops anyway and the leftovers fail with :class:`EngineStopped`."""
        if timeout is None:
            timeout = float(root.common.serve.get("drain_timeout_s", 30.0))
        self._draining = True
        deadline = time.monotonic() + max(0.0, float(timeout))
        while self.started and time.monotonic() < deadline:
            if self._idle():
                break
            time.sleep(0.01)
        # a crashed scheduler leaves the slots empty too, but it failed
        # the work: never a clean drain
        clean = not self._died and self._idle()
        self.stop()
        return clean

    def _in_flight(self) -> int:
        """Requests the engine holds: queued, or admitted to a slot
        (decoding or mid-prefill)."""
        with self._qlock:
            queued = len(self._queue)
        return queued + sum(r is not None for r in self._slot_req)

    def _idle(self) -> bool:
        """No queued, admitted or decoding work (a request mid-prefill is
        out of the queue but not yet active: ``_slot_req`` holds it)."""
        return not self._active.any() and self._in_flight() == 0

    # -- requests ----------------------------------------------------------
    def _check_ids(self, ids, what: str):
        hi = self._input_vocab if self._input_vocab is not None else 2 ** 31
        if ids.size and (ids.min() < 0 or ids.max() >= hi):
            raise ValueError(
                f"{what} token ids must be in [0, {hi}) "
                f"(got min {ids.min()}, max {ids.max()})")

    def submit(self, prompt, n_steps: int, *, temperature: float = 0.0,
               top_k: Optional[int] = None, top_p: Optional[float] = None,
               eos_id: Optional[int] = None, seed: int = 0,
               deadline_s: Optional[float] = None, priority: int = 0,
               stream: bool = False, emitted_prefix=None,
               stop=None, batch: bool = False) -> _Request:
        """Enqueue one sequence; its ``done`` event fires with ``result``
        (np.int32, prompt + generated, trimmed at eos or a stop match) or
        ``error``.

        ``priority`` is the request class, 0 (highest) to
        ``priorities - 1``.  ``stream=True`` opens ``req.stream`` (a
        :class:`_StreamHandle`; consume ``req.stream.events()``).
        ``stop`` (streaming only) is a list of token-id sequences that
        end generation with finish reason ``"stop"``.  ``emitted_prefix``
        is the resume form: the ORIGINAL prompt, ``n_steps`` and seed
        plus the tokens an interrupted run delivered; the continuation
        is the uninterrupted run's and its frames are numbered from
        ``len(emitted_prefix)``.  Raises :class:`EngineOverloaded` when
        the request is shed (queue or admission window full, nothing
        lower to displace; or the page pool cannot host it while slots
        are free).  ``batch=True`` rides the trough class below every
        priority (``priority`` is then ignored): refused with 429 while
        :meth:`trough_open` says no, outside the admission window,
        preempted first, and kept out of the SLO histograms."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        self._check_ids(prompt, "prompt")
        prompt = prompt.astype(np.int32)
        n_steps = int(n_steps)
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        pref = None
        if emitted_prefix is not None:
            pref = np.asarray(emitted_prefix, np.int64).reshape(-1)
            # at n_steps the resume would have nothing left to generate,
            # yet a prefill always samples one token
            if pref.size >= n_steps:
                raise ValueError(
                    f"emitted_prefix holds {pref.size} tokens but "
                    f"n_steps is {n_steps}; the resume form needs at "
                    "least one token left to generate (pass the "
                    "ORIGINAL n_steps, not the remainder)")
            self._check_ids(pref, "emitted_prefix")
            pref = pref.astype(np.int32)
        stop_seqs = ()
        if stop:
            stop_seqs = tuple(np.asarray(s, np.int32).reshape(-1)
                              for s in stop)
            if not stream:
                raise ValueError(
                    "stop sequences ride the streaming path (their "
                    "detection runs at flush time); pass stream=True")
            if len(stop_seqs) > 16:
                raise ValueError(
                    f"at most 16 stop sequences, got {len(stop_seqs)}")
            for s in stop_seqs:
                if not 1 <= s.size <= 32:
                    raise ValueError(
                        "each stop sequence must hold 1..32 tokens, "
                        f"got {s.size}")
        priority = int(priority)
        if batch:
            # the internal lowest class, one past the submittable range
            priority = self.priorities
        elif not 0 <= priority < self.priorities:
            raise ValueError(
                f"priority must be in [0, {self.priorities}) "
                f"(serve.priorities classes, 0 = highest), got {priority}")
        if top_k is not None and int(top_k) < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        if top_p is not None and not 0.0 < float(top_p) <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if prompt.size + n_steps > self.l_max:
            raise ValueError(
                f"prompt {prompt.size} + n_steps {n_steps} exceeds the "
                f"engine's l_max {self.l_max}")
        if self._draining:
            raise EngineDraining(
                "engine is draining; not accepting new requests")
        if self._died:
            raise SchedulerCrashed("engine scheduler crashed earlier; "
                                   "restart the engine")
        if not self.started:
            raise EngineStopped("engine is not running (call start())")
        if batch:
            # the trough gate: batch waits out interactive pressure; the
            # short hint, not _retry_after(): the trough reopens as soon
            # as a slot frees
            open_, why = self.trough_open()
            if not open_:
                self._count_shed(priority)
                self._m_requests.labels(outcome="429").inc()
                raise EngineOverloaded(
                    f"batch trough closed: {why}",
                    float(root.common.serve.jobs.get("trough_retry_s",
                                                     0.05)))
        req = _Request(prompt, n_steps, float(temperature),
                       None if top_k is None else int(top_k),
                       None if top_p is None else float(top_p),
                       None if eos_id is None else int(eos_id), int(seed),
                       time.monotonic() + (self.deadline_s
                                           if deadline_s is None
                                           else float(deadline_s)),
                       priority=priority, batch=batch)
        if pref is not None and pref.size:
            # the resume form IS the preemption resume state
            req.gen = pref
        req.stop_seqs = stop_seqs
        if stream:
            req.stream = self._acquire_stream(req)
        if self.paged:
            # pool backpressure while slots are free, the request's
            # cached prefix discounted; queueing when a lower-class slot
            # could be preempted for its pages
            eff = req.effective_prompt()
            need = self._page_span(eff.size, req.end_index - eff.size + 1)
            hashes = self._prefix_hashes(eff)
            req.page_hashes = hashes
            with self._page_lock:
                need -= self._prefix_hits_locked(hashes, eff.size)
                avail = self.pages - int(np.count_nonzero(self._page_ref))
            with self._qlock:
                free_slots = self.slots - int(self._active.sum())
                pool_bound = need > avail and free_slots > len(self._queue)
                if pool_bound and self.preempt and any(
                        r is not None and r.priority > priority
                        for r in self._slot_req):
                    pool_bound = False
            if pool_bound:
                with self._page_lock:
                    self._pool_rejected += 1
                self._count_shed(priority)
                self._m_requests.labels(outcome="429").inc()
                self._release_stream(req, "429")
                raise EngineOverloaded(
                    f"page pool exhausted ({avail} of {self.pages} "
                    f"pages free, request needs {need} beyond its "
                    "cached prefix)", self._retry_after())
        evicted = None
        with self._qlock:
            # the controller's window (priority-scaled) bounds what the
            # hard queue_depth bounds alone; a full queue lets the
            # arrival displace the youngest queued strictly-lower class
            qlen = len(self._queue)
            # batch bypasses the window (the trough gate is its
            # admission control) but not the hard queue depth
            limit = (self.queue_depth if batch
                     else min(self.queue_depth,
                              self._admission.allowance(priority)))
            overloaded = qlen >= limit
            if overloaded:
                evicted = self._queue.steal_lower(priority)
                if evicted is not None:
                    overloaded = False
            if not overloaded:
                self._queue.append(req)
        if evicted is not None:
            retry = self._retry_after()
            self._count_shed(evicted.priority)
            evicted.finish(error=EngineOverloaded(
                "shed from a full queue by a higher-priority arrival",
                retry))
            self._observe_finish(evicted, "429")
        if overloaded:
            self._count_shed(priority)
            self._m_requests.labels(outcome="429").inc()
            self._release_stream(req, "429")
            raise EngineOverloaded(
                f"admission window full ({qlen} pending, window "
                f"{limit} for class {priority} of "
                f"{self.queue_depth} hard depth)", self._retry_after())
        self._wake.set()
        return req

    def generate(self, prompt, n_steps: int, *, temperature: float = 0.0,
                 top_k=None, top_p=None, eos_id=None, seed: int = 0,
                 timeout: Optional[float] = None, priority: int = 0,
                 batch: bool = False):
        """Blocking batch decode with the ``generate()`` contract:
        (B, P) -> (B, P + n_steps) np.int32, rows past their eos padded
        with ``eos_id``.  Row r samples with ``row_seeds(seed, B)[r]``,
        as ``generate()`` does; every row rides class ``priority`` (the
        trough class with ``batch``)."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 2:
            raise ValueError("prompt must be (B, P)")
        B, P = prompt.shape
        seeds = row_seeds(seed, B)
        reqs = []
        try:
            for r in range(B):
                reqs.append(self.submit(
                    prompt[r], n_steps, temperature=temperature,
                    top_k=top_k, top_p=top_p, eos_id=eos_id,
                    seed=seeds[r], priority=priority, batch=batch))
            out = np.full((B, P + n_steps),
                          eos_id if eos_id is not None else 0, np.int32)
            for r, req in enumerate(reqs):
                if not req.done.wait(timeout):
                    raise TimeoutError("engine.generate timed out")
                if req.error is not None:
                    raise req.error
                out[r, :len(req.result)] = req.result
            return out
        except BaseException:
            # the batch's other rows must not keep decoding to discarded
            # results: an expired deadline retires them on the next sweep
            for req in reqs:
                if not req.done.is_set():
                    req.deadline = 0.0
            raise

    # -- stream handles ----------------------------------------------------
    def _acquire_stream(self, req: _Request) -> _StreamHandle:
        """Open the request's frame feed, numbered from its emitted
        prefix, and register it in the live set."""
        h = _StreamHandle(int(req.gen.size), int(req.prompt.size),
                          self.stream_buffer_tokens)
        with self._qlock:
            self._streams.add(h)
        return h

    def _release_stream(self, req: _Request, outcome: str):
        """Close and unregister the request's stream (no-op for unary
        requests): ok -> stop / eos / length, 504 -> deadline, anything
        else -> error."""
        h = req.stream
        if h is None:
            return
        err = None
        if outcome == "ok":
            gen_n = (0 if req.result is None
                     else int(req.result.size) - int(req.prompt.size))
            if req.stop_hit:
                reason = "stop"
            elif (req.eos_id is not None and gen_n
                    and gen_n < int(req.n_steps)
                    and int(req.result[-1]) == int(req.eos_id)):
                reason = "eos"
            else:
                reason = "length"
        elif outcome == "504":
            reason = "deadline"
            err = (str(req.error) if req.error is not None
                   else "request deadline expired")
        else:
            reason = "error"
            err = str(req.error) if req.error is not None else outcome
        h.close(reason, err)
        with self._qlock:
            self._streams.discard(h)

    def _observe_finish(self, req: _Request, outcome: str):
        """Every terminal edge: the stream closes, the outcome counts,
        and the request's timeline enters the span ring (engine.py:
        1612-1658): one ``request`` span on the request's own track with
        its queue-wait, prefill and decode children."""
        self._release_stream(req, outcome)
        self._m_requests.labels(outcome=outcome).inc()
        sub = req.submitted_at
        fin = req.finished_at if req.finished_at is not None \
            else time.monotonic()
        ring = span_ring()
        args = {"id": req.trace_id, "outcome": outcome,
                "prompt_tokens": int(req.prompt.size),
                "n_steps": int(req.n_steps)}
        if req.batch:
            args["batch"] = True
        elif req.priority:
            args["priority"] = int(req.priority)
        if req.preemptions:
            args["preemptions"] = int(req.preemptions)
        if req.slot is not None:
            args["slot"] = int(req.slot)
        if self.paged and req.admitted_at is not None:
            args["prefix_start"] = int(req.prefix_start)
        ring.add("request", sub, fin - sub, cat="request",
                 tid=req.trace_id, args=args)
        if req.admitted_at is None:
            ring.add("queue_wait", sub, fin - sub, cat="serve",
                     tid=req.trace_id)
            return
        ring.add("queue_wait", sub, req.admitted_at - sub, cat="serve",
                 tid=req.trace_id)
        if req.first_token_at is not None:
            ring.add("prefill", req.admitted_at,
                     req.first_token_at - req.admitted_at, cat="serve",
                     tid=req.trace_id)
            ring.add("decode", req.first_token_at,
                     fin - req.first_token_at, cat="serve",
                     tid=req.trace_id)

    # -- stats -------------------------------------------------------------
    def _count(self, key: str, n: int = 1):
        with self._stats_lock:
            self._n[key] += n

    def _count_shed(self, priority: int):
        """One shed in every ledger: rejected, shed by class, the
        ``vt_shed_total`` series.  Takes ``_qlock``: call outside it."""
        self._count("rejected")
        self._m_shed.labels(priority=str(priority)).inc()
        with self._qlock:
            self._shed_by_class[priority] = \
                self._shed_by_class.get(priority, 0) + 1

    def _retry_after(self) -> float:
        """429 Retry-After from actual congestion: queued decode work
        over recent throughput, floored by the queue-wait EWMA, scaled by
        how far the admission window is closed; in [1, 60] s
        (engine.py:2560-2577)."""
        with self._qlock:
            queued = sum(r.n_steps for r in self._queue) or 1
        est = max(queued / max(self._tokens_per_s, 1.0), self._qwait_ewma)
        est *= self._admission.backoff_factor()
        return min(60.0, max(1.0, est))

    def _pages_summary(self) -> Optional[dict]:
        if not self.paged:
            return None
        with self._page_lock:
            used = int(np.count_nonzero(self._page_ref))
            cached = sum(1 for pid in self._page_key
                         if self._page_ref[pid] == 0)
            hit, miss = self._prefix_hit_pages, self._prefix_miss_pages
            evictions, cow = self._evictions, self._cow_admissions
            rejected = self._pool_rejected
        lookups = hit + miss
        return {"page_size": self.page_size, "pages": self.pages,
                "used": used, "cached": cached,
                "free": self.pages - used - cached,
                "prefix_hit_pages": hit, "prefix_miss_pages": miss,
                "prefix_hit_rate": round(hit / lookups, 3) if lookups
                else 0.0,
                "prefix_tokens_reused": hit * self.page_size,
                "evictions": evictions, "cow_admissions": cow,
                "pool_rejected": rejected}

    def stats(self) -> dict:
        with self._stats_lock:
            n = dict(self._n)
            ttft = list(self._ttft)
            steps = list(self._step_s)
            wall = self._decode_wall
            verify_wall = self._verify_wall
            replays = {name: self._replays[name] for name in self._fns
                       if name != "prefill"}
        with self._qlock:
            qlen = len(self._queue)
            shed = {str(k): v for k, v in sorted(self._shed_by_class.items())}
            streams = len(self._streams)
        compile_ = self.step_cache.stats()
        capture = {kind: (compile_[kind] if self.paged else
                          {"captured": False, "reason": "dense layout"})
                   for kind in self._fns}
        out = {
            "device": str(self.device),
            "slots": self.slots, "l_max": self.l_max,
            "occupancy": int(self._active.sum()),
            "queue_depth": qlen, "queue_limit": self.queue_depth,
            "in_flight": self._in_flight(),
            "admitted": n.get("admitted", 0),
            "retired": n.get("retired", 0),
            "rejected": n.get("rejected", 0),
            "timeouts": n.get("timeouts", 0),
            "decode_steps": n.get("decode_steps", 0),
            "dispatches": n.get("dispatches", 0),
            # token-advancing dispatches by program (kind, and kind +
            # "_greedy" where no live slot sampled)
            "replays": replays,
            "decode_tokens": n.get("decode_tokens", 0),
            "prefill_tokens": n.get("prefill_tokens", 0),
            "prefill_calls": n.get("prefill_calls", 0),
            "decode_seconds": wall,
            "decode_tokens_per_s": (n.get("decode_tokens", 0) / wall
                                    if wall > 0 else 0.0),
            "ttft_s_mean": float(np.mean(ttft)) if ttft else None,
            "ttft_s_max": float(np.max(ttft)) if ttft else None,
            # the gap between a slot's output tokens is one decode step
            "decode_step_s_p50": (float(np.median(steps)) if steps
                                  else None),
            "decode_step_s_max": float(np.max(steps)) if steps else None,
            "paged": self.paged, "paged_kernel": self.paged_kernel,
            "cache_dtype": str(self._cache_dtype).replace("torch.", ""),
            "streams": streams,
            "swaps": self._swaps, "draining": self._draining,
            "swap_in_flight": self.last_swap_in_flight,
            "scheduler_crashed": self._died,
            "memory": dict(self._mem_bytes),
            "admission": {**self._admission.state(),
                          "priorities": self.priorities,
                          "preempt": self.preempt,
                          "prefill_chunk": self.prefill_chunk,
                          "preemptions": n.get("preemptions", 0),
                          "shed_by_class": shed},
            "compile": compile_, "capture": capture,
        }
        if self.spec:
            proposed = n.get("spec_proposed", 0)
            accepted = n.get("spec_accepted", 0)
            out["spec"] = {"k": self.spec_k, "drafter": self.spec_drafter,
                           "proposed": proposed, "accepted": accepted,
                           "verify_steps": n.get("verify_steps", 0),
                           "accept_rate": round(accepted / max(proposed, 1),
                                                4),
                           # tokens the verify steps emitted, their wall
                           "emitted": n.get("spec_emitted", 0),
                           "verify_seconds": verify_wall}
        if self.megastep > 1:
            out["megastep"] = {"n": self.megastep,
                               "mega_dispatches": n.get("mega_dispatches", 0)}
        pages = self._pages_summary()
        out["goodput"] = self._goodput_summary()
        out["headroom_slots"] = self._headroom_slots(pages)
        if pages is not None:
            out["pages"] = pages
            out["kv_transfer"] = self._kv_transfer_summary()
        # the batch lane: the gate now, and the throughput the SLO
        # histograms never see
        out["batch"] = {
            "trough_open": self._trough_open_for(out["headroom_slots"])[0],
            "tokens_generated": self._batch_tok_n,
            "tokens_per_sec": round(self._batch_tok_s, 1),
            "preemptions": n.get("batch_preemptions", 0)}
        return out

    # -- goodput -------------------------------------------------------------
    def _dispatch_bytes(self, pending) -> float:
        """Counted bytes of the token dispatches ``[(program, pos,
        active)]``: each program's count, its paged-kernel part (counted
        at the positions of the run that counted it) replaced by the
        kernel's ``cost`` at the dispatch's positions, each micro-step a
        position further for every slot ``active`` at the start (a slot
        that retires inside the block is counted on).  One ``cost`` a
        layer prices every row of the dispatches at once."""
        total, rows, costs = 0.0, [], {}
        for name, pos, active in pending:
            c = costs.get(name)
            if c is None:
                c = costs[name] = self.step_cache.program_cost(name)
            pk = c["kernels"].get(_paged.NAME)
            total += c["bytes_accessed"] - (pk["bytes"] if pk else 0.0)
            if pk:
                n = self._micro_steps[name.removesuffix("_greedy")]
                rows.append(np.minimum(
                    pos[None, :] + np.arange(n)[:, None]
                    * active.astype(np.int64), self.l_max - 1).reshape(-1))
        if rows:
            rows = np.concatenate(rows)
            for u in self.plan._attn_units:
                ck = self._caches[u.name]["k"]
                q = torch.empty((rows.size, u.n_heads, ck.shape[3]),
                                device="meta")
                total += _paged.cost(q, ck, rows, page_size=self.page_size,
                                     window=u.window)["bytes"]
        return total

    def _fold_bandwidth(self) -> None:
        """Price the token dispatches since the last read: their bytes
        over their summed wall become the achieved bytes/s.  (The
        reference's per-dispatch EWMA would need each dispatch priced
        alone; an EWMA across reads, 0.25 s apart, would lag a load by
        seconds.)"""
        with self._stats_lock:
            pending, self._bw_pending = self._bw_pending, []
            wall, self._bw_wall = self._bw_wall, 0.0
        if not pending:
            return
        self._bw_rate = self._dispatch_bytes(pending) / max(wall, 1e-9)

    def _goodput_summary(self) -> dict:
        """Decode goodput: achieved memory traffic per second against the
        configured HBM peak (model-bandwidth-utilization) and tokens/s
        per device; the bandwidth reads 0 once no token step ran for 2 s
        instead of freezing at the last load's value."""
        self._fold_bandwidth()
        idle = (self._last_step_at <= 0
                or time.monotonic() - self._last_step_at > 2.0)
        bw = 0.0 if idle else self._bw_rate
        peak_gbps = float(
            root.common.observe.get("peak_hbm_gbps", 0.0) or 0.0)
        # the sampling program's count, else the greedy-only one's: they
        # differ by elementwise ops, which count nothing
        c = self.step_cache.program_cost("decode")
        if not c["flops"]:
            c = self.step_cache.program_cost("decode_greedy")
        return {
            "decode_step_flops": c["flops"],
            "decode_step_bytes": c["bytes_accessed"],
            "decode_step_wall_ewma_s": round(self._step_wall_ewma, 6),
            "decode_bandwidth_bytes_per_sec": round(bw, 1),
            # six significant digits: a fixed 5 decimals lost up to
            # 1.5e-3 of a small MBU (the gauge must read bw / peak)
            "decode_mbu": float(f"{bw / (peak_gbps * 1e9):.6g}")
            if peak_gbps > 0 else 0.0,
            # one engine drives one card
            "tokens_per_sec_per_chip": round(
                self._tokens_per_s if not idle else 0.0, 2),
        }

    def _headroom_slots(self, pages: Optional[dict]) -> int:
        """Max-length requests admissible now: free slots, bounded (paged)
        by how many max-length page spans the pool still holds (cached
        refcount-0 pages count: the allocator evicts them on demand)."""
        free_slots = self.slots - int(self._active.sum())
        if pages is None:
            return max(free_slots, 0)
        avail = pages["free"] + pages["cached"]
        return max(min(free_slots, avail // max(self.n_ptab, 1)), 0)

    def trough_open(self):
        """The batch lane's gate -> ``(open, reason)``: open while at
        least ``serve.jobs.min_headroom_slots`` max-length requests are
        admissible (the headroom gauge) and the windowed SLO burn is at
        most ``serve.jobs.burn_ceiling``, which sits below the
        interactive shed threshold, so batch yields before any
        interactive class pays (engine.py:2373-2389)."""
        return self._trough_open_for(
            self._headroom_slots(self._pages_summary()))

    def _trough_open_for(self, headroom: int):
        """The gate on an already-computed headroom (engine.py:
        2391-2410)."""
        jobs_cfg = root.common.serve.jobs
        min_headroom = int(jobs_cfg.get("min_headroom_slots", 1))
        burn_ceiling = float(jobs_cfg.get("burn_ceiling", 1.0))
        if headroom < min_headroom:
            return False, (f"headroom {headroom} slots < "
                           f"serve.jobs.min_headroom_slots {min_headroom}")
        burn = self._admission.last_burn()
        if burn > burn_ceiling:
            return False, (f"SLO burn {burn:.2f} > serve.jobs.burn_ceiling "
                           f"{burn_ceiling}")
        return True, "ok"

    # -- scheduler ---------------------------------------------------------
    def _loop(self):
        ctx = (torch.cuda.stream(self._stream) if self._stream is not None
               else contextlib.nullcontext())
        try:
            with ctx:
                while not self._stop_evt.is_set():
                    # the SLO windows rotate and the admission controller
                    # evaluates on the scheduler's heartbeat
                    self._slo.tick()
                    self._admission.tick()
                    self._publish_gauges()
                    self._maybe_report()
                    if faults.enabled():
                        self._inject_faults()
                    # a step boundary: a staged weight swap flips here,
                    # and staged KV-page imports land (the scheduler
                    # thread writes every served tensor and cache)
                    self._apply_swap()
                    self._apply_kv_imports()
                    with self._qlock:
                        pending = bool(self._queue)
                    if not self._active.any() and not pending \
                            and not self._chunking:
                        self._wake.wait(timeout=0.05)
                        self._wake.clear()
                        continue
                    if not self._active.any() and not self._chunking \
                            and self.window_s > 0:
                        # batching window: concurrent arrivals are
                        # admitted together and share the first steps
                        time.sleep(self.window_s)
                    self._expire_queue()
                    self._admit()
                    # one bounded slice per mid-prefill slot, then one
                    # decode step: a long prompt and decoding take turns
                    self._advance_prefills()
                    if self._active.any():
                        self._advance_once()
        except Exception as e:  # noqa: BLE001 — a dead scheduler must
            # fail pending work loudly, not hang every client
            self._died = True
            self.exception("decode engine scheduler died")
            if self.status is not None:
                try:
                    self.status.record_event(
                        "scheduler_crash",
                        error=f"{type(e).__name__}: {e}")
                except Exception:  # noqa: BLE001 — status must never
                    pass           # mask the crash
            self._fail_all(SchedulerCrashed(
                f"engine scheduler crashed: {type(e).__name__}: {e}"))
        finally:
            # a swap staged during shutdown still flips, and staged
            # imports drain, so their callers do not wait out a timeout
            self._apply_swap()
            self._apply_kv_imports()
            self._fail_all(EngineStopped("engine stopped"))

    def _inject_faults(self):
        """The serving fault knobs' scheduler-side injection points
        (``runtime/faults.py``): a synthetic lowest-class burst straight
        into the queue, and a crash at an iteration with work pending;
        each once per arming."""
        plan = faults.get_plan()
        if plan.admission_burst and faults.fire_once("admission_burst"):
            self._inject_burst(plan.admission_burst)
        with self._qlock:
            pending = bool(self._queue)
        if (pending or self._active.any()) and plan.scheduler_crash \
                and faults.fire_once("scheduler_crash"):
            raise faults.FaultInjected("injected decode-scheduler crash")

    def _inject_burst(self, n: int):
        """``n`` minimal lowest-class requests appended to the queue,
        bypassing ``submit``'s shed gate (engine.py:2845-2859): nobody
        waits on them; they decode and retire like any request."""
        for _ in range(int(n)):
            r = _Request(np.asarray([0], np.int32), 2, 0.0, None, None,
                         None, 0, time.monotonic() + self.deadline_s,
                         priority=self.priorities - 1)
            with self._qlock:
                self._queue.append(r)

    def _maybe_report(self):
        """Every 0.5 s: the engine's stats into the status reporter."""
        now = time.monotonic()
        if self.status is None or now - self._status_mark < 0.5:
            return
        self._status_mark = now
        try:
            self.status.update(engine=self.stats())
        except Exception:  # noqa: BLE001 — status must never take the
            pass           # engine down

    def _fail_all(self, err: Exception):
        outcome = "crash" if isinstance(err, SchedulerCrashed) \
            else "stopped"
        with self._qlock:
            pending = list(self._queue)
            self._queue.clear()
        for req in pending:
            req.finish(error=err)
            self._observe_finish(req, outcome)
        for s, req in enumerate(self._slot_req):
            if req is not None:
                req.finish(error=err)
                self._slot_req[s] = None
                self._observe_finish(req, outcome)
            self._release_slot_pages(s)
        self._chunking.clear()
        self._active[:] = False

    def _timeout(self, req: _Request, where: str):
        self._count("timeouts")
        req.finish(error=TimeoutError(
            f"request deadline expired {where}"))
        self._observe_finish(req, "504")

    def _expire_queue(self):
        now = time.monotonic()
        with self._qlock:
            expired = self._queue.remove_if(lambda r: now > r.deadline)
        for r in expired:
            self._timeout(r, "while queued")

    def _free_slot(self) -> Optional[int]:
        """A slot neither decoding nor mid-(chunked-)prefill."""
        for s in range(self.slots):
            if not self._active[s] and self._slot_req[s] is None:
                return s
        return None

    def _pick_victim(self, priority: int) -> Optional[int]:
        """The occupied slot of the lowest class strictly below
        ``priority``, the youngest run among ties; None when preemption
        is off or nothing lower runs.  A running batch request holds the
        lowest class of all, so it is always the first victim."""
        if not self.preempt:
            return None
        best, best_key = None, None
        for s in range(self.slots):
            req = self._slot_req[s]
            if req is None or req.priority <= priority:
                continue
            k = (req.priority, req.run_started_at or 0.0)
            if best is None or k > best_key:
                best, best_key = s, k
        return best

    def _preempt_can_free(self, req) -> bool:
        """Could preempting every strictly-lower-class slot free enough
        pages for ``req``?  False means preemption can never satisfy it:
        requeue instead of evicting victims for nothing."""
        eff = req.effective_prompt()
        P = int(eff.size)
        need = self._page_span(P, req.end_index - P + 1)
        hashes = req.page_hashes or self._prefix_hashes(eff)
        reclaimable = set()
        for s in range(self.slots):
            r = self._slot_req[s]
            if r is not None and r.priority > req.priority:
                reclaimable.update(int(p) for p in np.unique(self._ptab[s])
                                   if p != self._scratch)
        with self._page_lock:
            need -= self._prefix_hits_locked(hashes, P)
            avail = self.pages - int(np.count_nonzero(self._page_ref))
        return need <= avail + len(reclaimable)

    def _preempt(self, slot: int):
        """Retire-and-requeue the slot for a higher class: harvest its
        generated tokens into ``req.gen`` (the resume re-prefills prompt
        + gen), release its pages, requeue it at the front of its
        class."""
        req = self._slot_req[slot]
        if self._active[slot]:
            eff_len = int(req.prompt.size) + int(req.gen.size)
            fresh = self._toks[slot, eff_len:int(self._pos[slot]) + 1]
            if fresh.size:
                req.gen = np.concatenate([req.gen, fresh.astype(np.int32)])
        self._active[slot] = False
        self._chunking.discard(slot)
        self._slot_req[slot] = None
        self._release_slot_pages(slot)
        req.slot = None
        req.page_row = None
        req.prefix_start = 0
        req.page_hashes = ()
        req.chunk_next = 0
        req._eff = None                 # the prompt grew by the harvest
        req.preemptions += 1
        self._count("preemptions")
        self._m_preempt.inc()
        if req.batch:
            # the batch lane yielding to interactive work
            self._count("batch_preemptions")
            self._m_batch_preempt.inc()
        with self._qlock:
            self._queue.appendleft(req)

    def _admit(self) -> int:
        """Move queued requests into free slots; when the head of the
        queue outranks a running slot and no capacity is free (slots, or
        pages), preempt.  Returns the number admitted."""
        n = 0
        while True:
            with self._qlock:
                req = self._queue.popleft()
            if req is None:
                return n
            if time.monotonic() > req.deadline:
                self._timeout(req, "while queued")
                continue
            if req.batch and not self.trough_open()[0]:
                # batch that queued in a lull waits out the burst that
                # came since; it is the lowest class, so nothing
                # interactive is queued behind it
                with self._qlock:
                    self._queue.appendleft(req)
                return n
            slot = self._free_slot()
            if slot is None:
                victim = self._pick_victim(req.priority)
                if victim is None or (
                        self.paged and not self._preempt_can_free(req)):
                    with self._qlock:
                        self._queue.appendleft(req)
                    return n
                self._preempt(victim)
                slot = self._free_slot()
            while self.paged and not self._reserve_pages(req):
                # pages free as slots retire; deadlines bound the wait
                victim = self._pick_victim(req.priority)
                if victim is None or not self._preempt_can_free(req):
                    with self._qlock:
                        self._queue.appendleft(req)
                    return n
                self._preempt(victim)
            self._prefill(int(slot), req)
            n += 1

    # -- page pool (the scheduler thread mutates; _page_lock guards the
    # cross-thread reads in submit() and stats()) --------------------------
    def _touch(self, pid: int):  # requires-lock: self._page_lock
        self._tick += 1
        self._page_tick[pid] = self._tick

    def _page_span(self, P: int, n_steps: int) -> int:
        """Pages a request can ever reference: KV lands at positions
        0 .. P + n_steps - 2 (the final token's KV is never computed)."""
        return -(-(int(P) + int(n_steps) - 1) // self.page_size)

    def _prefix_hashes(self, prompt):
        if not self._prefix_ok:
            return []
        return prefix_page_hashes(prompt, self.page_size)

    def _prefix_hits_locked(self, hashes, P: int) -> int:  # requires-lock: self._page_lock
        """Leading pages already in the prefix index, capped so at least
        the prompt's last token is recomputed (its logits give the first
        token)."""
        hits = 0
        for h in hashes:
            if h not in self._prefix_index:
                break
            hits += 1
        while hits and hits * self.page_size > P - 1:
            hits -= 1
        return hits

    def _reserve_pages(self, req) -> bool:
        """Map the request onto the pool: its prefix hits shared
        read-only (refcount + 1), fresh pages for the rest of its span.
        Sets ``page_row`` / ``prefix_start`` / ``page_hashes``; on a
        shortage rolls back and returns False."""
        psz = self.page_size
        eff = req.effective_prompt()
        P = int(eff.size)
        need = self._page_span(P, req.end_index - P + 1)
        hashes = req.page_hashes or self._prefix_hashes(eff)
        with self._page_lock:
            hits = self._prefix_hits_locked(hashes, P)
            row = np.full(self.n_ptab, self._scratch, np.int32)
            taken = []
            remote = 0
            for i in range(hits):
                pid = self._prefix_index[hashes[i]]
                self._page_ref[pid] += 1
                self._touch(pid)
                row[i] = pid
                taken.append(pid)
                remote += pid in self._imported_pages
            for i in range(hits, need):
                pid = self._alloc_page_locked()
                if pid is None:          # shortage: roll back, requeue
                    for p in taken:
                        self._page_ref[p] -= 1
                        if self._page_ref[p] <= 0:
                            self._page_ref[p] = 0
                            if p not in self._page_key:
                                self._page_free.append(p)
                    return False
                row[i] = pid
                taken.append(pid)
            self._prefix_hit_pages += hits
            self._prefix_miss_pages += max(P // psz - hits, 0)
            # hits on pages a peer prefilled and shipped (import_pages)
            self._remote_hit_pages += remote
            if hits:
                # copy-on-write admission: the shared prefix is mapped
                # read-only, the first divergent page on is private
                self._cow_admissions += 1
        req.page_row = row
        req.prefix_start = hits * psz
        req.page_hashes = hashes
        return True

    def _alloc_page_locked(self):  # requires-lock: self._page_lock
        """A free page, else the least recently used cached page
        (refcount 0, still in the prefix index) evicted; None when the
        pool is exhausted."""
        if self._page_free:
            pid = self._page_free.pop()
        else:
            pid, best_tick = None, None
            for p in self._page_key:
                if self._page_ref[p] == 0 and (
                        pid is None or self._page_tick[p] < best_tick):
                    pid, best_tick = p, self._page_tick[p]
            if pid is None:
                return None
            del self._prefix_index[self._page_key.pop(pid)]
            self._evictions += 1
        self._page_ref[pid] = 1
        self._imported_pages.discard(pid)
        self._touch(pid)
        return pid

    def _register_prefix_pages(self, req):
        """After a prefill: publish the request's freshly computed FULL
        prompt pages in the prefix index.  Pages holding the prompt's
        partial tail or generated tokens stay private."""
        full = int(req.effective_prompt().size) // self.page_size
        hits = req.prefix_start // self.page_size
        with self._page_lock:
            for i in range(hits, min(full, len(req.page_hashes))):
                h = req.page_hashes[i]
                pid = int(req.page_row[i])
                if h not in self._prefix_index:
                    self._prefix_index[h] = pid
                    self._page_key[pid] = h
                self._touch(pid)

    def _release_slot_pages(self, slot: int):
        """Drop the slot's references; a refcount-0 page returns to the
        free list unless the prefix index still caches it."""
        if not self.paged:
            return
        with self._page_lock:
            for pid in self._ptab[slot]:
                pid = int(pid)
                if pid == self._scratch:
                    continue
                self._page_ref[pid] -= 1
                if self._page_ref[pid] <= 0:
                    self._page_ref[pid] = 0
                    if pid not in self._page_key:
                        self._page_free.append(pid)
        self._ptab[slot] = self._scratch

    # -- KV-page transfer (engine.py:3028-3362): magic + length-prefixed
    # JSON header (page size, weights version, each cache entry's dtype
    # and row shape, each page's hash and sha256) + the raw page rows;
    # pages are named by the prefix index's chained hashes, so an
    # imported page is the page a local prefill computes ---------------
    def _require_transfer(self):
        """Transfer needs content-addressed pages: a dense engine and a
        chain without prefix reuse refuse (REST 400)."""
        if not self.paged:
            raise ValueError(
                "KV-page transfer requires the paged KV layout "
                "(serve.paged=True); dense caches have no "
                "content-addressed pages to ship")
        if not self._prefix_ok:
            raise ValueError(
                "KV-page transfer requires prefix reuse, which recurrent "
                "units disable (their cache content is not a pure "
                "function of a whole-page prompt prefix)")

    @property
    def kv_wver(self) -> str:
        """The weights version stamped into every blob: the parameter
        tree's signature hash (framework named) and the hot-swap count;
        import refuses any other."""
        return f"{self._kv_sig}.{self._swaps}"

    def _kv_xfer_entries(self) -> list:
        """Per-entry wire layout ``(name, part, dtype, row_shape)`` over
        the attention caches in sorted order (the JAX package's)."""
        return [(name, part,
                 str(self._caches[name][part].dtype).replace("torch.", ""),
                 tuple(int(d) for d in self._caches[name][part].shape[1:]))
                for name in sorted(self.plan.attn_keys())
                for part in ("k", "v")]

    def _kv_page_bytes(self) -> int:
        """Wire payload bytes of one page (every cache entry)."""
        return sum(self._caches[n][p][0].numel()
                   * self._caches[n][p].element_size()
                   for n, p, _dt, _s in self._kv_xfer_entries())

    @staticmethod
    def _norm_hash(h) -> bytes:
        """Raw sha256 digests inside, hex on the wire and in queries."""
        return bytes.fromhex(h) if isinstance(h, str) else bytes(h)

    def hot_page_hashes(self, k: int) -> list:
        """The K hottest cached prefix pages (refcount, then recency,
        descending) as raw digests."""
        self._require_transfer()
        with self._page_lock:
            ranked = sorted(self._page_key.items(),
                            key=lambda it: (int(self._page_ref[it[0]]),
                                            int(self._page_tick[it[0]])),
                            reverse=True)
            return [h for _pid, h in ranked[:max(int(k), 0)]]

    def export_pages(self, prefix_hashes) -> bytes:
        """The requested prefix pages that are resident (others are
        omitted) in the wire format.  The pages are pinned (refcount + 1)
        for the read, so eviction cannot recycle one mid-read; a
        registered page is written only by its own prefill."""
        self._require_transfer()
        t0 = time.monotonic()
        pinned = []
        with self._page_lock:
            seen = set()
            for h in prefix_hashes:
                h = self._norm_hash(h)
                pid = self._prefix_index.get(h)
                if pid is None or h in seen:
                    continue
                seen.add(h)
                self._page_ref[pid] += 1
                self._touch(pid)
                pinned.append((h, pid))
        try:
            entries = self._kv_xfer_entries()
            rows = []
            if pinned:
                idx = torch.as_tensor([pid for _h, pid in pinned],
                                      device=self.device)
                rows = [self._caches[n][p].index_select(0, idx).cpu()
                        .view(torch.uint8).reshape(len(pinned), -1).numpy()
                        for n, p, _dt, _s in entries]
            pages, payload = [], bytearray()
            for i, (h, _pid) in enumerate(pinned):
                page = b"".join(r[i].tobytes() for r in rows)
                pages.append({"hash": h.hex(),
                              "sha256": hashlib.sha256(page).hexdigest()})
                payload += page
        finally:
            with self._page_lock:
                for _h, pid in pinned:
                    self._page_ref[pid] -= 1
                    if self._page_ref[pid] <= 0:
                        self._page_ref[pid] = 0
                        if pid not in self._page_key:
                            self._page_free.append(pid)
        hdr = json.dumps({
            "page_size": self.page_size, "wver": self.kv_wver,
            "entries": [[n, p, dt, list(sh)] for n, p, dt, sh in entries],
            "pages": pages}).encode()
        blob = _KV_MAGIC + len(hdr).to_bytes(4, "little") + hdr \
            + bytes(payload)
        with self._page_lock:
            self._kv_exported_pages += len(pinned)
            self._kv_export_bytes += len(blob)
        self._m_kv_exported.inc(len(pinned))
        self._m_kv_bytes.labels(direction="out").inc(len(blob))
        self._m_kv_seconds.labels(direction="out").observe(
            time.monotonic() - t0)
        return blob

    def _decode_pages_blob(self, blob) -> list:
        """Validate a blob against the local geometry and weights
        version: ``[(hash, [row tensors in entry order]), ...]`` on the
        host.  Every defect raises ValueError (REST 400): a page of other
        KV entering the prefix index would break bitwise serving for
        every request that hits it."""
        blob = bytes(blob)
        if blob[:len(_KV_MAGIC)] != _KV_MAGIC:
            raise ValueError("not a KV-page blob (bad magic)")
        off = len(_KV_MAGIC)
        if len(blob) < off + 4:
            raise ValueError("truncated KV-page blob (no header)")
        n = int.from_bytes(blob[off:off + 4], "little")
        off += 4
        try:
            hdr = json.loads(blob[off:off + n].decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"corrupt KV-page header: {e}") from e
        if not isinstance(hdr, dict):
            raise ValueError("corrupt KV-page header: not an object")
        off += n
        if hdr.get("page_size") != self.page_size:
            raise ValueError(
                f"page_size mismatch: blob {hdr.get('page_size')} vs "
                f"local {self.page_size}")
        if str(hdr.get("wver")) != self.kv_wver:
            raise ValueError(
                f"weights-version mismatch: blob {hdr.get('wver')!r} vs "
                f"local {self.kv_wver!r} — pages computed under other "
                "weights (or by another framework) cannot serve here")
        entries = self._kv_xfer_entries()
        if hdr.get("entries") != [[n_, p, dt, list(sh)]
                                  for n_, p, dt, sh in entries]:
            raise ValueError(
                "cache-entry layout mismatch (names/dtypes/shapes differ "
                "from the local paged caches)")
        sizes = [(self._caches[n_][p].dtype, sh,
                  self._caches[n_][p][0].numel()
                  * self._caches[n_][p].element_size())
                 for n_, p, _dt, sh in entries]
        page_bytes = sum(sz for _d, _s, sz in sizes)
        pages_hdr = hdr.get("pages") or []
        if not isinstance(pages_hdr, list) or not all(
                isinstance(m, dict) for m in pages_hdr):
            raise ValueError("corrupt KV-page header: pages")
        if len(blob) - off != page_bytes * len(pages_hdr):
            raise ValueError(
                f"payload size mismatch: {len(blob) - off} bytes for "
                f"{len(pages_hdr)} pages of {page_bytes}")
        out = []
        for meta in pages_hdr:
            page = blob[off:off + page_bytes]
            off += page_bytes
            if hashlib.sha256(page).hexdigest() != meta.get("sha256"):
                raise ValueError("page integrity check failed for "
                                 f"{meta.get('hash')!r}")
            try:
                h = self._norm_hash(str(meta.get("hash")))
            except ValueError as e:
                raise ValueError(f"corrupt page hash: {e}") from e
            rows, p_off = [], 0
            for dt, sh, sz in sizes:
                raw = np.frombuffer(page, np.uint8, sz, p_off).copy()
                rows.append(torch.from_numpy(raw).view(dt).reshape(sh))
                p_off += sz
            out.append((h, rows))
        return out

    def import_pages(self, blob, *, timeout: float = 30.0) -> dict:
        """A peer's prefix pages into the local pool.  Validation is
        all-or-nothing (ValueError, the pool untouched); the apply is per
        page: resident hashes are skipped, and a page is dropped when
        every pool page is referenced.  The writes land on the scheduler
        thread at a step boundary (inline on a stopped engine), into the
        pool tensors the captured steps read; imported pages enter the
        prefix index at refcount 0, cached and evictable."""
        self._require_transfer()
        t0 = time.monotonic()
        # the weights version the blob is validated against, read first:
        # a swap that flips before the scheduler applies the pages makes
        # them stale (one that flips during the check refuses them too)
        wver = self.kv_wver
        pages = self._decode_pages_blob(blob)
        box = {"applied": None, "error": None}
        done = threading.Event()
        with self._kv_import_lock:
            self._kv_imports.append((pages, box, done, wver))
        if self.started:
            self._wake.set()
        else:
            self._apply_kv_imports()
        deadline = time.monotonic() + float(timeout)
        while not done.wait(0.05):
            if not self.started:
                # stopped between the enqueue and its drain: apply here
                self._apply_kv_imports()
            elif time.monotonic() > deadline:
                raise TimeoutError(
                    f"KV-page import not applied within {timeout}s "
                    "(scheduler wedged?)")
        if box["error"]:
            raise ValueError(f"KV-page import failed: {box['error']}")
        imported, skipped, dropped, hashes = box["applied"]
        with self._page_lock:
            self._kv_imported_pages += imported
            self._kv_import_bytes += len(blob)
        self._m_kv_imported.inc(imported)
        self._m_kv_bytes.labels(direction="in").inc(len(blob))
        self._m_kv_seconds.labels(direction="in").observe(
            time.monotonic() - t0)
        return {"imported": imported, "skipped": skipped,
                "dropped": dropped, "hashes": [h.hex() for h in hashes]}

    def _apply_kv_imports(self):
        """Drain the staged imports: per page skip a resident hash, claim
        a pool page, write its rows into the pool tensors in place
        (index copy: a captured graph keeps reading the same tensors),
        publish it in the prefix index.  A failed write returns the page
        and fails that import's caller, never the scheduler.  An import
        validated under weights a hot swap has since replaced is refused
        whole: its pages hold the old weights' KV (the swap dropped the
        prefix cache for that reason)."""
        while True:
            with self._kv_import_lock:
                if not self._kv_imports:
                    return
                pages, box, done, wver = self._kv_imports.popleft()
            imported = skipped = dropped = 0
            hashes = []
            if wver != self.kv_wver:
                box["error"] = (f"weights-version changed from {wver} to "
                                f"{self.kv_wver} before the import applied")
                box["applied"] = (0, 0, 0, [])
                done.set()
                continue
            entries = self._kv_xfer_entries()
            try:
                for h, rows in pages:
                    with self._page_lock:
                        pid = self._prefix_index.get(h)
                        if pid is not None:
                            self._touch(pid)
                            skipped += 1
                            hashes.append(h)
                            continue
                        pid = self._alloc_page_locked()
                    if pid is None:     # every page referenced: stays cold
                        dropped += 1
                        continue
                    try:
                        with torch.no_grad():
                            for (n, p, _dt, _sh), row in zip(entries, rows):
                                self._caches[n][p][pid].copy_(row)
                    except Exception:
                        with self._page_lock:
                            self._page_ref[pid] = 0
                            self._page_free.append(pid)
                        raise
                    with self._page_lock:
                        self._page_ref[pid] = 0
                        self._prefix_index[h] = pid
                        self._page_key[pid] = h
                        self._imported_pages.add(pid)
                        self._touch(pid)
                    imported += 1
                    hashes.append(h)
            except Exception as e:  # noqa: BLE001 — the importer's call
                # fails, the shared scheduler does not
                box["error"] = f"{type(e).__name__}: {e}"
            box["applied"] = (imported, skipped, dropped, hashes)
            done.set()

    def _kv_transfer_summary(self) -> dict:
        """``stats()["kv_transfer"]``: volume, remote hits, wire bytes a
        page and the weights version."""
        with self._page_lock:
            out = {"exported_pages": self._kv_exported_pages,
                   "imported_pages": self._kv_imported_pages,
                   "export_bytes": self._kv_export_bytes,
                   "import_bytes": self._kv_import_bytes,
                   "remote_hit_pages": self._remote_hit_pages}
        out["page_bytes"] = self._kv_page_bytes() if self._prefix_ok else 0
        out["prefill_tok_s"] = round(self._prefill_tok_s, 1)
        out["wver"] = self.kv_wver
        return out

    # -- device work -------------------------------------------------------
    def _prefill(self, slot: int, req: _Request):
        """Admit ``req`` into ``slot``: its un-shared tail prefills in one
        call, or, longer than ``prefill_chunk``, registers for chunked
        prefill (one slice per scheduler iteration)."""
        self._slot_req[slot] = req
        req.slot = slot
        now = time.monotonic()
        req.run_started_at = now
        if req.admitted_at is None:
            # first admission only: a resume's wait was observed once
            req.admitted_at = now
            wait = now - req.submitted_at
            if not req.batch:
                # a parked bulk prompt would poison the SLO windows and
                # the Retry-After estimate alike
                self._m_queue_wait.observe(wait)
                self._qwait_ewma = wait if self._qwait_ewma <= 0 \
                    else 0.9 * self._qwait_ewma + 0.1 * wait
            self._count("admitted")
        eff = req.effective_prompt()
        P = int(eff.size)
        start = req.prefix_start if self.paged else 0
        if self.paged:
            self._ptab[slot] = req.page_row
        if 0 < self.prefill_chunk < P - start:
            req.chunk_next = start
            self._chunking.add(slot)
            return
        self._prefill_call(slot, req, eff, start, P - start, last=True)

    def _advance_prefills(self):
        """One chunk slice per mid-prefill slot, and the mid-prefill
        deadline sweep."""
        for slot in sorted(self._chunking):
            req = self._slot_req[slot]
            if time.monotonic() > req.deadline:
                self._chunking.discard(slot)
                self._slot_req[slot] = None
                self._release_slot_pages(slot)
                self._timeout(req, "mid-prefill")
                continue
            eff = req.effective_prompt()
            P = int(eff.size)
            cur = req.chunk_next
            n = min(self.prefill_chunk, P - cur)
            last = cur + n >= P
            self._prefill_call(slot, req, eff, cur, n, last=last)
            req.chunk_next = cur + n
            if last:
                self._chunking.discard(slot)

    def _prefill_logits(self, slot: int, req: _Request, eff, start: int,
                        n: int):
        """Run positions ``start .. start + n - 1`` of ``eff`` into the
        slot's cache; returns the last position's (1, V) logits."""
        if self.paged:
            if self._prefill_staged is not None:
                # the previous chunk's copy out of the pinned buffer
                self._prefill_staged.synchronize()
            L, m = self.l_max, self.n_ptab
            buf = self._stage["buf"].numpy()
            buf[:eff.size] = eff
            buf[L:L + m] = req.page_row
            buf[L + m] = start
            buf[L + m + 1] = slot
            fn = self._fns["prefill"]
            out = fn(self._caches, {"buf": self._stage["buf"]})
            if self._prefill_staged is not None:
                self._prefill_staged.record()
            for _ in range(n - 1):
                out = fn(self._caches, None)
            return out["logits"]
        dev = self.device
        with torch.no_grad():
            toks = torch.from_numpy(
                eff[start:start + n].astype(np.int64)).to(dev)
            positions = torch.arange(start, start + n, dtype=torch.int32,
                                     device=dev)
            caches = {name: {part: t[slot:slot + 1]
                             for part, t in c.items()}
                      for name, c in self._caches.items()}
            for i in range(n):
                logits, _ = self.plan.step(self.params, caches,
                                           toks[i:i + 1],
                                           positions[i:i + 1], self._ctx)
        return logits

    def _prefill_call(self, slot: int, req: _Request, eff, start: int,
                      new_len: int, *, last: bool):
        """One prefill over ``eff[start:start + new_len]`` (a whole tail
        or one chunk slice).  ``last`` samples the first token at global
        fold position ``P - 1`` and runs the admission bookkeeping."""
        logits = self._prefill_logits(slot, req, eff, start, new_len)
        self._count("prefill_tokens", new_len)
        self._count("prefill_calls")
        if not last:
            return
        P = int(eff.size)
        topk = req.top_k if req.top_k is not None else self._vocab
        topp = req.top_p if req.top_p is not None else 1.0
        with torch.no_grad():
            dev = logits.device
            first = int((sample_slots(
                logits, *sampling_tensors([req.temperature], [topk], [topp],
                                          dev),
                gumbel_noise(fold_keys([req.seed], P - 1, dev),
                             self._vocab)) if req.temperature > 0
                else logits.float().argmax(-1))[0])
        if self.paged:
            self._register_prefix_pages(req)
        now = time.monotonic()
        # the admission's prefill rate, which the fleet's fetch payoff
        # reads (engine.py:3495-3500)
        rate = max(1, P - (req.prefix_start if self.paged else 0)) \
            / max(now - req.run_started_at, 1e-9)
        self._prefill_tok_s = rate if self._prefill_tok_s <= 0 \
            else 0.8 * self._prefill_tok_s + 0.2 * rate
        if req.first_token_at is None:
            # TTFT once, at the actual first token (not a resume's), and
            # never for batch
            req.first_token_at = now
            if not req.batch:
                self._m_ttft.observe(now - req.submitted_at)
                with self._stats_lock:
                    self._ttft.append(now - req.submitted_at)
        if req.batch:
            self._batch_tok_n += 1
        # the whole history: the drafter reads it, and the step its last
        self._toks[slot, :P] = eff
        self._toks[slot, P] = first
        self._pos[slot] = P
        self._temp[slot] = req.temperature
        self._topk[slot] = topk
        self._topp[slot] = topp
        self._eos[slot] = -1 if req.eos_id is None else req.eos_id
        self._end[slot] = req.end_index
        self._keys[slot] = fold_seed_array(req.seed, np.arange(self.l_max))
        self._serial[slot] += 1
        if req.stream is not None:
            req.stream.push(int(req.gen.size), (first,))
        done = (P >= req.end_index
                or (req.eos_id is not None and first == req.eos_id))
        if not done and req.stop_seqs:
            tail = np.concatenate([req.gen, np.asarray([first], np.int32)])
            if self._match_stop(req, tail, int(req.gen.size)) is not None:
                req.stop_hit = True
                done = True
        self._active[slot] = not done
        if done:
            self._retire(slot)

    def _stage_state(self) -> bool:
        """Pack the host mirror into the pinned state buffer; True when
        it differs from what the device holds."""
        S, lay = self.slots, self._layout
        b = self._st_stage.numpy()

        def put(name, vals, dt=np.int32):
            lo, hi = lay[name]
            b[lo:hi].view(dt)[:] = vals

        put("serial", self._serial)
        put("pos", self._pos)
        put("active", self._active)
        put("temp", self._temp, np.float32)
        put("topk", self._topk)
        put("topp", self._topp, np.float32)
        put("eos", self._eos)
        put("end", self._end)
        if self.paged:
            put("ptab", self._ptab.reshape(-1))
        return not np.array_equal(b, self._st_synced)

    def _dispatch(self, kind: str, batch=None):
        """One token-advancing dispatch: load the mirror onto the device
        when the host changed it (admission, retirement, preemption, a
        deadline, a page-table row), run the step (on the card: replay
        its graph), read back positions, active and finished flags,
        counts and the fresh tokens in one copy, and update the mirror.
        The ``kind``'s greedy-only program runs when no live slot
        samples.  Returns (finished, count, emitted) host arrays of
        (S,)."""
        if self._stage_state():
            self._dstate["st"].copy_(self._st_stage, non_blocking=True)
            self._dstate["toks"].copy_(self._toks_stage, non_blocking=True)
            self._dstate["keys"].copy_(self._keys_stage, non_blocking=True)
        name = kind if (self._temp[self._active] > 0).any() \
            else kind + "_greedy"
        # what the goodput read prices: the program and where it started
        self._last_dispatch = (name, self._pos.copy(), self._active.copy())
        rb = self._fns[name](self._dstate, batch)["rb"].cpu().numpy()
        with self._stats_lock:
            self._replays[name] += 1
        S = self.slots
        new_pos = rb[:S]
        emitted = new_pos - self._pos
        out = rb[4 * S:].reshape(S, -1)
        for s in np.flatnonzero(emitted):
            p = int(self._pos[s])
            self._toks[s, p + 1:p + 1 + emitted[s]] = out[s, :emitted[s]]
            req = self._slot_req[s]
            if req is not None and req.batch:
                self._batch_tok_n += int(emitted[s])
        self._pos[:] = new_pos
        self._active[:] = rb[S:2 * S] != 0
        self._stage_state()
        self._st_synced[:] = self._st_stage.numpy()
        return rb[2 * S:3 * S] != 0, rb[3 * S:4 * S], emitted

    def _advance_once(self):
        """One scheduler advance of every active slot (engine.py:
        3549-3580): a verify step when the drafter proposed and the
        measured payoff test passes (undrafted slots ride along on their
        ``-1`` rows and advance one token), else a megastep when every
        slot is busy and nothing waits, else one decode step.  When even
        a best-case draft could not pay (:meth:`_spec_worthwhile`) the
        drafter is skipped: an undraftable workload decays to plain
        decode plus one attempt every ``_SPEC_PROBE_TICKS`` ticks."""
        draft = None
        if self.spec and self._spec_worthwhile():
            probe = self._ticks_since_attempt >= _SPEC_PROBE_TICKS \
                and self._verify_wall_ewma > 0
            draft = self._spec_drafts()
            self._ticks_since_attempt = 0   # attempt consumed either way
            self._spec_attempts += 1
            # a parked-regime probe that found a draft runs the verify
            # unconditionally: it refreshes the accept EWMA the payoff
            # test reads
            if draft is not None and not probe \
                    and not self._verify_pays(draft):
                draft = None
        if draft is not None:
            self._verify_once(draft)
        elif self.megastep > 1 and self._mega_ready():
            self._megastep_once()
        else:
            self._step_once()

    def _mega_ready(self) -> bool:
        """May this iteration fuse N micro-steps (engine.py:3582-3595)?
        Only with every slot busy, the queue empty and no slot mid-
        chunked-prefill: any pending work drops the iteration to N = 1,
        so admission, preemption and the next chunk slice never wait on
        a fused block."""
        with self._qlock:
            queued = bool(self._queue)
        return bool(self._active.all()) and not queued \
            and not self._chunking

    def _spec_worthwhile(self) -> bool:
        """Could a verify step pay if every active slot drafted at the
        recent accept rate (engine.py:3597-3617)?  Profitable (measured
        EWMAs, payoff positive): draft every tick; cold (no verify wall
        measured): draft, for at most 64 attempts; parked or cold budget
        spent: one attempt every ``_SPEC_PROBE_TICKS``."""
        if self._verify_wall_ewma > 0 and self._step_wall_ewma > 0:
            ratio = self._verify_wall_ewma / max(self._step_wall_ewma,
                                                 1e-9)
            if 1 + self.spec_k * self._accept_ewma >= ratio:
                return True
        elif self._spec_attempts < 64:
            return True
        return self._ticks_since_attempt >= _SPEC_PROBE_TICKS

    def _verify_pays(self, draft) -> bool:
        """One verify step must be expected to emit what the same wall
        spent on decode steps would (engine.py:3619-3638): ``active +
        proposed * accept_ewma >= active * verify_wall / decode_wall``;
        yes until both walls are measured."""
        if self._verify_wall_ewma <= 0 or self._step_wall_ewma <= 0:
            return True
        active = int(self._active.sum())
        proposed = int((draft >= 0).sum())
        ratio = self._verify_wall_ewma / max(self._step_wall_ewma, 1e-9)
        return active + proposed * self._accept_ewma >= active * ratio

    def _spec_drafts(self):
        """(S, K) int32 draft matrix from the n-gram drafter over each
        active slot's history, or None when no slot drafted
        (engine.py:3640-3668).  The history is the host mirror, current
        after every dispatch's read-back (the JAX package syncs its own
        copy lazily, ``_sync_hist``)."""
        draft = None
        for s in np.flatnonzero(self._active):
            if self._slot_req[s] is None:
                continue
            pos, end = int(self._pos[s]), int(self._end[s])
            # one token left: a draft could accept nothing
            if end - pos < 2:
                continue
            row = ngram_draft(self._toks[s, :pos + 1], self.spec_k)
            if row is None:
                continue
            # proposals past the slot's length bound are dead weight
            row[min(self.spec_k, end - pos - 1):] = -1
            if not (row >= 0).any():
                continue
            if draft is None:
                draft = np.full((self.slots, self.spec_k), -1, np.int32)
            draft[s] = row
        return draft

    def _account(self, key: Optional[str], wall: float, tokens: int,
                 steps: int = 1):
        """A dispatch's counts: ``steps`` decode micro-steps (0 for a
        verify), ``tokens`` emitted over ``wall`` seconds."""
        self._tokens_per_s = tokens / max(wall, 1e-9)
        self._last_step_at = time.monotonic()
        with self._stats_lock:
            self._bw_pending.append(self._last_dispatch)
            self._bw_wall += wall
            if key is not None:
                self._n[key] += 1
            self._n["dispatches"] += 1
            self._n["decode_steps"] += steps
            self._n["decode_tokens"] += tokens
            self._decode_wall += wall
            if steps:
                self._step_s.append(wall / steps)
        if self.spec and steps:
            self._ticks_since_attempt += 1

    def _step_once(self):
        """One decode step over every slot (inactive slots ride along:
        their KV writes go to the scratch row / nowhere)."""
        t0 = time.monotonic()
        if faults.enabled():
            stall = faults.get_plan().decode_stall_ms
            if stall and faults.fire_once("decode_stall"):
                # one slow step, inside the timed window, so it lands in
                # the step histogram and the wall EWMAs as a real stall
                time.sleep(stall / 1e3)
        n_active = int(self._active.sum())
        finished, _, _ = self._dispatch("decode")
        wall = time.monotonic() - t0
        self._m_decode_step.observe(wall)
        self._step_wall_ewma = wall if self._step_wall_ewma <= 0 \
            else 0.9 * self._step_wall_ewma + 0.1 * wall
        self._account(None, wall, n_active)
        self._post_step(finished)

    def _megastep_once(self):
        """One megastep dispatch (engine.py:3893-3935): every slot
        advances up to N tokens, retiring inside the block on eos or its
        length bound; the host pays one scheduler pass for the block.
        Counted as N micro-steps, the per-token wall (dispatch wall / N)
        observed as the decode step."""
        t0 = time.monotonic()
        finished, emitted, _ = self._dispatch("megastep")
        wall = time.monotonic() - t0
        per_tok = wall / self.megastep
        self._m_decode_step.observe(per_tok)
        self._step_wall_ewma = per_tok if self._step_wall_ewma <= 0 \
            else 0.9 * self._step_wall_ewma + 0.1 * per_tok
        self._account("mega_dispatches", wall, int(emitted.sum()),
                      self.megastep)
        self._post_step(finished)

    def _verify_once(self, draft):
        """One speculative verify step (engine.py:3845-3891): every
        active slot scores its K + 1 positions in one dispatch and
        advances by its accepted prefix plus the bonus token; bitwise the
        decode path's tokens, since the sampler picks every one."""
        t0 = time.monotonic()
        self._stage["draft"].numpy()[:] = draft
        finished, accepted, emitted = self._dispatch(
            "verify", {"draft": self._stage["draft"]})
        wall = time.monotonic() - t0
        proposed, acc = int((draft >= 0).sum()), int(accepted.sum())
        self._m_spec_proposed.inc(proposed)
        self._m_spec_accepted.inc(acc)
        self._m_spec_verify.observe(wall)
        self._count("spec_proposed", proposed)
        self._count("spec_accepted", acc)
        self._count("spec_emitted", int(emitted.sum()))
        with self._stats_lock:
            self._verify_wall += wall
        self._verify_wall_ewma = wall if self._verify_wall_ewma <= 0 \
            else 0.9 * self._verify_wall_ewma + 0.1 * wall
        if proposed:
            self._accept_ewma = 0.8 * self._accept_ewma \
                + 0.2 * acc / proposed
        self._account("verify_steps", wall, int(emitted.sum()), 0)
        self._post_step(finished)

    def _publish_gauges(self):
        """The goodput and headroom gauges every 0.25 s and the windowed
        accept rate every 0.5 s (engine.py:2431-2452), first published on
        the scheduler's first tick: a ``/metrics`` scrape sees them
        without a ``stats()`` call."""
        now = time.monotonic()
        if now - self._goodput_mark >= 0.25:
            self._goodput_mark = now
            good = self._goodput_summary()
            self._g_headroom.set(self._headroom_slots(
                self._pages_summary()))
            # the pair as one: a reader reads the bandwidth, then the
            # MBU derived from it; MBU goes first, so a reader that sees
            # a new bandwidth (rising or falling to 0) sees its MBU too
            self._g_decode_mbu.set(good["decode_mbu"])
            self._g_decode_bw.set(good["decode_bandwidth_bytes_per_sec"])
            self._g_tps_chip.set(good["tokens_per_sec_per_chip"])
        b_t, b_n = self._batch_rate_mark
        if now - b_t >= 0.5:
            self._batch_tok_s = (self._batch_tok_n - b_n) / (now - b_t)
            self._batch_rate_mark = (now, self._batch_tok_n)
            self._g_batch_tps.set(self._batch_tok_s)
        t, prop0, acc0 = self._spec_rate_mark
        if not self.spec or now - t < 0.5:
            return
        with self._stats_lock:
            prop, acc = self._n["spec_proposed"], self._n["spec_accepted"]
        self._g_spec_accept_rate.set((acc - acc0) / (prop - prop0)
                                     if prop > prop0 else 0.0)
        self._spec_rate_mark = (now, prop, acc)

    def _post_step(self, finished):
        """Stream flush (first: a deadline below must deliver this
        step's tokens before its terminal frame), retirement, and the
        mid-flight deadline sweep."""
        with self._qlock:
            flush = bool(self._streams)
        if flush:
            self._flush_streams()
        for slot in np.flatnonzero(finished):
            self._retire(int(slot))
        now = time.monotonic()
        for slot in np.flatnonzero(self._active):
            req = self._slot_req[slot]
            if req is not None and now > req.deadline:
                self._active[slot] = False
                self._slot_req[slot] = None
                self._release_slot_pages(int(slot))
                self._timeout(req, "while decoding")

    @staticmethod
    def _match_stop(req: _Request, gen_all, start: int):
        """Earliest count ``n`` of generated tokens to keep such that a
        stop sequence ends at ``gen_all[n - 1]``, scanning match ends at
        index >= ``start`` only (a sequence spanning a flush boundary
        still matches: its end is new).  None = no match."""
        for j in range(int(start), int(gen_all.size)):
            for seq in req.stop_seqs:
                ln = int(seq.size)
                if ln <= j + 1 and np.array_equal(
                        gen_all[j + 1 - ln:j + 1], seq):
                    return j + 1
        return None

    def _stop_retire(self, slot: int, n_keep: int):
        """Retire on a stop match, keeping the generated tokens through
        the match (``n_keep``, the resume prefix counted)."""
        req = self._slot_req[slot]
        self._active[slot] = False
        self._slot_req[slot] = None
        self._release_slot_pages(slot)
        req.stop_hit = True
        P = int(req.prompt.size) + int(req.gen.size)
        fresh = self._toks[slot, P:P + n_keep - int(req.gen.size)]
        self._count("retired")
        req.finish(result=np.concatenate(
            [req.prompt, req.gen, fresh.astype(np.int32)]))
        self._observe_finish(req, "ok")

    def _flush_streams(self):
        """Push every streaming slot's new tokens as frames, matching
        stop sequences first so no frame past a stop point streams."""
        for slot in range(self.slots):
            req = self._slot_req[slot]
            # a mid-chunk slot still carries the previous occupant's _pos
            if req is None or req.stream is None or slot in self._chunking:
                continue
            h = req.stream
            P = int(req.prompt.size)
            total = int(self._pos[slot]) + 1 - P
            start = h.next_i        # the scheduler thread is the writer
            if total <= start:
                continue
            lim, n_keep = total, None
            if req.stop_seqs and not req.stop_hit:
                gen_all = np.concatenate([
                    req.gen,
                    self._toks[slot, P + int(req.gen.size):P + total]
                    .astype(np.int32)])
                n_keep = self._match_stop(req, gen_all, start)
                if n_keep is not None:
                    lim = n_keep
            if lim > start:
                h.push(start, self._toks[slot, P + start:P + lim])
            if n_keep is not None:
                self._stop_retire(slot, n_keep)

    def _retire(self, slot: int):
        req = self._slot_req[slot]
        self._active[slot] = False
        self._slot_req[slot] = None
        self._temp[slot] = 0.0
        self._release_slot_pages(slot)
        if req is None:
            return
        # the result: the request's own prompt, what a preemption (or
        # the resume form) already holds, and this run's tokens
        P = int(req.prompt.size) + int(req.gen.size)
        gen = self._toks[slot, P:int(self._pos[slot]) + 1].astype(np.int32)
        self._count("retired")
        req.finish(result=np.concatenate([req.prompt, req.gen, gen]))
        self._observe_finish(req, "ok")
