"""Continuous-batching decode engine (a subset of
veles_tpu/runtime/engine.py).

The engine owns a fixed slot batch of KV caches for its lifetime — dense
``(slots, l_max)`` rows, or (the default) a pool of fixed-size pages that
every slot maps through its own page table, with one scratch row that
absorbs the writes of inactive slots.  A scheduler thread owns the
request queue:

* admission happens mid-flight into free slots; a paged admission
  allocates the pages of the request's whole span first, and a request
  the pool cannot host while slots are free is refused with 429
  (:class:`EngineOverloaded`) — so is one that finds the queue full;
* prefill runs the prompt through the decode step one position at a
  time, as ``_make_paged_prefill_fn`` does (engine.py:574-657).  It reads
  the paged cache through the gather path even when the paged kernel is
  on — the JAX package's prefill passes no ``paged_kernel``
  (engine.py:622-624).  The JAX package pads the prompt to a pow2 bucket
  only to bound the shapes it compiles; the pad positions are no-ops
  (scratch writes, discarded logits), and an eager step compiles
  nothing, so the port runs the prompt's own positions;
* one decode step advances every slot, with per-slot greedy /
  temperature / top-k / top-p sampling and eos / length retirement
  (engine.py:187-243, ``_sample_slots`` :1024); with ``paged_kernel``
  the paged read goes through the paged-decode CUDA kernel;
* deadlines fail a request loudly (queued or decoding).

Prefix sharing / copy-on-write, chunked prefill, priorities and
preemption, admission control, streaming, speculative decoding,
megastep, KV transfer, hot swap and metrics wait for later slices
(ROADMAP.md, slice 5 (b)-(g)).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import root
from ..logger import Logger
from ..ops import resolve_device
from ..units.base import Context
from ..units.nn import input_vocab
from .generate import DecodePlan, row_seeds, sample_rows


class EngineOverloaded(RuntimeError):
    """The queue or the page pool is full; retry after ``retry_after_s``
    seconds (HTTP 429 + Retry-After in restful.py)."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = max(0.0, float(retry_after_s))


class EngineStopped(RuntimeError):
    """The engine is not running (never started, or stopped)."""


class SchedulerCrashed(RuntimeError):
    """The scheduler loop died; every pending request failed with this."""


class ServeGeometry(NamedTuple):
    slots: int
    l_max: int
    paged: bool
    page_size: int
    pages: int
    paged_kernel: bool = False

    @property
    def n_ptab(self) -> int:
        return self.l_max // self.page_size if self.paged else 0


def resolve_serve_geometry(slots=None, l_max=None, paged=None, page_size=None, pages=None,
                           paged_kernel=None) -> ServeGeometry:
    """Slot-batch geometry with ``root.common.serve`` defaults — the JAX
    package's resolution (engine.py:683-746) without megastep."""
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
    if not use_paged:
        if paged_kernel:
            raise ValueError(
                "paged_kernel requires the paged KV layout "
                "(root.common.serve.paged / paged=True)")
        return ServeGeometry(slots, l_max, False, psz, 0, False)
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
    return ServeGeometry(slots, l_max, True, psz, pages, use_kernel)


class _Request:
    __slots__ = ("prompt", "n_steps", "temperature", "top_k", "top_p",
                 "eos_id", "seed", "deadline", "done", "result", "error",
                 "submitted_at", "admitted_at", "first_token_at",
                 "finished_at", "slot", "page_row")

    def __init__(self, prompt, n_steps, temperature, top_k, top_p, eos_id,
                 seed, deadline):
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
        self.admitted_at = None
        self.first_token_at = None
        self.finished_at = None
        self.slot = None
        self.page_row = None

    @property
    def end_index(self) -> int:
        """Global index of the final token."""
        return int(self.prompt.size) + int(self.n_steps) - 1

    def finish(self, result=None, error=None):
        self.result, self.error = result, error
        self.finished_at = time.monotonic()
        self.done.set()


class DecodeEngine(Logger):
    """Continuous-batching decode engine over a :class:`DecodePlan`.

    ``slots`` / ``l_max`` / ``window_ms`` / ``queue_depth`` /
    ``deadline_s`` / the paged knobs default from ``root.common.serve``.
    ``device`` defaults to the CUDA card (``ops.resolve_device``); the
    workflow state's parameters are moved there."""

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
                 device=None):
        self.device = resolve_device(device)
        serve = root.common.serve
        geo = resolve_serve_geometry(slots, l_max, paged=paged,
                                     page_size=page_size, pages=pages,
                                     paged_kernel=paged_kernel)
        self.slots, self.l_max = geo.slots, geo.l_max
        self.paged, self.page_size, self.pages = \
            geo.paged, geo.page_size, geo.pages
        self.n_ptab = geo.n_ptab
        self.paged_kernel = geo.paged_kernel
        self.window_s = float(window_ms if window_ms is not None
                              else serve.get("window_ms", 2.0)) / 1e3
        self.queue_depth = int(queue_depth if queue_depth is not None
                               else serve.get("queue_depth", 64))
        self.deadline_s = float(deadline_s if deadline_s is not None
                                else serve.get("deadline_s", 120.0))
        self.params = {u: {k: t.to(self.device) for k, t in p.items()}
                       for u, p in wstate["params"].items()}
        self.plan = DecodePlan(workflow, output_unit)
        self._ctx = Context(train=False)
        # the embedding table's rows: the bound on prompt token ids (the
        # REST guard's), checked in submit before anything is enqueued
        self._input_vocab = input_vocab(workflow, self.params)

        S = self.slots
        if self.paged:
            self._caches = self.plan.init_caches(
                self.params, S, self.l_max, cache_dtype, self.device,
                kv_rows=self.pages + 1, page_size=self.page_size)
        else:
            self._caches = self.plan.init_caches(
                self.params, S, self.l_max, cache_dtype, self.device)
        # host-side per-slot state (scheduler thread)
        self._toks = np.zeros((S, self.l_max), np.int64)
        self._pos = np.zeros(S, np.int32)       # index of last written tok
        self._active = np.zeros(S, bool)
        self._temp = np.zeros(S, np.float32)
        self._topk = np.zeros(S, np.int64)
        self._topp = np.ones(S, np.float32)
        self._eos = np.full(S, -1, np.int64)
        self._end = np.zeros(S, np.int64)
        self._seeds = np.zeros(S, np.int64)
        self._slot_req: list = [None] * S

        # paged pool: refcounted pages, a free list, the per-slot page
        # table (scratch row = index ``pages``) and its device copy
        if self.paged:
            self._scratch = self.pages
            self._ptab = np.full((S, self.n_ptab), self._scratch, np.int32)
            self._ptab_dev = None        # refreshed when _ptab changes
            self._page_lock = threading.Lock()
            self._page_ref = np.zeros(self.pages, np.int32)  # guarded-by: self._page_lock
            self._page_free = list(range(self.pages))  # guarded-by: self._page_lock
            self._pool_rejected = 0      # guarded-by: self._page_lock

        self._queue: collections.deque = collections.deque()  # guarded-by: self._qlock
        self._qlock = threading.Lock()
        self._wake = threading.Event()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._died = False

        self._stats_lock = threading.Lock()
        self._n = collections.Counter()   # guarded-by: self._stats_lock
        self._ttft = collections.deque(maxlen=1024)  # guarded-by: self._stats_lock
        self._step_s = collections.deque(maxlen=4096)  # guarded-by: self._stats_lock
        self._decode_wall = 0.0           # guarded-by: self._stats_lock
        # head width (the logits' last dim): top_k's keep-all sentinel
        self._vocab = int(workflow.specs[self.plan.output].shape[-1])

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._thread is None:
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._loop, name="decode-engine", daemon=True)
            self._thread.start()
        return self

    @property
    def started(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def stop(self, timeout: float = 30.0):
        self._stop_evt.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    # -- requests ----------------------------------------------------------
    def submit(self, prompt, n_steps: int, *, temperature: float = 0.0,
               top_k: Optional[int] = None, top_p: Optional[float] = None,
               eos_id: Optional[int] = None, seed: int = 0,
               deadline_s: Optional[float] = None) -> _Request:
        """Enqueue one sequence; its ``done`` event fires with ``result``
        (np.int32, prompt + generated, trimmed at eos) or ``error``.
        Raises :class:`EngineOverloaded` when the queue is full or the
        page pool cannot host the request while slots are free."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        hi = self._input_vocab if self._input_vocab is not None else 2 ** 31
        if prompt.min() < 0 or prompt.max() >= hi:
            raise ValueError(
                f"prompt token ids must be in [0, {hi}) "
                f"(got min {prompt.min()}, max {prompt.max()})")
        prompt = prompt.astype(np.int32)
        n_steps = int(n_steps)
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        if top_k is not None and int(top_k) < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        if top_p is not None and not 0.0 < float(top_p) <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if prompt.size + n_steps > self.l_max:
            raise ValueError(
                f"prompt {prompt.size} + n_steps {n_steps} exceeds the "
                f"engine's l_max {self.l_max}")
        if self._died:
            raise SchedulerCrashed("engine scheduler crashed earlier; "
                                   "restart the engine")
        if not self.started:
            raise EngineStopped("engine is not running (call start())")
        req = _Request(prompt, n_steps, float(temperature),
                       None if top_k is None else int(top_k),
                       None if top_p is None else float(top_p),
                       None if eos_id is None else int(eos_id), int(seed),
                       time.monotonic() + (self.deadline_s
                                           if deadline_s is None
                                           else float(deadline_s)))
        if self.paged:
            need = self._page_span(prompt.size, n_steps)
            with self._page_lock:
                avail = len(self._page_free)
            with self._qlock:
                free_slots = sum(r is None for r in self._slot_req)
                pool_bound = need > avail and free_slots > len(self._queue)
            if pool_bound:
                with self._page_lock:
                    self._pool_rejected += 1
                self._count("rejected")
                raise EngineOverloaded(
                    f"page pool exhausted ({avail} of {self.pages} pages "
                    f"free, request needs {need})")
        with self._qlock:
            full = len(self._queue) >= self.queue_depth
            if not full:
                self._queue.append(req)
        if full:
            self._count("rejected")
            raise EngineOverloaded(
                f"queue full ({self.queue_depth} pending requests)")
        self._wake.set()
        return req

    def generate(self, prompt, n_steps: int, *, temperature: float = 0.0,
                 top_k=None, top_p=None, eos_id=None, seed: int = 0,
                 timeout: Optional[float] = None):
        """Blocking batch decode with the ``generate()`` contract:
        (B, P) -> (B, P + n_steps) np.int32, rows past their eos padded
        with ``eos_id``.  Row r samples with ``row_seeds(seed, B)[r]``,
        as ``generate()`` does."""
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
                    seed=seeds[r]))
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

    # -- stats -------------------------------------------------------------
    def _count(self, key: str, n: int = 1):
        with self._stats_lock:
            self._n[key] += n

    def stats(self) -> dict:
        with self._stats_lock:
            n = dict(self._n)
            ttft = list(self._ttft)
            steps = list(self._step_s)
            wall = self._decode_wall
        with self._qlock:
            qlen = len(self._queue)
        out = {
            "device": str(self.device),
            "slots": self.slots, "l_max": self.l_max,
            "occupancy": int(self._active.sum()),
            "queue_depth": qlen,
            "admitted": n.get("admitted", 0),
            "retired": n.get("retired", 0),
            "rejected": n.get("rejected", 0),
            "timeouts": n.get("timeouts", 0),
            "decode_steps": n.get("decode_steps", 0),
            "decode_tokens": n.get("decode_tokens", 0),
            "prefill_tokens": n.get("prefill_tokens", 0),
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
        }
        if self.paged:
            with self._page_lock:
                free = len(self._page_free)
                rej = self._pool_rejected
            out["pages"] = {"total": self.pages, "free": free,
                            "used": self.pages - free,
                            "page_size": self.page_size,
                            "pool_rejected": rej}
        return out

    # -- scheduler ---------------------------------------------------------
    def _loop(self):
        try:
            while not self._stop_evt.is_set():
                with self._qlock:
                    pending = bool(self._queue)
                if not self._active.any() and not pending:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    continue
                if not self._active.any() and self.window_s > 0:
                    # batching window: concurrent arrivals are admitted
                    # together and share the first decode steps
                    time.sleep(self.window_s)
                self._expire_queue()
                self._admit()
                if self._active.any():
                    self._step_once()
        except Exception as e:  # noqa: BLE001 — a dead scheduler must
            # fail pending work loudly, not hang every client
            self._died = True
            self.exception("decode engine scheduler died")
            self._fail_all(SchedulerCrashed(
                f"engine scheduler crashed: {type(e).__name__}: {e}"))
        finally:
            self._fail_all(EngineStopped("engine stopped"))

    def _fail_all(self, err: Exception):
        with self._qlock:
            pending = list(self._queue)
            self._queue.clear()
        for req in pending:
            req.finish(error=err)
        for s, req in enumerate(self._slot_req):
            if req is not None:
                req.finish(error=err)
                self._slot_req[s] = None
            self._release_slot_pages(s)
        self._active[:] = False

    def _expire_queue(self):
        now = time.monotonic()
        with self._qlock:
            expired = [r for r in self._queue if now > r.deadline]
            for r in expired:
                self._queue.remove(r)
        for r in expired:
            self._count("timeouts")
            r.finish(error=TimeoutError(
                "request deadline expired while queued"))

    def _free_slot(self) -> Optional[int]:
        for s in range(self.slots):
            if self._slot_req[s] is None:
                return s
        return None

    def _admit(self):
        while True:
            slot = self._free_slot()
            if slot is None:
                return
            with self._qlock:
                req = self._queue.popleft() if self._queue else None
            if req is None:
                return
            if time.monotonic() > req.deadline:
                self._count("timeouts")
                req.finish(error=TimeoutError(
                    "request deadline expired while queued"))
                continue
            if self.paged and not self._reserve_pages(req):
                # pages free as slots retire; deadlines bound the wait
                with self._qlock:
                    self._queue.appendleft(req)
                return
            self._prefill(slot, req)

    # -- page pool ---------------------------------------------------------
    def _page_span(self, P: int, n_steps: int) -> int:
        """Pages a request can ever reference: KV lands at positions
        0 .. P + n_steps - 2 (the final token's KV is never computed)."""
        return -(-(int(P) + int(n_steps) - 1) // self.page_size)

    def _reserve_pages(self, req) -> bool:
        need = self._page_span(req.prompt.size, req.n_steps)
        with self._page_lock:
            if len(self._page_free) < need:
                return False
            row = np.full(self.n_ptab, self._scratch, np.int32)
            for i in range(need):
                pid = self._page_free.pop()
                self._page_ref[pid] = 1
                row[i] = pid
        req.page_row = row
        return True

    def _release_slot_pages(self, slot: int):
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
                    self._page_free.append(pid)
        self._ptab[slot] = self._scratch
        self._ptab_dev = None

    def _ptab_device(self):
        if self._ptab_dev is None:
            self._ptab_dev = torch.from_numpy(self._ptab).to(self.device)
        return self._ptab_dev

    # -- device work -------------------------------------------------------
    def _prefill(self, slot: int, req: _Request):
        """Admit ``req`` into ``slot``: run its prompt through the decode
        step (gather path on the paged layout), sample its first token."""
        self._slot_req[slot] = req
        req.slot = slot
        req.admitted_at = time.monotonic()
        self._count("admitted")
        P = int(req.prompt.size)
        dev = self.device
        if self.paged:
            self._ptab[slot] = req.page_row
            self._ptab_dev = None
        topk = req.top_k if req.top_k is not None else self._vocab
        topp = req.top_p if req.top_p is not None else 1.0
        with torch.inference_mode():
            toks = torch.from_numpy(req.prompt.astype(np.int64)).to(dev)
            positions = torch.arange(P, dtype=torch.int32, device=dev)
            if self.paged:
                ptab_row = torch.from_numpy(req.page_row).to(dev)[None]
                caches = self._caches
            else:
                caches = {name: {"k": c["k"][slot:slot + 1],
                                 "v": c["v"][slot:slot + 1]}
                          for name, c in self._caches.items()}
            for i in range(P):
                pages = ((ptab_row, self.page_size, None) if self.paged
                         else None)
                logits, _ = self.plan.step(self.params, caches,
                                           toks[i:i + 1],
                                           positions[i:i + 1], self._ctx,
                                           pages=pages)
            first = int(sample_rows(logits, [req.temperature], [topk],
                                    [topp], [req.seed], [P - 1])[0])
        now = time.monotonic()
        req.first_token_at = now
        with self._stats_lock:
            self._ttft.append(now - req.submitted_at)
            self._n["prefill_tokens"] += P
        self._toks[slot, :P] = req.prompt
        self._toks[slot, P] = first
        self._pos[slot] = P
        self._temp[slot] = req.temperature
        self._topk[slot] = topk
        self._topp[slot] = topp
        self._eos[slot] = -1 if req.eos_id is None else req.eos_id
        self._end[slot] = req.end_index
        self._seeds[slot] = req.seed
        done = (P >= req.end_index
                or (req.eos_id is not None and first == req.eos_id))
        self._active[slot] = not done
        if done:
            self._retire(slot)

    def _step_once(self):
        """One decode step over every slot (inactive slots ride along:
        their KV writes go to the scratch row / nowhere)."""
        t0 = time.monotonic()
        S = self.slots
        rows = np.arange(S)
        pos = self._pos.copy()
        active = self._active.copy()
        dev = self.device
        with torch.inference_mode():
            tok = torch.from_numpy(self._toks[rows, pos]).to(dev)
            pos_d = torch.from_numpy(pos).to(dev)
            act_d = torch.from_numpy(active).to(dev)
            if self.paged:
                logits, _ = self.plan.step(
                    self.params, self._caches, tok, pos_d, self._ctx,
                    pages=(self._ptab_device(), self.page_size, act_d),
                    paged_kernel=self.paged_kernel)
            else:
                logits, _ = self.plan.step(self.params, self._caches, tok,
                                           pos_d, self._ctx,
                                           write_ok=act_d)
            nxt = sample_rows(logits, np.where(active, self._temp, 0.0),
                              self._topk, self._topp, self._seeds,
                              pos).cpu().numpy()
        new_pos = np.where(active, pos + 1, pos)
        cur = self._toks[rows, new_pos]
        self._toks[rows, new_pos] = np.where(active, nxt, cur)
        finished = active & ((nxt == self._eos) | (new_pos >= self._end))
        self._pos = new_pos.astype(np.int32)
        self._active = active & ~finished
        wall = time.monotonic() - t0
        with self._stats_lock:
            self._n["decode_steps"] += 1
            self._n["decode_tokens"] += int(active.sum())
            self._decode_wall += wall
            self._step_s.append(wall)
        for slot in np.flatnonzero(finished):
            self._retire(int(slot))
        now = time.monotonic()
        for slot in np.flatnonzero(self._active):
            req = self._slot_req[slot]
            if req is not None and now > req.deadline:
                self._active[slot] = False
                self._slot_req[slot] = None
                self._release_slot_pages(int(slot))
                self._count("timeouts")
                req.finish(error=TimeoutError(
                    "request deadline expired while decoding"))

    def _retire(self, slot: int):
        req = self._slot_req[slot]
        self._active[slot] = False
        self._slot_req[slot] = None
        self._temp[slot] = 0.0
        self._release_slot_pages(slot)
        if req is None:
            return
        P = int(req.prompt.size)
        gen = self._toks[slot, P:int(self._pos[slot]) + 1].astype(np.int32)
        self._count("retired")
        req.finish(result=np.concatenate([req.prompt, gen]))
