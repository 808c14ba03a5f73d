"""Batch job lane: bulk offline inference over idle serving capacity (a
copy of veles_tpu/runtime/jobs.py, which holds no JAX, rewired to the
port's config, logger, metrics and snapshotter).

The priority/preemption/admission stack and the fleet router only *shed*
load: the troughs between interactive bursts leave slots, pages and
captured programs idle.  This module fills them: a **job** is a set of
prompts plus sampling params; the manager shards it into one engine
request per prompt and dispatches them with ``"batch": true``, the
engine's trough-filler class below every interactive priority, admitted
only while headroom and SLO burn allow and preempted first the instant
interactive traffic arrives.

Durability is the core contract.  Every job lives in a directory under
the store root (a committed ``manifest.json`` plus one
``results/NNNNNN.json`` per completed prompt), and every write goes
through the snapshotter's tmp-fsync-rename helper (``_commit_bytes``)
and a directory fsync.  A crash, drain, preemption or replica ejection
therefore never loses completed work: a restarted manager reloads the
manifests, rebuilds each job's done-set from the result files on disk,
and re-enqueues only the prompts without a committed result.  The
manifest and result files are the JAX package's byte for byte, so
either package reads the other's store.  Because every prompt carries
its own derived seed (``seed + index``) and the engine's
preempt/resume path is bitwise deterministic, a resumed or failed-over
job produces byte-identical results to an uninterrupted run.

Dispatch is pluggable: the fleet router's ``handle_generate`` (the
fleet-level job API, with failover across replicas) or a single
:class:`~.restful.RestfulServer`'s local adapter; both return the
``(status, doc, headers)`` triple.  In-flight dispatches register in the
``_inflight`` ledger: acquired before the dispatch, released on result,
permanent failure, cancel and shutdown (a leaked entry would overstate
``vt_job_prompts_inflight`` and wedge the cancel path's accounting).

REST surface (served by both the fleet server and a single replica):
``POST /jobs`` submit, ``GET /jobs/<id>`` status, ``GET
/jobs/<id>/results`` paged results, ``DELETE /jobs/<id>`` cancel, ``GET
/jobs`` lists; the fleet merges :meth:`JobManager.summary` into
``/fleet.json``.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Tuple

from ..config import root
from ..logger import Logger
from .metrics import registry
from .snapshotter import _commit_bytes, _fsync_dir

#: spec keys a ``POST /jobs`` body may carry (anything else is a 400 —
#: a typoed ``"temprature"`` must not silently decode greedy).
_SPEC_KEYS = frozenset({
    "prompts", "prompt_file", "steps", "temperature", "top_k", "top_p",
    "eos_id", "seed",
})

#: terminal job states (no work left to schedule).
_TERMINAL = ("done", "cancelled")


class JobError(ValueError):
    """Malformed job spec or unknown job id (the REST 400/404 path)."""


class _Job:
    """In-memory twin of one persisted job directory."""

    __slots__ = ("id", "prompts", "params", "seed", "state", "created",
                 "done_idx", "failed_idx", "error_by_idx")

    def __init__(self, job_id: str, prompts: List[List[int]],
                 params: dict, seed: int, state: str = "running",
                 created: float = 0.0):
        self.id = job_id
        self.prompts = prompts
        self.params = params            # steps/temperature/top_k/...
        self.seed = int(seed)
        # mutable progress state: the owning manager's _lock guards
        # every post-construction touch (the _Job itself carries no
        # lock — load_all builds free-standing instances)
        self.state = state
        self.created = float(created)
        self.done_idx: set = set()
        self.failed_idx: set = set()
        self.error_by_idx: dict = {}

    def request_body(self, idx: int) -> dict:
        """The ``/generate`` body for prompt ``idx`` — always
        ``batch: true`` (the engine's trough class) and a per-prompt
        seed derived from the job seed, so the result is a pure
        function of (job spec, index): any replica, any preemption
        history, any retry produces the same bytes."""
        body = {"prompt": [self.prompts[idx]],
                "steps": self.params["steps"],
                "seed": self.seed + idx,
                "batch": True}
        for k in ("temperature", "top_k", "top_p", "eos_id"):
            if self.params.get(k) is not None:
                body[k] = self.params[k]
        return body

    def manifest(self) -> dict:
        return {"id": self.id, "state": self.state,
                "created": self.created, "seed": self.seed,
                "n_prompts": len(self.prompts),
                "params": self.params, "prompts": self.prompts}


class JobStore:
    """Durable job persistence: one directory per job under ``base``,
    holding a committed ``manifest.json`` and ``results/NNNNNN.json``
    per finished prompt.  Every write stages through the snapshotter's
    tmp-fsync-rename helper — a crash leaves the previous committed
    state, never a torn file a resume would trust."""

    def __init__(self, base: str):
        self.base = str(base)
        os.makedirs(self.base, exist_ok=True)

    def _job_dir(self, job_id: str) -> str:
        return os.path.join(self.base, job_id)

    def _result_path(self, job_id: str, idx: int) -> str:
        return os.path.join(self._job_dir(job_id), "results",
                            f"{int(idx):06d}.json")

    def commit_manifest(self, job: _Job) -> None:
        d = self._job_dir(job.id)
        os.makedirs(os.path.join(d, "results"), exist_ok=True)
        _commit_bytes(os.path.join(d, "manifest.json"),
                      json.dumps(job.manifest()).encode())
        _fsync_dir(d)

    def commit_result(self, job_id: str, idx: int, doc: dict) -> None:
        path = self._result_path(job_id, idx)
        _commit_bytes(path, json.dumps(doc).encode())
        _fsync_dir(os.path.dirname(path))

    def has_result(self, job_id: str, idx: int) -> bool:
        return os.path.exists(self._result_path(job_id, idx))

    def read_result(self, job_id: str, idx: int) -> Optional[dict]:
        try:
            with open(self._result_path(job_id, idx)) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def load_all(self) -> List[_Job]:
        """Rebuild every persisted job: the manifest names the prompts
        and params; the done-set is recomputed from the result files
        actually committed — the on-disk results ARE the progress
        record, so a crash between a result commit and any counter
        update can never double-run or drop a prompt."""
        jobs: List[_Job] = []
        try:
            entries = sorted(os.listdir(self.base))
        except OSError:
            return jobs
        for name in entries:
            mpath = os.path.join(self.base, name, "manifest.json")
            try:
                with open(mpath) as f:
                    m = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue        # half-created dir (pre-first-commit)
            job = _Job(m["id"], m["prompts"], m["params"],
                       m.get("seed", 0), state=m.get("state", "running"),
                       created=m.get("created", 0.0))
            for idx in range(len(job.prompts)):
                doc = self.read_result(job.id, idx) \
                    if self.has_result(job.id, idx) else None
                if doc is None:
                    continue
                job.done_idx.add(idx)
                if "error" in doc:
                    job.failed_idx.add(idx)
                    job.error_by_idx[idx] = doc["error"]
            jobs.append(job)
        return jobs


class JobManager(Logger):
    """Shards jobs into per-prompt batch-class requests and drives them
    through ``dispatch`` — ``FleetRouter.handle_generate`` or a single
    replica's local adapter, both ``body -> (status, doc, headers)``.

    Worker threads pull ``(job_id, idx)`` items from the work deque.
    A 429 (trough closed / replica backpressure) requeues the item and
    backs off by the server's Retry-After hint — batch work *waits out*
    interactive bursts, it never competes with them.  A 400 is a
    permanent per-prompt failure (recorded as that prompt's result); a
    5xx/transport failure requeues with backoff.  Results commit to the
    durable store exactly once per prompt — the done-set check runs
    before every dispatch, so retries and resumes can't double-commit.
    """

    def __init__(self, store_dir: str,
                 dispatch: Callable[[dict], Tuple[int, object, tuple]],
                 *, workers: Optional[int] = None,
                 retry_s: Optional[float] = None,
                 max_prompts: Optional[int] = None):
        jobs_cfg = root.common.serve.jobs
        self._dispatch = dispatch
        self._store = JobStore(store_dir)
        self.workers = max(1, int(jobs_cfg.get("workers", 2)
                                  if workers is None else workers))
        self.retry_s = float(jobs_cfg.get("retry_s", 0.25)
                             if retry_s is None else retry_s)
        self.max_prompts = int(jobs_cfg.get("max_prompts", 100_000)
                               if max_prompts is None else max_prompts)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._jobs: Dict[str, _Job] = {}        # guarded-by: self._lock
        self._work: collections.deque = collections.deque()  # guarded-by: self._lock
        self._inflight: Dict[Tuple[str, int], float] = {}  # guarded-by: self._lock
        self._stop_evt = threading.Event()
        self._threads: List[threading.Thread] = []
        self._counts = {"submitted": 0, "completed": 0, "cancelled": 0}  # guarded-by: self._lock
        reg = registry()
        self._m_submitted = reg.counter(
            "vt_jobs_submitted_total", "batch jobs accepted by POST "
            "/jobs (resumed-from-disk jobs not re-counted)")
        self._m_completed = reg.counter(
            "vt_jobs_completed_total",
            "batch jobs whose every prompt reached a terminal result")
        self._m_cancelled = reg.counter(
            "vt_jobs_cancelled_total", "batch jobs cancelled via "
            "DELETE /jobs/<id> before completing")
        self._g_inflight = reg.gauge(
            "vt_job_prompts_inflight",
            "per-prompt batch requests currently dispatched and "
            "awaiting a replica's answer (the job-slots ledger depth)")
        self._g_inflight.set(0)
        # crash/preemption resume: reload persisted jobs, re-enqueue
        # exactly the prompts without a committed result
        for job in self._store.load_all():
            self._jobs[job.id] = job
            if job.state not in _TERMINAL:
                missing = [i for i in range(len(job.prompts))
                           if i not in job.done_idx]
                if not missing:
                    self._finish_job_locked(job)
                    self._store.commit_manifest(job)
                else:
                    self._work.extend((job.id, i) for i in missing)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "JobManager":
        if self._threads:
            return self
        self._stop_evt.clear()
        for i in range(self.workers):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"job-worker-{i}")
            t.start()
            self._threads.append(t)
        return self

    def stop(self):
        """Stop scheduling — in-flight dispatches finish or fail on
        their own connections; their committed results survived either
        way, so a restart resumes from exactly this point."""
        self._stop_evt.set()
        with self._lock:                # the condition SHARES this lock
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads.clear()
        with self._lock:
            for key in list(self._inflight):
                self._release_job_slot_locked(key)

    # -- the job-slots ledger ------------------------------------------------
    def _acquire_job_slot(self, key: Tuple[str, int]) -> None:
        """Register one dispatched prompt in the in-flight ledger.
        Every acquire MUST reach :meth:`_release_job_slot` on result,
        permanent failure, cancel and shutdown paths."""
        with self._lock:
            self._inflight[key] = time.monotonic()
            self._g_inflight.set(len(self._inflight))

    def _release_job_slot(self, key: Tuple[str, int]) -> None:
        """Drop one prompt from the in-flight ledger (idempotent — the
        cancel and shutdown sweeps race the worker's own finally)."""
        with self._lock:
            self._release_job_slot_locked(key)

    def _release_job_slot_locked(self, key: Tuple[str, int]) -> None:  # requires-lock: self._lock
        self._inflight.pop(key, None)
        self._g_inflight.set(len(self._inflight))

    # -- submission / query API ----------------------------------------------
    def submit(self, spec: dict) -> dict:
        """Validate + persist one job, enqueue its prompts, return the
        status doc.  The manifest commits BEFORE the first dispatch:
        from the client's 200 onward the job survives any crash."""
        if not isinstance(spec, dict):
            raise JobError("job spec must be a JSON object")
        unknown = set(spec) - _SPEC_KEYS
        if unknown:
            raise JobError(f"unknown job spec keys: {sorted(unknown)}")
        prompts = self._load_prompts(spec)
        params = self._validate_params(spec)
        seed = int(spec.get("seed", 0))
        job = _Job(uuid.uuid4().hex[:12], prompts, params, seed,
                   created=time.time())
        self._store.commit_manifest(job)
        with self._lock:                # the condition SHARES this lock
            self._jobs[job.id] = job
            self._counts["submitted"] += 1
            self._work.extend((job.id, i) for i in range(len(prompts)))
            self._cv.notify_all()
        self._m_submitted.inc()
        return self.status(job.id)

    def _load_prompts(self, spec: dict) -> List[List[int]]:
        if ("prompts" in spec) == ("prompt_file" in spec):
            raise JobError(
                'job spec needs exactly one of "prompts" (inline) or '
                '"prompt_file" (server-side JSON path)')
        if "prompt_file" in spec:
            path = str(spec["prompt_file"])
            try:
                with open(path) as f:
                    prompts = json.load(f)
            except (OSError, json.JSONDecodeError) as e:
                raise JobError(
                    f"prompt_file {path!r} unreadable: {e}") from None
        else:
            prompts = spec["prompts"]
        if not isinstance(prompts, list) or not prompts:
            raise JobError("prompts must be a non-empty list of "
                           "token-id lists")
        if len(prompts) > self.max_prompts:
            raise JobError(f"{len(prompts)} prompts exceeds "
                           f"serve.jobs.max_prompts {self.max_prompts}")
        out: List[List[int]] = []
        for i, p in enumerate(prompts):
            if not isinstance(p, (list, tuple)) or not p:
                raise JobError(
                    f"prompt {i} must be a non-empty token-id list")
            try:
                row = [int(t) for t in p]
            except (TypeError, ValueError):
                raise JobError(
                    f"prompt {i} holds non-integer token ids") from None
            if any(t != float(orig) for t, orig in zip(row, p)):
                raise JobError(
                    f"prompt {i} holds non-integer token ids")
            out.append(row)
        return out

    @staticmethod
    def _validate_params(spec: dict) -> dict:
        steps = int(spec.get("steps", 16))
        if steps < 1:
            raise JobError(f"steps must be >= 1, got {steps}")
        params = {"steps": steps}
        for k in ("temperature", "top_k", "top_p", "eos_id"):
            if spec.get(k) is not None:
                params[k] = spec[k]
        return params

    def _get(self, job_id: str) -> _Job:
        with self._lock:
            job = self._jobs.get(job_id)
        if job is None:
            raise KeyError(f"no such job: {job_id}")
        return job

    def status(self, job_id: str) -> dict:
        job = self._get(job_id)
        with self._lock:
            done = len(job.done_idx)
            failed = len(job.failed_idx)
            running = sum(1 for j, _i in self._inflight if j == job_id)
            state = job.state
        total = len(job.prompts)
        return {
            "id": job.id, "state": state, "created": job.created,
            "prompts": total,
            "queued": max(total - done - running, 0),
            "running": running, "done": done, "failed": failed,
        }

    def results(self, job_id: str, offset: int = 0,
                limit: Optional[int] = None) -> dict:
        """One page of per-prompt results, in prompt order.  The store
        is the source of truth — only committed results appear, so a
        reader never sees work a crash could retract."""
        job = self._get(job_id)
        jobs_cfg = root.common.serve.jobs
        page = int(jobs_cfg.get("page_limit", 256)
                   if limit is None else limit)
        offset = max(int(offset), 0)
        total = len(job.prompts)
        out = []
        for idx in range(offset, min(offset + max(page, 0), total)):
            doc = self._store.read_result(job.id, idx)
            if doc is not None:
                out.append(doc)
        next_offset = offset + max(page, 0)
        return {"id": job.id, "offset": offset, "prompts": total,
                "results": out,
                **({"next_offset": next_offset}
                   if next_offset < total else {})}

    def cancel(self, job_id: str) -> dict:
        """Cancel: drop the job's queued work immediately and mark it
        terminal.  Dispatches already on the wire retire or fail on
        their replicas (their late answers are discarded below); the
        engine's lowest-class slots they occupy are reclaimed the
        moment any interactive request wants them — preemption, not
        cancellation, is the instant-yield path."""
        job = self._get(job_id)
        with self._lock:
            already = job.state in _TERMINAL
            if not already:
                job.state = "cancelled"
                self._counts["cancelled"] += 1
                self._work = collections.deque(
                    (j, i) for j, i in self._work if j != job_id)
                for key in [k for k in self._inflight
                            if k[0] == job_id]:
                    self._release_job_slot_locked(key)
        if not already:
            self._m_cancelled.inc()
            self._store.commit_manifest(job)
        return self.status(job_id)

    def list_jobs(self) -> dict:
        with self._lock:
            ids = sorted(self._jobs, key=lambda j: self._jobs[j].created)
        return {"jobs": [self.status(j) for j in ids]}

    def summary(self) -> dict:
        """The fleet-level view ``/fleet.json`` merges: job counts by
        state plus the live work backlog."""
        with self._lock:
            states: Dict[str, int] = {}
            for job in self._jobs.values():
                states[job.state] = states.get(job.state, 0) + 1
            return {
                "total": len(self._jobs),
                "by_state": states,
                "prompts_pending": len(self._work),
                "prompts_inflight": len(self._inflight),
                **{k: v for k, v in self._counts.items()},
            }

    def wait(self, job_id: str, timeout_s: float = 60.0) -> bool:
        """Block until the job is terminal (poll-based: terminality is
        a disk-backed property, not an in-memory event)."""
        deadline = time.monotonic() + float(timeout_s)
        while time.monotonic() < deadline:
            with self._lock:
                job = self._jobs.get(job_id)
                if job is not None and job.state in _TERMINAL:
                    return True
            time.sleep(0.02)
        return False

    # -- workers (host loop) -------------------------------------------------
    def _next_item(self) -> Optional[Tuple[str, int]]:
        with self._lock:                # the condition SHARES this lock
            while not self._stop_evt.is_set():
                if self._work:
                    return self._work.popleft()
                self._cv.wait(timeout=0.1)
        return None

    def _worker(self):
        """One dispatch worker: pure control plane — request bodies in,
        committed result files out; it never touches the device."""
        while not self._stop_evt.is_set():
            item = self._next_item()
            if item is None:
                return
            try:
                self._run_one(item)
            except Exception:  # noqa: BLE001 — a poisoned item must
                # not kill the worker pool; the item was released and
                # requeued (or recorded failed) by _run_one's own paths
                self.exception("job worker failed on %s", item)

    def _requeue(self, key: Tuple[str, int], delay_s: float):
        """Put a not-yet-terminal prompt back (at the back: FIFO over
        the remaining work) after releasing its slot, and back off so
        a closed trough is polled, not hammered."""
        self._release_job_slot(key)
        with self._lock:                # the condition SHARES this lock
            job = self._jobs.get(key[0])
            if job is not None and job.state not in _TERMINAL:
                self._work.append(key)
                self._cv.notify()
        if delay_s > 0:
            self._stop_evt.wait(timeout=min(float(delay_s), 2.0))

    def _run_one(self, key: Tuple[str, int]):
        job_id, idx = key
        with self._lock:
            job = self._jobs.get(job_id)
            stale = (job is None or job.state in _TERMINAL
                     or idx in job.done_idx or key in self._inflight)
        if stale:
            return
        self._acquire_job_slot(key)
        requeued = False
        try:
            try:
                status, doc, _headers = self._dispatch(
                    job.request_body(idx))
            except Exception as e:  # noqa: BLE001 — transport-level
                # dispatch failure (router gone, local engine raising
                # unexpectedly): transient, retry
                self.warning("job %s prompt %d dispatch failed: %s",
                             job_id, idx, e)
                requeued = True
                self._requeue(key, self.retry_s)
                return
            if status == 200 and isinstance(doc, dict):
                rows = doc.get("tokens") or [[]]
                self._commit(job, idx,
                             {"index": idx, "tokens": rows[0]})
                return
            if status == 429:
                retry = self.retry_s
                if isinstance(doc, dict) and doc.get("retry_after_s"):
                    try:
                        retry = max(retry,
                                    float(doc["retry_after_s"]))
                    except (TypeError, ValueError):
                        pass
                requeued = True
                self._requeue(key, retry)
                return
            if status == 400:
                # the replica REJECTED the prompt (length/vocab/params):
                # permanent — record it as this prompt's terminal result
                err = doc.get("error") if isinstance(doc, dict) \
                    else str(doc)
                self._commit(job, idx,
                             {"index": idx, "error": str(err)})
                return
            # 5xx/503/504: the fleet layer already failed over where it
            # could — whatever is left is transient from here
            requeued = True
            self._requeue(key, self.retry_s)
        finally:
            # _requeue releases before re-appending (a re-appended item
            # may already be re-acquired by another worker — a second
            # release here would drop THAT worker's ledger entry)
            if not requeued:
                self._release_job_slot(key)

    def _commit(self, job: _Job, idx: int, doc: dict):
        """Exactly-once result commit: the durable write lands first,
        then the in-memory done-set — a crash between the two re-runs
        nothing (the resume scan trusts the disk, and the pre-dispatch
        done-check consults the same set)."""
        with self._lock:
            if job.state in _TERMINAL or idx in job.done_idx:
                return          # cancelled mid-flight / duplicate race
        self._store.commit_result(job.id, idx, doc)
        finished = False
        with self._lock:
            job.done_idx.add(idx)
            if "error" in doc:
                job.failed_idx.add(idx)
                job.error_by_idx[idx] = doc["error"]
            if job.state not in _TERMINAL \
                    and len(job.done_idx) >= len(job.prompts):
                self._finish_job_locked(job)
                finished = True
        if finished:
            self._store.commit_manifest(job)
            self._m_completed.inc()

    def _finish_job_locked(self, job: _Job) -> None:  # requires-lock: self._lock
        job.state = "done"
        self._counts["completed"] += 1


def handle_jobs_request(manager: Optional[JobManager], method: str,
                        path: str, body: Optional[dict]
                        ) -> Optional[Tuple[int, object]]:
    """Shared REST glue for the job API — both the fleet server and a
    single replica route ``/jobs*`` requests here.  Returns
    ``(status, doc)`` or None when ``path`` is not a jobs route (the
    caller falls through to its own 404)."""
    from urllib.parse import parse_qs, urlparse
    parsed = urlparse(path)
    parts = [p for p in parsed.path.split("/") if p]
    if not parts or parts[0] != "jobs":
        return None
    if manager is None:
        return 404, {"error": "no job manager attached (set "
                              "serve.jobs.dir)"}
    try:
        if method == "POST" and len(parts) == 1:
            return 200, manager.submit(body or {})
        if method == "GET" and len(parts) == 1:
            return 200, manager.list_jobs()
        if method == "GET" and len(parts) == 2:
            return 200, manager.status(parts[1])
        if method == "GET" and len(parts) == 3 \
                and parts[2] == "results":
            q = parse_qs(parsed.query)
            offset = int(q.get("offset", ["0"])[0])
            limit = q.get("limit")
            return 200, manager.results(
                parts[1], offset,
                None if limit is None else int(limit[0]))
        if method == "DELETE" and len(parts) == 2:
            return 200, manager.cancel(parts[1])
    except KeyError as e:
        return 404, {"error": str(e)}
    except (JobError, TypeError, ValueError) as e:
        return 400, {"error": str(e)}
    return 404, {"error": f"unknown jobs route {parsed.path}"}
