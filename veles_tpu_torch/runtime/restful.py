"""HTTP serving front (a subset of veles_tpu/runtime/restful.py).

* ``POST /predict`` ``{"input": [[...]]}`` -> ``{"output": [...]}``: the
  full forward of the workflow's head, batched and padded to the build
  batch size (on the card the attention runs the flash-forward kernel);
* ``POST /generate`` ``{"prompt": [[...]], "steps": N, "temperature",
  "top_k", "top_p", "eos_id", "seed", "priority"}`` -> ``{"tokens":
  [[...]]}``: through the continuous-batching :class:`DecodeEngine` when
  one is attached, else the port's ``generate()``.  The request class
  comes from the body's ``priority`` or the ``X-Priority`` header (the
  body wins, restful.py:457-471 of the JAX package); a shed answers 429
  with ``Retry-After`` and the un-rounded ``retry_after_s`` in the body.
  ``"batch": true`` (engine only, unary, no priority) rides the engine's
  trough class below every priority (restful.py:691-703); a closed
  trough answers 429 with its short hint;
* ``POST /generate`` with ``"stream": true`` (one prompt row, plus
  optional ``"stop"`` token-id sequences, the resume form's
  ``"emitted_prefix"`` and ``"deadline_s"``): NDJSON frames ``{"i": n,
  "token": t}`` numbered by global generated index, then one terminal
  ``{"done": true, "finish_reason", "usage"}`` line (+ ``"error"``),
  restful.py:766-920 of the JAX package;
* ``POST /generate`` with ``"beams": W > 1`` (``"eos_id"``,
  ``"length_penalty"``): deterministic beam search
  (:func:`~.generate.generate_beam`, outside the engine's queue) ->
  ``{"tokens", "scores"}``, the JAX package's size guard and refusals
  (restful.py:612-720);
* ``GET /healthz`` (liveness), ``GET /ready`` (200 once the engine runs
  and nobody drains, else 503), ``GET /engine`` (engine stats), ``GET
  /metrics`` (the registry's Prometheus text), ``GET /slo.json`` (the
  rolling SLO windows), ``GET /memory.json`` (the device's allocator
  counters and the component ledger), ``GET /trace.json`` (the span
  ring's request timelines, Chrome-trace JSON), ``POST /debug/profile``
  (a duration-bounded ``torch.profiler`` capture, 409 while one runs),
  restful.py:176-216 of the JAX package;
* with a :class:`~.deploy.DeployController` attached (it sets
  ``server.deploy``): ``GET /models`` (the versioned registry) and
  ``POST /admin/reload`` (hot swap; 409 with the old version still
  serving on a load or signature failure), ``/admin/stage``,
  ``/admin/commit``, ``/admin/abort`` (the two halves of a swap) and
  ``/admin/drain`` (202; ``/ready`` and new ``/generate`` requests
  then answer 503), restful.py:351-456;
* ``GET /kv/pages?hashes=hex,hex`` or ``?top=K`` (the K hottest cached
  pages) answers the engine's serialized prefix pages (VTKV1,
  ``application/octet-stream``), and ``PUT /kv/pages`` imports such a
  blob (413 over ``serve.max_body_mb``, 400 on any validation defect or
  a dense engine, 504 when the import is not applied in time),
  restful.py:224-248 and :270-316;
* with ``jobs_dir`` (and an engine): the durable batch job API of
  :mod:`.jobs` against this replica (``POST /jobs``, ``GET /jobs``,
  ``GET /jobs/<id>``, ``GET /jobs/<id>/results``, ``DELETE
  /jobs/<id>``), its dispatch in-process through :meth:`RestfulServer.
  decode` with the handler's status mapping (restful.py:920-941).

:func:`reply_json`, :func:`reply_metrics_text` and
:func:`read_json_body` are shared with the fleet router's front
(``runtime/fleet.py``).  The experiments endpoints come with a later
slice.
"""

from __future__ import annotations

import http.server
import json
import threading
from typing import Callable, Optional
from urllib.parse import parse_qs, urlsplit

import numpy as np
import torch

from ..config import root
from ..logger import Logger
from ..ops import resolve_device
from .engine import EngineOverloaded, EngineStopped, SchedulerCrashed
from .generate import generate, generate_beam
from .jobs import JobManager, handle_jobs_request
from .memory import memory_monitor
from .metrics import registry, span_ring
from .profiler import serve_profile_post
from .slo import slo_tracker
from .snapshotter import SnapshotCorruptError

_ADMIN = ("/admin/reload", "/admin/drain", "/admin/stage", "/admin/commit",
          "/admin/abort")


def reply_json(handler, obj, code=200, headers=()):
    body = json.dumps(obj).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    for k, v in headers:
        handler.send_header(k, v)
    handler.end_headers()
    handler.wfile.write(body)


def reply_metrics_text(handler):
    """``GET /metrics``: the registry's Prometheus text, as every server
    of the serving stack (and the fleet router's front) answers it."""
    reply_bytes(handler, registry().render().encode(),
                "text/plain; version=0.0.4; charset=utf-8")


def reply_bytes(handler, body: bytes, content_type: str):
    handler.send_response(200)
    handler.send_header("Content-Type", content_type)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def read_body(handler):
    """The request body's bytes, or None after answering 413 itself when
    it exceeds ``root.common.serve.max_body_mb`` (checked before the
    body is read)."""
    n = max(int(handler.headers.get("Content-Length", 0)), 0)
    cap = int(float(root.common.serve.get("max_body_mb", 64)) * 2 ** 20)
    if n > cap:
        reply_json(handler, {"error": f"request body {n} bytes exceeds the "
                                      f"{cap} byte cap "
                                      "(root.common.serve.max_body_mb)"},
                   code=413)
        return None
    return handler.rfile.read(n) if n else b""


def read_json_body(handler):
    """POST body as JSON, or None after answering 413 itself (see
    :func:`read_body`)."""
    body = read_body(handler)
    if body is None:
        return None
    return json.loads(body) if body else {}


def _req_int(v, name):
    """Integral coercion for JSON numerics (2 / 2.0 / "2" -> 2; 2.5,
    "x", booleans -> ValueError, the 400 path)."""
    if isinstance(v, bool):
        raise ValueError(f"{name} must be an integer, got {v!r}")
    try:
        f = float(v)
        i = int(f)
        if f != i:
            raise ValueError
        return i
    except (TypeError, ValueError, OverflowError):
        raise ValueError(f"{name} must be an integer, got {v!r}") from None


class RestfulServer(Logger):
    """``predict_fn(wstate, batch) -> tensor`` serves /predict over
    (batch_size, *input_shape) inputs; ``workflow`` / ``engine`` enable
    /generate; ``jobs_dir`` (with an engine) the job API.  ``device``
    defaults to the CUDA card.  The server does not own the engine:
    whoever built it starts and stops it.  Without a workflow (a
    compiled artifact's :class:`~.artifact.ArtifactRunner` as the
    engine, its sealed forward as ``predict_fn``) the token bound is
    ``vocab_size`` or the engine's, and ``default_eos_id`` is the eos of
    a request that names none (restful.py:131-152 of the JAX
    package)."""

    def __init__(self, predict_fn: Callable, wstate, batch_size: int,
                 input_shape, *, port: int = 0, host: str = "127.0.0.1",
                 workflow=None, engine=None, input_dtype=np.int32,
                 device=None, jobs_dir: Optional[str] = None,
                 default_eos_id: Optional[int] = None,
                 vocab_size: Optional[int] = None):
        self.device = resolve_device(device)
        # the eos of a request that names none (a compiled artifact's
        # sealed eos), and the input-vocabulary bound of workflow-less
        # serving (the artifact's embedding rows)
        self.default_eos_id = (None if default_eos_id is None
                               else int(default_eos_id))
        self.vocab_size = None if vocab_size is None else int(vocab_size)
        self.predict_fn = predict_fn
        self.wstate = wstate
        self.batch_size = int(batch_size)
        self.input_shape = tuple(input_shape)
        self.input_dtype = np.dtype(input_dtype)
        self.workflow = workflow
        self.engine = engine
        self.deploy = None          # a DeployController sets itself here
        # the batch lane's job API against this replica's engine
        self.jobs: Optional[JobManager] = None
        if jobs_dir and engine is not None:
            self.jobs = JobManager(jobs_dir, self._local_dispatch)
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _reply(self, obj, code=200, headers=()):
                reply_json(self, obj, code=code, headers=headers)

            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/")
                if path == "/metrics":
                    reply_metrics_text(self)
                elif path == "/slo.json":
                    self._reply(slo_tracker().doc())
                elif path == "/memory.json":
                    self._reply(memory_monitor().doc())
                elif path == "/trace.json":
                    body = json.dumps(span_ring().chrome_trace(),
                                      default=repr).encode()
                    reply_bytes(self, body, "application/json")
                elif path == "/models" and outer.deploy is not None:
                    self._reply(outer.deploy.models_doc())
                elif path == "/kv/pages" and outer.engine is not None:
                    try:
                        blob = outer.export_kv_pages(
                            parse_qs(urlsplit(self.path).query))
                    except ValueError as e:
                        self._reply({"error": str(e)}, code=400)
                        return
                    reply_bytes(self, blob, "application/octet-stream")
                elif path == "/healthz":
                    self._reply({"status": "alive"})
                elif path == "/ready":
                    ok, why = outer.readiness()
                    self._reply({"ready": ok, "reason": why},
                                code=200 if ok else 503)
                elif path == "/engine" and outer.engine is not None:
                    self._reply(outer.engine.stats())
                else:
                    self._jobs_or_404("GET", None)

            def _jobs_or_404(self, method, body):
                hit = handle_jobs_request(outer.jobs, method, self.path,
                                          body)
                if hit is None:
                    self.send_error(404)
                else:
                    self._reply(hit[1], code=hit[0])

            def do_DELETE(self):
                # DELETE /jobs/<id>: cancel a batch job
                self._jobs_or_404("DELETE", None)

            def do_PUT(self):
                path = self.path.split("?", 1)[0].rstrip("/")
                if path != "/kv/pages" or outer.engine is None:
                    self.send_error(404)
                    return
                blob = read_body(self)
                if blob is None:
                    return
                try:
                    self._reply(outer.engine.import_pages(blob))
                except ValueError as e:
                    self._reply({"error": str(e)}, code=400)
                except TimeoutError as e:
                    self._reply({"error": str(e)}, code=504)
                except Exception as e:  # noqa: BLE001 — server answers
                    self.log_error("KV-page import failed: %r", e)
                    self._reply({"error": f"{type(e).__name__}: {e}"},
                                code=500)

            def do_POST(self):
                path = self.path.split("?", 1)[0].rstrip("/")
                if path == "/debug/profile":
                    # blocks this handler thread for the capture; other
                    # requests keep flowing
                    code, obj = serve_profile_post(self.headers,
                                                   self.rfile)
                    self._reply(obj, code=code)
                    return
                if path == "/jobs" or path.startswith("/jobs/"):
                    try:
                        body = read_json_body(self)
                    except json.JSONDecodeError as e:
                        self._reply({"error": str(e)}, code=400)
                        return
                    if body is not None:
                        self._jobs_or_404("POST", body)
                    return
                if path in _ADMIN and outer.deploy is None:
                    self._reply({"error": "no deploy control plane "
                                          "attached (serve with "
                                          "DeployController / "
                                          "--model-dir)"}, code=404)
                    return
                if path not in ("/predict", "/generate") + _ADMIN:
                    self.send_error(404)
                    return
                try:
                    req = read_json_body(self)
                    if req is None:
                        return
                    if path in _ADMIN:
                        code, obj = outer.admin(path, req)
                        self._reply(obj, code=code)
                        return
                    if path == "/generate":
                        # the X-Priority header is the proxy-friendly
                        # spelling of the body key; the body wins
                        hdr = self.headers.get("X-Priority")
                        if hdr is not None:
                            req.setdefault("priority", hdr)
                        if req.get("stream"):
                            # errors raise before any header is written
                            outer.stream_generate(req, self)
                            return
                        self._reply(outer.decode(req))
                    else:
                        self._reply({"output":
                                     outer.infer(req["input"]).tolist()})
                except EngineOverloaded as e:
                    self._reply(
                        {"error": str(e),
                         "retry_after_s": round(e.retry_after_s, 3)},
                        code=429,
                        headers=(("Retry-After",
                                  str(max(1, int(round(e.retry_after_s))))),
                                 ))
                except SchedulerCrashed as e:
                    self._reply({"error": str(e),
                                 "kind": "scheduler_crash"}, code=500)
                except EngineStopped as e:
                    self._reply({"error": str(e)}, code=503,
                                headers=(("Retry-After", "5"),))
                except TimeoutError as e:
                    self._reply({"error": str(e)}, code=504)
                except (KeyError, TypeError, ValueError,
                        json.JSONDecodeError) as e:
                    self._reply({"error": str(e)}, code=400)
                except Exception as e:  # noqa: BLE001 — server answers
                    self.log_error("request failed: %r", e)
                    self._reply({"error": f"{type(e).__name__}: {e}"},
                                code=500)

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def export_kv_pages(self, query: dict) -> bytes:
        """GET /kv/pages: ``top=K`` ships the K hottest cached pages,
        else ``hashes=hex,hex`` names them; ValueError (400) on a dense
        engine or a malformed query."""
        if "top" in query:
            hashes = self.engine.hot_page_hashes(
                _req_int(query["top"][0], "top"))
        else:
            hashes = [h for part in query.get("hashes", [])
                      for h in part.split(",") if h]
        return self.engine.export_pages(hashes)

    def readiness(self):
        """(ready, reason) for ``GET /ready``: nobody drains and the
        engine (if any) runs."""
        if self.deploy is not None and self.deploy.draining:
            return False, "draining"
        if self.engine is not None:
            if self.engine.draining:
                return False, "draining"
            if not self.engine.started:
                return False, "engine not started"
        return True, "ok"

    def admin(self, path: str, req: dict):
        """``POST /admin/*`` -> (status, body).  A load, signature or
        flip-timeout failure is 409 with the old version still serving;
        a malformed request 400; an unknown registry version 404; a
        draining engine raises :class:`EngineDraining` (the caller's
        503)."""
        dep = self.deploy
        if path == "/admin/drain":
            return 202, dep.begin_drain(handoff=req.get("handoff"))
        if path == "/admin/abort":
            return 200, dep.abort_staged(req.get("token"))
        if path == "/admin/commit" and not req.get("token"):
            return 400, {"error": 'commit needs the {"token": ...} stage '
                                  'returned'}
        source = req.get("source") or req.get("path")
        if path != "/admin/commit" and source is None \
                and req.get("version") is None:
            return 400, {"error": f'{path.rsplit("/", 1)[1]} needs '
                                  '{"path": ...} (or "source"/"version")'}
        try:
            if path == "/admin/commit":
                return 200, dep.commit_staged(req["token"])
            fn = dep.reload if path == "/admin/reload" else dep.stage
            return 200, fn(source=source, version=req.get("version"))
        except KeyError as e:
            return 404, {"error": str(e)}
        except (ValueError, OSError, TimeoutError,
                SnapshotCorruptError) as e:
            return 409, {"error": f"{type(e).__name__}: {e}",
                         "active": dep.registry.active_version}

    def _vocab_size(self) -> Optional[int]:
        if self.workflow is None:
            if self.vocab_size is not None:
                return self.vocab_size
            v = getattr(self.engine, "_input_vocab", None)
            return int(v) if v else None
        from ..units.nn import input_vocab
        return input_vocab(self.workflow, self.wstate["params"])

    def infer(self, x) -> np.ndarray:
        """The head's output for every row of ``x``, in chunks of the
        build batch size (the last chunk zero-padded)."""
        if np.issubdtype(self.input_dtype, np.integer):
            xi = np.asarray(x, np.int64)
            hi = self._vocab_bound()
            if xi.size and (xi.min() < 0 or xi.max() >= hi):
                raise ValueError(
                    f"input token ids must be in [0, {hi}) "
                    f"(got min {xi.min()}, max {xi.max()})")
            x = xi.astype(self.input_dtype)
        else:
            x = np.asarray(x, self.input_dtype)
        if x.shape[1:] != self.input_shape:
            raise ValueError(
                f"input shape {x.shape[1:]} != expected {self.input_shape}")
        outs = []
        bs = self.batch_size
        for i in range(0, len(x), bs):
            chunk = x[i:i + bs]
            valid = len(chunk)
            if valid < bs:
                chunk = np.concatenate(
                    [chunk, np.zeros((bs - valid,) + self.input_shape,
                                     self.input_dtype)])
            batch = {"@input": torch.from_numpy(chunk).to(self.device)}
            y = self.predict_fn(self.wstate, batch)[:valid]
            outs.append(y.float().cpu().numpy())
        return np.concatenate(outs)

    def _sampling(self, req: dict, hi: int):
        """steps and the sampling fields of a /generate body, checked."""
        steps = _req_int(req.get("steps", 16), "steps")
        if not 0 < steps <= 65536:
            raise ValueError(f"steps must be in [1, 65536], got {steps}")
        temperature = float(req.get("temperature", 0.0))
        top_p = req.get("top_p")
        top_p = None if top_p is None else float(top_p)
        top_k = req.get("top_k")
        top_k = None if top_k is None else _req_int(top_k, "top_k")
        if (top_k is not None or top_p is not None) and temperature <= 0:
            raise ValueError(
                "top_k/top_p filter sampling and need temperature > 0 "
                "(temperature 0 is greedy decoding)")
        eos_id = req.get("eos_id")
        if eos_id is None:
            eos_id = self.default_eos_id
        if eos_id is not None:
            eos_id = _req_int(eos_id, "eos_id")
            if not 0 <= eos_id < hi:
                raise ValueError(f"eos_id {eos_id} is outside the model "
                                 f"vocabulary [0, {hi})")
        seed = _req_int(req.get("seed", 0), "seed")
        return steps, dict(temperature=temperature, top_k=top_k,
                           top_p=top_p, eos_id=eos_id, seed=seed)

    def _vocab_bound(self) -> int:
        vocab = self._vocab_size()
        return vocab if vocab is not None else 2 ** 31

    def decode(self, req: dict) -> dict:
        """POST /generate body -> {"tokens": [[...]]}."""
        if self.workflow is None and self.engine is None:
            raise ValueError("this server has no workflow or engine; "
                             "/generate is off")
        beams = _req_int(req.get("beams", 1), "beams")
        if beams < 1:
            raise ValueError(f"beams must be >= 1, got {beams}")
        if req.get("stop") is not None \
                or req.get("emitted_prefix") is not None:
            # ignoring either would answer a wrong unary 200
            raise ValueError(
                'stop and emitted_prefix ride the streaming path; add '
                '{"stream": true}')
        priority = _req_int(req.get("priority", 0), "priority")
        if priority and self.engine is None:
            raise ValueError(
                "priority classes need engine= serving (per-request "
                "generate() has no queue to prioritize)")
        # the batch lane: the engine's trough class, which IS the class
        batch = bool(req.get("batch", False))
        if batch and self.engine is None:
            raise ValueError("batch-class requests need engine= serving "
                             "(per-request generate() has no trough to "
                             "fill)")
        if batch and priority:
            raise ValueError("batch rides the trough class below every "
                             "priority; drop the priority key (or drop "
                             "batch)")
        prompt = np.asarray(req["prompt"])
        # whole-valued floats (2.0) are ids, as the JAX package's unary
        # path takes them; a fraction is refused, never truncated
        if not np.issubdtype(prompt.dtype, np.integer) and not (
                np.issubdtype(prompt.dtype, np.floating)
                and np.all(np.isfinite(prompt))
                and np.all(prompt == np.floor(prompt))):
            raise ValueError("prompt token ids must be integers "
                             f"(got dtype {prompt.dtype})")
        prompt = prompt.astype(np.int64)
        if prompt.ndim != 2 or 0 in prompt.shape:
            raise ValueError("prompt must be a non-empty 2-D "
                             "[[ids], ...] array")
        hi = self._vocab_bound()
        if prompt.min() < 0 or prompt.max() >= hi:
            raise ValueError(
                f"prompt token ids must be in [0, {hi}) "
                f"(got min {prompt.min()}, max {prompt.max()})")
        steps, kw = self._sampling(req, hi)
        B, P = prompt.shape
        if B * beams * (P + steps) > 1_048_576:
            # beam search multiplies every cache by its width
            raise ValueError(
                f"request too large: batch {B} x beams {beams} x total "
                f"length {P + steps} exceeds the 2^20 token-cell cap")
        if beams > 1:
            if batch:
                raise ValueError("beam search runs outside the engine "
                                 "queue; the batch lane applies to beams=1 "
                                 "requests")
            return self._beam(req, prompt, steps, beams, priority, kw)
        if req.get("length_penalty"):
            raise ValueError(
                "length_penalty shapes beam scores and needs beams > 1")
        if self.engine is not None:
            toks = self.engine.generate(prompt.astype(np.int32), steps,
                                        priority=priority, batch=batch,
                                        **kw)
        else:
            toks = generate(self.workflow, self.wstate,
                            prompt.astype(np.int32), steps,
                            **kw).cpu().numpy()
        return {"tokens": np.asarray(toks).tolist()}

    def _beam(self, req, prompt, steps, beams, priority, kw) -> dict:
        """``beams > 1``: beam search over the live workflow and the
        served weights, outside the engine's queue."""
        if self.workflow is None:
            raise ValueError("beam search needs the live workflow "
                             "(RestfulServer(..., workflow=wf))")
        if kw["temperature"] > 0 or req.get("seed") is not None:
            raise ValueError(
                "beams is deterministic search; drop temperature/top_k/"
                "top_p/seed or use beams=1")
        if priority:
            raise ValueError(
                "beam search runs outside the engine queue; priority "
                "classes apply to beams=1 requests")
        length_penalty = float(req.get("length_penalty", 0.0))
        if length_penalty < 0:
            raise ValueError(
                f"length_penalty must be >= 0, got {length_penalty}")
        wstate = (self.engine.wstate if self.engine is not None
                  else self.wstate)
        toks, scores = generate_beam(
            self.workflow, wstate, prompt.astype(np.int32), steps,
            beams=beams, eos_id=kw["eos_id"],
            length_penalty=length_penalty)
        return {"tokens": toks.cpu().numpy().tolist(),
                "scores": scores.cpu().numpy().tolist()}

    def _stream_submit(self, req: dict):
        """Validate a ``{"stream": true}`` body and submit it to the
        engine's streaming path; returns ``(request, consumer timeout)``.
        Every error raises before a header is written, so a malformed
        body gets the unary path's 400/429/5xx."""
        if self.engine is None:
            raise ValueError(
                "streaming needs engine= serving (per-request "
                "generate() has no incremental token feed)")
        if req.get("batch"):
            raise ValueError("the batch lane is unary; drop stream or batch")
        if _req_int(req.get("beams", 1), "beams") != 1:
            raise ValueError("streaming supports beams=1 only")
        prompt = np.asarray(req["prompt"])
        if not np.issubdtype(prompt.dtype, np.integer):
            raise ValueError("prompt token ids must be integers "
                             f"(got dtype {prompt.dtype})")
        if prompt.ndim == 2 and prompt.shape[0] == 1:
            prompt = prompt.reshape(-1)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("a streamed prompt is ONE non-empty "
                             "sequence: [ids] or [[ids]]")
        hi = self._vocab_bound()
        if prompt.min() < 0 or prompt.max() >= hi:
            raise ValueError(
                f"prompt token ids must be in [0, {hi}) "
                f"(got min {prompt.min()}, max {prompt.max()})")
        steps, kw = self._sampling(req, hi)
        priority = _req_int(req.get("priority", 0), "priority")
        pref = req.get("emitted_prefix")
        if pref is not None:
            pref = np.asarray(pref)
            if pref.size and not np.issubdtype(pref.dtype, np.integer):
                raise ValueError("emitted_prefix must hold integer "
                                 "token ids")
            pref = pref.reshape(-1).astype(np.int64)
        stop = req.get("stop")
        if stop is not None:
            if not isinstance(stop, (list, tuple)):
                raise ValueError(
                    'stop must be a list of token-id sequences, e.g. '
                    '{"stop": [[13, 198]]}')
            stop = [np.asarray(s, np.int64).reshape(-1) for s in stop]
            for s in stop:
                if s.size and (s.min() < 0 or s.max() >= hi):
                    raise ValueError(f"stop token ids must be in [0, {hi})")
        deadline_s = req.get("deadline_s")
        if deadline_s is not None:
            deadline_s = float(deadline_s)
            if not deadline_s > 0:
                raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        r = self.engine.submit(
            prompt.astype(np.int32), steps, deadline_s=deadline_s,
            priority=priority, stream=True, emitted_prefix=pref, stop=stop,
            **kw)
        # a hang guard over the engine-enforced deadline, not a second one
        wait = (deadline_s if deadline_s is not None
                else self.engine.deadline_s) + 30.0
        return r, wait

    def stream_generate(self, req: dict, handler):
        """POST /generate with ``{"stream": true}``: one NDJSON line per
        token frame, then exactly one terminal line; the reply closes the
        connection to frame the stream."""
        r, wait = self._stream_submit(req)
        h = r.stream
        handler.send_response(200)
        handler.send_header("Content-Type", "application/x-ndjson")
        handler.send_header("Cache-Control", "no-store")
        handler.send_header("Connection", "close")
        handler.end_headers()
        try:
            for ev in h.events(timeout_s=wait):
                if ev[0] == "token":
                    line = {"i": ev[1], "token": ev[2]}
                else:
                    _, reason, err = ev
                    line = {"done": True, "finish_reason": reason,
                            "usage": {"prompt_tokens": h.prompt_tokens,
                                      "completion_tokens": int(h.next_i)}}
                    if err is not None:
                        line["error"] = err
                handler.wfile.write((json.dumps(line) + "\n").encode())
                handler.wfile.flush()
        except TimeoutError:
            # the hang guard tripped: a best-effort terminal frame
            try:
                handler.wfile.write((json.dumps(
                    {"done": True, "finish_reason": "error",
                     "error": "stream stalled past its deadline"})
                    + "\n").encode())
            except OSError:
                pass
        except OSError:
            # the consumer went away; the request retires unary
            pass

    def _local_dispatch(self, body: dict):
        """The job manager's dispatch against this replica: :meth:`decode`
        with the handler's status mapping, as the ``(status, doc,
        headers)`` the fleet router's ``handle_generate`` returns too."""
        try:
            return 200, self.decode(body), ()
        except EngineOverloaded as e:
            return 429, {"error": str(e),
                         "retry_after_s": round(e.retry_after_s, 3)}, ()
        except SchedulerCrashed as e:
            return 500, {"error": str(e), "kind": "scheduler_crash"}, ()
        except EngineStopped as e:
            return 503, {"error": str(e)}, ()
        except TimeoutError as e:
            return 504, {"error": str(e)}, ()
        except (KeyError, TypeError, ValueError) as e:
            return 400, {"error": str(e)}, ()

    def start(self):
        if self.jobs is not None:
            self.jobs.start()
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="restful", daemon=True)
        self._thread.start()
        self.info("RESTful inference on http://127.0.0.1:%d/predict",
                  self.port)
        return self

    def stop(self):
        if self.jobs is not None:
            # stop scheduling batch dispatches first; committed results
            # survive for the next manager
            self.jobs.stop()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(10)
            self._thread = None
