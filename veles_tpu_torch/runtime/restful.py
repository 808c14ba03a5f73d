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
  with ``Retry-After`` and the un-rounded ``retry_after_s`` in the body;
* ``POST /generate`` with ``"stream": true`` (one prompt row, plus
  optional ``"stop"`` token-id sequences, the resume form's
  ``"emitted_prefix"`` and ``"deadline_s"``): NDJSON frames ``{"i": n,
  "token": t}`` numbered by global generated index, then one terminal
  ``{"done": true, "finish_reason", "usage"}`` line (+ ``"error"``),
  restful.py:766-920 of the JAX package;
* ``GET /healthz`` (liveness), ``GET /ready`` (200 once the engine runs),
  ``GET /engine`` (engine stats), ``GET /metrics`` (the registry's
  Prometheus text), ``GET /slo.json`` (the rolling SLO windows),
  restful.py:176-188 of the JAX package;
* ``GET /kv/pages?hashes=hex,hex`` or ``?top=K`` (the K hottest cached
  pages) answers the engine's serialized prefix pages (VTKV1,
  ``application/octet-stream``), and ``PUT /kv/pages`` imports such a
  blob (413 over ``serve.max_body_mb``, 400 on any validation defect or
  a dense engine, 504 when the import is not applied in time),
  restful.py:224-248 and :270-316.

Beam search (``beams``; ROADMAP.md queue 1 item 2), the batch lane
(``batch``; with the job manager, queue 1 item 7) and the deploy / jobs
/ experiments control planes come with later slices.
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
from .generate import generate
from .metrics import registry
from .slo import slo_tracker


def reply_json(handler, obj, code=200, headers=()):
    body = json.dumps(obj).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    for k, v in headers:
        handler.send_header(k, v)
    handler.end_headers()
    handler.wfile.write(body)


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
    /generate.  ``device`` defaults to the CUDA card."""

    def __init__(self, predict_fn: Callable, wstate, batch_size: int,
                 input_shape, *, port: int = 0, host: str = "127.0.0.1",
                 workflow=None, engine=None, input_dtype=np.int32,
                 device=None):
        self.device = resolve_device(device)
        self.predict_fn = predict_fn
        self.wstate = wstate
        self.batch_size = int(batch_size)
        self.input_shape = tuple(input_shape)
        self.input_dtype = np.dtype(input_dtype)
        self.workflow = workflow
        self.engine = engine
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _reply(self, obj, code=200, headers=()):
                reply_json(self, obj, code=code, headers=headers)

            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/")
                if path == "/metrics":
                    reply_bytes(self, registry().render().encode(),
                                "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/slo.json":
                    self._reply(slo_tracker().doc())
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
                    self.send_error(404)

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
                if path not in ("/predict", "/generate"):
                    self.send_error(404)
                    return
                try:
                    req = read_json_body(self)
                    if req is None:
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
        if self.engine is not None and not self.engine.started:
            return False, "engine not started"
        return True, "ok"

    def _vocab_size(self) -> Optional[int]:
        if self.workflow is None:
            return None
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

    def _refuse_unported(self, req: dict):
        if _req_int(req.get("beams", 1), "beams") != 1:
            raise ValueError("beams: beam search is not served by the port "
                             "yet (generate_beam, ROADMAP.md queue 1 "
                             "item 2)")
        if req.get("batch"):
            raise ValueError("batch: the batch lane is not served by the "
                             "port yet (it comes with the job manager, "
                             "ROADMAP.md queue 1 item 7)")

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
        self._refuse_unported(req)
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
        prompt = np.asarray(req["prompt"])
        if not np.issubdtype(prompt.dtype, np.integer):
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
        if self.engine is not None:
            toks = self.engine.generate(prompt.astype(np.int32), steps,
                                        priority=priority, **kw)
        else:
            toks = generate(self.workflow, self.wstate,
                            prompt.astype(np.int32), steps,
                            **kw).cpu().numpy()
        return {"tokens": np.asarray(toks).tolist()}

    def _stream_submit(self, req: dict):
        """Validate a ``{"stream": true}`` body and submit it to the
        engine's streaming path; returns ``(request, consumer timeout)``.
        Every error raises before a header is written, so a malformed
        body gets the unary path's 400/429/5xx."""
        if self.engine is None:
            raise ValueError(
                "streaming needs engine= serving (per-request "
                "generate() has no incremental token feed)")
        self._refuse_unported(req)
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

    def start(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="restful", daemon=True)
        self._thread.start()
        self.info("RESTful inference on http://127.0.0.1:%d/predict",
                  self.port)
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(10)
            self._thread = None
