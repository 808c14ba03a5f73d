"""HTTP serving front (a subset of veles_tpu/runtime/restful.py).

* ``POST /predict`` ``{"input": [[...]]}`` -> ``{"output": [...]}``: the
  full forward of the workflow's head, batched and padded to the build
  batch size (on the card the attention runs the flash-forward kernel);
* ``POST /generate`` ``{"prompt": [[...]], "steps": N, "temperature",
  "top_k", "top_p", "eos_id", "seed"}`` -> ``{"tokens": [[...]]}``:
  through the continuous-batching :class:`DecodeEngine` when one is
  attached, else the port's ``generate()``; a full queue or page pool
  answers 429 with ``Retry-After``;
* ``GET /healthz`` (liveness), ``GET /ready`` (200 once the engine runs),
  ``GET /engine`` (engine stats).

Beam search, streaming and the deploy / jobs / experiments control
planes come with later slices.
"""

from __future__ import annotations

import http.server
import json
import threading
from typing import Callable, Optional

import numpy as np
import torch

from ..config import root
from ..logger import Logger
from ..ops import resolve_device
from .engine import EngineOverloaded, EngineStopped, SchedulerCrashed
from .generate import generate


def reply_json(handler, obj, code=200, headers=()):
    body = json.dumps(obj).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    for k, v in headers:
        handler.send_header(k, v)
    handler.end_headers()
    handler.wfile.write(body)


def read_json_body(handler):
    """POST body as JSON, or None after answering 413 itself when the
    body exceeds ``root.common.serve.max_body_mb``."""
    n = max(int(handler.headers.get("Content-Length", 0)), 0)
    cap = int(float(root.common.serve.get("max_body_mb", 64)) * 2 ** 20)
    if n > cap:
        reply_json(handler, {"error": f"request body {n} bytes exceeds the "
                                      f"{cap} byte cap "
                                      "(root.common.serve.max_body_mb)"},
                   code=413)
        return None
    return json.loads(handler.rfile.read(n)) if n else {}


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
                if path == "/healthz":
                    self._reply({"status": "alive"})
                elif path == "/ready":
                    ok, why = outer.readiness()
                    self._reply({"ready": ok, "reason": why},
                                code=200 if ok else 503)
                elif path == "/engine" and outer.engine is not None:
                    self._reply(outer.engine.stats())
                else:
                    self.send_error(404)

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
            vocab = self._vocab_size()
            hi = vocab if vocab is not None else 2 ** 31
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

    def decode(self, req: dict) -> dict:
        """POST /generate body -> {"tokens": [[...]]}."""
        if self.workflow is None and self.engine is None:
            raise ValueError("this server has no workflow or engine; "
                             "/generate is off")
        unported = [k for k in ("stream", "stop", "emitted_prefix",
                                "batch", "priority") if req.get(k)]
        if _req_int(req.get("beams", 1), "beams") != 1:
            unported.append("beams")
        if unported:
            raise ValueError(f"{unported} not served by this slice of the "
                             "port (ROADMAP.md slice 5)")
        prompt = np.asarray(req["prompt"])
        if not np.issubdtype(prompt.dtype, np.integer):
            raise ValueError("prompt token ids must be integers "
                             f"(got dtype {prompt.dtype})")
        prompt = prompt.astype(np.int64)
        if prompt.ndim != 2 or 0 in prompt.shape:
            raise ValueError("prompt must be a non-empty 2-D "
                             "[[ids], ...] array")
        vocab = self._vocab_size()
        hi = vocab if vocab is not None else 2 ** 31
        if prompt.min() < 0 or prompt.max() >= hi:
            raise ValueError(
                f"prompt token ids must be in [0, {hi}) "
                f"(got min {prompt.min()}, max {prompt.max()})")
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
        kw = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                  eos_id=eos_id, seed=seed)
        if self.engine is not None:
            toks = self.engine.generate(prompt.astype(np.int32), steps,
                                        **kw)
        else:
            toks = generate(self.workflow, self.wstate,
                            prompt.astype(np.int32), steps,
                            **kw).cpu().numpy()
        return {"tokens": np.asarray(toks).tolist()}

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
