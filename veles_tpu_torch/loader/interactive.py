"""Streaming / interactive loaders.

Reference parity:
* ``InteractiveLoader`` (reference: veles/loader/interactive.py:57 — feed()
  samples from a REPL into a running workflow),
* ``ZeroMQLoader`` (reference: veles/zmq_loader.py:74-138 — ROUTER-socket
  job queue on slaves).

TPU redesign: a thread-safe queue loader covers both — producers call
``feed()`` from any thread (REPL, HTTP handler, socket reader); the
training/inference loop consumes fixed-size batches. The ZMQ transport
itself is dropped (SPMD needs no job sockets); network feeding composes as
"HTTP server thread -> QueueLoader.feed".

(The port's copy of veles_tpu/loader/interactive.py, which holds no
JAX: the same batches from the same files, rewired to the port's
package.)
"""

from __future__ import annotations

import queue
import struct
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from .. import wire
from .base import Loader, TRAIN

#: a frame on the socket: magic + u32 length + wire body (the JAX
#: package's veles_tpu/graphics.py framing, so either package's producer
#: feeds either package's loader)
_MAGIC = b"VTPL"


def _send_frame(sock, payload: bytes) -> None:
    sock.sendall(_MAGIC + struct.pack("<I", len(payload)) + payload)


def _recv_exact(sock, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def recv_frame(sock):
    """The next frame's payload, or None at the end of the stream (or
    a stream that is not framed)."""
    head = _recv_exact(sock, 8)
    if head is None or head[:4] != _MAGIC:
        return None
    (length,) = struct.unpack("<I", head[4:])
    if length > wire.MAX_FRAME:
        raise wire.WireError(f"frame length {length} exceeds cap")
    body = _recv_exact(sock, length)
    if body is None:
        return None
    return wire.loads(body)


class QueueLoader(Loader):
    """Serve batches from a thread-safe queue of fed samples."""

    def __init__(self, input_shape, minibatch_size=1, *, maxsize: int = 0,
                 **kw):
        super().__init__(minibatch_size=minibatch_size, **kw)
        self.input_shape = tuple(input_shape)
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._closed = threading.Event()

    def feed(self, sample, label: Optional[int] = None) -> None:
        """Enqueue one sample (thread-safe)."""
        arr = np.asarray(sample, np.float32)
        if arr.shape != self.input_shape:
            raise ValueError(
                f"sample shape {arr.shape} != {self.input_shape}")
        self._q.put((arr, label))

    def close(self) -> None:
        """No more samples; pending partial batch is flushed padded."""
        self._closed.set()
        self._q.put(None)  # wake the consumer

    def load_data(self):
        # Unbounded stream: lengths unknown; report one pseudo-sample so
        # initialize() passes (the reference's interactive loader did the
        # same trick with a fake single-sample epoch).
        self.class_lengths = [0, 0, self.minibatch_size]

    def fill_minibatch(self, indices, klass):
        raise NotImplementedError("QueueLoader serves from the queue")

    def iter_epoch(self, klass: int, epoch=None
                   ) -> Iterator[Dict[str, np.ndarray]]:
        if klass != TRAIN:
            return
        if self._closed.is_set() and self._q.empty():
            return  # stream ended; later epochs must not block on get()
        bs = self.minibatch_size
        buf, labels = [], []
        while True:
            item = self._q.get()
            if item is None:
                # re-arm the sentinel so a subsequent iter_epoch (or a
                # concurrent consumer) also terminates instead of blocking
                self._q.put(None)
                break
            buf.append(item[0])
            labels.append(item[1] if item[1] is not None else 0)
            if len(buf) == bs:
                yield self._emit(buf, labels, bs)
                buf, labels = [], []
            if self._closed.is_set() and self._q.empty():
                break
        if buf:
            yield self._emit(buf, labels, bs)

    def _emit(self, buf, labels, bs):
        valid = len(buf)
        while len(buf) < bs:
            buf.append(np.zeros(self.input_shape, np.float32))
            labels.append(0)
        mask = np.zeros(bs, np.float32)
        mask[:valid] = 1.0
        return {"@input": np.stack(buf),
                "@labels": np.asarray(labels, np.int32),
                "@mask": mask}


class SocketLoader(QueueLoader):
    """Network job queue: a TCP listener feeds the queue with sample
    frames (reference: ZeroMQLoader's ROUTER socket job queue,
    veles/zmq_loader.py:74-138 — the Mastodon/Hadoop contact point).

    Frames use the package's length-prefixed framing with the pickle-free
    ``veles_tpu_torch.wire`` serializer (JSON header + raw array bytes): each
    frame is ``{"input": array, "label": int?}`` or ``{"kind": "close"}``
    to end the stream.  A hostile peer can inject bogus samples but never
    execute code — unlike the reference's pickled ZMQ payloads."""

    def __init__(self, input_shape, minibatch_size=1, *, port: int = 0,
                 host: str = "127.0.0.1", **kw):
        super().__init__(input_shape, minibatch_size, **kw)
        import socket as _socket
        self._listener = _socket.socket(_socket.AF_INET,
                                        _socket.SOCK_STREAM)
        self._listener.setsockopt(_socket.SOL_SOCKET,
                                  _socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(8)
        self.endpoint = "tcp://%s:%d" % self._listener.getsockname()[:2]
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def _accept_loop(self):
        import socket as _socket
        while not self._closed.is_set():
            try:
                self._listener.settimeout(0.2)
                conn, _ = self._listener.accept()
            except _socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._reader, args=(conn,),
                             daemon=True).start()

    def _reader(self, conn):
        try:
            while not self._closed.is_set():
                try:
                    frame = recv_frame(conn)
                except OSError:
                    break
                except Exception as e:
                    # Corrupt pickle body / hostile length prefix: drop the
                    # whole connection (frame boundary is lost) but never
                    # kill the reader silently.
                    self.warning("dropping connection on bad frame: %s", e)
                    break
                if frame is None:
                    break
                if not isinstance(frame, dict):
                    self.warning("non-dict frame dropped: %r",
                                 type(frame).__name__)
                    continue
                if frame.get("kind") == "close":
                    self.close()
                    break
                try:
                    self.feed(frame["input"], frame.get("label"))
                except (ValueError, KeyError, TypeError) as e:
                    self.warning("bad frame dropped: %s", e)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self):
        super().close()
        try:
            self._listener.close()
        except OSError:
            pass


def feed_socket(endpoint: str, samples, labels=None, *,
                close: bool = False) -> None:
    """Producer-side helper: push samples to a SocketLoader endpoint."""
    import socket as _socket
    assert endpoint.startswith("tcp://"), endpoint
    host, _, port = endpoint[6:].partition(":")
    sock = _socket.create_connection((host, int(port)))
    try:
        for i, sample in enumerate(samples):
            frame = {"input": np.asarray(sample, np.float32)}
            if labels is not None:
                frame["label"] = int(labels[i])
            data = wire.dumps(frame)
            if len(data) > wire.MAX_FRAME:
                # The receiving SocketLoader caps frames at MAX_FRAME and
                # drops the connection on violation — which would silently
                # discard every later sample; fail loudly at the producer.
                raise ValueError(
                    f"sample {i} serializes to {len(data)} bytes, over the "
                    f"wire frame cap ({wire.MAX_FRAME})")
            _send_frame(sock, data)
        if close:
            _send_frame(sock, wire.dumps({"kind": "close"}))
    finally:
        sock.close()
