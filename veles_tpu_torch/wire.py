"""Pickle-free wire format for socket payloads.

The reference streamed pickles over its ZMQ transport
(veles/txzmq/connection.py:140-143) and trusted the network; round-1 of
this rebuild kept that and the advisor flagged it — ``pickle.loads`` on
bytes from any connector is arbitrary code execution.  This module is the
replacement: a restricted serializer that can represent exactly

* JSON scalars (``None``/bool/int/float/str),
* lists / dicts (string keys) of the above,
* numpy arrays of non-object dtype (raw buffer + dtype + shape).

Frame layout: ``u32 header_len | u32 sizes_len | header_json |
sizes_json | buf0 | buf1 | ...`` where ``sizes_json`` is the list of
buffer byte lengths and arrays in the structure are replaced by
``{"\\u0000nd": i, dtype, shape}`` placeholders indexing the
concatenated raw buffers.  Deserialization never
constructs arbitrary objects — worst case a hostile peer hands us wrong
numbers, never code.

(The port's copy of veles_tpu/wire.py, which holds no JAX: the same
bytes, so the two packages read each other's frames.)
"""

from __future__ import annotations

import json
import struct
from typing import Any, List, Tuple

import numpy as np

# Placeholder key; NUL-prefixed so it cannot collide with normal payload dict keys
# that callers build from identifiers.
_ND = "\x00nd"

#: refuse frames larger than this (hostile length prefix → OOM guard)
MAX_FRAME = 1 << 30


class WireError(ValueError):
    pass


def _encode(obj: Any, bufs: List[bytes]) -> Any:
    if isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            raise WireError("object arrays are not wire-serializable")
        idx = len(bufs)
        bufs.append(np.ascontiguousarray(obj).tobytes())
        return {_ND: idx, "dtype": obj.dtype.str, "shape": list(obj.shape)}
    if isinstance(obj, (np.generic,)):
        return _encode(np.asarray(obj), bufs)
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if not isinstance(k, str):
                raise WireError(f"non-string dict key {k!r}")
            if k.startswith("\x00"):
                raise WireError("reserved key prefix")
            out[k] = _encode(v, bufs)
        return out
    if isinstance(obj, (list, tuple)):
        return [_encode(v, bufs) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise WireError(f"type {type(obj).__name__} is not wire-serializable")


def _decode(obj: Any, bufs: List[Tuple[int, int]], data: bytes) -> Any:
    if isinstance(obj, dict):
        if _ND in obj:
            idx = obj[_ND]
            if not isinstance(idx, int) or not 0 <= idx < len(bufs):
                raise WireError("bad buffer index")
            # Hostile headers can be malformed in every field; the module
            # contract is "malformed frame ⇒ WireError", never a raw
            # ValueError/KeyError escaping to the caller.
            try:
                dtype = np.dtype(str(obj["dtype"]))
                if dtype.hasobject:
                    raise WireError("object dtype refused")
                shape = tuple(int(s) for s in obj["shape"])
                start, end = bufs[idx]
                arr = np.frombuffer(data[start:end], dtype=dtype)
                return arr.reshape(shape).copy()
            except WireError:
                raise
            except (TypeError, KeyError, ValueError, OverflowError) as e:
                raise WireError(f"bad array header: {e}") from None
        return {k: _decode(v, bufs, data) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v, bufs, data) for v in obj]
    return obj


def dumps(payload: Any) -> bytes:
    """Serialize ``payload`` to a self-contained frame body."""
    bufs: List[bytes] = []
    header = json.dumps(_encode(payload, bufs),
                        separators=(",", ":")).encode("utf-8")
    sizes = [len(b) for b in bufs]
    head = json.dumps(sizes, separators=(",", ":")).encode("utf-8")
    return (struct.pack("<II", len(header), len(head))
            + header + head + b"".join(bufs))


def loads(data: bytes) -> Any:
    """Deserialize a frame body produced by :func:`dumps`."""
    if len(data) < 8:
        raise WireError("short frame")
    hlen, slen = struct.unpack("<II", data[:8])
    if 8 + hlen + slen > len(data):
        raise WireError("truncated header")
    try:
        header = json.loads(data[8:8 + hlen].decode("utf-8"))
        sizes = json.loads(data[8 + hlen:8 + hlen + slen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError, RecursionError) as e:
        raise WireError(f"bad header: {e}") from None
    if not isinstance(sizes, list):
        raise WireError("bad size table")
    offsets: List[Tuple[int, int]] = []
    pos = 8 + hlen + slen
    for s in sizes:
        if not isinstance(s, int) or s < 0 or pos + s > len(data):
            raise WireError("buffer overruns frame")
        offsets.append((pos, pos + s))
        pos += s
    return _decode_checked(header, offsets, data)


def _decode_checked(header, offsets, data) -> Any:
    # A hostile header like "[[[[...1...]]]]" passes json.loads but can
    # blow the stack inside _decode — that must surface as WireError, not
    # RecursionError (receivers catch only WireError).
    try:
        return _decode(header, offsets, data)
    except RecursionError:
        raise WireError("header nesting too deep") from None
