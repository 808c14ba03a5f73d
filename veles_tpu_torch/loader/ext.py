"""Extended loader family: pickles, audio, CSV/text, ensemble results.

Reference parity (SURVEY.md §2.4):
* ``PicklesLoader``  — dataset from pickled arrays, one pickle per class
  (reference: veles/loader/pickles.py:55).
* ``WavLoader``      — audio windows + labels from WAV files. The reference
  used a libsndfile FFI binding (veles/loader/libsndfile.py:42-91,
  libsndfile_loader.py:46-107); here stdlib ``wave`` decodes PCM WAV — no
  native dependency — and the features are fixed-size windows (optionally
  magnitude spectra via an rFFT, replacing the reference's external DSP).
* ``CsvLoader``      — delimited-text rows -> (features, label) arrays. The
  reference's HDFS text loader (veles/loader/hdfs_loader.py:48) parsed the
  same line format streamed from HDFS; ``hdfs://`` URLs raise a clear
  gating error here (no hadoop client in this environment) while local
  paths and open file objects work the same.
* ``EnsembleResultsLoader`` — reads the per-model results JSON written by
  ensemble training for ensemble test mode (reference:
  veles/loader/ensemble.py:53-143, consuming the JSON produced by
  veles/ensemble/model_workflow.py).

(The port's copy of veles_tpu/loader/ext.py, which holds no
JAX: the same batches from the same files, rewired to the port's
package.)
"""

from __future__ import annotations

import json
import os
import pickle
import wave
from urllib.parse import urlparse
from typing import Dict, List, Optional, Sequence

import numpy as np

from .base import TEST, TRAIN, VALID, Loader, LoaderError


class PicklesLoader(Loader):
    """Dataset from pickle files, one path per class (test/valid/train).

    Each pickle holds either an (N, ...) array, or a dict with
    ``data``/``labels`` (and optionally ``targets``) keys, matching the
    shapes ArrayLoader expects.
    """

    def __init__(self, paths: Dict[int, str], normalizer=None, **kw):
        super().__init__(**kw)
        self._paths = dict(paths)
        self.normalizer = normalizer
        self._data: Dict[int, np.ndarray] = {}
        self._labels: Dict[int, Optional[np.ndarray]] = {}
        self._targets: Dict[int, Optional[np.ndarray]] = {}

    def load_data(self):
        for klass in (TEST, VALID, TRAIN):
            path = self._paths.get(klass)
            if not path:
                continue
            with open(path, "rb") as f:
                obj = pickle.load(f)
            if isinstance(obj, dict):
                data = np.asarray(obj["data"])
                labels = obj.get("labels")
                targets = obj.get("targets")
            else:
                data, labels, targets = np.asarray(obj), None, None
            self._data[klass] = data
            self._labels[klass] = (None if labels is None
                                   else np.asarray(labels))
            self._targets[klass] = (None if targets is None
                                    else np.asarray(targets))
            self.class_lengths[klass] = len(data)
        if self.normalizer is not None and TRAIN in self._data:
            self.normalizer.analyze(self._data[TRAIN])
            for klass in list(self._data):
                self._data[klass] = self.normalizer.normalize(
                    self._data[klass])

    def fill_minibatch(self, indices, klass):
        batch = {"@input": self._data[klass][indices]}
        if self._labels.get(klass) is not None:
            batch["@labels"] = self._labels[klass][indices]
        if self._targets.get(klass) is not None:
            batch["@targets"] = self._targets[klass][indices]
        return batch


def read_wav(path: str) -> tuple:
    """Decode a PCM WAV file to (float32 mono samples in [-1, 1], rate)."""
    with wave.open(path, "rb") as w:
        n = w.getnframes()
        width = w.getsampwidth()
        channels = w.getnchannels()
        rate = w.getframerate()
        raw = w.readframes(n)
    if width == 1:  # unsigned 8-bit
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 2:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    else:
        raise LoaderError(f"unsupported WAV sample width {width}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x, rate


class WavLoader(Loader):
    """Fixed-size windows from labeled WAV files.

    ``files[klass]`` is a list of (path, label) pairs. Each file is cut into
    non-overlapping windows of ``window`` samples; ``spectrum=True`` maps
    each window to its rFFT magnitude (window//2+1 features), which is both
    the idiomatic audio frontend and a shape XLA pads nicely to lanes.
    """

    def __init__(self, files: Dict[int, Sequence], window: int = 1024,
                 spectrum: bool = False, **kw):
        super().__init__(**kw)
        self._files = files
        self.window = int(window)
        self.spectrum = bool(spectrum)
        self._data: Dict[int, np.ndarray] = {}
        self._labels: Dict[int, np.ndarray] = {}

    def load_data(self):
        for klass, entries in self._files.items():
            feats: List[np.ndarray] = []
            labels: List[int] = []
            for path, label in entries:
                samples, _rate = read_wav(path)
                n_win = len(samples) // self.window
                if n_win == 0:
                    continue
                wins = samples[:n_win * self.window].reshape(
                    n_win, self.window)
                if self.spectrum:
                    wins = np.abs(np.fft.rfft(wins, axis=1)).astype(
                        np.float32)
                feats.append(wins.astype(np.float32))
                labels.extend([label] * n_win)
            if feats:
                self._data[klass] = np.concatenate(feats, axis=0)
                self._labels[klass] = np.asarray(labels, np.int32)
                self.class_lengths[klass] = len(self._labels[klass])

    def fill_minibatch(self, indices, klass):
        return {"@input": self._data[klass][indices],
                "@labels": self._labels[klass][indices]}


class CsvLoader(Loader):
    """Delimited text -> float feature rows, optional label column.

    ``sources[klass]`` is a filesystem path, an open text-file object, or a
    ``webhdfs://namenode:port/path`` URL read through the WebHDFS REST
    gateway (loader/hdfs.py — the rebuild of the reference's snakebite
    HDFS loader, veles/loader/hdfs_loader.py:48). Bare ``hdfs://`` (native
    RPC) stays gated with an explanatory error pointing at webhdfs.
    """

    def __init__(self, sources: Dict[int, object], delimiter: str = ",",
                 label_column: Optional[int] = -1, skip_header: bool = False,
                 normalizer=None, **kw):
        super().__init__(**kw)
        self._sources = dict(sources)
        self.delimiter = delimiter
        self.label_column = label_column
        self.skip_header = bool(skip_header)
        self.normalizer = normalizer
        self._data: Dict[int, np.ndarray] = {}
        self._labels: Dict[int, Optional[np.ndarray]] = {}

    def _read_rows(self, src) -> List[List[str]]:
        if isinstance(src, str):
            if src.startswith("webhdfs://"):
                from .hdfs import WebHdfsClient
                u = urlparse(src)
                lines = list(WebHdfsClient(
                    f"http://{u.netloc}").text(u.path))
            elif src.startswith("hdfs://"):
                raise LoaderError(
                    "hdfs:// (native RPC) needs a hadoop client; use a "
                    "webhdfs://namenode:port/path URL instead (WebHDFS "
                    "REST gateway, loader/hdfs.py; reference analog: "
                    "veles/loader/hdfs_loader.py)")
            else:
                with open(src, "r") as f:
                    lines = f.read().splitlines()
        else:
            lines = src.read().splitlines()
        if self.skip_header and lines:
            lines = lines[1:]
        return [ln.split(self.delimiter) for ln in lines if ln.strip()]

    def load_data(self):
        for klass, src in self._sources.items():
            rows = self._read_rows(src)
            if not rows:
                continue
            if self.label_column is not None:
                lc = self.label_column % len(rows[0])
                labels = np.asarray([r[lc] for r in rows])
                try:
                    labels = labels.astype(np.int32)
                except ValueError:  # string labels -> dense int mapping
                    _, labels = np.unique(labels, return_inverse=True)
                    labels = labels.astype(np.int32)
                feats = [[v for i, v in enumerate(r) if i != lc]
                         for r in rows]
                self._labels[klass] = labels
            else:
                feats = rows
                self._labels[klass] = None
            self._data[klass] = np.asarray(feats, np.float32)
            self.class_lengths[klass] = len(rows)
        if self.normalizer is not None and TRAIN in self._data:
            self.normalizer.analyze(self._data[TRAIN])
            for klass in list(self._data):
                self._data[klass] = self.normalizer.normalize(
                    self._data[klass])

    def fill_minibatch(self, indices, klass):
        batch = {"@input": self._data[klass][indices]}
        if self._labels.get(klass) is not None:
            batch["@labels"] = self._labels[klass][indices]
        return batch


class EnsembleResultsLoader(Loader):
    """Serves per-model prediction matrices recorded during ensemble training
    for the ensemble-test vote (reference: veles/loader/ensemble.py:53-143).

    The manifest JSON is a list of per-model entries with ``results_path``
    pointing at an .npz of ``probabilities`` (N, n_classes) and ``labels``
    (N,). The served "@input" is the concatenation of all models'
    probabilities per sample — the input of a stacking/vote evaluator.
    """

    def __init__(self, manifest_path: str, klass: int = TEST, **kw):
        super().__init__(**kw)
        self.manifest_path = manifest_path
        self.klass = klass
        self._data: Optional[np.ndarray] = None
        self._labels: Optional[np.ndarray] = None

    def load_data(self):
        with open(self.manifest_path) as f:
            manifest = json.load(f)
        entries = manifest["models"] if isinstance(manifest, dict) \
            else manifest
        probs, labels = [], None
        base = os.path.dirname(os.path.abspath(self.manifest_path))
        for entry in entries:
            path = entry["results_path"]
            if not os.path.isabs(path):
                path = os.path.join(base, path)
            with np.load(path) as z:
                probs.append(z["probabilities"].astype(np.float32))
                if labels is None and "labels" in z:
                    labels = z["labels"].astype(np.int32)
        if not probs:
            raise LoaderError(f"no model results in {self.manifest_path}")
        lengths = {p.shape[0] for p in probs}
        if len(lengths) > 1:
            # Rows pair per-sample across models; differing counts mean
            # the models were evaluated on different sample sets and the
            # vote would silently mix samples.
            raise LoaderError(
                f"model result row counts differ ({sorted(lengths)}); "
                "all models must be evaluated on the same samples")
        n = lengths.pop()
        if labels is not None and labels.shape[0] != n:
            raise LoaderError(
                f"labels length {labels.shape[0]} != result rows {n}; "
                "labels must pair one-to-one with model predictions")
        self._data = np.concatenate(probs, axis=1)
        self._labels = labels
        self.class_lengths[self.klass] = n

    def fill_minibatch(self, indices, klass):
        batch = {"@input": self._data[indices]}
        if self._labels is not None:
            batch["@labels"] = self._labels[indices]
        return batch
