"""The port's host loaders (veles_tpu_torch/loader/{image,ext,saver,
interactive,hdfs}.py, the ``Loader`` base's ``class_offset`` and
``analyze_label_distribution``) against the JAX package's on the same
files: the contracts of tests/test_loaders_ext.py,
tests/test_loader_family.py, tests/test_hdfs.py and
tests/test_loader_properties.py, with every batch bitwise the JAX
loader's (same keys, dtypes, shapes and bytes).  The WebHDFS tests talk
to a stub server on 127.0.0.1 only."""

import io
import json
import pickle
import threading
import urllib.parse
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import veles_tpu as vt  # noqa: E402
import veles_tpu.loader as jl  # noqa: E402
from veles_tpu.loader import interactive as jinter  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
import veles_tpu_torch.loader as pl  # noqa: E402
from veles_tpu_torch.loader import (TEST, TRAIN, VALID,  # noqa: E402
                                    LoaderError)

CLASSES = (TEST, VALID, TRAIN)


@pytest.fixture(autouse=True)
def _reset_prng():
    prng.streams.reset()
    vt.prng.streams.reset()
    yield
    prng.streams.reset()
    vt.prng.streams.reset()


def _same(jb, pb):
    assert sorted(jb) == sorted(pb)
    for k in jb:
        a, b = np.asarray(jb[k]), np.asarray(pb[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def _same_epochs(jld, pld, classes=CLASSES, epochs=(0, 1)):
    """Every batch of every class and epoch, bitwise; the counts too."""
    assert list(jld.class_lengths) == list(pld.class_lengths)
    n = 0
    for klass in classes:
        for epoch in epochs:
            jbs = list(jld.iter_epoch(klass, epoch))
            pbs = list(pld.iter_epoch(klass, epoch))
            assert len(jbs) == len(pbs)
            for jb, pb in zip(jbs, pbs):
                _same(jb, pb)
            n += len(pbs)
    return n


def _pair(name, *args, **kw):
    jld = getattr(jl, name)(*args, **kw)
    pld = getattr(pl, name)(*args, **kw)
    jld.initialize()
    pld.initialize()
    return jld, pld


# -- images ------------------------------------------------------------------

@pytest.fixture
def image_tree(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(0)
    for split in ("train", "valid"):
        for cls in ("cat", "dog"):
            d = tmp_path / split / cls
            d.mkdir(parents=True)
            for i in range(6 if split == "train" else 3):
                arr = rng.integers(0, 255, (20, 24, 3), dtype=np.uint8)
                Image.fromarray(arr).save(d / f"img{i}.png")
    return tmp_path


@pytest.mark.parametrize("aug", [
    {}, {"crop": (12, 12), "mirror": "random"},
    {"rotations": (0.0, 15.0, -15.0), "background": 128.0},
    {"grayscale": True, "crop": (10, 14)}],
    ids=["plain", "crop_mirror", "rotation", "gray"])
def test_file_image_loader(image_tree, aug):
    """Scale, crop, mirror, rotation, background and grayscale: both
    epochs of both classes bitwise JAX's; labels from the directory
    names; the same epoch twice gives the same pixels."""
    jld, pld = _pair("FileImageLoader",
                     train_paths=[str(image_tree / "train")],
                     valid_paths=[str(image_tree / "valid")],
                     scale=(16, 16), minibatch_size=4, **aug)
    assert pld.class_lengths == [0, 6, 12]
    assert pld.label_mapping == jld.label_mapping == {"cat": 0, "dog": 1}
    assert _same_epochs(jld, pld, (VALID, TRAIN)) == 10
    b1, b2 = (next(pld.iter_epoch(TRAIN, 0)) for _ in range(2))
    _same(b1, b2)


def test_hdf5_loader(tmp_path):
    import h5py
    rng = np.random.default_rng(0)
    paths = {}
    for klass, n in ((TRAIN, 30), (VALID, 9)):
        paths[klass] = str(tmp_path / f"{klass}.h5")
        with h5py.File(paths[klass], "w") as f:
            f["data"] = rng.standard_normal((n, 5)).astype(np.float32)
            f["labels"] = rng.integers(0, 3, n).astype(np.int32)
    jld, pld = _pair("Hdf5Loader", paths, minibatch_size=8)
    _same_epochs(jld, pld, (VALID, TRAIN))
    assert sum(int(b["@mask"].sum()) for b in pld.iter_epoch(TRAIN, 0)) \
        == 30


# -- the loader family -------------------------------------------------------

def _write_wav(path, samples, rate=8000, width=2, channels=1):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        if width == 2:
            data = (np.clip(samples, -1, 1) * 32767).astype("<i2")
        else:
            data = ((np.clip(samples, -1, 1) * 127) + 128).astype(np.uint8)
        if channels > 1:
            data = np.repeat(data[:, None], channels, axis=1)
        w.writeframes(data.tobytes())


def test_pickles_loader(tmp_path, rng):
    train = {"data": rng.normal(size=(20, 4)).astype(np.float32),
             "labels": rng.integers(0, 3, 20).astype(np.int32)}
    valid = rng.normal(size=(8, 4)).astype(np.float32)  # bare array form
    pt, pv = tmp_path / "train.pickle", tmp_path / "valid.pickle"
    pt.write_bytes(pickle.dumps(train))
    pv.write_bytes(pickle.dumps(valid))
    jld, pld = _pair("PicklesLoader", {TRAIN: str(pt), VALID: str(pv)},
                     minibatch_size=5)
    assert pld.class_lengths == [0, 8, 20]
    _same_epochs(jld, pld, (VALID, TRAIN))
    assert "@labels" not in next(pld.iter_epoch(VALID))


def test_wav_roundtrip_and_loader(tmp_path, rng):
    t = np.arange(4096) / 8000.0
    sine = np.sin(2 * np.pi * 500 * t).astype(np.float32)
    noise = rng.normal(scale=0.3, size=4096).astype(np.float32)
    _write_wav(tmp_path / "sine.wav", sine)
    _write_wav(tmp_path / "noise.wav", noise)
    _write_wav(tmp_path / "st.wav", sine[:256], channels=2)
    _write_wav(tmp_path / "u8.wav", sine[:256], width=1)
    for name in ("sine", "st", "u8"):
        x, rate = pl.read_wav(str(tmp_path / f"{name}.wav"))
        jx, jrate = jl.read_wav(str(tmp_path / f"{name}.wav"))
        assert rate == jrate == 8000
        assert x.tobytes() == jx.tobytes() and x.dtype == jx.dtype
    assert np.max(np.abs(pl.read_wav(str(tmp_path / "sine.wav"))[0]
                         - sine)) < 1e-3
    for spectrum in (True, False):
        jld, pld = _pair(
            "WavLoader", {TRAIN: [(str(tmp_path / "sine.wav"), 0),
                                  (str(tmp_path / "noise.wav"), 1)]},
            window=512, spectrum=spectrum, minibatch_size=4)
        assert pld.class_lengths[TRAIN] == 16
        _same_epochs(jld, pld, (TRAIN,))
    assert next(pld.iter_epoch(TRAIN))["@input"].shape == (4, 512)


def test_csv_loader(tmp_path):
    rows = ["f1,f2,label", "1.0,2.0,a", "3.0,4.0,b", "5.0,6.0,a"]
    p = tmp_path / "d.csv"
    p.write_text("\n".join(rows))
    jld, pld = _pair("CsvLoader", {TRAIN: str(p), VALID: str(p)},
                     skip_header=True, minibatch_size=2)
    assert pld._labels[TRAIN].tolist() == [0, 1, 0]  # a,b,a -> dense ints
    _same_epochs(jld, pld, (VALID, TRAIN))
    ld2 = pl.CsvLoader({TRAIN: io.StringIO("1,2\n3,4")}, label_column=None,
                       minibatch_size=1)
    ld2.initialize()
    assert ld2._labels[TRAIN] is None
    with pytest.raises(LoaderError, match="webhdfs"):
        pl.CsvLoader({TRAIN: "hdfs://namenode/data.csv"},
                     minibatch_size=1).initialize()


def test_ensemble_results_loader(tmp_path, rng):
    labels = rng.integers(0, 3, 12).astype(np.int32)
    entries = []
    for i in range(2):
        probs = rng.random((12, 3)).astype(np.float32)
        np.savez(tmp_path / f"model{i}.npz", probabilities=probs,
                 labels=labels)
        entries.append({"results_path": f"model{i}.npz"})
    man = tmp_path / "manifest.json"
    man.write_text(json.dumps({"models": entries}))
    jld, pld = _pair("EnsembleResultsLoader", str(man), minibatch_size=4)
    assert pld.class_lengths[TEST] == 12
    _same_epochs(jld, pld, (TEST,))
    assert next(pld.iter_epoch(TEST))["@input"].shape == (4, 6)
    np.savez(tmp_path / "model1.npz", probabilities=probs[:5],
             labels=labels[:5])
    with pytest.raises(LoaderError):
        pl.EnsembleResultsLoader(str(man), minibatch_size=4).initialize()


def test_label_distribution_and_class_offset(rng):
    labels = {TRAIN: rng.integers(0, 4, 200), VALID: rng.integers(0, 3, 50)}
    jld, pld = _pair("ArrayLoader",
                     {TRAIN: np.zeros((200, 1), np.float32),
                      VALID: np.zeros((50, 1), np.float32)},
                     minibatch_size=10)
    assert pld.analyze_label_distribution(labels) == \
        jld.analyze_label_distribution(labels)
    for klass in CLASSES:
        assert pld.class_offset(klass) == jld.class_offset(klass)
    assert pld.class_offset(TRAIN) == 50


# -- capture and replay, queues and sockets ----------------------------------

def test_minibatch_saver_replay_across_packages(tmp_path, rng):
    """The port's capture replays bitwise in both packages' loaders, and
    the JAX package's capture in the port's."""
    d = rng.standard_normal((40, 6)).astype(np.float32)
    lab = rng.integers(0, 2, 40).astype(np.int32)
    paths = {}
    for name, mod in (("port", pl), ("jax", jl)):
        saver = mod.MinibatchesSaver(mod.ArrayLoader(
            {TRAIN: d}, {TRAIN: lab}, minibatch_size=16))
        saver.initialize()
        orig = [{k: np.asarray(v) for k, v in b.items()}
                for b in saver.iter_epoch(TRAIN, 0)]
        paths[name] = saver.save(str(tmp_path / f"{name}.npz"))
    for path in paths.values():
        jrep, prep = _pair("MinibatchesLoader", path)
        assert prep.class_lengths[TRAIN] == 40
        got = list(prep.iter_epoch(TRAIN))
        assert len(got) == len(orig) == 3
        for a, b, c in zip(orig, got, jrep.iter_epoch(TRAIN)):
            _same(a, b)
            _same(c, b)


def test_queue_loader_stream():
    loader = pl.QueueLoader(input_shape=(3,), minibatch_size=4)
    loader.initialize()

    def producer():
        for i in range(10):
            loader.feed(np.full(3, i, np.float32), label=i % 2)
        loader.close()

    t = threading.Thread(target=producer)
    t.start()
    batches = list(loader.iter_epoch(TRAIN))
    t.join()
    assert sum(int(b["@mask"].sum()) for b in batches) == 10
    assert batches[0]["@input"].shape == (4, 3)
    assert batches[-1]["@mask"].sum() == 2
    got = np.concatenate([b["@input"][b["@mask"] > 0] for b in batches])
    np.testing.assert_array_equal(got[:, 0], np.arange(10))


@pytest.mark.parametrize("producer", ["port", "jax"])
def test_socket_loader_feeds_batches(producer):
    """Frames over TCP, from either package's ``feed_socket`` (one wire
    format), serve the samples and labels."""
    loader = pl.SocketLoader((4,), minibatch_size=3)
    loader.initialize()
    samples = np.arange(24, dtype=np.float32).reshape(6, 4)
    feed = pl.feed_socket if producer == "port" else jinter.feed_socket
    feed(loader.endpoint, samples, labels=[0, 1, 2, 0, 1, 2], close=True)
    batches = list(loader.iter_epoch(TRAIN))
    got = np.concatenate([b["@input"][b["@mask"] > 0] for b in batches])
    np.testing.assert_array_equal(np.sort(got.ravel()),
                                  np.sort(samples.ravel()))
    labels = np.concatenate([b["@labels"][b["@mask"] > 0] for b in batches])
    assert sorted(labels.tolist()) == [0, 0, 1, 1, 2, 2]


# -- WebHDFS against a local stub (tests/test_hdfs.py) -----------------------

FILES = {
    "/data/train.csv": b"1.0,2.0,0\n3.0,4.0,1\n5.0,6.0,0\n7.0,8.0,1\n",
    "/data/lines.txt": "\n".join(f"line-{i}" for i in range(2500)
                                 ).encode() + b"\n",
}


class _StubHandler(BaseHTTPRequestHandler):
    """Namenode and datanode in one server: OPEN 307-redirects to
    /serve/<path>, which honours offset and length."""

    def log_message(self, *a):
        pass

    def do_GET(self):
        u = urllib.parse.urlparse(self.path)
        q = dict(urllib.parse.parse_qsl(u.query))
        if u.path.startswith("/webhdfs/v1"):
            path = u.path[len("/webhdfs/v1"):]
            if path not in FILES:
                self.send_error(404, "FileNotFoundException")
                return
            op = q.get("op")
            if op == "GETFILESTATUS":
                body = json.dumps({"FileStatus": {
                    "length": len(FILES[path]), "type": "FILE",
                    "pathSuffix": ""}}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)
            elif op == "OPEN":
                self.send_response(307)
                self.send_header("Location", f"/serve{path}?{u.query}")
                self.end_headers()
            else:
                self.send_error(400, f"unsupported op {op}")
        elif u.path.startswith("/serve/"):
            data = FILES[u.path[len("/serve"):]]
            off = int(q.get("offset", 0))
            ln = int(q.get("length", len(data) - off))
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.end_headers()
            self.wfile.write(data[off:off + ln])
        else:
            self.send_error(404)


@pytest.fixture(scope="module")
def stub_url():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _StubHandler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()


def test_webhdfs_client_and_text_loader(stub_url):
    c = pl.WebHdfsClient(stub_url)
    assert c.stat("/data/train.csv")["length"] == len(
        FILES["/data/train.csv"])
    assert c.open("/data/train.csv") == FILES["/data/train.csv"]
    assert c.open("/data/train.csv", offset=4, length=3) == \
        FILES["/data/train.csv"][4:7]
    assert list(c.text("/data/lines.txt", block=256)) == \
        [f"line-{i}" for i in range(2500)]
    ld = pl.HdfsTextLoader(stub_url, "/data/lines.txt", chunk_lines=1000)
    chunks = list(ld.read_chunks())
    assert [len(ch) for ch in chunks] == [1000, 1000, 500]
    assert ld.finished and chunks[2][-1] == "line-2499"
    with pytest.raises(LoaderError, match="404"):
        c.stat("/data/nope.txt")


def test_csv_loader_webhdfs_source(stub_url):
    host = stub_url[len("http://"):]
    src = {TRAIN: f"webhdfs://{host}/data/train.csv",
           VALID: f"webhdfs://{host}/data/train.csv"}
    jld, pld = _pair("CsvLoader", src, minibatch_size=2)
    assert pld.class_lengths[TRAIN] == 4
    _same_epochs(jld, pld, (VALID, TRAIN))


# -- epoch and shard accounting (tests/test_loader_properties.py) ------------

@pytest.mark.parametrize("n,mb,shards,epoch", [
    (1, 1, 1, 0), (37, 8, 3, 1), (128, 16, 4, 2), (300, 64, 5, 3),
    (17, 32, 2, 0)])
def test_every_sample_served_exactly_once_across_shards(n, mb, shards,
                                                        epoch):
    """Each shard serves fixed-size padded batches, all shards the same
    number, the union every sample once, and each shard's batches are
    the JAX loader's."""
    data = np.arange(n, dtype=np.float32).reshape(n, 1)
    labels = np.arange(n, dtype=np.int32)
    seen, counts = [], []
    for s in range(shards):
        kw = dict(minibatch_size=mb, shard_index=s, shard_count=shards)
        jld, pld = _pair("ArrayLoader", {TRAIN: data.copy()},
                         {TRAIN: labels.copy()}, **kw)
        pbs = list(pld.iter_epoch(TRAIN, epoch))
        for jb, pb in zip(jld.iter_epoch(TRAIN, epoch), pbs, strict=True):
            _same(jb, pb)
            m = pb["@mask"].astype(bool)
            assert len(m) == mb
            seen.extend(pb["@labels"][m].tolist())
        counts.append(len(pbs))
    assert len(set(counts)) == 1
    assert sorted(seen) == list(range(n))
