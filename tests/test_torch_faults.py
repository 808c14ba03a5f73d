"""The training half of the fault-tolerance layer (tests/test_faults.py
:90-356) in the port, held against the JAX package on the same data and
weights: the in-step anomaly sentinel with injected NaN gradients,
escalation to a rollback after consecutive anomalous steps, the snapshot
walk-back past corrupt snapshots, and the loader's injected read error
and retry.

The contract running through every test: robustness costs ZERO
recompiles (the StepCache counters; on the CPU the cache counts one
build per program, on the card one capture).  The JAX Trainer runs the
same workflow (two fully-connected layers over 3-class blobs, SGD with
momentum) from the same initial weights and loader order; the port's
per-epoch train losses are held to the JAX package's within rtol 1e-5,
its skip and rollback counts exactly."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import veles_tpu as vt  # noqa: E402
from veles_tpu.config import root as jroot  # noqa: E402
from veles_tpu.ops import optimizers as jopt  # noqa: E402
from veles_tpu.runtime import faults as jfaults  # noqa: E402
from veles_tpu.units import nn as jnn  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.config import root  # noqa: E402
from veles_tpu_torch.loader.base import (TRAIN, VALID, ArrayLoader,  # noqa: E402,E501
                                         LoaderError)
from veles_tpu_torch.models.lm import InductionLoader  # noqa: E402
from veles_tpu_torch.ops import optimizers as popt  # noqa: E402
from veles_tpu_torch.ops.optimizers import (ANOM_CONSEC_KEY,  # noqa: E402
                                            ANOM_SKIP_KEY, LR_MULT_KEY)
from veles_tpu_torch.runtime import faults  # noqa: E402
from veles_tpu_torch.runtime.decision import Decision  # noqa: E402
from veles_tpu_torch.runtime.snapshotter import (  # noqa: E402
    SnapshotCorruptError, Snapshotter, compare_snapshots,
    params_from_jax, restore_with_walkback, snapshot_checksum)
from veles_tpu_torch.runtime.trainer import Trainer  # noqa: E402
from veles_tpu_torch.units import nn  # noqa: E402
from veles_tpu_torch.units.base import Spec  # noqa: E402
from veles_tpu_torch.units.workflow import (Workflow, new_state,  # noqa: E402
                                            seed_key)

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
KNOBS = ("sentinel", "clip_norm", "anomaly_patience")


@pytest.fixture(autouse=True)
def _clean():
    """Both packages' harnesses disarmed, their knobs at their defaults,
    the port's PRNG streams fresh."""
    saved = [(r, {k: r.common.train.get(k) for k in KNOBS},
              r.common.get("snapshot_keep", 0),
              r.common.loader.get("retries", 2),
              r.common.loader.get("retry_backoff_s", 0.05))
             for r in (root, jroot)]
    faults.reset()
    jfaults.reset()
    prng.streams.reset()
    yield
    faults.reset()
    jfaults.reset()
    prng.streams.reset()
    for r, train, keep, retries, backoff in saved:
        for k, v in train.items():
            setattr(r.common.train, k, v)
        r.common.snapshot_keep = keep
        r.common.loader.retries = retries
        r.common.loader.retry_backoff_s = backoff


def _set(**train):
    for r in (root, jroot):
        for k, v in train.items():
            setattr(r.common.train, k, v)


def _arm(**knobs):
    faults.configure(**knobs)
    jfaults.configure(**knobs)


def _blob(n=96, dim=8):
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((3, dim)) * 3
    lab = rng.integers(0, 3, n).astype(np.int32)
    d = (centers[lab] + rng.standard_normal((n, dim))).astype(np.float32)
    return d, lab


def _data(mb=32):
    d, lab = _blob()
    return ({TRAIN: d, VALID: d[:32]}, {TRAIN: lab, VALID: lab[:32]},
            dict(minibatch_size=mb))


def _jax_trainer(max_epochs=3, snapshotter=None):
    wf = vt.Workflow("ft")
    wf.add(jnn.All2AllTanh(16, name="fc1", inputs=("@input",)))
    wf.add(jnn.All2AllSoftmax(3, name="fc2", inputs=("fc1",)))
    wf.add(jnn.EvaluatorSoftmax(name="ev",
                                inputs=("fc2", "@labels", "@mask")))
    data, labels, kw = _data()
    tr = vt.Trainer(wf, vt.ArrayLoader(data, labels, **kw),
                    jopt.SGD(0.05, momentum=0.9),
                    vt.Decision(max_epochs=max_epochs, fail_iterations=50),
                    snapshotter=snapshotter)
    tr.initialize(seed=0)
    return tr


def _port_trainer(like, max_epochs=3, snapshotter=None):
    """The port's trainer on ``like``'s (a JAX trainer's) initial
    weights, with a fresh optimizer state."""
    wf = Workflow("ft")
    wf.add(nn.All2AllTanh(16, name="fc1", inputs=("@input",)))
    wf.add(nn.All2AllSoftmax(3, name="fc2", inputs=("fc1",)))
    wf.add(nn.EvaluatorSoftmax(name="ev",
                               inputs=("fc2", "@labels", "@mask")))
    data, labels, kw = _data()
    o = popt.SGD(0.05, momentum=0.9)
    tr = Trainer(wf, ArrayLoader(data, labels, **kw), o,
                 Decision(max_epochs=max_epochs, fail_iterations=50),
                 snapshotter, device="cpu")
    tr.initialize(seed=0)
    params = params_from_jax(jax.device_get(like.wstate["params"]), wf,
                             device="cpu")
    tr.initialize(wstate=new_state(params, {}, o.init(params), 0,
                                   seed_key(0)))
    return tr


def _pair(max_epochs=3, snapshotters=(None, None)):
    jtr = _jax_trainer(max_epochs, snapshotters[0])
    return jtr, _port_trainer(jtr, max_epochs, snapshotters[1])


def _same_losses(ptr, jtr):
    assert len(ptr.decision.history) == len(jtr.decision.history)
    for pe, je in zip(ptr.decision.history, jtr.decision.history):
        for k in ("n_err", "n_samples", "n_batches", "anomaly_steps"):
            assert pe["train"].get(k) == je["train"].get(k), k
        np.testing.assert_allclose(pe["train"]["loss"], je["train"]["loss"],
                                   rtol=LOSS_RTOL)


def _host(t):
    return t.detach().cpu().numpy()


# -- anomaly sentinel ------------------------------------------------------

def test_injected_nan_run_completes_exact_skips_zero_recompiles():
    """With nan_grad_at_step armed the run completes, every logged loss is
    finite, EXACTLY the injected steps are skipped, the counters in
    opt_state agree, the programs never rebuild, and the epoch losses
    follow the JAX Trainer's."""
    _arm(nan_grad_at_step=[3, 4])
    jtr, ptr = _pair()
    jtr.run()
    ptr.run()
    assert ptr.anomaly_steps_skipped == jtr.anomaly_steps_skipped == 2
    assert int(ptr.wstate["opt_state"][ANOM_SKIP_KEY]) == 2
    assert all(np.isfinite(h["train"]["loss"])
               for h in ptr.decision.history)
    # train + eval, one each; a skip is not a rebuild (the second
    # initialize of _port_trainer was a hit)
    assert ptr.step_cache.compiles == 2
    assert ptr.step_cache.recompiles == 0
    assert ptr.step_cache.hits == 1
    _same_losses(ptr, jtr)


def test_skip_prefix_matches_uninjected_and_is_deterministic():
    """The injected run equals an uninjected one bitwise up to the
    faulty step (epoch 0 here), and two identically injected runs agree
    bitwise at the end."""
    def run(inject):
        faults.reset()
        prng.streams.reset()
        if inject:
            faults.configure(nan_grad_at_step=[7])  # epoch 2 (3 a epoch)
        tr = _port_trainer(_jax_trainer(1))
        tr.run()
        return tr

    a, b, clean = run(True), run(True), run(False)
    assert a.decision.history[0]["train"]["loss"] \
        == clean.decision.history[0]["train"]["loss"]
    assert a.decision.history[2]["train"]["loss"] \
        != clean.decision.history[2]["train"]["loss"]
    for part in ("params", "opt_state"):
        for x, y in zip(popt.tree_leaves(a.wstate[part]),
                        popt.tree_leaves(b.wstate[part]), strict=True):
            assert torch.equal(x, y)
    assert a.anomaly_steps_skipped == b.anomaly_steps_skipped == 1


def test_skip_is_complete_noop_on_training_state():
    """A skipped step leaves params and optimizer slots untouched, bumps
    both counters and zeroes the step's metrics; the next clean step
    trains and resets the consecutive counter."""
    faults.configure(nan_grad_at_step=[0])
    wf = _port_trainer(_jax_trainer(1)).workflow
    o = popt.SGD(0.05, momentum=0.9)
    step = wf.make_train_step(o)
    ws = wf.init_state(0, o, "cpu")
    before = {k: [t.clone() for t in popt.tree_leaves(ws[k])]
              for k in ("params", "opt_state")}
    rng = np.random.default_rng(3)
    batch = {"@input": torch.from_numpy(
                 rng.standard_normal((8, 8)).astype(np.float32)),
             "@labels": torch.from_numpy(
                 rng.integers(0, 3, 8).astype(np.int32)),
             "@mask": torch.ones(8)}
    ws, mets = step(ws, batch)              # step 0: injected, skipped
    for a, b in zip(before["params"], popt.tree_leaves(ws["params"])):
        assert torch.equal(a, b)
    assert int(ws["opt_state"][ANOM_SKIP_KEY]) == 1
    assert int(ws["opt_state"][ANOM_CONSEC_KEY]) == 1
    assert float(mets["loss"]) == 0.0 and float(mets["anomaly_steps"]) == 1
    ws, mets = step(ws, batch)              # step 1: clean
    assert float(mets["anomaly_steps"]) == 0.0
    assert int(ws["opt_state"][ANOM_CONSEC_KEY]) == 0
    assert any(not torch.equal(a, b) for a, b in zip(
        before["params"], popt.tree_leaves(ws["params"])))


def test_escalation_restores_and_halves_lr():
    """Every step NaN from step 6 on crosses anomaly_patience and
    escalates: best weights restored, the lr multiplier halved in
    opt_state, the consecutive counter reset — zero recompiles, and the
    same rollbacks and losses as the JAX Trainer."""
    _set(anomaly_patience=3)
    _arm(nan_grad_at_step=list(range(6, 60)))
    jtr, ptr = _pair(max_epochs=4)
    jtr.run()
    ptr.run()
    assert ptr.anomaly_rollbacks == jtr.anomaly_rollbacks >= 1
    assert ptr.decision.lr_multiplier == jtr.decision.lr_multiplier <= 0.5
    assert float(ptr.wstate["opt_state"][LR_MULT_KEY]) \
        == ptr.decision.lr_multiplier
    assert ptr.step_cache.compiles == 2
    assert ptr.step_cache.recompiles == 0
    assert ptr.results["anomaly_rollbacks"] == ptr.anomaly_rollbacks
    _same_losses(ptr, jtr)


def test_escalation_walks_back_to_last_valid_snapshot(tmp_path):
    """With no best state in memory the escalation restores the last
    snapshot, walking back past a torn one (counted), halves the lr
    multiplier and zeroes the consecutive counter; training then goes on
    with zero recompiles."""
    _set(anomaly_patience=2)
    snap = Snapshotter("esc", str(tmp_path))
    jtr = _jax_trainer(1)
    tr = _port_trainer(jtr, max_epochs=1, snapshotter=snap)
    tr.run()                                  # writes esc_ep0
    good = Snapshotter.load(snap.last_path)["wstate"]
    faults.configure(truncate_snapshot=True)
    snap.save("torn", tr._payload())          # the newest, torn
    faults.reset()
    tr2 = _port_trainer(jtr, max_epochs=2, snapshotter=snap)
    tr2.wstate["opt_state"][ANOM_CONSEC_KEY].fill_(3)
    assert tr2._best_wstate is None
    tr2._escalate_anomaly(0, 3)
    assert tr2.anomaly_rollbacks == 1 and tr2.snapshot_walkbacks == 1
    np.testing.assert_array_equal(
        _host(tr2.wstate["params"]["fc1"]["w"]),
        np.asarray(good["params"]["fc1"]["w"]))
    assert float(tr2.wstate["opt_state"][LR_MULT_KEY]) == 0.5
    assert int(tr2.wstate["opt_state"][ANOM_CONSEC_KEY]) == 0
    tr2.run()
    assert tr2.results["snapshot_walkbacks"] == 1
    assert tr2.step_cache.compiles == 2
    assert tr2.step_cache.recompiles == 0


def test_sentinel_off_restores_a_sentinel_snapshot(tmp_path):
    """sentinel=False still trains and restores from a snapshot taken
    with the sentinel on (surplus reserved slots dropped)."""
    tr = _port_trainer(_jax_trainer(1), max_epochs=1)
    tr.run()
    path = Snapshotter("xover", str(tmp_path)).save("s", tr._payload())
    _set(sentinel=False)
    tr2 = _port_trainer(_jax_trainer(1), max_epochs=2)
    tr2.restore(path)
    tr2.run()
    assert tr2.decision.complete


# -- snapshot integrity / walk-back ----------------------------------------

def _train_with_snaps(tmp_path, prefix="ft", max_epochs=3):
    snap = Snapshotter(prefix, str(tmp_path))
    tr = _port_trainer(_jax_trainer(1), max_epochs, snap)
    tr.run()
    return tr, snap


def _npz(tmp_path, snap):
    with open(snap.last_path) as f:
        return os.path.join(str(tmp_path), json.load(f)["tensors"])


@pytest.mark.parametrize("corruption", ["truncate", "bitflip"])
def test_restore_walks_back_to_newest_valid(tmp_path, corruption):
    """A truncated OR bit-flipped newest snapshot makes Trainer.restore
    land on the previous valid one, count the walk-back, and keep
    training with zero recompiles."""
    tr, snap = _train_with_snaps(tmp_path)
    npz = _npz(tmp_path, snap)
    if corruption == "truncate":
        with open(npz, "rb+") as f:
            f.truncate(os.path.getsize(npz) // 2)
    else:
        data = bytearray(open(npz, "rb").read())
        data[len(data) // 2] ^= 0xFF
        open(npz, "wb").write(bytes(data))
    tr2 = _port_trainer(_jax_trainer(1), max_epochs=5)
    compiles0 = tr2.step_cache.compiles
    tr2.restore(snap.last_path)
    assert tr2.snapshot_walkbacks == 1
    assert tr2.step_cache.compiles == compiles0
    prev = Snapshotter.load(os.path.join(str(tmp_path), "ft_ep1.json"))
    np.testing.assert_array_equal(
        _host(tr2.wstate["params"]["fc1"]["w"]),
        np.asarray(prev["wstate"]["params"]["fc1"]["w"]))
    tr2.run()
    assert tr2.step_cache.recompiles == 0


def test_walkback_exhaustion_raises(tmp_path):
    tr, snap = _train_with_snaps(tmp_path)
    for fn in os.listdir(str(tmp_path)):
        if fn.endswith(".npz"):
            p = os.path.join(str(tmp_path), fn)
            with open(p, "rb+") as f:
                f.truncate(max(os.path.getsize(p) // 2, 1))
    with pytest.raises(SnapshotCorruptError, match="no valid snapshot"):
        restore_with_walkback(snap.last_path)


def test_truncate_snapshot_knob_and_checksums(tmp_path):
    """The harness's truncate_snapshot knob makes exactly the torn write
    the walk-back defends against; ``snapshot_checksum`` names a blob by
    its bytes and ``compare_snapshots`` diffs two snapshots by tensor."""
    snap = Snapshotter("tk", str(tmp_path))
    tr = _port_trainer(_jax_trainer(1), max_epochs=1)
    payload = tr._payload()
    good = snap.save("good", payload)
    same = snap.save("same", payload)
    faults.configure(truncate_snapshot=True)
    bad = snap.save("bad", payload)
    faults.reset()
    with pytest.raises(SnapshotCorruptError):
        Snapshotter.load(bad)
    loaded, used, skipped = restore_with_walkback(bad)
    assert os.path.realpath(used) == os.path.realpath(same)
    assert len(skipped) == 1
    assert snapshot_checksum(good) == snapshot_checksum(same) != ""
    assert snapshot_checksum(str(tmp_path / "missing.json")) == ""
    tr.run()
    moved = snap.save("moved", tr._payload())
    diff = compare_snapshots(good, moved)
    rows = {r["key"]: r for r in diff["rows"]}
    assert rows["params/fc1/w"]["max_abs"] > 0
    assert rows["params/fc1/w"]["shape"] == [8, 16]
    assert not diff["only_a"] and not diff["only_b"]
    assert "loader" in diff["meta"]
    assert all(r["max_abs"] == 0 for r in
               compare_snapshots(good, same)["rows"])


# -- loader transient-read retry -------------------------------------------

def _loaders():
    data, labels, kw = _data()
    return (ArrayLoader(data, labels, **kw),
            InductionLoader(minibatch_size=16, n_train=64, n_valid=16,
                            seq_len=12, vocab=16, device="cpu"))


@pytest.mark.parametrize("which", [0, 1], ids=["host", "fullbatch"])
def test_loader_retry_recovers_injected_ioerror(which):
    """The first fetch of batch 1 fails; the retry serves every batch,
    identical to an unarmed epoch."""
    root.common.loader.retry_backoff_s = 0.001
    clean = _loaders()[which]
    clean.initialize()
    want = [dict(b) for b in clean.iter_epoch(TRAIN)]
    faults.configure(loader_ioerror_at_batch=[1])
    ld = _loaders()[which]
    ld.initialize()
    got = [dict(b) for b in ld.iter_epoch(TRAIN)]
    assert len(got) == len(want) == ld.n_minibatches(TRAIN)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert np.asarray(g[k]).tobytes() == np.asarray(w[k]).tobytes()


def test_loader_retry_exhaustion_names_batch_index():
    root.common.loader.retries = 0
    faults.configure(loader_ioerror_at_batch=[2])
    ld = _loaders()[0]
    ld.initialize()
    with pytest.raises(LoaderError, match="minibatch 2"):
        list(ld.iter_epoch(TRAIN))


def test_batch_specs_need_no_gather():
    """A card-resident batch states its specs before any gather (the
    trainer builds its workflow and static inputs from them)."""
    ld = _loaders()[1]
    ld.initialize()
    b = next(ld.iter_epoch(TRAIN))
    assert b.specs() == {"@input": Spec((16, 12), torch.int32),
                         "@labels": Spec((16,), torch.int32),
                         "@mask": Spec((16,), torch.float32)}
    assert b._fresh is None
    assert {k: (tuple(v.shape), v.dtype) for k, v in b.items()} == {
        k: (s.shape, s.dtype) for k, s in b.specs().items()}
