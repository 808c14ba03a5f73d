"""The port's StepCache against the JAX package's contracts
(tests/test_step_cache.py:51-259): the counters and a key miss, hits
across a re-initialize, zero recompiles across a Decision rollback and a
``Trainer.restore``, and the lr multiplier in opt_state bitwise where the
JAX Trainer has it; then what the cache decides before any capture (no
unit blocks one: the dropout units draw their seeds from device slots),
the in-place state writes a captured step relies on, and the launch
counters' capture bookkeeping.

On the CPU the cache returns the eager step and counts one build per
program, as it counts one capture on the card (tests/test_torch_cuda.py
holds the captured step against the eager one there)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import veles_tpu as vt  # noqa: E402
from veles_tpu.ops import optimizers as jopt  # noqa: E402
from veles_tpu.ops.optimizers import LR_MULT_KEY as JAX_LR_MULT  # noqa: E402
from veles_tpu.units import nn as jnn  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.loader.base import TRAIN, VALID, ArrayLoader  # noqa: E402
from veles_tpu_torch.models.alexnet import ALEXNET_CONFIG  # noqa: E402
from veles_tpu_torch.models.standard import build_workflow  # noqa: E402
from veles_tpu_torch.ops import optimizers as popt  # noqa: E402
from veles_tpu_torch.ops.kernels.build import LaunchCounter  # noqa: E402
from veles_tpu_torch.ops.optimizers import LR_MULT_KEY  # noqa: E402
from veles_tpu_torch.runtime.decision import Decision  # noqa: E402
from veles_tpu_torch.runtime.metrics import registry  # noqa: E402
from veles_tpu_torch.runtime.snapshotter import (Snapshotter,  # noqa: E402
                                                 params_from_jax)
from veles_tpu_torch.runtime.step_cache import (StepCache,  # noqa: E402
                                                tree_signature)
from veles_tpu_torch.runtime.trainer import Trainer  # noqa: E402
from veles_tpu_torch.units import nn  # noqa: E402
from veles_tpu_torch.units.base import Spec  # noqa: E402
from veles_tpu_torch.units.workflow import Workflow, new_state  # noqa: E402
from _torch_helpers import port_autotune_off  # noqa: E402,F401

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _reset_port_prng():
    prng.streams.reset()
    yield
    prng.streams.reset()


def _fc_wf(pkg):
    wf = (vt.Workflow if pkg is jnn else Workflow)("sc")
    wf.add(pkg.All2AllTanh(16, name="fc1", inputs=("@input",)))
    wf.add(pkg.All2AllSoftmax(3, name="fc2", inputs=("fc1",)))
    wf.add(pkg.EvaluatorSoftmax(name="ev",
                                inputs=("fc2", "@labels", "@mask")))
    return wf


def _blob(dim=8, n=96):
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((3, dim)) * 3
    lab = rng.integers(0, 3, n).astype(np.int32)
    d = (centers[lab] + rng.standard_normal((n, dim))).astype(np.float32)
    return {TRAIN: d, VALID: d[:32]}, {TRAIN: lab, VALID: lab[:32]}


def _trainer(opt=None, decision=None, snapshotter=None, **kw):
    data, labels = _blob()
    return Trainer(_fc_wf(nn), ArrayLoader(data, labels, minibatch_size=32),
                   opt or popt.SGD(0.05), decision or Decision(max_epochs=1),
                   snapshotter, device="cpu", **kw)


def _rollback_decision(epochs):
    # lr 0 keeps the epoch metrics constant, so rollback_after=1 rolls
    # back deterministically from epoch 1 on
    return Decision(max_epochs=epochs, fail_iterations=10, rollback_after=1)


def test_step_cache_counters_and_key_miss():
    """Same key hits; a changed batch geometry misses; a second program
    of a kind for one workflow counts as a recompile."""
    cache = StepCache()
    calls = []
    wf = _fc_wf(nn)

    def build():
        calls.append(1)
        return wf.make_eval_step()

    args = ({"params": {}}, {"@input": torch.zeros(4, 8)})
    fn1 = cache.get_step("eval", ("k", 1), build, args)
    fn2 = cache.get_step("eval", ("k", 1), build, args)
    assert fn1 is fn2 and len(calls) == 1
    assert cache.compiles == 1 and cache.hits == 1
    assert cache.recompiles == 0
    assert cache.stats()["eval"] == {"captured": False, "reason": "cpu"}
    cache.get_step("eval", ("k", 2), build, args)
    assert cache.compiles == 2 and len(calls) == 2
    assert cache.recompiles == 1
    st = cache.stats()
    assert st["programs"] == 2 and st["compile_wall_s"] >= 0.0
    assert st["captures"] == 0           # the CPU captures nothing
    text = registry().render()
    assert 'vt_compile_total{program="eval"}' in text
    assert 'vt_compile_hits_total{program="eval"}' in text
    assert 'vt_recompile_total{program="eval"}' in text


def test_trainer_key_misses_on_changed_geometry():
    """The key covers the batch geometry and the state's shapes and
    dtypes, so a stale step never serves another signature."""
    tr = _trainer()
    tr.initialize(seed=0)
    cache = tr.step_cache
    key = cache.trainer_key(tr.workflow, tr.optimizer, tr.wstate,
                            tr._batch_spec, "cpu")
    wider = {**tr._batch_spec, "@input": Spec((64, 8), torch.float32)}
    assert cache.trainer_key(tr.workflow, tr.optimizer, tr.wstate, wider,
                             "cpu") != key
    assert cache.trainer_key(tr.workflow, popt.SGD(0.05), tr.wstate,
                             tr._batch_spec, "cpu") != key
    assert tree_signature({"a": torch.zeros(2, 3), "b": (1, np.zeros(2))}) \
        == (("/a", "(2, 3)", "torch.float32"), ("/b/0", "()", "int"),
            ("/b/1", "(2,)", "float64"))


def test_step_cache_hits_across_reinitialize():
    """Re-initializing the same trainer (unchanged shapes) is a hit; the
    eval step is built on the first eval epoch, once."""
    tr = _trainer()
    tr.initialize(seed=0)
    assert tr.step_cache.compiles == 1   # eval is lazy
    tr.initialize(seed=1)
    assert tr.step_cache.compiles == 1
    assert tr.step_cache.hits == 1
    tr.run()
    assert tr.step_cache.compiles == 2
    assert tr.step_cache.recompiles == 0


def test_rollback_zero_recompiles():
    tr = _trainer(popt.SGD(0.0, momentum=0.9), _rollback_decision(4))
    tr.initialize(seed=0)
    assert tr.step_cache.compiles == 1
    mult = tr.wstate["opt_state"][LR_MULT_KEY]
    tr.run()
    assert tr.decision.lr_multiplier < 1.0  # rollbacks happened
    assert tr.step_cache.compiles == 2
    assert tr.step_cache.recompiles == 0
    # written into the same tensor the step reads
    assert tr.wstate["opt_state"][LR_MULT_KEY] is mult
    assert float(mult) == tr.decision.lr_multiplier


def test_restore_zero_recompiles(tmp_path):
    snap = Snapshotter("sc", str(tmp_path))
    tr = _trainer(popt.SGD(0.0, momentum=0.9), _rollback_decision(3), snap)
    tr.initialize(seed=0)
    tr.run()
    assert tr.decision.lr_multiplier < 1.0
    tr2 = _trainer(popt.SGD(0.0, momentum=0.9), Decision(max_epochs=5))
    tr2.initialize(seed=1)
    compiles0 = tr2.step_cache.compiles
    w = tr2.wstate["params"]["fc1"]["w"]
    tr2.restore(snap.last_path)
    assert tr2.step_cache.compiles == compiles0
    assert tr2.wstate["params"]["fc1"]["w"] is w  # written in place
    np.testing.assert_array_equal(
        w.numpy(), Snapshotter.load(snap.last_path)["wstate"]["params"][
            "fc1"]["w"])
    assert tr2.effective_lr(0) == pytest.approx(
        float(popt.SGD(0.0).schedule(0)) * tr2.decision.lr_multiplier)
    tr2.run()
    assert tr2.step_cache.compiles == compiles0 + 1
    assert tr2.step_cache.recompiles == 0


def test_lr_multiplier_bitwise_against_the_jax_trainer():
    """The same rollbacks in both packages leave the same float32
    multiplier in opt_state and the same effective learning rate, bit for
    bit; and the port's multiplied step equals a step on the scaled
    schedule bitwise (the reference's traced-multiplier contract)."""
    data, labels = _blob()
    jtr = vt.Trainer(_fc_wf(jnn), vt.ArrayLoader(data, labels,
                                                 minibatch_size=32),
                     jopt.SGD(0.05, momentum=0.9),
                     vt.Decision(max_epochs=4, fail_iterations=10,
                                 rollback_after=1))
    jtr.initialize(seed=0)
    tr = _trainer(popt.SGD(0.05, momentum=0.9), _rollback_decision(4))
    tr.initialize(seed=0)
    params = params_from_jax(jax.device_get(jtr.wstate["params"]),
                             tr.workflow, device="cpu")
    tr.initialize(wstate=new_state(params, {}, tr.optimizer.init(params), 0,
                                   None))
    jtr.run()
    tr.run()
    assert tr.decision.lr_multiplier == jtr.decision.lr_multiplier < 1.0
    got = tr.wstate["opt_state"][LR_MULT_KEY].numpy()
    want = np.asarray(jax.device_get(jtr.wstate["opt_state"][JAX_LR_MULT]))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert tr.effective_lr(5) == jtr.effective_lr(5)

    scale = 0.25
    wf = _fc_wf(nn)
    wf.build({"@input": Spec((8, 8), torch.float32),
              "@labels": Spec((8,), torch.int32),
              "@mask": Spec((8,), torch.float32)})
    rng = np.random.default_rng(3)
    batch = {"@input": torch.from_numpy(
                 rng.standard_normal((8, 8)).astype(np.float32)),
             "@labels": torch.from_numpy(
                 rng.integers(0, 3, 8).astype(np.int32)),
             "@mask": torch.ones(8)}
    base = popt.fixed_lr(0.05)
    o_old = popt.SGD(lr_policy=lambda s: base(s) * np.float32(scale),
                     momentum=0.9)
    o_new = popt.SGD(lr_policy=base, momentum=0.9)
    ws_old, ws_new = wf.init_state(0, o_old, "cpu"), wf.init_state(0, o_new,
                                                                 "cpu")
    ws_new["opt_state"][LR_MULT_KEY].fill_(scale)
    s_old, s_new = wf.make_train_step(o_old), wf.make_train_step(o_new)
    for _ in range(3):
        ws_old, m_old = s_old(ws_old, batch)
        ws_new, m_new = s_new(ws_new, batch)
    for a, b in zip(popt.tree_leaves(ws_old["params"]),
                    popt.tree_leaves(ws_new["params"])):
        assert torch.equal(a, b)
    assert torch.equal(m_old["loss"], m_new["loss"])


def test_capture_blockers_come_from_the_units():
    """No unit blocks a capture any more: AlexNet's dropout units draw
    their seeds from device slots the train step fills (``draws_seed``),
    so its train step is captured like the LM's; no unit names a
    blocker, the LM's units draw no seed, a dropout at ratio 0 none."""
    alex = build_workflow("alexnet", ALEXNET_CONFIG["layers"])
    assert [u.name for u in alex.topo_order() if u.draws_seed] == [
        "drop6", "drop7"]
    assert alex.make_train_step(popt.SGD(lr=0.1)).seeded == [
        "drop6", "drop7"]
    assert not any(hasattr(u, "capture_blocker") for u in alex.topo_order())
    lm = _fc_wf(nn)
    assert not any(u.draws_seed for u in lm.topo_order())
    off = build_workflow("nodrop", [{"type": "dropout",
                                     "dropout_ratio": 0.0},
                                    {"type": "softmax", "output_size": 3}])
    assert not any(u.draws_seed for u in off.topo_order())


def test_train_step_writes_the_state_in_place():
    """Every tensor of the state the step read is the one it wrote:
    params, optimizer slots and scalars (the condition a captured step
    holds to)."""
    tr = _trainer(popt.Adam(1e-3))
    tr.initialize(seed=0)
    before = [id(t) for t in popt.tree_leaves(tr.wstate)
              if torch.is_tensor(t)]
    vals = [t.clone() for t in popt.tree_leaves(tr.wstate["params"])]
    tr.run()
    assert [id(t) for t in popt.tree_leaves(tr.wstate)
            if torch.is_tensor(t)] == before
    assert any(not torch.equal(a, b) for a, b in zip(
        vals, popt.tree_leaves(tr.wstate["params"])))
    assert tr.wstate["step"] == 3


def test_tree_assign_writes_values_keeps_tensors():
    dst = {"a": torch.zeros(3), "t": (torch.zeros(2), torch.zeros(())),
           "step": 4, "key": np.zeros(2, np.uint32)}
    a, t0 = dst["a"], dst["t"][0]
    src = {"a": np.arange(3, dtype=np.float32), "t": (torch.ones(2),
                                                      torch.full((), 2.)),
           "step": 7, "key": np.ones(2, np.uint32), "new": torch.ones(1)}
    out = popt.tree_assign(dst, src)
    assert out is dst and dst["a"] is a and dst["t"][0] is t0
    assert dst["a"].tolist() == [0, 1, 2] and float(dst["t"][1]) == 2
    assert dst["step"] == 7 and dst["key"].tolist() == [1, 1]
    assert "new" in dst


def test_tree_assign_refuses_a_shape_it_cannot_write_in_place():
    """A tensor leaf of another shape, or a tuple of another length, is
    refused by path: rebinding it would leave a captured step replaying
    on the old tensors."""
    dst = {"u": {"w": torch.zeros(3)}, "t": (torch.zeros(2),)}
    with pytest.raises(ValueError, match="/u/w"):
        popt.tree_assign(dst, {"u": {"w": np.zeros(4, np.float32)}})
    with pytest.raises(ValueError, match="/t"):
        popt.tree_assign(dst, {"t": (torch.zeros(2), torch.zeros(2))})
    assert dst["u"]["w"].shape == (3,) and len(dst["t"]) == 1


def test_restore_of_another_width_raises(tmp_path):
    """A snapshot of the same layer list at another width passes the
    checksum (names, types, inputs) but not the shape check: restore
    raises before it writes anything, so the live tensors are intact."""
    def wide_trainer(width, snapshotter=None):
        wf = Workflow("sc")
        wf.add(nn.All2AllTanh(width, name="fc1", inputs=("@input",)))
        wf.add(nn.All2AllSoftmax(3, name="fc2", inputs=("fc1",)))
        wf.add(nn.EvaluatorSoftmax(name="ev",
                                   inputs=("fc2", "@labels", "@mask")))
        data, labels = _blob()
        return Trainer(wf, ArrayLoader(data, labels, minibatch_size=32),
                       popt.SGD(0.05), Decision(max_epochs=1), snapshotter,
                       device="cpu")

    snap = Snapshotter("sc", str(tmp_path))
    tr = wide_trainer(16, snap)
    tr.initialize(seed=0)
    tr.run()
    tr2 = wide_trainer(24)
    tr2.initialize(seed=1)
    assert tr2.workflow.checksum() == tr.workflow.checksum()
    before = [t.clone() for t in popt.tree_leaves(tr2.wstate)
              if torch.is_tensor(t)]
    with pytest.raises(ValueError, match="fc1"):
        tr2.restore(snap.last_path)
    with pytest.raises(ValueError, match="fc1"):
        tr2.restore(snap.last_path, force=True)
    after = [t for t in popt.tree_leaves(tr2.wstate) if torch.is_tensor(t)]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_launch_counter_capture_bookkeeping():
    """A capture reads a counter's state, undoes what its recorded calls
    added, and a replay adds them back, by variant."""
    c = LaunchCounter()
    c.inc("tc")
    before = c.state()
    c.inc("tc")
    c.inc("simt")
    assert c.state() == (3, {"tc": 2, "simt": 1})
    c.set_state(before)
    assert c.count == 1 and c.by_variant() == {"tc": 1}
    c.add(2, {"tc": 1, "simt": 1})
    assert c.count == 3 and c.by_variant() == {"tc": 2, "simt": 1}


def test_capture_gate_keeps_replays_out_of_a_capture():
    """The process-wide capture gate: replays run together, a capture
    waits for the replays in flight and holds new ones until it ends, a
    replay nested in its own thread's replay never waits, and a capture
    inside a replay of the same thread raises instead of deadlocking."""
    import threading
    import time
    from veles_tpu_torch.runtime.step_cache import _CaptureGate
    gate = _CaptureGate()
    log, lock = [], threading.Lock()
    in_replay, release = threading.Event(), threading.Event()

    def replayer(tag, hold):
        with gate.replay():
            with lock:
                log.append(("in", tag))
            if hold:
                in_replay.set()
                assert release.wait(60)
            with gate.replay():             # nested: never waits
                pass
        with lock:
            log.append(("out", tag))

    def capturer():
        with gate.capture():
            with lock:
                log.append(("capture", None))

    first = threading.Thread(target=replayer, args=("a", True))
    cap = threading.Thread(target=capturer)
    second = threading.Thread(target=replayer, args=("b", False))
    first.start()
    try:
        assert in_replay.wait(60)
        cap.start()
        # the capture waits for "a"; a new replay queues behind it
        deadline = time.monotonic() + 60
        while not gate._waiting:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        second.start()
    finally:
        release.set()
    for t in (first, cap, second):
        t.join(60)
        assert not t.is_alive()
    assert log.index(("out", "a")) < log.index(("capture", None)) \
        < log.index(("in", "b")), log
    with gate.replay():
        with pytest.raises(RuntimeError, match="wait for itself"):
            with gate.capture():
                pass
    with gate.capture():                    # free again
        pass
