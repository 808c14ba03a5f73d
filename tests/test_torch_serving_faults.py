"""The serving half of the port's fault harness (runtime/faults.py) on
the CPU, held to tests/test_faults.py:407-540: an injected scheduler
crash fails the pending request with SchedulerCrashed (HTTP 500 with
``kind: scheduler_crash``), records a ``scheduler_crash`` status event,
flips ``stats()["scheduler_crashed"]`` and keeps later submits failing
loudly; ``decode_stall_ms`` slows exactly one decode step inside its
timed window; ``admission_burst`` floods the engine's own queue with
lowest-class requests that decode and retire; the plan parses and fires
once per arming; and ``kv_transfer_drop`` / ``kv_transfer_slow_ms``
fail or slow a drain's page handoff while the drain goes on."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.runtime import faults as jax_faults  # noqa: E402
from veles_tpu_torch.runtime import faults  # noqa: E402
from veles_tpu_torch.runtime.deploy import DeployController  # noqa: E402
from veles_tpu_torch.runtime.engine import (DecodeEngine,  # noqa: E402
                                            SchedulerCrashed)
from veles_tpu_torch.runtime.restful import RestfulServer  # noqa: E402
from veles_tpu_torch.runtime.status import StatusReporter  # noqa: E402

from _torch_helpers import build_pair  # noqa: E402

torch.set_num_threads(2)

V = 12
LAYERS = [
    {"type": "embedding", "vocab": V, "dim": 12, "name": "emb"},
    {"type": "attention", "n_heads": 2, "rope": True, "residual": True,
     "name": "a1"},
    {"type": "seq_last", "name": "last"},
    {"type": "softmax", "output_size": V, "name": "out"},
]


@pytest.fixture(scope="module")
def lm():
    return build_pair(LAYERS, B=2, T=6, seed=3)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.reset()


def _engine(lm, **kw):
    *_, pwf, pws = lm
    kw = {"slots": 2, "l_max": 32, "window_ms": 0.0, **kw}
    return DecodeEngine(pwf, pws, device="cpu", **kw)


def _events(rep, kind, timeout=3.0):
    """The status events of ``kind`` (they may ride the coalescing
    window: poll briefly)."""
    deadline = time.monotonic() + timeout
    while True:
        events = [e for e in rep.read().get("events", [])
                  if e["kind"] == kind]
        if events or time.monotonic() > deadline:
            return events
        time.sleep(0.05)


def test_scheduler_crash_fails_work_with_500_and_event(lm, tmp_path):
    *_, pwf, pws = lm
    rep = StatusReporter(str(tmp_path / "status.json"))
    eng = _engine(lm, status=rep)
    srv = RestfulServer(pwf.make_predict_step("out"), pws, 2, (6,),
                        workflow=pwf, engine=eng, device="cpu")
    eng.start()
    srv.start()
    try:
        faults.configure(scheduler_crash=True)
        req = eng.submit(np.array([1, 2, 3], np.int32), 4)
        assert req.done.wait(20)
        assert isinstance(req.error, SchedulerCrashed)
        assert eng.stats()["scheduler_crashed"] is True
        events = _events(rep, "scheduler_crash")
        assert events and "FaultInjected" in events[0]["error"]
        with pytest.raises(SchedulerCrashed):
            eng.submit(np.array([1], np.int32), 2)
        body = json.dumps({"prompt": [[1, 2]], "steps": 2}).encode()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/generate", body,
                {"Content-Type": "application/json"}), timeout=30)
        assert ei.value.code == 500
        assert json.loads(ei.value.read())["kind"] == "scheduler_crash"
        # a crashed scheduler is never a clean drain
        assert eng.drain(1.0) is False
    finally:
        srv.stop()
        eng.stop()


def test_scheduler_crash_waits_for_pending_work(lm):
    """Armed on an idle engine, the crash fires only once work is
    pending, so it always exercises the fail-all path."""
    eng = _engine(lm).start()
    try:
        faults.configure(scheduler_crash=True)
        time.sleep(0.3)                   # idle ticks: nothing fires
        assert eng.started and not eng.stats()["scheduler_crashed"]
        req = eng.submit(np.array([1, 2, 3], np.int32), 4)
        assert req.done.wait(20)
        assert isinstance(req.error, SchedulerCrashed)
    finally:
        eng.stop()


def test_decode_stall_knob_slows_one_step(lm):
    """One artificially slow decode step: the request still completes
    correctly, the stall lands in the timed window (the step histogram's
    max), and it fires once per arming."""
    eng = _engine(lm).start()
    try:
        prompt = np.array([1, 2, 3], np.int32)
        req = eng.submit(prompt, 3)
        assert req.done.wait(120) and req.error is None
        ref = req.result
        faults.configure(decode_stall_ms=200.0)
        t0 = time.monotonic()
        req = eng.submit(prompt, 3)
        assert req.done.wait(120) and req.error is None
        stalled = time.monotonic() - t0
        assert stalled >= 0.2, stalled
        np.testing.assert_array_equal(req.result, ref)
        assert eng.stats()["decode_step_s_max"] >= 0.2
        t0 = time.monotonic()
        req = eng.submit(prompt, 3)
        assert req.done.wait(120) and req.error is None
        assert time.monotonic() - t0 < stalled
    finally:
        eng.stop()


def test_admission_burst_knob_floods_own_queue(lm):
    """N synthetic lowest-class requests straight into the engine's own
    queue (bypassing submit's shed gate); they decode and retire like
    real traffic, once per arming."""
    eng = _engine(lm, priorities=2).start()
    try:
        base = eng.stats()["retired"]
        faults.configure(admission_burst=5)
        deadline = time.monotonic() + 120
        while eng.stats()["retired"] < base + 5:
            assert time.monotonic() < deadline, eng.stats()
            time.sleep(0.01)
        st = eng.stats()
        assert st["admitted"] >= 5
        assert st["scheduler_crashed"] is False
        time.sleep(0.3)
        assert eng.stats()["retired"] == base + 5      # fired once
    finally:
        eng.stop()


def test_fault_plan_parsing_and_one_shot():
    """The serving knobs parse as the JAX package's plan parses them,
    and the one-shot memory resets with the plan."""
    knobs = dict(scheduler_crash=1, decode_stall_ms=7.5, admission_burst=4,
                 kv_transfer_drop=2, kv_transfer_slow_ms=80)
    plan = faults.configure(**knobs)
    try:
        jplan = jax_faults.configure(**knobs)
        for k in knobs:
            assert getattr(plan, k) == getattr(jplan, k), k
    finally:
        jax_faults.reset()
    assert plan.scheduler_crash is True and plan.decode_stall_ms == 7.5
    assert plan.admission_burst == 4 and plan.kv_transfer_drop == 2
    assert bool(plan)
    plan = faults.configure(nan_grad_at_step=3, slow_batch_ms=1.5)
    assert plan.nan_grad_at_step == (3,) and bool(plan)
    assert not plan.scheduler_crash and not plan.admission_burst
    assert faults.fire_once("x", 1)
    assert not faults.fire_once("x", 1)
    faults.reset()
    assert not faults.enabled() and not faults.get_plan()
    assert faults.fire_once("x", 1)


def _drain_with_handoff(lm, rng, **knobs):
    """Engine A with two cached pages drains with a handoff to engine B;
    returns (B's imported pages, the drain's wall seconds, clean)."""
    *_, pwf, pws = lm
    a = _engine(lm, l_max=64).start()
    b = _engine(lm, l_max=64)
    srv = RestfulServer(pwf.make_predict_step("out"), pws, 2, (6,),
                        workflow=pwf, engine=b, device="cpu")
    b.start()
    srv.start()
    try:
        a.generate(rng.integers(0, V, (1, 40)).astype(np.int32), 2,
                   timeout=120)
        faults.configure(**knobs)
        dep = DeployController(engine=a, drain_timeout_s=30)
        t0 = time.monotonic()
        out = {}
        t = threading.Thread(target=lambda: out.setdefault(
            "clean", dep.drain(handoff=f"http://127.0.0.1:{srv.port}")))
        t.start()
        t.join(120)
        return (b.stats()["kv_transfer"]["imported_pages"],
                time.monotonic() - t0, out.get("clean"), a.started)
    finally:
        srv.stop()
        b.stop()
        a.stop()


def test_kv_transfer_drop_fails_the_handoff_not_the_drain(lm, rng):
    imported, _, clean, running = _drain_with_handoff(
        lm, rng, kv_transfer_drop=1)
    assert imported == 0 and clean is True and not running


def test_kv_transfer_slow_delays_the_handoff(lm, rng):
    imported, wall, clean, _ = _drain_with_handoff(
        lm, rng, kv_transfer_slow_ms=300)
    assert imported == 2 and clean is True and wall >= 0.3
