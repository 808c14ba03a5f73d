"""The port's admission controller, SLO windows and metrics registry on
the CPU, against the JAX package's (tests/test_overload.py:489-600): the
same fake-clock burn trace gives the same window sequence, allowances,
backoff and state; the rolling SLO windows read the same percentiles and
burn off the same observations; and an engine behind a closed window
sheds its low class first, or displaces it for a higher arrival."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.runtime import admission as jax_admission  # noqa: E402
from veles_tpu.runtime import metrics as jax_metrics  # noqa: E402
from veles_tpu.runtime import slo as jax_slo  # noqa: E402
from veles_tpu_torch.runtime import admission, metrics, slo  # noqa: E402
from veles_tpu_torch.runtime.engine import (DecodeEngine,  # noqa: E402
                                            EngineOverloaded)

from _torch_helpers import SERVE_V as V  # noqa: E402
from _torch_helpers import held, serve_pair, wait_busy  # noqa: E402

torch.set_num_threads(2)

#: (seconds to advance, burn) — burning, the floor, the mid band, a
#: recovery held too briefly, a blip re-arming the hold, regrowth to the
#: ceiling, and a second burn
TRACE = ([(0.0, 10.0), (0.0, 10.0)] + [(1.0, 10.0)] * 5 + [(1.0, 1.5)]
         + [(1.0, 0.4), (4.0, 0.4), (1.0, 1.5), (1.0, 0.4), (5.0, 0.4)]
         + [(1.0, 0.4)] * 5 + [(1.0, 10.0)] * 2 + [(0.3, 10.0)]
         + [(1.0, 0.9)] * 3)


def _controllers(**kw):
    clock, burn = [0.0], [0.0]
    ctls = [mod.AdmissionController(
        burn_fn=lambda: burn[0], clock=lambda: clock[0], **kw)
        for mod in (jax_admission, admission)]
    return ctls, clock, burn


@pytest.mark.parametrize("kw", [
    dict(queue_depth=64, priorities=4, enabled=True, min_window=2,
         interval_s=1.0, hold_s=5.0, decrease=0.5, increase=2.0,
         burn_threshold=2.0),
    dict(queue_depth=16, priorities=1, enabled=True, min_window=3,
         interval_s=0.5, hold_s=2.0, decrease=0.7, increase=1.5,
         burn_threshold=1.0),
    dict(queue_depth=16, priorities=3, enabled=False)],
    ids=["four_classes", "one_class", "disabled"])
def test_controller_window_sequence_matches_jax(kw):
    """Both packages' controllers under one fake clock and burn trace:
    the same window after every tick, the same allowance for every
    class, backoff factor and state."""
    (jctl, pctl), clock, burn = _controllers(**kw)
    seq = []
    for dt, b in TRACE:
        clock[0] += dt
        burn[0] = b
        w = pctl.tick()
        assert w == jctl.tick()
        seq.append(w)
        for p in range(kw["priorities"] + 1):
            assert pctl.allowance(p) == jctl.allowance(p)
        assert pctl.backoff_factor() == jctl.backoff_factor()
        assert pctl.state() == jctl.state()
    if kw["enabled"] and kw["priorities"] == 4:
        # the reference test's pinned law: shrink, floor, hold, regrow
        assert seq[:7] == [32.0, 32.0, 16.0, 8.0, 4.0, 2.0, 2.0]
        assert max(seq) == 64.0 and seq[-4] < 64.0
    if not kw["enabled"]:
        assert set(seq) == {float(kw["queue_depth"])}


def test_controller_knob_validation():
    for mod in (jax_admission, admission):
        with pytest.raises(ValueError):
            mod.AdmissionController(queue_depth=8, decrease=1.5)
        with pytest.raises(ValueError):
            mod.AdmissionController(queue_depth=8, increase=0.9)


def test_slo_windows_match_jax():
    """The same observations under one fake clock: the port's tracker
    (over its HistogramWindow and registry) reads the JAX package's
    windowed percentiles, burn rates and burning flags."""
    clock = [100.0]
    trackers, hists = [], []
    for mod, met in ((jax_slo, jax_metrics), (slo, metrics)):
        reg = met.MetricsRegistry()
        hists.append({"ttft": reg.histogram("vt_request_ttft_seconds", "t"),
                      "queue_wait": reg.histogram(
                          "vt_request_queue_wait_seconds", "q")})
        # a registry of the test's own, bound when the tracker is built
        mod_registry = mod.registry
        mod.registry = lambda reg=reg: reg
        try:
            trackers.append(mod.SloTracker(
                window_s=10.0, slices=5, burn_threshold=2.0,
                targets_ms={"ttft": 50.0, "queue_wait": 5.0},
                clock=lambda: clock[0]))
        finally:
            mod.registry = mod_registry
    rng = np.random.default_rng(7)
    for step in range(40):
        clock[0] += 0.7
        vals = rng.lognormal(-3.5, 1.0, 4)
        for h in hists:
            for v in vals:
                h["ttft"].observe(float(v))
                h["queue_wait"].observe(float(v) / 10)
        docs = [t.doc() for t in trackers]
        docs[0].pop("degrade_ready"), docs[1].pop("degrade_ready")
        assert docs[1] == docs[0], step
        assert trackers[1].max_burn() == trackers[0].max_burn()
    assert docs[1]["metrics"]["ttft"]["count"] > 0
    assert any(d["metrics"]["ttft"]["burn_rate"] > 0 for d in docs)


@pytest.mark.parametrize("q", [0.0, 0.5, 0.9, 0.99, 1.0])
def test_quantile_and_fraction_over_match_jax(q):
    pairs = [(0.001, 3.0), (0.01, 10.0), (0.1, 12.0), (math.inf, 13.0)]
    assert metrics.quantile_from_cumulative(pairs, q) == \
        jax_metrics.quantile_from_cumulative(pairs, q)
    assert metrics.fraction_over(pairs, q / 10) == \
        jax_metrics.fraction_over(pairs, q / 10)


def test_registry_renders_counters_gauges_and_histograms():
    reg = metrics.MetricsRegistry()
    reg.counter("c_total", "c", labels=("outcome",)).labels(
        outcome="ok").inc(2)
    reg.gauge("g", "g").set(1.5)
    h = reg.histogram("h_seconds", "h", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    text = reg.render()
    for line in ('c_total{outcome="ok"} 2', "g 1.5",
                 'h_seconds_bucket{le="0.1"} 1',
                 'h_seconds_bucket{le="1"} 2',
                 'h_seconds_bucket{le="+Inf"} 3', "h_seconds_count 3"):
        assert line in text, line
    with pytest.raises(ValueError):
        reg.gauge("c_total", "again", labels=("outcome",))
    with pytest.raises(ValueError):
        reg.counter("c_total", "c").inc(-1)


# -- the engine behind a closed window ----------------------------------------

@pytest.fixture(scope="module")
def lm():
    return serve_pair()


def test_closed_window_sheds_low_class_first(rng, lm):
    """A controller pinned nearly shut (window 2: class 2's allowance 1)
    sheds a class-2 submit while the queue holds work, with the adaptive
    Retry-After, and counts it in shed_by_class."""
    ctl = admission.AdmissionController(
        queue_depth=8, priorities=3, burn_fn=lambda: 10.0, interval_s=0.0,
        min_window=2, enabled=True)
    ctl.tick()
    ctl.tick()                      # 8 -> 4 -> 2
    eng = DecodeEngine(lm[2], lm[3], slots=1, l_max=64, window_ms=0.0,
                       queue_depth=8, priorities=3, preempt=False,
                       admission=ctl, device="cpu").start()
    try:
        with held(eng):
            holder = eng.submit(rng.integers(0, V, 4), 6)
            wait_busy(eng)
            queued = eng.submit(rng.integers(0, V, 4), 2, priority=1)
            with pytest.raises(EngineOverloaded) as ei:
                eng.submit(rng.integers(0, V, 4), 2, priority=2)
            assert ei.value.retry_after_s >= 4.0   # 4x closed window
            st = eng.stats()
            assert st["admission"]["shed_by_class"] == {"2": 1}, st
            assert st["admission"]["window"] == 2.0
        for r in (holder, queued):
            assert r.done.wait(180) and r.error is None
    finally:
        eng.stop()


def test_closed_window_displaces_lower_class_not_arrival(rng, lm):
    """The queue fills with class 2 while the window is open; once a
    burn closes it, a class-1 arrival displaces the youngest class-2
    request instead of being shed itself."""
    burn = [0.0]
    ctl = admission.AdmissionController(
        queue_depth=8, priorities=3, burn_fn=lambda: burn[0],
        interval_s=0.0, hold_s=60.0, min_window=2, enabled=True)
    eng = DecodeEngine(lm[2], lm[3], slots=1, l_max=64, window_ms=0.0,
                       queue_depth=8, priorities=3, preempt=False,
                       admission=ctl, device="cpu").start()
    try:
        with held(eng):
            holder = eng.submit(rng.integers(0, V, 4), 6)
            wait_busy(eng)
            low = [eng.submit(rng.integers(0, V, 4), 2, priority=2)
                   for _ in range(3)]
            burn[0] = 10.0
            # the held scheduler does not tick: the test drives it
            while ctl.tick() > 2.0:
                pass
            mid = eng.submit(rng.integers(0, V, 4), 2, priority=1)
            # the youngest class-2 request is shed; the held scheduler
            # finishes nothing else meanwhile
            assert low[-1].done.wait(30)
            assert isinstance(low[-1].error, EngineOverloaded)
            assert not any(r.done.is_set() for r in low[:2])
            assert eng.stats()["admission"]["shed_by_class"] == {"2": 1}
            burn[0] = 0.0
        for r in (holder, mid, low[0], low[1]):
            assert r.done.wait(180) and r.error is None, r.error
    finally:
        eng.stop()
