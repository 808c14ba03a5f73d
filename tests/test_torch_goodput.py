"""Goodput and MFU of the port against the contracts of
tests/test_perf_observability.py:123,138,149,393: the MFU arithmetic
with a fake clock and the peak override (equal to the JAX package's
functions), each kernel module's ``cost()`` against a hand count at two
shapes, the trainer's ``train_step_flops`` against the hand count of a
tiny LM (and unchanged with every kernel route patched to its plain
version), and the engine's headroom and decode-bandwidth gauges fresh on
the scheduler tick without a ``stats()`` call, the bandwidth back to 0
at idle."""

import json
import time
import urllib.request

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from veles_tpu.runtime import benchmark as jax_bench  # noqa: E402
from veles_tpu_torch.config import root  # noqa: E402
from veles_tpu_torch.loader.base import TRAIN, VALID, ArrayLoader  # noqa: E402
from veles_tpu_torch.models.standard import build_workflow  # noqa: E402
from veles_tpu_torch.ops import optimizers as popt  # noqa: E402
from veles_tpu_torch.ops.kernels import (KERNELS, flash_attention,  # noqa: E402
                                         flash_bwd_dkv, flash_bwd_dq,
                                         fused_dropout, gather_rows,
                                         mean_disp, paged_attention)
from veles_tpu_torch.runtime import benchmark  # noqa: E402
from veles_tpu_torch.runtime.decision import Decision  # noqa: E402
from veles_tpu_torch.runtime.engine import DecodeEngine  # noqa: E402
from veles_tpu_torch.runtime.metrics import registry  # noqa: E402
from veles_tpu_torch.runtime.restful import RestfulServer  # noqa: E402
from veles_tpu_torch.runtime.status import (StatusReporter,  # noqa: E402
                                            StatusServer)
from veles_tpu_torch.runtime.step_cache import CostCounter  # noqa: E402
from veles_tpu_torch.runtime.trainer import Trainer  # noqa: E402
from veles_tpu_torch.units.base import Spec  # noqa: E402

torch.set_num_threads(2)

V, E, H, FF = 16, 32, 2, 64
LM = [{"type": "embedding", "vocab": V, "dim": E, "name": "emb"},
      {"type": "attention", "n_heads": H, "rope": True, "residual": True,
       "name": "a1"},
      {"type": "layer_norm", "name": "n1"},
      {"type": "ffn", "d_hidden": FF, "name": "f1"},
      {"type": "all2all", "output_size": V, "per_position": True,
       "name": "out"}]


@pytest.fixture
def peak(request):
    """``root.common.observe.<knob>`` set for one test."""
    knob, value = request.param
    old = root.common.observe.get(knob, 0.0)
    setattr(root.common.observe, knob, value)
    yield value
    setattr(root.common.observe, knob, old)


# -- the arithmetic ----------------------------------------------------------

def test_mfu_arithmetic_known_flops_fake_clock():
    g = benchmark.epoch_goodput(1e9, 10, 2.0, peak_tflops=2.0)
    assert g["flops_per_sec"] == pytest.approx(5e9)
    assert g["mfu"] == pytest.approx(5e9 / 2e12)
    assert g == jax_bench.epoch_goodput(1e9, 10, 2.0, peak_tflops=2.0)
    for args in ((0.0, 1.0, 2.0), (1e9, 0.0, 2.0), (1e9, 1.0, 0.0),
                 (3e12, 1.5, 989.0)):
        assert benchmark.mfu_fraction(*args) == jax_bench.mfu_fraction(
            *args)
    assert benchmark.mfu_fraction(1e9, 0.0, 2.0) == 0.0
    assert benchmark.epoch_goodput(1e9, 0, 1.0, peak_tflops=1.0)["mfu"] \
        == 0.0


@pytest.mark.parametrize("peak", [("peak_tflops", 3.5)], indirect=True)
def test_resolve_peak_tflops_override_then_db(peak, tmp_path, monkeypatch):
    assert benchmark.resolve_peak_tflops() == 3.5
    root.common.observe.peak_tflops = 0.0
    monkeypatch.setattr(root.common, "cache_dir", str(tmp_path))
    assert benchmark.resolve_peak_tflops("cpu") == 0.0  # no DB: unknown
    info = benchmark.benchmark_device(device="cpu", sizes=(64, 128),
                                      dtypes=("float32",), reps=1)
    assert info["device_kind"] == "cpu" and info["platform"] == "cpu"
    assert len(info["results"]) == 2 and info["computing_power"] > 0
    assert benchmark.resolve_peak_tflops("cpu") == max(
        e["tflops"] for e in info["results"])
    # cached per device kind: a second call measures nothing
    with open(benchmark.device_info_path()) as f:
        assert json.load(f)["cpu"]["results"] == info["results"]
    assert benchmark.benchmark_device(device="cpu") == info


# -- each kernel's count -----------------------------------------------------

def _pairs_causal(Tq, Tk, W=None):
    return sum(min(i + 1, Tk, W or Tk) for i in range(Tq))


@pytest.mark.parametrize("B,Tq,Tk,Hq,Hk,D,causal,W", [
    (2, 8, 8, 4, 4, 16, True, None),
    (1, 5, 12, 4, 2, 64, False, None),
    (3, 16, 16, 2, 1, 16, True, 5),
])
def test_flash_costs_equal_the_hand_count(B, Tq, Tk, Hq, Hk, D, causal, W):
    q = torch.empty(B, Tq, Hq, D, dtype=torch.bfloat16)
    k = torch.empty(B, Tk, Hk, D, dtype=torch.bfloat16)
    pairs = _pairs_causal(Tq, Tk, W) if causal else Tq * Tk
    nq, nk, rows = B * Tq * Hq * D, B * Tk * Hk * D, B * Hq * Tq * 4
    assert flash_attention.cost(q, k, k, causal, W) == {
        "flops": 4 * B * Hq * D * pairs,
        "bytes": 2 * (2 * nq + 2 * nk) + rows}
    assert flash_bwd_dq.cost(q, k, k, causal, W) == {
        "flops": 6 * B * Hq * D * pairs,
        "bytes": 2 * (3 * nq + 2 * nk) + 2 * rows}
    assert flash_bwd_dkv.cost(q, k, k, causal, W) == {
        "flops": 8 * B * Hq * D * pairs,
        "bytes": 2 * (2 * nq + 4 * nk) + 2 * rows}


@pytest.mark.parametrize("pos,psz,W,pool", [
    ([0, 17, 40], 16, None, torch.float32),
    ([5, 63], 8, 10, torch.bfloat16),
])
def test_paged_cost_equals_the_hand_count(pos, psz, W, pool):
    B, Hq, Hk, Dh = len(pos), 4, 2, 16
    q = torch.empty(B, Hq, Dh)
    k_pool = torch.empty(64, psz, Hk, Dh, dtype=pool)
    lo = [max(p - W + 1, 0) if W else 0 for p in pos]
    live = sum(p - a + 1 for p, a in zip(pos, lo))
    pages = sum(p // psz - a // psz + 1 for p, a in zip(pos, lo))
    elt = torch.empty(0, dtype=pool).element_size()
    assert paged_attention.cost(q, k_pool, pos, page_size=psz,
                                window=W) == {
        "flops": 4 * Hq * Dh * live,
        "bytes": 2 * live * Hk * Dh * elt + B * Hq * Dh * 4
        + B * Hq * Dh * 4 + pages * 4 + B * 4}


@pytest.mark.parametrize("shape,dtype", [((512, 4096), torch.float32),
                                         ((100, 256), torch.bfloat16)])
def test_bytes_kernels_costs_equal_the_hand_count(shape, dtype):
    x = torch.empty(shape, dtype=dtype)
    n, elt = x.numel(), x.element_size()
    assert fused_dropout.cost(x) == {"flops": 0.0,
                                     "bytes": 2 * n * elt + 4}
    u8 = torch.empty(shape, dtype=torch.uint8)
    mean = torch.empty(shape[1:])
    assert mean_disp.cost(u8, mean) == {
        "flops": 2 * n, "bytes": n + 4 * n + 2 * 4 * shape[1]}
    labels = torch.empty(shape[0], dtype=torch.int32)
    m = 16
    row = shape[1] * elt
    assert gather_rows.cost([x, labels], m, mask=True) == {
        "flops": 0.0, "bytes": 2 * m * (row + 4) + m * 4 + m * 4}
    assert gather_rows.cost([x], m) == {"flops": 0.0,
                                        "bytes": 2 * m * row + m * 4}


def test_wrappers_report_once_and_hide_their_plain_ops():
    """Under a counter a wrapper adds its ``cost()`` and none of its plain
    version's products; without one it computes no cost."""
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    with CostCounter() as cc:
        out, _ = flash_attention.flash_attention(q, q, q, causal=True)
        out.sum().backward()
    pairs = _pairs_causal(8, 8)
    assert cc.kernels == {
        name: {**fn(q, q, q, True), "calls": 1}
        for name, fn in ((flash_attention.NAME, flash_attention.cost),
                         (flash_bwd_dq.NAME, flash_bwd_dq.cost),
                         (flash_bwd_dkv.NAME, flash_bwd_dkv.cost))}
    assert cc.flops == 18 * 2 * 16 * pairs
    assert all(callable(k.cost) for k in KERNELS)


# -- the trainer ---------------------------------------------------------------

def _lm_trainer(B=4, T=8):
    rng = np.random.default_rng(0)
    d = rng.integers(0, V, (3 * B, T)).astype(np.int32)
    lab = rng.integers(0, V, (3 * B, T)).astype(np.int32)
    tr = Trainer(build_workflow("mfu", LM),
                 ArrayLoader({TRAIN: d, VALID: d[:B]},
                             {TRAIN: lab, VALID: lab[:B]},
                             minibatch_size=B),
                 popt.Adam(1e-3), Decision(max_epochs=2), device="cpu")
    tr.initialize(seed=0)
    return tr


def _hand_count(B=4, T=8):
    M = B * T
    mm = 2 * M * E * E * 4 + 2 * M * E * FF * 2 + 2 * M * E * V
    return 3 * mm + 18 * B * H * (E // H) * _pairs_causal(T, T)


@pytest.mark.parametrize("peak", [("peak_tflops", 1.0)], indirect=True)
def test_trainer_reports_step_flops_and_mfu(peak):
    tr = _lm_trainer()
    results = tr.run()
    assert results["train_step_flops"] == pytest.approx(_hand_count(),
                                                        rel=0.01)
    assert results["peak_tflops"] == 1.0
    assert results["train_mfu"] > 0
    reg = registry()
    assert reg.get("vt_train_flops_per_sec").value > 0
    assert reg.get("vt_train_mfu").value == pytest.approx(
        results["train_mfu"], rel=1e-6)
    assert 'vt_program_flops{program="train"}' in reg.render()


def test_step_flops_the_same_with_every_route_plain(monkeypatch):
    want = _lm_trainer().run()["train_step_flops"]
    for mod in KERNELS:
        monkeypatch.setattr(mod, "kernel_route", lambda x, name: False)
    assert _lm_trainer().run()["train_step_flops"] == want


# -- the engine -----------------------------------------------------------------

def _lm_engine(**kw):
    wf = build_workflow("good", LM)
    wf.build({"@input": Spec((2, 8), torch.int32),
              "@labels": Spec((2, 8), torch.int32),
              "@mask": Spec((2, 8), torch.float32)})
    ws = wf.init_state(0, None, "cpu")
    return wf, ws, DecodeEngine(wf, ws, slots=2, l_max=64, page_size=8,
                                paged=True, paged_kernel=True,
                                window_ms=0.0, device="cpu", **kw)


def _wait(cond, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


@pytest.mark.parametrize("peak", [("peak_hbm_gbps", 1.0)], indirect=True)
def test_engine_gauges_fresh_without_stats_polling(peak):
    _, _, eng = _lm_engine()
    reg = registry()
    g_bw = reg.get("vt_decode_bandwidth_bytes_per_sec")
    g_mbu = reg.get("vt_decode_mbu")
    g_head = reg.get("vt_memory_headroom_slots")
    seen = []
    eng.start()
    try:
        assert _wait(lambda: g_head.value == 2, 10)
        req = eng.submit(np.arange(1, 6, dtype=np.int32), 50)
        assert _wait(lambda: seen.append((g_bw.value, g_mbu.value,
                                          g_head.value))
                     or g_bw.value > 0, 30), "bandwidth never went live"
        bw, mbu, _ = seen[-1]
        assert mbu == pytest.approx(bw / 1e9, rel=1e-3)
        assert req.done.wait(120) and req.error is None
        # idle decay: no token step for > 2 s and the gauge reads 0
        assert _wait(lambda: g_bw.value == 0, 10)
        assert g_mbu.value == 0 and g_head.value == 2
    finally:
        eng.stop()


def test_decode_bytes_follow_the_positions():
    """A dispatch's bytes are its program's count (made at the program's
    first execution) with the paged kernel's part at that dispatch's
    positions: one position further on every live slot adds the K and V
    of one position of each layer."""
    _, _, eng = _lm_engine()
    cache = eng.step_cache
    assert cache.program_cost("decode_greedy")["bytes_accessed"] == 0.0
    assert eng.stats()["goodput"]["decode_bandwidth_bytes_per_sec"] == 0.0
    eng.start()
    try:
        eng.generate(np.arange(1, 4, dtype=np.int32)[None], 3, timeout=60)
        good = eng.stats()["goodput"]
    finally:
        eng.stop()
    c = cache.program_cost("decode_greedy")
    pk = c["kernels"][paged_attention.NAME]
    assert pk["calls"] == 1                     # one attention layer
    assert c["bytes_accessed"] > pk["bytes"] > 0
    assert good["decode_step_bytes"] == c["bytes_accessed"]
    assert good["decode_bandwidth_bytes_per_sec"] > 0
    on = np.ones(2, bool)
    at0 = eng._dispatch_bytes([("decode_greedy", np.zeros(2, np.int64), on)])
    at9 = eng._dispatch_bytes([("decode_greedy", np.full(2, 9), on)])
    per_pos = 2 * (E // H) * H * 4                  # K and V, float32
    pages = 2 * (9 // 8 + 1 - 1) * 4                # one more page a row
    assert at9 - at0 == pytest.approx(2 * 9 * per_pos + pages)
    # a read prices every dispatch since the last at once
    both = eng._dispatch_bytes([("decode_greedy", np.zeros(2, np.int64), on),
                                ("decode_greedy", np.full(2, 9), on)])
    assert both == pytest.approx(at0 + at9)
    assert eng.stats()["headroom_slots"] == 2
    # free slots, bounded by the max-length page spans left (n_ptab 8)
    assert eng._headroom_slots({"free": 7, "cached": 2}) == 1
    assert eng._headroom_slots({"free": 3, "cached": 2}) == 0
    eng._active[0] = True
    assert eng._headroom_slots({"free": 16, "cached": 0}) == 1
    assert eng._headroom_slots(None) == 1


def test_status_page_and_engine_endpoint_carry_goodput(tmp_path):
    wf, ws, eng = _lm_engine()
    eng.start()
    rep = StatusReporter(str(tmp_path / "status.json"))
    st = StatusServer(rep).start()
    srv = RestfulServer(wf.make_predict_step("out"), ws, 2, (8,),
                        workflow=wf, engine=eng, input_dtype=np.int32,
                        device="cpu").start()
    try:
        eng.generate(np.arange(1, 4, dtype=np.int32)[None], 3, timeout=60)
        rep.update(engine=eng.stats())
        doc = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/engine", timeout=30).read())
        assert set(doc["goodput"]) >= {"decode_bandwidth_bytes_per_sec",
                                       "decode_mbu", "decode_step_bytes",
                                       "tokens_per_sec_per_chip"}
        assert doc["headroom_slots"] == 2
        page = urllib.request.urlopen(f"http://127.0.0.1:{st.port}/",
                                      timeout=30).read().decode()
        for row in ("engine.goodput.decode_mbu",
                    "engine.goodput.decode_bandwidth_bytes_per_sec",
                    "engine.headroom_slots"):
            assert f"<td>{row}</td>" in page
    finally:
        srv.stop()
        st.stop()
        eng.stop()
