"""A started ``DecodeEngine`` is stopped and joined at interpreter exit.

``runtime/engine.py`` keeps a weak registry of engines whose scheduler
thread runs, and one ``atexit`` callback stops and joins each: a daemon
``decode-engine`` thread left inside a CUDA call at finalization would
abort the process (see ``_stop_live_engines``).  On the CPU these tests
show the registry and the callback; tests/test_torch_cuda.py shows a
child process on the card exiting 0 while its engine decodes.
"""

import os
import subprocess
import sys
import textwrap
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

from veles_tpu_torch.runtime import engine as engine_mod  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: a narrow LM (one attention block, vocab 16), random weights from seed 0
_LM = """
import torch
from veles_tpu_torch.models.standard import StandardWorkflow
from veles_tpu_torch.units.base import Spec
layers = [{"type": "embedding", "vocab": 16, "dim": 16, "name": "emb"},
          {"type": "attention", "n_heads": 2, "residual": True,
           "name": "attn"},
          {"type": "all2all", "output_size": 16, "per_position": True,
           "name": "head"}]
wf = StandardWorkflow({"name": "lm", "layers": layers}).workflow
wf.build({"@input": Spec((2, 8), torch.int32),
          "@labels": Spec((2, 8), torch.int32),
          "@mask": Spec((2,), torch.float32)})
ws = wf.init_state(0, device="cpu")
"""


def _engine():
    scope = {}
    exec(_LM, scope)
    return engine_mod.DecodeEngine(scope["wf"], scope["ws"], slots=2,
                                   l_max=32, window_ms=0.0, device="cpu")


def test_started_engine_is_in_the_registry_and_the_exit_hook_stops_it():
    eng = _engine()
    assert eng not in engine_mod._LIVE_ENGINES
    eng.start()
    try:
        thread = eng._thread
        assert thread.is_alive() and eng in engine_mod._LIVE_ENGINES
        assert engine_mod._EXIT_HOOK
        engine_mod._stop_live_engines()      # what atexit calls
        assert not thread.is_alive() and not eng.started
        assert eng not in engine_mod._LIVE_ENGINES
    finally:
        eng.stop()


def test_stopped_engine_leaves_the_registry():
    eng = _engine().start()
    eng.stop()
    assert not eng.started and eng not in engine_mod._LIVE_ENGINES


def test_a_thread_that_outlasts_the_join_stays_registered():
    """A scheduler thread still running when ``stop``'s wait ends stays
    the engine's and in the registry, so the exit hook still sees it."""
    eng = _engine().start()
    thread = eng._thread
    with mock.patch.object(thread, "join", lambda timeout=None: None):
        eng.stop(timeout=0.01)
    try:
        assert eng._thread is thread and eng in engine_mod._LIVE_ENGINES
    finally:
        eng.stop()
    assert not thread.is_alive() and eng not in engine_mod._LIVE_ENGINES


def test_the_exit_hook_signals_every_engine_before_it_joins_any():
    """The hook sets every live engine's stop event before its first join
    and hands the joins one shared wait, not one wait per engine."""
    engines = [_engine().start() for _ in range(2)]
    seen, waits = [], []
    real_stop = engine_mod.DecodeEngine.stop

    def stop(self, timeout=30.0):
        seen.append([e._stop_evt.is_set() for e in engines])
        waits.append(timeout)
        real_stop(self, timeout)

    try:
        with mock.patch.object(engine_mod.DecodeEngine, "stop", stop):
            engine_mod._stop_live_engines()
        assert seen[0] == [True, True]
        assert all(w <= engine_mod._EXIT_JOIN_S for w in waits)
        assert waits[1] <= waits[0]
        assert not any(e.started for e in engines)
    finally:
        for e in engines:
            e.stop()


def test_process_exiting_while_its_engine_decodes_joins_the_thread():
    """A child leaves its engine decoding a long request and returns: the
    exit hook stops and joins the scheduler thread (an ``atexit``
    callback registered before it, so run after it, finds no
    ``decode-engine`` thread alive) and the process exits 0."""
    child = _LM + textwrap.dedent("""
        import atexit, threading
        atexit.register(lambda: print("alive_at_exit", sum(
            t.name == "decode-engine" and t.is_alive()
            for t in threading.enumerate())))
        from veles_tpu_torch.runtime.engine import DecodeEngine
        eng = DecodeEngine(wf, ws, slots=2, l_max=4096, window_ms=0.0,
                           device="cpu").start()
        req = eng.submit([1, 2, 3], 4000)
        while req.first_token_at is None:
            threading.Event().wait(0.01)
        print("decoding", eng.started)
        """)
    r = subprocess.run([sys.executable, "-c", child], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "decoding True" in r.stdout
    assert "alive_at_exit 0" in r.stdout
