"""O(1) carried-state decode of the recurrent family in the port
(runtime/generate.py, runtime/engine.py) on the CPU, on float32 weights
shared with the JAX package.

Against JAX: ``generate()`` on the recurrent chains of
tests/test_generate.py:94-156 (the pipeline stack left out: the port has
no pipeline stacks yet), greedy token for token, and beam search; the
engine on tests/test_engine.py:48-54's RECURRENT chain, paged and dense,
against the JAX engine's tokens.  Within the port, bitwise: megastep and
speculative verify against the N=1 engine (tokens and the carries left
behind, tests/test_megastep.py:129), chunked prefill crossing slices
against the whole prefill (tests/test_overload.py:99), a preempted
sampled request against its uninterrupted run.  Such a chain takes no
prefix shortcut (tests/test_paged.py:167) and refuses KV-page transfer,
in the library and over REST (tests/test_disagg.py:182)."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.runtime.engine import DecodeEngine as JaxEngine  # noqa: E402
from veles_tpu.runtime.generate import generate as jax_generate  # noqa: E402
from veles_tpu.runtime.generate import (  # noqa: E402
    generate_beam as jax_generate_beam)
from veles_tpu_torch.runtime.engine import DecodeEngine  # noqa: E402
from veles_tpu_torch.runtime.generate import (  # noqa: E402
    DecodePlan, generate, generate_beam)
from veles_tpu_torch.runtime.restful import RestfulServer  # noqa: E402

from _torch_helpers import build_pair, held, wait_busy  # noqa: E402

torch.set_num_threads(2)

V = 12

#: tests/test_generate.py's recurrent chains, less the pipeline stack
CHAINS = {
    "rnn_lm": [
        {"type": "embedding", "vocab": V, "dim": 16, "name": "emb"},
        {"type": "rnn", "hidden": 16, "name": "r1"},
        {"type": "seq_last", "name": "last"},
        {"type": "softmax", "output_size": V, "name": "out"}],
    "gru_lstm_stacked": [
        {"type": "embedding", "vocab": V, "dim": 16, "name": "emb"},
        {"type": "gru", "hidden": 16, "name": "g1"},
        {"type": "lstm", "hidden": 16, "name": "l1"},
        {"type": "seq_last", "name": "last"},
        {"type": "softmax", "output_size": V, "name": "out"}],
    "lstm_last_hidden": [
        {"type": "embedding", "vocab": V, "dim": 16, "name": "emb"},
        {"type": "lstm", "hidden": 16, "return_sequences": False,
         "name": "l1"},
        {"type": "softmax", "output_size": V, "name": "out"}],
    "mixed_rnn_attention": [
        {"type": "embedding", "vocab": V, "dim": 16, "name": "emb"},
        {"type": "attention", "n_heads": 2, "rope": True,
         "residual": True, "name": "a1"},
        {"type": "gru", "hidden": 16, "name": "g1"},
        {"type": "seq_last", "name": "last"},
        {"type": "softmax", "output_size": V, "name": "out"}],
}

#: tests/test_engine.py:48-54
RECURRENT = [
    {"type": "embedding", "vocab": V, "dim": 12, "name": "emb"},
    {"type": "gru", "hidden": 12, "name": "g1"},
    {"type": "lstm", "hidden": 12, "name": "l1"},
    {"type": "seq_last", "name": "last"},
    {"type": "softmax", "output_size": V, "name": "out"},
]


@pytest.fixture(scope="module")
def rec_lm():
    return build_pair(RECURRENT, B=2, T=6, seed=3)


def _engine(lm, **kw):
    kw.setdefault("window_ms", 0.0)
    return DecodeEngine(lm[2], lm[3], device="cpu", **kw)


def _carries(eng):
    return {k: {p: t.clone() for p, t in c.items()}
            for k, c in eng._caches.items() if k in ("g1", "l1")}


def _same_carries(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        for p in a[k]:
            assert torch.equal(a[k][p], b[k][p]), (k, p)


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_generate_matches_jax(rng, chain):
    """Greedy tokens of the port's ``generate()`` are JAX's, token for
    token; beam search's tokens too, its scores at rtol 1e-5."""
    layers = CHAINS[chain]
    jwf, jws, pwf, pws = build_pair(layers, B=2, T=8, seed=0)
    prompt = rng.integers(0, V, (2, 5)).astype(np.int32)
    ref = np.asarray(jax_generate(jwf, jws, prompt, 7))
    np.testing.assert_array_equal(generate(pwf, pws, prompt, 7).numpy(), ref)
    jt, js = jax_generate_beam(jwf, jws, prompt, 5, beams=3)
    pt, ps = generate_beam(pwf, pws, prompt, 5, beams=3)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-5)
    plan = DecodePlan(pwf)
    assert [u.name for u in plan._rec_units] == [
        s["name"] for s in layers if s["type"] in ("rnn", "gru", "lstm")]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_engine_matches_jax_engine(rng, rec_lm, paged):
    """Mixed prompt and step shapes through both engines: the port's
    tokens are the JAX engine's and the JAX ``generate()``'s."""
    jwf, jws, _, _ = rec_lm
    shapes = [(3, 5), (7, 4), (11, 6), (4, 3), (17, 5)]
    prompts = [rng.integers(0, V, (1, p)).astype(np.int32)
               for p, _ in shapes]
    jeng = JaxEngine(jwf, jws, slots=4, l_max=64, window_ms=0.0).start()
    try:
        jgot = [jeng.generate(pr, n, timeout=180)
                for pr, (_, n) in zip(prompts, shapes)]
    finally:
        jeng.stop()
    eng = _engine(rec_lm, slots=4, l_max=64, paged=paged).start()
    try:
        reqs = [eng.submit(pr[0], n) for pr, (_, n) in zip(prompts, shapes)]
        for r in reqs:
            assert r.done.wait(180) and r.error is None
        st = eng.stats()
    finally:
        eng.stop()
    for i, (r, j, pr) in enumerate(zip(reqs, jgot, prompts)):
        np.testing.assert_array_equal(r.result, np.asarray(j).reshape(-1),
                                      err_msg=str(shapes[i]))
        np.testing.assert_array_equal(
            r.result, np.asarray(jax_generate(jwf, jws, pr,
                                              shapes[i][1]))[0])
    assert st["retired"] == len(shapes)
    assert st["compile"]["recompiles"] == 0


def test_megastep_and_verify_carries_bitwise(rng, rec_lm):
    """Megastep (N=4) and speculative verify (k=3) leave the tokens and
    the carries of an N=1 engine bit for bit, greedy and sampled, a slot
    retiring inside a block included."""
    _, _, pwf, pws = rec_lm
    prompt = np.resize(rng.integers(0, V, 4), 11).astype(np.int32)[None]
    cases = [{}, {"temperature": 1.4, "top_k": 5, "seed": 11}]
    runs = {}
    for name, kw in (("n1", {}), ("mega", {"megastep": 4}),
                     ("spec", {"spec": True, "spec_k": 3})):
        eng = _engine(rec_lm, slots=1, l_max=64, **kw).start()
        try:
            toks, carries = [], []
            for c in cases:
                toks.append(eng.generate(prompt, 18, timeout=180, **c))
                carries.append(_carries(eng))
            st = eng.stats()
        finally:
            eng.stop()
        if name == "mega":
            assert st["megastep"]["mega_dispatches"] > 0, st
        if name == "spec":
            assert st["spec"]["verify_steps"] > 0, st
        runs[name] = (toks, carries)
    for c, ref in zip(cases, runs["n1"][0]):
        np.testing.assert_array_equal(
            ref, generate(pwf, pws, prompt, 18, **c).numpy())
    for name in ("mega", "spec"):
        for a, b in zip(runs[name][0], runs["n1"][0]):
            np.testing.assert_array_equal(a, b, err_msg=name)
        for a, b in zip(runs[name][1], runs["n1"][1]):
            _same_carries(a, b)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_chunked_prefill_carry_crosses_slices(rng, rec_lm, paged):
    """A chunk boundary carries the state on (a fresh admission resets
    it): chunk 8 over a 21-token prompt while another slot decodes is
    bitwise the whole prefill, greedy (JAX's tokens) and sampled."""
    jwf, jws, pwf, pws = rec_lm
    prompt = rng.integers(0, V, (1, 21)).astype(np.int32)
    other = rng.integers(0, V, 6).astype(np.int32)
    for kw in ({}, {"temperature": 1.1, "top_p": 0.95, "seed": 5}):
        ref = generate(pwf, pws, prompt, 5, **kw).numpy()
        if not kw:
            np.testing.assert_array_equal(
                ref, np.asarray(jax_generate(jwf, jws, prompt, 5)))
        eng = _engine(rec_lm, slots=2, l_max=64, paged=paged,
                      prefill_chunk=8).start()
        try:
            busy = eng.submit(other, 30)
            got = eng.generate(prompt, 5, timeout=180, **kw)
            assert busy.done.wait(180) and busy.error is None
            st = eng.stats()
        finally:
            eng.stop()
        np.testing.assert_array_equal(got, ref, err_msg=str(kw))
        np.testing.assert_array_equal(
            busy.result, generate(pwf, pws, other[None], 30).numpy()[0])
        assert st["prefill_calls"] >= 4, st
        assert st["compile"]["recompiles"] == 0


def test_preempted_request_is_bitwise_uninterrupted(rng, rec_lm):
    """A sampled class-1 request preempted by a class-0 arrival resumes
    by re-prefilling from token 0: its stream is its uninterrupted
    ``generate()``'s, bit for bit."""
    _, _, pwf, pws = rec_lm
    vic_p = rng.integers(0, V, (1, 5)).astype(np.int32)
    kw = dict(temperature=1.7, top_k=6, seed=23)
    ref = generate(pwf, pws, vic_p, 30, **kw).numpy()
    eng = _engine(rec_lm, slots=1, l_max=64, priorities=2,
                  preempt=True).start()
    try:
        with held(eng):
            victim = eng.submit(vic_p[0], 30, priority=1, **kw)
            wait_busy(eng)
            high = eng.submit(rng.integers(0, V, 4), 3, priority=0)
        assert high.done.wait(180) and victim.done.wait(180)
        assert victim.error is None and victim.preemptions >= 1
        np.testing.assert_array_equal(victim.result[None], ref)
    finally:
        eng.stop()


def test_no_prefix_shortcut(rng):
    """The mixed attention + GRU chain of tests/test_paged.py:167: an
    identical prompt twice takes no prefix hit and serves bitwise."""
    layers = CHAINS["mixed_rnn_attention"]
    _, _, pwf, pws = lm = build_pair(layers, B=2, T=8, seed=4)
    prompt = rng.integers(0, V, (1, 20)).astype(np.int32)
    ref = generate(pwf, pws, prompt, 5).numpy()
    eng = _engine(lm, slots=2, l_max=64).start()
    try:
        for _ in range(2):
            np.testing.assert_array_equal(
                eng.generate(prompt, 5, timeout=120), ref)
        pg = eng.stats()["pages"]
    finally:
        eng.stop()
    assert pg["prefix_hit_pages"] == 0 and pg["cow_admissions"] == 0, pg


def test_kv_transfer_refused_and_carries_counted(rec_lm):
    """KV-page transfer needs prefix reuse, which a recurrent chain
    disables: the library raises, ``GET``/``PUT /kv/pages`` answer 400;
    the memory ledger counts the carries as slot state, not KV."""
    _, _, pwf, pws = rec_lm
    eng = _engine(rec_lm, slots=2, l_max=32)
    with pytest.raises(ValueError, match="prefix reuse"):
        eng.export_pages([])
    with pytest.raises(ValueError, match="prefix reuse"):
        eng.import_pages(b"VTKV1\x00whatever")
    carry_bytes = sum(t.numel() * t.element_size()
                      for c in eng._caches.values() for t in c.values())
    assert eng._mem_bytes["kv_cache"] == 0
    assert eng._mem_bytes["slot_state"] == \
        eng._dstate["st"].numel() * 4 + carry_bytes
    srv = RestfulServer(pwf.make_predict_step("out"), pws, 2, (6,), port=0,
                        workflow=pwf, engine=eng, device="cpu")
    eng.start()
    srv.start()
    base = f"http://127.0.0.1:{srv.port}/kv/pages"
    try:
        for req in (urllib.request.Request(base + "?top=4"),
                    urllib.request.Request(base, data=b"VTKV1\x00x",
                                           method="PUT")):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=60)
            assert e.value.code == 400
            assert "prefix reuse" in json.loads(e.value.read())["error"]
    finally:
        srv.stop()
        eng.stop()


def test_cli_trains_a_recurrent_config_and_its_snapshot_decodes(tmp_path):
    """``python -m veles_tpu_torch CONFIG`` trains a GRU+LSTM config (a
    subprocess on the CPU, JAX unimportable there); its best snapshot
    loads into the port's workflow and decodes greedily as the JAX
    package's ``generate()`` does on the same weights."""
    import os
    import subprocess
    import sys
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.runtime.snapshotter import (Snapshotter,
                                                     wstate_from_snapshot)
    from veles_tpu_torch.units.base import Spec
    cfg = {"workflow": {"name": "RecLM", "layers": RECURRENT,
                        "loss": "softmax", "optimizer": "adam",
                        "optimizer_args": {"lr": 0.003}, "max_epochs": 1},
           "loader": {"name": "induction", "minibatch_size": 20,
                      "seq_len": 8, "vocab": V, "n_train": 60,
                      "n_valid": 20}}
    path = tmp_path / "rec.json"
    path.write_text(json.dumps(cfg))
    (tmp_path / "sitecustomize.py").write_text(
        "import sys\nsys.modules['jax'] = None\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path),
                                                       repo]))
    r = subprocess.run([sys.executable, "-m", "veles_tpu_torch", str(path),
                        "--random-seed", "1", "--device", "cpu",
                        "--snapshot-dir", str(tmp_path / "snap")],
                       capture_output=True, text=True, env=env, cwd=repo,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["epochs"] == 1 and np.isfinite(res["best_value"])
    snap = str(tmp_path / "snap" / "RecLM_best.json")
    wf = StandardWorkflow(cfg["workflow"]).workflow
    wf.build({"@input": Spec((2, 8), torch.int32),
              "@labels": Spec((2,), torch.int32),
              "@mask": Spec((2,), torch.float32)})
    ws = wstate_from_snapshot(snap, wf, device="cpu")
    prompt = np.arange(10, dtype=np.int32).reshape(2, 5) % V
    jwf, _, _, _ = build_pair(RECURRENT, B=2, T=6, seed=3)
    jws = {"params": Snapshotter.load(snap)["wstate"]["params"]}
    np.testing.assert_array_equal(
        generate(wf, ws, prompt, 6).numpy(),
        np.asarray(jax_generate(jwf, jws, prompt, 6)))
