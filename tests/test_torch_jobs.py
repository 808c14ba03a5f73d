"""The port's batch lane (veles_tpu_torch/runtime/jobs.py and the
engine's trough class) on the CPU, held to tests/test_jobs.py's
contracts and to the JAX package: the durable store commits and rebuilds
progress from disk, and a store either package writes is read by the
other's ``JobStore`` with the same done-set and the same result bytes;
the manager shards jobs into per-prompt batch-class dispatches with
exactly-once commits across 429 back-off and crash/resume; the REST job
API round-trips against a live engine (the JAX ``generate()``'s greedy
tokens); the trough gate 429s batch work with its short hint, batch stays
out of the SLO histograms, and a running batch request is the first
preemption victim and resumes bitwise.

Every manager and server a test starts is stopped in its ``finally``;
every wait has a deadline and no assertion rests on wall-clock speed."""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.runtime.generate import generate as jax_generate  # noqa: E402
from veles_tpu.runtime.jobs import JobStore as JaxJobStore  # noqa: E402
from veles_tpu.runtime.jobs import _Job as JaxJob  # noqa: E402
from veles_tpu_torch.config import root  # noqa: E402
from veles_tpu_torch.runtime.engine import (DecodeEngine,  # noqa: E402
                                            EngineOverloaded)
from veles_tpu_torch.runtime.generate import generate  # noqa: E402
from veles_tpu_torch.runtime.jobs import (JobError, JobManager,  # noqa: E402
                                          JobStore, _Job,
                                          handle_jobs_request)
from veles_tpu_torch.runtime.metrics import registry  # noqa: E402
from veles_tpu_torch.runtime.restful import RestfulServer  # noqa: E402

from _torch_helpers import build_pair, wait_for  # noqa: E402

pytestmark = pytest.mark.jobs

torch.set_num_threads(2)

V = 12

#: tests/test_jobs.py:38-44's LM
LAYERS = [
    {"type": "embedding", "vocab": V, "dim": 16, "name": "emb"},
    {"type": "attention", "n_heads": 2, "rope": True,
     "residual": True, "name": "a1"},
    {"type": "seq_last", "name": "last"},
    {"type": "softmax", "output_size": V, "name": "out"},
]


@pytest.fixture(scope="module")
def lm():
    """(jax_wf, jax_ws, port_wf, port_ws) on the seed-3 weights."""
    return build_pair(LAYERS, B=2, T=6, seed=3)


def fake_dispatch(body):
    """A stand-in replica: the prompt plus ``steps`` tokens derived from
    the per-prompt seed, a pure function of the body."""
    prompt = body["prompt"][0]
    seed = body.get("seed", 0)
    return 200, {"tokens": [list(prompt) + [(seed + k) % V
                                            for k in range(body["steps"])]]
                 }, ()


def mgr_of(tmp_path, dispatch, **kw):
    kw.setdefault("workers", 2)
    kw.setdefault("retry_s", 0.01)
    return JobManager(str(tmp_path / "jobs"), dispatch, **kw).start()


def result_files(tmp_path, job_id):
    d = tmp_path / "jobs" / job_id / "results"
    return sorted(os.listdir(d)) if d.exists() else []


def drained(mgr):
    """Until the in-flight ledger is empty: a job turns terminal on its
    last commit, just before that worker releases its ledger entry."""
    wait_for(lambda: mgr.summary()["prompts_inflight"] == 0, 60,
             "the in-flight ledger to empty")


def engine(pwf, pws, **kw):
    kw = {"slots": 2, "l_max": 64, "window_ms": 0.0, **kw}
    return DecodeEngine(pwf, pws, device="cpu", **kw)


# -- durable store -----------------------------------------------------------

def test_store_roundtrip_rebuilds_done_set_from_disk(tmp_path):
    """load_all recovers manifest and params and recomputes the done-set
    from the committed result files (error results land in failed_idx);
    a half-created job directory is skipped."""
    store = JobStore(str(tmp_path))
    job = _Job("j1", [[1, 2], [3, 4], [5, 6]], {"steps": 4}, 7,
               created=123.0)
    store.commit_manifest(job)
    store.commit_result("j1", 0, {"index": 0, "tokens": [1, 2, 9]})
    store.commit_result("j1", 2, {"index": 2, "error": "too long"})
    os.makedirs(tmp_path / "half-created")
    loaded = store.load_all()
    assert len(loaded) == 1
    got = loaded[0]
    assert got.id == "j1" and got.seed == 7
    assert got.prompts == [[1, 2], [3, 4], [5, 6]]
    assert got.params == {"steps": 4}
    assert got.done_idx == {0, 2} and got.failed_idx == {2}
    assert got.error_by_idx[2] == "too long"
    assert store.read_result("j1", 1) is None


def _write_store(store_cls, job_cls, base):
    store = store_cls(str(base))
    job = job_cls("jx", [[1, 2], [3], [4, 5, 6]],
                  {"steps": 3, "temperature": 0.5}, 40, created=7.5)
    store.commit_manifest(job)
    store.commit_result("jx", 0, {"index": 0, "tokens": [1, 2, 3, 4, 5]})
    store.commit_result("jx", 2, {"index": 2, "error": "bad prompt"})
    return job


def _store_bytes(base):
    out = {}
    for d, _dirs, files in os.walk(base):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, base)] = fh.read()
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_job_store_cross_package(tmp_path, writer):
    """A store one package writes is read by the other's ``JobStore``
    with the same done-set and failures, the same result documents, and
    the two packages write the same bytes for the same job."""
    _write_store(JobStore, _Job, tmp_path / "port")
    _write_store(JaxJobStore, JaxJob, tmp_path / "jax")
    assert _store_bytes(tmp_path / "port") == _store_bytes(tmp_path / "jax")
    reader = JaxJobStore if writer == "port" else JobStore
    got = reader(str(tmp_path / writer)).load_all()
    assert len(got) == 1
    job = got[0]
    assert (job.id, job.seed, job.prompts, job.params, job.created) == \
        ("jx", 40, [[1, 2], [3], [4, 5, 6]],
         {"steps": 3, "temperature": 0.5}, 7.5)
    assert job.done_idx == {0, 2} and job.failed_idx == {2}
    store = reader(str(tmp_path / writer))
    assert store.read_result("jx", 0) == {"index": 0,
                                          "tokens": [1, 2, 3, 4, 5]}
    assert store.read_result("jx", 1) is None


def test_job_resumed_by_the_other_package(tmp_path):
    """A job the JAX package's manager left half done is finished by the
    port's manager, which dispatches only the missing prompts and leaves
    the committed files' bytes as they were."""
    from veles_tpu.runtime.jobs import JobManager as JaxJobManager

    def first(body):
        if body["seed"] >= 2:
            return 429, {"error": "later"}, ()
        return fake_dispatch(body)

    jm = JaxJobManager(str(tmp_path / "jobs"), first, workers=1,
                       retry_s=0.01).start()
    try:
        jid = jm.submit({"prompts": [[i + 1] for i in range(5)],
                         "steps": 2})["id"]
        wait_for(lambda: jm.status(jid)["done"] >= 2, 60, "two results")
    finally:
        jm.stop()
    rdir = tmp_path / "jobs" / jid / "results"
    before = {p: (rdir / p).read_bytes() for p in result_files(tmp_path,
                                                               jid)}
    assert set(before) == {"000000.json", "000001.json"}
    seen = []
    mgr = mgr_of(tmp_path, lambda b: seen.append(b["seed"])
                 or fake_dispatch(b))
    try:
        assert mgr.wait(jid, timeout_s=60)
        assert sorted(seen) == [2, 3, 4]
        for p, blob in before.items():
            assert (rdir / p).read_bytes() == blob
        assert len(result_files(tmp_path, jid)) == 5
    finally:
        mgr.stop()


def test_manager_completes_job_deterministically(tmp_path):
    """A job reaches done with one committed result per prompt, in
    prompt order; every dispatch rides the batch class with the
    per-prompt seed."""
    seen, lock = [], threading.Lock()

    def dispatch(body):
        with lock:
            seen.append(body)
        return fake_dispatch(body)

    mgr = mgr_of(tmp_path, dispatch)
    try:
        doc = mgr.submit({"prompts": [[1, 2], [3], [4, 5, 6]], "steps": 3,
                          "seed": 100})
        assert doc["state"] == "running" and doc["prompts"] == 3
        assert mgr.wait(doc["id"], timeout_s=60)
        st = mgr.status(doc["id"])
        assert st["state"] == "done" and st["done"] == 3
        assert st["failed"] == 0
        res = mgr.results(doc["id"])
        assert [r["index"] for r in res["results"]] == [0, 1, 2]
        assert res["results"][0]["tokens"] == \
            [1, 2] + [(100 + k) % V for k in range(3)]
        assert "next_offset" not in res
        with lock:
            assert len(seen) == 3
            assert all(b["batch"] is True for b in seen)
            assert sorted(b["seed"] for b in seen) == [100, 101, 102]
        assert result_files(tmp_path, doc["id"]) == \
            ["000000.json", "000001.json", "000002.json"]
        assert mgr.summary()["by_state"] == {"done": 1}
    finally:
        mgr.stop()


@pytest.mark.parametrize("bad", [
    {"prompts": [[1]], "steps": 2, "temprature": 1.0},
    {"steps": 2},
    {"prompts": [[1]], "prompt_file": "x"},
    {"prompts": [], "steps": 2},
    {"prompts": [[]], "steps": 2},
    {"prompts": [[1, "a"]], "steps": 2},
    {"prompts": [[1.5]], "steps": 2},
    {"prompts": [[1]], "steps": 0},
    {"prompts": [[1]] * 5, "steps": 2},
    {"prompt_file": "missing.json"},
])
def test_spec_validation(tmp_path, bad):
    mgr = mgr_of(tmp_path, fake_dispatch, max_prompts=4)
    try:
        with pytest.raises(JobError):
            mgr.submit(bad)
        assert mgr.summary()["total"] == 0
    finally:
        mgr.stop()


def test_prompt_file_submission(tmp_path):
    pf = tmp_path / "prompts.json"
    pf.write_text(json.dumps([[1, 2], [3, 4]]))
    mgr = mgr_of(tmp_path, fake_dispatch)
    try:
        doc = mgr.submit({"prompt_file": str(pf), "steps": 2})
        assert mgr.wait(doc["id"], timeout_s=60)
        assert mgr.status(doc["id"])["done"] == 2
    finally:
        mgr.stop()


def test_429_backs_off_then_completes_exactly_once(tmp_path):
    """429s requeue with back-off and never double-commit: every prompt
    was turned away twice and still lands exactly one result file."""
    calls, lock = {}, threading.Lock()

    def dispatch(body):
        idx = body["seed"]          # seed == index (job seed 0)
        with lock:
            calls[idx] = calls.get(idx, 0) + 1
            if calls[idx] <= 2:
                return 429, {"error": "batch trough closed: busy",
                             "retry_after_s": 0.01}, ()
        return fake_dispatch(body)

    mgr = mgr_of(tmp_path, dispatch)
    try:
        doc = mgr.submit({"prompts": [[1], [2], [3]], "steps": 2})
        assert mgr.wait(doc["id"], timeout_s=120)
        assert mgr.status(doc["id"])["done"] == 3
        with lock:
            assert calls == {0: 3, 1: 3, 2: 3}, calls
        assert len(result_files(tmp_path, doc["id"])) == 3
        drained(mgr)
    finally:
        mgr.stop()


def test_400_is_permanent_per_prompt_failure(tmp_path):
    def dispatch(body):
        if len(body["prompt"][0]) > 2:
            return 400, {"error": "prompt too long"}, ()
        return fake_dispatch(body)

    mgr = mgr_of(tmp_path, dispatch)
    try:
        doc = mgr.submit({"prompts": [[1], [2, 3, 4, 5], [6]], "steps": 2})
        assert mgr.wait(doc["id"], timeout_s=60)
        st = mgr.status(doc["id"])
        assert st["state"] == "done" and st["done"] == 3
        assert st["failed"] == 1
        res = mgr.results(doc["id"])["results"]
        assert res[1] == {"index": 1, "error": "prompt too long"}
        assert "tokens" in res[0] and "tokens" in res[2]
    finally:
        mgr.stop()


def test_cancel_drops_queued_work_and_is_idempotent(tmp_path):
    """Cancel drops queued prompts at once, persists the terminal state
    (a restarted manager resumes nothing) and is idempotent."""
    gate = threading.Event()

    def dispatch(body):
        gate.wait(timeout=60)
        return fake_dispatch(body)

    mgr = mgr_of(tmp_path, dispatch, workers=1)
    try:
        doc = mgr.submit({"prompts": [[i + 1] for i in range(20)],
                          "steps": 1})
        assert mgr.cancel(doc["id"])["state"] == "cancelled"
        assert mgr.cancel(doc["id"])["state"] == "cancelled"
        gate.set()
        assert mgr.summary()["cancelled"] == 1
        assert mgr.summary()["prompts_pending"] == 0
    finally:
        gate.set()
        mgr.stop()
    calls = []
    mgr2 = JobManager(str(tmp_path / "jobs"),
                      lambda b: calls.append(b) or fake_dispatch(b),
                      workers=1, retry_s=0.01).start()
    try:
        assert mgr2.status(doc["id"])["state"] == "cancelled"
        assert mgr2.summary()["prompts_pending"] == 0
        assert calls == []
    finally:
        mgr2.stop()


def test_crash_resume_completes_missing_only_bitwise(tmp_path):
    """Manager 1 commits a prefix of a job and stops (the crash);
    manager 2 on the same store dispatches only the missing prompts and
    leaves the committed files' bytes as they were."""
    def first(body):
        if body["seed"] >= 3:
            return 429, {"error": "later"}, ()
        return fake_dispatch(body)

    mgr = mgr_of(tmp_path, first, workers=1)
    jid = mgr.submit({"prompts": [[i + 1] for i in range(6)],
                      "steps": 2})["id"]
    try:
        wait_for(lambda: mgr.status(jid)["done"] >= 3, 60, "three results")
    finally:
        mgr.stop()
    rdir = tmp_path / "jobs" / jid / "results"
    before = {p: (rdir / p).read_bytes() for p in result_files(tmp_path,
                                                               jid)}
    assert set(before) == {"000000.json", "000001.json", "000002.json"}
    resumed, lock = [], threading.Lock()

    def second(body):
        with lock:
            resumed.append(body["seed"])
        return fake_dispatch(body)

    mgr2 = JobManager(str(tmp_path / "jobs"), second, workers=2,
                      retry_s=0.01).start()
    try:
        assert mgr2.wait(jid, timeout_s=60)
        st = mgr2.status(jid)
        assert st["state"] == "done" and st["done"] == 6
        with lock:
            assert sorted(resumed) == [3, 4, 5]
        for p, blob in before.items():
            assert (rdir / p).read_bytes() == blob
        assert len(result_files(tmp_path, jid)) == 6
    finally:
        mgr2.stop()


# -- REST surface against a live replica -------------------------------------

def http(base, path, body=None, method=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        base + path, data=data, method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        with e:
            return e.code, json.loads(e.read())


def test_rest_job_api_end_to_end(lm, tmp_path, rng):
    """POST /jobs, GET /jobs/<id>, paged results, GET /jobs and DELETE
    over HTTP against an engine-backed replica; each prompt's tokens are
    the JAX ``generate()``'s greedy tokens (decoded on the batch
    class)."""
    jwf, jws, pwf, pws = lm
    prompts = [rng.integers(0, V, (n,)).tolist() for n in (4, 5, 3, 6)]
    refs = [np.asarray(jax_generate(jwf, jws, np.asarray([p], np.int32),
                                    4))[0] for p in prompts]
    eng = engine(pwf, pws).start()
    srv = RestfulServer(pwf.make_predict_step("out"), eng.wstate, 2, (6,),
                        port=0, workflow=pwf, engine=eng, device="cpu",
                        jobs_dir=str(tmp_path / "jobs")).start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        code, doc = http(base, "/jobs", {"prompts": prompts, "steps": 4})
        assert code == 200, doc
        jid = doc["id"]
        assert srv.jobs.wait(jid, timeout_s=120)
        code, st = http(base, f"/jobs/{jid}")
        assert code == 200 and st["state"] == "done"
        assert st["done"] == 4 and st["failed"] == 0
        code, p1 = http(base, f"/jobs/{jid}/results?limit=2")
        assert code == 200 and len(p1["results"]) == 2
        assert p1["next_offset"] == 2
        code, p2 = http(base, f"/jobs/{jid}/results?offset=2&limit=2")
        assert code == 200 and "next_offset" not in p2
        for i, r in enumerate(p1["results"] + p2["results"]):
            np.testing.assert_array_equal(np.asarray(r["tokens"]), refs[i])
        code, ls = http(base, "/jobs")
        assert code == 200 and len(ls["jobs"]) == 1
        assert http(base, "/jobs/nope")[0] == 404
        assert http(base, "/jobs", {"steps": 2})[0] == 400
        assert http(base, "/jobs", {"prompts": [[1]], "bogus": 1})[0] == 400
        code, d2 = http(base, "/jobs", {"prompts": [[1, 2]] * 3,
                                        "steps": 2})
        assert code == 200
        code, cd = http(base, f"/jobs/{d2['id']}", method="DELETE")
        assert code == 200 and cd["state"] in ("cancelled", "done")
        assert eng.stats()["batch"]["tokens_generated"] >= 16
    finally:
        srv.stop()
        eng.stop()


def test_handle_jobs_request_routing():
    """Non-/jobs paths fall through (None); a missing manager is a 404
    naming serve.jobs.dir."""
    assert handle_jobs_request(None, "GET", "/predict", None) is None
    code, doc = handle_jobs_request(None, "GET", "/jobs", None)
    assert code == 404 and "serve.jobs.dir" in doc["error"]


def test_rest_without_job_store_answers_404(lm):
    """A replica served without ``jobs_dir`` answers the job routes 404
    (the JAX server's answer), and DELETE on other paths too."""
    _, _, pwf, pws = lm
    eng = engine(pwf, pws).start()
    srv = RestfulServer(pwf.make_predict_step("out"), eng.wstate, 2, (6,),
                        port=0, workflow=pwf, engine=eng,
                        device="cpu").start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        code, doc = http(base, "/jobs", {"prompts": [[1]], "steps": 1})
        assert code == 404 and "serve.jobs.dir" in doc["error"]
        assert http(base, "/jobs")[0] == 404
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(
                base + "/generate", method="DELETE"), timeout=60)
        assert ei.value.code == 404
    finally:
        srv.stop()
        eng.stop()


# -- trough gate + batch-class engine behaviour ------------------------------

@pytest.fixture
def jobs_knobs():
    """Save and restore the trough-gate knobs."""
    jobs_cfg = root.common.serve.jobs
    prev = (jobs_cfg.get("min_headroom_slots", 1),
            jobs_cfg.get("burn_ceiling", 1.0))
    yield jobs_cfg
    jobs_cfg.min_headroom_slots, jobs_cfg.burn_ceiling = prev


def test_trough_gate_sheds_batch_submit(lm, jobs_knobs):
    """With the headroom floor above the slot count the trough is
    closed: a batch submit 429s with the reason and the short trough
    hint, while interactive work on the engine still runs; a burn over
    the ceiling closes it too."""
    _, _, pwf, pws = lm
    eng = engine(pwf, pws).start()
    try:
        jobs_knobs.min_headroom_slots = 99
        assert eng.trough_open() == (
            False, "headroom 2 slots < serve.jobs.min_headroom_slots 99")
        with pytest.raises(EngineOverloaded) as ei:
            eng.submit(np.asarray([1, 2, 3], np.int32), 2, batch=True)
        assert "batch trough closed" in str(ei.value)
        assert ei.value.retry_after_s == pytest.approx(0.05)
        assert eng.stats()["batch"]["trough_open"] is False
        out = eng.generate(np.asarray([[1, 2, 3]], np.int32), 2,
                           timeout=180)
        assert out.shape == (1, 5)
        jobs_knobs.min_headroom_slots = 1
        jobs_knobs.burn_ceiling = -1.0
        open_, why = eng.trough_open()
        assert not open_ and "burn" in why
    finally:
        eng.stop()


def test_rest_batch_trough_closed_is_429_with_short_hint(lm, jobs_knobs):
    """Over HTTP a closed trough answers 429 with the un-rounded short
    hint in the body (the job manager re-probes that soon)."""
    _, _, pwf, pws = lm
    eng = engine(pwf, pws).start()
    srv = RestfulServer(pwf.make_predict_step("out"), eng.wstate, 2, (6,),
                        port=0, workflow=pwf, engine=eng,
                        device="cpu").start()
    try:
        jobs_knobs.min_headroom_slots = 99
        code, doc = http(f"http://127.0.0.1:{srv.port}", "/generate",
                         {"prompt": [[1, 2, 3]], "steps": 2, "batch": True})
        assert code == 429 and doc["retry_after_s"] == pytest.approx(0.05)
        assert "trough" in doc["error"]
    finally:
        srv.stop()
        eng.stop()


def test_batch_excluded_from_slo_histograms(lm):
    """Batch decodes leave the queue-wait and TTFT histograms untouched
    and count in the batch accounting; an interactive decode observes
    both.  Batch tokens are the JAX ``generate()``'s."""
    jwf, jws, pwf, pws = lm
    reg = registry()
    eng = engine(pwf, pws).start()
    try:
        h_ttft = reg.get("vt_request_ttft_seconds")
        h_qw = reg.get("vt_request_queue_wait_seconds")
        t0 = h_ttft.aggregate_snapshot()[2]
        q0 = h_qw.aggregate_snapshot()[2]
        prompt = np.asarray([[3, 1, 4, 1, 5]], np.int32)
        ref = np.asarray(jax_generate(jwf, jws, prompt, 6))
        got = eng.generate(prompt, 6, timeout=180, batch=True)
        np.testing.assert_array_equal(got, ref)
        assert h_ttft.aggregate_snapshot()[2] == t0
        assert h_qw.aggregate_snapshot()[2] == q0
        assert eng.stats()["ttft_s_mean"] is None
        assert eng.stats()["batch"]["tokens_generated"] >= 6
        eng.generate(prompt, 2, timeout=180)
        assert h_ttft.aggregate_snapshot()[2] == t0 + 1
        assert h_qw.aggregate_snapshot()[2] == q0 + 1
    finally:
        eng.stop()


def test_interactive_preempts_batch_first_bitwise(lm, rng):
    """A class-0 arrival on a full engine preempts the running batch
    request even with a lower interactive class running too; the batch
    request resumes bitwise its uninterrupted run, and the batch
    preemption counters tick."""
    _, _, pwf, pws = lm
    bat_prompt = rng.integers(0, V, 5).astype(np.int32)
    low_prompt = rng.integers(0, V, 6).astype(np.int32)
    hi_prompt = rng.integers(0, V, 4).astype(np.int32)
    bat_ref = generate(pwf, pws, bat_prompt[None], 40)[0].numpy()
    c_pre = registry().get("vt_batch_preemptions_total")
    n0 = c_pre.value
    eng = engine(pwf, pws, preempt=True)
    gate = threading.Event()
    step = eng._step_once
    eng._step_once = lambda: (gate.wait(120), step())
    eng.start()
    try:
        victim = eng.submit(bat_prompt, 40, batch=True)
        low = eng.submit(low_prompt, 40, priority=2)
        wait_for(lambda: eng.stats()["occupancy"] == 2, 60, "both slots")
        high = eng.submit(hi_prompt, 3, priority=0)
        gate.set()
        for r in (high, low, victim):
            assert r.done.wait(180) and r.error is None, r.error
        np.testing.assert_array_equal(victim.result, bat_ref)
        assert victim.preemptions >= 1 and low.preemptions == 0
        assert high.finished_at < victim.finished_at
        assert eng.stats()["batch"]["preemptions"] >= 1
        assert c_pre.value >= n0 + 1
    finally:
        gate.set()
        eng.stop()


def test_queued_batch_waits_while_trough_closed(lm, jobs_knobs):
    """Batch that queued while the trough was open is held at admission
    once the gate closes, and admitted when it reopens (the re-check at
    admission)."""
    _, _, pwf, pws = lm
    eng = engine(pwf, pws)
    gate = threading.Event()
    admit = eng._admit
    eng._admit = lambda: (gate.wait(120), admit())[1]
    eng.start()
    try:
        r = eng.submit(np.asarray([1, 2, 3], np.int32), 3, batch=True)
        jobs_knobs.min_headroom_slots = 99
        gate.set()
        time.sleep(0.2)         # scheduler iterations with the gate shut
        assert not r.done.is_set() and r.admitted_at is None
        jobs_knobs.min_headroom_slots = 1
        assert r.done.wait(120) and r.error is None
    finally:
        gate.set()
        eng.stop()


def test_batch_refusals(lm):
    """The REST layer's batch refusals, the JAX package's: with a
    priority class, streamed, with beams, and without an engine."""
    _, _, pwf, pws = lm
    eng = engine(pwf, pws).start()
    srv = RestfulServer(pwf.make_predict_step("out"), eng.wstate, 2, (6,),
                        port=0, workflow=pwf, engine=eng,
                        device="cpu").start()
    bare = RestfulServer(pwf.make_predict_step("out"), pws, 2, (6,),
                         port=0, workflow=pwf, device="cpu").start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        body = {"prompt": [[1, 2, 3]], "steps": 2, "batch": True}
        for extra, needle in (({"priority": 1}, "priority"),
                              ({"beams": 2}, "beam"),
                              ({"stream": True}, "unary")):
            code, doc = http(base, "/generate", dict(body, **extra))
            assert code == 400 and needle in doc["error"], doc
        code, doc = http(f"http://127.0.0.1:{bare.port}", "/generate", body)
        assert code == 400 and "engine" in doc["error"]
        assert http(base, "/generate", body)[0] == 200
    finally:
        srv.stop()
        bare.stop()
        eng.stop()
