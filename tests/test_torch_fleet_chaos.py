"""The fleet's chaos rehearsals on the port (tests/test_chaos.py:188,
:309, :460 and :593), on the CPU: a replica killed mid-burst under the
``replica_crash_at_request`` fault (unary requests resubmitted whole,
zero class-0 failures; streams resumed from their last delivered token,
bitwise and gapless, with a healthy leg cut by ``stream_cut_at_token``
too), a batch job whose replica dies mid-job (exactly one result file a
prompt, every result the uninterrupted run's bytes), and KV-page
transfers that all fail while their holder drains (every request served
by local prefill, the same tokens).

The tests hold outcomes, not timings: every wait has a deadline, and
every server, router and replica a test starts is stopped in its
``finally``."""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.runtime.generate import generate as jax_generate  # noqa: E402
from veles_tpu_torch.config import root  # noqa: E402
from veles_tpu_torch.runtime import faults  # noqa: E402
from veles_tpu_torch.runtime.deploy import DeployController  # noqa: E402
from veles_tpu_torch.runtime.engine import DecodeEngine  # noqa: E402
from veles_tpu_torch.runtime.fleet import (DRAINING, EJECTED,  # noqa: E402
                                           FleetRouter, FleetServer,
                                           InProcessReplica)
from veles_tpu_torch.runtime.generate import generate  # noqa: E402
from veles_tpu_torch.runtime.restful import RestfulServer  # noqa: E402

from _torch_helpers import build_pair, wait_for  # noqa: E402

pytestmark = [pytest.mark.fleet, pytest.mark.faults]

torch.set_num_threads(2)

V = 12

#: tests/test_chaos.py's fleet LM
LAYERS = [
    {"type": "embedding", "vocab": V, "dim": 16, "name": "emb"},
    {"type": "attention", "n_heads": 2, "rope": True,
     "residual": True, "name": "a1"},
    {"type": "seq_last", "name": "last"},
    {"type": "softmax", "output_size": V, "name": "out"},
]


@pytest.fixture(scope="module")
def lm():
    return build_pair(LAYERS, B=2, T=6, seed=3)


class Fleet:
    """Three in-process replicas behind a started ``FleetServer``, the
    scrape interval short; ``close()`` stops everything and restores
    the knobs."""

    def __init__(self, pwf, pws, n=3, jobs_dir=None):
        def factory():
            own = dict(pws, params={u: {k: t.clone() for k, t in p.items()}
                                    for u, p in pws["params"].items()})
            eng = DecodeEngine(pwf, own, slots=2, l_max=64, window_ms=0.0,
                               device="cpu").start()
            srv = RestfulServer(pwf.make_predict_step("out"), eng.wstate,
                                2, (6,), port=0, workflow=pwf, engine=eng,
                                device="cpu")
            DeployController(server=srv)
            return srv.start()

        fleet = root.common.serve.fleet
        self._prev_scrape = fleet.get("scrape_interval_s", 0.5)
        fleet.scrape_interval_s = 0.05
        self.replicas = []
        self.fsrv = None
        try:
            self.replicas = [InProcessReplica(factory) for _ in range(n)]
            self.router = FleetRouter()
            for rep in self.replicas:
                self.router.add_replica(url=rep.url,
                                        registry_key="in-process",
                                        restart=rep.restart, kill=rep.kill)
            self.fsrv = FleetServer(self.router, port=0,
                                    jobs_dir=jobs_dir).start()
        except BaseException:
            self.close()
            raise
        self.base = f"http://127.0.0.1:{self.fsrv.port}"

    def doc(self):
        with urllib.request.urlopen(self.base + "/fleet.json",
                                    timeout=60) as r:
            return json.loads(r.read())

    def ejected(self):
        return [r["state"] for r in self.doc()["replicas"]].count(EJECTED)

    def close(self):
        faults.reset()
        root.common.serve.fleet.scrape_interval_s = self._prev_scrape
        if self.fsrv is not None:
            self.fsrv.stop()
        for rep in self.replicas:
            rep.stop()


def post_json(base, body):
    """POST /generate -> (status, body or error text); a transport
    failure is a dropped request, returned so an assertion names it."""
    req = urllib.request.Request(
        base + "/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.read().decode()
    except Exception as e:  # noqa: BLE001
        return repr(e), None


def run_workers(fn, args_list):
    out, lock = [], threading.Lock()

    def worker(args):
        for res in fn(*args):
            with lock:
                out.append(res)

    threads = [threading.Thread(target=worker, args=(a,)) for a in args_list]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads)
    return out


def test_fleet_survives_replica_kill_mid_burst(lm):
    """Three replicas under a concurrent mixed-class burst through the
    router's HTTP front; the 8th routed request kills the replica chosen
    for it (with the slow-replica knob skewing the load).  The victim is
    ejected, the interrupted work resubmitted, and every class-0 request
    completes: zero failures."""
    _, _, pwf, pws = lm
    fleet = Fleet(pwf, pws)
    try:
        faults.configure(replica_crash_at_request=8, replica_slow_ms=20.0)

        def burst(priority):
            for _ in range(6):
                yield priority, post_json(fleet.base, {
                    "prompt": [[1, 2, 3, 4]], "steps": 3,
                    "priority": priority})[0]

        res = run_workers(burst, [(0,), (0,), (0,), (2,), (2,), (2,)])
        hi = [s for p, s in res if p == 0]
        lo = [s for p, s in res if p == 2]
        assert hi == [200] * 18, hi
        assert all(s in (200, 429) for s in lo), lo
        wait_for(lambda: fleet.ejected() == 1, 60, "the victim's ejection")
        fd = fleet.doc()
        assert sum(r["dispatched"] for r in fd["replicas"]) >= 37, fd
        assert fleet.router._m_resubmissions.value >= 1
    finally:
        fleet.close()


@pytest.mark.streaming
def test_streams_survive_replica_kill_mid_burst(lm):
    """A concurrent class-0 streaming burst with a replica killed
    mid-burst and one healthy leg cut after its 3rd frame: every stream
    completes gapless and duplicate-free, bitwise the undisturbed run
    (greedy and sampled), and the resume path is counted."""
    _, _, pwf, pws = lm
    prompt = (np.arange(8) % V).astype(np.int32)
    N = 8
    refs = {False: generate(pwf, pws, prompt[None], N)[0, 8:].tolist(),
            True: generate(pwf, pws, prompt[None], N, temperature=1.3,
                           top_k=5, seed=11)[0, 8:].tolist()}
    fleet = Fleet(pwf, pws)

    def consume(sampled):
        body = {"prompt": prompt.tolist(), "steps": N, "stream": True}
        if sampled:
            body.update(temperature=1.3, top_k=5, seed=11)
        req = urllib.request.Request(
            fleet.base + "/generate", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                frames = [json.loads(line) for line in r if line.strip()]
        except Exception as e:  # noqa: BLE001 — a dropped stream
            return repr(e)
        body_frames = [f for f in frames if not f.get("done")]
        if [f["i"] for f in body_frames] != list(range(N)):
            return f"gap/duplicate frames: {[f['i'] for f in body_frames]}"
        toks = [f["token"] for f in body_frames]
        if toks != refs[sampled]:
            return f"token divergence: {toks} != {refs[sampled]}"
        if frames[-1].get("finish_reason") != "length":
            return f"bad terminal: {frames[-1]}"
        return "ok"

    try:
        resumes0 = fleet.router._m_stream_resumes.value
        resubs0 = fleet.router._m_resubmissions.value
        faults.configure(replica_crash_at_request=8, stream_cut_at_token=3)
        res = run_workers(lambda s: (consume(s) for _ in range(3)),
                          [(False,), (False,), (False,), (True,), (True,),
                           (True,)])
        assert res == ["ok"] * 18, res
        assert fleet.router._m_stream_resumes.value >= resumes0 + 1
        assert fleet.router._m_resubmissions.value >= resubs0 + 1
        wait_for(lambda: fleet.ejected() == 1, 60, "the victim's ejection")
    finally:
        fleet.close()


@pytest.mark.jobs
def test_batch_job_survives_replica_kill_mid_job(lm, tmp_path):
    """A bulk job mid-flight across three replicas when the 5th routed
    dispatch kills its replica: the job completes on the survivors with
    exactly one committed result file a prompt, every sampled result the
    uninterrupted run's (the per-prompt seed makes each a pure function
    of the job spec), and /fleet.json carries the job summary."""
    _, _, pwf, pws = lm
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, V, (n,)).tolist()
               for n in (4, 5, 3, 6, 4, 5, 4, 3, 5, 4)]
    STEPS, SEED, TEMP, TOPK = 4, 77, 1.3, 5
    refs = [generate(pwf, pws, np.asarray([p], np.int32), STEPS,
                     temperature=TEMP, top_k=TOPK, seed=SEED + i)[0].numpy()
            for i, p in enumerate(prompts)]
    fleet = Fleet(pwf, pws, jobs_dir=str(tmp_path / "jobs"))
    try:
        faults.configure(replica_crash_at_request=5, replica_slow_ms=10.0)
        req = urllib.request.Request(
            fleet.base + "/jobs",
            data=json.dumps({"prompts": prompts, "steps": STEPS,
                             "temperature": TEMP, "top_k": TOPK,
                             "seed": SEED}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            jid = json.loads(r.read())["id"]
        jobs = fleet.fsrv.jobs
        assert jobs.wait(jid, timeout_s=240), jobs.status(jid)
        st = jobs.status(jid)
        assert st["state"] == "done" and st["done"] == len(prompts), st
        assert st["failed"] == 0, st
        files = sorted(os.listdir(tmp_path / "jobs" / jid / "results"))
        assert files == [f"{i:06d}.json" for i in range(len(prompts))]
        with urllib.request.urlopen(
                fleet.base + f"/jobs/{jid}/results?limit=64",
                timeout=60) as r:
            docs = json.loads(r.read())["results"]
        assert [d["index"] for d in docs] == list(range(len(prompts)))
        for d in docs:
            np.testing.assert_array_equal(np.asarray(d["tokens"], np.int32),
                                          refs[d["index"]])
        wait_for(lambda: fleet.ejected() == 1, 60, "the victim's ejection")
        wait_for(lambda: fleet.doc()["jobs"]["prompts_inflight"] == 0, 60,
                 "the job ledger to empty")
        assert fleet.doc()["jobs"]["by_state"] == {"done": 1}
    finally:
        fleet.close()


@pytest.mark.disagg
def test_kv_transfer_fails_mid_fetch_requests_survive(lm):
    """The affinity holder drains and every page fetch from it fails
    (``kv_transfer_drop``, with the slow knob): a concurrent class-0
    same-prefix burst completes with zero failures through local
    prefill, the same tokens throughout (the JAX package's), nothing
    imported anywhere and no transfer completed."""
    jwf, jws, pwf, pws = lm
    prompt = [[(i * 5 + 3) % V for i in range(48)]]     # 3 full pages
    ref = np.asarray(jax_generate(jwf, jws, np.asarray(prompt, np.int32),
                                  3)).tolist()
    fleet = Fleet(pwf, pws)
    try:
        st, doc = post_json(fleet.base, {"prompt": prompt, "steps": 3})
        assert st == 200 and doc["tokens"] == ref, doc
        router = fleet.router
        with router._lock:
            holder_id = router._affinity[next(iter(router._affinity))]
            next(r for r in router._replicas
                 if r.id == holder_id).state = DRAINING
        faults.configure(kv_transfer_drop=100, kv_transfer_slow_ms=10.0)

        def burst():
            for _ in range(4):
                st, doc = post_json(fleet.base, {"prompt": prompt,
                                                 "steps": 3,
                                                 "priority": 0})
                yield st, (doc or {}).get("tokens") \
                    if isinstance(doc, dict) else doc

        res = run_workers(burst, [()] * 4)
        assert [s for s, _ in res] == [200] * 16, res
        assert all(t == ref for _, t in res), res
        fd = router.fleet_doc()
        assert fd["kv_transfer"]["transfers"] == 0, fd["kv_transfer"]
        for rep in fd["replicas"]:
            with urllib.request.urlopen(rep["url"] + "/engine",
                                        timeout=60) as r:
                kvt = json.loads(r.read())["kv_transfer"]
            assert kvt["imported_pages"] == 0, (rep["id"], kvt)
    finally:
        fleet.close()
