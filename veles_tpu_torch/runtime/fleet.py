"""Fleet router: multi-replica serving with load- and prefix-affinity
dispatch, coordinated hot swap, rolling drain, failover and
disaggregated prefill (a copy of veles_tpu/runtime/fleet.py, which
holds no JAX, rewired to the port's modules).

A lightweight **router** fronts N replica workers, each the port's
single-process serving stack (:class:`~.engine.DecodeEngine` behind
:class:`~.restful.RestfulServer` with a :class:`~.deploy.
DeployController` attached), built in-process (:class:`InProcessReplica`,
``--serve PORT --fleet N``; on the card every replica is its own
captured engine on the one device), booted from a sealed compiled
artifact (``--serve PORT --artifact DIR --fleet N``: each replica an
:class:`~.artifact.ArtifactRunner` over the artifact's programs, and the
rolling drain reboots each from the same artifact), or as independent
processes that ``--join ROUTER_URL`` themselves in.  Everything the router does
composes per-replica primitives that already exist — drain, two-phase
swap staging, ``/ready``, the burn-rate SLO, ``/metrics``, ``/kv/pages``
— into the fleet-level behaviours horizontal scale needs:

* **dispatch** by scraped replica load (queue depth, occupancy, the
  admission window from ``/engine``) *composed with* **prefix-cache
  affinity**: the router computes the same chained-sha256 page hashes
  as the engine's prefix index (:func:`~.engine.prefix_page_hashes`,
  one function) over the prompt head and routes same-system-prompt
  sessions to the replica already holding those pages, falling back to
  a hash ring for cold prefixes so a new prefix converges on one
  replica.  Routing has **hysteresis**: the incumbent keeps a stream
  until a rival's load score beats it by a margin, and the router's own
  live outstanding counts sharpen the stale scrape numbers;
* **coordinated hot swap**: stage the new version on every replica
  (``POST /admin/stage``), flip only after all staged, roll back
  everywhere when any flip fails (committed replicas reload their
  previous registry version, uncommitted stagings abort): the fleet
  serves the new version everywhere or the old one everywhere;
* **rolling drain**: drain one replica (no new routing, its in-flight
  work retires), restart it through its restart handle (``--join``ed
  replicas are drained for their external supervisor), readmit it on
  ``/ready``, go on to the next; the victim's hottest prefix pages are
  first pushed to a successor and their affinity repointed;
* **graceful degradation**: health scrapes, ejection after consecutive
  transport failures with resubmission of the failed unary dispatch to
  a survivor, streams resumed from their last delivered token
  (:meth:`FleetRouter.handle_generate_stream`), a replica's 429 honoured
  as router-level backpressure for its Retry-After window (class 0 is
  instead routed to the least-burned replica), readmission when an
  ejected replica answers ``/ready`` again;
* **disaggregated prefill and fleet-wide prefix sharing**: VTKV1 page
  transfers between replicas (``GET``/``PUT /kv/pages``) place a
  request's prefix pages before it is dispatched — a fetch from the
  affinity holder when the routed replica is cold (gated by a measured
  payoff: wire bytes over the link bandwidth EWMA against the replica's
  prefill rate), or the ``prefill`` role's leg (that replica prefills,
  its pages ship to the decode target).  Every transfer failure falls
  back to local prefill;
* **aggregated observability**: the ``vt_fleet_*`` metrics, a merged
  ``/slo.json`` whose windowed quantiles sum the replicas' scraped
  cumulative buckets through the ``aggregate_snapshot`` interface the
  process :class:`~.metrics.HistogramWindow` reads, and ``GET
  /fleet.json``.

In-process replicas share this process's metrics registry, so the SLO
merge groups replicas by ``registry_key`` and counts each process's
histograms once.  The experiment manager's hook (``/experiments*``,
``/fleet.json``'s ``experiments``) comes with a later slice.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..config import root
from ..logger import Logger
from . import faults
from .deploy import BACKOFF_FACTOR, BACKOFF_JITTER, HTTP_RETRY_BASE_S
from .engine import prefix_page_hashes
from .fleet_client import ReplicaClient, ReplicaUnavailable
from .metrics import (cumulative_buckets, fraction_over, HistogramWindow,
                      parse_samples, quantile_from_cumulative, registry)

#: replica lifecycle states as the router tracks them
ACTIVE = "active"
DRAINING = "draining"
EJECTED = "ejected"

#: score penalty for a replica that answers but is not /ready
#: (draining, SLO-degraded): routable as a last resort, never preferred
_NOT_READY_PENALTY = 100.0


class Replica:
    """One replica serving stack as the router sees it.  All mutable
    fields are owned by the router and mutated only under its lock;
    the ``client`` is used outside it (HTTP never runs under the
    routing lock)."""

    def __init__(self, rid: str, client: ReplicaClient, *,
                 registry_key: Optional[str] = None,
                 restart: Optional[Callable[[], str]] = None,
                 kill: Optional[Callable[[], None]] = None,
                 role: str = "mixed"):
        self.id = rid
        self.client = client
        #: capacity class: "mixed" serves everything; "prefill"
        #: replicas absorb prefill work and ship pages, never taking
        #: normal dispatch while a non-prefill replica is up; "decode"
        #: replicas receive shipped pages
        self.role = role
        #: replicas sharing a metrics registry (in-process fleets)
        #: share a key; the SLO merge counts each key once
        self.registry_key = registry_key or client.base_url
        #: () -> new base url: rebuild this replica in place (rolling
        #: drain); None for --join'ed replicas an external supervisor
        #: restarts
        self.restart = restart
        #: () -> None: hard-stop (the fault harness's crash handle)
        self.kill = kill
        self.state = ACTIVE
        self.ready = False
        self.active_version = None  # scraped /models active id
        self.fails = 0
        self.backoff_until = 0.0    # 429 Retry-After honor window
        self.outstanding = 0        # router-tracked in-flight dispatches
        self.dispatched = 0
        self.load: dict = {}        # last scraped /engine stats
        self.metrics_text = ""      # last scraped /metrics (group leader)
        self.last_scrape = 0.0
        self.last_error: Optional[str] = None

    def doc(self) -> dict:
        """JSON-able snapshot for ``/fleet.json`` (caller holds the
        router lock)."""
        st = self.load or {}
        return {
            "id": self.id, "url": self.client.base_url,
            "role": self.role,
            "state": self.state, "ready": self.ready,
            "outstanding": self.outstanding,
            "dispatched": self.dispatched,
            "fails": self.fails,
            "backoff_remaining_s": round(
                max(0.0, self.backoff_until - time.monotonic()), 3),
            "restartable": self.restart is not None,
            "load": {k: st.get(k) for k in
                     ("slots", "occupancy", "queue_depth",
                      "tokens_per_sec")
                     if k in st},
            "last_error": self.last_error,
        }


class _FleetHistogram:
    """A ``Histogram``-shaped view (``buckets`` +
    ``aggregate_snapshot()``) summing one series across the fleet's
    scraped ``/metrics`` texts, one text per registry group — exactly
    the interface :class:`~.metrics.HistogramWindow` consumes, so the
    fleet's rolling SLO windows reuse the process machinery unchanged.
    Returns per-bucket counts (incl. +Inf), sum and count, like
    ``Histogram.aggregate_snapshot``.

    Cross-process replicas restart (rolling drain!) and come back with
    zeroed cumulative buckets; feeding the raw sum to the window would
    drive its delta NEGATIVE against the pre-restart baseline and the
    merged quantiles/burn would read 0 exactly when an operator needs
    them.  So per-group **counter-reset correction** applies: when a
    group's cumulative count decreases, the last-seen values fold into
    that group's standing offset — the aggregate stays monotonic, the
    standard Prometheus reset treatment."""

    def __init__(self, router: "FleetRouter", name: str):
        self._router = router
        self.name = name
        self._buckets: Tuple[float, ...] = ()
        self._lock = threading.Lock()
        #: group key -> [offset (buckets dict, sum, count),
        #:               last raw (buckets dict, sum, count)]
        self._groups: Dict[str, list] = {}  # guarded-by: self._lock

    @property
    def buckets(self) -> Tuple[float, ...]:
        return self._buckets

    @staticmethod
    def _add(into: Dict[float, float], frm: Dict[float, float]):
        for le, c in frm.items():
            into[le] = into.get(le, 0.0) + c

    def aggregate_snapshot(self):
        agg: Dict[float, float] = {}
        total, count = 0.0, 0
        for key, samples in self._router._group_samples():
            raw_b = dict(cumulative_buckets(samples, self.name))
            raw_s, raw_c = 0.0, 0
            for n, _labels, v in samples:
                if n == self.name + "_sum":
                    raw_s += v
                elif n == self.name + "_count":
                    raw_c += int(v)
            with self._lock:
                off, last = self._groups.setdefault(
                    key, [({}, 0.0, 0), ({}, 0.0, 0)])
                if raw_c < last[2]:
                    # the group's process restarted: its history is
                    # gone from the scrape but not from the window —
                    # fold the last sight of it into the offset
                    off_b = dict(off[0])
                    self._add(off_b, last[0])
                    off = (off_b, off[1] + last[1], off[2] + last[2])
                self._groups[key] = [off, (raw_b, raw_s, raw_c)]
                self._add(agg, off[0])
                total += off[1]
                count += off[2]
            self._add(agg, raw_b)
            total += raw_s
            count += raw_c
        if not agg:
            return [0], 0.0, 0
        pairs = sorted(agg.items())
        uppers = tuple(le for le, _c in pairs if le != float("inf"))
        self._buckets = uppers
        counts, prev = [], 0.0
        for _le, c in pairs:
            counts.append(int(c - prev))
            prev = c
        if len(counts) == len(uppers):     # no +Inf sample scraped
            counts.append(0)
        return counts, total, count

    def snapshot_or_none(self):
        """None until any replica scraped a ``/metrics`` text — the
        ``HistogramWindow`` late-binding contract (a cheap existence
        check; the window calls ``aggregate_snapshot`` itself)."""
        return self if self._router._has_group_texts() else None


class FleetRouter(Logger):
    """The router over N :class:`Replica` handles.  Thread model: one
    daemon scrape thread (health + load + metrics text), dispatch on
    the HTTP server's worker threads, swaps/drains serialized on an
    operations mutex.  ``self._lock`` guards the topology and every
    replica's mutable fields; no network IO ever runs under it."""

    def __init__(self, *, scrape_interval_s: Optional[float] = None,
                 hysteresis: Optional[float] = None,
                 affinity_pages: Optional[int] = None,
                 affinity_max: Optional[int] = None,
                 eject_failures: Optional[int] = None,
                 page_size: Optional[int] = None):
        fleet = root.common.serve.fleet
        serve = root.common.serve
        self.scrape_interval_s = float(
            fleet.get("scrape_interval_s", 0.5)
            if scrape_interval_s is None else scrape_interval_s)
        self.hysteresis = float(fleet.get("hysteresis", 0.5)
                                if hysteresis is None else hysteresis)
        self.affinity_pages = int(fleet.get("affinity_pages", 4)
                                  if affinity_pages is None
                                  else affinity_pages)
        self.affinity_max = int(fleet.get("affinity_max", 4096)
                                if affinity_max is None else affinity_max)
        self.eject_failures = max(1, int(
            fleet.get("eject_failures", 2)
            if eject_failures is None else eject_failures))
        self.drain_poll_s = float(fleet.get("drain_poll_s", 0.05))
        self.restart_timeout_s = float(
            fleet.get("restart_timeout_s", 120.0))
        self.drain_timeout_s = float(serve.get("drain_timeout_s", 30.0))
        # a dispatched /generate may legitimately run for the whole
        # per-request deadline — classifying a slow-but-healthy
        # request as a transport failure would duplicate it AND eject
        # a healthy replica, so the dispatch timeout must dominate the
        # replica-side deadline (plus slack for the answer itself)
        self.dispatch_timeout_s = float(
            serve.get("deadline_s", 120.0)) + 30.0
        # the prompt-head page geometry must match the replicas' prefix
        # index (engine.prefix_page_hashes) or affinity keys never hit
        self.page_size = int(serve.get("page_size", 16)
                             if page_size is None else page_size)
        # KV-page transfer policy: fetch-vs-reprefill is a measured payoff
        # call, never a correctness one — every transfer failure falls
        # back to local prefill
        kvt = root.common.serve.kv_transfer
        self.kv_transfer_enabled = bool(kvt.get("enabled", True))
        self.kv_min_pages = int(kvt.get("min_pages", 2))
        self.kv_timeout_s = float(kvt.get("timeout_s", 5.0))
        self.prewarm_pages = int(kvt.get("prewarm_pages", 64))
        # streaming failover policy: how many mid-stream resubmissions one
        # request may spend, and the capped exponential backoff between
        # them — together they bound a failover storm
        stream_cfg = root.common.serve.stream
        self.stream_retry_budget = int(
            stream_cfg.get("retry_budget", 3))
        self.stream_backoff_s = float(stream_cfg.get("backoff_s", 0.05))
        self.stream_backoff_max_s = float(
            stream_cfg.get("backoff_max_s", 2.0))
        # router-side default for a streaming request naming no
        # deadline_s of its own: the same per-request deadline the
        # replicas enforce (the router's failover loop must terminate
        # within it)
        self.stream_deadline_s = float(serve.get("deadline_s", 120.0))
        #: replicas added without an explicit role class
        self.default_role = str(fleet.get("role", "mixed"))

        self._lock = threading.Lock()
        self._replicas: List[Replica] = []  # guarded-by: self._lock
        self._samples_cache: Dict[str, tuple] = {}  # guarded-by: self._lock
        self._affinity: "dict" = {}  # prefix hash -> replica id (LRU)  # guarded-by: self._lock
        self._pending: Dict[str, set] = {}  # replica id -> dispatch seqs  # guarded-by: self._lock
        self._dispatch_seq = 0  # guarded-by: self._lock
        self._route_count = 0  # guarded-by: self._lock
        self._last_pick: Optional[str] = None  # guarded-by: self._lock
        self._affinity_hits = 0  # guarded-by: self._lock
        self._affinity_requests = 0  # guarded-by: self._lock
        # KV-transfer payoff inputs: link bandwidth EWMA over measured
        # transfers (the spec-decode _spec_worthwhile idiom — the first
        # few transfers are optimistic probes that seed the estimate)
        self._kv_bw_ewma = 0.0  # bytes/s  # guarded-by: self._lock
        self._kv_transfers = 0  # guarded-by: self._lock
        self._kv_drops = 0  # fault-plan drop budget used  # guarded-by: self._lock
        self._draining = False
        self._stop_evt = threading.Event()
        self._scrape_thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        # swap / rolling-drain serialization: an operations mutex held
        # across replica HTTP calls BY DESIGN (the short-critical-section
        # rule is for data locks; this one's contract is "one fleet
        # operation at a time")
        self._ops_mutex = threading.Lock()
        self._last_swap: dict = {"swapped": None}
        self._last_drain: dict = {"completed": None}
        self._drain_thread: Optional[threading.Thread] = None
        # batch lane: the fleet-level job manager, attached by FleetServer when serve.jobs.dir (or
        # its jobs_dir arg) names a store — fleet_doc merges its
        # summary so /fleet.json shows the bulk backlog next to the
        # interactive topology
        self.jobs = None

        # the fleet metric family
        reg = registry()
        self._g_replicas = reg.gauge(
            "vt_fleet_replicas",
            "replicas known to the fleet router, by lifecycle state",
            labels=("state",))
        self._m_requests = reg.counter(
            "vt_fleet_requests_total",
            "requests the router dispatched, by replica",
            labels=("replica",))
        self._g_outstanding = reg.gauge(
            "vt_fleet_outstanding",
            "router-tracked in-flight dispatches, by replica",
            labels=("replica",))
        self._m_resubmissions = reg.counter(
            "vt_fleet_resubmissions_total",
            "dispatches resubmitted to a survivor after a replica "
            "failed mid-request (transport error or scheduler crash)")
        self._m_ejections = reg.counter(
            "vt_fleet_ejections_total",
            "replicas ejected after consecutive health/dispatch "
            "failures")
        self._m_readmissions = reg.counter(
            "vt_fleet_readmissions_total",
            "ejected replicas readmitted after answering /ready again")
        self._m_affinity_requests = reg.counter(
            "vt_fleet_affinity_requests_total",
            "dispatched requests long enough to carry prefix-affinity "
            "hashes (>= one full page of prompt head)")
        self._m_affinity_hits = reg.counter(
            "vt_fleet_affinity_hits_total",
            "affinity-eligible requests routed to the replica already "
            "holding their prefix pages")
        self._g_affinity_hit_rate = reg.gauge(
            "vt_fleet_affinity_hit_rate",
            "affinity hits over affinity-eligible requests since "
            "router start")
        self._m_backpressure = reg.counter(
            "vt_fleet_backpressure_total",
            "replica 429s honored as router-level backpressure "
            "(the replica enters its hinted Retry-After window)")
        self._m_swaps = reg.counter(
            "vt_fleet_swaps_total",
            "coordinated fleet-wide hot swaps committed on every "
            "replica")
        self._m_swap_rollbacks = reg.counter(
            "vt_fleet_swap_rollbacks_total",
            "coordinated swaps rolled back fleet-wide after a stage "
            "or flip failure (the old version kept serving everywhere)")
        self._m_rolling_drains = reg.counter(
            "vt_fleet_rolling_drains_total",
            "completed rolling-drain cycles (every replica drained, "
            "restarted and readmitted in turn)")
        self._m_kv_fetches = reg.counter(
            "vt_fleet_kv_fetches_total",
            "router-initiated KV-page transfers between replicas, by "
            "outcome (ok / skipped by payoff / failed / rejected / "
            "disagg / prewarm)",
            labels=("outcome",))
        # streaming failover
        self._m_stream_resumes = reg.counter(
            "vt_stream_resumes_total",
            "mid-stream failovers: an interrupted stream resubmitted "
            "to a survivor from its last delivered token (subset of "
            "vt_fleet_resubmissions_total)")
        self._m_stream_splice = reg.histogram(
            "vt_stream_splice_seconds",
            "gap a mid-stream failover added: from the interruption "
            "to the resumed replica accepting the suffix dispatch")
        self._m_stream_retry_exhausted = reg.counter(
            "vt_stream_retry_exhausted_total",
            "streams terminated with an error frame after the "
            "per-request resume retry budget ran out "
            "(serve.stream.retry_budget)")
        self._g_kv_payoff = reg.gauge(
            "vt_fleet_kv_fetch_payoff",
            "last fetch-vs-reprefill payoff estimate (estimated local "
            "prefill seconds over estimated transfer seconds; >= 1 "
            "means fetching beats recomputing; 0 while probing cold)")

        # fleet-merged rolling SLO windows over the scraped histograms
        # (the same HistogramWindow machinery /slo.json uses per
        # process — _FleetHistogram implements the aggregate_snapshot
        # interface over the per-group scrape texts)
        slo = root.common.observe.slo
        self._slo_window_s = float(slo.get("window_s", 60.0))
        self._slo_slices = int(slo.get("slices", 12))
        self._slo_burn_threshold = float(slo.get("burn_threshold", 2.0))
        self._slo_targets_ms = {
            "ttft": float(slo.get("ttft_p99_ms", 0.0) or 0.0),
            "queue_wait": float(slo.get("queue_wait_p99_ms", 0.0)
                                or 0.0),
        }
        self._fleet_hists = {
            "ttft": _FleetHistogram(self, "vt_request_ttft_seconds"),
            "queue_wait": _FleetHistogram(
                self, "vt_request_queue_wait_seconds"),
        }
        self._slo_windows = {
            key: HistogramWindow(hist.snapshot_or_none,
                                 self._slo_window_s, self._slo_slices)
            for key, hist in self._fleet_hists.items()}

    # -- topology ------------------------------------------------------------
    def add_replica(self, url: Optional[str] = None, *,
                    client: Optional[ReplicaClient] = None,
                    registry_key: Optional[str] = None,
                    restart: Optional[Callable[[], str]] = None,
                    kill: Optional[Callable[[], None]] = None,
                    role: Optional[str] = None) -> Replica:
        """Register one replica (by base URL or a prebuilt client).
        New replicas start ACTIVE but un-``ready``; the next scrape (or
        first dispatch) fills in their health.  ``role`` assigns the
        capacity class (mixed | prefill | decode —
        ``serve.fleet.role`` when omitted)."""
        if client is None:
            if not url:
                raise ValueError("add_replica needs a url or a client")
            client = ReplicaClient(url)
        role = self.default_role if role is None else str(role)
        if role not in ("mixed", "prefill", "decode"):
            raise ValueError(
                f"fleet role must be mixed | prefill | decode, "
                f"got {role!r}")
        with self._lock:
            rid = f"r{len(self._replicas)}"
            rep = Replica(rid, client, registry_key=registry_key,
                          restart=restart, kill=kill, role=role)
            self._replicas.append(rep)
        self.info("fleet: replica %s joined at %s (role %s)", rep.id,
                  client.base_url, role)
        return rep

    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas)

    def _by_state(self, state: str) -> List[Replica]:
        with self._lock:
            return [r for r in self._replicas if r.state == state]

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FleetRouter":
        if self._scrape_thread is not None \
                and self._scrape_thread.is_alive():
            return self
        self._stop_evt.clear()
        # prime health/load before the first dispatch so a router that
        # starts under traffic doesn't route blind for a full interval
        self._scrape_once()
        self._scrape_thread = threading.Thread(
            target=self._scrape_loop, name="fleet-scrape", daemon=True)
        self._scrape_thread.start()
        with self._lock:
            n = len(self._replicas)
        self.info("fleet router: %d replicas, scrape every %.2fs", n,
                  self.scrape_interval_s)
        return self

    def stop(self):
        self._stop_evt.set()
        t = self._scrape_thread
        if t is not None:
            t.join(timeout=10)
        self._scrape_thread = None
        # a mid-cycle rolling drain must not race the teardown: its
        # loops watch _stop_evt and bail, and a restart completed
        # after this join is still covered — the restart handle
        # updated its owner's srv, so the owner's stop() stops the
        # REBUILT stack, not a stale reference
        with self._lock:
            dt = self._drain_thread
        if dt is not None and dt is not threading.current_thread():
            dt.join(timeout=30)

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> dict:
        """Fleet shutdown: stop admitting at the router, fan a drain
        out to every replica, release :meth:`wait`.  (The zero-downtime
        restart path is :meth:`rolling_drain`, not this.)"""
        self._draining = True
        for rep in self.replicas():
            try:
                rep.client.drain(timeout=5.0)
            except ReplicaUnavailable:
                pass
        self._stopped.set()
        return {"draining": True}

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._stopped.wait(timeout)

    # -- scrape / health loop ------------------------------------------------
    def _scrape_loop(self):
        while not self._stop_evt.wait(self.scrape_interval_s):
            try:
                self._scrape_once()
            except Exception:  # noqa: BLE001 — the scrape loop must
                # outlive any single bad replica answer
                self.exception("fleet scrape tick failed")

    def _scrape_once(self):
        reps = self.replicas()
        # one /metrics scrape per registry group, from a live member —
        # a dead leader must not freeze its group's SLO merge input
        leaders: Dict[str, str] = {}
        for rep in reps:
            if rep.state != EJECTED:
                leaders.setdefault(rep.registry_key, rep.id)
        for rep in reps:
            leaders.setdefault(rep.registry_key, rep.id)
        for rep in reps:
            err = None
            ready = False
            stats: Optional[dict] = None
            text: Optional[str] = None
            models: Optional[dict] = None
            try:
                ready = rep.client.ready(timeout=5.0)
                stats = rep.client.engine_stats(timeout=5.0)
                models = rep.client.models_doc(timeout=5.0)
                if leaders.get(rep.registry_key) == rep.id:
                    text = rep.client.metrics_text(timeout=5.0)
            except ReplicaUnavailable as e:
                err = str(e)
            with self._lock:
                if err is None:
                    rep.fails = 0
                    rep.ready = ready
                    rep.load = stats or {}
                    rep.active_version = (models or {}).get("active")
                    if text is not None:
                        rep.metrics_text = text
                    rep.last_scrape = time.monotonic()
                    if rep.state == EJECTED and ready:
                        rep.state = ACTIVE
                        rep.last_error = None
                        self._m_readmissions.inc()
                        self.info("fleet: replica %s readmitted "
                                  "(/ready again)", rep.id)
                else:
                    rep.last_error = err
                    rep.ready = False
                    rep.fails += 1
                    if rep.state == ACTIVE \
                            and rep.fails >= self.eject_failures:
                        self._eject_locked(rep, err)
        for w in self._slo_windows.values():
            w.tick()
        self._publish_gauges()

    def _eject_locked(self, rep: Replica, reason: str):  # requires-lock: self._lock
        """Eject a failed replica: stop routing to it and RELEASE its
        pending-dispatch ledger entries — the dispatch threads holding
        them observe the failure on their own connections and resubmit
        to survivors (ejection empties the ejected replica's ledger)."""
        rep.state = EJECTED
        rep.ready = False
        self._m_ejections.inc()
        for seq in list(self._pending.get(rep.id, ())):
            self._end_dispatch_locked(rep, seq)
        self.warning("fleet: ejected replica %s (%s)", rep.id, reason)

    def _publish_gauges(self):
        with self._lock:
            by_state = {ACTIVE: 0, DRAINING: 0, EJECTED: 0}
            for r in self._replicas:
                by_state[r.state] = by_state.get(r.state, 0) + 1
                self._g_outstanding.labels(replica=r.id).set(
                    r.outstanding)
            hits, reqs = self._affinity_hits, self._affinity_requests
        for state, n in by_state.items():
            self._g_replicas.labels(state=state).set(n)
        self._g_affinity_hit_rate.set(hits / reqs if reqs else 0.0)

    # -- dispatch ledger ------------------------------------------------------
    def _begin_dispatch(self, rep: Replica) -> int:
        with self._lock:
            self._dispatch_seq += 1
            seq = self._dispatch_seq
            self._pending.setdefault(rep.id, set()).add(seq)
            rep.outstanding = len(self._pending[rep.id])
            rep.dispatched += 1
        self._m_requests.labels(replica=rep.id).inc()
        return seq

    def _end_dispatch(self, rep: Replica, seq: int):
        with self._lock:
            self._end_dispatch_locked(rep, seq)

    def _end_dispatch_locked(self, rep: Replica, seq: int):  # requires-lock: self._lock
        pend = self._pending.get(rep.id)
        if pend is not None:
            pend.discard(seq)
        rep.outstanding = len(pend) if pend else 0

    # -- routing -------------------------------------------------------------
    def _head_hashes(self, prompt) -> List[bytes]:
        """Chained page hashes of the prompt head (first row of a
        batch request) — the SAME digests the replicas' prefix index
        keys (engine.prefix_page_hashes), truncated to
        ``affinity_pages``: the system prompt lives at the head, and
        hashing the whole prompt would make every long request
        affinity-unique."""
        if prompt is None or self.affinity_pages <= 0:
            return []
        try:
            row = np.asarray(prompt)
            if row.ndim == 2:
                row = row[0]
            row = row.reshape(-1)
            if not np.issubdtype(row.dtype, np.number):
                return []
            head = row[:self.affinity_pages * self.page_size]
            return prefix_page_hashes(head.astype(np.int64),
                                      self.page_size)
        except (TypeError, ValueError):
            return []    # malformed prompts get their 400 from the
            #              replica; affinity just doesn't apply

    def _score_locked(self, rep: Replica) -> float:  # requires-lock: self._lock
        """Load score, lower = better: scraped queue + occupancy plus
        the router's LIVE outstanding count (which beats scrape
        staleness), normalized by slot count; un-ready replicas carry
        a routable-last penalty."""
        st = rep.load or {}
        slots = max(int(st.get("slots", 1) or 1), 1)
        score = (float(st.get("queue_depth", 0))
                 + float(st.get("occupancy", 0))
                 + float(rep.outstanding)) / slots
        if not rep.ready:
            score += _NOT_READY_PENALTY
        return score

    @staticmethod
    def _burn_locked(rep: Replica) -> float:  # requires-lock: self._lock
        adm = (rep.load or {}).get("admission") or {}
        try:
            return float(adm.get("burn", 0.0) or 0.0)
        except (TypeError, ValueError):
            return 0.0

    def _route(self, priority: int, hashes: List[bytes],
               tried: set) -> Tuple[Optional[Replica], bool]:
        """Pick a replica → ``(replica, affinity_hit)``.  Affinity
        first (the page-holding replica keeps the stream unless its
        load is worse than the best by more than the hysteresis
        margin), then load dispatch with incumbent hysteresis, with a
        hash-ring fallback for cold prefixes.  Backed-off replicas
        (honored 429s) are skipped for classes > 0; class 0 falls back
        to the least-burned replica when everyone is backed off."""
        now = time.monotonic()
        with self._lock:
            cands = [r for r in self._replicas
                     if r.state == ACTIVE and r.id not in tried]
            # capacity classes: prefill-role replicas serve the disagg
            # prefill leg, not normal dispatch — unless the fleet
            # has NOTHING else (availability beats role purity)
            serving = [r for r in cands if r.role != "prefill"]
            if serving:
                cands = serving
            if not cands:
                return None, False
            open_ = [r for r in cands if r.backoff_until <= now]
            if not open_:
                if priority > 0:
                    return None, False
                # class 0 is never controller-shed per replica; at the
                # router it rides out fleet-wide backpressure on the
                # replica burning its budget slowest
                rep = min(cands, key=lambda r: (self._burn_locked(r),
                                                self._score_locked(r)))
                return rep, False
            cands = open_
            scores = {r.id: self._score_locked(r) for r in cands}
            best = min(cands, key=lambda r: scores[r.id])
            by_id = {r.id: r for r in cands}
            # 1) warm prefix: deepest known page hash wins
            for h in reversed(hashes):
                rid = self._affinity.get(h)
                rep = by_id.get(rid)
                if rep is not None and scores[rep.id] \
                        <= scores[best.id] + self.hysteresis:
                    return rep, True
            # 2) cold prefix: hash ring — the same new prefix
            # converges on one replica instead of warming all of them
            if hashes:
                ring = sorted(cands, key=lambda r: r.id)
                rep = ring[int.from_bytes(hashes[0][:8], "big")
                           % len(ring)]
                if scores[rep.id] <= scores[best.id] + self.hysteresis:
                    return rep, False
                return best, False
            # 3) pure load, with incumbent hysteresis so two stale
            # scrapes can't ping-pong the stream
            inc = by_id.get(self._last_pick)
            if inc is not None and scores[inc.id] \
                    <= scores[best.id] + self.hysteresis:
                return inc, False
            self._last_pick = best.id
            return best, False

    def _record_affinity(self, hashes: List[bytes], rep: Replica):
        """First-touch binding: a prefix keeps its original page
        holder.  A request load-diverted AWAY from the holder warms a
        second copy but must NOT migrate the session — rebinding on
        every success made sessions chase whichever replica was least
        loaded at the moment and collapse onto one.  Only a mapping
        whose holder left the active set rebinds."""
        if not hashes:
            return
        with self._lock:
            active = {r.id for r in self._replicas
                      if r.state == ACTIVE}
            for h in hashes:
                cur = self._affinity.get(h)
                if cur is not None and cur != rep.id \
                        and cur in active:
                    continue
                self._affinity.pop(h, None)      # re-insert = LRU touch
                self._affinity[h] = rep.id
            while len(self._affinity) > self.affinity_max:
                self._affinity.pop(next(iter(self._affinity)))

    def _note_dispatch_failure(self, rep: Replica, reason: str):
        """A dispatch-level transport failure counts toward ejection
        exactly like a failed health scrape — connection-refused from
        a crashed replica must not wait for the next scrape tick."""
        with self._lock:
            rep.last_error = reason
            rep.fails += 1
            if rep.state == ACTIVE and rep.fails >= self.eject_failures:
                self._eject_locked(rep, reason)

    def _note_backpressure(self, rep: Replica, retry_after_s: float):
        with self._lock:
            rep.backoff_until = time.monotonic() \
                + max(0.1, float(retry_after_s))
        self._m_backpressure.inc()

    # -- KV-page transfer: every helper here is BEST-EFFORT — a failed or
    # rejected transfer means the target replica prefills locally,
    # never an errored request -----------------------------------------------
    def _full_hashes(self, prompt) -> List[bytes]:
        """Chained page hashes of the WHOLE prompt head row — the
        disagg ship set, unlike :meth:`_head_hashes` which truncates to
        ``affinity_pages`` for routing keys."""
        if prompt is None:
            return []
        try:
            row = np.asarray(prompt)
            if row.ndim == 2:
                row = row[0]
            row = row.reshape(-1)
            if not np.issubdtype(row.dtype, np.number):
                return []
            return prefix_page_hashes(row.astype(np.int64),
                                      self.page_size)
        except (TypeError, ValueError):
            return []

    def _kv_fault_drop(self) -> bool:
        """Consult the fault plan's transfer knobs: sleep
        ``kv_transfer_slow_ms`` per transfer, and report True while the
        ``kv_transfer_drop`` budget (first N transfers fail) lasts."""
        if not faults.enabled():
            return False
        plan = faults.get_plan()
        if plan.kv_transfer_slow_ms:
            time.sleep(plan.kv_transfer_slow_ms / 1e3)
        if plan.kv_transfer_drop:
            with self._lock:
                if self._kv_drops < int(plan.kv_transfer_drop):
                    self._kv_drops += 1
                    return True
        return False

    def _fetch_worthwhile(self, rep: Replica, n_pages: int) -> bool:
        """Fetch-vs-reprefill payoff (the spec-decode _spec_worthwhile
        idiom): estimated transfer wall (page wire bytes over the
        measured link-bandwidth EWMA) against estimated local prefill
        wall (page tokens over the replica's scraped prefill
        throughput).  Cold — no measured bandwidth yet, or the replica
        hasn't scraped transfer geometry — is OPTIMISTIC: probe
        transfers are how the estimate gets seeded."""
        with self._lock:
            cold = self._kv_transfers < 3
            bw = self._kv_bw_ewma
        xfer = (rep.load or {}).get("kv_transfer") or {}
        try:
            page_bytes = float(xfer.get("page_bytes", 0) or 0)
            tok_s = float(xfer.get("prefill_tok_s", 0) or 0)
        except (TypeError, ValueError):
            page_bytes = tok_s = 0.0
        if cold or bw <= 0 or page_bytes <= 0 or tok_s <= 0:
            self._g_kv_payoff.set(0.0)
            return True
        est_fetch_s = n_pages * page_bytes / bw
        est_prefill_s = n_pages * self.page_size / tok_s
        payoff = est_prefill_s / max(est_fetch_s, 1e-9)
        self._g_kv_payoff.set(round(payoff, 4))
        return payoff >= 1.0

    def _transfer_pages(self, src: Replica, dst: Replica, *,
                        hashes: Optional[List[bytes]] = None,
                        top: Optional[int] = None,
                        outcome: str = "ok") -> Optional[dict]:
        """Move pages ``src`` → ``dst`` (named hashes or src's top-K
        hottest); returns dst's import doc on success, None on any
        failure.  The measured wall feeds the bandwidth EWMA."""
        t0 = time.monotonic()
        try:
            if self._kv_fault_drop():
                raise ReplicaUnavailable("fault: kv_transfer_drop")
            status, blob = src.client.fetch_pages(
                hashes, top=top, timeout=self.kv_timeout_s)
            if status != 200 or not blob:
                self._m_kv_fetches.labels(outcome="failed").inc()
                return None
            status2, doc = dst.client.put_pages(
                blob, timeout=self.kv_timeout_s)
            if status2 != 200 or not isinstance(doc, dict):
                # dst REJECTED the blob (geometry/weights-version) —
                # its local prefill is the correct fallback
                self._m_kv_fetches.labels(outcome="rejected").inc()
                return None
        except ReplicaUnavailable:
            self._m_kv_fetches.labels(outcome="failed").inc()
            return None
        wall = max(time.monotonic() - t0, 1e-6)
        with self._lock:
            bw = len(blob) / wall
            self._kv_bw_ewma = bw if self._kv_bw_ewma <= 0 \
                else 0.8 * self._kv_bw_ewma + 0.2 * bw
            self._kv_transfers += 1
        self._m_kv_fetches.labels(outcome=outcome).inc()
        return doc

    def _maybe_fetch_remote(self, rep: Replica,
                            hashes: List[bytes]) -> bool:
        """Fleet-wide prefix-cache sharing: the deepest affinity-known
        holder of the request's prefix pages ships them to the routed
        replica before dispatch, payoff permitting, so the admission
        there hits the imported prefix instead of re-prefilling."""
        if len(hashes) < self.kv_min_pages:
            return False
        with self._lock:
            holder_id = None
            for h in reversed(hashes):
                rid = self._affinity.get(h)
                if rid is not None and rid != rep.id:
                    holder_id = rid
                    break
            holder = next(
                (r for r in self._replicas if r.id == holder_id
                 and r.state in (ACTIVE, DRAINING)), None)
        if holder is None:
            return False
        if not self._fetch_worthwhile(rep, len(hashes)):
            self._m_kv_fetches.labels(outcome="skipped").inc()
            return False
        return self._transfer_pages(holder, rep,
                                    hashes=hashes) is not None

    def _disagg_prefill(self, rep: Replica, body: dict) -> bool:
        """Disaggregated dispatch: a prefill-class replica runs the
        (chunked) prefill — a steps=1 dispatch, whose single decode
        step is the prefill's first token — then its finished pages
        ship to the decode target, whose real admission starts at the
        shipped length via prefix hits.  Any failed leg falls back to
        a plain dispatch (``rep`` prefills locally)."""
        full = self._full_hashes(body.get("prompt"))
        if len(full) < self.kv_min_pages:
            return False
        with self._lock:
            pre = [r for r in self._replicas
                   if r.state == ACTIVE and r.role == "prefill"
                   and r.id != rep.id]
            p = min(pre, key=self._score_locked) if pre else None
        if p is None:
            return False
        pb = dict(body)
        pb["steps"] = 1
        pb.pop("priority", None)  # the prefill leg must not queue-jump
        try:
            status, _doc, _retry = p.client.generate(
                pb, timeout=self.dispatch_timeout_s)
        except ReplicaUnavailable:
            self._m_kv_fetches.labels(outcome="failed").inc()
            return False
        if status != 200:
            self._m_kv_fetches.labels(outcome="failed").inc()
            return False
        # the prefix binds to the decode target the pages ship to, which
        # routing can pick, not to the prefill replica, which it cannot
        # while a serving replica is up: a binding to ``p`` would make
        # every later request of the session miss and pay the leg again
        # (the JAX package binds ``p``, fleet.py:967)
        return self._transfer_pages(p, rep, hashes=full,
                                    outcome="disagg") is not None

    def _kv_prefetch(self, rep: Replica, body: dict,
                     hashes: List[bytes]):
        """Pre-dispatch page placement, in preference order: the
        disagg prefill leg when prefill-class capacity exists, else a
        remote fetch from the affinity holder.  Never raises — the
        transfer path is an optimization over local prefill, not a
        dependency of the request."""
        if not self.kv_transfer_enabled:
            return
        try:
            if self._disagg_prefill(rep, body):
                return
            self._maybe_fetch_remote(rep, hashes)
        except Exception:  # noqa: BLE001 — local prefill serves
            self.exception("kv prefetch failed; falling back to "
                           "local prefill")

    def handle_generate(self, body: dict) -> Tuple[int, object, Tuple]:
        """Route + forward one ``/generate`` →
        ``(status, doc, extra headers)``.  Failover policy: transport
        failures and replica-fatal statuses (503 stopped/draining, 500
        scheduler-crash) resubmit the request — it is unary and never
        mid-stream — to a survivor; 429s honor the replica's
        Retry-After as backpressure; everything else (including the
        client's own 4xx) is the replica's answer, returned as-is."""
        if self._draining:
            return 503, {"error": "fleet is draining"}, \
                (("Retry-After", "5"),)
        try:
            priority = int(body.get("priority", 0) or 0)
        except (TypeError, ValueError):
            priority = 0
        if body.get("batch"):
            # batch lane: route as a
            # non-zero class so a backed-off replica is SKIPPED, never
            # ridden through its 429 window the way class 0 rides the
            # least-burned replica — batch always defers to whatever
            # interactive pressure caused the backoff
            priority = max(priority, 1)
        hashes = self._head_hashes(body.get("prompt"))
        if hashes:
            self._m_affinity_requests.inc()
            with self._lock:
                self._affinity_requests += 1
        plan = faults.get_plan() if faults.enabled() else None
        with self._lock:
            self._route_count += 1
            route_n = self._route_count
            n_replicas = len(self._replicas)
        tried: set = set()
        retry_hint: Optional[float] = None
        hit_counted = False
        prefetched = False
        for _attempt in range(n_replicas + 1):
            rep, hit = self._route(priority, hashes, tried)
            if rep is None:
                break
            if hit and not hit_counted:
                # once per REQUEST, not per failover attempt — two
                # routed attempts must not make the hit rate exceed 1
                hit_counted = True
                self._m_affinity_hits.inc()
                with self._lock:
                    self._affinity_hits += 1
            if plan is not None:
                self._inject_faults(plan, rep, route_n)
            if hashes and not hit and not prefetched:
                # cold here (no affinity hit on the routed replica):
                # place the prefix pages there first — a disagg
                # prefill leg or a fetch from the holder — so the
                # admission below skips the re-prefill.  Once per
                # request: a failover retry must not pay twice.
                prefetched = True
                self._kv_prefetch(rep, body, hashes)
            seq = self._begin_dispatch(rep)
            try:
                try:
                    status, doc, retry = rep.client.generate(
                        body, timeout=self.dispatch_timeout_s)
                except ReplicaUnavailable as e:
                    # the replica never answered: resubmit to a
                    # survivor (idempotent — the request is unary and
                    # no partial answer escaped)
                    self._note_dispatch_failure(rep, str(e))
                    self._m_resubmissions.inc()
                    tried.add(rep.id)
                    continue
            finally:
                self._end_dispatch(rep, seq)
            if status == 429:
                # a batch-class 429 is "no headroom for BATCH" — the
                # replica is busy serving interactive, which is the
                # opposite of shedding.  Honoring it as router-level
                # backpressure would let the job manager's trough
                # probes black-hole class-0 traffic (every replica
                # "shedding" while all of them serve fine).
                if not body.get("batch"):
                    self._note_backpressure(rep, retry)
                retry_hint = retry if retry_hint is None \
                    else min(retry_hint, retry)
                tried.add(rep.id)
                continue
            if status == 503 or (status == 500 and isinstance(doc, dict)
                                 and doc.get("kind")
                                 == "scheduler_crash"):
                # the replica is going (drain/stop) or its scheduler
                # died: this request FAILED there — a survivor can
                # serve it
                self._note_dispatch_failure(rep, f"HTTP {status}")
                self._m_resubmissions.inc()
                tried.add(rep.id)
                continue
            if status == 200:
                self._record_affinity(hashes, rep)
            return status, doc, ()
        if retry_hint is None:
            # nothing was dispatched this call, but active replicas
            # sitting out earlier 429 windows are still backpressure:
            # answer with the soonest re-open, not a 503 a balancer
            # would misread as an outage
            now = time.monotonic()
            with self._lock:
                waits = [r.backoff_until - now for r in self._replicas
                         if r.state == ACTIVE and r.backoff_until > now]
            if waits:
                retry_hint = min(waits)
        if retry_hint is not None:
            return 429, {"error": "every replica is shedding "
                                  "(router-level backpressure)",
                         "retry_after_s": round(retry_hint, 3)}, \
                (("Retry-After", str(int(round(max(1.0,
                                                   retry_hint))))),)
        return 503, {"error": "no replica available"}, \
            (("Retry-After", "5"),)

    def handle_generate_stream(self, body: dict
                               ) -> Tuple[int, object, Tuple]:
        """Route + relay one STREAMING ``/generate`` → ``(status, result,
        extra headers)``.  On 200 ``result`` is a GENERATOR of NDJSON
        frame dicts; any pre-stream failure returns the same statuses
        :meth:`handle_generate` would.  The relay records the
        per-request token high-water mark; when a replica dies
        mid-stream (transport cut, or an error terminal frame from a
        crashed/stopped scheduler) it resubmits the SUFFIX — the
        original prompt/steps/seed plus every token already delivered,
        via the engine's ``emitted_prefix`` resume form — to a
        survivor and splices the streams, so the client sees one
        gapless, duplicate-free sequence bitwise-identical to an
        uninterrupted run.  ``serve.stream.retry_budget`` resumes with
        ``serve.stream.backoff_s``-based capped backoff bound the
        failover storm; the budget or the request deadline running out
        yields ONE error/deadline terminal frame, never a hang."""
        if self._draining:
            return 503, {"error": "fleet is draining"}, \
                (("Retry-After", "5"),)
        try:
            priority = int(body.get("priority", 0) or 0)
        except (TypeError, ValueError):
            priority = 0
        hashes = self._head_hashes(body.get("prompt"))
        if hashes:
            self._m_affinity_requests.inc()
            with self._lock:
                self._affinity_requests += 1
        plan = faults.get_plan() if faults.enabled() else None
        with self._lock:
            self._route_count += 1
            route_n = self._route_count
        # the router-side failover clock: every resume leg must fit
        # inside what remains of the ORIGINAL request deadline (resumed
        # legs get the shrunken remainder as their deadline_s)
        try:
            total_s = float(body.get("deadline_s")
                            or self.stream_deadline_s)
        except (TypeError, ValueError):
            total_s = self.stream_deadline_s
        deadline = time.monotonic() + total_s
        # high-water mark: every token already DELIVERED to the client
        # (seeded by a client-side resume's own prefix); the resume
        # body sends exactly this list, so a survivor numbers its
        # first frame one past it
        tokens: List[int] = [int(t) for t in
                             np.asarray(body.get("emitted_prefix")
                                        if body.get("emitted_prefix")
                                        is not None else [],
                                        np.int64).reshape(-1)]
        state = {"hit_counted": False, "prefetched": False}

        def run_leg(tried: set, leg_body: dict):
            """One routed streaming dispatch, with the unary loop's
            skip/backoff/failover semantics.  Returns ``("stream",
            rep, seq, frames)`` holding the dispatch ledger entry open
            (the relay closes it), ``("status", code, doc, headers)``
            for an answered non-200, or ``("exhausted", retry_hint)``."""
            retry_hint = None
            with self._lock:
                n_replicas = len(self._replicas)
            for _attempt in range(n_replicas + 1):
                rep, hit = self._route(priority, hashes, tried)
                if rep is None:
                    break
                if hit and not state["hit_counted"]:
                    state["hit_counted"] = True
                    self._m_affinity_hits.inc()
                    with self._lock:
                        self._affinity_hits += 1
                if plan is not None:
                    self._inject_faults(plan, rep, route_n)
                if hashes and not hit and not state["prefetched"]:
                    state["prefetched"] = True
                    self._kv_prefetch(rep, leg_body, hashes)
                seq = self._begin_dispatch(rep)
                try:
                    status, result, retry = rep.client.generate_stream(
                        leg_body, timeout=self.dispatch_timeout_s)
                except ReplicaUnavailable as e:
                    self._end_dispatch(rep, seq)
                    self._note_dispatch_failure(rep, str(e))
                    self._m_resubmissions.inc()
                    tried.add(rep.id)
                    continue
                if status == 200:
                    self._record_affinity(hashes, rep)
                    return ("stream", rep, seq, result)
                self._end_dispatch(rep, seq)
                if status == 429:
                    self._note_backpressure(rep, retry)
                    retry_hint = retry if retry_hint is None \
                        else min(retry_hint, retry)
                    tried.add(rep.id)
                    continue
                if status == 503 or (status == 500
                                     and isinstance(result, dict)
                                     and result.get("kind")
                                     == "scheduler_crash"):
                    self._note_dispatch_failure(rep, f"HTTP {status}")
                    self._m_resubmissions.inc()
                    tried.add(rep.id)
                    continue
                return ("status", status, result, ())
            return ("exhausted", retry_hint)

        def leg_body_now() -> dict:
            b = dict(body)
            b["stream"] = True
            b["emitted_prefix"] = list(tokens)
            # the remaining budget, floored just enough to keep the
            # replica's deadline_s validation (> 0) satisfied — the
            # engine, not the router, owns expiry semantics
            b["deadline_s"] = max(0.05, deadline - time.monotonic())
            return b

        first = run_leg(set(), leg_body_now())
        if first[0] == "status":
            return first[1], first[2], first[3]
        if first[0] == "exhausted":
            retry_hint = first[1]
            if retry_hint is None:
                # same soonest-reopen answer as the unary path: backed-
                # off replicas are backpressure, not an outage
                now = time.monotonic()
                with self._lock:
                    waits = [r.backoff_until - now
                             for r in self._replicas
                             if r.state == ACTIVE
                             and r.backoff_until > now]
                if waits:
                    retry_hint = min(waits)
            if retry_hint is not None:
                return 429, {"error": "every replica is shedding "
                                      "(router-level backpressure)",
                             "retry_after_s": round(retry_hint, 3)}, \
                    (("Retry-After", str(int(round(max(
                        1.0, retry_hint))))),)
            return 503, {"error": "no replica available"}, \
                (("Retry-After", "5"),)

        def relay(rep, seq, frames):
            cut_at = plan.stream_cut_at_token if plan is not None else 0
            stall_ms = plan.stream_stall_ms if plan is not None else 0.0
            resumes_left = self.stream_retry_budget
            relayed = 0
            while True:
                failure = None
                try:
                    try:
                        for frame in frames:
                            if frame.get("done"):
                                reason = frame.get("finish_reason")
                                if reason == "error":
                                    # the replica-side request FAILED
                                    # (scheduler crash/stop, shed
                                    # mid-flight): resumable, exactly
                                    # like a transport cut — but the
                                    # replica itself answered, so no
                                    # ejection strike
                                    failure = ("terminal",
                                               str(frame.get("error")))
                                    break
                                yield frame
                                return
                            i = int(frame["i"])
                            if i < len(tokens):
                                continue    # overlap after a resume:
                                #             already delivered, drop
                            if i > len(tokens):
                                # a gap is stream corruption — never
                                # deliver it; resume from the mark
                                failure = ("gap",
                                           f"frame {i} past high-water "
                                           f"mark {len(tokens)}")
                                break
                            tokens.append(int(frame["token"]))
                            relayed += 1
                            if stall_ms:
                                # injected slow consumer
                                # (faults.stream_stall_ms): the relay
                                # lags, the replica-side handle buffers
                                time.sleep(stall_ms / 1e3)
                            yield frame
                            if cut_at and relayed >= cut_at \
                                    and faults.fire_once("stream_cut"):
                                raise ReplicaUnavailable(
                                    f"{rep.id}: injected stream cut "
                                    f"after frame {relayed} "
                                    "(faults.stream_cut_at_token)")
                    except ReplicaUnavailable as e:
                        failure = ("transport", str(e))
                finally:
                    # the leg's ledger entry closes however the leg
                    # ends — clean terminal, failover, or the client
                    # closing the relay generator mid-stream
                    self._end_dispatch(rep, seq)
                if failure is None:
                    # replica closed the stream with no terminal frame:
                    # the transport died between frames
                    failure = ("transport",
                               f"{rep.id}: stream ended without a "
                               "terminal frame")
                cut_at = 0      # the injected cut fires once
                if hasattr(frames, "close"):
                    frames.close()
                if failure[0] == "transport":
                    self._note_dispatch_failure(rep, failure[1])
                interrupted = time.monotonic()
                resumed = None
                while resumes_left > 0:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    resumes_left -= 1
                    attempt = self.stream_retry_budget - resumes_left
                    backoff = min(
                        self.stream_backoff_s * (2 ** (attempt - 1)),
                        self.stream_backoff_max_s, max(remaining, 0.0))
                    if backoff > 0:
                        time.sleep(backoff)
                    self._m_resubmissions.inc()
                    self._m_stream_resumes.inc()
                    # first retry skips the replica that just died; later
                    # retries re-admit it (a restart may have brought it
                    # back inside the backoff window)
                    nxt = run_leg({rep.id} if attempt == 1 else set(),
                                  leg_body_now())
                    if nxt[0] == "stream":
                        resumed = nxt
                        break
                    if nxt[0] == "status":
                        # a survivor ANSWERED with a non-resumable
                        # error (e.g. 400): surface it terminally
                        doc = nxt[2] if isinstance(nxt[2], dict) else {}
                        yield {"done": True, "finish_reason": "error",
                               "error": f"resume failed with HTTP "
                                        f"{nxt[1]}: "
                                        f"{doc.get('error', nxt[2])}"}
                        return
                    # exhausted this pass: let the backoff window give
                    # ejection/readmission a chance before retrying
                if resumed is None:
                    if deadline - time.monotonic() <= 0:
                        yield {"done": True,
                               "finish_reason": "deadline",
                               "error": "request deadline expired "
                                        "during mid-stream failover"}
                        return
                    self._m_stream_retry_exhausted.inc()
                    yield {"done": True, "finish_reason": "error",
                           "error": "mid-stream failover retry budget "
                                    f"exhausted after {failure[1]} "
                                    "(serve.stream.retry_budget)"}
                    return
                self._m_stream_splice.observe(
                    time.monotonic() - interrupted)
                _tag, rep, seq, frames = resumed

        return 200, relay(first[1], first[2], first[3]), ()

    def _inject_faults(self, plan, rep: Replica, route_n: int):
        """Fleet fault knobs (runtime/faults.py): ``replica_slow_ms``
        delays every dispatch to the lowest-id active replica;
        ``replica_crash_at_request`` kills the chosen replica right
        before the Nth dispatch is forwarded (once per arming), so the
        forward fails over through the resubmission path."""
        if plan.replica_slow_ms:
            with self._lock:
                low = min((r.id for r in self._replicas
                           if r.state == ACTIVE), default=None)
            if rep.id == low:
                time.sleep(plan.replica_slow_ms / 1e3)
        if plan.replica_crash_at_request \
                and route_n >= plan.replica_crash_at_request \
                and rep.kill is not None \
                and faults.fire_once("replica_crash"):
            self.warning("fault: killing replica %s at request %d",
                         rep.id, route_n)
            try:
                rep.kill()
            except Exception:  # noqa: BLE001 — an imperfect kill must
                pass           # not fail the rehearsal's request

    # -- coordinated hot swap ------------------------------------------------
    def coordinated_swap(self, source: Optional[str] = None,
                         version=None) -> dict:
        """Fleet-wide two-phase hot swap: stage the new version on
        EVERY active replica, flip only after all staged successfully,
        roll back everywhere when any flip fails.  The fleet ends on
        the new version everywhere or the old version everywhere —
        never mixed.  Rollback of an already-committed replica reloads
        its previous registry version (which needs a reloadable boot
        source; a 'live'-booted replica logs the gap loudly)."""
        with self._ops_mutex:
            reps = self._by_state(ACTIVE)
            if not reps:
                return {"swapped": False, "phase": "stage",
                        "errors": {"fleet": "no active replicas"}}
            staged: Dict[str, str] = {}
            prev_version: Dict[str, Optional[int]] = {}
            errors: Dict[str, str] = {}
            for rep in reps:        # phase 1: stage everywhere
                try:
                    models = rep.client.models_doc()
                    prev_version[rep.id] = (models or {}).get("active")
                    status, doc = rep.client.stage(source=source,
                                                   version=version)
                    if status == 200 and isinstance(doc, dict) \
                            and doc.get("staged"):
                        staged[rep.id] = doc["staged"]
                    else:
                        errors[rep.id] = f"HTTP {status}: {doc}"
                except ReplicaUnavailable as e:
                    errors[rep.id] = str(e)
            if errors:
                for rep in reps:
                    token = staged.get(rep.id)
                    if token is None and rep.id not in errors:
                        continue
                    # a stage whose REPLY was lost may have landed
                    # server-side and would wedge every later swap on
                    # that replica ("already staged") — a token-less
                    # abort clears whatever is pending (idempotent)
                    try:
                        rep.client.abort(token)
                    except ReplicaUnavailable:
                        pass
                self._m_swap_rollbacks.inc()
                result = {"swapped": False, "phase": "stage",
                          "errors": errors,
                          "staged_then_aborted": sorted(staged)}
                self._last_swap = result
                self.warning("coordinated swap aborted at stage: %s",
                             errors)
                return result
            committed: List[Replica] = []
            for rep in reps:        # phase 2: flip everywhere
                try:
                    status, doc = rep.client.commit(staged[rep.id])
                    if status != 200:
                        # an HTTP error is UNambiguous: commit_staged
                        # either flipped (200) or left the old version
                        # serving (its own rollback) before replying
                        errors[rep.id] = f"HTTP {status}: {doc}"
                        break
                    committed.append(rep)
                except ReplicaUnavailable as e:
                    # ambiguous: the reply was lost, but the flip may
                    # have landed server-side after the timeout — a
                    # committed-but-unrecorded replica skipped by the
                    # rollback would leave the fleet MIXED.  Resolve
                    # by probing the registry it would have advanced.
                    errors[rep.id] = str(e)
                    try:
                        m = rep.client.models_doc()
                        if m is not None and m.get("active") \
                                != prev_version.get(rep.id):
                            committed.append(rep)
                    except ReplicaUnavailable:
                        pass    # still unreachable: nothing flipped a
                        #         working registry forward, and a dead
                        #         replica rejoins via /ready + scrape
                    break
            if errors:
                # roll back: uncommitted stagings abort, committed
                # replicas reload the version they served before
                rolled, rollback_errors = [], {}
                for rep in reps:
                    if rep in committed:
                        continue
                    token = staged.get(rep.id)
                    if token is not None:
                        try:
                            rep.client.abort(token)
                        except ReplicaUnavailable:
                            pass
                for rep in committed:
                    prev = prev_version.get(rep.id)
                    try:
                        status, doc = rep.client.reload(version=prev)
                        if status == 200:
                            rolled.append(rep.id)
                        else:
                            rollback_errors[rep.id] = \
                                f"HTTP {status}: {doc}"
                    except ReplicaUnavailable as e:
                        rollback_errors[rep.id] = str(e)
                self._m_swap_rollbacks.inc()
                result = {"swapped": False, "phase": "commit",
                          "errors": errors, "rolled_back": rolled,
                          "rollback_errors": rollback_errors}
                self._last_swap = result
                self.warning("coordinated swap rolled back: %s",
                             errors)
                return result
            self._m_swaps.inc()
            result = {"swapped": True,
                      "replicas": [r.id for r in committed],
                      "previous_versions": prev_version}
            self._last_swap = result
            self.info("coordinated swap committed on %d replicas",
                      len(committed))
            return result

    # -- rolling drain -------------------------------------------------------
    def begin_rolling_drain(self) -> dict:
        """Async rolling drain (the ``POST /admin/rolling-drain``
        handler): one replica at a time on a background thread; 202 —
        watch ``/fleet.json`` for progress."""
        with self._lock:
            t = self._drain_thread
            if t is not None and t.is_alive():
                return {"rolling": True, "already": True}
            self._drain_thread = threading.Thread(
                target=self.rolling_drain, name="fleet-rolling-drain",
                daemon=True)
            self._drain_thread.start()
        return {"rolling": True}

    def rolling_drain(self) -> dict:
        """Zero-downtime restart cycle: for each replica in turn —
        stop routing to it, wait for its in-flight work to retire,
        restart it (the restart handle; ``--join``ed replicas are
        drained for their external supervisor instead), readmit when
        ``/ready`` answers again, move on.  Survivors keep serving the
        whole time.  EJECTED replicas the router can restart ride the
        cycle too (skipping the idle wait — a crashed replica has
        nothing in flight): the rolling drain is also the repair
        action that rebuilds a dead in-process/child replica."""
        with self._ops_mutex:
            results = []
            with self._lock:
                cycle = [r for r in self._replicas
                         if r.state == ACTIVE
                         or (r.state == EJECTED
                             and r.restart is not None)]
            for rep in sorted(cycle, key=lambda r: r.id):
                if self._draining or self._stop_evt.is_set():
                    # fleet shutdown wins: restarting replicas into a
                    # stopping fleet would leave fresh serving stacks
                    # running past the "clean" exit
                    results.append({"replica": rep.id,
                                    "skipped": "fleet stopping"})
                    continue
                entry = {"replica": rep.id, "restarted": False,
                         "readmitted": False}
                with self._lock:
                    was_ejected = rep.state == EJECTED
                if not was_ejected:
                    # affinity-preserving drain: push the victim's hot
                    # prefix pages to a successor BEFORE routing stops,
                    # so sessions landing elsewhere post-drain keep
                    # their warm TTFT (a dead replica has no pages to
                    # push).  Best-effort like every transfer.
                    entry["prewarm"] = self._prewarm_successor(rep)
                with self._lock:
                    was_ejected = rep.state == EJECTED
                    rep.state = DRAINING
                entry["idle"] = True if was_ejected \
                    else self._wait_replica_idle(rep)
                if rep.restart is not None:
                    try:
                        new_url = rep.restart()
                        if new_url:
                            with self._lock:
                                rep.client = ReplicaClient(str(new_url))
                        entry["restarted"] = True
                    except Exception as e:  # noqa: BLE001 — a failed
                        # restart must strand ONE replica, not the loop
                        entry["error"] = f"{type(e).__name__}: {e}"
                        with self._lock:
                            rep.last_error = entry["error"]
                            self._eject_locked(rep, entry["error"])
                        results.append(entry)
                        continue
                else:
                    try:
                        rep.client.drain(timeout=5.0)
                    except ReplicaUnavailable:
                        pass
                ready = self._wait_ready(rep)
                with self._lock:
                    rep.state = ACTIVE if ready else EJECTED
                    rep.ready = ready
                    rep.fails = 0
                    if ready:
                        rep.load = {}
                entry["readmitted"] = ready
                results.append(entry)
                self.info("rolling drain: %s %s", rep.id,
                          "readmitted" if ready else "NOT ready "
                          "(ejected; the scrape loop readmits it when "
                          "/ready answers)")
            summary = {"completed": bool(results)
                       and all(r.get("readmitted") for r in results),
                       "replicas": results}
            self._last_drain = summary
            if summary["completed"]:
                self._m_rolling_drains.inc()
            return summary

    def _prewarm_successor(self, rep: Replica) -> Optional[dict]:
        """Ship ``rep``'s top-K hottest prefix pages (refcount-ranked
        — ``GET /kv/pages?top=K``) to the least-loaded surviving
        replica and REPOINT the affinity entries that named ``rep`` as
        holder, so post-drain routing lands where the pages now live.
        Returns a summary dict for the drain report, None when skipped
        or failed."""
        if not self.kv_transfer_enabled or self.prewarm_pages <= 0:
            return None
        with self._lock:
            others = [r for r in self._replicas
                      if r.state == ACTIVE and r.id != rep.id
                      and r.role != "prefill"]
            succ = min(others, key=self._score_locked) if others \
                else None
        if succ is None:
            return None
        doc = self._transfer_pages(rep, succ, top=self.prewarm_pages,
                                   outcome="prewarm")
        if doc is None:
            return None
        moved = []
        for hx in doc.get("hashes", ()):
            try:
                moved.append(bytes.fromhex(hx))
            except (TypeError, ValueError):
                continue
        with self._lock:
            for h in moved:
                if self._affinity.get(h) == rep.id:
                    self._affinity[h] = succ.id
        return {"to": succ.id,
                "pages": int(doc.get("imported", 0))
                + int(doc.get("skipped", 0)),
                "dropped": int(doc.get("dropped", 0))}

    def _wait_replica_idle(self, rep: Replica) -> bool:
        """The drained replica's router-tracked in-flight count AND
        its own queue/occupancy must reach zero (a request the router
        dispatched before the drain decision must retire there)."""
        deadline = time.monotonic() + self.drain_timeout_s
        while time.monotonic() < deadline \
                and not self._stop_evt.is_set():
            with self._lock:
                outstanding = rep.outstanding
            if outstanding == 0:
                try:
                    st = rep.client.engine_stats(timeout=5.0) or {}
                except ReplicaUnavailable:
                    return False        # it died; restart will tell
                if not st or (int(st.get("queue_depth", 0) or 0) == 0
                              and int(st.get("occupancy", 0) or 0)
                              == 0):
                    return True
            time.sleep(self.drain_poll_s)
        return False

    def _wait_ready(self, rep: Replica) -> bool:
        """Probe ``/ready`` with the shared retry-backoff shape
        (deploy.http_retry's curve) until the restart deadline."""
        import random
        deadline = time.monotonic() + self.restart_timeout_s
        delay = HTTP_RETRY_BASE_S
        while time.monotonic() < deadline \
                and not self._stop_evt.is_set():
            try:
                if rep.client.ready(timeout=5.0):
                    return True
            except ReplicaUnavailable:
                pass
            time.sleep(min(delay * (1.0 + random.random()
                                    * BACKOFF_JITTER),
                           max(deadline - time.monotonic(), 0.0)))
            delay = min(delay * BACKOFF_FACTOR, 2.0)
        return False

    # -- aggregated observability -------------------------------------------
    def _group_items(self) -> List[Tuple[str, str]]:
        """One ``(group key, scraped /metrics text)`` per registry
        group — the SLO merge's input.  In-process replicas share a
        registry (and a group), so their already-merged histograms
        count once.  Live members' texts win over an ejected former
        leader's stale snapshot (which would otherwise freeze the
        merged window until readmission); an all-dead group falls back
        to its last sight."""
        with self._lock:
            texts: Dict[str, str] = {}
            for rep in self._replicas:
                if rep.metrics_text and rep.state != EJECTED \
                        and rep.registry_key not in texts:
                    texts[rep.registry_key] = rep.metrics_text
            for rep in self._replicas:
                if rep.metrics_text \
                        and rep.registry_key not in texts:
                    texts[rep.registry_key] = rep.metrics_text
            return list(texts.items())

    def _group_texts(self) -> List[str]:
        return [text for _key, text in self._group_items()]

    def _group_samples(self) -> List[Tuple[str, list]]:
        """Parsed samples per registry group, memoized on the scraped
        text OBJECT (each scrape stores a fresh string): both fleet
        histograms read the same tick's texts, so the full Prometheus
        parse runs once per group per scrape instead of once per
        histogram per read."""
        out = []
        for key, text in self._group_items():
            with self._lock:
                cached = self._samples_cache.get(key)
            if cached is None or cached[0] is not text:
                cached = (text, parse_samples(text))
                with self._lock:
                    self._samples_cache[key] = cached
            out.append((key, cached[1]))
        return out

    def _has_group_texts(self) -> bool:
        with self._lock:
            return any(r.metrics_text for r in self._replicas)

    def merged_slo_doc(self) -> dict:
        """The fleet ``GET /slo.json``: windowed percentiles + burn
        over the MERGED per-replica histograms (scraped cumulative
        buckets summed per registry group, windowed by the same
        HistogramWindow ring the per-process tracker uses)."""
        metrics = {}
        for key, w in self._slo_windows.items():
            _hist, pairs, count, total = w.delta()
            out = {"count": int(count),
                   "sum_seconds": round(float(total), 6)}
            for q in (0.5, 0.95, 0.99):
                out[f"p{int(q * 100)}_ms"] = round(
                    1e3 * quantile_from_cumulative(pairs, q), 3)
            target_ms = self._slo_targets_ms.get(key, 0.0)
            out["target_p99_ms"] = target_ms
            if target_ms > 0 and pairs:
                frac = fraction_over(pairs, target_ms / 1e3)
                burn = frac / 0.01
                out["frac_over_target"] = round(frac, 5)
                out["burn_rate"] = round(burn, 3)
                out["burning"] = burn >= self._slo_burn_threshold \
                    and count >= 10
            else:
                out["frac_over_target"] = 0.0
                out["burn_rate"] = 0.0
                out["burning"] = False
            metrics[key] = out
        return {
            "fleet": True,
            "replica_groups": len(self._group_texts()),
            "window_s": self._slo_window_s,
            "slices": self._slo_slices,
            "burn_threshold": self._slo_burn_threshold,
            "metrics": metrics,
            "burning": any(m["burning"] for m in metrics.values()),
        }

    def fleet_doc(self) -> dict:
        """``GET /fleet.json`` — the topology document: every replica
        with state/load/backoff, the dispatch policy knobs, affinity
        health, and the last swap / rolling-drain outcomes."""
        with self._lock:
            replicas = [r.doc() for r in self._replicas]
            hits, reqs = self._affinity_hits, self._affinity_requests
            affinity_entries = len(self._affinity)
            kv_bw = self._kv_bw_ewma
            kv_transfers = self._kv_transfers
            roles: Dict[str, int] = {}
            for r in self._replicas:
                roles[r.role] = roles.get(r.role, 0) + 1
            # versions come from the scrape cache, NOT live HTTP: the
            # topology document is what operators poll during an
            # incident, and a wedged replica must not make it hang
            versions = {r.id: r.active_version for r in self._replicas
                        if r.state != EJECTED
                        and r.active_version is not None}
        return {
            "role": "fleet-router",
            "draining": self._draining,
            "replicas": replicas,
            "active_versions": versions,
            "dispatch": {
                "scrape_interval_s": self.scrape_interval_s,
                "hysteresis": self.hysteresis,
                "affinity_pages": self.affinity_pages,
                "page_size": self.page_size,
                "eject_failures": self.eject_failures,
            },
            "affinity": {
                "entries": affinity_entries,
                "requests": reqs, "hits": hits,
                "hit_rate": round(hits / reqs, 4) if reqs else 0.0,
            },
            "roles": roles,
            "kv_transfer": {
                "enabled": self.kv_transfer_enabled,
                "min_pages": self.kv_min_pages,
                "timeout_s": self.kv_timeout_s,
                "prewarm_pages": self.prewarm_pages,
                "transfers": kv_transfers,
                "bandwidth_Bps": round(kv_bw, 1),
            },
            "last_swap": self._last_swap,
            "last_rolling_drain": self._last_drain,
            **({"jobs": self.jobs.summary()}
               if self.jobs is not None else {}),
        }


class FleetServer(Logger):
    """The router's HTTP front: ``POST /generate`` dispatches across
    the fleet (``{"stream": true}`` relays NDJSON frames); ``GET
    /fleet.json`` / merged ``/slo.json`` / ``/metrics`` aggregate it;
    ``POST /admin/reload`` runs the coordinated two-phase swap, ``POST
    /admin/rolling-drain`` the zero-downtime restart cycle, ``POST
    /admin/join`` registers a replica by URL, ``POST /admin/drain``
    shuts the fleet down; with a job store (``jobs_dir`` or
    ``root.common.serve.jobs.dir``) the ``/jobs*`` API runs fleet-wide
    through :meth:`FleetRouter.handle_generate`.  The same stdlib
    threading server shape as :class:`~.restful.RestfulServer`."""

    def __init__(self, router: FleetRouter, *, port: int = 0,
                 host: str = "127.0.0.1", jobs_dir: Optional[str] = None):
        import http.server

        from .jobs import JobManager, handle_jobs_request
        from .restful import (read_json_body, reply_json,
                              reply_metrics_text)
        self.router = router
        # the batch lane: dispatch IS handle_generate, so every sharded
        # prompt rides the same affinity routing, failover and
        # resubmission as interactive traffic, on the trough class
        if jobs_dir is None:
            jobs_dir = str(root.common.serve.jobs.get("dir", "") or "")
        self.jobs: Optional[JobManager] = None
        if jobs_dir:
            self.jobs = JobManager(jobs_dir, router.handle_generate)
            router.jobs = self.jobs
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _reply(self, obj, code=200, headers=()):
                reply_json(self, obj, code=code, headers=headers)

            def _jobs_or_404(self, method, body):
                hit = handle_jobs_request(outer.jobs, method, self.path,
                                          body)
                if hit is None:
                    self.send_error(404)
                else:
                    self._reply(hit[1], code=hit[0])

            def _stream_reply(self, frames):
                """Relay router stream frames as NDJSON — headers first,
                then one flushed JSON line per frame (the replica's own
                streaming wire shape); the consumer reads to connection
                close.  A client that disconnects mid-stream closes the
                relay generator, which releases the upstream leg."""
                try:
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/x-ndjson")
                    self.send_header("Cache-Control", "no-store")
                    self.send_header("Connection", "close")
                    self.end_headers()
                    for frame in frames:
                        self.wfile.write(
                            (json.dumps(frame) + "\n").encode())
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionError, OSError):
                    pass    # consumer went away; generator close below
                finally:    # ends the upstream leg either way
                    if hasattr(frames, "close"):
                        frames.close()

            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/")
                if path == "/metrics":
                    reply_metrics_text(self)
                elif path == "/fleet.json":
                    self._reply(outer.router.fleet_doc())
                elif path == "/slo.json":
                    self._reply(outer.router.merged_slo_doc())
                elif path == "/healthz":
                    self._reply({"status": "alive",
                                 "role": "fleet-router"})
                elif path == "/ready":
                    up = [r for r in outer.router.replicas()
                          if r.state == ACTIVE and r.ready]
                    ok = bool(up) and not outer.router.draining
                    self._reply(
                        {"ready": ok, "replicas_ready": len(up)},
                        code=200 if ok else 503)
                else:
                    self._jobs_or_404("GET", None)

            def do_DELETE(self):
                self._jobs_or_404("DELETE", None)

            def do_POST(self):
                path = self.path.split("?", 1)[0].rstrip("/")
                try:
                    req = read_json_body(self)  # 413 answered inside
                    if req is None:
                        return
                    if path == "/generate":
                        hdr = self.headers.get("X-Priority")
                        if hdr is not None:
                            req.setdefault("priority", hdr)
                        if req.get("stream"):
                            code, result, headers = \
                                outer.router.handle_generate_stream(req)
                            if code != 200:
                                self._reply(result, code=code,
                                            headers=headers)
                                return
                            self._stream_reply(result)
                            return
                        code, doc, headers = \
                            outer.router.handle_generate(req)
                        self._reply(doc, code=code, headers=headers)
                    elif path == "/admin/reload":
                        out = outer.router.coordinated_swap(
                            source=req.get("source") or req.get("path"),
                            version=req.get("version"))
                        self._reply(out,
                                    code=200 if out.get("swapped")
                                    else 409)
                    elif path == "/admin/rolling-drain":
                        self._reply(outer.router.begin_rolling_drain(),
                                    code=202)
                    elif path == "/admin/join":
                        url = req.get("url")
                        if not url:
                            self._reply(
                                {"error": 'join needs {"url": ...}'},
                                code=400)
                            return
                        rep = outer.router.add_replica(
                            url=str(url),
                            registry_key=req.get("registry_key"),
                            role=req.get("role"))
                        self._reply({"joined": rep.id,
                                     "url": rep.client.base_url})
                    elif path == "/admin/drain":
                        self._reply(outer.router.begin_drain(),
                                    code=202)
                    else:
                        self._jobs_or_404("POST", req)
                except (KeyError, TypeError, ValueError,
                        json.JSONDecodeError) as e:
                    self._reply({"error": str(e)}, code=400)
                except Exception as e:  # noqa: BLE001 — the router
                    # must answer even when a fleet op blows up
                    self._reply({"error": f"{type(e).__name__}: {e}"},
                                code=500)

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer((host, port),
                                                     Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "FleetServer":
        self.router.start()
        if self.jobs is not None:
            self.jobs.start()
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="fleet-server", daemon=True)
        self._thread.start()
        self.info("fleet router serving on http://127.0.0.1:%d "
                  "(/generate, /fleet.json)", self.port)
        return self

    def stop(self):
        if self.jobs is not None:
            # stop scheduling batch dispatches before the router's
            # replicas go away; committed results resume elsewhere
            self.jobs.stop()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(10)
            self._thread = None
        self.router.stop()

    def install_signal_handlers(self) -> bool:
        import signal

        def _on_sigterm(signum, frame):  # noqa: ARG001
            self.info("SIGTERM: draining the fleet before exit")
            self.router.begin_drain()

        try:
            signal.signal(signal.SIGTERM, _on_sigterm)
            return True
        except ValueError:
            self.warning(
                "not the main thread; SIGTERM handler not installed")
            return False


class InProcessReplica:
    """Owns one in-process replica stack built by ``factory`` — a
    zero-arg callable returning a STARTED :class:`~.restful.
    RestfulServer` whose engine runs (deploy control plane attached) —
    and adapts it to the router's handle contract: ``url`` to dispatch
    to, ``kill`` for the fault harness (hard stop, no drain: in-flight
    work fails as it would in a crashed process), ``restart`` for the
    rolling drain (tear down, rebuild through the factory, hand the
    router the new URL).  The port's server does not own its engine, so
    this handle stops both.  On the card the factory's new engine
    captures its steps while the other replicas serve (see
    ``runtime/step_cache.py``, the capture gate)."""

    def __init__(self, factory: Callable[[], object]):
        self.factory = factory
        self.srv = factory()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.srv.port}"

    def _stop_stack(self):
        self.srv.stop()
        if self.srv.engine is not None:
            self.srv.engine.stop()

    def kill(self):
        """Crash simulation: the listener closes and the engine stops
        without a drain; queued and mid-flight work fails (503/500 to
        whoever is on the wire), the shape a killed replica process
        presents to the router."""
        self._stop_stack()

    def restart(self) -> str:
        """Rolling-drain reboot: stop the old stack (the router already
        stopped routing to it and waited out its in-flight work),
        rebuild through the factory, return the new URL."""
        try:
            self._stop_stack()
        except Exception:  # noqa: BLE001 — a half-dead old stack must
            pass           # not block its own replacement
        self.srv = self.factory()
        return self.url

    def stop(self):
        try:
            self._stop_stack()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass
