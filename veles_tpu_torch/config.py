"""Typed-ish configuration tree with dot-path access and overrides.

A copy of ``veles_tpu/config.py`` kept inside the PyTorch port so the port
never imports the JAX package: ``configs/*.json`` and every
``root.common.serve.*`` key load unchanged.  Keep the two in step.

Original note: TPU-native re-design of the reference's global ``root`` Config tree
(reference: veles/config.py:60-152 — auto-vivifying attribute tree, defaults at
:178-291, ``--dump-config``, inline ``root.x.y=z`` overrides) and of the
genetics ``Range()`` tuneable markers (reference: veles/genetics/config.py:45-130
— "config doubles as the GA genome").

Differences from the reference, by design:
  * No executable-Python config files as the primary path (still supported via
    :func:`apply_config_file` for parity); dicts / JSON are first-class.
  * ``Range`` carries explicit (min, max) or choices and is discoverable by the
    genetic optimizer via :func:`collect_tuneables`.
"""

from __future__ import annotations

import json
import runpy
from typing import Any, Callable, Iterator


class Range:
    """A tuneable hyperparameter marker inside a :class:`Config`.

    Mirrors the reference's ``veles.genetics.config.Range`` (reference:
    veles/genetics/config.py:45-130): holds a current value plus the domain the
    genetic optimizer may explore.

    ``Range(0.01, 0.0001, 0.1)``  -> continuous domain [0.0001, 0.1]
    ``Range(16, 8, 256, integer=True)`` -> integer domain
    ``Range.choice("relu", ["relu", "tanh"])`` -> categorical
    """

    __slots__ = ("value", "min_value", "max_value", "choices", "integer")

    def __init__(self, value, min_value=None, max_value=None, *,
                 choices=None, integer=None):
        self.value = value
        self.min_value = min_value
        self.max_value = max_value
        self.choices = list(choices) if choices is not None else None
        if integer is None:
            integer = isinstance(value, int) and not isinstance(value, bool)
        self.integer = integer

    @classmethod
    def choice(cls, value, choices):
        return cls(value, choices=choices)

    def clip(self, v):
        if self.choices is not None:
            return v if v in self.choices else self.value
        if self.min_value is not None:
            v = max(self.min_value, v)
        if self.max_value is not None:
            v = min(self.max_value, v)
        if self.integer:
            v = int(round(v))
        return v

    def __repr__(self):
        if self.choices is not None:
            return f"Range({self.value!r}, choices={self.choices!r})"
        return f"Range({self.value!r}, {self.min_value!r}, {self.max_value!r})"


def _unwrap(v):
    return v.value if isinstance(v, Range) else v


class Config:
    """Auto-vivifying attribute tree (reference: veles/config.py:60-152).

    ``cfg.loader.minibatch_size = 100`` creates intermediate nodes on demand.
    Reading an attribute that does not exist also auto-vivifies (matching the
    reference's behavior where reading returns a fresh Config node), so use
    :meth:`get` / ``in`` checks when existence matters.
    """

    def __init__(self, path="", **kwargs):
        object.__setattr__(self, "_path", path)
        object.__setattr__(self, "_items", {})
        self.update(kwargs)

    # -- attribute protocol ------------------------------------------------
    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        items = object.__getattribute__(self, "_items")
        if name not in items:
            child_path = f"{self._path}.{name}" if self._path else name
            items[name] = Config(child_path)
        return items[name]

    def __setattr__(self, name: str, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
            return
        self._items[name] = self._coerce(name, value)

    def __delattr__(self, name):
        self._items.pop(name, None)

    def _coerce(self, name, value):
        if isinstance(value, dict):
            child_path = f"{self._path}.{name}" if self._path else name
            node = Config(child_path)
            node.update(value)
            return node
        return value

    # -- mapping-ish protocol ----------------------------------------------
    def __contains__(self, name: str) -> bool:
        return name in self._items

    def __iter__(self) -> Iterator[str]:
        return iter(self._items)

    def items(self):
        return self._items.items()

    def keys(self):
        return self._items.keys()

    def get(self, name: str, default=None):
        v = self._items.get(name, default)
        return _unwrap(v) if isinstance(v, Range) else v

    def __getitem__(self, name):
        return getattr(self, name)

    def __setitem__(self, name, value):
        setattr(self, name, value)

    # -- bulk ops ----------------------------------------------------------
    def update(self, tree: dict) -> "Config":
        """Deep-merge a nested dict (reference: veles/config.py:100-117)."""
        for k, v in tree.items():
            if isinstance(v, dict) and isinstance(self._items.get(k), Config):
                self._items[k].update(v)
            else:
                setattr(self, k, v)
        return self

    def set_path(self, dotted: str, value):
        """``cfg.set_path("loader.minibatch_size", 64)``."""
        parts = dotted.split(".")
        node = self
        for p in parts[:-1]:
            node = getattr(node, p)
        setattr(node, parts[-1], value)

    def get_path(self, dotted: str, default=None):
        node = self
        for p in dotted.split("."):
            if not isinstance(node, Config) or p not in node:
                return default
            node = node._items[p]
        return _unwrap(node)

    def to_dict(self, unwrap_ranges: bool = True) -> dict:
        out = {}
        for k, v in self._items.items():
            if isinstance(v, Config):
                out[k] = v.to_dict(unwrap_ranges)
            elif isinstance(v, Range):
                out[k] = v.value if unwrap_ranges else v
            else:
                out[k] = v
        return out

    def value(self, name: str, default=None):
        """Fetch a leaf, unwrapping Range tuneables."""
        if name not in self._items:
            return default
        return _unwrap(self._items[name])

    def dump(self) -> str:
        """``--dump-config`` parity (reference: veles/__main__.py)."""
        return json.dumps(self.to_dict(), indent=2, default=repr, sort_keys=True)

    def __repr__(self):
        return f"Config({self._path or 'root'}: {self.to_dict()!r})"

    def __bool__(self):
        return bool(self._items)


def collect_tuneables(cfg: Config, prefix: str = "") -> dict:
    """Walk the tree, returning ``{dot.path: Range}`` for every tuneable.

    This is what makes "config is the GA genome" work (reference:
    veles/genetics/config.py:45-223).
    """
    found = {}
    for k, v in cfg.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Config):
            found.update(collect_tuneables(v, path))
        elif isinstance(v, Range):
            found[path] = v
    return found


def apply_overrides(cfg: Config, overrides: list[str]) -> None:
    """Apply ``path=value`` strings (CLI ``root.x.y=z`` parity,
    reference: veles/__main__.py:474-481). Values parsed as JSON, falling
    back to raw string."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be path=value, got {ov!r}")
        path, _, raw = ov.partition("=")
        try:
            value = json.loads(raw)
        except (json.JSONDecodeError, ValueError):
            value = raw
        cfg.set_path(path.strip(), value)


def apply_config_file(cfg: Config, filename: str) -> None:
    """Load a config file into ``cfg``.

    ``.json`` files deep-merge; ``.py`` files are executed with ``root`` bound
    to ``cfg`` (reference parity: user configs are executed Python mutating the
    global root, veles/__main__.py:426-472).
    """
    if filename.endswith(".json"):
        with open(filename) as f:
            cfg.update(json.load(f))
    else:
        runpy.run_path(filename, init_globals={"root": cfg})


#: The global config tree, like the reference's ``veles.config.root``.
root = Config()


def _defaults():
    # NOTE: the reference's precision_type (host dtype) and a global
    # compute_dtype used to be declared here but nothing read them —
    # the on-device dtype is a per-unit/model knob (``compute_dtype=``
    # on units and StandardWorkflow layer specs).  veles_tpu.analysis
    # VK302 keeps this file honest about such drift.
    root.common.precision_level = 0          # 0 fast | 1 high | 2 highest (ref PRECISION_LEVEL)
    root.common.timings = False
    root.common.trace_file = ""              # JSONL event trace target
    root.common.cache_dir = ".veles_tpu"
    root.common.autotune = True              # measured per-device op picks
    root.common.snapshot_dir = "snapshots"
    # Persistent XLA compilation cache directory ("" = disabled): set via
    # --compile-cache or root.common.compile_cache=DIR overrides; see
    # runtime/step_cache.py and docs/compile_cache.md. Programs whose
    # backend compile is faster than compile_cache_min_compile_secs are
    # not persisted (0 = persist everything).
    root.common.compile_cache = ""
    root.common.compile_cache_min_compile_secs = 0.0
    # Upper bound (MiB) on the tensors blob compare_snapshots /
    # Snapshotter.load will download from an http(s):// snapshot URI.
    root.common.snapshot_http_max_mb = 2048
    # Snapshot retention: keep only the newest K manifests+blobs per
    # prefix (0 = keep everything).  The _current/_best symlink targets
    # are never collected (docs/robustness.md).
    root.common.snapshot_keep = 0
    # Training fault tolerance (runtime/trainer.py + docs/robustness.md).
    root.common.train.sentinel = True       # in-graph non-finite guard
    root.common.train.clip_norm = 0.0       # global grad-norm clip (0=off)
    root.common.train.anomaly_patience = 0  # consecutive bad steps before
    #                                         rollback escalation (0=never)
    # Loader transient-read retry (loader/base.py; the Veles
    # failed-minibatch-requeue analog).
    root.common.loader.retries = 2          # attempts beyond the first
    root.common.loader.retry_backoff_s = 0.05  # first retry delay (doubles)
    # Transient HTTP retry (forge/client.py, Snapshotter http loads;
    # backoff shape shared with the deploy watcher, runtime/deploy.py).
    root.common.net.http_retries = 3
    # Observability (runtime/metrics.py + runtime/status.py,
    # docs/observability.md "Metrics & tracing").
    root.common.observe.label_cap = 64       # label series per metric;
    #                                          beyond -> the _other series
    root.common.observe.span_ring = 512      # request/step spans kept for
    #                                          GET /trace.json / --trace-out
    root.common.observe.status_flush_s = 0.25  # min interval between
    #                                            status.json event flushes
    # Deep performance observability (docs/observability.md: memory
    # ledger, goodput/MFU, rolling SLO windows, profiler endpoint).
    root.common.observe.peak_tflops = 0.0    # measured peak for MFU; 0 =
    #                                          use runtime/benchmark.py's
    #                                          cached GEMM calibration
    root.common.observe.peak_hbm_gbps = 0.0  # HBM bandwidth peak for the
    #                                          decode MBU gauge (0 = MBU
    #                                          reported as 0 / unknown)
    root.common.observe.memory_poll_s = 2.0  # device memory_stats() poll
    #                                          period (0 = no poller)
    root.common.observe.slo.window_s = 60.0  # rolling SLO window length
    root.common.observe.slo.slices = 12      # bucket-snapshot ring slices
    root.common.observe.slo.ttft_p99_ms = 0.0       # p99 TTFT target
    #                                                 (0 = no target)
    root.common.observe.slo.queue_wait_p99_ms = 0.0  # p99 queue-wait
    #                                                  target (0 = none)
    root.common.observe.slo.burn_threshold = 2.0  # burn rate at/above
    #                                               which the SLO "burns"
    root.common.observe.slo.degrade_ready = False  # /ready 503s on
    #                                                sustained burn
    root.common.observe.profile_dir = ""     # POST /debug/profile capture
    #                                          dir ("" = cache_dir/profiles)
    root.common.observe.profile_max_s = 30.0  # per-capture duration cap
    root.common.random_seed = 42
    root.common.platform = ""                # "" = let JAX pick
    root.common.mesh = dict(data=-1)          # -1: all remaining devices
    # Serving knobs (runtime/engine.py + runtime/restful.py, docs/serving.md).
    root.common.serve.slots = 8              # decode slots (engine batch)
    root.common.serve.l_max = 512            # per-slot KV length cap
    root.common.serve.prefill_bucket_min = 16  # smallest pow2 prompt bucket
    # Paged KV cache + shared-prefix reuse (docs/serving.md "Paged KV
    # cache"): the pool, not slots*l_max, is the real token capacity.
    root.common.serve.paged = True           # page-pool KV layout
    root.common.serve.page_size = 16         # tokens per page (divides
    #                                          l_max; halves itself if not)
    root.common.serve.pages = None           # pool size; None = the
    #                                          dense-equivalent slots*l_max
    # Fused Pallas paged-attention decode kernel (docs/serving.md
    # "Paged KV cache"): gathers K/V pages inside the kernel instead of
    # materializing the flat pool[ptab] view.  BOUNDED-ERROR vs the
    # bitwise gather path (online softmax reorders the summation), so
    # it is opt-in and requires serve.paged.
    root.common.serve.paged_kernel = False
    # Speculative decoding (docs/serving.md "Speculative decoding"):
    # a host-side prompt-lookup drafter proposes up to spec.k tokens
    # per slot and ONE verify program (the third program kind) scores
    # all k+1 positions per call; emitted tokens stay bitwise the
    # non-speculative engine's.
    root.common.serve.spec.enabled = False   # speculative decode on/off
    root.common.serve.spec.k = 4             # draft tokens per verify
    root.common.serve.spec.drafter = "ngram"  # host drafter (prompt
    #                                           lookup; no second model)
    # Megastep decode (docs/serving.md "Megastep decode"): fuse N decode
    # micro-steps into ONE compiled dispatch (the fourth program kind),
    # amortizing the host scheduler pass to once per N tokens.  Engaged
    # only when every slot is busy and nothing is pending (admission,
    # chunked prefill, a speculative draft) — otherwise the engine runs
    # plain N=1 steps so interactive latency never waits on a fused
    # block.  Emitted tokens stay bitwise the N=1 engine's.
    root.common.serve.megastep = 1           # micro-steps per dispatch
    #                                          (1 = off)
    root.common.serve.window_ms = 2.0        # admission batching window
    root.common.serve.queue_depth = 64       # pending requests before 429
    # Overload survival (docs/serving.md "Overload survival"): chunked
    # prefill bounds how long one prompt can monopolize the scheduler,
    # priority classes give queue-jump + preemption, and the adaptive
    # admission controller resizes the admitted queue window off the
    # SLO burn rate instead of only flipping /ready.
    root.common.serve.prefill_chunk = 256    # split prefills longer than
    #                                          this into bucket-sized
    #                                          slices interleaved with
    #                                          decode steps (0 = off)
    root.common.serve.priorities = 3         # request classes (0 = the
    #                                          highest; default class 0)
    root.common.serve.preempt = True         # a higher-class arrival may
    #                                          retire-and-requeue the
    #                                          lowest-class youngest slot
    root.common.serve.admission.enabled = True  # SLO-driven admission
    #                                             window (no-op while no
    #                                             slo target is set)
    root.common.serve.admission.min_window = 2  # floor the window never
    #                                             shrinks below
    root.common.serve.admission.interval_s = 0.25  # controller eval step
    root.common.serve.admission.hold_s = 2.0  # burn must stay recovered
    #                                           this long before regrowth
    root.common.serve.admission.decrease = 0.5  # multiplicative shrink
    #                                             while burn >= threshold
    root.common.serve.admission.increase = 1.5  # multiplicative regrowth
    #                                             once recovery held
    # Fleet serving (runtime/fleet.py, docs/serving.md "Fleet
    # serving"): a lightweight router fronting N replica serving
    # stacks — load + prefix-affinity dispatch, coordinated hot swap,
    # rolling drain, replica ejection with resubmission.
    root.common.serve.fleet.replicas = 0     # CLI --fleet N (0 = single
    #                                          -replica serving, no router)
    root.common.serve.fleet.scrape_interval_s = 0.5  # replica load/
    #                                                  health poll period
    root.common.serve.fleet.hysteresis = 0.5  # load-score margin a rival
    #                                           replica must win by before
    #                                           routing switches (stale
    #                                           scrapes must not flap it)
    root.common.serve.fleet.affinity_pages = 4  # prompt-head pages hashed
    #                                             for prefix affinity
    root.common.serve.fleet.affinity_max = 4096  # prefix->replica map
    #                                              entries kept (LRU)
    root.common.serve.fleet.eject_failures = 2  # consecutive scrape/
    #                                             health failures before a
    #                                             replica is ejected
    root.common.serve.fleet.drain_poll_s = 0.05  # rolling-drain idle-
    #                                              check cadence
    root.common.serve.fleet.restart_timeout_s = 120.0  # rolling drain:
    #                                                    replica must be
    #                                                    /ready again
    #                                                    within this
    root.common.serve.fleet.role = "mixed"   # capacity class replicas
    #                                          join with (mixed | prefill
    #                                          | decode) unless add_replica
    #                                          / --join names one
    # Disaggregated prefill/decode (runtime/fleet.py + engine
    # export_pages/import_pages, docs/serving.md "Disaggregated
    # prefill/decode"): serialized KV-page transfer between replicas.
    root.common.serve.kv_transfer.enabled = True  # router-initiated
    #                                               page transfers
    root.common.serve.kv_transfer.min_pages = 2  # smallest prefix (full
    #                                              pages) worth shipping
    root.common.serve.kv_transfer.timeout_s = 5.0  # per-leg transfer
    #                                                HTTP deadline
    root.common.serve.kv_transfer.prewarm_pages = 64  # top-K hottest
    #                                                   pages the rolling
    #                                                   drain pushes to
    #                                                   the successor
    # Batch job lane (runtime/jobs.py, docs/serving.md "Batch lane"):
    # durable bulk-inference jobs riding the trough-filler class below
    # every interactive priority.
    root.common.serve.jobs.dir = ""          # durable job store root
    #                                          ("" = job API off)
    root.common.serve.jobs.workers = 2       # manager dispatch threads
    root.common.serve.jobs.min_headroom_slots = 1  # idle admissible slots
    #                                                required before batch
    #                                                enters (trough gate)
    root.common.serve.jobs.burn_ceiling = 1.0  # max SLO burn rate the
    #                                            trough gate admits under
    #                                            (interactive sheds at
    #                                            admission.burn_threshold)
    root.common.serve.jobs.trough_retry_s = 0.05  # Retry-After hint on a
    #                                               trough-closed 429 —
    #                                               sub-second because the
    #                                               trough reopens at slot
    #                                               granularity, unlike the
    #                                               >=1s interactive hint
    root.common.serve.jobs.retry_s = 0.25    # base backoff after a batch
    #                                          429 (Retry-After overrides
    #                                          upward)
    root.common.serve.jobs.max_prompts = 100000  # per-job prompt cap
    root.common.serve.jobs.page_limit = 256  # GET /jobs/<id>/results
    #                                          default page size
    # Streaming + mid-stream failover (docs/serving.md "Streaming and
    # mid-stream failover"): incremental token frames with the router
    # resuming an interrupted stream from its last delivered token.
    root.common.serve.stream.buffer_tokens = 4096  # undrained frames a
    #                                                consumer may leave
    #                                                buffered before its
    #                                                stream closes with
    #                                                an overflow error
    root.common.serve.stream.retry_budget = 3  # mid-stream failover
    #                                            resubmissions per
    #                                            request before the
    #                                            router gives up with an
    #                                            error terminal frame
    root.common.serve.stream.backoff_s = 0.05  # base sleep before a
    #                                            mid-stream resubmission
    #                                            (doubles per attempt)
    root.common.serve.stream.backoff_max_s = 2.0  # backoff growth cap —
    #                                               bounds a failover
    #                                               storm's dispatch rate
    root.common.serve.deadline_s = 120.0     # default per-request deadline
    root.common.serve.max_body_mb = 64       # POST body cap -> 413
    # Model lifecycle control plane (runtime/deploy.py, docs/serving.md).
    root.common.serve.model_dir = ""         # registry/watcher snapshot dir
    root.common.serve.swap_timeout_s = 60.0  # step-boundary flip deadline
    root.common.serve.drain_timeout_s = 30.0  # graceful-drain deadline
    root.common.serve.drain_grace_s = 2.0    # min /ready-503 hold on drain
    root.common.serve.watch_interval_s = 5.0  # snapshot watcher poll period
    root.common.serve.watch_backoff_max_s = 300.0  # watcher retry ceiling
    # Experiment manager (experiments/, docs/experiments.md): the
    # autonomous train -> select -> hot-swap loop.
    root.common.experiment.dir = ""          # durable experiment store
    #                                          root ("" = API off)
    root.common.experiment.generations = 4   # default search generations
    root.common.experiment.population = 8    # default trials/generation
    root.common.experiment.workers = 1       # >1 + cli_argv: parallel
    #                                          trial subprocess pool
    root.common.experiment.promote_margin = 0.0  # score improvement over
    #                                              the baseline a winner
    #                                              must exceed to swap
    root.common.experiment.eval_steps = 8    # decode steps per eval
    #                                          prompt in the scoring sweep
    root.common.experiment.eval_timeout_s = 300.0  # batch-lane sweep
    #                                                wait deadline


_defaults()
