"""Trainer: the host-side epoch loop tying loader + workflow + decision +
snapshotter together (counterpart of veles_tpu/runtime/trainer.py:57-743).

The train and eval steps come from a :class:`~.step_cache.StepCache`,
built once per workflow lifetime and on the card captured once as CUDA
graphs (eval lazily, on the first eval epoch); the per-epoch metric sums
stay on the device as tensors and are read back once per epoch.  A
worker thread assembles the next batches while the current step runs:
for an eager step the whole batch on the device (the fullbatch loader's
gather, or a host batch and its copy); for a captured step only the
host-side work (a card-resident batch stays a ``DeviceBatch``, a host
batch becomes pinned tensors), because the step's static inputs are
written by the thread that replays it, right before the replay.
Rollback, restore, the lr multiplier and anomaly escalation write into
the live state's tensors in place, so none of them recaptures.  The
Decision's rollback restores the best state and scales the learning
rate through the ``__lr_mult__`` scalar of ``opt_state``; after
``root.common.train.anomaly_patience`` consecutive anomalous steps the
trainer rolls back too, to the best state or the last snapshot (walking
back past corrupt ones).  Snapshots carry the JAX ``Trainer``'s payload,
so a run resumes in either package.

The trainer's parameters and optimizer state enter the memory ledger
(``runtime/memory.py``) at ``initialize``; a ``status`` reporter gets
the epoch's results.  Goodput (trainer.py:123-133, :426-457): the train
step's counted flops (``StepCache.entry_cost``, counted once: before
the capture, or at an eager step's first execution) times the steps of an epoch over its train-phase wall feed
``vt_train_flops_per_sec`` and ``vt_train_mfu`` (against
``runtime.benchmark.resolve_peak_tflops``), and the results carry
``train_step_flops``, ``train_mfu`` and ``peak_tflops`` unrounded.
With a ``mesh`` (``parallel.mesh.Mesh``; one process a rank, every
rank's loader yielding the same global batches from the same seed) the
train step is the data-parallel one, or with a ``pipe`` axis above 1 the
fused 1F1B schedule (interleaved with ``pipeline_interleave`` > 1), and
the eval step evaluates each data rank's rows (trainer.py:63-83,
:203-210); those steps talk to other ranks and stay eager.  A ``rule``
(``parallel.mesh``) places the state: each rank keeps its block of
every leaf it splits (``parallel/fsdp.py``), every step factory takes
it, a snapshot (and the in-memory best state) gathers every split leaf
to the host on every rank (:676-679) and rank 0 alone writes it, and a
restore or rollback cuts the whole state under the rule again.
"""

from __future__ import annotations

import queue
import threading
import time
import weakref
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import prng
from ..config import root
from ..loader.base import TEST, TRAIN, VALID, Loader
from ..logger import Logger
from ..ops import resolve_device
from ..ops.optimizers import (ANOM_CONSEC_KEY, LR_MULT_KEY, Optimizer,
                              reserved_opt_neutral, tree_assign)
from ..units.base import Spec
from ..units.workflow import Workflow
from .benchmark import epoch_goodput, resolve_peak_tflops
from .decision import Decision
from .memory import drop_stamped_components, memory_monitor, tree_bytes
from .metrics import registry
from .snapshotter import (Snapshotter, restore_with_walkback,
                          wstate_to_numpy)
from .step_cache import StepCache


def aggregate_epoch_metrics(sums: Dict[str, float]) -> Dict[str, float]:
    """Epoch sums -> error % (softmax evaluators), rmse (MSE evaluators:
    the root of the mean per-sample MSE), loss and grad norm per trained
    batch (veles_tpu/runtime/trainer.py:38-54)."""
    n = max(sums.get("n_samples", 0.0), 1.0)
    out = dict(sums)
    if "n_err" in sums:
        out["error_pct"] = 100.0 * sums["n_err"] / n
    if "mse_sum" in sums:
        out["rmse"] = float(np.sqrt(sums["mse_sum"] / n))
    trained = max(sums.get("n_batches", 0.0)
                  - sums.get("anomaly_steps", 0.0), 1.0)
    if "loss" in sums and "n_batches" in sums:
        out["loss"] = sums["loss"] / trained
    if "grad_norm" in sums and "n_batches" in sums:
        out["grad_norm"] = sums["grad_norm"] / trained
    return out


def _read_sums(sums: Dict[str, Any], n_batches: int) -> Dict[str, float]:
    """One device read for the whole epoch's sums."""
    keys = sorted(sums)
    vals = torch.stack([sums[k].float() for k in keys]).tolist() \
        if keys else []
    out = dict(zip(keys, vals))
    out["n_batches"] = float(n_batches)
    return out


class Trainer(Logger):
    """Single-device training loop."""

    def __init__(self, workflow: Workflow, loader: Loader,
                 optimizer: Optimizer, decision: Optional[Decision] = None,
                 snapshotter: Optional[Snapshotter] = None, *,
                 prefetch: int = 2, device=None,
                 step_cache: Optional[StepCache] = None, status=None,
                 mesh=None, pipeline_microbatches: Optional[int] = None,
                 pipeline_interleave: int = 1, rule=None):
        self.workflow = workflow
        self.mesh = mesh
        self.rule = rule
        #: the placed state's layout (``parallel.fsdp.ShardedState``):
        #: None without a mesh or with a whole state
        self.sharding = None
        self.pipeline_microbatches = pipeline_microbatches
        self.pipeline_interleave = int(pipeline_interleave or 1)
        self.status = status      # runtime.status.StatusReporter (optional)
        self.loader = loader
        self.optimizer = optimizer
        self.decision = decision or Decision(max_epochs=10)
        self.snapshotter = snapshotter
        self.prefetch = prefetch  # batches assembled ahead (0 = inline)
        self.device = resolve_device(device)
        self.step_cache = step_cache if step_cache is not None \
            else StepCache()
        self.wstate = None
        self._train_step = None
        self._eval_step = None
        self._eval_entry = None
        self._best_wstate = None
        self.results: Dict[str, Any] = {}
        self.anomaly_steps_skipped = 0
        self.anomaly_rollbacks = 0
        self.snapshot_walkbacks = 0
        reg = registry()
        self._m_anom = reg.counter(
            "vt_train_anomaly_skips_total",
            "train steps skipped by the in-step anomaly sentinel")
        self._m_rollbacks = reg.counter(
            "vt_train_anomaly_rollbacks_total",
            "rollbacks escalated from consecutive anomalous steps")
        self._m_walkbacks = reg.counter(
            "vt_snapshot_walkbacks_total",
            "corrupt snapshots skipped on the way to a valid one")
        self._g_flops_sec = reg.gauge(
            "vt_train_flops_per_sec",
            "achieved training flops/s over the last train-epoch wall "
            "(loader waits included; eval and snapshots outside it)")
        self._g_mfu = reg.gauge(
            "vt_train_mfu",
            "model FLOPs utilization of the last train epoch against "
            "the measured peak (0 = peak unknown)")
        self._train_key = None
        self._last_mfu = 0.0

    # -- setup -------------------------------------------------------------
    def initialize(self, seed: Optional[int] = None,
                   wstate: Optional[dict] = None) -> None:
        """Build the workflow from the first batch's shapes and make the
        state: ``wstate`` as given, else fresh weights seeded from
        ``seed`` or the ``"init"`` PRNG stream."""
        self.loader.initialize()
        batch = next(self.loader.iter_epoch(
            TRAIN if self.loader.class_lengths[TRAIN] else VALID))
        # a card-resident batch knows its specs before any gather
        specs = batch.specs() if hasattr(batch, "specs") else {
            k: Spec(tuple(v.shape), _dtype(v)) for k, v in batch.items()}
        self.workflow.build(specs)
        if wstate is not None:
            self.wstate = wstate
        else:
            if seed is None:
                seed = prng.get("init").next_seed() & 0x7FFFFFFF
            self.wstate = self.workflow.init_state(seed, self.optimizer,
                                                   self.device)
        self._batch_spec = specs
        self._compile_steps()
        if self.mesh is not None and self.mesh.world_group is not None:
            # the train step's layout (a collective step runs eagerly)
            layout = self._train_step.step.state
            if layout.sharded:
                self.sharding = layout
                self.wstate = layout.shard_state(self.wstate)
        # the ledger of GET /memory.json, from shapes; a freed trainer's
        # entries leave it unless a newer one took the names over
        mem = memory_monitor()
        stamps = {name: mem.set_component(name, tree_bytes(
            self.wstate.get(part, {})))
            for name, part in (("train.params", "params"),
                               ("train.opt_state", "opt_state"))}
        self._mem_finalizer = weakref.finalize(
            self, drop_stamped_components, stamps)
        mem.ensure_poller()
        self.info("workflow %s: %d params", self.workflow.name,
                  self.workflow.n_params(self.wstate))

    def _compile_steps(self) -> None:
        """The train step from the StepCache (on the card: captured over
        this state and a zero batch, the static inputs the eval step
        shares); the eval step on the first eval epoch.  A rollback, a
        restore or a re-``initialize`` with unchanged shapes is a hit."""
        key = self.step_cache.trainer_key(
            self.workflow, self.optimizer, self.wstate, self._batch_spec,
            self.device)
        build_train, build_eval = self._step_factories()
        if self.mesh is not None:
            key += (("mesh", tuple(sorted(self.mesh.shape.items())),
                     id(self.mesh), id(self.rule),
                     self.pipeline_microbatches,
                     self.pipeline_interleave),)
        inputs = {k: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                  for k, s in self._batch_spec.items()}
        args = (self.wstate, inputs)
        pin = (self.workflow, self.optimizer, self.mesh, self.rule)
        self._train_step = self.step_cache.get_step(
            "train", key, build_train, args, pin=pin)
        # the cost of THIS trainer's program, never the kind's sum (a
        # rebuilt optimizer's superseded entry stays cached)
        self._train_key = key
        self._eval_step = None
        self._eval_entry = (key, args, pin, build_eval)

    def _step_factories(self):
        """The (train, eval) step factories: the plain steps without a mesh;
        with one the data-parallel step, or the fused 1F1B schedule when
        the pipe axis is above 1 (trainer.py:203-210)."""
        wf, opt, mesh = self.workflow, self.optimizer, self.mesh
        if mesh is None:
            # no mesh: a stack runs sequentially, its configs' own
            # "same math, portable config"
            return (lambda: wf.make_train_step(opt)), wf.make_eval_step
        pipe = mesh.shape.get("pipe", 1)
        if pipe > 1:
            n_mb = self.pipeline_microbatches
            if n_mb is None:
                from ..units.parallel_nn import PipelineStack
                stacks = [u for u in wf.units
                          if isinstance(u, PipelineStack)]
                n_mb = (stacks[0].n_microbatches if stacks else None) \
                    or pipe
                self.info("no pipeline_microbatches: the stack trains on "
                          "the fused 1F1B schedule with %d microbatches "
                          "(the GPipe schedule's gradients)", n_mb)

            def build_train():
                return wf.make_pipeline_train_step(
                    opt, mesh, n_microbatches=n_mb,
                    interleave=self.pipeline_interleave, rule=self.rule)
        else:
            if self.pipeline_interleave > 1:
                raise ValueError(
                    "pipeline_interleave needs the fused 1F1B schedule: "
                    "give the mesh a 'pipe' axis > 1")

            def build_train():
                return wf.make_sharded_train_step(opt, mesh, rule=self.rule)
        return build_train, (lambda: wf.make_sharded_eval_step(
            mesh, rule=self.rule))

    def _ensure_eval_step(self):
        if self._eval_step is None:
            key, (_, inputs), pin, build_eval = self._eval_entry
            self._eval_step = self.step_cache.get_step(
                "eval", key, build_eval, (self.wstate, inputs), pin=pin)
        return self._eval_step

    # -- epoch passes -------------------------------------------------------
    def _place_batch(self, batch, staged: bool):
        """A batch as the step takes it.  For an eager step: tensors on
        the trainer's device (a card-resident batch gathered).  For a
        captured one (``staged``) only the host-side work: a
        card-resident batch passes through and host arrays become pinned
        tensors; the step writes either into its static inputs."""
        if staged and hasattr(batch, "gather"):
            return batch
        if hasattr(batch, "gather"):
            return batch.gather()
        out = {k: v if isinstance(v, torch.Tensor)
               else torch.from_numpy(np.asarray(v))
               for k, v in batch.items()}
        if staged:
            return {k: v if v.is_cuda else v.pin_memory()
                    for k, v in out.items()}
        return {k: v.to(self.device) for k, v in out.items()}

    def _batches(self, klass: int, epoch, step):
        """The batch stream of ``step``; with ``prefetch`` > 0 a worker
        thread assembles up to ``prefetch`` batches ahead of the step
        (an eager step's device work there shares the default stream with
        the step's, so it runs in order)."""
        staged = getattr(step, "captured", False)
        it = self.loader.iter_epoch(klass, epoch)
        if self.prefetch <= 0:
            for item in it:
                yield self._place_batch(item, staged)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        end = object()
        stop = threading.Event()

        def put(item) -> bool:
            # gives up when the consumer is gone (step raised, early stop)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in it:
                    if not put(self._place_batch(item, staged)):
                        return
                put(end)
            except BaseException as e:  # re-raised on the consumer side
                put(e)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=30)

    def _run_epoch_train(self, epoch: int) -> Dict[str, float]:
        sums: Dict[str, Any] = {}
        n = 0
        for batch in self._batches(TRAIN, epoch, self._train_step):
            self.wstate, mets = self._train_step(self.wstate, batch)
            # summed on the device, in stream order before the next step
            # (a captured step's metrics are its graph's static outputs):
            # no host read per step
            for k, v in mets.items():
                sums[k] = sums[k] + v if k in sums else v.clone()
            n += 1
        return aggregate_epoch_metrics(_read_sums(sums, n))

    def _run_epoch_eval(self, klass: int, epoch: int) -> Dict[str, float]:
        if self.loader.class_lengths[klass] == 0:
            return {}
        step = self._ensure_eval_step()
        sums: Dict[str, Any] = {}
        n = 0
        for batch in self._batches(klass, epoch, step):
            mets = step(self.wstate, batch)
            for k, v in mets.items():
                sums[k] = sums[k] + v if k in sums else v.clone()
            n += 1
        return aggregate_epoch_metrics(_read_sums(sums, n))

    def _train_step_flops(self) -> float:
        return self.step_cache.entry_cost("train", self._train_key)["flops"]

    # -- main loop ----------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        if self.wstate is None:
            self.initialize()
        t0 = time.time()
        samples_done = 0
        step_s = []
        epoch = self.loader.epoch_number
        while not self.decision.complete:
            t_ep = time.time()
            train_mets = self._run_epoch_train(epoch)
            t_train = time.time()
            samples_done += int(train_mets.get("n_samples", 0))
            steps = train_mets.get("n_batches", 0.0)
            if steps:
                step_s.append((t_train - t_ep) / steps)
            goodput = epoch_goodput(self._train_step_flops(), steps,
                                    max(t_train - t_ep, 1e-9),
                                    resolve_peak_tflops(self.device))
            self._g_flops_sec.set(goodput["flops_per_sec"])
            self._g_mfu.set(goodput["mfu"])
            self._last_mfu = goodput["mfu"]
            self._check_anomalies(epoch, train_mets)
            valid_mets = self._run_epoch_eval(VALID, epoch)
            if root.common.timings:
                self.info("epoch %d timings: train %.3fs (%.0f samples/s), "
                          "eval %.3fs", epoch, t_train - t_ep,
                          train_mets.get("n_samples", 0.0)
                          / max(t_train - t_ep, 1e-9),
                          time.time() - t_train)
            stop = self.decision.on_epoch(epoch, train_mets, valid_mets)
            if self.status is not None:
                self.status.update(
                    epoch=epoch, best_value=self.decision.best_value,
                    best_epoch=self.decision.best_epoch,
                    train_mfu=round(goodput["mfu"], 4),
                    train_flops_per_sec=round(goodput["flops_per_sec"], 1),
                    anomaly_steps_skipped=self.anomaly_steps_skipped,
                    anomaly_rollbacks=self.anomaly_rollbacks,
                    snapshot_walkbacks=self.snapshot_walkbacks,
                    **{f"valid_{k}": v for k, v in valid_mets.items()})
            if self.decision.improved \
                    and (self.decision.rollback_after is not None
                         or self._anomaly_patience() > 0):
                self._best_wstate = self._host_state()
            if self.decision.want_rollback and self._best_wstate is not None:
                # rollback to the best state + lr drop, written into the
                # live tensors and the opt_state multiplier the train step
                # reads: no recapture
                self._write_state({"wstate": self._best_wstate})
                self._apply_lr_multiplier()
            # advance first so a restored snapshot resumes at the NEXT epoch
            self.loader.next_epoch()
            if (self.snapshotter is not None
                    and self.snapshotter.tick(best=self.decision.improved)):
                # collective under a placed state: every rank gathers
                payload = self._payload()
                if self.writes:
                    self.snapshotter.save(f"ep{epoch}", payload,
                                          best=self.decision.improved)
            epoch = self.loader.epoch_number
            if stop:
                break

        elapsed = time.time() - t0
        test_mets = self._run_epoch_eval(TEST, epoch)
        self.results = self.workflow.gather_results({
            "best_value": self.decision.best_value,
            "best_epoch": self.decision.best_epoch,
            "epochs": epoch,
            "elapsed_s": elapsed,
            "train_samples_per_s": samples_done / max(elapsed, 1e-9),
            # the median over epochs of the train-phase wall a step (the
            # batch assembly the step waits for included)
            "train_step_s_median": (float(np.median(step_s)) if step_s
                                    else None),
            "train_step_flops": self._train_step_flops(),
            # unrounded: a CPU run's MFU is tiny and must not round to 0
            "train_mfu": self._last_mfu,
            "peak_tflops": resolve_peak_tflops(self.device),
            "anomaly_steps_skipped": self.anomaly_steps_skipped,
            "anomaly_rollbacks": self.anomaly_rollbacks,
            "snapshot_walkbacks": self.snapshot_walkbacks,
            **{f"test_{k}": v for k, v in test_mets.items()},
        })
        return self.results

    @property
    def writes(self) -> bool:
        """True on the rank that writes snapshots and results: rank 0 of
        the process group (every rank without one)."""
        from ..parallel.distributed import host_index
        return host_index() == 0

    # -- anomaly sentinel escalation ------------------------------------------
    def _anomaly_patience(self) -> int:
        return int(root.common.train.get("anomaly_patience", 0) or 0)

    def _check_anomalies(self, epoch: int, train_mets: Dict[str, float]):
        """Count the steps the in-step guard skipped this epoch, and when
        the consecutive-anomaly counter of ``opt_state`` reaches
        ``root.common.train.anomaly_patience``, escalate
        (veles_tpu/runtime/trainer.py:539-579).  One device read an
        epoch, only with a patience set."""
        skipped = int(train_mets.get("anomaly_steps", 0))
        if skipped:
            self.anomaly_steps_skipped += skipped
            self._m_anom.inc(skipped)
            self.warning("epoch %d: %d anomalous step(s) skipped "
                         "(non-finite loss/grad norm)", epoch, skipped)
        patience = self._anomaly_patience()
        opt_state = (self.wstate or {}).get("opt_state")
        if patience <= 0 or not isinstance(opt_state, dict) \
                or ANOM_CONSEC_KEY not in opt_state:
            return
        consec = int(opt_state[ANOM_CONSEC_KEY])
        if consec >= patience:
            self._escalate_anomaly(epoch, consec)

    def _escalate_anomaly(self, epoch: int, consec: int) -> None:
        """Skipping alone cannot cure a run that keeps diverging: restore
        the best state (or the last snapshot, walking back past corrupt
        ones), scale the lr multiplier down and zero the consecutive
        counter (trainer.py:581-621).  Pure writes into the live tensors:
        no recapture."""
        self.anomaly_rollbacks += 1
        self._m_rollbacks.inc()
        dec = self.decision
        dec.lr_multiplier *= dec.rollback_lr_scale
        source = None
        if self._best_wstate is not None:
            self._write_state({"wstate": self._best_wstate})
            source = "in-memory best state"
        elif self.snapshotter is not None \
                and self.snapshotter.last_path is not None:
            payload, used, skipped = restore_with_walkback(
                self.snapshotter.last_path)
            self._note_walkback(skipped)
            self._adapt_reserved_opt_keys(payload)
            self._write_state(payload)
            source = used
        else:
            self.warning("anomaly escalation has no snapshot or best "
                         "state to roll back to; keeping current params")
        self._apply_lr_multiplier()
        opt_state = self.wstate.get("opt_state")
        if isinstance(opt_state, dict) and ANOM_CONSEC_KEY in opt_state:
            opt_state[ANOM_CONSEC_KEY].fill_(0)
        self.error(
            "anomaly escalation at epoch %d: %d consecutive anomalous "
            "steps >= patience %d — restored %s, lr multiplier now %g",
            epoch, consec, self._anomaly_patience(), source or "nothing",
            dec.lr_multiplier)

    def _note_walkback(self, skipped) -> None:
        if not skipped:
            return
        self.snapshot_walkbacks += len(skipped)
        self._m_walkbacks.inc(len(skipped))
        for s in skipped:
            self.warning("snapshot walk-back: skipped %s (%s)",
                         s["path"], s["reason"])

    # -- state writes, lr multiplier, payload, restore -----------------------
    def _write_state(self, payload: Dict[str, Any]) -> None:
        """``payload["wstate"]`` (host numpy, whole) checked against the
        live state's structure and written into its tensors in place,
        cut to this rank's blocks under a placed state."""
        if self.sharding is not None:
            payload = {**payload, "wstate": self.sharding.shard_state(
                payload["wstate"])}
        tree_assign(self.wstate, Snapshotter.restore_wstate(
            payload, like=self.wstate))

    def _host_state(self) -> Dict[str, Any]:
        """The whole state on the host (gathered under a placed state:
        collective, every rank calls it)."""
        if self.sharding is not None:
            return self.sharding.gather_state(self.wstate)
        return wstate_to_numpy(self.wstate)

    def _apply_lr_multiplier(self) -> None:
        """Write ``decision.lr_multiplier`` into the ``__lr_mult__``
        opt_state scalar the train step multiplies onto its schedule."""
        mult = float(getattr(self.decision, "lr_multiplier", 1.0))
        opt_state = self.wstate.get("opt_state")
        if not isinstance(opt_state, dict) or LR_MULT_KEY not in opt_state:
            if mult != 1.0:
                self.warning("optimizer state carries no %s slot; lr "
                             "multiplier %g NOT applied", LR_MULT_KEY, mult)
            return
        opt_state[LR_MULT_KEY].fill_(mult)

    def effective_lr(self, step: int = 0) -> float:
        """The learning rate the train step applies at ``step``: the base
        schedule times the rollback multiplier in opt_state."""
        lr = float(self.optimizer.schedule(step))
        opt_state = (self.wstate or {}).get("opt_state")
        if isinstance(opt_state, dict) and LR_MULT_KEY in opt_state:
            lr *= float(opt_state[LR_MULT_KEY])
        return lr

    def _payload(self) -> Dict[str, Any]:
        """The JAX ``Trainer``'s snapshot payload (trainer.py:682-690)."""
        return {
            "wstate": self._host_state(),
            "loader": self.loader.state(),
            "decision": self.decision.state(),
            "prng": prng.streams.state(),
            "config": root.to_dict(),
            "workflow_checksum": self.workflow.checksum(),
        }

    def _adapt_reserved_opt_keys(self, payload: Dict[str, Any]) -> None:
        """Inject the reserved opt_state scalars a snapshot lacks, and
        drop those the live state does not carry (trainer.py:692-708)."""
        saved = payload.get("wstate")
        live_os = (self.wstate or {}).get("opt_state")
        if not (isinstance(saved, dict) and isinstance(live_os, dict)
                and isinstance(saved.get("opt_state"), dict)):
            return
        saved_os = saved["opt_state"]
        for k, neutral in reserved_opt_neutral().items():
            if k in live_os and k not in saved_os:
                saved_os[k] = neutral
            elif k in saved_os and k not in live_os:
                del saved_os[k]

    def restore(self, path: str, *, force: bool = False) -> None:
        """Resume from a snapshot manifest of either package: a workflow
        checksum that differs is fatal unless ``force``; weights,
        optimizer state, loader, decision and PRNG streams are restored
        (into the live tensors: no recapture), then the decision's lr
        multiplier is re-applied.  A corrupt snapshot walks back to the
        newest valid one in its directory, each one skipped counted in
        ``snapshot_walkbacks``."""
        payload, used, skipped = restore_with_walkback(path)
        self._note_walkback(skipped)
        if skipped:
            self.warning("restoring %s instead of corrupt %s", used, path)
        if self.wstate is None:
            self.initialize()
        if payload.get("workflow_checksum") != self.workflow.checksum():
            msg = ("snapshot was taken from a different workflow "
                   f"(checksum {payload.get('workflow_checksum')!r} != "
                   f"{self.workflow.checksum()!r})")
            if not force:
                raise ValueError(msg + "; pass force=True to override")
            self.warning("%s — forcing restore", msg)
        self._adapt_reserved_opt_keys(payload)
        self._write_state(payload)
        self.loader.set_state(payload["loader"])
        self.decision.set_state(payload["decision"])
        prng.streams.set_state(payload["prng"])
        self._apply_lr_multiplier()


def _dtype(v) -> torch.dtype:
    if isinstance(v, torch.Tensor):
        return v.dtype
    return torch.from_numpy(np.asarray(v)[:0]).dtype
