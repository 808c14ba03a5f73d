"""Trainer: the host-side epoch loop tying loader + workflow + decision +
snapshotter together (counterpart of veles_tpu/runtime/trainer.py:57-537
and :674-743).

Every step runs the workflow's eager train step on the device; the
per-epoch metric sums stay there as tensors and are read back once per
epoch.  A worker thread assembles the next batches (the fullbatch
loader's gather kernel, or a host batch and its copy to the device)
while the current step runs.  The Decision's rollback restores the best
state and scales the learning rate through the ``__lr_mult__`` scalar of
``opt_state``; snapshots carry the JAX ``Trainer``'s payload, so a run
resumes in either package.

Left out here (ROADMAP.md, slice 3): escalation to a rollback after
consecutive anomalous steps, the snapshot walk-back, the step cache, the
goodput/MFU gauges, the metrics registry, the memory ledger, and the
mesh, multi-host and pipeline schedules.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import prng
from ..config import root
from ..loader.base import TEST, TRAIN, VALID, Loader
from ..logger import Logger
from ..ops import resolve_device
from ..ops.optimizers import LR_MULT_KEY, Optimizer, reserved_opt_neutral
from ..units.base import Spec
from ..units.workflow import Workflow
from .decision import Decision
from .snapshotter import Snapshotter, wstate_to_numpy


def aggregate_epoch_metrics(sums: Dict[str, float]) -> Dict[str, float]:
    """Epoch sums -> error % / loss / grad norm per trained batch
    (trainer.py:38-54; the rmse of the MSE evaluators comes with them)."""
    n = max(sums.get("n_samples", 0.0), 1.0)
    out = dict(sums)
    if "n_err" in sums:
        out["error_pct"] = 100.0 * sums["n_err"] / n
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
                 prefetch: int = 2, device=None):
        self.workflow = workflow
        self.loader = loader
        self.optimizer = optimizer
        self.decision = decision or Decision(max_epochs=10)
        self.snapshotter = snapshotter
        self.prefetch = prefetch  # batches assembled ahead (0 = inline)
        self.device = resolve_device(device)
        self.wstate = None
        self._train_step = None
        self._eval_step = None
        self._best_wstate = None
        self.results: Dict[str, Any] = {}
        self.anomaly_steps_skipped = 0
        self.anomaly_rollbacks = 0

    # -- setup -------------------------------------------------------------
    def initialize(self, seed: Optional[int] = None,
                   wstate: Optional[dict] = None) -> None:
        """Build the workflow from the first batch's shapes and make the
        state: ``wstate`` as given, else fresh weights seeded from
        ``seed`` or the ``"init"`` PRNG stream."""
        self.loader.initialize()
        batch = next(self.loader.iter_epoch(
            TRAIN if self.loader.class_lengths[TRAIN] else VALID))
        self.workflow.build({k: Spec(tuple(v.shape), _dtype(v))
                             for k, v in batch.items()})
        if wstate is not None:
            self.wstate = wstate
        else:
            if seed is None:
                seed = prng.get("init").next_seed() & 0x7FFFFFFF
            self.wstate = self.workflow.init_state(seed, self.optimizer,
                                                   self.device)
        self._train_step = self.workflow.make_train_step(self.optimizer)
        self._eval_step = self.workflow.make_eval_step()
        self.info("workflow %s: %d params", self.workflow.name,
                  self.workflow.n_params(self.wstate))

    # -- epoch passes -------------------------------------------------------
    def _place_batch(self, batch):
        """Host (numpy) arrays to tensors on the trainer's device;
        tensors already there pass through."""
        return {k: (v if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.asarray(v))).to(self.device)
                for k, v in batch.items()}

    def _batches(self, klass: int, epoch):
        """Device-placed batch stream; with ``prefetch`` > 0 a worker
        thread assembles up to ``prefetch`` batches ahead of the step
        (its launches share the default stream with the step's, so they
        run in order)."""
        it = self.loader.iter_epoch(klass, epoch)
        if self.prefetch <= 0:
            for item in it:
                yield self._place_batch(item)
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
                    if not put(self._place_batch(item)):
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
        for batch in self._batches(TRAIN, epoch):
            self.wstate, mets = self._train_step(self.wstate, batch)
            # summed on the device: no host read per step
            for k, v in mets.items():
                sums[k] = sums[k] + v if k in sums else v
            n += 1
        return aggregate_epoch_metrics(_read_sums(sums, n))

    def _run_epoch_eval(self, klass: int, epoch: int) -> Dict[str, float]:
        if self.loader.class_lengths[klass] == 0:
            return {}
        sums: Dict[str, Any] = {}
        n = 0
        for batch in self._batches(klass, epoch):
            mets = self._eval_step(self.wstate, batch)
            for k, v in mets.items():
                sums[k] = sums[k] + v if k in sums else v
            n += 1
        return aggregate_epoch_metrics(_read_sums(sums, n))

    # -- main loop ----------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        if self.wstate is None:
            self.initialize()
        t0 = time.time()
        samples_done = 0
        epoch = self.loader.epoch_number
        while not self.decision.complete:
            t_ep = time.time()
            train_mets = self._run_epoch_train(epoch)
            t_train = time.time()
            samples_done += int(train_mets.get("n_samples", 0))
            self._check_anomalies(epoch, train_mets)
            valid_mets = self._run_epoch_eval(VALID, epoch)
            if root.common.timings:
                self.info("epoch %d timings: train %.3fs (%.0f samples/s), "
                          "eval %.3fs", epoch, t_train - t_ep,
                          train_mets.get("n_samples", 0.0)
                          / max(t_train - t_ep, 1e-9),
                          time.time() - t_train)
            stop = self.decision.on_epoch(epoch, train_mets, valid_mets)
            if self.decision.improved \
                    and self.decision.rollback_after is not None:
                self._best_wstate = wstate_to_numpy(self.wstate)
            if self.decision.want_rollback and self._best_wstate is not None:
                # rollback to the best state + lr drop, written into the
                # opt_state multiplier the train step reads
                self.wstate = Snapshotter.restore_wstate(
                    {"wstate": self._best_wstate}, like=self.wstate)
                self.wstate = self._apply_lr_multiplier(self.wstate)
            # advance first so a restored snapshot resumes at the NEXT epoch
            self.loader.next_epoch()
            if (self.snapshotter is not None
                    and self.snapshotter.tick(best=self.decision.improved)):
                self.snapshotter.save(f"ep{epoch}", self._payload(),
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
            "anomaly_steps_skipped": self.anomaly_steps_skipped,
            "anomaly_rollbacks": self.anomaly_rollbacks,
            **{f"test_{k}": v for k, v in test_mets.items()},
        })
        return self.results

    def _check_anomalies(self, epoch: int, train_mets: Dict[str, float]):
        """Count the steps the in-step guard skipped this epoch."""
        skipped = int(train_mets.get("anomaly_steps", 0))
        if skipped:
            self.anomaly_steps_skipped += skipped
            self.warning("epoch %d: %d anomalous step(s) skipped "
                         "(non-finite loss/grad norm)", epoch, skipped)

    # -- lr multiplier, payload, restore -------------------------------------
    def _apply_lr_multiplier(self, wstate):
        """Write ``decision.lr_multiplier`` into the ``__lr_mult__``
        opt_state scalar the train step multiplies onto its schedule."""
        mult = float(getattr(self.decision, "lr_multiplier", 1.0))
        opt_state = wstate.get("opt_state")
        if not isinstance(opt_state, dict) or LR_MULT_KEY not in opt_state:
            if mult != 1.0:
                self.warning("optimizer state carries no %s slot; lr "
                             "multiplier %g NOT applied", LR_MULT_KEY, mult)
            return wstate
        opt_state[LR_MULT_KEY] = torch.full(
            (), mult, dtype=torch.float32,
            device=opt_state[LR_MULT_KEY].device)
        return wstate

    def _payload(self) -> Dict[str, Any]:
        """The JAX ``Trainer``'s snapshot payload (trainer.py:682-690)."""
        return {
            "wstate": wstate_to_numpy(self.wstate),
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
        optimizer state, loader, decision and PRNG streams are restored,
        then the decision's lr multiplier is re-applied."""
        payload = Snapshotter.load(path)
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
        self.wstate = Snapshotter.restore_wstate(payload, like=self.wstate)
        self.loader.set_state(payload["loader"])
        self.decision.set_state(payload["decision"])
        prng.streams.set_state(payload["prng"])
        self.wstate = self._apply_lr_multiplier(self.wstate)


def _dtype(v) -> torch.dtype:
    if isinstance(v, torch.Tensor):
        return v.dtype
    return torch.from_numpy(np.asarray(v)[:0]).dtype
