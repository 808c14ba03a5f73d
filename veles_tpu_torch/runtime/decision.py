"""Decision: epoch-level training control (a copy of
veles_tpu/runtime/decision.py, which holds no JAX).

Reference parity: the Znicz Decision unit (reference: docs
manualrst_veles_units.rst; SURVEY.md §2.10) tracked train/valid errors per
epoch, decided when to stop, and owned the "best snapshot" notion, including
"rollback to best snapshot on failure + lr change"
(manualrst_veles_algorithms.rst:164 item 11).

In the rebuild this is host-side loop control (the one place data-dependent
control flow belongs — outside jit)."""

from __future__ import annotations

import math
from typing import Dict, Optional

from ..logger import Logger


class Decision(Logger):
    """Tracks epoch metrics, detects improvement, decides stop/rollback.

    * ``max_epochs`` — hard epoch budget (None = unlimited).
    * ``fail_iterations`` — stop after this many epochs without validation
      improvement (reference Decision semantic).
    * ``metric`` — key into the aggregated epoch metrics; lower is better
      (error %, loss, rmse).
    * ``rollback_after`` — if set, request a rollback to the best state after
      this many non-improving epochs, multiplying lr by ``rollback_lr_scale``
      (reference item 11).
    """

    def __init__(self, max_epochs: Optional[int] = None,
                 fail_iterations: int = 50, metric: str = "error_pct",
                 rollback_after: Optional[int] = None,
                 rollback_lr_scale: float = 0.5):
        self.max_epochs = max_epochs
        self.fail_iterations = fail_iterations
        self.metric = metric
        self.rollback_after = rollback_after
        self.rollback_lr_scale = rollback_lr_scale

        self.best_value = math.inf
        self.best_epoch = -1
        self.epochs_since_improvement = 0
        self.complete = False
        self.improved = False
        self.want_rollback = False
        self.lr_multiplier = 1.0
        self._gauge_key = metric
        self.history: list = []

    def on_epoch(self, epoch: int, train_metrics: Dict[str, float],
                 valid_metrics: Dict[str, float]) -> bool:
        """Feed epoch results; returns True when training should stop."""
        gauge = valid_metrics if valid_metrics else train_metrics
        # fall back classification -> regression -> raw loss, and report
        # the key actually used (an MSE workflow's gauge is its RMSE, not
        # a metric labeled "error_pct")
        used = self.metric
        value = gauge.get(used)
        if value is None:
            for used in ("rmse", "loss"):
                if used in gauge:
                    value = gauge[used]
                    break
            else:
                used, value = "loss", math.inf
        self._gauge_key = used
        self.history.append(
            {"epoch": epoch, "train": dict(train_metrics),
             "valid": dict(valid_metrics), "value": value,
             "metric": used})

        self.improved = value < self.best_value
        self.want_rollback = False
        if self.improved:
            self.best_value = value
            self.best_epoch = epoch
            self.epochs_since_improvement = 0
        else:
            self.epochs_since_improvement += 1
            if (self.rollback_after is not None
                    and self.epochs_since_improvement > 0
                    and self.epochs_since_improvement
                    % self.rollback_after == 0):
                self.want_rollback = True
                self.lr_multiplier *= self.rollback_lr_scale
                self.info("rollback requested at epoch %d (lr ×%g)",
                          epoch, self.lr_multiplier)

        self.info("epoch %d: %s=%.4f (best %.4f @ %d)%s", epoch,
                  self._gauge_key, value, self.best_value, self.best_epoch,
                  " *" if self.improved else "")

        if self.max_epochs is not None and epoch + 1 >= self.max_epochs:
            self.complete = True
        if self.epochs_since_improvement >= self.fail_iterations:
            self.info("no improvement for %d epochs — stopping",
                      self.epochs_since_improvement)
            self.complete = True
        return self.complete

    #: config knobs belong to the CURRENT run's config — restoring them
    #: from a snapshot would silently pin a resumed run to the ORIGINAL
    #: run's settings (observed: a curriculum fine-tune with
    #: max_epochs=330 stopping at the phase-1 budget of 170). Progress
    #: fields (best_value, epochs_since_improvement, lr_multiplier...)
    #: DO restore.
    _CONFIG_KEYS = ("max_epochs", "fail_iterations", "metric",
                    "rollback_after", "rollback_lr_scale")

    def state(self) -> dict:
        return {k: v for k, v in vars(self).items() if not k.startswith("_")}

    def set_state(self, st: dict) -> None:
        # ``complete`` is derived from progress vs budget: keep it only
        # when the budget is unchanged (plain resume of a finished run
        # exits immediately); under a NEW budget it must be recomputed,
        # i.e. training continues.
        same_budget = (st.get("max_epochs") == self.max_epochs and
                       st.get("fail_iterations") == self.fail_iterations)
        for k, v in st.items():
            if k in self._CONFIG_KEYS or (k == "complete"
                                          and not same_budget):
                continue
            setattr(self, k, v)
        if "metric" in st and st["metric"] != self.metric:
            # best_value is in the SAVED metric's units; comparing the
            # current metric against it would freeze/poison improvement
            # tracking — start the gauge fresh under the new metric
            self.best_value = float("inf")
            self.best_epoch = -1
            self.epochs_since_improvement = 0
