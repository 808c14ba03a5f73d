"""Sequence model family: the induction-recall task and its loader
(counterpart of veles_tpu/models/lm.py; the data generators are copies,
so the same arguments give bit-identical data in both packages).

**SynthInduction** — each sample is a token sequence whose LAST token
repeats an earlier token; the label is the token that FOLLOWED that
earlier occurrence.  Bar: <= 5 % validation error (chance: 93.75 % error
at vocab=16).
"""

from __future__ import annotations

import numpy as np
import torch

from ..loader.base import TRAIN, VALID
from ..loader.fullbatch import FullBatchLoader
from ..units.base import Spec


def synth_induction(n_train: int = 20000, n_valid: int = 4000,
                    seq_len: int = 32, vocab: int = 16,
                    seed: int = 20260732):
    """Token sequences (n, T) int32 + labels (n,): induction recall."""
    rng = np.random.default_rng(seed)
    n = n_train + n_valid
    x = rng.integers(0, vocab, (n, seq_len)).astype(np.int32)
    # the trigger token appears at position p, its successor at p+1, and
    # again as the final token; the model must emit that successor
    p = rng.integers(0, seq_len - 2, n)
    rows = np.arange(n)
    trigger = x[rows, p]
    # make the trigger unique elsewhere: re-draw clashing positions with a
    # shifted value, which stays in-vocab and != trigger
    clash = x == trigger[:, None]
    x[clash] = (x[clash] + 1 + rng.integers(
        0, vocab - 1, int(clash.sum()))) % vocab
    x[rows, p] = trigger
    x[rows, -1] = trigger
    y = x[rows, p + 1].astype(np.int32)
    return (x[:n_train], y[:n_train], x[n_train:], y[n_train:])


def synth_repeat(n: int, seq_len: int, vocab: int, seed: int = 20260733):
    """Repeated-segment sequences: a random filler prefix, then a random
    segment ``u`` twice, its length (hence the repeat offset) varying per
    sample.  Returns (x, y, m): tokens, next-token labels, and the
    trainable-position mask (second copy only)."""
    rng = np.random.default_rng(seed)
    T = seq_len
    x = rng.integers(0, vocab, (n, T)).astype(np.int32)
    y = np.zeros((n, T), np.int32)
    m = np.zeros((n, T), np.float32)
    max_l = max(2, min(16, T // 4))
    lens = rng.integers(2, max_l + 1, n)
    for i in range(n):
        L = int(lens[i])
        a = int(rng.integers(0, T - 2 * L + 1))   # first-copy start
        u = x[i, a:a + L]
        x[i, T - L:] = u                          # tail copy
        y[i, :-1] = x[i, 1:]
        # the last position's induction answer: the token after the
        # source copy
        y[i, -1] = x[i, a + L] if a + L < T - L else u[0]
        m[i, T - L:] = 1.0
    return x, y, m


class InductionLoader(FullBatchLoader):
    """``per_position=True`` switches to next-token LM training: labels
    are the one-step shift and the loss is per-position CE.  The TRAIN
    split then mixes repeated-segment sequences (``synth_repeat``, mask on
    the predictable second copy) with trigger-task sequences supervised
    at the last position, while VALID keeps the trigger-recall task with
    the mask on only the last position, so ``error_pct`` still measures
    induction recall.  On the card the per-sample train masks are one
    more device-resident array, gathered with the rest."""

    def __init__(self, minibatch_size=100, n_train=20000, n_valid=4000,
                 seq_len=32, vocab=16, per_position=False,
                 repeat_fraction=0.5, data_seed=None, **kw):
        xt, yt, xv, yv = synth_induction(n_train, n_valid, seq_len, vocab)
        self.per_position = bool(per_position)
        self._train_mask = None
        if self.per_position:
            if not 0.0 <= float(repeat_fraction) <= 1.0:
                raise ValueError(
                    f"repeat_fraction={repeat_fraction} must be in [0, 1]")
            n_rep = int(n_train * float(repeat_fraction))
            xr, yr, mr = synth_repeat(
                n_rep, seq_len, vocab,
                **({"seed": int(data_seed)} if data_seed is not None
                   else {}))
            xg, yg = xt[:n_train - n_rep], yt[:n_train - n_rep]
            yg = np.concatenate([xg[:, 1:], yg[:, None]], axis=1)
            mg = np.zeros((len(xg), seq_len), np.float32)
            mg[:, -1] = 1.0
            xt = np.concatenate([xr, xg])
            yt = np.concatenate([yr, yg])
            self._train_mask = np.concatenate([mr, mg])
            yv = np.concatenate([xv[:, 1:], yv[:, None]], axis=1)
        super().__init__({TRAIN: xt, VALID: xv},
                         {TRAIN: yt, VALID: yv},
                         minibatch_size=minibatch_size, **kw)
        self.vocab = vocab
        self.seq_len = seq_len
        self._last = None

    def _upload(self):
        super()._upload()
        if self._train_mask is not None:
            # gathered with the class's other arrays, then folded into
            # @mask (gather_batch below)
            self._dev_data[TRAIN]["@rowmask"] = torch.from_numpy(
                self._train_mask).to(self.device)
            self._last = torch.zeros(self.seq_len, device=self.device)
            self._last[-1] = 1.0

    def make_batch(self, chunk, klass, **kw):
        batch = super().make_batch(chunk, klass, **kw)
        if not self.per_position or self.on_device:
            return batch
        pad = np.asarray(batch["@mask"], np.float32)  # (bs,)
        m = np.repeat(pad[:, None], self.seq_len, axis=1)
        if klass == TRAIN:
            m = m * self._train_mask[self.padded_index(chunk)]
        else:
            m[:, :-1] = 0.0  # metric = last-position recall only
        batch["@mask"] = m
        return batch

    def batch_specs(self, klass):
        out = super().batch_specs(klass)
        if self.per_position:
            out.pop("@rowmask", None)
            out["@mask"] = Spec(out["@input"].shape, torch.float32)
        return out

    def gather_batch(self, ref, out=None):
        """Per position, ``@mask`` = the padding row mask times the
        gathered per-sample train mask (train) or the last position only
        (valid): one gather launch and one product."""
        if not self.per_position:
            return super().gather_batch(ref, out)
        out = out or {}
        batch = super().gather_batch(
            ref, {k: v for k, v in out.items() if k != "@mask"})
        pad = batch.pop("@mask")[:, None]
        rows = batch.pop("@rowmask") if ref.klass == TRAIN else self._last
        batch["@mask"] = torch.mul(pad, rows, out=out.get("@mask"))
        return batch


INDUCTION_CONFIG = {
    "name": "InductionLM",
    "layers": [
        {"type": "embedding", "vocab": 16, "dim": 64, "name": "emb"},
        {"type": "attention", "n_heads": 4, "rope": True,
         "residual": True, "name": "attn1"},
        {"type": "attention", "n_heads": 4, "rope": True,
         "residual": True, "name": "attn2"},
        {"type": "seq_last", "name": "last"},
        {"type": "softmax", "output_size": 16, "name": "out"},
    ],
    "loss": "softmax",
    "optimizer": "adam",
    "optimizer_args": {"lr": 1e-3},
    "max_epochs": 25,
    "fail_iterations": 25,
}
