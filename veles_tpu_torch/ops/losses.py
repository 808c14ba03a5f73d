"""Loss ops (counterpart of veles_tpu/ops/losses.py): softmax
cross-entropy and MSE, computed in float32."""

from __future__ import annotations

import torch


def softmax_cross_entropy(logits, labels, *, mask=None):
    """Mean CE over the batch (or positions); labels are integer class
    ids.  Returns (loss, n_err): n_err counts the argmax misses (the
    Decision's per-minibatch error count).  With ``mask`` the mean and
    the count are over the masked entries."""
    logits = logits.float()
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    err = (logits.argmax(-1) != labels).float()
    if mask is not None:
        denom = torch.clamp_min(mask.sum(), 1.0)
        return (ce * mask).sum() / denom, (err * mask).sum()
    return ce.mean(), err.sum()


def mse_loss(output, target, *, mask=None, root_flag=False):
    """Mean squared error; returns (loss, sum of per-sample mean squared
    errors) so RMSE aggregates per epoch."""
    output = output.float()
    target = target.float()
    diff = output.reshape(output.shape[0], -1) - target.reshape(
        target.shape[0], -1)
    per_sample = torch.mean(torch.square(diff), dim=-1)
    if mask is not None:
        denom = torch.clamp_min(mask.sum(), 1.0)
        loss = (per_sample * mask).sum() / denom
        agg = (per_sample * mask).sum()
    else:
        loss = per_sample.mean()
        agg = per_sample.sum()
    if root_flag:
        loss = torch.sqrt(loss)
    return loss, agg
