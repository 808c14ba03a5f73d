"""Optimizers (counterpart of veles_tpu/ops/optimizers.py): SGD with
momentum, AdaGrad, AdaDelta, Adam and AdamW, learning-rate policies,
L1/L2 regularization and per-unit hyperparameter overrides.

Written, as in the JAX package, as functions over an explicit state tree
(not ``torch.optim``): ``state = opt.init(params)`` and ``params, state =
opt.update(grads, state, params, step)`` return new trees, so the state
flattens to the JAX package's snapshot keys (Adam's slot stays ``(m, v,
t)`` with a per-leaf scalar ``t``) and moves between the packages.  The
workflow's train step copies the results into its tensors in place.

All update math runs in float32 on the parameters' device; the learning
rate is a float32 scalar tensor there (the train step passes its own,
which the host fills from ``schedule(step)`` before each step, so a
captured step reads the new value on every replay), and the reserved
``opt_state`` scalars (the rollback lr multiplier and the anomaly
counters) are device tensors too, so nothing in a step reads a value back
to the host.  :func:`tree_assign` writes a result tree into the live
state's tensors in place, the one way the train step, rollback and
restore change the state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


# -- learning-rate policies: step (int) -> float32 ---------------------------

def fixed_lr(base: float) -> Callable[[int], np.float32]:
    return lambda step: np.float32(base)


def exp_decay_lr(base: float, gamma: float, step_size: int = 1):
    """lr = base * gamma^(step // step_size)."""
    return lambda step: np.float32(base) * np.power(
        np.float32(gamma), np.float32(step // step_size))


def inv_lr(base: float, gamma: float, power: float = 1.0):
    """lr = base / (1 + gamma*step)^power (caffe 'inv' policy)."""
    return lambda step: np.float32(base) * np.power(
        np.float32(1.0) + np.float32(gamma) * np.float32(step),
        np.float32(-power))


def warmup_cosine_lr(base: float, warmup_steps: int, total_steps: int,
                     final_scale: float = 0.0):
    """Linear warmup to ``base`` over ``warmup_steps``, then cosine decay
    to ``final_scale * base`` at ``total_steps``."""
    w = np.float32(max(warmup_steps, 1))
    span = np.float32(max(total_steps - warmup_steps, 1))
    f32 = np.float32

    def f(step):
        s = f32(step)
        if s < warmup_steps:
            return f32(base) * (s / w)
        prog = np.clip((s - f32(warmup_steps)) / span, f32(0), f32(1))
        cos = f32(final_scale) + (f32(1) - f32(final_scale)) * f32(0.5) * (
            f32(1) + np.cos(f32(np.pi) * prog))
        return f32(base) * cos

    return f


def step_lr(base: float, boundaries, values):
    """Piecewise-constant schedule."""
    bounds = np.asarray(boundaries)
    vals = np.asarray([base] + list(values), np.float32)
    return lambda step: vals[np.searchsorted(bounds, step, side="right")]


LR_POLICIES = {
    "fixed": fixed_lr,
    "exp": exp_decay_lr,
    "inv": inv_lr,
    "step": step_lr,
    "warmup_cosine": warmup_cosine_lr,
}

#: Reserved opt_state scalars (the JAX package's names): the cumulative
#: rollback lr multiplier, the total of updates skipped on a non-finite
#: loss or gradient norm, and the current run of consecutive skips.
LR_MULT_KEY = "__lr_mult__"
ANOM_SKIP_KEY = "__anom_skipped__"
ANOM_CONSEC_KEY = "__anom_consec__"


def reserved_opt_neutral():
    """The reserved scalars' fresh values (host numpy), the table a
    restore walks to adapt snapshots that lack or carry extra slots."""
    return {LR_MULT_KEY: np.ones((), np.float32),
            ANOM_SKIP_KEY: np.zeros((), np.int32),
            ANOM_CONSEC_KEY: np.zeros((), np.int32)}


def tree_leaves(tree):
    """Leaves of a nested dict/tuple/list tree, in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of same-structure trees, visited in
    :func:`tree_leaves` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_assign(dst, src, path: str = ""):
    """Write ``src``'s leaves into ``dst``'s tensors in place and return
    ``dst``: a tensor leaf is ``copy_``-ed (dtype cast as ``.to`` casts;
    numpy leaves are taken on the host first), a dict gains the keys of
    ``src`` it lacks, and a dict entry that holds no tensor (the state's
    step, its host key) is replaced.  The tensors a captured step reads
    stay the same objects, so a ``src`` that does not fit them (another
    shape or structure, e.g. a snapshot of another width) raises
    ``ValueError`` naming the path instead of rebinding them."""
    if isinstance(dst, dict):
        if not isinstance(src, dict):
            raise ValueError(f"state at {path or '/'} is a dict; cannot "
                             f"write a {type(src).__name__} into it")
        for k, v in src.items():
            if k in dst and _holds_tensor(dst[k]):
                tree_assign(dst[k], v, f"{path}/{k}")
            else:
                dst[k] = v
        return dst
    if isinstance(dst, (list, tuple)):
        if not isinstance(src, (list, tuple)) or len(src) != len(dst):
            raise ValueError(f"state at {path or '/'} holds {len(dst)} "
                             f"leaves; cannot write {src!r:.60} into it")
        for i, (d, v) in enumerate(zip(dst, src)):
            tree_assign(d, v, f"{path}/{i}")
        return dst
    if tuple(np.shape(src)) != tuple(dst.shape):
        raise ValueError(f"state tensor {path or '/'} has shape "
                         f"{tuple(dst.shape)}; cannot write shape "
                         f"{tuple(np.shape(src))} into it in place")
    dst.copy_(src if torch.is_tensor(src)
              else torch.from_numpy(np.asarray(src)))
    return dst


def _holds_tensor(tree) -> bool:
    return any(torch.is_tensor(x) for x in tree_leaves(tree))


def global_grad_norm(grads) -> torch.Tensor:
    """float32 global L2 norm over every gradient leaf."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads)) + 1e-12)


def tree_select(ok, new_tree, old_tree):
    """``torch.where(ok, new, old)`` over two same-structure trees: the
    anomaly guard's skip, a device-side select with no host read."""
    return tree_map(lambda n, o: torch.where(ok, n, o), new_tree, old_tree)


def guarded_update(optimizer: "Optimizer", grads, opt_state, params, step,
                   loss, *, clip_norm: float = 0.0, sentinel: bool = True,
                   lr=None, inject_nan=None, norm=None):
    """Anomaly-guarded optimizer update (veles_tpu/ops/optimizers.py:
    134-197): runs ``optimizer.update`` and, with ``sentinel`` on, keeps
    the old params and slots where the loss or the gradients' global norm
    is not finite, advancing ``ANOM_SKIP_KEY``/``ANOM_CONSEC_KEY``.
    ``clip_norm > 0`` rescales the gradients to that global norm first.
    ``lr`` (a float32 device scalar) replaces ``schedule(step)``;
    ``inject_nan`` (a bool device scalar, the fault harness's
    ``nan_grad_at_step``) poisons every floating gradient with NaN where
    it is true.  ``norm(grads, path)``: the global norm of a gradient
    (sub)tree at ``path`` in the params tree (default
    :func:`global_grad_norm`); a sharded state passes its norm over all
    ranks' blocks (``parallel.fsdp.ShardedState.grad_norm``), so every
    rank clips and skips alike.  Returns ``(params, opt_state, ok,
    gnorm)``; ``ok``/``gnorm`` are ``None`` where that machinery is
    off."""
    if inject_nan is not None:
        grads = tree_map(
            lambda g: torch.where(inject_nan, torch.full(
                (), float("nan"), dtype=g.dtype, device=g.device), g)
            if g.is_floating_point() else g, grads)
    clip_norm = float(clip_norm or 0.0)
    if not sentinel and clip_norm <= 0.0:
        p, s = optimizer.update(grads, opt_state, params, step, lr=lr,
                                norm=norm)
        return p, s, None, None
    gnorm = global_grad_norm(grads) if norm is None else norm(grads, ())
    if clip_norm > 0.0:
        scale = torch.clamp_max(clip_norm / gnorm, 1.0)
        grads = tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)
    new_params, new_opt = optimizer.update(grads, opt_state, params, step,
                                           lr=lr, norm=norm)
    if not sentinel:
        return new_params, new_opt, None, gnorm
    ok = torch.isfinite(loss.float()) & torch.isfinite(gnorm)
    sel_params = tree_select(ok, new_params, params)
    sel_opt = {k: (tree_select(ok, v, opt_state[k]) if k in opt_state
                   else v)
               for k, v in new_opt.items()}
    if ANOM_SKIP_KEY in opt_state:
        sel_opt[ANOM_SKIP_KEY] = opt_state[ANOM_SKIP_KEY] + (~ok).int()
        sel_opt[ANOM_CONSEC_KEY] = torch.where(
            ok, torch.zeros_like(opt_state[ANOM_CONSEC_KEY]),
            opt_state[ANOM_CONSEC_KEY] + 1)
    return sel_params, sel_opt, ok, gnorm


@dataclasses.dataclass(frozen=True)
class HyperParams:
    """Per-layer knobs; ``None`` inherits the optimizer-wide value (so an
    explicit 0.0 disables that term for the layer)."""
    lr_scale: float = 1.0
    bias_lr_scale: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    momentum: Optional[float] = None
    clip_norm: Optional[float] = None


class Optimizer:
    """Functional optimizer over the workflow's nested
    ``{unit: {param: tensor}}`` dict; per-unit overrides by unit name."""

    def __init__(self, lr=0.01, *, lr_policy: Callable = None,
                 momentum: float = 0.0, l1: float = 0.0, l2: float = 0.0,
                 clip_norm: Optional[float] = None,
                 per_unit: Optional[Dict[str, HyperParams]] = None):
        self.schedule = lr_policy if lr_policy is not None else fixed_lr(lr)
        self.momentum = momentum
        self.l1 = l1
        self.l2 = l2
        self.clip_norm = clip_norm
        self.per_unit = dict(per_unit or {})

    # -- override in subclasses --------------------------------------------
    def init_slot(self, p) -> Any:
        return ()

    def apply_slot(self, g, slot, lr, hp, param=None) -> tuple:
        """Return (delta, new_slot); delta is subtracted from the param.
        ``param`` is the float32 master weight (AdamW reads it)."""
        raise NotImplementedError

    # -- shared update ------------------------------------------------------
    def init(self, params) -> dict:
        state = tree_map(self.init_slot, params)
        dev = tree_leaves(params)[0].device if params else "cpu"
        state[LR_MULT_KEY] = torch.ones((), dtype=torch.float32, device=dev)
        state[ANOM_SKIP_KEY] = torch.zeros((), dtype=torch.int32, device=dev)
        state[ANOM_CONSEC_KEY] = torch.zeros((), dtype=torch.int32,
                                             device=dev)
        return state

    def _hp(self, unit_name: str) -> HyperParams:
        return self.per_unit.get(unit_name, HyperParams())

    def update(self, grads, state, params, step, *, lr=None, norm=None):
        """``lr``: the float32 device scalar of ``schedule(step)`` (the
        train step's); None computes it here.  ``norm(grads, path)``:
        the global norm of a gradient (sub)tree (``guarded_update``)."""
        if norm is None:
            def norm(g, path):
                return global_grad_norm(g)
        if lr is None:
            lr = torch.full((), float(self.schedule(step)),
                            dtype=torch.float32,
                            device=tree_leaves(params)[0].device)
        lr_mult = state.get(LR_MULT_KEY)
        if lr_mult is not None:
            lr = lr * lr_mult
        if self.clip_norm is not None:
            scale = torch.clamp_max(self.clip_norm / norm(grads, ()), 1.0)
            grads = tree_map(lambda g: g * scale, grads)
        new_params, new_state = {}, {}
        for k in (LR_MULT_KEY, ANOM_SKIP_KEY, ANOM_CONSEC_KEY):
            if k in state:
                new_state[k] = state[k]
        for uname, uparams in params.items():
            hp = self._hp(uname)
            ugrads = grads[uname]
            uscale = None
            if hp.clip_norm is not None:
                uscale = torch.clamp_max(
                    hp.clip_norm / norm(ugrads, (uname,)), 1.0)
            new_params[uname], new_state[uname] = self._update_tree(
                uparams, ugrads, state.get(uname) or {}, hp, lr, uscale)
        return new_params, new_state

    def _update_tree(self, uparams, ugrads, ustate, hp, lr, uscale):
        """Leaf update over a unit's (possibly nested) param dict; slots
        mirror its structure and a missing slot starts fresh."""
        np_, ns_ = {}, {}
        for pname, p in uparams.items():
            if isinstance(p, dict):
                sub = ustate.get(pname)
                np_[pname], ns_[pname] = self._update_tree(
                    p, ugrads[pname], sub if isinstance(sub, dict) else {},
                    hp, lr, uscale)
                continue
            g = ugrads[pname].float()
            if uscale is not None:
                g = g * uscale
            p32 = p.float()
            l1 = hp.l1 if hp.l1 is not None else self.l1
            l2 = hp.l2 if hp.l2 is not None else self.l2
            if l2:
                g = g + l2 * p32
            if l1:
                g = g + l1 * torch.sign(p32)
            scale = hp.lr_scale
            if pname == "b" and hp.bias_lr_scale is not None:
                scale = hp.bias_lr_scale
            slot0 = ustate.get(pname)
            if slot0 is None:
                slot0 = self.init_slot(p)
            delta, slot = self.apply_slot(g, slot0, lr * scale, hp,
                                          param=p32)
            np_[pname] = (p32 - delta).to(p.dtype)
            ns_[pname] = slot
        return np_, ns_


def _zeros(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


class SGD(Optimizer):
    """SGD with classical momentum.  Velocity slots exist when the global
    or any per-unit momentum is nonzero."""

    def _uses_momentum(self) -> bool:
        return bool(self.momentum) or any(
            hp.momentum for hp in self.per_unit.values()
            if hp.momentum is not None)

    def init_slot(self, p):
        return _zeros(p) if self._uses_momentum() else ()

    def apply_slot(self, g, slot, lr, hp, param=None):
        mom = hp.momentum if hp.momentum is not None else self.momentum
        if isinstance(slot, tuple):  # no velocity allocated
            return lr * g, ()
        v = mom * slot + g
        return lr * v, v


class AdaGrad(Optimizer):
    def __init__(self, lr=0.01, eps=1e-8, **kw):
        super().__init__(lr, **kw)
        self.eps = eps

    def init_slot(self, p):
        return _zeros(p)

    def apply_slot(self, g, slot, lr, hp, param=None):
        acc = slot + torch.square(g)
        return lr * g / (torch.sqrt(acc) + self.eps), acc


class AdaDelta(Optimizer):
    def __init__(self, lr=1.0, rho=0.95, eps=1e-6, **kw):
        super().__init__(lr, **kw)
        self.rho = rho
        self.eps = eps

    def init_slot(self, p):
        return (_zeros(p), _zeros(p))

    def apply_slot(self, g, slot, lr, hp, param=None):
        acc_g, acc_d = slot
        acc_g = self.rho * acc_g + (1 - self.rho) * torch.square(g)
        delta = g * torch.sqrt(acc_d + self.eps) / torch.sqrt(acc_g
                                                              + self.eps)
        acc_d = self.rho * acc_d + (1 - self.rho) * torch.square(delta)
        return lr * delta, (acc_g, acc_d)


class Adam(Optimizer):
    def __init__(self, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, **kw):
        super().__init__(lr, **kw)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init_slot(self, p):
        return (_zeros(p), _zeros(p),
                torch.zeros((), dtype=torch.float32, device=p.device))

    def apply_slot(self, g, slot, lr, hp, param=None):
        m, v, t = slot
        t = t + 1
        m = self.b1 * m + (1 - self.b1) * g
        v = self.b2 * v + (1 - self.b2) * torch.square(g)
        mhat = m / (1 - torch.pow(self.b1, t))
        vhat = v / (1 - torch.pow(self.b2, t))
        return lr * mhat / (torch.sqrt(vhat) + self.eps), (m, v, t)


class AdamW(Adam):
    """Adam with decoupled weight decay; ``l2`` (coupled decay through the
    gradient) is refused."""

    def __init__(self, lr=1e-3, weight_decay: float = 0.01, **kw):
        if kw.get("l2"):
            raise ValueError(
                "AdamW takes decoupled weight_decay=, not l2 (which "
                "would couple the decay through the adaptive moments)")
        coupled = [n for n, hp in (kw.get("per_unit") or {}).items()
                   if hp.l2]
        if coupled:
            raise ValueError(
                f"per-unit hyperparams l2 on {coupled} would apply "
                "COUPLED decay under AdamW; use the optimizer-wide "
                "weight_decay (or switch those layers to Adam + l2)")
        super().__init__(lr, **kw)
        self.weight_decay = float(weight_decay)

    def apply_slot(self, g, slot, lr, hp, param=None):
        delta, slot = super().apply_slot(g, slot, lr, hp)
        return delta + lr * self.weight_decay * param, slot


OPTIMIZERS = {
    "sgd": SGD,
    "momentum": lambda lr=0.01, **kw: SGD(lr, momentum=kw.pop("momentum",
                                                               0.9), **kw),
    "adagrad": AdaGrad,
    "adadelta": AdaDelta,
    "adam": Adam,
    "adamw": AdamW,
}
