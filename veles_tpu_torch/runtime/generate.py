"""Autoregressive decoding with a per-layer KV cache (counterpart of
veles_tpu/runtime/generate.py:119-545).

``DecodePlan`` classifies a linear unit chain into cached-attention,
pointwise and head segments; its ``step`` advances one position, on the
dense ``(B, L, Hk, Dh)`` cache or on the engine's paged pool.  The caches
are updated IN PLACE (the JAX package returns new arrays; PyTorch saves
the copy).  ``generate`` prefills the prompt through the same step
(teacher-forced) and decodes greedily or by temperature sampling with
optional top-k / top-p.

Sampling draws Gumbel noise from an explicit ``torch.Generator`` seeded
by ``fold_seed(seed, position)`` per row, so a stream depends only on
(seed, position): the engine and ``generate`` give the same sampled
tokens for the same seed.  The numbers cannot match the JAX package's
threefry streams; greedy tokens are what the two packages share.

Recurrent, mixture-of-experts and pipeline-stack units come with later
slices of the port (ROADMAP.md); a chain holding one raises.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.activations import rope_inv_freq, rotary_embedding, rotate_pairs
from ..ops.kernels.paged_attention import paged_attention_decode
from ..units import nn
from ..units.base import Context
from ..units.parallel_nn import MultiHeadAttention
from ..units.workflow import WorkflowError

_MASK64 = (1 << 64) - 1


def fold_seed(seed: int, value: int) -> int:
    """Deterministic 63-bit mix of (seed, value) — splitmix64 over the
    pair; the port's counterpart of ``jax.random.fold_in``."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(value) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def _attn_cache_init(u, params, B: int, L: int, dtype, device, *,
                     kv_rows: Optional[int] = None,
                     page_size: Optional[int] = None) -> dict:
    """Dense per-slot KV rows (B, L, Hk, Dh), or the paged pool
    (kv_rows, page_size, Hk, Dh) when ``kv_rows``/``page_size`` are given
    (the last pool row is the scratch page)."""
    Dh = params["wk"].shape[1] // u.n_kv_heads
    shape = ((kv_rows, page_size, u.n_kv_heads, Dh) if kv_rows is not None
             else (B, L, u.n_kv_heads, Dh))
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _rope_rows(x, pos):
    """RoPE for a one-position activation (B, 1, H, D) where each row sits
    at its own position ``pos`` (B,)."""
    half = x.shape[-1] // 2
    inv_freq = rope_inv_freq(half, 10000.0, x.device)
    ang = pos.float()[:, None] * inv_freq[None, :]             # (B, half)
    cos = torch.cos(ang)[:, None, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, None, None, :].to(x.dtype)
    return rotate_pairs(x, cos, sin)


def _attn_decode_step(u, params, cache, x_t, pos, pages=None,
                      write_ok=None, *, paged_kernel=False):
    """One-position attention against the cache (in place).

    x_t: (B, E) activation at position ``pos`` — an int (every row at one
    position: ``generate``) or a (B,) int32 tensor of per-row positions
    (the engine).  ``pages`` = (ptab, page_size, write_ok) selects the
    paged pool layout: ptab (B, n_ptab) int32 maps each row's logical
    pages to pool rows, and rows whose ``write_ok`` is False write their
    KV to the scratch row.  ``write_ok`` alone is the dense layout's mask
    (masked rows write nothing).  ``paged_kernel`` reads the paged cache
    through the paged-decode kernel instead of gathering ``pool[ptab]``
    (bounded error against the gather path, never bitwise)."""
    B, E = x_t.shape
    H, Hk = u.n_heads, u.n_kv_heads
    dt = u.compute_dtype or x_t.dtype
    xq = x_t.to(dt)
    per_row = isinstance(pos, torch.Tensor)
    if pages is not None and not per_row:
        raise ValueError("paged attention requires per-row positions "
                         "(the continuous-batching engine path)")

    def proj(w, nh):
        return (xq @ w.to(dt)).reshape(B, 1, nh, -1)

    q = proj(params["wq"], H)                     # (B, 1, H, Dh)
    k = proj(params["wk"], Hk)
    v = proj(params["wv"], Hk)
    if u.rope:
        if per_row:
            q = _rope_rows(q, pos)
            k = _rope_rows(k, pos)
        else:
            q = rotary_embedding(q, offset=pos)
            k = rotary_embedding(k, offset=pos)
    Dh = q.shape[-1]
    G = H // Hk
    ck, cv = cache["k"], cache["v"]
    if pages is not None:
        ptab, psz, wok = pages
        n_ptab = ptab.shape[1]
        pos64 = pos.long()
        # the row's current page (clamped: a position past l_max must not
        # clip into a real page), or the scratch row when masked off
        lpage = torch.clamp(pos64 // psz, max=n_ptab - 1)
        pg = ptab.long().gather(1, lpage[:, None])[:, 0]
        if wok is not None:
            pg = torch.where(wok, pg, ck.shape[0] - 1)
        off = pos64 % psz
        ck[pg, off] = k[:, 0].to(ck.dtype)
        cv[pg, off] = v[:, 0].to(cv.dtype)
        L = n_ptab * psz
        if paged_kernel:
            o = paged_attention_decode(
                q[:, 0].contiguous(), ck, cv, ptab, pos, page_size=psz,
                n_kv_heads=Hk, scale=Dh ** -0.5, window=u.window)
            return _attn_scores(u, params, xq, None, None, None, pos,
                                per_row=True, B=B, H=H, Hk=Hk, G=G, Dh=Dh,
                                L=L, dt=dt, out_dtype=x_t.dtype,
                                context=o), cache
        idx = ptab.long()
        kf = ck[idx].reshape(B, L, Hk, Dh).float()
        vf = cv[idx].reshape(B, L, Hk, Dh).float()
    else:
        L = ck.shape[1]
        if per_row:
            rows = torch.arange(B, device=x_t.device)
            keep = pos.long() < L
            if write_ok is not None:
                keep = keep & write_ok
            ck[rows[keep], pos.long()[keep]] = k[keep, 0].to(ck.dtype)
            cv[rows[keep], pos.long()[keep]] = v[keep, 0].to(cv.dtype)
        else:
            ck[:, pos] = k[:, 0].to(ck.dtype)
            cv[:, pos] = v[:, 0].to(cv.dtype)
        kf = ck.float()
        vf = cv.float()
    qg = q[:, 0].reshape(B, Hk, G, Dh).float()
    return _attn_scores(u, params, xq, qg, kf, vf, pos, per_row=per_row,
                        B=B, H=H, Hk=Hk, G=G, Dh=Dh, L=L, dt=dt,
                        out_dtype=x_t.dtype), cache


def _attn_scores(u, params, xq, qg, kf, vf, pos, *, per_row, B, H, Hk, G,
                 Dh, L, dt, out_dtype, context=None):
    """Masked score/softmax/output tail shared by the cache layouts — one
    copy of the attention math.  ``context`` (B, H, Dh) float32, when the
    paged kernel computed it, skips the score/softmax block."""
    if context is None:
        s = torch.einsum("bkgd,btkd->bkgt", qg, kf) * (Dh ** -0.5)
        t = torch.arange(L, device=qg.device)
        if per_row:
            p64 = pos.long()
            mask = t[None, :] <= p64[:, None]                  # (B, L)
            if u.window is not None:
                mask = mask & (t[None, :] > p64[:, None] - u.window)
            s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
        else:
            mask = t <= pos
            if u.window is not None:
                mask = mask & (t > pos - u.window)
            s = s.masked_fill(~mask[None, None, None, :], float("-inf"))
        p = torch.softmax(s, dim=-1)
        context = torch.einsum("bkgt,btkd->bkgd", p, vf)
    y = context.reshape(B, H * Dh).to(dt) @ params["wo"].to(dt)
    if u.residual:
        y = y + xq
    return y.to(out_dtype)


class DecodePlan:
    """Decode program for a sequence workflow: the unit chain classified
    into cached-attention / pointwise / head segments."""

    def __init__(self, wf, output_unit: Optional[str] = None):
        self.wf = wf
        order = [u for u in wf.topo_order()
                 if not getattr(u, "is_evaluator", False)]
        if output_unit is not None:
            keep = wf.ancestors(output_unit)
            order = [u for u in order if u.name in keep]
        prev = "@input"
        for u in order:
            if tuple(u.inputs) != (prev,):
                raise WorkflowError(
                    f"generate() needs a linear unit chain; {u.name!r} "
                    f"consumes {list(u.inputs)}, expected [{prev!r}]")
            prev = u.name
        if not order or not isinstance(order[0], nn.Embedding):
            raise WorkflowError(
                "generate() needs an Embedding unit at the front of the "
                "chain (token ids are the decode interface)")
        self.embedding = order[0]
        self.output = order[-1].name
        self.seq_handlers: List[Tuple[str, object]] = []
        self.flat_units: List[object] = []
        seen_last = False
        for u in order[1:]:
            if isinstance(u, nn.SeqLast):
                seen_last = True
            elif seen_last:
                self.flat_units.append(u)
            elif isinstance(u, MultiHeadAttention):
                if not u.causal:
                    raise WorkflowError(
                        f"attention unit {u.name!r} is non-causal; "
                        "autoregressive decoding requires causal attention")
                self.seq_handlers.append(("attn", u))
            elif isinstance(u, (nn.LayerNorm, nn.FFN)) or (
                    isinstance(u, nn.All2All) and u.per_position):
                self.seq_handlers.append(("pointwise", u))
            else:
                raise WorkflowError(
                    f"unit {u.name!r} ({type(u).__name__}) cannot decode "
                    "in this slice of the port: it supports attention, "
                    "layer_norm, ffn, per-position all2all and seq_last "
                    "before the head (recurrent, MoE and pipeline stacks "
                    "come with ROADMAP.md slices 7-8)")
        self._attn_units = [u for kind, u in self.seq_handlers
                            if kind == "attn"]

    def attn_keys(self):
        return {u.name for u in self._attn_units}

    def init_caches(self, params, B: int, L: int, dtype, device, *,
                    kv_rows: Optional[int] = None,
                    page_size: Optional[int] = None) -> dict:
        """Zeroed caches: dense (B, L, Hk, Dh) rows, or the flat page pool
        (kv_rows, page_size, Hk, Dh) when ``kv_rows``/``page_size`` are
        given."""
        return {u.name: _attn_cache_init(u, params[u.name], B, L, dtype,
                                         device, kv_rows=kv_rows,
                                         page_size=page_size)
                for u in self._attn_units}

    def step(self, params, caches, tok, pos, ctx: Context, pages=None,
             write_ok=None, *, paged_kernel=False):
        """One decode position: token ids (B,) -> (logits (B, V), caches).
        ``pos`` is an int or a (B,) int32 tensor; see
        :func:`_attn_decode_step` for ``pages``/``write_ok``."""
        x = params[self.embedding.name]["table"][tok.long()]     # (B, E)
        for kind, u in self.seq_handlers:
            if kind == "attn":
                x, caches[u.name] = _attn_decode_step(
                    u, params[u.name], caches[u.name], x, pos, pages,
                    write_ok, paged_kernel=paged_kernel)
            else:
                y, _ = u.apply(params.get(u.name, {}), {}, [x[:, None]],
                               ctx)
                x = y[:, 0]
        for u in self.flat_units:
            x, _ = u.apply(params.get(u.name, {}), {}, [x], ctx)
        return x, caches


def _gumbel(V: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand((V,), generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp_min(1e-20)))


def sample_rows(logits, temperature, top_k, top_p, seeds, positions):
    """Per-row next-token choice from (S, V) logits; the sampling
    parameters are host arrays of length S.  ``temperature <= 0`` picks
    the argmax; otherwise temperature scaling, then top-k (``top_k >= V``
    keeps all), then top-p on the filtered logits (``top_p = 1`` keeps
    all), then a Gumbel-max draw with the row's noise seeded by
    ``fold_seed(seeds[r], positions[r])`` — the op order of the JAX
    package's ``sample_logits`` / ``_sample_slots``."""
    lg = logits.float()
    out = lg.argmax(-1)
    temperature = np.asarray(temperature, np.float32)
    rows = np.flatnonzero(temperature > 0)
    if rows.size == 0:
        return out
    dev = lg.device
    idx = torch.as_tensor(rows, device=dev)
    V = lg.shape[-1]
    x = lg[idx] / torch.as_tensor(temperature[rows], device=dev)[:, None]
    srt = x.sort(-1, descending=True).values
    kk = np.clip(np.asarray(top_k, np.int64)[rows] - 1, 0, V - 1)
    kth = srt.gather(1, torch.as_tensor(kk, device=dev)[:, None])
    x2 = x.masked_fill(x < kth, float("-inf"))
    srt2 = x2.sort(-1, descending=True).values
    probs = torch.softmax(srt2, -1)
    csum = probs.cumsum(-1) - probs
    tp = torch.as_tensor(np.asarray(top_p, np.float32)[rows], device=dev)
    cut = ((csum < tp[:, None]).sum(-1) - 1).clamp_min(0)
    thresh = srt2.gather(1, cut[:, None])
    x3 = x2.masked_fill(x2 < thresh, float("-inf"))
    noise = torch.stack([_gumbel(V, fold_seed(seeds[r], positions[r]), dev)
                         for r in rows])
    out[idx] = (x3 + noise).argmax(-1)
    return out


def params_device(params) -> torch.device:
    """The device the workflow's parameters live on."""
    for sub in params.values():
        for t in sub.values():
            return t.device
    raise ValueError("workflow has no parameters")


def row_seeds(seed: int, B: int) -> List[int]:
    """Per-row sampling seeds of a (B, P) request: the request seed for a
    single row, else ``fold_seed(seed, row)`` (the JAX engine's
    ``fold_in(key, row)`` rule)."""
    return [int(seed)] if B == 1 else [fold_seed(seed, r) for r in range(B)]


def generate(wf, wstate, prompt, n_steps: int, *, temperature: float = 0.0,
             seed: int = 0, top_k: Optional[int] = None,
             top_p: Optional[float] = None, eos_id: Optional[int] = None,
             output_unit: Optional[str] = None,
             cache_dtype=torch.float32):
    """Decode ``n_steps`` tokens after ``prompt`` (B, P) ints.  Returns a
    (B, P + n_steps) int32 tensor: prompt then continuation.  With
    ``eos_id`` a row that emits it is padded with ``eos_id`` afterwards,
    and the loop stops once every row has finished."""
    params = wstate["params"]
    dev = params_device(params)
    prompt = torch.as_tensor(np.asarray(prompt), device=dev).long()
    if prompt.dim() != 2 or prompt.shape[1] < 1:
        raise ValueError("prompt must be (B, P) with at least one token")
    if top_k is not None and int(top_k) < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < float(top_p) <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    B, P = prompt.shape
    L = P + int(n_steps)
    plan = DecodePlan(wf, output_unit)
    ctx = Context(train=False)
    seeds = row_seeds(seed, B)
    temp = np.full(B, float(temperature), np.float32)
    V = None
    with torch.inference_mode():
        caches = plan.init_caches(params, B, L, cache_dtype, dev)
        toks = torch.zeros((B, L), dtype=torch.long, device=dev)
        toks[:, :P] = prompt
        alive = torch.ones(B, dtype=torch.bool, device=dev)
        for pos in range(L - 1):
            logits, caches = plan.step(params, caches, toks[:, pos], pos,
                                       ctx)
            if pos + 1 < P:               # teacher-forced prompt position
                continue
            if V is None:
                V = logits.shape[-1]
            nxt = sample_rows(
                logits, temp,
                np.full(B, V if top_k is None else int(top_k), np.int64),
                np.full(B, 1.0 if top_p is None else float(top_p),
                        np.float32),
                seeds, [pos] * B)
            if eos_id is not None:
                nxt = torch.where(alive, nxt, torch.full_like(nxt, eos_id))
                alive = alive & (nxt != eos_id)
            toks[:, pos + 1] = nxt
            if eos_id is not None and not bool(alive.any()):
                toks[:, pos + 2:] = eos_id
                break
    return toks.to(torch.int32)
