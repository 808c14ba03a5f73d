"""Autoregressive decoding with a per-layer KV cache (counterpart of
veles_tpu/runtime/generate.py:119-545).

``DecodePlan`` classifies a linear unit chain into cached-attention,
pointwise and head segments; its ``step`` advances one position, on the
dense ``(B, L, Hk, Dh)`` cache or on the engine's paged pool.  The caches
are updated IN PLACE (the JAX package returns new arrays; PyTorch saves
the copy).  ``generate`` prefills the prompt through the same step
(teacher-forced) and decodes greedily or by temperature sampling with
optional top-k / top-p; ``generate_beam`` runs beam search over B·W
dense cache rows.  Both build their :class:`DecodePlan` per call: the
JAX package keeps compiled per-shape runners in an LRU, and the port
compiles nothing per shape, so it has no such cache.

Sampling (:func:`sample_slots`) is a function of tensors only, so the
engine runs it inside its captured decode graphs: the Gumbel noise of
row ``r`` and vocabulary entry ``v`` is a counter-based hash of
``(fold_seed(seed, position), v)`` in integer tensor ops, so a stream
depends only on (seed, position) and the engine and ``generate`` give the
same sampled tokens for the same seed.  The numbers cannot match the JAX
package's threefry streams; greedy tokens are what the two packages
share.

Recurrent units decode with O(1) carried state (generate.py:72-110 of
the JAX package): each step runs the unit's own training cell
(``ops/recurrent.py``), so decode cannot drift from the forward pass, and
updates the carry in place.  A ``return_sequences=False`` recurrent ends
the sequence segment as ``seq_last`` does.  A pipeline stack's stages
are flattened into the handlers (its attention and recurrent sub-units
keep caches of their own, generate.py:361-366 of the JAX package), and a
mixture-of-experts unit decodes as a pointwise stage run dropless
(``capacity_factor = n_experts``, :494-506), so a step's routing never
drops a token and keeps fixed shapes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.activations import rope_inv_freq, rotary_embedding, rotate_pairs
from ..ops.kernels.fused_dropout import splitmix32_tensor
from ..ops.kernels.paged_attention import paged_attention_decode
from ..units import nn
from ..units.base import Context
from ..units.parallel_nn import MoEFFN, MultiHeadAttention, PipelineStack
from ..units.recurrent import _RecurrentBase
from ..units.workflow import WorkflowError

_MASK64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF
_FOLD = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB)


def fold_seed(seed: int, value: int) -> int:
    """Deterministic 63-bit mix of (seed, value) — splitmix64 over the
    pair; the port's counterpart of ``jax.random.fold_in``."""
    z = (int(seed) * _FOLD[0] + int(value) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * _FOLD[1]) & _MASK64
    z = ((z ^ (z >> 27)) * _FOLD[2]) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def fold_seed_array(seed: int, values) -> np.ndarray:
    """:func:`fold_seed` of one seed over an array of values, bit for bit,
    as int64: numpy's uint64 products wrap mod 2^64 by definition.  The
    engine folds a slot's seed at every position once, when the slot is
    admitted, so its decode steps read the fold instead of computing it."""
    g = [np.uint64(c) for c in _FOLD]
    z = np.asarray(values, np.uint64) + np.uint64(1) \
        + np.uint64(int(seed) * _FOLD[0] & _MASK64)
    z = (z ^ (z >> np.uint64(30))) * g[1]
    z = (z ^ (z >> np.uint64(27))) * g[2]
    z = (z ^ (z >> np.uint64(31))) & np.uint64((1 << 63) - 1)
    return z.astype(np.int64)


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


def _rec_decode_step(u, params, st, x_t, write_ok=None, rows=None,
                     reset=None):
    """One recurrent step through the unit's training cell, the carry
    ``st`` updated in place.

    ``rows`` (B,) int64 maps the batch rows to carry rows (the engine's
    prefill: one slot of the engine's carries); None is the identity.
    ``reset`` (B,) bool starts a row from the zero carry (a prompt at
    position 0).  ``write_ok`` (B,) bool freezes the carry of the rows
    that are off: a cell step is not idempotent (unlike a KV rewrite),
    so without the gate a decode step would advance the carry of a slot
    mid-chunked-prefill, whose next slice continues from it.  Returns
    the (B, H) output, the gated hidden state."""
    old = {k: (v if rows is None else v.index_select(0, rows))
           for k, v in st.items()}
    start = old if reset is None else {
        k: torch.where(reset[:, None], torch.zeros_like(v), v)
        for k, v in old.items()}
    new = u.cell(params, x_t, start)
    if write_ok is not None:
        # a row that is off keeps its carry as it was, reset or not
        new = {k: torch.where(write_ok[:, None], v, old[k])
               for k, v in new.items()}
    for k, v in new.items():
        if rows is None:
            st[k].copy_(v)
        else:
            st[k].index_copy_(0, rows, v)
    return new["h"]


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
        #: unit name -> its params' path in the workflow's params (a
        #: pipeline stack's sub-units sit under ``stack/s<i>``)
        self.param_paths: Dict[str, Tuple[str, ...]] = {}
        seen_last = False
        for u in order[1:]:
            if isinstance(u, nn.SeqLast):
                seen_last = True
            elif seen_last:
                self.flat_units.append(u)
            elif isinstance(u, PipelineStack):
                self._add_stack(u)
            else:
                seen_last = self._add_seq(u, (u.name,))
        self._attn_units = [u for kind, u in self.seq_handlers
                            if kind == "attn"]
        self._rec_units = [u for kind, u in self.seq_handlers
                           if kind == "recurrent"]

    def _add_seq(self, u, path, *, in_stage: bool = False) -> bool:
        """Classify one unit before ``seq_last``; returns True when it
        plays ``seq_last``'s role (a recurrent unit that returns its last
        hidden only)."""
        self.param_paths[u.name] = tuple(path)
        if isinstance(u, MultiHeadAttention):
            if not u.causal:
                raise WorkflowError(
                    f"attention unit {u.name!r} is non-causal; "
                    "autoregressive decoding requires causal attention")
            self.seq_handlers.append(("attn", u))
        elif isinstance(u, _RecurrentBase):
            if in_stage and not u.return_sequences:
                raise WorkflowError(
                    f"recurrent unit {u.name!r} inside a pipeline stage "
                    "must return sequences (stages preserve the "
                    "activation spec)")
            self.seq_handlers.append(("recurrent", u))
            # the current hidden IS the last hidden: the unit plays
            # seq_last's role and the rest works on (B, H) tensors
            return not u.return_sequences
        elif isinstance(u, MoEFFN):
            self.seq_handlers.append(("moe", u))
        elif isinstance(u, (nn.LayerNorm, nn.FFN, nn.Dropout)) or (
                isinstance(u, nn.All2All) and u.per_position):
            self.seq_handlers.append(("pointwise", u))
        else:
            raise WorkflowError(
                f"unit {u.name!r} ({type(u).__name__}) mixes sequence "
                "positions (or is not per-position); generate() supports "
                "attention, rnn/gru/lstm, moe, layer_norm, ffn, dropout, "
                "per-position all2all, pipeline_stack and seq_last before "
                "the head")
        return False

    def _add_stack(self, stack) -> None:
        """A pipeline stack's stages flattened into the handlers, in
        stage order (veles_tpu/runtime/generate.py:361-366); the
        homogeneous form is one pointwise handler."""
        if stack.stages_cfg is None:
            self.param_paths[stack.name] = (stack.name,)
            self.seq_handlers.append(("pointwise", stack))
            return
        for i, units in enumerate(stack._stage_units):
            for su in units:
                self._add_seq(su, (stack.name, f"s{i}", su.name),
                              in_stage=True)

    def unit_params(self, params, u) -> dict:
        """Unit ``u``'s params in the workflow's params tree."""
        p = params
        for k in self.param_paths.get(u.name, (u.name,)):
            p = p.get(k, {})
        return p

    def attn_keys(self):
        return {u.name for u in self._attn_units}

    def init_caches(self, params, B: int, L: int, dtype, device, *,
                    kv_rows: Optional[int] = None,
                    page_size: Optional[int] = None) -> dict:
        """Zeroed caches: dense (B, L, Hk, Dh) rows, or the flat page pool
        (kv_rows, page_size, Hk, Dh) when ``kv_rows``/``page_size`` are
        given; a recurrent unit's carry is (B, H) float32 either way."""
        caches = {u.name: _attn_cache_init(u, self.unit_params(params, u),
                                           B, L, dtype,
                                           device, kv_rows=kv_rows,
                                           page_size=page_size)
                  for u in self._attn_units}
        for u in self._rec_units:
            caches[u.name] = u.carry_init(B, device)
        return caches

    def step(self, params, caches, tok, pos, ctx: Context, pages=None,
             write_ok=None, *, paged_kernel=False, carry_rows=None):
        """One decode position: token ids (B,) -> (logits (B, V), caches).
        ``pos`` is an int or a (B,) int32 tensor; see
        :func:`_attn_decode_step` for ``pages``/``write_ok``.  The
        recurrent carries are gated by the same mask (the paged tuple's,
        else ``write_ok``), read and written at ``carry_rows`` (B,)
        int64 when given, and a row at position 0 starts from the zero
        carry."""
        x = params[self.embedding.name]["table"][tok.long()]     # (B, E)
        carry_ok = pages[2] if pages is not None else write_ok
        reset = (pos == 0) if isinstance(pos, torch.Tensor) else None
        for kind, u in self.seq_handlers:
            p = self.unit_params(params, u)
            if kind == "attn":
                x, caches[u.name] = _attn_decode_step(
                    u, p, caches[u.name], x, pos, pages,
                    write_ok, paged_kernel=paged_kernel)
            elif kind == "recurrent":
                x = _rec_decode_step(u, p, caches[u.name], x,
                                     carry_ok, carry_rows, reset)
            elif kind == "moe":
                # dropless: capacity_factor = n_experts gives C = T*K,
                # so no route of the step's B tokens is dropped
                # (veles_tpu/runtime/generate.py:494-506)
                x, _ = u.apply(p, {}, [x], ctx,
                               capacity_factor=float(u.n_experts))
            else:
                y, _ = u.apply(p, {}, [x[:, None]], ctx)
                x = y[:, 0]
        for u in self.flat_units:
            x, _ = u.apply(params.get(u.name, {}), {}, [x], ctx)
        return x, caches


def noise_bits(keys: torch.Tensor, V: int) -> torch.Tensor:
    """(S, V) int64 32-bit hash of each row's fold key (``fold_seed(seed,
    position)``, int64) and the vocabulary index: ``splitmix32(v ^ lo ^
    hi)`` over the key's 32-bit halves, in integer tensor ops — the same
    bits on every device."""
    row = (keys & _M32) ^ (keys >> 32)
    v = torch.arange(V, dtype=torch.int64, device=keys.device)
    return splitmix32_tensor(v[None, :] ^ row[:, None])


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Float32 Gumbel noise ``-log(-log(u))`` of 32-bit hashes: ``u``
    takes the top 23 bits, centred in its 2^-23 bin, so every ``u`` from
    2^-24 to 1 - 2^-24 is exact in float32 and the noise is finite (24
    bits would round the top bin's centre up to 1.0)."""
    u = ((bits >> 9).to(torch.float32) + 0.5) * (1.0 / 8388608.0)
    return -torch.log(-torch.log(u))


def gumbel_noise(keys: torch.Tensor, V: int) -> torch.Tensor:
    """(S, V) float32 Gumbel noise of :func:`noise_bits`, in the
    device's float32 logs."""
    return gumbel_from_bits(noise_bits(keys, V))


def filter_logits(logits, temperature, top_k, top_p):
    """The sampled rows' candidates: (S, V) float32 logits scaled by the
    temperature (a safe divisor where the row is greedy), then top-k
    (``top_k >= V`` keeps all), then top-p on the filtered logits
    (``top_p = 1`` keeps all); filtered entries are ``-inf``.  The op
    order of the JAX package's ``_sample_slots``
    (veles_tpu/runtime/engine.py:1024-1066)."""
    lg = logits.float()
    V = lg.shape[-1]
    x = lg / torch.where(temperature > 0, temperature,
                         torch.ones_like(temperature))[:, None]
    srt = x.sort(-1, descending=True).values
    kth = srt.gather(1, (top_k.long() - 1).clamp(0, V - 1)[:, None])
    x2 = x.masked_fill(x < kth, float("-inf"))
    # the sorted x2: the filter is monotone, so it maps sorted to sorted
    srt2 = srt.masked_fill(srt < kth, float("-inf"))
    probs = torch.softmax(srt2, -1)
    csum = probs.cumsum(-1) - probs
    cut = ((csum < top_p[:, None]).sum(-1) - 1).clamp_min(0)
    thresh = srt2.gather(1, cut[:, None])
    return x2.masked_fill(x2 < thresh, float("-inf"))


def sample_slots(logits, temperature, top_k, top_p, noise):
    """Per-row next-token choice from (S, V) logits, every argument a
    tensor on the logits' device (temperature and top_p float32, top_k
    integer, ``noise`` the rows' (S, V) :func:`gumbel_noise`): no host
    value and no host branch, so a CUDA graph captures it.  Greedy rows
    (``temperature <= 0``) take ``logits.float().argmax(-1)``, the
    others the Gumbel-max draw ``argmax(filter_logits(...) + noise)``.
    The JAX package skips the sampled half with a runtime branch when
    every row is greedy; this computes both halves every call and picks
    per row, and its callers skip it on the host instead (the engine
    replays a greedy-only program when no live slot samples).  Returns
    int64 (S,)."""
    x3 = filter_logits(logits, temperature, top_k, top_p)
    return torch.where(temperature > 0, (x3 + noise).argmax(-1),
                       logits.float().argmax(-1))


def sampling_tensors(temperature, top_k, top_p, device):
    """The per-row filter arguments of :func:`sample_slots` from host
    values (lists or arrays of one length), on ``device``."""
    return (torch.as_tensor(np.asarray(temperature, np.float32),
                            device=device),
            torch.as_tensor(np.asarray(top_k, np.int64), device=device),
            torch.as_tensor(np.asarray(top_p, np.float32), device=device))


def fold_keys(seeds, position: int, device) -> torch.Tensor:
    """The rows' ``fold_seed(seed, position)`` as an int64 tensor."""
    return torch.as_tensor([fold_seed(s, position) for s in seeds],
                           dtype=torch.int64, device=device)


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
    and the loop stops once every row has finished.  ``cache_dtype`` is
    the KV cache's type (float32 or bfloat16, as the engine's)."""
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
                samp = sampling_tensors(
                    [temperature] * B, [V if top_k is None else top_k] * B,
                    [1.0 if top_p is None else top_p] * B, dev)
            nxt = (sample_slots(logits, *samp, gumbel_noise(
                fold_keys(seeds, pos, dev), V)) if temperature > 0
                else logits.float().argmax(-1))
            if eos_id is not None:
                nxt = torch.where(alive, nxt, torch.full_like(nxt, eos_id))
                alive = alive & (nxt != eos_id)
            toks[:, pos + 1] = nxt
            if eos_id is not None and not bool(alive.any()):
                toks[:, pos + 2:] = eos_id
                break
    return toks.to(torch.int32)


#: the score of a beam that must not be chosen (only beam 0 starts live;
#: a finished beam extends only with eos)
_BEAM_NEG = -1e30


def generate_beam(wf, wstate, prompt, n_steps: int, *, beams: int = 4,
                  eos_id: Optional[int] = None,
                  length_penalty: float = 0.0,
                  output_unit: Optional[str] = None,
                  cache_dtype=torch.float32):
    """Beam-search decode (generate.py:745-872 of the JAX package): (B, P)
    ints -> (tokens (B, P + n_steps) int32, scores (B,) float32), the
    highest-scoring of ``beams`` hypotheses a row.

    A score is the generated continuation's summed token log-probs (the
    prompt's own is a per-row constant and left out), over ``len **
    length_penalty`` of the generated length (0: the raw sum; > 0
    favours longer continuations).  With ``eos_id`` a beam that emits it
    is finished: its score freezes and it pads with ``eos_id``, its
    length normalised at its first eos.  ``beams=1`` is greedy
    :func:`generate`.

    The batch axis carries B·W rows of dense caches through the decode
    step; each expansion takes the top W of the W·V candidates a row
    (ties to the lower index, as ``lax.top_k``) and reorders every cache
    by the survivors' parents.  Beam search reaches no kernel in the JAX
    package either (its dense ``plan.step``)."""
    params = wstate["params"]
    dev = params_device(params)
    prompt = torch.as_tensor(np.asarray(prompt), device=dev).long()
    if prompt.dim() != 2 or prompt.shape[1] < 1:
        raise ValueError("prompt must be (B, P) with at least one token")
    W = int(beams)
    if W < 1:
        raise ValueError(f"beams must be >= 1, got {W}")
    B, P = prompt.shape
    L = P + int(n_steps)
    BW = B * W
    plan = DecodePlan(wf, output_unit)
    ctx = Context(train=False)
    with torch.inference_mode():
        # every beam starts as a copy of its row, but only beam 0 scores
        # 0: the first expansion would otherwise pick W copies of one
        # hypothesis
        caches = plan.init_caches(params, BW, L, cache_dtype, dev)
        toks = torch.zeros((BW, L), dtype=torch.long, device=dev)
        toks[:, :P] = prompt.repeat_interleave(W, 0)
        scores = torch.where(torch.arange(W, device=dev) == 0, 0.0,
                             _BEAM_NEG).float().repeat(B)
        alive = torch.ones(BW, dtype=torch.bool, device=dev)
        rows = torch.arange(B, device=dev)[:, None] * W
        for pos in range(L - 1):
            logits, caches = plan.step(params, caches, toks[:, pos], pos,
                                       ctx)
            if pos + 1 < P:       # prefill accumulates nothing
                continue
            logp = torch.log_softmax(logits.float(), dim=-1)
            V = logp.shape[-1]
            if eos_id is not None:
                # a finished beam extends only with eos, at no cost
                frozen = torch.full((V,), _BEAM_NEG, device=dev)
                frozen[eos_id] = 0.0
                logp = torch.where(alive[:, None], logp, frozen[None])
            flat = (scores[:, None] + logp).reshape(B, W * V)
            top_s, top_i = torch.sort(flat, dim=-1, descending=True,
                                      stable=True)
            top_s, top_i = top_s[:, :W], top_i[:, :W]
            idx = (top_i // V + rows).reshape(-1)
            nxt = (top_i % V).reshape(-1)
            for c in caches.values():
                for part in c:
                    c[part] = c[part].index_select(0, idx)
            toks = toks.index_select(0, idx)
            alive = alive.index_select(0, idx)
            scores = top_s.reshape(-1)
            if eos_id is not None:
                alive = alive & (nxt != eos_id)
            toks[:, pos + 1] = nxt
        toks_bw = toks.reshape(B, W, L)
        scores_bw = scores.reshape(B, W)
        if length_penalty:
            if eos_id is not None:
                ended = toks_bw[:, :, P:] == eos_id
                first = torch.where(ended.any(-1),
                                    ended.int().argmax(-1) + 1, L - P)
            else:
                first = torch.full((B, W), L - P, device=dev)
            scores_bw = scores_bw / (first.float() ** length_penalty)
        best = scores_bw.argmax(-1)
        b = torch.arange(B, device=dev)
        return toks_bw[b, best].to(torch.int32), scores_bw[b, best]
