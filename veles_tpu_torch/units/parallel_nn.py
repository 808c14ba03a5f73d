"""Multi-head attention unit (counterpart of veles_tpu/units/parallel_nn.py
``MultiHeadAttention``, local path :178-222).

Covers RoPE, the residual stream, grouped-query attention and the
sliding window.  The sequence-parallel modes (``manual`` / ``wrapper``,
ring attention over a mesh) come with the parallelism slice, and the
JAX package's build-time autotune (``prepare``) is not ported: on the
card the flash-forward kernel is the attention.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..ops import check_gqa_heads, rotary_embedding, smart_uniform_init
from .base import Context, Forward, Spec, dtype_of


class MultiHeadAttention(Forward):
    """Self-attention over (B, T, E) activations."""

    def __init__(self, n_heads: int, head_dim: Optional[int] = None,
                 name=None, inputs=("@input",), *, causal: bool = True,
                 seq_axis: str = "seq", block_size: int = 512,
                 compute_dtype=None, window: Optional[int] = None,
                 n_kv_heads: Optional[int] = None, rope: bool = False,
                 residual: bool = False):
        super().__init__(name, inputs)
        self.n_heads = int(n_heads)
        self.head_dim = head_dim
        self.causal = causal
        self.seq_axis = seq_axis
        self.block_size = int(block_size)
        self.compute_dtype = dtype_of(compute_dtype)
        self.window = None if window is None else int(window)
        self.rope = bool(rope)
        self.residual = bool(residual)
        self.n_kv_heads = (self.n_heads if n_kv_heads is None
                           else int(n_kv_heads))
        check_gqa_heads(self.n_heads, self.n_kv_heads)

    def output_spec(self, in_specs: Sequence[Spec]) -> Spec:
        return in_specs[0]

    def init(self, generator, in_specs, device):
        E = in_specs[0].shape[-1]
        H, Hk = self.n_heads, self.n_kv_heads
        D = self.head_dim or E // H
        if self.head_dim is None and E % H:
            raise ValueError(f"model dim {E} not divisible by {H} heads")
        return {
            "wq": smart_uniform_init(generator, (E, H * D), E,
                                     device=device),
            "wk": smart_uniform_init(generator, (E, Hk * D), E,
                                     device=device),
            "wv": smart_uniform_init(generator, (E, Hk * D), E,
                                     device=device),
            "wo": smart_uniform_init(generator, (H * D, E), H * D,
                                     device=device),
        }, {}

    def apply(self, params, state, xs, ctx: Context):
        from ..parallel.ring_attention import blockwise_attention
        if ctx.mesh is not None:
            raise NotImplementedError(
                f"attention {self.name!r}: sequence-parallel attention over "
                "a device mesh comes with the parallelism slice of the port "
                "(ROADMAP.md, slice 8)")
        x = xs[0]
        B, T, E = x.shape
        H = self.n_heads
        dt = self.compute_dtype or x.dtype
        xq = x.to(dt)

        def proj(w, nh):
            return (xq @ w.to(dt)).reshape(B, T, nh, -1)

        q = proj(params["wq"], H)
        k = proj(params["wk"], self.n_kv_heads)
        v = proj(params["wv"], self.n_kv_heads)
        if self.rope:
            q = rotary_embedding(q)
            k = rotary_embedding(k)
        o = blockwise_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), block_size=self.block_size,
                                causal=self.causal, window=self.window)
        y = o.reshape(B, T, -1) @ params["wo"].to(dt)
        if self.residual:
            y = y + xq
        return y.to(x.dtype), state
