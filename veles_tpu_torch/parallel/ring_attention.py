"""Local attention of the port (counterpart of
veles_tpu/parallel/ring_attention.py).

Only ``blockwise_attention`` is ported: on a CPU tensor it runs the
online-softmax scan (ring_attention.py:88-135), on the card the
flash-forward CUDA kernel.  Ring (sequence-parallel) attention comes with
ROADMAP.md item 6b.
"""

from __future__ import annotations

from typing import Optional

from ..ops.kernels.flash_attention import flash_attention


def blockwise_attention(q, k, v, *, block_size: int = 512,
                        causal: bool = False, scale: Optional[float] = None,
                        window: Optional[int] = None):
    """Memory-efficient attention on one device. q: (B, T, H, D); k/v:
    (B, T, H_kv, D) -> (B, T, H, D).  ``block_size`` is the key block of
    the CPU scan; ``window=W`` (causal only) keeps keys in (q-W, q]."""
    out, _ = flash_attention(q, k, v, causal, scale, window,
                             block_k=block_size)
    return out
