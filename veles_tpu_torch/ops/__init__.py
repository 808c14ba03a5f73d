"""Functional op library of the port (counterpart of ``veles_tpu/ops``).

Holds the port's device policy — the counterpart of
``use_pallas_default()`` (veles_tpu/ops/__init__.py:20-31):

* :func:`resolve_device` is what every entry point (workflow state,
  weight loading, the decode engine, the server, the CLI) calls on its
  ``device`` argument: ``None`` means the CUDA card, and a missing card
  raises instead of carrying on on the CPU.  Only an explicit
  ``device="cpu"`` (the tests) runs on the host.
* :func:`kernel_route` is what every kernel wrapper calls on its input:
  a CPU tensor takes the plain PyTorch version, a tensor on a Hopper card
  (capability 9.0) launches the hand-written kernel, and a tensor on any
  other CUDA device raises.  No wrapper falls back from a kernel that
  fails to build or launch.
"""

from __future__ import annotations

import torch

from .activations import ACTIVATIONS, rotary_embedding
from .linear import dense, smart_uniform_init

__all__ = ["ACTIVATIONS", "rotary_embedding", "dense", "smart_uniform_init",
           "resolve_device", "kernel_route", "check_attention_window",
           "check_gqa_heads"]

#: compute capability the hand-written kernels are compiled for (sm_90a)
KERNEL_CAPABILITY = (9, 0)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` -> the CUDA card.
    Raises when CUDA is asked for (explicitly or by default) and no card
    is present — the port never silently serves from the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def kernel_route(x: torch.Tensor, kernel: str) -> bool:
    """True when ``x`` must go through the hand-written CUDA kernel,
    False when it lies on the CPU (plain version).  Raises for a CUDA
    device the kernels are not built for."""
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        cap = torch.cuda.get_device_capability(x.device)
        if tuple(cap) != KERNEL_CAPABILITY:
            raise RuntimeError(
                f"{kernel}: the kernel is built for sm_90a (capability "
                f"{KERNEL_CAPABILITY}); {torch.cuda.get_device_name(x.device)}"
                f" has capability {tuple(cap)}")
        return True
    raise RuntimeError(f"{kernel}: no kernel for device {x.device}")


def check_attention_window(window, causal):
    """Shared validation for sliding-window attention: None disables;
    otherwise a positive int with causal=True (0 would silently mask
    everything to zeros).  Same rule as veles_tpu/ops/__init__.py:34."""
    if window is None:
        return None
    if not causal:
        raise ValueError("sliding-window attention requires causal=True")
    window = int(window)
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window} "
                         "(use window=None to disable)")
    return window


def check_gqa_heads(n_heads: int, n_kv_heads: int) -> int:
    """Shared GQA validation: returns the group size H / H_kv."""
    if n_kv_heads < 1 or n_heads % n_kv_heads:
        raise ValueError(f"q heads {n_heads} must be a positive multiple "
                         f"of kv heads {n_kv_heads}")
    return n_heads // n_kv_heads
