"""The port's hand-written CUDA kernels, one module per TPU kernel, each
with its plain PyTorch version and a launch counter beside it.

=========================  ===============================================
module                     replaces (veles_tpu/ops/pallas_kernels.py)
=========================  ===============================================
``flash_attention``        ``_flash_fwd`` (pallas_call :205)
``paged_attention``        ``paged_attention_decode`` (pallas_call :612)
=========================  ===============================================

Sources live in ``veles_tpu_torch/csrc``; :mod:`.build` compiles them at
first use.
"""

from . import flash_attention, paged_attention

#: every kernel module of the port (chip_smoke.py and the docs walk it)
KERNELS = (flash_attention, paged_attention)
