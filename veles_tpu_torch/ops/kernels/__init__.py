"""The port's hand-written CUDA kernels, one module per TPU kernel, each
with its plain PyTorch version and a launch counter beside it.

=========================  ===============================================
module                     replaces (veles_tpu/ops/pallas_kernels.py)
=========================  ===============================================
``flash_attention``        ``_flash_fwd`` (pallas_call :205)
``flash_bwd_dq``           ``_flash_bwd`` dQ (pallas_call :384)
``flash_bwd_dkv``          ``_flash_bwd`` dK/dV (pallas_call :411)
``paged_attention``        ``paged_attention_decode`` (pallas_call :612)
``gather_rows``            ``gather_rows_packed`` (pallas_call :818)
``fused_dropout``          ``_dropout_apply`` (pallas_call :694)
``mean_disp``              ``mean_disp_normalize`` (pallas_call :760)
=========================  ===============================================

Sources live in ``veles_tpu_torch/csrc``; :mod:`.build` compiles them at
first use.
"""

from . import (flash_attention, flash_bwd_dkv, flash_bwd_dq, fused_dropout,
               gather_rows, mean_disp, paged_attention)

#: every kernel module of the port (chip_smoke.py and the docs walk it)
KERNELS = (flash_attention, flash_bwd_dq, flash_bwd_dkv, paged_attention,
           fused_dropout, mean_disp, gather_rows)
