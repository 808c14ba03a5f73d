"""Units of the port (counterpart of veles_tpu/units), LM family."""

from .base import Context, Forward, Spec, Unit
from .nn import (All2All, All2AllRELU, All2AllSincos, All2AllSoftmax,
                 All2AllTanh, Embedding, EvaluatorSoftmax, FFN, LayerNorm,
                 SeqLast)
from .parallel_nn import MultiHeadAttention
from .workflow import Workflow, WorkflowError

__all__ = ["Context", "Forward", "Spec", "Unit", "All2All", "All2AllRELU",
           "All2AllSincos", "All2AllSoftmax", "All2AllTanh", "Embedding",
           "EvaluatorSoftmax", "FFN", "LayerNorm", "SeqLast",
           "MultiHeadAttention", "Workflow", "WorkflowError"]
