"""Units of the port (counterpart of veles_tpu/units): the LM, image and
recurrent families, the self-organizing units and the utility units."""

from .base import (Avatar, Context, Forward, InputJoiner, LambdaUnit, Spec,
                   TrivialUnit, Unit, UnitRegistry)
from .kohonen import KohonenForward
from .nn import (All2All, All2AllRELU, All2AllSincos, All2AllSoftmax,
                 All2AllTanh, Embedding, EvaluatorSoftmax, FFN, LayerNorm,
                 SeqLast)
from .parallel_nn import MultiHeadAttention
from .rbm import RBM
from .recurrent import GRU, LSTM, RNN
from .workflow import Workflow, WorkflowError

__all__ = ["Avatar", "Context", "Forward", "InputJoiner", "LambdaUnit",
           "Spec", "TrivialUnit", "Unit", "UnitRegistry", "KohonenForward",
           "All2All", "All2AllRELU", "All2AllSincos", "All2AllSoftmax",
           "All2AllTanh", "Embedding", "EvaluatorSoftmax", "FFN",
           "LayerNorm", "SeqLast", "MultiHeadAttention", "RBM", "GRU",
           "LSTM", "RNN", "Workflow", "WorkflowError"]
