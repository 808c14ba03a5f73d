"""MNIST autoencoder, the non-classification path (a copy of
veles_tpu/models/autoencoder.py, which holds no JAX, rewired to the
port).

Reference: the Znicz MNIST AE, validation RMSE target 0.5478: an all2all
tanh bottleneck trained with MSE against the input (``loss:
"mse_input"``, ``EvaluatorMSE``; the trainer's epoch ``rmse``).
"""

from __future__ import annotations

from .mnist import MnistLoader
from .standard import StandardWorkflow

MNIST_AE_CONFIG = {
    "name": "MnistAutoencoder",
    "layers": [
        {"type": "all2all_tanh", "output_size": 100, "name": "enc"},
        {"type": "all2all", "output_size": 784, "name": "dec",
         "activation": "linear"},
    ],
    "loss": "mse_input",
    "optimizer": "adadelta",
    "optimizer_args": {"lr": 1.0},
    "max_epochs": 20,
    "fail_iterations": 20,
}


def mnist_autoencoder_workflow(minibatch_size=100, loader_args=None,
                               **overrides) -> StandardWorkflow:
    cfg = dict(MNIST_AE_CONFIG)
    cfg.update(overrides)
    sw = StandardWorkflow(cfg)
    sw.loader = MnistLoader(minibatch_size=minibatch_size,
                            **(loader_args or {}))
    return sw
