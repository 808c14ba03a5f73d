"""Loaders of the port (counterpart of veles_tpu/loader): the minibatch
contract and the device-resident fullbatch loaders."""

from .base import (CLASS_NAMES, TEST, TRAIN, VALID, ArrayLoader, Loader,
                   LoaderError)
from .fullbatch import FullBatchAugmentedLoader, FullBatchLoader

__all__ = ["CLASS_NAMES", "TEST", "TRAIN", "VALID", "ArrayLoader", "Loader",
           "LoaderError", "FullBatchLoader", "FullBatchAugmentedLoader"]
