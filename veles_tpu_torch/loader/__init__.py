"""Loaders of the port (counterpart of veles_tpu/loader): the minibatch
contract, the device-resident fullbatch loaders, and the host loaders of
images, pickles, wav, csv, ensemble results, captured minibatches, queues
and sockets, and WebHDFS text."""

from .base import (CLASS_NAMES, TEST, TRAIN, VALID, ArrayLoader, Loader,
                   LoaderError)
from .ext import (CsvLoader, EnsembleResultsLoader, PicklesLoader,
                  WavLoader, read_wav)
from .fullbatch import FullBatchAugmentedLoader, FullBatchLoader
from .hdfs import HdfsTextLoader, WebHdfsClient
from .image import FileImageLoader, Hdf5Loader, ImageLoader
from .interactive import QueueLoader, SocketLoader, feed_socket
from .saver import MinibatchesLoader, MinibatchesSaver

__all__ = ["CLASS_NAMES", "TEST", "TRAIN", "VALID", "ArrayLoader", "Loader",
           "LoaderError", "FullBatchLoader", "FullBatchAugmentedLoader",
           "CsvLoader", "EnsembleResultsLoader", "PicklesLoader",
           "WavLoader", "read_wav", "HdfsTextLoader", "WebHdfsClient",
           "FileImageLoader", "Hdf5Loader", "ImageLoader", "QueueLoader",
           "SocketLoader", "feed_socket", "MinibatchesLoader",
           "MinibatchesSaver"]
