"""Serving runtime of the port (counterpart of veles_tpu/runtime):
snapshots, decoding, the continuous-batching engine and the REST server."""
