"""Model factories of the port (counterpart of veles_tpu/models)."""
