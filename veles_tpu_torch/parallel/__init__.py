"""Parallel layers of the port (counterpart of veles_tpu/parallel).

This slice ports the local ``blockwise_attention`` only."""
