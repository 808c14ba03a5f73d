"""Parallel layers of the port (counterpart of veles_tpu/parallel).

The local ``blockwise_attention``, and the ``CliRunner`` / ``ParallelMap``
pools of ``pool.py``."""
