"""Parallel layers of the port (counterpart of veles_tpu/parallel).

The local ``blockwise_attention``; the ``CliRunner`` / ``ParallelMap``
pools of ``pool.py``; the mixture-of-experts layer (``moe.py``); the
mesh over ``torch.distributed`` process groups (``mesh.py``,
``distributed.py``, ``launcher.py``), ring attention over its ``seq``
axis (``ring_attention.py``), the expert all-to-all over its ``expert``
axis (``moe.py``), the pipeline schedules over its ``pipe`` axis
(``pipeline.py``, ``pipeline_compile.py``), the state placed by a rule
over its ``fsdp`` (and any other) axis (``fsdp.py``), tensor parallelism
over its ``model`` axis (``tensor_parallel.py``) and the data x fsdp x
model dry run (``dryrun.py``)."""
