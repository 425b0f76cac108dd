"""Multi-card training: one process per card.

The port's counterpart of ``synthanatomy_tpu/parallel/``:
``distributed`` (process-group set-up from torchrun's environment, the
collectives of the steps, the pipeline's point-to-point exchange, a
launcher of rank processes), ``mesh`` (the (data, seq), (data, model)
and (data, pipe) rank layouts of ``--sp_shards``, ``--mesh_shape`` and
``--pp_stages``, their process groups), ``sequence_parallel`` (the SP
train step), ``tensor_parallel`` (the Megatron TP train step, head
packing), ``pipeline_parallel`` (the GPipe train step over stages of the
depth, stage packing) and ``sharding_rules`` (the TP split rules; ZeRO-1:
Adam behind ``ZeroRedundancyOptimizer``).
"""
