"""Multi-card training: one process per card.

The port's counterpart of ``synthanatomy_tpu/parallel/``:
``distributed`` (process-group set-up from torchrun's environment, the
collectives of the steps, a launcher of rank processes), ``mesh`` (the
(data, seq) and (data, model) rank layouts of ``--sp_shards`` and
``--mesh_shape``, their process groups), ``sequence_parallel`` (the SP
train step), ``tensor_parallel`` (the Megatron TP train step, head
packing) and ``sharding_rules`` (the TP split rules; ZeRO-1: Adam behind
``ZeroRedundancyOptimizer``).  Pipeline parallelism is not ported yet
(ROADMAP.md §1).
"""
