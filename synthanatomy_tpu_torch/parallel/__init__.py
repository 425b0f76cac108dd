"""Data parallelism and ZeRO-1: one process per card.

The port's counterpart of ``synthanatomy_tpu/parallel/`` for pure data
parallelism: ``distributed`` (process-group set-up from torchrun's
environment, the collectives of the DP steps, a launcher of rank
processes), ``mesh`` (the data-axis check of ``--mesh_shape`` and the
per-rank shard) and ``sharding_rules`` (ZeRO-1: Adam behind
``ZeroRedundancyOptimizer``).  Sequence, tensor and pipeline parallelism
are not ported yet (ROADMAP.md §1).
"""
