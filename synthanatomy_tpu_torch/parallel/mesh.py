"""The data axis of ``--mesh_shape`` and each rank's shard.

Port of the data-parallel half of ``synthanatomy_tpu/parallel/mesh.py``
(``host_shard_info`` :170, the mesh check of ``make_data_mesh_for_batch``
:98): one process per card, so the data axis is the world of ranks and a
rank's loader already holds its shard (JAX's ``shard_batch`` has no
counterpart).  A model axis is tensor parallelism, not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from synthanatomy_tpu_torch.parallel.distributed import default_group, group_info

__all__ = ["TP_ITEM", "check_data_mesh", "host_shard_info"]

TP_ITEM = "ROADMAP.md §1, item 1 (Multi-GPU: tensor parallelism)"


def host_shard_info() -> Tuple[int, int]:
    """(shard_id, num_shards) for per-rank data loading (the
    DistributedSampler replacement): (rank, world), (0, 1) in a
    single-device run."""
    return group_info(default_group())


def check_data_mesh(mesh_shape: Optional[Sequence[int]], world: int) -> None:
    """``--mesh_shape=(N,)`` must name the ranks the job has (None: all of
    them); a model axis over several devices raises
    ``NotImplementedError``."""
    if mesh_shape is None:
        return
    shape = tuple(int(s) for s in mesh_shape)
    if any(s > 1 for s in shape[1:]):
        raise NotImplementedError(
            f"--mesh_shape={shape} has a model axis: tensor parallelism is not ported yet "
            f"({TP_ITEM}); use --mesh_shape='(N,)' with N ranks")
    if shape[0] != world:
        raise ValueError(
            f"--mesh_shape={shape} names {shape[0]} data ranks but the job has WORLD_SIZE "
            f"{world}: launch it with torchrun --nproc_per_node={shape[0]}")
