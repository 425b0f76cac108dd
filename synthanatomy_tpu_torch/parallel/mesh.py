"""The rank layout of ``--mesh_shape`` and ``--sp_shards``, and each
rank's shard of the data.

Port of ``synthanatomy_tpu/parallel/mesh.py``'s mesh rules (and of the
runner's SP and PP meshes, ``runners/transformer.py:210-236``) for one
process per card: the ranks form a 2-D layout (data, inner), laid out as
JAX's row-major ``make_mesh`` lays out devices, the second axis the fast
one (rank = data_index · n_inner + inner_index):

- ``--mesh_shape=(N,)`` or ``(N, 1)``: pure data parallelism over N ranks;
- ``--mesh_shape=(d, m)``: (data, model), tensor parallelism over m;
- ``--sp_shards=s``: (data, seq), data = world / s; the world must
  divide by s.  ``--batch_size`` counts one data group's rows (as it
  counts one rank's under DP), so every data size holds it and every
  rank has a place: JAX's rule that shrinks the data size until it
  divides a global batch has nothing to do here;
- ``--pp_stages=P``: (data, pipe), data = world / P, under the same
  rules; the ranks of a pipe group hold the prior's P stages in order.

:func:`build_groups` makes the ``torch.distributed`` groups of both axes
(every rank calls it).  The ranks of one data group hold the same
position on the inner axis and other rows of the batch; the ranks of one
inner group hold the same rows (:func:`host_shard_info` for the loader).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch.distributed as dist

from synthanatomy_tpu_torch.parallel.distributed import default_group, group_info

__all__ = ["RankLayout", "build_groups", "host_shard_info", "rank_layout"]


def host_shard_info() -> Tuple[int, int]:
    """(rank, world) of the job: (0, 1) in a single-device run."""
    return group_info(default_group())


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """A (data, inner) layout of the job's ranks.  ``inner`` names the
    second axis ("seq", "model", "pipe", or None for pure DP).  The groups
    are set by :func:`build_groups`; a group of one rank is None (nothing
    to reduce), ``group`` holds every rank."""

    shape: Tuple[int, int]
    inner: Optional[str]
    rank: int
    world: int
    group: Any = None
    data_group: Any = None
    inner_group: Any = None

    @property
    def data_index(self) -> int:
        return self.rank // self.shape[1]

    @property
    def inner_index(self) -> int:
        return self.rank % self.shape[1]


def rank_layout(mesh_shape: Optional[Sequence[int]], world: int, rank: int = 0, *,
                sp_shards: int = 0, pp_stages: int = 0) -> RankLayout:
    """The layout the flags ask for over ``world`` ranks; raises
    ``ValueError`` for one the job cannot hold."""
    for flag, n, inner in (("sp_shards", sp_shards, "seq"), ("pp_stages", pp_stages, "pipe")):
        if n > 1:
            if world % n:
                raise ValueError(f"{flag}={n} must divide the device count: the job has "
                                 f"WORLD_SIZE {world}")
            return RankLayout((world // n, n), inner, rank, world)
    if mesh_shape is None:
        return RankLayout((world, 1), None, rank, world)
    shape = tuple(int(s) for s in mesh_shape)
    if len(shape) > 2 or not shape:
        raise ValueError(f"--mesh_shape={shape}: give (data,) or (data, model)")
    d, m = shape[0], (shape[1] if len(shape) == 2 else 1)
    if d * m != world:
        raise ValueError(
            f"--mesh_shape={shape} names {d * m} ranks but the job has WORLD_SIZE {world}: "
            f"launch it with torchrun --nproc_per_node={d * m}")
    return RankLayout((d, m), "model" if m > 1 else None, rank, world)


def build_groups(layout: RankLayout) -> RankLayout:
    """``layout`` with its process groups: every rank, this rank's data
    group and its inner group.  A collective: every rank of the job
    creates every group, in one order.  One rank: no groups."""
    if layout.world == 1:
        return layout
    d, n = layout.shape

    def make(ranks):
        if len(ranks) == 1:
            return None
        return dist.group.WORLD if len(ranks) == layout.world else dist.new_group(ranks)

    data_groups = [make([i * n + j for i in range(d)]) for j in range(n)]
    inner_groups = [make([i * n + j for j in range(n)]) for i in range(d)]
    return dataclasses.replace(layout, group=dist.group.WORLD,
                               data_group=data_groups[layout.inner_index],
                               inner_group=inner_groups[layout.data_index])
