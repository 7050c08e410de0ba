"""Per-rank layout of the pipeline (``pp``) and sequence (``sp``) axes.
The start of the twin of ``ray_tpu/parallel/mesh.py`` (``MeshConfig``,
``:38``).

The JAX package builds one ``Mesh`` over every device and lets a
``shard_map`` name its axes. The port runs each rank as a thread or a
process of its own, so a rank gets its coordinates on the mesh and one
gloo group per axis: the ranks that share its ``sp`` coordinate form its
``pp`` group, and the ranks that share its ``pp`` coordinate its ``sp``
group. The groups are built here, over one ``torch.distributed.Store``
that every rank shares, each under a store prefix of its own. torch's
``DeviceMesh`` is not used: it builds its sub-groups from the one default
process group of a process, and the port's ranks may be threads of one
process (ROADMAP, ground rules).

Ranks are numbered as the JAX mesh orders its devices, slowest axis
first (dp, pp, ep, sp, tp): with ``dp``, ``ep`` and ``tp`` at 1, rank =
pp_rank * sp + sp_rank.
"""
from __future__ import annotations

import dataclasses

import torch.distributed as dist

from ray_tpu_torch.util import collective as col
from ray_tpu_torch.util.collective.collective import DEFAULT_TIMEOUT_S

_NOT_PORTED = ("the port's layout has the pp and sp axes only; {axis}={size} "
               "waits for mesh SPMD (ROADMAP Queue 1 item 2)")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """How many ways each axis splits the work. Only ``pp`` and ``sp`` are
    ported; each size is given, the JAX package's -1 (absorb the rest) is
    not."""

    dp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def __post_init__(self):
        for axis in ("dp", "ep", "tp"):
            size = getattr(self, axis)
            if size != 1:
                raise NotImplementedError(
                    _NOT_PORTED.format(axis=axis, size=size))
        for axis in ("pp", "sp"):
            if getattr(self, axis) < 1:
                raise ValueError(f"{axis}={getattr(self, axis)}: the port's "
                                 f"axis sizes are given, each at least 1")

    @property
    def world_size(self) -> int:
        return self.pp * self.sp


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """One rank's place on the mesh and the names of its axis groups."""

    config: MeshConfig
    rank: int
    pp_rank: int
    sp_rank: int
    pp_group: str
    sp_group: str

    @property
    def pp(self) -> int:
        return self.config.pp

    @property
    def sp(self) -> int:
        return self.config.sp

    @property
    def is_first_stage(self) -> bool:
        return self.pp_rank == 0

    @property
    def is_last_stage(self) -> bool:
        return self.pp_rank == self.config.pp - 1


def coordinates(config: MeshConfig, rank: int):
    """(pp_rank, sp_rank) of a global rank."""
    if not 0 <= rank < config.world_size:
        raise ValueError(f"rank {rank} out of range for a mesh of "
                         f"{config.world_size}")
    return divmod(rank, config.sp)


def init_rank_layout(config: MeshConfig, rank: int, *, store,
                     name: str = "mesh",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> RankLayout:
    """Join ``rank`` into its ``pp`` group and then its ``sp`` group over
    ``store``; returns when every member of both has joined, or raises
    after ``timeout_s``. Group names carry ``name`` and the global rank,
    so the ranks of one mesh may share a process."""
    pp_rank, sp_rank = coordinates(config, rank)
    pp_group = f"{name}_pp{sp_rank}_r{rank}"
    sp_group = f"{name}_sp{pp_rank}_r{rank}"
    col.init_collective_group(
        config.pp, pp_rank, group_name=pp_group, timeout_s=timeout_s,
        store=dist.PrefixStore(f"{name}/pp{sp_rank}", store))
    try:
        col.init_collective_group(
            config.sp, sp_rank, group_name=sp_group, timeout_s=timeout_s,
            store=dist.PrefixStore(f"{name}/sp{pp_rank}", store))
    except BaseException:
        col.destroy_collective_group(pp_group)
        raise
    return RankLayout(config, rank, pp_rank, sp_rank, pp_group, sp_group)


def destroy_rank_layout(layout: RankLayout) -> None:
    col.destroy_collective_group(layout.pp_group)
    col.destroy_collective_group(layout.sp_group)
