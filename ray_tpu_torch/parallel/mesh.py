"""Per-rank layout of the data (``dp``), pipeline (``pp``), expert
(``ep``), sequence (``sp``) and tensor (``tp``) axes. The twin of
``ray_tpu/parallel/mesh.py``'s ``MeshConfig``, ``AXIS_ORDER``,
``balanced_factorization``, ``mesh_shape_summary`` and
``validate_mesh_for_model``.

The JAX package builds one ``Mesh`` over every device and lets a
``shard_map`` name its axes. The port runs each rank as a thread or a
process of its own, so a rank gets its coordinates on the mesh and one
gloo group per axis: the ranks that differ from it in that axis's
coordinate alone. The groups are built here, over one
``torch.distributed.Store`` that every rank shares, each under a store
prefix that names the axis and every other coordinate. torch's
``DeviceMesh`` is not used: it builds its sub-groups from the one default
process group of a process, and the port's ranks may be threads of one
process (ROADMAP, ground rules).

Ranks are numbered as the JAX mesh orders its devices, slowest axis
first (``AXIS_ORDER``: dp, pp, ep, sp, tp), as ``create_mesh`` reshapes
the device list: rank = (((dp_rank * pp + pp_rank) * ep + ep_rank) * sp
+ sp_rank) * tp + tp_rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import torch.distributed as dist

from ray_tpu_torch.util import collective as col
from ray_tpu_torch.util.collective.collective import DEFAULT_TIMEOUT_S

# Canonical axis order, slowest- to fastest-varying, as the JAX package's.
AXIS_ORDER = ("dp", "pp", "ep", "sp", "tp")
# the axes a rank layout holds groups for: every one, in AXIS_ORDER
LAYOUT_AXES = AXIS_ORDER


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """How many ways each axis splits the work: the batch over ``dp``, the
    layers over ``pp``, the MoE experts over ``ep``, the sequence over
    ``sp``, the heads, MLP hidden and vocab over ``tp``. Any one axis may
    be -1, which ``resolved`` turns into what the others leave of a device
    count. Which combinations a model runs on is the model's to say
    (``gpt2.forward_pipelined``)."""

    dp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def __post_init__(self):
        for axis in AXIS_ORDER:
            size = getattr(self, axis)
            if size < 1 and size != -1:
                raise ValueError(f"{axis}={size}: an axis size is at least "
                                 f"1, or -1 to absorb the rest")

    def resolved(self, n_devices: int) -> "MeshConfig":
        """The config with its -1 axis (at most one) sized so that the
        axes multiply to ``n_devices``; raises if they cannot."""
        sizes = self.axis_sizes()
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError("At most one mesh axis may be -1")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {sizes}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"Mesh {sizes} needs {fixed} devices but {n_devices} present")
        return MeshConfig(**sizes)

    def axis_sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    @property
    def world_size(self) -> int:
        sizes = self.axis_sizes()
        if -1 in sizes.values():
            raise ValueError(f"{sizes} has an axis at -1: resolve it first "
                             f"(MeshConfig.resolved)")
        return math.prod(sizes.values())


def balanced_factorization(n: int, axes: Sequence[str]) -> Dict[str, int]:
    """Split n devices over ``axes`` as evenly as possible: factors of 2
    round-robin over the axes, an odd remainder to the first."""
    sizes = {a: 1 for a in axes}
    remaining = n
    axes = list(axes)
    i = 0
    while remaining % 2 == 0 and remaining > 1:
        sizes[axes[i % len(axes)]] *= 2
        remaining //= 2
        i += 1
    if remaining > 1:
        sizes[axes[0]] *= remaining
    return sizes


def _shape(mesh) -> Dict[str, int]:
    """The axis sizes of a ``MeshConfig`` or a ``RankLayout``."""
    config = getattr(mesh, "config", mesh)
    return config.axis_sizes()


def mesh_shape_summary(mesh) -> str:
    """``dp=2xpp=2x...`` over every axis of a ``MeshConfig`` or a
    ``RankLayout``, as the JAX package prints a ``Mesh``'s shape."""
    return "x".join(f"{k}={v}" for k, v in _shape(mesh).items())


def validate_mesh_for_model(mesh, *, n_heads: int,
                            n_layers: int) -> List[str]:
    """The problems of running a model of ``n_heads`` heads and
    ``n_layers`` layers on a ``MeshConfig`` or ``RankLayout``, as
    readable lines; none when it fits."""
    problems = []
    shape = _shape(mesh)
    if n_heads % shape["tp"] != 0:
        problems.append(f"n_heads={n_heads} not divisible by tp={shape['tp']}")
    if n_layers % shape["pp"] != 0:
        problems.append(f"n_layers={n_layers} not divisible by "
                        f"pp={shape['pp']}")
    return problems


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """One rank's place on the mesh and the names of its axis groups: its
    coordinate on each axis (``dp_rank``, ``pp_rank``, ``ep_rank``,
    ``sp_rank``, ``tp_rank``) and the group of the ranks that differ from
    it on that axis alone."""

    config: MeshConfig
    rank: int
    dp_rank: int
    pp_rank: int
    sp_rank: int
    dp_group: str
    pp_group: str
    sp_group: str
    # last and defaulted, so that a layout built by hand without tp (and
    # the positional constructions of the layouts before it) still reads
    tp_rank: int = 0
    tp_group: Optional[str] = None
    ep_rank: int = 0
    ep_group: Optional[str] = None

    @property
    def dp(self) -> int:
        return self.config.dp

    @property
    def pp(self) -> int:
        return self.config.pp

    @property
    def ep(self) -> int:
        return self.config.ep

    @property
    def sp(self) -> int:
        return self.config.sp

    @property
    def tp(self) -> int:
        return self.config.tp

    @property
    def is_first_stage(self) -> bool:
        return self.pp_rank == 0

    @property
    def is_last_stage(self) -> bool:
        return self.pp_rank == self.config.pp - 1


def coordinates(config: MeshConfig, rank: int):
    """(dp_rank, pp_rank, ep_rank, sp_rank, tp_rank) of a global rank: its
    device's index on each axis of ``create_mesh``'s array of the same
    sizes, in ``AXIS_ORDER``."""
    if not 0 <= rank < config.world_size:
        raise ValueError(f"rank {rank} out of range for a mesh of "
                         f"{config.world_size}")
    coords = []
    for axis in reversed(AXIS_ORDER):
        rank, c = divmod(rank, getattr(config, axis))
        coords.append(c)
    return tuple(reversed(coords))


def init_rank_layout(config: MeshConfig, rank: int, *, store,
                     name: str = "mesh",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> RankLayout:
    """Join ``rank`` into its ``dp``, ``pp``, ``ep``, ``sp`` and ``tp``
    groups over ``store``, in that order; returns when every member of all
    five has joined, or raises after ``timeout_s``. A group's store prefix
    names its axis and the rank's coordinates on the other four, so no
    two groups share a key; group names carry ``name`` and the global rank,
    so the ranks of one mesh may share a process."""
    coords = dict(zip(LAYOUT_AXES, coordinates(config, rank)))
    groups = {}
    try:
        for axis in LAYOUT_AXES:
            others = "_".join(f"{a}{coords[a]}" for a in LAYOUT_AXES
                              if a != axis)
            group = f"{name}_{axis}_{others}_r{rank}"
            col.init_collective_group(
                getattr(config, axis), coords[axis], group_name=group,
                timeout_s=timeout_s,
                store=dist.PrefixStore(f"{name}/{axis}/{others}", store))
            groups[axis] = group
    except BaseException:
        for group in groups.values():
            col.destroy_collective_group(group)
        raise
    return RankLayout(config, rank, coords["dp"], coords["pp"], coords["sp"],
                      groups["dp"], groups["pp"], groups["sp"],
                      coords["tp"], groups["tp"], coords["ep"], groups["ep"])


def destroy_rank_layout(layout: RankLayout) -> None:
    for group in (layout.dp_group, layout.pp_group, layout.sp_group,
                  layout.tp_group, layout.ep_group):
        if group is not None:
            col.destroy_collective_group(group)
