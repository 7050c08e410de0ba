"""The mesh of the data (``dp``), pipeline (``pp``), expert (``ep``),
sequence (``sp``) and tensor (``tp``) axes, and each rank's layout on
it. The twin of ``ray_tpu/parallel/mesh.py``: ``MeshConfig``,
``AXIS_ORDER``, ``create_mesh``, ``single_device_mesh``,
``balanced_factorization``, ``mesh_shape_summary``,
``validate_mesh_for_model``, ``group_devices_by_slice`` and
``create_hybrid_mesh``. ``timed_mesh_build`` is the JAX package's
compile telemetry and is left out: building a ``Mesh`` here compiles
nothing.

The JAX package builds one ``Mesh`` over every device and lets a
``shard_map`` name its axes. The port's ``Mesh`` is the same array of
devices in ``AXIS_ORDER``'s shape, but the port runs each rank as a
thread or a process of its own: rank r, at flat index r of the array,
joins the mesh (``Mesh.join``) and gets its coordinates on it and one
collective group per axis: the ranks that differ from it in that axis's
coordinate alone. The groups are built here, over one
``torch.distributed.Store`` that every rank shares, each under a store
prefix that names the axis and every other coordinate. They run on the
``"device"`` backend by default, since the JAX mesh's collectives are
device collectives: rank threads exchange through device memory, and a
CUDA tensor stays on the card (``util/collective/device_backend.py``);
``backend="gloo"`` stays selectable. torch's ``DeviceMesh`` is not used:
it builds its sub-groups from the one default process group of a
process, and the port's ranks may be threads of one process (ROADMAP,
ground rules).

Ranks are numbered as the JAX mesh orders its devices, slowest axis
first (``AXIS_ORDER``: dp, pp, ep, sp, tp), as ``create_mesh`` reshapes
the device list: rank = (((dp_rank * pp + pp_rank) * ep + ep_rank) * sp
+ sp_rank) * tp + tp_rank.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
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
    """The axis sizes of a ``Mesh``, a ``MeshConfig`` or a
    ``RankLayout``."""
    config = getattr(mesh, "config", mesh)
    return config.axis_sizes()


def mesh_shape_summary(mesh) -> str:
    """``dp=2xpp=2x...`` over every axis of a ``Mesh``, a ``MeshConfig``
    or a ``RankLayout``, as the JAX package prints a ``Mesh``'s shape."""
    return "x".join(f"{k}={v}" for k, v in _shape(mesh).items())


def validate_mesh_for_model(mesh, *, n_heads: int,
                            n_layers: int) -> List[str]:
    """The problems of running a model of ``n_heads`` heads and
    ``n_layers`` layers on a ``Mesh``, a ``MeshConfig`` or a
    ``RankLayout``, as readable lines; none when it fits."""
    problems = []
    shape = _shape(mesh)
    if n_heads % shape["tp"] != 0:
        problems.append(f"n_heads={n_heads} not divisible by tp={shape['tp']}")
    if n_layers % shape["pp"] != 0:
        problems.append(f"n_layers={n_layers} not divisible by "
                        f"pp={shape['pp']}")
    return problems


class Mesh:
    """The twin of ``jax.sharding.Mesh`` over ``AXIS_ORDER``: ``devices``,
    an object array of ``torch.device`` in the axes' shape (slowest axis
    first), and the resolved ``config``. Rank r is the device at flat
    index r, at ``coordinates(config, r)``. Rank threads that share one
    card name it once each (``devices=[cuda:0] * 4``)."""

    axis_names = AXIS_ORDER

    def __init__(self, devices: np.ndarray, config: MeshConfig):
        sizes = config.axis_sizes()
        if devices.shape != tuple(sizes[a] for a in AXIS_ORDER):
            raise ValueError(f"devices of shape {devices.shape} for a mesh "
                             f"of {sizes}")
        self.devices = devices
        self.config = config

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        """Every axis's size, in ``AXIS_ORDER``, as ``Mesh.shape``."""
        return collections.OrderedDict(self.config.axis_sizes())

    @property
    def size(self) -> int:
        return self.devices.size

    def device(self, rank: int) -> torch.device:
        """Rank ``rank``'s device."""
        return self.devices.flat[rank]

    def join(self, rank: int, *, store=None, name: str = "mesh",
             timeout_s: float = DEFAULT_TIMEOUT_S,
             backend: str = "device") -> "RankLayout":
        """Rank ``rank``'s layout on this mesh, its groups joined over
        ``store`` on ``backend`` (``init_rank_layout``), carrying the mesh
        and the rank's device. Every rank of the mesh calls it, each with
        the same ``store``; a mesh of one rank needs none."""
        if store is None:
            if self.size > 1:
                raise ValueError(f"a mesh of {self.size} ranks joins over "
                                 f"a store that every rank shares")
            store = dist.HashStore()
        layout = init_rank_layout(
            self.config, rank, store=store, name=name, timeout_s=timeout_s,
            backend=backend,
            device=None if backend == "gloo" else self.device(rank))
        return dataclasses.replace(layout, mesh=self,
                                   device=self.device(rank))

    def __repr__(self) -> str:
        return (f"Mesh({mesh_shape_summary(self)}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def _all_devices() -> List[torch.device]:
    """Every CUDA device; raises without one, as the entry points do."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch builds its meshes over the CUDA devices and none "
            "is available; pass devices=, e.g. [torch.device('cpu')] * n")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _device_array(devices: Sequence, shape) -> np.ndarray:
    out = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        out[i] = torch.device(d)
    return out.reshape(shape)


def create_mesh(config: Optional[MeshConfig] = None, *,
                devices: Optional[Sequence] = None,
                axes: Optional[Dict[str, int]] = None) -> Mesh:
    """A ``Mesh`` over ``devices`` (every CUDA device by default), its
    config resolved to their count (``axes`` stands for the config, all
    on ``dp`` by default), the device list reshaped to the axes' sizes
    in ``AXIS_ORDER``, as the JAX package lays out CPU devices. There is
    no interconnect topology to map the axes onto on a card, so the
    reshape is the layout."""
    if config is None:
        config = MeshConfig(**(axes or {"dp": -1}))
    devices = list(devices if devices is not None else _all_devices())
    config = config.resolved(len(devices))
    sizes = config.axis_sizes()
    return Mesh(_device_array(devices, tuple(sizes[a] for a in AXIS_ORDER)),
                config)


def single_device_mesh(device=None) -> Mesh:
    """A mesh of one rank on ``device`` (the first CUDA device by
    default)."""
    device = device if device is not None else _all_devices()[0]
    return create_mesh(MeshConfig(), devices=[device])


def group_devices_by_slice(devices: Sequence) -> Dict[int, list]:
    """Devices grouped by their slice (``slice_index``): a
    ``torch.device`` has none, so every one lands in slice 0, as the JAX
    twin puts CPU devices."""
    groups: Dict[int, list] = {}
    for d in devices:
        groups.setdefault(getattr(d, "slice_index", 0), []).append(d)
    return groups


def create_hybrid_mesh(config: Optional[MeshConfig] = None, *,
                       dcn_dp: int = -1, devices: Optional[Sequence] = None,
                       axes: Optional[Dict[str, int]] = None,
                       slice_assignments: Optional[Sequence[int]] = None
                       ) -> Mesh:
    """Multi-slice mesh: ``dp`` spans the slices, every other axis stays
    inside a slice. ``config``/``axes`` describe the within-slice
    sharding (all on ``tp`` by default), ``dcn_dp`` the between-slice dp
    degree (-1: one dp shard a slice); the mesh's dp is ``dcn_dp *
    config.dp``. ``slice_assignments`` forces a slice id a device.

    The JAX twin's checks and messages, and its slice-major layout: the
    devices in slice order, so that dp's index is the slice for the
    between-slice part. The card has no topology to query, so that
    order is the layout."""
    devices = list(devices if devices is not None else _all_devices())
    if slice_assignments is not None:
        if len(slice_assignments) != len(devices):
            raise ValueError(
                f"slice_assignments has {len(slice_assignments)} entries "
                f"for {len(devices)} devices")
        groups: Dict[int, list] = {}
        for d, s in zip(devices, slice_assignments):
            groups.setdefault(s, []).append(d)
    else:
        groups = group_devices_by_slice(devices)
    n_slices = len(groups)
    if dcn_dp == -1:
        dcn_dp = n_slices
    if dcn_dp != n_slices:
        raise ValueError(
            f"dcn_dp={dcn_dp} but {n_slices} slices present (one dp shard "
            f"per slice is the supported DCN layout)")
    sizes = sorted(len(g) for g in groups.values())
    if sizes[0] != sizes[-1]:
        raise ValueError(f"uneven slices: {sizes}")
    if config is None:
        config = MeshConfig(**(axes or {"tp": -1}))
    config = config.resolved(sizes[0])
    ordered: list = []
    for s in sorted(groups):
        ordered.extend(groups[s])
    mesh_sizes = dict(config.axis_sizes(), dp=dcn_dp * config.dp)
    return Mesh(_device_array(ordered, tuple(mesh_sizes[a]
                                             for a in AXIS_ORDER)),
                MeshConfig(**mesh_sizes))


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """One rank's place on the mesh and the names of its axis groups: its
    coordinate on each axis (``dp_rank``, ``pp_rank``, ``ep_rank``,
    ``sp_rank``, ``tp_rank``) and the group of the ranks that differ from
    it on that axis alone; joined from a ``Mesh``, the mesh and the
    rank's device."""

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
    mesh: Optional[Mesh] = None
    device: Optional[torch.device] = None

    @property
    def world_size(self) -> int:
        return self.config.world_size

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


def rank_layout(mesh):
    """(the rank layout a function of the port runs on for its ``mesh``
    argument, the device that argument names): (None, None) for no mesh;
    for a ``Mesh`` or a ``RankLayout`` of one rank, no layout (the
    one-device path: there is no collective to schedule) and its device;
    for a ``RankLayout`` of several ranks, itself and its device. A
    ``Mesh`` of several ranks is refused: each rank passes its own layout
    (``Mesh.join``)."""
    if mesh is None:
        return None, None
    if isinstance(mesh, Mesh):
        if mesh.size > 1:
            raise TypeError(
                f"a mesh of {mesh.size} ranks: pass this rank's layout, "
                f"mesh.join(rank, store=...)")
        return None, mesh.device(0)
    return (mesh if mesh.world_size > 1 else None), mesh.device


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
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     backend: str = "device", device=None) -> RankLayout:
    """Join ``rank`` into its ``dp``, ``pp``, ``ep``, ``sp`` and ``tp``
    groups over ``store``, in that order, on ``backend`` (``"device"``,
    ``"gloo"`` or ``"nccl"``; ``device`` is the rank's, for the device
    and NCCL groups); returns when every member of all five has joined,
    or raises after ``timeout_s``. A group's store prefix names its axis
    and the rank's coordinates on the other four, so no two groups share
    a key; group names carry ``name`` and the global rank, so the ranks
    of one mesh may share a process."""
    coords = dict(zip(LAYOUT_AXES, coordinates(config, rank)))
    groups = {}
    try:
        for axis in LAYOUT_AXES:
            others = "_".join(f"{a}{coords[a]}" for a in LAYOUT_AXES
                              if a != axis)
            group = f"{name}_{axis}_{others}_r{rank}"
            col.init_collective_group(
                getattr(config, axis), coords[axis], backend,
                group_name=group, timeout_s=timeout_s, device=device,
                store=dist.PrefixStore(f"{name}/{axis}/{others}", store))
            groups[axis] = group
    except BaseException:
        for group in groups.values():
            col.destroy_collective_group(group)
        raise
    return RankLayout(config, rank, coords["dp"], coords["pp"], coords["sp"],
                      groups["dp"], groups["pp"], groups["sp"],
                      coords["tp"], groups["tp"], coords["ep"], groups["ep"])


def layout_groups(layout: RankLayout) -> List[str]:
    """The names of a layout's axis groups."""
    return [g for g in (layout.dp_group, layout.pp_group, layout.sp_group,
                        layout.tp_group, layout.ep_group) if g is not None]


def destroy_rank_layout(layout: RankLayout) -> None:
    for group in layout_groups(layout):
        col.destroy_collective_group(group)
