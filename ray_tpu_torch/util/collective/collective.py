"""Named collective groups on three backends. The twin of the part of
``ray_tpu/util/collective/collective.py`` (``:434-705``) that the
data-parallel gang, the pipeline and the mesh call, with its backend
choice (``:333``, ``:367``).

``init_collective_group(..., backend=)`` joins this rank into a group
registered under ``group_name``, over a ``torch.distributed.Store`` the
ranks share. It never builds torch's default process group, so several
ranks can live in one process under different names: a test runs a gang
as threads, each rank holding its group over one shared ``HashStore``.
Without a store, the ranks meet through a ``TCPStore`` at
``MASTER_ADDR:MASTER_PORT``, torch's own convention, one rank per
process. The backends share one API:

* ``"gloo"`` (``gloo_backend.GlooGroup``): host tensors. A CUDA tensor
  is copied to the host first and the results are host tensors. Ranks in
  one process or in several.
* ``"device"`` (``device_backend.DeviceGroup``): ranks that are threads
  of one process, on one device or several, exchanging through device
  memory; results stay on their inputs' devices. The twin of the JAX
  package's ``"xla"`` backend and of the collectives XLA compiles into a
  mesh step.
* ``"nccl"`` (``nccl_backend.NcclGroup``): ranks in separate processes,
  each on its own CUDA device; results stay on the device.

``"device"`` and ``"nccl"`` never stage a CUDA tensor through the host
and never build a gloo group: an error raises, there is no fallback.
Every op has a timeout, 30 s unless the group was made with another.
Use the tensor an op returns: gloo's and NCCL's ``allreduce`` write into
their (host or device) tensor, the device group's returns a new one.

Point to point: ``send`` and ``recv`` pair in order on each channel
(sender, receiver), and ``recv`` returns the tensor without being told
its shape; ``sendrecv`` is one hop of a ring. ``send_device`` and
``recv_device`` are the twin's matched device-resident pair, on a device
or NCCL group.

``abort_collective_group`` poisons a group: every pending and later op
of its members in this process raises ``CollectiveGroupError`` at once
(``poison_on_error`` does it for a rank whose code raises).
"""
from __future__ import annotations

import contextlib
import datetime
import os
import threading

import torch
import torch.distributed as dist

from ray_tpu_torch.util.collective.async_handles import CollectiveHandle

DEFAULT_TIMEOUT_S = 30.0
BACKENDS = ("gloo", "device", "nccl")

_groups: dict = {}
_groups_lock = threading.Lock()


def _get(group_name: str):
    group = _groups.get(group_name)  # None while its ranks are meeting
    if group is None:
        raise ValueError(
            f"collective group {group_name!r} not initialized in this "
            f"process: call init_collective_group first")
    return group


def _tcp_store(world_size: int, rank: int, timeout):
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ.get("MASTER_PORT")
    if port is None:
        raise ValueError("init_collective_group needs store= or "
                         "MASTER_ADDR and MASTER_PORT to meet its peers")
    return dist.TCPStore(addr, int(port), world_size, rank == 0,
                         timeout=timeout)


def _make_group(backend, group_name, world_size, rank, store, timeout_s,
                device):
    if backend == "gloo":
        if device is not None:
            raise ValueError("a gloo group moves host tensors: it takes no "
                             "device=")
        from ray_tpu_torch.util.collective.gloo_backend import GlooGroup
        return GlooGroup(group_name, world_size, rank, store, timeout_s)
    if backend == "device":
        from ray_tpu_torch.util.collective.device_backend import DeviceGroup
        return DeviceGroup(group_name, world_size, rank, store, timeout_s,
                           device)
    from ray_tpu_torch.util.collective.nccl_backend import NcclGroup
    return NcclGroup(group_name, world_size, rank, store, timeout_s, device)


def init_collective_group(world_size: int, rank: int,
                          backend: str = "gloo",
                          group_name: str = "default", *,
                          store=None,
                          timeout_s: float = DEFAULT_TIMEOUT_S,
                          device=None):
    """Join this rank into a named group on ``backend`` (``"gloo"``,
    ``"device"`` or ``"nccl"``); returns when every rank has joined, or
    raises after ``timeout_s``. ``store`` is a ``torch.distributed.Store``
    that the group's ranks share, used as it is; without one, a
    ``TCPStore`` prefixed by ``group_name``. ``device`` (device and NCCL
    groups) is this rank's device: where ``recv`` puts what it receives,
    and the NCCL rank's binding."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for world {world_size}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: the port's are "
                         f"{', '.join(repr(b) for b in BACKENDS)}")
    with _groups_lock:
        if group_name in _groups:
            raise ValueError(f"collective group {group_name!r} already "
                             f"initialized in this process")
        # reserve the name: the ranks meet outside the lock, since each
        # waits in the constructor for the others
        _groups[group_name] = None
    try:
        if store is None:
            store = dist.PrefixStore(group_name, _tcp_store(
                world_size, rank, datetime.timedelta(seconds=timeout_s)))
        group = _make_group(backend, group_name, world_size, rank, store,
                            float(timeout_s), device)
    except BaseException:
        with _groups_lock:
            del _groups[group_name]
        raise
    with _groups_lock:
        _groups[group_name] = group
    return group


def get_rank(group_name: str = "default") -> int:
    return _get(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _get(group_name).world_size


def get_backend(group_name: str = "default") -> str:
    return _get(group_name).backend


def keeps_device(group_name: str = "default") -> bool:
    """True when the group's results stay on their inputs' devices
    (``"device"``, ``"nccl"``); False for gloo, whose are host tensors."""
    return _get(group_name).keeps_device


def destroy_collective_group(group_name: str = "default") -> bool:
    """Forget the group; its name is free again. False if it was not
    initialized."""
    with _groups_lock:
        if _groups.get(group_name) is None:
            return False
        group = _groups.pop(group_name)
    group.close()
    return True


def abort_collective_group(group_name: str = "default", dead_ranks=(),
                           reason: str = "") -> bool:
    """Poison the group: every pending and later op of its members in this
    process raises ``CollectiveGroupError`` naming ``dead_ranks``, at once
    (the first report wins). False if it was not initialized."""
    group = _groups.get(group_name)
    if group is None:
        return False
    group.abort(dead_ranks, reason)
    return True


@contextlib.contextmanager
def poison_on_error(*group_names: str):
    """Run a rank's code; if it raises, abort each of ``group_names``
    naming this rank as dead, so the peers fail at once instead of
    waiting out the timeout, and re-raise."""
    try:
        yield
    except BaseException as e:
        for name in group_names:
            group = _groups.get(name)
            if group is not None:
                group.abort([group.rank], f"rank {group.rank} raised "
                                          f"{type(e).__name__}: {e}")
        raise


def supports_async(group_name: str = "default") -> bool:
    """True when the group can start ops asynchronously, which every
    group can."""
    _get(group_name)
    return True


def is_group_initialized(group_name: str = "default") -> bool:
    return _groups.get(group_name) is not None


# ------------------------------------------------------------------ ops
def _start(group_name: str, op: str, *args) -> CollectiveHandle:
    """A handle for ``op``: gloo's completes in the background, a device
    or NCCL group's host part runs now (its work is on the stream)."""
    g = _get(group_name)
    start = getattr(g, f"{op}_async", None)
    if start is not None:
        return start(*args)
    return CollectiveHandle.completed(group_name, op, getattr(g, op)(*args))


def allreduce_async(tensor, group_name: str = "default",
                    op: str = "sum") -> CollectiveHandle:
    """Start an allreduce; the handle resolves to the reduced tensor.
    Leave the tensor alone until the handle completes."""
    return _start(group_name, "allreduce", tensor, op)


def allreduce(tensor, group_name: str = "default", op: str = "sum"):
    return allreduce_async(tensor, group_name, op).result()


def reducescatter_async(tensor, group_name: str = "default",
                        op: str = "sum") -> CollectiveHandle:
    """Start a reducescatter: rank r's handle resolves to chunk r of the
    reduction, split along dim 0 as ``torch.tensor_split`` splits it (the
    first ``n % world`` chunks one row longer)."""
    return _start(group_name, "reducescatter", tensor, op)


def reducescatter(tensor, group_name: str = "default", op: str = "sum"):
    return reducescatter_async(tensor, group_name, op).result()


def allgather_async(tensor, group_name: str = "default") -> CollectiveHandle:
    """Start an allgather: the handle resolves to the list of every rank's
    tensor, in rank order. gloo and NCCL take only equal shapes."""
    return _start(group_name, "allgather", tensor)


def allgather(tensor, group_name: str = "default") -> list:
    return allgather_async(tensor, group_name).result()


def allgather_object(obj, group_name: str = "default") -> list:
    """Every rank's picklable ``obj``, in rank order, each a copy."""
    return _get(group_name).allgather_object(obj)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    """Every rank's copy of ``src_rank``'s tensor; the other ranks pass a
    tensor of its shape and dtype, which gets the copy (gloo: the host
    copy of it)."""
    return _get(group_name).broadcast(tensor, src_rank)


def barrier(group_name: str = "default") -> None:
    """Returns when every rank of the group has called it."""
    _get(group_name).barrier()


# ------------------------------------------------------- point to point
_NO_WIRE = ("the quantized wire (wire_dtype) is not ported yet: see "
            "ROADMAP Queue 1, 'left out of earlier slices'")


def send(tensor, dst_rank: int, group_name: str = "default",
         wire_dtype: str | None = None) -> None:
    """Send ``tensor`` to ``dst_rank``; returns once that rank has
    received it (an NCCL group: once the send is on the stream), or
    raises after the group's timeout. ``wire_dtype`` (the reference's
    quantized hop) is not ported."""
    if wire_dtype is not None:
        raise NotImplementedError(_NO_WIRE)
    _get(group_name).send(tensor, dst_rank)


def recv(src_rank: int, group_name: str = "default") -> torch.Tensor:
    """The next tensor ``src_rank`` sends this rank, of the sent shape and
    dtype: a host tensor from gloo, on this rank's device from a device
    or NCCL group; raises after the group's timeout."""
    return _get(group_name).recv(src_rank)


def sendrecv(tensor, dst_rank: int, src_rank: int,
             group_name: str = "default") -> torch.Tensor:
    """One hop of a ring: send ``tensor`` to ``dst_rank`` while receiving
    the next tensor from ``src_rank``; returns the received one."""
    return _get(group_name).sendrecv(tensor, dst_rank, src_rank)


def _device_group(group_name: str, what: str):
    g = _get(group_name)
    if not g.keeps_device:
        raise ValueError(f"{what} requires a 'device' or 'nccl' collective "
                         f"group; {group_name!r} is {g.backend!r}")
    return g


def send_device(tensor, dst_rank: int, group_name: str = "default") -> None:
    """Device-resident point-to-point send (device and NCCL groups only):
    the payload never stages through the host. Matched-call contract: the
    peer calls ``recv_device`` with the same shape and dtype, in the same
    order."""
    g = _device_group(group_name, "send_device")
    if not isinstance(tensor, torch.Tensor):
        raise TypeError(f"send_device takes a tensor, got "
                        f"{type(tensor).__name__}")
    g.send(tensor, dst_rank)


def recv_device(shape, dtype, src_rank: int,
                group_name: str = "default") -> torch.Tensor:
    """Device-resident point-to-point receive (pairs with
    ``send_device``): the payload on this rank's device, of ``shape`` and
    ``dtype`` (a mismatch with what was sent raises)."""
    g = _device_group(group_name, "recv_device")
    out = g.recv(src_rank)
    if tuple(out.shape) != tuple(shape) or out.dtype != dtype:
        raise ValueError(f"recv_device: rank {src_rank} sent {out.dtype} "
                         f"{tuple(out.shape)}, expected {dtype} "
                         f"{tuple(shape)}")
    return out
