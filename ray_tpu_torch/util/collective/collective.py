"""Named collective groups over gloo. The twin of the part of
``ray_tpu/util/collective/collective.py`` (``:434-640``) that the
data-parallel gang calls.

``init_collective_group`` builds a ``torch.distributed.ProcessGroupGloo``
of its own over a ``Store`` and registers it under ``group_name``. It
never builds torch's default process group, so several ranks can live in
one process under different names: a test runs a gang as threads, each
rank holding its group over one shared ``HashStore``. Without a store,
the ranks meet through a ``TCPStore`` at ``MASTER_ADDR:MASTER_PORT``,
torch's own convention, one rank per process.

Ops move host tensors: a CUDA tensor or a numpy array is copied to a
contiguous CPU tensor first. ``allreduce`` reduces in place and returns
the tensor, as the reference's NCCL op does. Every op has a timeout,
30 s unless the group was made with another.
"""
from __future__ import annotations

import datetime
import os
import pickle
import threading

import torch
import torch.distributed as dist

from ray_tpu_torch.util.collective.async_handles import (CollectiveHandle,
                                                         CompletionQueue)

DEFAULT_TIMEOUT_S = 30.0
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "product": dist.ReduceOp.PRODUCT,
               "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


class _Group:
    __slots__ = ("name", "world_size", "rank", "pg", "timeout_s",
                 "completions")

    def __init__(self, name, world_size, rank, pg, timeout_s):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.pg = pg
        self.timeout_s = timeout_s
        self.completions = CompletionQueue(name)

    def submit(self, op: str, work, value) -> CollectiveHandle:
        return self.completions.put(
            work, CollectiveHandle(self.name, op, value, self.timeout_s))


_groups: dict[str, _Group] = {}
_groups_lock = threading.Lock()


def _get(group_name: str) -> _Group:
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


def init_collective_group(world_size: int, rank: int,
                          backend: str = "gloo",
                          group_name: str = "default", *,
                          store=None,
                          timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join this rank into a named group; returns when every rank has
    joined, or raises after ``timeout_s``. ``store`` is a
    ``torch.distributed.Store`` that the group's ranks share, used as it
    is; without one, a ``TCPStore`` prefixed by ``group_name``."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for world {world_size}")
    if backend != "gloo":
        raise ValueError(f"unknown backend {backend!r}: the port's groups "
                         f"are 'gloo' (the NCCL device backend is not "
                         f"ported yet)")
    with _groups_lock:
        if group_name in _groups:
            raise ValueError(f"collective group {group_name!r} already "
                             f"initialized in this process")
        # reserve the name: the ranks meet outside the lock, since each
        # waits in the constructor for the others
        _groups[group_name] = None
    try:
        timeout = datetime.timedelta(seconds=timeout_s)
        if store is None:
            store = dist.PrefixStore(group_name,
                                     _tcp_store(world_size, rank, timeout))
        pg = dist.ProcessGroupGloo(store, rank, world_size, timeout)
        group = _Group(group_name, world_size, rank, pg, float(timeout_s))
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


def destroy_collective_group(group_name: str = "default") -> bool:
    """Forget the group; its name is free again. False if it was not
    initialized."""
    with _groups_lock:
        if _groups.get(group_name) is None:
            return False
        group = _groups.pop(group_name)
    group.completions.close()
    return True


def supports_async(group_name: str = "default") -> bool:
    """True when the group can start ops asynchronously, which every gloo
    group can."""
    _get(group_name)
    return True


def is_group_initialized(group_name: str = "default") -> bool:
    return _groups.get(group_name) is not None


# ------------------------------------------------------------------ ops
def _host(tensor) -> torch.Tensor:
    if not isinstance(tensor, torch.Tensor):
        tensor = torch.as_tensor(tensor)
    return tensor.detach().cpu().contiguous()


def _reduce_opts(op: str):
    if op not in _REDUCE_OPS:
        raise ValueError(f"unknown reduce op {op!r}: one of "
                         f"{sorted(_REDUCE_OPS)}")
    return _REDUCE_OPS[op]


def allreduce_async(tensor, group_name: str = "default",
                    op: str = "sum") -> CollectiveHandle:
    """Start an allreduce; the handle resolves to the reduced tensor.
    Leave the tensor alone until the handle completes."""
    g = _get(group_name)
    arr = _host(tensor)
    opts = dist.AllreduceOptions()
    opts.reduceOp = _reduce_opts(op)
    return g.submit("allreduce", g.pg.allreduce([arr], opts), arr)


def allreduce(tensor, group_name: str = "default", op: str = "sum"):
    return allreduce_async(tensor, group_name, op).result()


def reducescatter_async(tensor, group_name: str = "default",
                        op: str = "sum") -> CollectiveHandle:
    """Start a reducescatter: rank r's handle resolves to chunk r of the
    reduction, split along dim 0 as ``torch.tensor_split`` splits it (the
    first ``n % world`` chunks one row longer)."""
    g = _get(group_name)
    arr = _host(tensor)
    chunks = list(torch.tensor_split(arr, g.world_size))
    out = torch.empty_like(chunks[g.rank])
    opts = dist.ReduceScatterOptions()
    opts.reduceOp = _reduce_opts(op)
    return g.submit("reducescatter",
                    g.pg.reduce_scatter([out], [chunks], opts), out)


def reducescatter(tensor, group_name: str = "default", op: str = "sum"):
    return reducescatter_async(tensor, group_name, op).result()


def allgather_async(tensor, group_name: str = "default") -> CollectiveHandle:
    """Start an allgather: the handle resolves to the list of every rank's
    tensor, in rank order. gloo takes only equal shapes on every rank."""
    g = _get(group_name)
    arr = _host(tensor)
    outs = [torch.empty_like(arr) for _ in range(g.world_size)]
    return g.submit("allgather", g.pg.allgather([outs], [arr]), outs)


def allgather(tensor, group_name: str = "default") -> list:
    return allgather_async(tensor, group_name).result()


def allgather_object(obj, group_name: str = "default") -> list:
    """Every rank's picklable ``obj``, in rank order. The object is
    pickled to bytes; the ranks allgather their byte counts, then their
    bytes zero-padded to the largest count (gloo's allgather takes equal
    sizes only), and each rank unpickles every rank's bytes."""
    data = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
    sizes = allgather(torch.tensor([data.numel()], dtype=torch.int64),
                      group_name)
    width = max(int(s) for s in sizes)
    padded = torch.zeros(width, dtype=torch.uint8)
    padded[:data.numel()] = data
    parts = allgather(padded, group_name)
    return [pickle.loads(part[:int(n)].numpy().tobytes())
            for part, n in zip(parts, sizes)]
