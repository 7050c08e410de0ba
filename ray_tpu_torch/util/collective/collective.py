"""Named collective groups over gloo. The twin of the part of
``ray_tpu/util/collective/collective.py`` (``:434-705``) that the
data-parallel gang and the pipeline call.

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

Point to point: ``send`` and ``recv`` pair in order on each channel
(sender, receiver). A message is a small header (dtype and shape) and its
payload, each under a gloo tag of its own drawn from the channel's
sequence, so ``recv`` returns the tensor without being told its shape, as
the reference's does. gloo's send completes only once the peer has posted
the matching receive, so a ``send`` blocks until then; ``sendrecv`` is one
hop of a ring (every member sends to one peer and receives from another
at once), which a blocking send before a receive would deadlock.
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
                 "completions", "p2p_seq")

    def __init__(self, name, world_size, rank, pg, timeout_s):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.pg = pg
        self.timeout_s = timeout_s
        self.completions = CompletionQueue(name)
        self.p2p_seq = {}  # (sender, receiver) -> messages so far

    def p2p_tag(self, src: int, dst: int) -> int:
        """The header's tag of the channel's next message; its payload's
        is one more."""
        seq = self.p2p_seq.get((src, dst), 0)
        self.p2p_seq[(src, dst)] = seq + 1
        return 2 * (seq % (1 << 29))

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


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    """Every rank's copy of ``src_rank``'s tensor, returned as a host
    tensor; the other ranks pass a tensor of its shape and dtype."""
    g = _get(group_name)
    arr = _host(tensor)
    opts = dist.BroadcastOptions()
    opts.rootRank = src_rank
    return g.submit("broadcast", g.pg.broadcast([arr], opts), arr).result()


def barrier(group_name: str = "default") -> None:
    """Returns when every rank of the group has called it."""
    g = _get(group_name)
    g.submit("barrier", g.pg.barrier(dist.BarrierOptions()), None).result()


# ------------------------------------------------------- point to point
_WIRE_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
                torch.int64, torch.int32, torch.int16, torch.int8,
                torch.uint8, torch.bool)
_MAX_DIMS = 8
_NO_WIRE = ("the quantized wire (wire_dtype) is not ported yet: see "
            "ROADMAP Queue 1, 'left out of earlier slices'")


def _start_send(g: _Group, tensor, dst_rank: int) -> list:
    arr = _host(tensor)
    if arr.dtype not in _WIRE_DTYPES or arr.dim() > _MAX_DIMS:
        raise ValueError(f"send takes up to {_MAX_DIMS} dims of "
                         f"{_WIRE_DTYPES}; got {arr.dtype} {tuple(arr.shape)}")
    header = torch.zeros(2 + _MAX_DIMS, dtype=torch.int64)
    header[0] = _WIRE_DTYPES.index(arr.dtype)
    header[1] = arr.dim()
    header[2:2 + arr.dim()] = torch.tensor(arr.shape, dtype=torch.int64)
    tag = g.p2p_tag(g.rank, dst_rank)
    # the tensors stay referenced by this list until the sends complete
    return [(g.pg.send([header], dst_rank, tag), header),
            (g.pg.send([arr], dst_rank, tag + 1), arr)]


def _wait(works) -> None:
    """gloo fails a send or receive after the group's timeout."""
    for work, _ in works:
        work.wait()


def _recv(g: _Group, src_rank: int) -> torch.Tensor:
    tag = g.p2p_tag(src_rank, g.rank)
    header = torch.empty(2 + _MAX_DIMS, dtype=torch.int64)
    g.pg.recv([header], src_rank, tag).wait()
    code, ndim = int(header[0]), int(header[1])
    out = torch.empty(header[2:2 + ndim].tolist(), dtype=_WIRE_DTYPES[code])
    g.pg.recv([out], src_rank, tag + 1).wait()
    return out


def send(tensor, dst_rank: int, group_name: str = "default",
         wire_dtype: str | None = None) -> None:
    """Send ``tensor`` to ``dst_rank``; returns once that rank has
    received it, or raises after the group's timeout. ``wire_dtype``
    (the reference's quantized hop) is not ported."""
    if wire_dtype is not None:
        raise NotImplementedError(_NO_WIRE)
    g = _get(group_name)
    _wait(_start_send(g, tensor, dst_rank))


def recv(src_rank: int, group_name: str = "default") -> torch.Tensor:
    """The next tensor ``src_rank`` sends this rank, as a host tensor of
    the sent shape and dtype; raises after the group's timeout."""
    return _recv(_get(group_name), src_rank)


def sendrecv(tensor, dst_rank: int, src_rank: int,
             group_name: str = "default") -> torch.Tensor:
    """One hop of a ring: send ``tensor`` to ``dst_rank`` while receiving
    the next tensor from ``src_rank``; returns the received one."""
    g = _get(group_name)
    works = _start_send(g, tensor, dst_rank)
    out = _recv(g, src_rank)
    _wait(works)
    return out
