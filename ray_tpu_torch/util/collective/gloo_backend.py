"""The gloo collective backend: ``GlooGroup``, a
``torch.distributed.ProcessGroupGloo`` of its own over the group's
store. It moves host tensors: a CUDA tensor or a numpy array is copied to
a contiguous CPU tensor first, and results are host tensors.
``allreduce`` and ``broadcast`` write into that host tensor and return
it, as the reference's NCCL ops do. Its ranks may be threads of one
process or separate processes.

Point to point: ``send`` and ``recv`` pair in order on each channel
(sender, receiver). A message is a small header (dtype and shape) and its
payload, each under a gloo tag of its own drawn from the channel's
sequence, so ``recv`` returns the tensor without being told its shape, as
the reference's does. gloo's send completes only once the peer has posted
the matching receive, so a ``send`` blocks until then; ``sendrecv`` is one
hop of a ring (every member sends to one peer and receives from another
at once), which a blocking send before a receive would deadlock.

The members of one incarnation that live in one process share its
poison (``device_backend.Exchange``, under the group's token): aborting
any of them fails every member's pending handles and later ops with
``CollectiveGroupError``. gloo's own ``Work`` still runs to its timeout.
"""
from __future__ import annotations

import datetime
import pickle

import torch
import torch.distributed as dist

from ray_tpu_torch.exceptions import CollectiveGroupError
from ray_tpu_torch.util.collective.async_handles import (CollectiveHandle,
                                                         CompletionQueue)
from ray_tpu_torch.util.collective.device_backend import (group_token,
                                                          join_exchange,
                                                          leave_exchange,
                                                          reduce_fn)

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "product": dist.ReduceOp.PRODUCT,
               "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}
_WIRE_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
                torch.int64, torch.int32, torch.int16, torch.int8,
                torch.uint8, torch.bool)
_MAX_DIMS = 8


def _host(tensor) -> torch.Tensor:
    if not isinstance(tensor, torch.Tensor):
        tensor = torch.as_tensor(tensor)
    return tensor.detach().cpu().contiguous()


def _reduce_op(op: str):
    reduce_fn(op)  # the same refusal as the other backends'
    return _REDUCE_OPS[op]


class GlooGroup:
    """One rank's membership of a gloo group (module docstring)."""

    backend = "gloo"
    keeps_device = False

    def __init__(self, name: str, world_size: int, rank: int, store,
                 timeout_s: float):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.timeout_s = float(timeout_s)
        token = group_token(store, world_size, rank, timeout_s)
        self.pg = dist.ProcessGroupGloo(
            store, rank, world_size, datetime.timedelta(seconds=timeout_s))
        self.completions = CompletionQueue(name)
        self.p2p_seq = {}  # (sender, receiver) -> messages so far
        self._ex = join_exchange(token, world_size)
        with self._ex.cond:
            self._ex.listeners.append(self._poisoned)
        if self._ex.poison is not None:
            self._poisoned(*self._ex.poison)

    # ----------------------------------------------------------- poison
    def _error(self) -> CollectiveGroupError:
        dead, reason = self._ex.poison
        return CollectiveGroupError(self.name, dead, reason)

    def _poisoned(self, dead_ranks, reason) -> None:
        self.completions.fail_pending(self._error)

    def _check(self) -> None:
        if self._ex.poison is not None:
            raise self._error()

    def abort(self, dead_ranks=(), reason: str = "") -> None:
        self._ex.abort(dead_ranks, reason)

    def close(self) -> None:
        with self._ex.cond:
            self._ex.listeners.remove(self._poisoned)
        leave_exchange(self._ex)
        self.completions.close()

    # -------------------------------------------------------------- ops
    def _submit(self, op: str, work, value) -> CollectiveHandle:
        return self.completions.put(
            work, CollectiveHandle(self.name, op, value, self.timeout_s))

    def allreduce_async(self, tensor, op: str = "sum") -> CollectiveHandle:
        self._check()
        arr = _host(tensor)
        opts = dist.AllreduceOptions()
        opts.reduceOp = _reduce_op(op)
        return self._submit("allreduce", self.pg.allreduce([arr], opts), arr)

    def reducescatter_async(self, tensor, op: str = "sum") -> CollectiveHandle:
        self._check()
        arr = _host(tensor)
        chunks = list(torch.tensor_split(arr, self.world_size))
        out = torch.empty_like(chunks[self.rank])
        opts = dist.ReduceScatterOptions()
        opts.reduceOp = _reduce_op(op)
        return self._submit("reducescatter",
                            self.pg.reduce_scatter([out], [chunks], opts), out)

    def allgather_async(self, tensor) -> CollectiveHandle:
        """gloo takes only equal shapes on every rank."""
        self._check()
        arr = _host(tensor)
        outs = [torch.empty_like(arr) for _ in range(self.world_size)]
        return self._submit("allgather", self.pg.allgather([outs], [arr]),
                            outs)

    def allgather_object(self, obj) -> list:
        """The object is pickled to bytes; the ranks allgather their byte
        counts, then their bytes zero-padded to the largest count (gloo's
        allgather takes equal sizes only), and each rank unpickles every
        rank's bytes."""
        data = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                dtype=torch.uint8)
        sizes = self.allgather_async(
            torch.tensor([data.numel()], dtype=torch.int64)).result()
        width = max(int(s) for s in sizes)
        padded = torch.zeros(width, dtype=torch.uint8)
        padded[:data.numel()] = data
        parts = self.allgather_async(padded).result()
        return [pickle.loads(part[:int(n)].numpy().tobytes())
                for part, n in zip(parts, sizes)]

    def broadcast(self, tensor, src_rank: int = 0):
        self._check()
        arr = _host(tensor)
        opts = dist.BroadcastOptions()
        opts.rootRank = src_rank
        return self._submit("broadcast", self.pg.broadcast([arr], opts),
                            arr).result()

    def barrier(self) -> None:
        self._check()
        self._submit("barrier", self.pg.barrier(dist.BarrierOptions()),
                     None).result()

    # ---------------------------------------------------- point to point
    def _p2p_tag(self, src: int, dst: int) -> int:
        """The header's tag of the channel's next message; its payload's
        is one more."""
        seq = self.p2p_seq.get((src, dst), 0)
        self.p2p_seq[(src, dst)] = seq + 1
        return 2 * (seq % (1 << 29))

    def _start_send(self, tensor, dst_rank: int) -> list:
        self._check()
        arr = _host(tensor)
        if arr.dtype not in _WIRE_DTYPES or arr.dim() > _MAX_DIMS:
            raise ValueError(f"send takes up to {_MAX_DIMS} dims of "
                             f"{_WIRE_DTYPES}; got {arr.dtype} "
                             f"{tuple(arr.shape)}")
        header = torch.zeros(2 + _MAX_DIMS, dtype=torch.int64)
        header[0] = _WIRE_DTYPES.index(arr.dtype)
        header[1] = arr.dim()
        header[2:2 + arr.dim()] = torch.tensor(arr.shape, dtype=torch.int64)
        tag = self._p2p_tag(self.rank, dst_rank)
        # the tensors stay referenced by this list until the sends complete
        return [(self.pg.send([header], dst_rank, tag), header),
                (self.pg.send([arr], dst_rank, tag + 1), arr)]

    @staticmethod
    def _wait(works) -> None:
        """gloo fails a send or receive after the group's timeout."""
        for work, _ in works:
            work.wait()

    def send(self, tensor, dst_rank: int) -> None:
        self._wait(self._start_send(tensor, dst_rank))

    def recv(self, src_rank: int) -> torch.Tensor:
        self._check()
        tag = self._p2p_tag(src_rank, self.rank)
        header = torch.empty(2 + _MAX_DIMS, dtype=torch.int64)
        self.pg.recv([header], src_rank, tag).wait()
        code, ndim = int(header[0]), int(header[1])
        out = torch.empty(header[2:2 + ndim].tolist(),
                          dtype=_WIRE_DTYPES[code])
        self.pg.recv([out], src_rank, tag + 1).wait()
        return out

    def sendrecv(self, tensor, dst_rank: int, src_rank: int) -> torch.Tensor:
        works = self._start_send(tensor, dst_rank)
        out = self.recv(src_rank)
        self._wait(works)
        return out
