"""The NCCL collective backend: ``NcclGroup``, for ranks that own
distinct CUDA devices, one a process. The twin of ``XlaGroup``
(``ray_tpu/util/collective/xla_backend.py:26``) across processes: a
``torch.distributed.ProcessGroupNCCL`` of its own over the group's
store, each rank bound to its device (``cuda:<current device>`` unless
given), so CUDA tensors stay on the card end to end.

NCCL cannot hold two ranks on one device, so before NCCL is called every
rank publishes its device's identity (host name and device UUID) in the
store and reads everyone's; two ranks on one device are refused with a
``ValueError`` on each of them, within the join. Rank threads that share
a card take the ``"device"`` backend.

Ops take CUDA tensors on the group's device. ``allreduce`` and
``broadcast`` run in place and return the tensor, as NCCL does;
``reducescatter`` of an uneven dim 0 (``torch.tensor_split``'s chunks)
reduces the whole tensor and keeps this rank's chunk, as the twin does
(``xla_backend.py:286-301``). Each op's ``Work`` is waited on the
current stream, so the host does not block on the device. Objects
(``allgather_object``) and the header of a point-to-point message (its
dtype and shape) cross the store as pickles; payloads cross NCCL. A
message to this rank itself is a copy on its device. The op timeout is
the group's, handed to NCCL.
"""
from __future__ import annotations

import datetime
import pickle
import socket

import torch
import torch.distributed as dist

from ray_tpu_torch.exceptions import CollectiveGroupError
from ray_tpu_torch.util.collective.device_backend import (group_token,
                                                          reduce_fn,
                                                          store_wait)

_REDUCE_OPS = {"sum": "SUM", "product": "PRODUCT", "min": "MIN", "max": "MAX"}
_KEY = "ray_tpu_torch/nccl/"


def _device_identity(device: torch.device) -> str:
    props = torch.cuda.get_device_properties(device)
    uuid = getattr(props, "uuid", None)
    return f"{socket.gethostname()}/{uuid if uuid is not None else device}"


class NcclGroup:
    """One rank's membership of an NCCL group (module docstring)."""

    backend = "nccl"
    keeps_device = True

    def __init__(self, name: str, world_size: int, rank: int, store,
                 timeout_s: float, device=None):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"nccl group {name!r}: backend 'nccl' runs on CUDA devices "
                f"and this process sees none (torch.cuda.is_available() is "
                f"False); rank threads use backend='device', host tensors "
                f"backend='gloo'")
        if not dist.is_nccl_available():
            raise RuntimeError(
                f"nccl group {name!r}: this torch build ({torch.__version__})"
                f" has no NCCL (torch.distributed.is_nccl_available() is "
                f"False)")
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.timeout_s = float(timeout_s)
        self.device = torch.device(
            device if device is not None
            else ("cuda", torch.cuda.current_device()))
        if self.device.type != "cuda":
            raise ValueError(f"nccl group {name!r}: device {self.device} is "
                             f"not a CUDA device")
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._store = store
        token = group_token(store, world_size, rank, timeout_s)
        self._key = f"{_KEY}{token}/"
        store.set(f"{self._key}device{rank}", _device_identity(self.device))
        keys = [f"{self._key}device{r}" for r in range(world_size)]
        store_wait(store, keys, timeout_s, f"nccl group {name!r} join")
        idents = [store.get(k).decode() for k in keys]
        for r, ident in enumerate(idents):
            twins = [q for q, other in enumerate(idents) if other == ident]
            if len(twins) > 1:
                raise ValueError(
                    f"nccl group {name!r}: ranks {twins} are on one device "
                    f"({ident}). NCCL cannot hold two ranks on one device; "
                    f"rank threads that share a card use backend='device'")
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = datetime.timedelta(seconds=timeout_s)
        with torch.cuda.device(self.device):
            self.pg = dist.ProcessGroupNCCL(
                dist.PrefixStore(self._key + "pg", store), rank, world_size,
                opts)
        self._seq = 0            # allgather_object rounds
        self._p2p_seq = {}       # (sender, receiver) -> messages so far
        self._self_queue = []    # messages to this rank itself
        self._poison = None

    # ----------------------------------------------------------- poison
    def _check(self) -> None:
        if self._poison is not None:
            raise CollectiveGroupError(self.name, *self._poison)

    def abort(self, dead_ranks=(), reason: str = "") -> None:
        if self._poison is None:
            self._poison = (tuple(dead_ranks), reason)

    def close(self) -> None:
        shutdown = getattr(self.pg, "shutdown", None)
        if shutdown is not None:
            try:
                shutdown()
            except Exception:
                pass

    # -------------------------------------------------------------- ops
    def _cuda(self, tensor) -> torch.Tensor:
        self._check()
        if not isinstance(tensor, torch.Tensor):
            tensor = torch.as_tensor(tensor)
        if tensor.device != self.device:
            raise ValueError(f"nccl group {self.name!r} takes CUDA tensors "
                             f"on {self.device}; got one on {tensor.device}")
        return tensor.detach().contiguous()

    @staticmethod
    def _reduce_opts(kind, op: str):
        reduce_fn(op)
        opts = kind()
        opts.reduceOp = getattr(dist.ReduceOp, _REDUCE_OPS[op])
        return opts

    def _run(self, launch) -> None:
        """``launch()`` on the group's device; its ``Work`` waited on the
        current stream."""
        with torch.cuda.device(self.device):
            launch().wait()

    def allreduce(self, tensor, op: str = "sum"):
        t = self._cuda(tensor)
        self._run(lambda: self.pg.allreduce(
            [t], self._reduce_opts(dist.AllreduceOptions, op)))
        return t

    def reducescatter(self, tensor, op: str = "sum"):
        t = self._cuda(tensor)
        n = t.shape[0]
        if n % self.world_size:
            whole = self.allreduce(t.clone(), op)
            return torch.tensor_split(whole, self.world_size)[self.rank].clone()
        out = torch.empty((n // self.world_size,) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        self._run(lambda: self.pg._reduce_scatter_base(
            out, t, self._reduce_opts(dist.ReduceScatterOptions, op)))
        return out

    def allgather(self, tensor) -> list:
        """Equal shapes on every rank, as NCCL takes."""
        t = self._cuda(tensor)
        outs = [torch.empty_like(t) for _ in range(self.world_size)]
        self._run(lambda: self.pg.allgather([outs], [t]))
        return outs

    def allgather_object(self, obj) -> list:
        self._check()
        key = f"{self._key}object{self._seq}/"
        self._seq += 1
        self._store.set(f"{key}{self.rank}", pickle.dumps(obj))
        keys = [f"{key}{r}" for r in range(self.world_size)]
        store_wait(self._store, keys, self.timeout_s,
                   f"nccl group {self.name!r} allgather_object")
        return [pickle.loads(self._store.get(k)) for k in keys]

    def broadcast(self, tensor, src_rank: int = 0):
        t = self._cuda(tensor)
        opts = dist.BroadcastOptions()
        opts.rootRank = src_rank
        self._run(lambda: self.pg.broadcast([t], opts))
        return t

    def barrier(self) -> None:
        self.allreduce(torch.zeros(1, device=self.device))

    # ---------------------------------------------------- point to point
    def _header_key(self, src: int, dst: int) -> str:
        seq = self._p2p_seq.get((src, dst), 0)
        self._p2p_seq[(src, dst)] = seq + 1
        return f"{self._key}p2p{src}_{dst}_{seq}"

    def _send(self, t, dst_rank: int):
        if dst_rank == self.rank:
            self._self_queue.append(t.clone())
            return
        self._store.set(self._header_key(self.rank, dst_rank),
                        pickle.dumps((str(t.dtype), tuple(t.shape))))
        self._run(lambda: self.pg.send([t], dst_rank, 0))

    def _recv(self, src_rank: int) -> torch.Tensor:
        self._check()
        if src_rank == self.rank:
            if not self._self_queue:
                raise ValueError(f"nccl group {self.name!r}: recv from "
                                 f"this rank itself with nothing sent")
            out = self._self_queue.pop(0)
        else:
            key = self._header_key(src_rank, self.rank)
            store_wait(self._store, [key], self.timeout_s,
                       f"nccl group {self.name!r} recv")
            sent_dtype, sent_shape = pickle.loads(self._store.get(key))
            out = torch.empty(sent_shape,
                              dtype=getattr(torch, sent_dtype.split(".")[1]),
                              device=self.device)
            self._run(lambda: self.pg.recv([out], src_rank, 0))
        return out

    def send(self, tensor, dst_rank: int) -> None:
        self._send(self._cuda(tensor), dst_rank)

    def recv(self, src_rank: int) -> torch.Tensor:
        return self._recv(src_rank)

    def sendrecv(self, tensor, dst_rank: int, src_rank: int) -> torch.Tensor:
        """One hop of a ring. A pair that sends and receives to each other
        orders its two calls by rank (NCCL runs a pair's calls on one
        stream); other hops send first."""
        t = self._cuda(tensor)
        if dst_rank == src_rank and self.rank > dst_rank:
            out = self._recv(src_rank)
            self._send(t, dst_rank)
            return out
        self._send(t, dst_rank)
        return self._recv(src_rank)
