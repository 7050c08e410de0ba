"""The device collective backend: ``DeviceGroup``, a group whose ranks are
threads of one process, on one device or several, exchanging through
device memory. The twin of ``XlaGroup``
(``ray_tpu/util/collective/xla_backend.py:26``) and of the collectives
XLA compiles into a mesh step across the devices one process owns: a
tensor on a device stays on it, end to end (``:236-243``).

Membership: rank 0 writes a token (its pid and a fresh id) into the
group's store, every rank reads it, and the ranks meet in the one
in-process ``Exchange`` registered under that token. The key is the
token, not the store object: each ``PrefixStore`` wrapper of one store
is a new object. A rank in another process reads another pid and is
refused; ranks in separate processes, each on its own GPU, take the
``"nccl"`` backend.

An op is a round of the exchange. Each rank deposits its tensor (with a
CUDA event recorded on its current stream) and waits on the host, up to
the group's timeout, until every rank has deposited. Then each rank
computes its result on its own tensor's device, on its current stream,
which first waits on each depositor's event; it never stacks the peers'
tensors. Sums, products, minima and maxima run in rank order, r0 op r1
op r2 ..., so every rank returns the same bytes (at world 2 the one
IEEE operation gloo's ring also does). ``reducescatter`` cuts dim 0 as
``torch.tensor_split`` does, the first ``n % world`` chunks one row
longer (the twin's ``np.array_split``, ``xla_backend.py:286-301``), and
each rank reduces only its own chunk of every deposit. Each rank then
records a read event and waits until every rank has read; a depositor's
stream waits on its readers' events before the op returns, so the
caller may reuse or free its tensor at once. A CUDA input gives a CUDA
result on its device, a CPU input a CPU result: the CPU tests run this
same code. Results are new tensors, the inputs are left as they were
(``broadcast`` writes into the receivers' tensors, as NCCL's does).

Point to point: ``send`` puts its tensor on the channel (sender,
receiver), whose messages pair with ``recv`` calls in order, and
returns once the receiver has read it; ``recv`` returns a copy of the
sent shape and dtype on the receiver's device (the group's ``device``,
else the sender's tensor's).

Poison: ``abort(dead_ranks, reason)`` (``abort_collective_group``) wakes
every pending and future wait of every member at once with
``CollectiveGroupError``, the twin of ``_Rendezvous.poison``
(``ray_tpu/util/collective/collective.py:122``).
"""
from __future__ import annotations

import collections
import datetime
import os
import pickle
import threading
import time
import uuid

import torch

from ray_tpu_torch.exceptions import CollectiveGroupError

_REDUCE = {"sum": torch.add, "product": torch.mul, "min": torch.minimum,
           "max": torch.maximum}
_KEY = "ray_tpu_torch/"


def reduce_fn(op: str):
    if op not in _REDUCE:
        raise ValueError(f"unknown reduce op {op!r}: one of "
                         f"{sorted(_REDUCE)}")
    return _REDUCE[op]


def store_wait(store, keys, timeout_s: float, what: str):
    try:
        store.wait(list(keys), datetime.timedelta(seconds=timeout_s))
    except Exception as e:  # torch's DistStoreError or RuntimeError
        raise RuntimeError(f"{what}: timeout after {timeout_s}s waiting "
                           f"for {list(keys)}: {e}") from e


def group_token(store, world_size: int, rank: int, timeout_s: float) -> str:
    """The token of this incarnation of the group: rank 0's
    ``"<pid>:<id>"``, read by every rank. Incarnations of a group over
    one store (a gang restarted with the same address) are told apart by
    the count of joins."""
    joined = store.add(_KEY + "joined", 1)
    key = f"{_KEY}token{(joined - 1) // world_size}"
    if rank == 0:
        store.set(key, f"{os.getpid()}:{uuid.uuid4().hex}")
    store_wait(store, [key], timeout_s, "collective group join")
    return store.get(key).decode()


class Exchange:
    """What the members of one group incarnation share in this process:
    the rounds of their collective ops, their point-to-point channels,
    who has joined, and the poison."""

    def __init__(self, token: str, world_size: int):
        self.token = token
        self.world_size = world_size
        self.cond = threading.Condition()
        self.joined: set = set()
        self.users = 0
        self.rounds: dict = {}
        self.channels = collections.defaultdict(collections.deque)
        self.poison: tuple | None = None  # (dead ranks, reason)
        self.listeners: list = []          # called once poisoned

    def abort(self, dead_ranks, reason: str) -> None:
        """Poison the group; the first report wins."""
        with self.cond:
            if self.poison is not None:
                return
            self.poison = (tuple(dead_ranks), reason)
            listeners = list(self.listeners)
            self.cond.notify_all()
        for listener in listeners:
            listener(*self.poison)


_exchanges: dict[str, Exchange] = {}
_exchanges_lock = threading.Lock()


def join_exchange(token: str, world_size: int) -> Exchange:
    with _exchanges_lock:
        ex = _exchanges.get(token)
        if ex is None:
            ex = _exchanges[token] = Exchange(token, world_size)
        ex.users += 1
        return ex


def leave_exchange(ex: Exchange) -> None:
    with _exchanges_lock:
        ex.users -= 1
        if ex.users == 0 and _exchanges.get(ex.token) is ex:
            del _exchanges[ex.token]


class _Round:
    __slots__ = ("parts", "arrived", "read_events", "reads", "left")

    def __init__(self, world: int):
        self.parts = [None] * world        # (payload, CUDA event or None)
        self.arrived = 0
        self.read_events = [None] * world
        self.reads = 0
        self.left = 0


class _Message:
    __slots__ = ("tensor", "event", "read_event", "read")

    def __init__(self, tensor, event):
        self.tensor = tensor
        self.event = event
        self.read_event = None
        self.read = False


def _record(tensor):
    """An event on the current stream of a CUDA tensor's device, after
    the work that writes it; None for a host tensor."""
    if not isinstance(tensor, torch.Tensor) or tensor.device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(tensor.device))
    return event


def _after_reads(tensor, read_events) -> None:
    """The peers read ``tensor`` on their streams: its depositor's stream
    waits for their reads before the caller may write or free it. A block
    allocated on another stream is marked as used on this one, so that
    its reuse there waits too (on its own allocation stream that is a
    no-op). Readers mark nothing: a block marked on a reader's stream
    could not be reused until the card caught up with the host, and rank
    threads run far ahead of the card."""
    stream = torch.cuda.current_stream(tensor.device)
    for ev in read_events:
        if ev is not None:
            stream.wait_event(ev)
    tensor.record_stream(stream)


def _as_tensor(tensor) -> torch.Tensor:
    if not isinstance(tensor, torch.Tensor):
        tensor = torch.as_tensor(tensor)
    return tensor.detach()


class DeviceGroup:
    """One rank's membership of a device group (module docstring)."""

    backend = "device"
    keeps_device = True

    def __init__(self, name: str, world_size: int, rank: int, store,
                 timeout_s: float, device=None):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.timeout_s = float(timeout_s)
        self.device = None if device is None else torch.device(device)
        token = group_token(store, world_size, rank, timeout_s)
        pid = os.getpid()
        if int(token.split(":")[0]) != pid:
            raise ValueError(
                f"device group {name!r}: rank {rank} is in process {pid}, "
                f"rank 0 in process {token.split(':')[0]}. A 'device' group's "
                f"ranks are threads of one process; ranks in separate "
                f"processes, each on its own GPU, use backend='nccl'")
        store.set(f"{_KEY}{token}/pid{rank}", str(pid))
        keys = [f"{_KEY}{token}/pid{r}" for r in range(world_size)]
        store_wait(store, keys, timeout_s, f"device group {name!r} join")
        others = {int(store.get(k)) for k in keys} - {pid}
        if others:
            raise ValueError(
                f"device group {name!r}: members in processes "
                f"{sorted(others)} besides {pid}. A 'device' group's ranks "
                f"are threads of one process; ranks in separate processes "
                f"use backend='nccl'")
        self._ex = join_exchange(token, world_size)
        self._seq = 0
        try:
            with self._ex.cond:
                self._ex.joined.add(rank)
                self._ex.cond.notify_all()
                self._wait(lambda: len(self._ex.joined) == world_size,
                           "join")
        except BaseException:
            self.close()
            raise

    # ------------------------------------------------------------ waits
    def _error(self) -> CollectiveGroupError:
        dead, reason = self._ex.poison
        return CollectiveGroupError(self.name, dead, reason)

    def _wait(self, ready, what: str) -> None:
        """Wait on the exchange's condition (held) until ``ready()``;
        raises the poison, or ``TimeoutError`` after the group's
        timeout."""
        deadline = time.monotonic() + self.timeout_s
        while True:
            if self._ex.poison is not None:
                raise self._error()
            if ready():
                return
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"collective {what} (device group {self.name!r}, rank "
                    f"{self.rank}) did not complete within "
                    f"{self.timeout_s}s")
            self._ex.cond.wait(left)

    def abort(self, dead_ranks=(), reason: str = "") -> None:
        self._ex.abort(dead_ranks, reason)

    def close(self) -> None:
        leave_exchange(self._ex)

    # ----------------------------------------------------------- rounds
    def _round(self, what: str, payload, compute):
        """Deposit ``payload`` in this rank's slot of the next round, wait
        for every rank's, return ``compute(parts)`` once every rank has
        read. ``compute`` returns (result, read event or None)."""
        ex = self._ex
        seq = self._seq
        self._seq += 1
        event = _record(payload)
        with ex.cond:
            rnd = ex.rounds.get(seq)
            if rnd is None:
                rnd = ex.rounds[seq] = _Round(self.world_size)
            rnd.parts[self.rank] = (payload, event)
            rnd.arrived += 1
            ex.cond.notify_all()
            self._wait(lambda: rnd.arrived == self.world_size, what)
        result, read_event = compute(rnd.parts)
        with ex.cond:
            rnd.read_events[self.rank] = read_event
            rnd.reads += 1
            ex.cond.notify_all()
            self._wait(lambda: rnd.reads == self.world_size, what)
            rnd.left += 1
            if rnd.left == self.world_size:
                del ex.rounds[seq]
        if event is not None:
            _after_reads(payload, [ev for r, ev in enumerate(rnd.read_events)
                                   if r != self.rank])
        return result

    def _reader(self, device: torch.device):
        """(read(tensor, event) -> the tensor readable on ``device`` after
        its depositor's writes, finish() -> this rank's read event)."""
        if device.type != "cuda":
            return (lambda t, ev: t.to(device)), (lambda: None)
        stream = torch.cuda.current_stream(device)

        def read(t, ev):
            if ev is not None:
                stream.wait_event(ev)
            return t if t.device == device else t.to(device,
                                                     non_blocking=True)

        def finish():
            done = torch.cuda.Event()
            done.record(stream)
            return done

        return read, finish

    @staticmethod
    def _same_kind(parts, what: str) -> None:
        first = parts[0][0]
        for r, (t, _) in enumerate(parts):
            if t.shape != first.shape or t.dtype != first.dtype:
                raise ValueError(
                    f"{what}: rank {r} gave {t.dtype} {tuple(t.shape)}, rank "
                    f"0 {first.dtype} {tuple(first.shape)}")

    def _reduce(self, parts, op: str, device, chunk: bool):
        fn = reduce_fn(op)
        read, finish = self._reader(device)
        srcs = []
        for t, ev in parts:
            if chunk:
                t = torch.tensor_split(t, self.world_size)[self.rank]
            srcs.append(read(t, ev))
        if len(srcs) == 1:
            out = srcs[0].clone(memory_format=torch.contiguous_format)
        else:
            out = fn(srcs[0], srcs[1])
            for s in srcs[2:]:
                fn(out, s, out=out)
        return out, finish()

    # -------------------------------------------------------------- ops
    def allreduce(self, tensor, op: str = "sum"):
        """The reduction of every rank's tensor in rank order, a new
        tensor on this rank's tensor's device."""
        reduce_fn(op)
        t = _as_tensor(tensor)

        def compute(parts):
            self._same_kind(parts, "allreduce")
            return self._reduce(parts, op, t.device, chunk=False)

        return self._round("allreduce", t, compute)

    def reducescatter(self, tensor, op: str = "sum"):
        """Chunk ``rank`` (``torch.tensor_split`` along dim 0) of the
        reduction."""
        reduce_fn(op)
        t = _as_tensor(tensor)

        def compute(parts):
            self._same_kind(parts, "reducescatter")
            return self._reduce(parts, op, t.device, chunk=True)

        return self._round("reducescatter", t, compute)

    def allgather(self, tensor) -> list:
        """Every rank's tensor, in rank order, each a copy on this rank's
        tensor's device; the shapes may differ."""
        t = _as_tensor(tensor)

        def compute(parts):
            read, finish = self._reader(t.device)
            outs = []
            for p, ev in parts:
                src = read(p, ev)
                outs.append(src.clone(memory_format=torch.contiguous_format)
                            if src is p else src)
            return outs, finish()

        return self._round("allgather", t, compute)

    def allgather_object(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order, each unpickled
        from the rank's pickle (a copy, as gloo's)."""
        return self._round("allgather_object", pickle.dumps(obj),
                           lambda parts: ([pickle.loads(b) for b, _ in parts],
                                          None))

    def broadcast(self, tensor, src_rank: int = 0):
        """``src_rank``'s tensor, written into every other rank's tensor
        (of its shape and dtype), which is returned; ``src_rank`` gets its
        own back."""
        if not 0 <= src_rank < self.world_size:
            raise ValueError(f"src_rank {src_rank} out of range for world "
                             f"{self.world_size}")
        t = _as_tensor(tensor)

        def compute(parts):
            src, ev = parts[src_rank]
            if src.shape != t.shape or src.dtype != t.dtype:
                raise ValueError(
                    f"broadcast: rank {self.rank} gave {t.dtype} "
                    f"{tuple(t.shape)} for rank {src_rank}'s {src.dtype} "
                    f"{tuple(src.shape)}")
            if self.rank == src_rank:
                return t, None
            read, finish = self._reader(t.device)
            out = t if t.is_contiguous() else t.contiguous()
            out.copy_(read(src, ev), non_blocking=True)
            return out, finish()

        return self._round("broadcast", t, compute)

    def barrier(self) -> None:
        self._round("barrier", None, lambda parts: (None, None))

    # ---------------------------------------------------- point to point
    def _post(self, tensor, dst_rank: int) -> _Message:
        if not 0 <= dst_rank < self.world_size:
            raise ValueError(f"dst_rank {dst_rank} out of range for world "
                             f"{self.world_size}")
        t = _as_tensor(tensor)
        msg = _Message(t, _record(t))
        with self._ex.cond:
            if self._ex.poison is not None:
                raise self._error()
            self._ex.channels[(self.rank, dst_rank)].append(msg)
            self._ex.cond.notify_all()
        return msg

    def _delivered(self, msg: _Message, dst_rank: int) -> None:
        with self._ex.cond:
            self._wait(lambda: msg.read, f"send to rank {dst_rank}")
        if msg.event is not None:
            _after_reads(msg.tensor, [msg.read_event])

    def send(self, tensor, dst_rank: int) -> None:
        """Send to ``dst_rank``; returns once it has read the tensor."""
        self._delivered(self._post(tensor, dst_rank), dst_rank)

    def recv(self, src_rank: int, device=None) -> torch.Tensor:
        """The next tensor ``src_rank`` sends this rank, a copy on
        ``device`` (the group's device, else the sent tensor's)."""
        if not 0 <= src_rank < self.world_size:
            raise ValueError(f"src_rank {src_rank} out of range for world "
                             f"{self.world_size}")
        channel = self._ex.channels[(src_rank, self.rank)]
        with self._ex.cond:
            self._wait(lambda: len(channel) > 0,
                       f"recv from rank {src_rank}")
            msg = channel.popleft()
        device = torch.device(device or self.device or msg.tensor.device)
        read, finish = self._reader(device)
        src = read(msg.tensor, msg.event)
        out = (src.clone(memory_format=torch.contiguous_format)
               if src is msg.tensor else src)
        msg.read_event = finish()
        with self._ex.cond:
            msg.read = True
            self._ex.cond.notify_all()
        return out

    def sendrecv(self, tensor, dst_rank: int, src_rank: int) -> torch.Tensor:
        """One hop of a ring: send to ``dst_rank`` while receiving from
        ``src_rank``; returns the received tensor, on the sent tensor's
        device."""
        t = _as_tensor(tensor)
        msg = self._post(t, dst_rank)
        out = self.recv(src_rank, device=t.device)
        self._delivered(msg, dst_rank)
        return out
