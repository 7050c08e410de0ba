"""Host batches onto the device behind the consumer's back: the device half
of ``ray_tpu/data/_internal/streaming/iterator.py`` (``make_to_batch``,
``_double_buffered``) and of ``Dataset.iter_batches(device_put=True)``.

The port has no object store or Dataset: ``iter_device_batches`` takes any
iterable of host batches (numpy arrays, dicts of them, or the blocks a
Dataset is made of) and yields each as torch tensors on the device, a
producer thread converting and copying batch k+1 while the caller
consumes batch k.

On a CUDA device a batch is staged into a pinned host buffer and copied on
a side stream (``.to(device, non_blocking=True)``'s transfer, issued as
``copy_`` into a tensor allocated on that stream), so the copy overlaps
the caller's kernels. Three things keep that right:

- the caller's current stream waits on the copy's event before the batch
  is handed out (``Transfer.wait``);
- each device tensor is marked with ``record_stream`` for the caller's
  stream, so the caching allocator does not hand its memory to a later
  copy while the caller's kernels may still read it;
- a pinned staging buffer is refilled only once the event of the copy
  that last read it has completed (``_PinnedRing``).
"""
from __future__ import annotations

import queue as _queue
import threading

import numpy as np
import torch

from ray_tpu_torch._private.device import DeviceLike, resolve_device

_STAGING_SLOTS = 3  # one batch copying, one queued, one being staged
_ALIGN = 256
_JOIN_S = 5.0  # how long a closed stream waits for its producer thread


# ------------------------------------------------- blocks to numpy batches
# (the twin's ray_tpu/data/block.py, the part a numpy batch needs)
def _is_columnar(block) -> bool:
    return isinstance(block, dict) and all(
        isinstance(v, np.ndarray) for v in block.values())


def _to_rows(block) -> list:
    if isinstance(block, np.ndarray):
        return list(block)
    if _is_columnar(block):
        n = len(next(iter(block.values()))) if block else 0
        return [{k: v[i] for k, v in block.items()} for i in range(n)]
    if hasattr(block, "to_dict") and hasattr(block, "columns"):
        return block.to_dict("records")
    return list(block)


def to_numpy_batch(block):
    """A block (an array, a dict of columns, or rows) as a numpy batch: the
    array, the dict of arrays, or the rows stacked."""
    if isinstance(block, np.ndarray) or _is_columnar(block):
        return block
    rows = _to_rows(block)
    if rows and isinstance(rows[0], dict):
        return {k: np.asarray([r[k] for r in rows]) for k in rows[0]}
    return np.asarray(rows)


# ------------------------------------------------------------- transfers
class Transfer:
    """A batch on (or on its way to) the device. ``wait()`` returns it,
    ready for the calling thread's current stream."""

    __slots__ = ("batch", "tensors", "event", "device")

    def __init__(self, batch, tensors=(), event=None, device=None):
        self.batch, self.tensors = batch, tensors
        self.event, self.device = event, device

    def wait(self):
        if self.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self.event)
            for t in self.tensors:
                t.record_stream(stream)
        return self.batch


class _PinnedRing:
    """Pinned staging buffers used in turn. A slot is handed out again
    only after the copy that last read it has completed."""

    def __init__(self, slots: int):
        self._buffers = [None] * slots
        self._events = [None] * slots
        self._next = 0

    def take(self, nbytes: int):
        i = self._next
        self._next = (i + 1) % len(self._buffers)
        if self._events[i] is not None:
            self._events[i].synchronize()
        buf = self._buffers[i]
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                              pin_memory=True)
            self._buffers[i] = buf
        return i, buf

    def release(self, slot: int, event) -> None:
        self._events[slot] = event


def _arrays(batch):
    """(keys or None, the batch's arrays) of an array or a dict batch."""
    if isinstance(batch, dict):
        return list(batch), [np.asarray(v) for v in batch.values()]
    return None, [np.asarray(batch)]


def _rebuild(keys, tensors):
    return tensors[0] if keys is None else dict(zip(keys, tensors))


def make_to_batch(batch_format: str, device: DeviceLike = None):
    """``to_batch(block) -> Transfer``: the block as a numpy batch, then as
    tensors on ``device`` (CUDA by default). On CUDA the copy runs from a
    pinned buffer on a side stream of its own; on the CPU the tensors are
    copies of the arrays."""
    if batch_format != "numpy":
        raise ValueError(f"device batches are numpy batches; got "
                         f"batch_format={batch_format!r}")
    dev = resolve_device(device)
    if dev.type != "cuda":
        def to_cpu(blk):
            keys, arrays = _arrays(to_numpy_batch(blk))
            return Transfer(_rebuild(keys, [torch.tensor(a)
                                            for a in arrays]))
        return to_cpu

    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.Stream(dev)
    ring = _PinnedRing(_STAGING_SLOTS)

    def to_cuda(blk):
        keys, arrays = _arrays(to_numpy_batch(blk))
        hosts = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        offsets, end = [], 0
        for h in hosts:
            offsets.append(end)
            end += -(-h.numel() * h.element_size() // _ALIGN) * _ALIGN
        slot, buf = ring.take(end)
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            tensors = []
            for h, off in zip(hosts, offsets):
                nbytes = h.numel() * h.element_size()
                pinned = buf[off:off + nbytes].view(h.dtype).view(h.shape)
                pinned.copy_(h)
                tensors.append(pinned.to(dev, non_blocking=True))
            event = torch.cuda.Event()
            event.record(stream)
        ring.release(slot, event)
        return Transfer(_rebuild(keys, tensors), tensors, event, dev)

    return to_cuda


def double_buffered(batches, to_batch):
    """A producer thread runs ``to_batch`` on batch k+1 while the caller
    consumes batch k; yields each ``Transfer``'s batch, waited for on the
    caller's stream. Queue depth 2: one batch in the caller's hands, one
    converted and waiting, one being converted. A producer error is
    re-raised here; closing the generator stops the thread (joined within
    ``_JOIN_S`` unless it is parked inside ``batches`` itself)."""
    q: _queue.Queue = _queue.Queue(maxsize=2)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except _queue.Full:
                continue
        return False

    def produce():
        try:
            for bb in batches:
                if not put(("ok", to_batch(bb))):
                    return
            put(("end", None))
        except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
            put(("err", e))

    t = threading.Thread(target=produce, daemon=True,
                         name="device-batches")
    t.start()
    try:
        while True:
            try:
                kind, payload = q.get(timeout=1.0)
            except _queue.Empty:
                if not t.is_alive():
                    return  # the producer died without a sentinel
                continue
            if kind == "end":
                return
            if kind == "err":
                raise payload
            yield payload.wait()
    finally:
        stop.set()
        t.join(_JOIN_S)


def iter_device_batches(batches, *, device: DeviceLike = None,
                        batch_format: str = "numpy"):
    """Each host batch of ``batches`` as tensors on ``device`` (CUDA by
    default), double-buffered: the entry point for feeding a model from a
    batch stream (for example a ``ray_tpu`` Dataset's
    ``iter_batches(batch_format="numpy")``)."""
    yield from double_buffered(batches, make_to_batch(batch_format, device))
