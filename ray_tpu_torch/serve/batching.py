"""Adaptive, shape-aware request batching for serving: the port's copy of
``ray_tpu/serve/batching.py`` (``@serve.batch``).

Concurrent single-item calls coalesce into one call of the wrapped
function on a list. Batches are padded up to a small fixed set of bucket
sizes (powers of two up to ``max_batch_size`` by default) by replicating
the last real request, and the padded outputs are dropped before fan-out,
so a model sees a handful of batch shapes instead of one per queue cut:
on the card each new shape costs a first call (the kernels' first use,
the BLAS library's first plan for that shape). Padded slots are measured
(``ray_tpu_torch_serve_batch_pad_waste_tasks``). The kill switch
``RAY_TPU_TORCH_SERVE_SHAPE_BUCKETS=0`` restores pad-free batches.

Every batch call is classified by its signature (batch size, each item's
shape and dtype; scalar items by value, others by type):
``ray_tpu_torch_serve_batch_signature_total{fn, result=hit|miss}``, with
each signature's first call timed
(``ray_tpu_torch_serve_batch_first_call_seconds``). So "bucketing stops
meeting new shapes after warm-up" is a counter, as the twin's
compile-cache classification makes it one.

The batcher is thread-based: callers enqueue their item and block; one
lazily started thread drains the queue into lists of at most
``max_batch_size``, waiting at most ``batch_wait_timeout_s`` after the
first item arrives, calls the wrapped function once a batch and hands the
results back. On failure each caller gets ITS OWN clone of the exception.
The twin's trace-context linking is not ported (the port has no tracing
plane).
"""
from __future__ import annotations

import copy
import os
import threading
import time
from typing import Callable

from ray_tpu_torch._private import telemetry as _tm


def shape_buckets_enabled() -> bool:
    """Kill switch, read at batcher construction: ``0`` restores the
    pad-free batcher (every queue cut is its own batch size)."""
    return os.environ.get("RAY_TPU_TORCH_SERVE_SHAPE_BUCKETS", "1") != "0"


def default_bucket_sizes(max_batch_size: int) -> tuple[int, ...]:
    """Powers of two up to (and always including) ``max_batch_size``: no
    batch pads to more than twice its real size."""
    sizes, s = [], 1
    while s < max_batch_size:
        sizes.append(s)
        s *= 2
    sizes.append(max_batch_size)
    return tuple(sorted(set(sizes)))


def _clone_exception(exc: BaseException) -> BaseException:
    """A per-caller copy of one batch failure: it shares the original's
    traceback and cause but is a DISTINCT object, so one caller re-raising
    with ``raise e from other`` cannot corrupt what the others see."""
    try:
        clone = copy.copy(exc)
        if clone is exc or type(clone) is not type(exc):
            return exc
        clone.__traceback__ = exc.__traceback__
        clone.__cause__ = exc.__cause__
        return clone
    except Exception:
        return exc  # unclonable exotic exception: shared beats lost


def _item_key(item):
    shape = getattr(item, "shape", None)
    dtype = getattr(item, "dtype", None)
    if shape is not None and dtype is not None:
        return (tuple(shape), str(dtype).removeprefix("torch."))
    if isinstance(item, (int, float, bool, complex, str, bytes,
                         type(None))):
        return (type(item).__name__, item)
    return type(item).__name__


def _signature(items: list) -> tuple:
    """The signature a batch call is classified by."""
    return (len(items), tuple(_item_key(x) for x in items))


class _Pending:
    __slots__ = ("item", "event", "result", "error")

    def __init__(self, item):
        self.item = item
        self.event = threading.Event()
        self.result = None
        self.error = None


class _Batcher:
    """Queue + single worker thread for one bound batch function."""

    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float,
                 bucket_sizes: tuple[int, ...] | None = None,
                 name: str | None = None):
        self._name = name or getattr(fn, "__name__", "batched")
        self._fn = self._instrument(fn)
        self.max_batch_size = max_batch_size
        self.batch_wait_timeout_s = batch_wait_timeout_s
        if shape_buckets_enabled():
            self.bucket_sizes = tuple(sorted(
                set(bucket_sizes or default_bucket_sizes(max_batch_size))))
            if self.bucket_sizes[-1] < max_batch_size:
                self.bucket_sizes += (max_batch_size,)
        else:
            self.bucket_sizes = None
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: list[_Pending] = []
        self._thread: threading.Thread | None = None

    def _instrument(self, fn: Callable):
        """Classify every batch call by its signature: a miss (timed) for
        a signature's first call, a hit after. A failed first call is not
        remembered, so its retry counts as a miss again."""
        if not _tm.ENABLED:
            return fn
        seen: set = set()
        tags = {"fn": self._name}

        def classified(items):
            key = _signature(items)
            if key in seen:
                _tm.counter_inc("ray_tpu_torch_serve_batch_signature_total",
                                tags={**tags, "result": "hit"})
                return fn(items)
            seen.add(key)
            _tm.counter_inc("ray_tpu_torch_serve_batch_signature_total",
                            tags={**tags, "result": "miss"})
            t0 = time.perf_counter()
            try:
                out = fn(items)
            except BaseException:
                seen.discard(key)
                raise
            _tm.observe("ray_tpu_torch_serve_batch_first_call_seconds",
                        time.perf_counter() - t0, tags=tags)
            return out

        return classified

    def submit(self, item):
        pending = _Pending(item)
        with self._cond:
            self._queue.append(pending)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="serve-batcher")
                self._thread.start()
            self._cond.notify_all()
        pending.event.wait()
        if pending.error is not None:
            raise pending.error
        return pending.result

    def _take_batch(self) -> list[_Pending] | None:
        """Block for the first item, then linger up to the wait timeout (or
        until the batch fills) before cutting the batch. Returns None when
        idle long enough to let the thread retire."""
        with self._cond:
            deadline = time.monotonic() + 10.0
            while not self._queue:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cond.wait(remaining)
            cutoff = time.monotonic() + self.batch_wait_timeout_s
            while len(self._queue) < self.max_batch_size:
                remaining = cutoff - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            batch = self._queue[: self.max_batch_size]
            del self._queue[: len(batch)]
            return batch

    def _pad_to_bucket(self, items: list) -> tuple[list, int]:
        """Pad ``items`` up to the smallest bucket that fits by
        replicating the last real item (never a sentinel). Returns the
        padded list and the pad count; a no-op when bucketing is off."""
        if self.bucket_sizes is None:
            return items, 0
        n = len(items)
        bucket = next(b for b in self.bucket_sizes if b >= n)
        pad = bucket - n
        if pad:
            items = items + [items[-1]] * pad
        return items, pad

    def _loop(self):
        while True:
            batch = self._take_batch()
            if batch is None:
                # Retire quietly; submit() restarts the thread on demand.
                with self._cond:
                    if self._queue:
                        continue
                    self._thread = None
                    return
            items, pad = self._pad_to_bucket([p.item for p in batch])
            try:
                results = self._fn(items)
                if results is None or len(results) != len(items):
                    raise TypeError(
                        f"@serve.batch function must return a list with one "
                        f"result per input ({len(items)} expected"
                        f"{f', incl. {pad} padded' if pad else ''}, got "
                        f"{None if results is None else len(results)})")
                for pending, result in zip(batch, results):
                    pending.result = result  # padded tail dropped by zip
                _tm.observe("ray_tpu_torch_serve_batch_size_tasks",
                            len(items), tags={"fn": self._name})
                _tm.observe("ray_tpu_torch_serve_batch_pad_waste_tasks", pad,
                            tags={"fn": self._name})
            except BaseException as exc:  # noqa: BLE001 - fan the error out
                for pending in batch:
                    pending.error = _clone_exception(exc)
            finally:
                for pending in batch:
                    pending.event.set()


def _reject_bad_call(args: tuple, kwargs: dict, name: str):
    """One clear error for the two call-shape mistakes, instead of a bare
    arity TypeError from deep inside the batcher."""
    if kwargs:
        raise TypeError(
            f"@serve.batch function {name!r} takes a single positional "
            f"request argument; unexpected keyword arguments "
            f"{sorted(kwargs)} — pack request fields into the one request "
            f"object (the wrapped function receives a LIST of them)")
    if len(args) != 1:
        raise TypeError(
            f"@serve.batch function {name!r} takes exactly one request "
            f"argument per call (got {len(args)}); it is invoked once per "
            f"REQUEST, and the wrapped function receives the batched list")


class _BatchWrapper:
    """The object ``@batch`` produces. Works as a plain function wrapper
    and as a method decorator (the descriptor protocol binds one batcher
    per instance, so two replicas in one process never share a queue)."""

    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float,
                 batch_size_buckets: tuple[int, ...] | None = None):
        if max_batch_size < 1:
            raise ValueError(
                f"max_batch_size must be >= 1, got {max_batch_size}")
        if batch_wait_timeout_s < 0:
            raise ValueError(f"batch_wait_timeout_s must be >= 0, got "
                             f"{batch_wait_timeout_s}")
        if batch_size_buckets:
            bad = [b for b in batch_size_buckets
                   if not isinstance(b, int) or b < 1 or b > max_batch_size]
            if bad:
                # a bucket above max_batch_size would PAD batches past
                # the bound the wrapped function was sized for
                raise ValueError(
                    f"batch_size_buckets must be integers in "
                    f"[1, max_batch_size={max_batch_size}], got {bad}")
        self._fn = fn
        self._max_batch_size = max_batch_size
        self._batch_wait_timeout_s = batch_wait_timeout_s
        self._batch_size_buckets = (tuple(batch_size_buckets)
                                    if batch_size_buckets else None)
        self._batcher: _Batcher | None = None
        # guards batcher creation: concurrent first callers that each saw
        # None would otherwise every one build a private batcher
        self._creation_lock = threading.Lock()
        self._instance_attr = f"__serve_batcher_{id(self)}"
        self.__name__ = getattr(fn, "__name__", "batched")
        self.__doc__ = getattr(fn, "__doc__", None)

    # The wrapper may ship inside a pickled class: only the recipe
    # travels (the creation lock is unpicklable, and a live batcher is
    # meaningless in another process).
    def __getstate__(self):
        return {"fn": self._fn, "max_batch_size": self._max_batch_size,
                "batch_wait_timeout_s": self._batch_wait_timeout_s,
                "batch_size_buckets": self._batch_size_buckets}

    def __setstate__(self, state):
        self.__init__(state["fn"], state["max_batch_size"],
                      state["batch_wait_timeout_s"],
                      state["batch_size_buckets"])

    def _make_batcher(self, fn) -> _Batcher:
        return _Batcher(fn, self._max_batch_size,
                        self._batch_wait_timeout_s,
                        bucket_sizes=self._batch_size_buckets,
                        name=self.__name__)

    def _get_batcher(self, instance=None) -> _Batcher:
        if instance is None:
            if self._batcher is None:
                with self._creation_lock:
                    if self._batcher is None:
                        self._batcher = self._make_batcher(self._fn)
            return self._batcher
        batcher = getattr(instance, self._instance_attr, None)
        if batcher is None:
            with self._creation_lock:
                batcher = getattr(instance, self._instance_attr, None)
                if batcher is None:
                    bound = self._fn.__get__(instance, type(instance))
                    batcher = self._make_batcher(bound)
                    setattr(instance, self._instance_attr, batcher)
        return batcher

    def __call__(self, *args, **kwargs):
        _reject_bad_call(args, kwargs, self.__name__)
        return self._get_batcher().submit(args[0])

    def __get__(self, instance, owner=None):
        if instance is None:
            return self
        batcher = self._get_batcher(instance)
        name = self.__name__

        def bound(*args, **kwargs):
            _reject_bad_call(args, kwargs, name)
            return batcher.submit(args[0])

        bound.__name__ = name
        bound._serve_batcher = batcher
        return bound


def batch(fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01,
          batch_size_buckets: list[int] | tuple[int, ...] | None = None):
    """Coalesce concurrent single-item calls into one list-in/list-out call.

    Usage (method or free function)::

        class Model:
            @batch(max_batch_size=16, batch_wait_timeout_s=0.005)
            def predict(self, inputs: list):
                return list(self.predictor.predict(np.stack(inputs)))

    Each caller passes ONE item and receives ONE result; the wrapped
    function always receives a list and must return an equal-length list.
    Batches are padded up to the bucket sizes (powers of two up to
    ``max_batch_size``, or ``batch_size_buckets``) with copies of the last
    real request, whose outputs are dropped.
    ``RAY_TPU_TORCH_SERVE_SHAPE_BUCKETS=0`` disables padding.
    """
    if fn is not None:
        return _BatchWrapper(fn, max_batch_size, batch_wait_timeout_s,
                             batch_size_buckets)

    def decorate(inner):
        return _BatchWrapper(inner, max_batch_size, batch_wait_timeout_s,
                             batch_size_buckets)

    return decorate
