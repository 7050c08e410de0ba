"""Handles for collective ops started asynchronously. The twin of
``ray_tpu/util/collective/async_handles.py``.

gloo runs each op on its own worker threads and tags ops in the order they
are submitted, so every rank matches the same op sequence. Its ``Work``
cannot be relied on for completion, though: the one a gloo reducescatter
returns never reports itself completed and ignores the timeout of
``wait``. So each gloo group has one completion thread
(``CompletionQueue``) that waits its ops' ``Work`` in submission order,
without a timeout of its own (gloo fails an op after the group's
timeout), and completes each op's ``CollectiveHandle``. A caller waits on
the handle, which honours its timeout: ``result(timeout)`` raises
``TimeoutError`` when the wait runs out, and never hangs.

A poisoned group (``collective.abort_collective_group``) fails every
handle still pending at once with its ``CollectiveGroupError``
(``CompletionQueue.fail_pending``); the first completion of a handle
wins, so gloo's late ``Work`` does not overwrite it. The device and NCCL
groups run an op's host part when it is started and hand back a handle
that is already complete (``CollectiveHandle.completed``): their work is
kernels on the caller's stream.
"""
from __future__ import annotations

import queue
import threading


class CollectiveHandle:
    """Future for one collective op: ``poll()``, ``wait(timeout)`` and
    ``result(timeout)``. ``timeout=None`` waits up to the group's
    timeout."""

    __slots__ = ("group", "op", "_value", "_default_timeout", "_done",
                 "_error")

    def __init__(self, group: str, op: str, value, default_timeout: float):
        self.group = group
        self.op = op
        self._value = value
        self._default_timeout = default_timeout
        self._done = threading.Event()
        self._error = None

    @classmethod
    def completed(cls, group: str, op: str, value) -> "CollectiveHandle":
        """A handle of an op that already ran."""
        handle = cls(group, op, value, 0.0)
        handle._finish()
        return handle

    def poll(self) -> bool:
        """True once the op finished, successfully or not. Never blocks."""
        return self._done.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the op completes and raise its error if it failed,
        or ``TimeoutError`` after ``timeout`` seconds."""
        if timeout is None:
            timeout = self._default_timeout
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"collective {self.op} (group {self.group!r}) did not "
                f"complete within {timeout}s")
        if self._error is not None:
            raise self._error
        return True

    def result(self, timeout: float | None = None):
        """``wait()``, then the op's value."""
        self.wait(timeout)
        return self._value

    def _finish(self, error=None):
        """Complete the handle; only the first completion counts."""
        if self._done.is_set():
            return
        self._error = error
        self._done.set()


class CompletionQueue:
    """One group's completion thread: waits each submitted ``Work`` in
    submission order and completes its handle."""

    def __init__(self, group: str):
        self._queue: queue.SimpleQueue = queue.SimpleQueue()
        self._pending: set = set()
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"collective-{group}")
        self._thread.start()

    def put(self, work, handle: CollectiveHandle) -> CollectiveHandle:
        with self._lock:
            self._pending.add(handle)
        self._queue.put((work, handle))
        return handle

    def fail_pending(self, make_error) -> None:
        """Fail every handle not completed yet with ``make_error()``."""
        with self._lock:
            pending, self._pending = self._pending, set()
        for handle in pending:
            handle._finish(make_error())

    def close(self):
        """Stop after the ops already submitted complete."""
        self._queue.put(None)

    def _run(self):
        while (item := self._queue.get()) is not None:
            work, handle = item
            try:
                work.wait()
            except Exception as e:  # gloo's op error or timeout, for the caller
                handle._finish(e)
            else:
                handle._finish()
            with self._lock:
                self._pending.discard(handle)
