"""Crash-consistent file writes. The port's copy of
``ray_tpu/_private/atomic_write.py``.

A file meant to be read back after a crash (a checkpoint shard, a
generation's manifest) is written to a temp file in the same directory,
flushed and fsynced, renamed onto its final name (atomic on POSIX within
one filesystem), and then the directory is fsynced so that the rename
itself is durable. A reader sees the old bytes or the whole new ones,
never a torn prefix.

``RAY_TPU_TORCH_CHECKPOINT_FSYNC=0`` skips the fsyncs, for tests on
tmpfs only: durability needs them. The twin's fault plane (injected torn
and corrupt writes) is not ported; tests tear or corrupt files by hand.
"""
from __future__ import annotations

import os
import tempfile

from ray_tpu_torch._private.config import get_config


def _fsync_enabled() -> bool:
    return bool(get_config("checkpoint_fsync"))


def fsync_dir(path: str) -> None:
    """fsync a directory, so that a rename or creation inside it is
    durable."""
    if not _fsync_enabled():
        return
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write(path: str, data: bytes) -> str:
    """Durably replace ``path`` with ``data``; returns ``path``.

    temp file (same directory) -> write -> flush and fsync -> rename ->
    directory fsync. On any error the temp file is removed and ``path``
    is as it was."""
    path = os.fspath(path)
    dirname = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".tmp.",
                               dir=dirname)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            if _fsync_enabled():
                os.fsync(f.fileno())
        os.rename(tmp, path)
        fsync_dir(dirname)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path
