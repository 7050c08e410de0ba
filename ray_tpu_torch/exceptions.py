"""The port's exceptions. The twin of the part of ``ray_tpu/exceptions.py``
that the port raises: ``RayTpuError`` and ``CollectiveGroupError``
(``:106-125``), with the same messages and fields."""
from __future__ import annotations


class RayTpuError(Exception):
    """Base of the port's errors."""


class CollectiveGroupError(RayTpuError):
    """The collective group was poisoned: a member rank died (or the
    group was torn down) while ops were pending. Raised by pending and
    future collective calls on every surviving rank, naming the dead
    rank(s), well under the collective op timeout, instead of letting
    each rank hang until its own watchdog fires. The group is unusable;
    recovery is a gang restart (destroy and re-create the group)."""

    def __init__(self, group: str, dead_ranks=(), reason: str = ""):
        self.group = group
        self.dead_ranks = tuple(sorted(set(int(r) for r in dead_ranks)))
        self.reason = reason
        ranks = (f" (dead ranks: {list(self.dead_ranks)})"
                 if self.dead_ranks else "")
        super().__init__(
            f"collective group {group!r} poisoned{ranks}: "
            f"{reason or 'member death'}")

    def __reduce__(self):
        return (type(self), (self.group, self.dead_ranks, self.reason))
