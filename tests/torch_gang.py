"""Runs a data-parallel gang of the port as threads of the test process.
Each rank thread holds its own gloo group, named ``<name>_r<rank>``, over
one shared in-memory ``HashStore``: no process is started and no address
is given. Every wait is bounded."""
import threading
import time

import torch.distributed as dist

from ray_tpu_torch.util import collective as col

GROUP_TIMEOUT_S = 30.0


def run_gang(world, fn, *, name="train_dp", timeout_s=GROUP_TIMEOUT_S,
             join_timeout_s=90.0):
    """``fn(rank, group_name)`` on ``world`` rank threads; returns their
    results in rank order and raises the first rank's error. A thread
    still alive after ``join_timeout_s`` fails the caller."""
    store = dist.HashStore()
    results, errors = [None] * world, [None] * world

    def body(rank):
        group = f"{name}_r{rank}"
        try:
            col.init_collective_group(world, rank, group_name=group,
                                      store=store, timeout_s=timeout_s)
            try:
                results[rank] = fn(rank, group)
            finally:
                col.destroy_collective_group(group)
        except BaseException as e:  # handed to the caller below
            errors[rank] = e

    threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                name=f"{name}_r{r}") for r in range(world)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + join_timeout_s
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    alive = [t.name for t in threads if t.is_alive()]
    assert not alive, f"rank threads alive after {join_timeout_s}s: {alive}"
    for e in errors:
        if e is not None:
            raise e
    return results
