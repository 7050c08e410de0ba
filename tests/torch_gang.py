"""Runs a gang of the port as threads of the test process: a
data-parallel gang (``run_gang``), each rank holding its own gloo group,
named ``<name>_r<rank>``, or a mesh (``run_mesh`` from a ``MeshConfig``,
``run_on_mesh`` from a ``parallel.mesh.Mesh``), each rank holding its
axis groups (``parallel.mesh.init_rank_layout``, ``Mesh.join``).
The groups meet over one shared in-memory ``HashStore``: no process is
started and no address is given. Every wait is bounded."""
import threading
import time

import torch.distributed as dist

from ray_tpu_torch.parallel import mesh
from ray_tpu_torch.util import collective as col

GROUP_TIMEOUT_S = 30.0


def _run_threads(world, body, *, name, join_timeout_s):
    """``body(rank)`` on ``world`` threads; returns their results in rank
    order and raises the first rank's error. A thread still alive after
    ``join_timeout_s`` fails the caller."""
    results, errors = [None] * world, [None] * world

    def run(rank):
        try:
            results[rank] = body(rank)
        except BaseException as e:  # handed to the caller below
            errors[rank] = e

    threads = [threading.Thread(target=run, args=(r,), daemon=True,
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


def run_gang(world, fn, *, name="train_dp", timeout_s=GROUP_TIMEOUT_S,
             join_timeout_s=90.0):
    """``fn(rank, group_name)`` on ``world`` rank threads."""
    store = dist.HashStore()

    def body(rank):
        group = f"{name}_r{rank}"
        col.init_collective_group(world, rank, group_name=group,
                                  store=store, timeout_s=timeout_s)
        try:
            return fn(rank, group)
        finally:
            col.destroy_collective_group(group)

    return _run_threads(world, body, name=name,
                        join_timeout_s=join_timeout_s)


def run_mesh(config, fn, *, name="mesh", timeout_s=GROUP_TIMEOUT_S,
             join_timeout_s=90.0):
    """``fn(layout)`` on one rank thread for each rank of ``config`` (a
    ``parallel.mesh.MeshConfig``), in rank order."""
    store = dist.HashStore()

    def body(rank):
        layout = mesh.init_rank_layout(config, rank, store=store, name=name,
                                       timeout_s=timeout_s)
        try:
            return fn(layout)
        finally:
            mesh.destroy_rank_layout(layout)

    return _run_threads(config.world_size, body, name=name,
                        join_timeout_s=join_timeout_s)


def run_on_mesh(the_mesh, fn, *, name="mesh", timeout_s=GROUP_TIMEOUT_S,
                join_timeout_s=90.0):
    """``fn(layout)`` on one rank thread for each rank of ``the_mesh`` (a
    ``parallel.mesh.Mesh``), each joined by ``Mesh.join``, in rank
    order."""
    store = dist.HashStore()

    def body(rank):
        layout = the_mesh.join(rank, store=store, name=name,
                               timeout_s=timeout_s)
        try:
            return fn(layout)
        finally:
            mesh.destroy_rank_layout(layout)

    return _run_threads(the_mesh.size, body, name=name,
                        join_timeout_s=join_timeout_s)
