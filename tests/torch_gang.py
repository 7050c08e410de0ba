"""Runs a gang of the port as threads of the test process: a
data-parallel gang (``run_gang``), each rank holding its own collective
group, named ``<name>_r<rank>``, or a mesh (``run_mesh`` from a
``MeshConfig``, ``run_on_mesh`` from a ``parallel.mesh.Mesh``), each rank
holding its axis groups (``parallel.mesh.init_rank_layout``,
``Mesh.join``). The groups run on ``backend`` (``"gloo"`` for a gang by
default, ``"device"`` for a mesh, as ``init_rank_layout`` defaults) and
meet over one shared in-memory ``HashStore``: no process is started and
no address is given. Every wait is bounded, and a rank whose code raises
poisons its groups (``collective.poison_on_error``), so its peers fail at
once instead of waiting out their timeout."""
import threading
import time

import torch.distributed as dist

from ray_tpu_torch.parallel import mesh
from ray_tpu_torch.util import collective as col

GROUP_TIMEOUT_S = 30.0


def _run_threads(world, join, fn, leave, groups, *, name, join_timeout_s):
    """On each of ``world`` threads: ``member = join(rank)``, then
    ``fn(member)``, then ``leave(member)``; a rank whose ``fn`` raises
    aborts its ``groups(member)`` first. Returns the results in rank
    order and raises the first rank's error. A thread still alive after
    ``join_timeout_s`` fails the caller."""
    results, errors = [None] * world, [None] * world

    def run(rank):
        try:
            member = join(rank)
            try:
                with col.poison_on_error(*groups(member)):
                    results[rank] = fn(member)
            finally:
                leave(member)
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
             join_timeout_s=90.0, backend="gloo"):
    """``fn(rank, group_name)`` on ``world`` rank threads."""
    store = dist.HashStore()

    def join(rank):
        group = f"{name}_r{rank}"
        col.init_collective_group(world, rank, backend, group_name=group,
                                  store=store, timeout_s=timeout_s)
        return rank, group

    return _run_threads(world, join, lambda m: fn(*m),
                        lambda m: col.destroy_collective_group(m[1]),
                        lambda m: [m[1]], name=name,
                        join_timeout_s=join_timeout_s)


def run_mesh(config, fn, *, name="mesh", timeout_s=GROUP_TIMEOUT_S,
             join_timeout_s=90.0, backend="device"):
    """``fn(layout)`` on one rank thread for each rank of ``config`` (a
    ``parallel.mesh.MeshConfig``), in rank order."""
    store = dist.HashStore()
    return _run_threads(
        config.world_size,
        lambda rank: mesh.init_rank_layout(config, rank, store=store,
                                           name=name, timeout_s=timeout_s,
                                           backend=backend),
        fn, mesh.destroy_rank_layout, mesh.layout_groups, name=name,
        join_timeout_s=join_timeout_s)


def run_on_mesh(the_mesh, fn, *, name="mesh", timeout_s=GROUP_TIMEOUT_S,
                join_timeout_s=90.0, backend="device"):
    """``fn(layout)`` on one rank thread for each rank of ``the_mesh`` (a
    ``parallel.mesh.Mesh``), each joined by ``Mesh.join``, in rank
    order."""
    store = dist.HashStore()
    return _run_threads(
        the_mesh.size,
        lambda rank: the_mesh.join(rank, store=store, name=name,
                                   timeout_s=timeout_s, backend=backend),
        fn, mesh.destroy_rank_layout, mesh.layout_groups, name=name,
        join_timeout_s=join_timeout_s)
