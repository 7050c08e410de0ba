"""The Train backend: brings a gang's collective group up on its workers
and down again. The twin of ``Backend``, ``JaxBackend`` and ``JaxConfig``
(``ray_tpu/train/backend_executor.py:201-290``), with the same
signatures, so ``ray_tpu``'s ``BackendExecutor`` can take
``TorchConfig().backend_cls()``; the port imports nothing of it.

A worker group is anything with ``len()``, ``execute(method, *args,
timeout=None)`` (the method on every worker, results in rank order) and
``execute_single(rank, method, *args)``, whose workers answer
``free_coordinator_address()`` and ``run_setup((fn, args, kwargs))`` by
calling ``fn(world_rank, world_size, *args, **kwargs)``, as
``ray_tpu/train/worker_group.py``'s ``TrainWorker`` does.

``on_start`` asks rank 0 for an address and has every rank join the
port's collective group ``group_name`` over a store there:
``"host:port"`` is a ``TCPStore`` whose master is rank 0,
``"file://<path>"`` a ``FileStore`` on a path every rank can reach. The
group's backend is ``collective_backend``: ``"gloo"`` (host tensors),
``"nccl"`` (each worker process on ``cuda:<its rank on its host>``) or
``"device"`` (rank threads, exchanging through device memory). A gang
whose ranks are threads of one process (``rank_threads=True``) registers
each rank's group as ``<group_name>_r<rank>``, since one process holds
one group per name; ``group_name_of(rank)`` gives the name a rank's code
uses.
"""
from __future__ import annotations

import datetime
import socket

import torch
import torch.distributed as dist

from ray_tpu_torch.util import collective as col
from ray_tpu_torch.util.collective.collective import DEFAULT_TIMEOUT_S
from ray_tpu_torch.util.collective.device_backend import store_wait

SHUTDOWN_TIMEOUT_S = 60.0
_NO_DISTRIBUTED = (
    "distributed=True (one world of ranks across hosts, jax.distributed's "
    "twin) is not ported yet: it needs a rank layout across processes, "
    "which the port does not have; a gang of worker processes joins one "
    "collective group (collective_backend='gloo' or 'nccl')")


class Backend:
    """Per-framework setup and teardown of a worker group."""

    def on_start(self, worker_group, scaling):
        pass

    def on_shutdown(self, worker_group):
        pass


def _store(address: str, world_size: int, world_rank: int,
           timeout_s: float):
    if address.startswith("file://"):
        return dist.FileStore(address[len("file://"):], world_size)
    host, sep, port = address.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"expected a 'host:port' or 'file://<path>' "
                         f"address, got {address!r}")
    return dist.TCPStore(host, int(port), world_size, world_rank == 0,
                         timeout=datetime.timedelta(seconds=timeout_s))


def group_name_of(group_name: str, rank: int, rank_threads: bool) -> str:
    """The name rank ``rank``'s group is registered under: ``group_name``,
    or ``<group_name>_r<rank>`` when the ranks are threads of one
    process."""
    return f"{group_name}_r{int(rank)}" if rank_threads else group_name


def _local_rank(store, world_rank: int, world_size: int,
                timeout_s: float) -> int:
    """This rank's index among the ranks on its host, in world order."""
    store.set(f"host{world_rank}", socket.gethostname())
    keys = [f"host{r}" for r in range(world_size)]
    store_wait(store, keys, timeout_s, "local rank")
    hosts = [store.get(k) for k in keys]
    return sum(1 for r in range(world_rank) if hosts[r] == hosts[world_rank])


def _join_group(world_rank, world_size, address, group_name, rank_threads,
                timeout_s, backend="gloo"):
    """Run on each rank by ``on_start``: joins ``group_name``'s group on
    ``backend`` (an NCCL rank on ``cuda:<its rank on its host>``) and
    returns the name it is registered under here."""
    store = dist.PrefixStore(group_name, _store(address, world_size,
                                                world_rank, timeout_s))
    registered = group_name_of(group_name, world_rank, rank_threads)
    device = None
    if backend == "nccl":
        device = torch.device("cuda", _local_rank(
            dist.PrefixStore("local_rank", store), world_rank, world_size,
            timeout_s))
    col.init_collective_group(world_size, world_rank, backend,
                              group_name=registered, store=store,
                              timeout_s=timeout_s, device=device)
    return registered


def _leave_group(world_rank, world_size, group_name, rank_threads):
    return col.destroy_collective_group(
        group_name_of(group_name, world_rank, rank_threads))


class TorchBackend(Backend):
    """The data-parallel backend of the port: one collective group over
    the gang, on the config's ``collective_backend``, which
    ``train.ddp``'s bucketed sync, ``ZeroOptimizer`` and the sharded
    checkpoints' commit run on."""

    def __init__(self, config: "TorchConfig"):
        self.config = config

    def group_name_of(self, rank: int) -> str:
        """The name rank ``rank``'s code finds its group under."""
        return group_name_of(self.config.group_name, rank,
                             self.config.rank_threads)

    def on_start(self, worker_group, scaling):
        cfg = self.config
        address = cfg.coordinator_address
        if address is None:
            address = worker_group.execute_single(
                0, "free_coordinator_address")
        worker_group.execute(
            "run_setup", (_join_group, (address, cfg.group_name,
                                        cfg.rank_threads, cfg.timeout_s,
                                        cfg.collective_backend), {}),
            timeout=cfg.timeout_s)

    def on_shutdown(self, worker_group):
        # destroys every rank's group; a dead or stuck rank costs at most
        # SHUTDOWN_TIMEOUT_S, and teardown never raises
        cfg = self.config
        try:
            worker_group.execute(
                "run_setup", (_leave_group, (cfg.group_name,
                                             cfg.rank_threads), {}),
                timeout=SHUTDOWN_TIMEOUT_S)
        except Exception:
            pass


class TorchConfig:
    """The port's ``JaxConfig``. ``coordinator_address`` (None: rank 0's
    ``free_coordinator_address()``) is where the ranks meet;
    ``collective_backend`` is the group's: ``"gloo"``, ``"nccl"`` or
    ``"device"`` (which needs ``rank_threads``); ``timeout_s`` bounds the
    meeting and every op of the group; ``rank_threads`` is for a gang
    whose ranks are threads of one process. ``distributed=True``
    (jax.distributed across hosts) is not ported and raises."""

    def __init__(self, distributed: bool = False,
                 coordinator_address: str | None = None,
                 group_name: str = "train_dp",
                 collective_backend: str = "gloo", *,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 rank_threads: bool = False):
        if distributed:
            raise NotImplementedError(_NO_DISTRIBUTED)
        if collective_backend not in col.BACKENDS:
            raise ValueError(f"unknown collective backend "
                             f"{collective_backend!r}: the port's are "
                             f"{', '.join(repr(b) for b in col.BACKENDS)}")
        if collective_backend == "device" and not rank_threads:
            raise ValueError("collective_backend='device' exchanges through "
                             "one process's memory: its ranks are threads "
                             "(rank_threads=True); worker processes use "
                             "'nccl' or 'gloo'")
        self.distributed = distributed
        self.coordinator_address = coordinator_address
        self.group_name = group_name
        self.collective_backend = collective_backend
        self.timeout_s = float(timeout_s)
        self.rank_threads = bool(rank_threads)

    def backend_cls(self):
        return TorchBackend(self)
