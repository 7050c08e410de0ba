"""The port's Train backend (ray_tpu_torch.train.backend_executor) over a
stand-in worker group whose ranks are threads of the test process
(``ThreadWorkerGroup`` below), meeting through a FileStore: no
process is started, no TCPStore built, no port bound. Its interface is
held to ray_tpu's Backend and JaxConfig by inspection."""
import inspect
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu.train import backend_executor as JB
from ray_tpu_torch.parallel import sharding as TS
from ray_tpu_torch.train import backend_executor as TB
from ray_tpu_torch.train import ddp as TD
from ray_tpu_torch.util import collective as col


class ThreadWorker:
    """A stand-in for ``ray_tpu``'s ``TrainWorker`` whose rank runs as a
    thread of the test process: it answers ``run_setup`` and
    ``free_coordinator_address`` (``address``, where the ranks meet)."""

    def __init__(self, world_rank, world_size, address):
        self.world_rank = world_rank
        self.world_size = world_size
        self.address = address

    def run_setup(self, setup_fn_and_args):
        fn, args, kwargs = setup_fn_and_args
        return fn(self.world_rank, self.world_size, *args, **kwargs)

    def free_coordinator_address(self):
        return self.address


class ThreadWorkerGroup:
    """A stand-in for ``ray_tpu``'s ``WorkerGroup`` over ``ThreadWorker``s:
    ``execute`` runs one method on every worker at once, each on a thread
    of its own, and returns the results in rank order; a worker still
    running after ``timeout`` raises ``TimeoutError`` (its thread is left
    to end on its own)."""

    def __init__(self, world, address):
        self.workers = [ThreadWorker(r, world, address) for r in range(world)]

    def __len__(self):
        return len(self.workers)

    def execute(self, method_name, *args, timeout=None, **kwargs):
        results, errors = [None] * len(self), [None] * len(self)

        def body(rank):
            try:
                results[rank] = getattr(self.workers[rank], method_name)(
                    *args, **kwargs)
            except BaseException as e:  # raised on the caller's thread
                errors[rank] = e

        threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                    name=f"worker_r{r}")
                   for r in range(len(self))]
        for t in threads:
            t.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in threads:
            t.join(None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
        stuck = [t.name for t in threads if t.is_alive()]
        if stuck:
            raise TimeoutError(f"{method_name} still running on {stuck} "
                               f"after {timeout}s")
        for e in errors:
            if e is not None:
                raise e
        return results

    def execute_single(self, rank, method_name, *args, **kwargs):
        return getattr(self.workers[rank], method_name)(*args, **kwargs)


SHAPES = {"w1": (96, 64), "b1": (64,), "w2": (64, 11), "emb": (3, 7, 5)}
BUCKET = 8192  # bytes: several buckets


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in sorted(SHAPES.items())}


def _bytes(tree):
    return {k: v.numpy().tobytes() for k, v in tree.items()}


@pytest.fixture
def gang(tmp_path):
    """A world-2 thread worker group brought up by TorchBackend.on_start
    over a file:// address that rank 0 hands out; torn down after."""
    group = ThreadWorkerGroup(2, f"file://{tmp_path / 'store'}")
    backend = TB.TorchConfig(group_name="tb_dp", timeout_s=20.0,
                             rank_threads=True).backend_cls()
    backend.on_start(group, None)
    yield group, backend
    backend.on_shutdown(group)


def test_on_start_brings_up_a_group_and_bucketed_sync_equals_whole_tree(
        gang, monkeypatch):
    group, backend = gang
    names = [backend.group_name_of(r) for r in range(2)]
    assert names == ["tb_dp_r0", "tb_dp_r1"]
    assert all(col.is_group_initialized(n) for n in names)
    assert [col.get_rank(n) for n in names] == [0, 1]
    assert {col.get_collective_group_size(n) for n in names} == {2}
    grads = [_grads(30 + r) for r in range(2)]

    def sync(rank, world, **kw):
        assert world == 2
        return _bytes(TD.sync_gradients(grads[rank], backend.group_name_of(rank),
                                        bucket_bytes=BUCKET, average=True, **kw))

    bucketed = group.execute("run_setup", (sync, (), {}), timeout=30)
    monkeypatch.setenv("RAY_TPU_TORCH_TRAIN_BUCKET_DDP", "0")
    whole = group.execute("run_setup", (sync, (), {}), timeout=30)
    expect = _bytes({k: (grads[0][k] + grads[1][k]) / 2 for k in SHAPES})
    assert bucketed == whole == [expect, expect]


def test_on_shutdown_tears_the_group_down_within_its_timeout(tmp_path):
    group = ThreadWorkerGroup(2, f"file://{tmp_path / 'store'}")
    backend = TB.TorchConfig(group_name="tb_down", timeout_s=20.0,
                             rank_threads=True).backend_cls()
    backend.on_start(group, None)
    names = [backend.group_name_of(r) for r in range(2)]
    assert all(col.is_group_initialized(n) for n in names)
    t0 = time.monotonic()
    backend.on_shutdown(group)
    assert time.monotonic() - t0 < TB.SHUTDOWN_TIMEOUT_S
    assert not any(col.is_group_initialized(n) for n in names)
    backend.on_shutdown(group)  # a second teardown finds nothing, quietly


def test_on_shutdown_does_not_hang_on_a_dead_rank(tmp_path, monkeypatch):
    """A rank that never answers costs on_shutdown its timeout, and the
    live rank's group is gone all the same."""
    group = ThreadWorkerGroup(2, f"file://{tmp_path / 'store'}")
    backend = TB.TorchConfig(group_name="tb_dead", timeout_s=20.0,
                             rank_threads=True).backend_cls()
    backend.on_start(group, None)
    release = threading.Event()
    dead, run_setup = group.workers[1], group.workers[1].run_setup

    def hang(setup):
        release.wait(30)
        return run_setup(setup)

    monkeypatch.setattr(dead, "run_setup", hang)
    monkeypatch.setattr(TB, "SHUTDOWN_TIMEOUT_S", 1.0)
    t0 = time.monotonic()
    try:
        backend.on_shutdown(group)  # raises nothing
        assert time.monotonic() - t0 < 10.0
        assert not col.is_group_initialized("tb_dead_r0")
    finally:
        release.set()
    deadline = time.monotonic() + 10
    while col.is_group_initialized("tb_dead_r1") and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not col.is_group_initialized("tb_dead_r1")


def test_the_ddp_mode_knob_is_read_by_sync_gradients(gang, monkeypatch):
    """train_ddp_mode: sync_gradients with no mode reads
    RAY_TPU_TORCH_TRAIN_DDP_MODE, as ray_tpu's reads RAY_TPU_TRAIN_DDP_MODE."""
    group, backend = gang
    grads = [_grads(40 + r) for r in range(2)]

    def sync(rank, world):
        return TD.sync_gradients(grads[rank], backend.group_name_of(rank),
                                 bucket_bytes=BUCKET)

    full = group.execute("run_setup", (sync, (), {}), timeout=30)
    assert all(isinstance(out, dict) for out in full)
    monkeypatch.setenv("RAY_TPU_TORCH_TRAIN_DDP_MODE", "reducescatter")
    shards = group.execute("run_setup", (sync, (), {}), timeout=30)
    assert all(isinstance(out, list) for out in shards)
    # the two ranks' shards of each bucket make up the full sum
    leaves = [full[0][k].reshape(-1) for k in sorted(SHAPES)]
    plan = TS.plan_buckets(leaves, BUCKET)
    for b, indices in enumerate(plan):
        joined = torch.cat([shards[0][b], shards[1][b]])
        assert torch.equal(joined, TS.pack_bucket(leaves, indices))


def _params_of(fn):
    """Names, kinds and defaults: ray_tpu's Backend annotates with its own
    WorkerGroup and ScalingConfig, which the port cannot import."""
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("method", ["on_start", "on_shutdown"])
def test_backend_signatures_equal_ray_tpus(method):
    for ours in (TB.Backend, TB.TorchBackend):
        assert (_params_of(getattr(ours, method))
                == _params_of(getattr(JB.Backend, method))
                == _params_of(getattr(JB.JaxBackend, method)))


def test_torch_config_mirrors_jax_config():
    jax_params = list(inspect.signature(JB.JaxConfig).parameters)
    torch_params = list(inspect.signature(TB.TorchConfig).parameters)
    assert torch_params[:len(jax_params)] == jax_params
    cfg = TB.TorchConfig()
    assert isinstance(cfg.backend_cls(), TB.TorchBackend)
    assert isinstance(cfg.backend_cls(), TB.Backend)
    assert (cfg.group_name, cfg.coordinator_address) == ("train_dp", None)
    assert cfg.backend_cls().group_name_of(3) == "train_dp"


@pytest.mark.parametrize("kw", [{"distributed": True, "collective_backend": "nccl"},
                                {"distributed": True}])
def test_what_is_not_ported_raises(kw):
    """distributed=True names what it lacks by title; the NCCL backend is
    a working config (test_torch_device_gang.py)."""
    with pytest.raises(NotImplementedError,
                       match="a rank layout across processes"):
        TB.TorchConfig(**kw)


def test_a_bad_address_raises_before_any_store():
    with pytest.raises(ValueError, match="host:port"):
        TB._store("no-port-here", 2, 0, 1.0)
    with pytest.raises(ValueError, match="unknown collective backend"):
        TB.TorchConfig(collective_backend="mpi")
    with pytest.raises(ValueError, match="rank_threads=True"):
        TB.TorchConfig(collective_backend="device")
