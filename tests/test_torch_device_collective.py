"""The device collective backend (ray_tpu_torch.util.collective,
backend="device"): ranks as threads of this process exchanging through
memory, here over CPU tensors, which run the same code as CUDA ones.
Every op is held to a reduction in rank order computed apart, to the
gloo group's result bit for bit at world 2, and at world 1 to the JAX
package's own XlaGroup. Also: the uneven reducescatter, the p2p ring,
the async handles, the refusal of a member in another process, the
poison path, and the NCCL backend's refusal without CUDA. Every wait has
a timeout."""
import os
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu_torch.exceptions import CollectiveGroupError
from ray_tpu_torch.util import collective as col
from tests.torch_gang import run_gang

DTYPES = [torch.float32, torch.bfloat16, torch.int64]
OPS = ["sum", "product", "min", "max"]
_NP = {"sum": np.add, "product": np.multiply, "min": np.minimum,
       "max": np.maximum}


def _inputs(world, shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == torch.int64:
        return [torch.from_numpy(rng.integers(-9, 10, shape)) for _ in
                range(world)]
    # near 1, so that products stay in range
    return [torch.from_numpy(rng.uniform(0.5, 1.5, shape).astype(np.float32))
            .to(dtype) for _ in range(world)]


def _rank_order(xs, op):
    """r0 op r1 op r2 ... in numpy, each step rounded to the dtype (bf16
    through f32, where one rounding of the exact f32 result is bf16's)."""
    dtype = xs[0].dtype
    as_np = [x.float().numpy() if dtype == torch.bfloat16 else x.numpy()
             for x in xs]
    out = as_np[0].copy()
    for x in as_np[1:]:
        out = _NP[op](out, x)
        if dtype == torch.bfloat16:
            out = torch.from_numpy(out).to(dtype).float().numpy()
    return torch.from_numpy(out).to(dtype)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.contiguous().view(torch.uint8).numpy().tobytes() == \
        b.contiguous().view(torch.uint8).numpy().tobytes()


def _all_ops(xs, op):
    """Every rank's results of every op on ``xs`` (one tensor a rank)."""
    world = len(xs)

    def rank(r, g):
        def x():  # a copy a call: gloo writes into a host input
            return xs[r].clone()

        out = {"allreduce": col.allreduce(x(), g, op),
               "reducescatter": col.reducescatter(x(), g, op),
               "allgather": col.allgather(x(), g),
               "broadcast": [col.broadcast(x(), s, g) for s in range(world)],
               "ring": col.sendrecv(x(), (r + 1) % world, (r - 1) % world,
                                    g)}
        col.barrier(g)
        return out

    return rank


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_every_op_equals_the_rank_order_reduction(world, op, dtype):
    xs = _inputs(world, (7, 3), dtype, seed=world)
    outs = run_gang(world, _all_ops(xs, op), backend="device",
                    name="dc_ops")
    want = _rank_order(xs, op)
    for r, out in enumerate(outs):
        _same(out["allreduce"], want)
        _same(out["reducescatter"],
              torch.tensor_split(want, world)[r])
        for got, x in zip(out["allgather"], xs):
            _same(got, x)
        for got, x in zip(out["broadcast"], xs):
            _same(got, x)
        _same(out["ring"], xs[(r - 1) % world])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("op", OPS)
def test_world_2_is_gloo_bit_for_bit(op, dtype):
    """At world 2 every reduction is one operation of two operands, so
    the device group and gloo agree to the bit, op by op."""
    xs = _inputs(2, (10, 4), dtype, seed=7)
    dev = run_gang(2, _all_ops(xs, op), backend="device", name="dc_b2")
    gloo = run_gang(2, _all_ops(xs, op), backend="gloo", name="dc_g2")
    for d, g in zip(dev, gloo):
        for key in ("allreduce", "reducescatter", "ring"):
            _same(d[key], g[key])
        for key in ("allgather", "broadcast"):
            for a, b in zip(d[key], g[key]):
                _same(a, b)


def test_world_1_equals_the_jax_xla_group():
    """At world 1 each op returns its input, as ray_tpu's XlaGroup does."""
    from ray_tpu.util.collective.xla_backend import XlaGroup

    xla = XlaGroup("g", 1, 0, None)
    x = _inputs(1, (5, 2), torch.float32)[0]
    mine = run_gang(1, _all_ops([x], "sum"), backend="device",
                    name="dc_w1")[0]
    ref = x.numpy()
    np.testing.assert_array_equal(mine["allreduce"].numpy(),
                                  np.asarray(xla.allreduce(ref, "sum", 0)))
    np.testing.assert_array_equal(
        mine["reducescatter"].numpy(),
        np.asarray(xla.reducescatter(ref, "sum", 0)))
    np.testing.assert_array_equal(mine["allgather"][0].numpy(),
                                  np.asarray(xla.allgather(ref, 0)[0]))
    np.testing.assert_array_equal(mine["broadcast"][0].numpy(),
                                  np.asarray(xla.broadcast(ref, 0, 0)))


@pytest.mark.parametrize("n", [5, 10, 13])
@pytest.mark.parametrize("world", [2, 3, 4])
def test_uneven_reducescatter_is_the_twins_array_split(world, n):
    """Rank r gets np.array_split(sum, world)[r], the JAX twin's uneven
    split (xla_backend.py:286-301): the first n % world chunks one row
    longer."""
    xs = _inputs(world, (n, 2), torch.float32, seed=n)
    outs = run_gang(world, lambda r, g: col.reducescatter(xs[r], g),
                    backend="device", name="dc_rs")
    full = _rank_order(xs, "sum").numpy()
    for r, got in enumerate(outs):
        np.testing.assert_array_equal(got.numpy(),
                                      np.array_split(full, world)[r])


@pytest.mark.parametrize("world", [2, 3])
def test_p2p_pairs_in_order_per_channel(world):
    """Several messages on one channel arrive in order, each of its sent
    shape and dtype; send_device and recv_device pair as the twin's
    matched calls, and a mismatched recv_device raises."""
    def rank(r, g):
        if r == 0:
            for k in range(3):
                col.send(torch.full((k + 1, 2), float(k)), 1, g)
            col.send_device(torch.arange(4, dtype=torch.int64), 1, g)
            col.send_device(torch.zeros(3), 1, g)
            return None
        if r == 1:
            got = [col.recv(0, g) for _ in range(3)]
            dev = col.recv_device((4,), torch.int64, 0, g)
            with pytest.raises(ValueError, match="expected"):
                col.recv_device((2,), torch.float32, 0, g)
            return got, dev
        return None

    outs = run_gang(world, rank, backend="device", name="dc_p2p")
    got, dev = outs[1]
    for k, t in enumerate(got):
        assert t.shape == (k + 1, 2) and (t == k).all()
    assert dev.tolist() == [0, 1, 2, 3]


def test_send_device_needs_a_device_group():
    def rank(r, g):
        with pytest.raises(ValueError, match="'device' or 'nccl'"):
            col.send_device(torch.zeros(2), 1 - r, g)
        return col.keeps_device(g), col.get_backend(g)

    assert run_gang(2, rank, name="dc_gloo") == [(False, "gloo")] * 2
    assert run_gang(2, lambda r, g: (col.keeps_device(g), col.get_backend(g)),
                    backend="device", name="dc_dev") == [(True, "device")] * 2


@pytest.mark.parametrize("world", [2, 4])
def test_async_handles_resolve_to_the_sync_results(world):
    xs = _inputs(world, (12,), torch.float32, seed=5)

    def rank(r, g):
        h1 = col.allreduce_async(xs[r], g)
        h2 = col.reducescatter_async(xs[r], g)
        h3 = col.allgather_async(xs[r], g)
        out = (h1.result(timeout=20), h2.result(timeout=20),
               h3.result(timeout=20))
        assert h1.poll() and h2.poll() and h3.poll()
        assert col.supports_async(g)
        return out

    want = _rank_order(xs, "sum")
    for r, (red, shard, gathered) in enumerate(
            run_gang(world, rank, backend="device", name="dc_async")):
        _same(red, want)
        _same(shard, torch.tensor_split(want, world)[r])
        for a, b in zip(gathered, xs):
            _same(a, b)


def test_allgather_object_and_unequal_shapes():
    def obj(r):
        return (r, "x" * (37 * r), {"n": [r] * r})

    outs = run_gang(3, lambda r, g: (col.allgather_object(obj(r), g),
                                     col.allgather(torch.ones(r + 1), g)),
                    backend="device", name="dc_obj")
    for objs, parts in outs:
        assert objs == [obj(r) for r in range(3)]
        assert [p.tolist() for p in parts] == [[1.0] * (r + 1)
                                               for r in range(3)]


def test_a_mismatched_allreduce_raises_on_every_rank():
    def rank(r, g):
        with pytest.raises(ValueError, match="rank 1 gave"):
            col.allreduce(torch.zeros(2 + r), g)
        return True

    assert run_gang(2, rank, backend="device", name="dc_bad") == [True] * 2


def _token_key(store, key="ray_tpu_torch/token0", timeout=10):
    store.wait([key], __import__("datetime").timedelta(seconds=timeout))
    return store.get(key).decode()


def test_a_member_in_another_process_is_refused():
    """The device group's ranks are threads of one process: a rank that
    reads another process's token is refused, naming 'nccl'; so is rank 0
    once a member reports another pid."""
    store = dist.HashStore()
    store.add("ray_tpu_torch/joined", 1)  # rank 0 of another process
    store.set("ray_tpu_torch/token0", f"{os.getpid() + 1}:elsewhere")
    with pytest.raises(ValueError, match="nccl"):
        col.init_collective_group(2, 1, "device", "dc_far1", store=store,
                                  timeout_s=5)
    assert not col.is_group_initialized("dc_far1")

    store = dist.HashStore()

    def foreign_rank_1():
        token = _token_key(store)
        store.add("ray_tpu_torch/joined", 1)
        store.set(f"ray_tpu_torch/{token}/pid1", str(os.getpid() + 1))

    t = threading.Thread(target=foreign_rank_1, daemon=True)
    t.start()
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="nccl"):
        col.init_collective_group(2, 0, "device", "dc_far0", store=store,
                                  timeout_s=10)
    assert time.monotonic() - t0 < 5
    t.join(10)
    assert not col.is_group_initialized("dc_far0")


def test_a_rank_that_raises_poisons_its_peers_within_2s():
    """Rank 2 raises while ranks 0 and 1 wait in an allreduce with a 30 s
    timeout: they raise CollectiveGroupError naming rank 2 within 2 s, and
    the group's later ops raise it too."""
    waited = {}

    def rank(r, g):
        if r == 2:
            time.sleep(0.2)
            raise RuntimeError("rank 2 died mid-step")
        t0 = time.monotonic()
        with pytest.raises(CollectiveGroupError) as info:
            col.allreduce(torch.ones(3), g)
        waited[r] = time.monotonic() - t0
        assert info.value.dead_ranks == (2,)
        assert "rank 2 died" in str(info.value)
        with pytest.raises(CollectiveGroupError):
            col.barrier(g)
        return True

    with pytest.raises(RuntimeError, match="rank 2 died"):
        run_gang(3, rank, backend="device", name="dc_poison", timeout_s=30)
    assert sorted(waited) == [0, 1]
    assert max(waited.values()) < 2.0


def test_a_gloo_groups_pending_handles_raise_the_poison():
    """A gloo group's handle in flight fails with CollectiveGroupError as
    soon as a member aborts the group, well before gloo's own timeout."""
    def rank(r, g):
        if r == 1:
            time.sleep(0.2)
            col.abort_collective_group(g, [1], "rank 1 left")
            return None
        handle = col.allreduce_async(torch.ones(3), g)
        t0 = time.monotonic()
        with pytest.raises(CollectiveGroupError, match="rank 1 left"):
            handle.result(timeout=20)
        with pytest.raises(CollectiveGroupError):
            col.allreduce(torch.ones(3), g)
        return time.monotonic() - t0

    waited = run_gang(2, rank, name="dc_gpoison", timeout_s=5)[0]
    assert waited < 2.0


def test_no_gloo_is_built_and_nccl_without_cuda_is_refused(monkeypatch):
    """"device" runs without building a gloo process group; "nccl" without
    CUDA raises a clear error, builds nothing and registers nothing."""
    def no_gloo(*a, **k):
        raise AssertionError("a gloo process group was built")

    monkeypatch.setattr(dist, "ProcessGroupGloo", no_gloo)
    outs = run_gang(2, lambda r, g: col.allreduce(torch.full((2,), r + 1.0),
                                                  g),
                    backend="device", name="dc_nogloo")
    assert [o.tolist() for o in outs] == [[3.0, 3.0]] * 2
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="CUDA"):
        col.init_collective_group(1, 0, "nccl", "dc_nccl",
                                  store=dist.HashStore(), timeout_s=5)
    assert time.monotonic() - t0 < 5
    assert not col.is_group_initialized("dc_nccl")
