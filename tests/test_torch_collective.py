"""The port's collective groups (ray_tpu_torch.util.collective): ranks as
threads of this process, each with its own gloo group over one in-memory
store (tests/torch_gang.py). Results are held to numpy sums of the same
inputs; every wait has a timeout."""
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.parallel.sharding import shard_bounds
from ray_tpu_torch.util import collective as col
from tests.torch_gang import run_gang


def _inputs(world, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(world)]


def _f32_sum(xs):
    """Left-to-right f32 sum; at world 2 one IEEE add, which gloo's must
    equal bit for bit whatever its order."""
    out = xs[0].copy()
    for x in xs[1:]:
        out = out + x
    return out


def _close(got, xs, world):
    """Equal at world 2; within f32 reassociation beyond: each partial sum
    rounds once, so |err| <= (world - 1) * 2^-24 * sum |x_r|."""
    got = np.asarray(got)
    if world == 2:
        assert got.tobytes() == _f32_sum(xs).tobytes()
    else:
        exact = np.sum([x.astype(np.float64) for x in xs], axis=0)
        bound = (world - 1) * 2.0 ** -24 * np.sum(np.abs(xs), axis=0)
        assert (np.abs(got - exact) <= bound).all()


@pytest.mark.parametrize("world", [2, 4])
def test_allreduce(world):
    xs = _inputs(world, 1001)

    def rank(r, group):
        assert col.get_rank(group) == r
        assert col.get_collective_group_size(group) == world
        assert col.supports_async(group)
        t = torch.from_numpy(xs[r].copy())
        out = col.allreduce(t, group)
        assert out.data_ptr() == t.data_ptr()  # in place on a host tensor
        return out.numpy().copy()

    outs = run_gang(world, rank)
    for out in outs:
        assert out.tobytes() == outs[0].tobytes()
        _close(out, xs, world)


@pytest.mark.parametrize("n", [8, 10, 1001])
@pytest.mark.parametrize("world", [2, 4])
def test_reducescatter_uneven_split(world, n):
    """Rank r gets elements shard_bounds(n, world)[r] of the sum, also
    where n % world != 0."""
    xs = _inputs(world, n, seed=n)
    outs = run_gang(world, lambda r, g: col.reducescatter(
        torch.from_numpy(xs[r].copy()), g).numpy().copy())
    full = np.concatenate(outs)
    for r, (lo, hi) in enumerate(shard_bounds(n, world)):
        assert outs[r].shape == (hi - lo,)
    _close(full, xs, world)


@pytest.mark.parametrize("world", [2, 4])
def test_allgather_padded_to_the_widest_shard(world):
    """gloo gathers equal sizes only; shards of a divmod split are padded
    to the widest, gathered, and trimmed back to their bounds."""
    n = 4 * world + 3
    stream = np.arange(n, dtype=np.float32)
    bounds = shard_bounds(n, world)
    width = max(hi - lo for lo, hi in bounds)

    def rank(r, group):
        lo, hi = bounds[r]
        mine = torch.zeros(width)
        mine[:hi - lo] = torch.from_numpy(stream[lo:hi])
        parts = col.allgather(mine, group)
        return torch.cat([p[:h - l] for p, (l, h) in zip(parts, bounds)])

    for got in run_gang(world, rank):
        assert got.numpy().tobytes() == stream.tobytes()


@pytest.mark.parametrize("world", [1, 2, 3])
def test_allgather_object_of_unequal_sizes(world):
    """Every rank's object in rank order, though their pickles differ in
    size (gloo's allgather takes equal sizes: the bytes are padded)."""
    def obj(r):
        return (r, "x" * (37 * r), None if r else "sha", {"n": [r] * r})

    outs = run_gang(world, lambda r, g: col.allgather_object(obj(r), g))
    assert outs == [[obj(r) for r in range(world)]] * world


@pytest.mark.parametrize("world", [2, 4])
def test_async_handles_poll_and_result(world):
    """Async allreduce, reducescatter and allgather in flight together
    resolve to what the synchronous ops return."""
    xs = _inputs(world, 12, seed=5)

    def rank(r, group):
        h1 = col.allreduce_async(torch.from_numpy(xs[r].copy()), group)
        h2 = col.reducescatter_async(torch.from_numpy(xs[r].copy()), group)
        h3 = col.allgather_async(torch.full((3,), float(r)), group)
        out = (h1.result(timeout=20), h2.result(timeout=20),
               h3.result(timeout=20))
        assert h1.poll() and h2.poll() and h3.poll()
        return out

    outs = run_gang(world, rank)
    for r, (reduced, shard, gathered) in enumerate(outs):
        _close(reduced.numpy(), xs, world)
        lo, hi = shard_bounds(12, world)[r]
        _close(shard.numpy(), [x[lo:hi] for x in xs], world)
        assert [g.tolist() for g in gathered] == \
            [[float(q)] * 3 for q in range(world)]


@pytest.mark.parametrize("op", ["allreduce", "reducescatter", "allgather"])
def test_result_times_out_when_a_rank_never_joins_the_op(op):
    """Rank 1 holds back its op: rank 0's result(timeout=1) raises
    TimeoutError within seconds (gloo's reducescatter Work ignores a
    wait's timeout, the handle does not), and once rank 1 joins, the same
    handle completes with the right value."""
    held_back = threading.Event()
    start = getattr(col, f"{op}_async")

    def value(h):
        out = h.result(timeout=20)
        return [t.tolist() for t in out] if op == "allgather" else out.tolist()

    def rank(r, group):
        t = torch.full((4,), float(r + 1))
        if r == 1:
            assert held_back.wait(timeout=20)
            return value(start(t, group))
        h = start(t, group)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="did not complete"):
            h.result(timeout=1)
        waited = time.monotonic() - t0
        assert not h.poll()
        held_back.set()
        return waited, value(h)

    (waited, late), joined = run_gang(2, rank)
    assert 0.9 <= waited < 5
    if op == "allgather":
        assert late == joined == [[1.0] * 4, [2.0] * 4]
    elif op == "allreduce":
        assert late == joined == [3.0] * 4
    else:
        assert late == joined == [3.0] * 2


def test_join_times_out_when_a_rank_never_comes():
    """Rank 1 of the group never joins: rank 0's join raises after its
    timeout, and the name it had reserved is free again."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timeout"):
        col.init_collective_group(2, 0, group_name="col_lonely",
                                  store=torch.distributed.HashStore(),
                                  timeout_s=1)
    assert time.monotonic() - t0 < 10
    assert not col.is_group_initialized("col_lonely")
    col.init_collective_group(1, 0, group_name="col_lonely",
                              store=torch.distributed.HashStore())
    try:
        assert col.allreduce(torch.ones(2), "col_lonely").tolist() == [1, 1]
    finally:
        assert col.destroy_collective_group("col_lonely")


def test_destroy_frees_the_name():
    for _ in range(2):  # the second gang reuses the names the first freed
        names = run_gang(2, lambda r, g: (g, col.is_group_initialized(g)),
                         name="col_reuse")
        assert names == [("col_reuse_r0", True), ("col_reuse_r1", True)]
        assert not any(col.is_group_initialized(g) for g, _ in names)
    assert not col.destroy_collective_group("col_reuse_r0")


@pytest.mark.parametrize("call, error", [
    (lambda: col.init_collective_group(2, 2, store=torch.distributed.HashStore()),
     "out of range"),
    (lambda: col.init_collective_group(2, 0, "mpi", store=torch.distributed.HashStore()),
     "unknown backend"),
    (lambda: col.get_rank("col_never_made"), "not initialized"),
    (lambda: col.allreduce(torch.zeros(2), "col_never_made"), "not initialized"),
], ids=["rank", "backend", "get_rank", "op"])
def test_refusals_before_any_group_state(call, error):
    with pytest.raises(ValueError, match=error):
        call()
    assert not col.is_group_initialized("default")
