"""The collective backends on the card: a device group of rank threads,
each on a CUDA stream of its own, keeps CUDA tensors on the card and
agrees with the host's rank-order reduction; the mesh on the device
backend trains GPT-2-tiny at dp 2 x tp 2 bit for bit as on gloo; an NCCL
group runs at world 1 and refuses two ranks on one card. These need an
NVIDIA GPU and skip without one. On a GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_collective.py
"""
import dataclasses
import threading
import time

import pytest
import torch
import torch.distributed as dist

from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.exceptions import CollectiveGroupError
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.parallel import sharding as sh
from ray_tpu_torch.parallel import train_step as ts
from ray_tpu_torch.parallel.mesh import MeshConfig
from ray_tpu_torch.util import collective as col
from tests.torch_gang import run_gang, run_mesh

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _on_streams(fn):
    """``fn`` run inside a CUDA stream of the rank thread's own, synced
    before it returns."""
    def run(*args):
        with torch.cuda.stream(torch.cuda.Stream()):
            out = fn(*args)
            torch.cuda.current_stream().synchronize()
            return out
    return run


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int64],
                         ids=str)
def test_device_group_ops_stay_on_the_card(cuda, world, dtype):
    gen = torch.Generator(device=cuda).manual_seed(world)
    if dtype == torch.int64:
        xs = [torch.randint(-9, 10, (1027, 5), device=cuda, generator=gen)
              for _ in range(world)]
    else:
        xs = [torch.rand(1027, 5, device=cuda, generator=gen).to(dtype)
              for _ in range(world)]
    torch.cuda.synchronize()

    @_on_streams
    def rank(r, g):
        # a busy stream: the deposit must wait for this rank's own writes
        x = xs[r].clone()
        for _ in range(20):
            x = x * 1 if dtype != torch.int64 else x + 0
        return (col.allreduce(x, g), col.reducescatter(x, g),
                col.sendrecv(x, (r + 1) % world, (r - 1) % world, g),
                col.allgather(x, g), col.broadcast(x.clone(), world - 1, g))

    outs = run_gang(world, rank, backend="device", name="cc_ops")
    want = xs[0].cpu()
    for x in xs[1:]:
        want = want + x.cpu()
    for r, (red, shard, ring, gathered, bcast) in enumerate(outs):
        assert all(t.is_cuda for t in (red, shard, ring, bcast, *gathered))
        if dtype == torch.int64 or world == 2:
            assert torch.equal(red.cpu(), want)
        else:
            torch.testing.assert_close(red.cpu().float(), want.float(),
                                       rtol=0, atol=4 * 2 ** -8 * world)
        assert torch.equal(shard.cpu(),
                           torch.tensor_split(red.cpu(), world)[r])
        assert torch.equal(ring, xs[(r - 1) % world])
        assert all(torch.equal(a, b) for a, b in zip(gathered, xs))
        assert torch.equal(bcast, xs[world - 1])


def test_mesh_on_the_device_backend_is_gloos_bit_for_bit(cuda):
    """GPT-2-tiny's first step at dp 2 x tp 2 on the card: metrics and
    grads the same bits on the device backend as on gloo."""
    cfg = dataclasses.replace(gpt2.gpt2_tiny(), dtype=torch.bfloat16,
                              max_seq=64)
    params = gpt2.init(torch.Generator(device=cuda).manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (8, 65), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    specs = gpt2.partition_specs(cfg)
    torch.cuda.synchronize()

    def run(backend):
        @_on_streams
        def rank(lay):
            mine = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                            sh.tree_shard(params, lay, specs))
            m, grads = ts.pipelined_grads(mine, {"tokens": tokens}, cfg, lay,
                                          1)
            return ({k: float(v) for k, v in m.items()},
                    [g.detach().cpu() for g in tree_leaves(grads)])
        return run_mesh(MeshConfig(dp=2, tp=2), rank, backend=backend,
                        name=f"cc_{backend}")

    for d, g in zip(run("device"), run("gloo")):
        assert d[0] == g[0]
        assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                   for a, b in zip(d[1], g[1]))


def test_poison_wakes_the_peers_on_the_card(cuda):
    waited = {}

    @_on_streams
    def rank(r, g):
        if r == 1:
            time.sleep(0.2)
            raise RuntimeError("rank 1 died")
        t0 = time.monotonic()
        with pytest.raises(CollectiveGroupError):
            col.allreduce(torch.ones(8, device=cuda), g)
        waited[r] = time.monotonic() - t0

    with pytest.raises(RuntimeError, match="rank 1 died"):
        run_gang(3, rank, backend="device", name="cc_poison", timeout_s=60)
    assert sorted(waited) == [0, 2] and max(waited.values()) < 2.0


def test_nccl_at_world_1_and_two_ranks_on_one_card(cuda):
    if not dist.is_nccl_available():
        with pytest.raises(RuntimeError, match="NCCL"):
            col.init_collective_group(1, 0, "nccl", "cc_nccl",
                                      store=dist.HashStore())
        return
    col.init_collective_group(1, 0, "nccl", "cc_nccl",
                              store=dist.HashStore(), device=cuda)
    try:
        x = torch.arange(10.0, device=cuda).reshape(5, 2)
        for out in (col.allreduce(x.clone(), "cc_nccl"),
                    col.reducescatter(x.clone(), "cc_nccl"),
                    col.allgather(x, "cc_nccl")[0],
                    col.broadcast(x.clone(), 0, "cc_nccl"),
                    col.sendrecv(x, 0, 0, "cc_nccl")):
            assert out.is_cuda and torch.equal(out, x)
        assert col.allgather_object("o", "cc_nccl") == ["o"]
        col.barrier("cc_nccl")
    finally:
        col.destroy_collective_group("cc_nccl")
    store, errors = dist.HashStore(), [None, None]

    def join(r):
        try:
            col.init_collective_group(2, r, "nccl", f"cc_two_r{r}",
                                      store=store, timeout_s=20, device=cuda)
        except ValueError as e:
            errors[r] = e

    threads = [threading.Thread(target=join, args=(r,)) for r in range(2)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert time.monotonic() - t0 < 20
    assert all(e is not None and "one device" in str(e) for e in errors)
