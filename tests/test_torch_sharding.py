"""The port's bucket plan (ray_tpu_torch.parallel.sharding) against the
JAX package's (ray_tpu.parallel.sharding): plan, shard map, fingerprint
and reslice spans on the GPT-2-small tree, the port's twins of the JAX
package's unit tests of the same functions, and pack/unpack."""
import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as JG
from ray_tpu.parallel import sharding as JS
from ray_tpu.util.collective import host_backend as hb
from ray_tpu_torch.parallel import sharding as TS

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int64": torch.int64, "float16": torch.float16}


def _np_dtype(name):
    return np.dtype(ml_dtypes.bfloat16 if name == "bfloat16" else name)


@pytest.fixture(scope="module")
def small_trees():
    """GPT-2-small's param tree twice, as numpy arrays and as torch
    tensors of the shapes jax.eval_shape gives; np.empty and the meta
    device commit no memory."""
    shapes = jax.eval_shape(lambda k: JG.init(k, JG.gpt2_small()),
                            jax.random.PRNGKey(0))
    np_tree = jax.tree.map(lambda s: np.empty(s.shape, s.dtype), shapes)
    torch_tree = jax.tree.map(
        lambda s: torch.empty(s.shape, dtype=TORCH_DTYPES[str(s.dtype)],
                              device="meta"), shapes)
    return np_tree, torch_tree


@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("bucket_bytes", [1 << 10, 4 << 20, 25 << 20, 1 << 62],
                         ids=["1KiB", "4MiB", "25MiB", "whole"])
def test_gpt2_small_plan_equals_jax(small_trees, bucket_bytes, world):
    np_tree, torch_tree = small_trees
    jleaves, _ = JS.flatten_tree(np_tree)
    tleaves, _ = TS.flatten_tree(torch_tree)
    assert [tuple(t.shape) for t in tleaves] == [j.shape for j in jleaves]
    plan = TS.plan_buckets(tleaves, bucket_bytes)
    assert plan == JS.plan_buckets(jleaves, bucket_bytes)
    assert TS.plan_fingerprint(tleaves, plan) == \
        JS.plan_fingerprint(jleaves, plan)
    tmap = TS.plan_shard_map(tleaves, plan, world)
    jmap = JS.plan_shard_map(jleaves, plan, world)
    assert [{**e, "dtype": str(e["dtype"]).removeprefix("torch.")}
            for e in tmap] == \
        [{**e, "dtype": str(e["dtype"])} for e in jmap]
    for e in tmap:
        for old_world in (1, 2, 3, 4):
            for new_rank in range(world):
                assert TS.reslice_spans(e["elems"], old_world, world,
                                        new_rank) == \
                    JS.reslice_spans(e["elems"], old_world, world, new_rank)


# ------------------------------------------------ twins of the JAX units
def _twin_bucket_plan_deterministic_and_size_targeted():
    """test_zz_bucket_ddp.py::test_bucket_plan_deterministic_and_size_targeted"""
    tree = {
        "w1": torch.zeros(100, 100),                # 40 KB
        "b1": torch.zeros(100),                     # 400 B
        "w2": torch.zeros(50, 100),                 # 20 KB
        "ints": torch.zeros(64, dtype=torch.int64),  # distinct dtype
        "scalar": torch.tensor(1.0),
    }
    leaves, treedef = TS.flatten_tree(tree)
    plan = TS.plan_buckets(leaves, 24 * 1024)
    assert plan == TS.plan_buckets(leaves, 24 * 1024)   # deterministic
    jleaves, _ = JS.flatten_tree({k: v.numpy() for k, v in tree.items()})
    assert plan == JS.plan_buckets(jleaves, 24 * 1024)
    seen = []
    for bucket in plan:
        assert len({leaves[i].dtype for i in bucket}) == 1
        assert bucket == sorted(bucket)
        seen += bucket
    assert sorted(seen) == list(range(len(leaves)))
    for bucket in plan:
        if len(bucket) > 1:
            assert sum(leaves[i].nbytes for i in bucket) <= 24 * 1024
    big = [b for b in plan if any(leaves[i].nbytes > 24 * 1024 for i in b)]
    assert big and all(len(b) == 1 for b in big)
    out = [None] * len(leaves)
    for bucket in plan:
        TS.unpack_bucket(TS.pack_bucket(leaves, bucket), leaves, bucket, out)
    rt = TS.unflatten_tree(treedef, out)
    for k in tree:
        assert rt[k].numpy().tobytes() == tree[k].numpy().tobytes(), k


def _twin_shard_bounds_pin_backend_split():
    """test_zz_zero_ddp.py::test_shard_bounds_pin_backend_split: the shard
    map's split is the JAX host backend's, np.array_split's and that of
    torch.tensor_split, by which the port's reducescatter splits."""
    for total in (0, 1, 2, 7, 100, 101, 8191, 70000):
        for parts in (1, 2, 3, 4, 8):
            got = TS.shard_bounds(total, parts)
            assert got == JS.shard_bounds(total, parts)
            assert got == list(hb._split_bounds(total, parts))
            sizes = [hi - lo for lo, hi in got]
            assert sizes == [len(c) for c in
                             np.array_split(np.zeros(total), parts)]
            assert sizes == [len(c) for c in
                             torch.tensor_split(torch.zeros(total), parts)]
            assert got[0][0] == 0 and got[-1][1] == total
            for (_, a), (b, _) in zip(got, got[1:]):
                assert a == b


def _twin_plan_shard_map_covers_plan():
    """test_zz_zero_ddp.py::test_plan_shard_map_covers_plan"""
    tree = {"w1": torch.zeros(96, 64), "b1": torch.zeros(64),
            "w2": torch.zeros(64, 11),
            "ints": torch.zeros(33, dtype=torch.int64)}
    leaves, _ = TS.flatten_tree(tree)
    plan = TS.plan_buckets(leaves, 8192)
    for world in (1, 2, 4):
        smap = TS.plan_shard_map(leaves, plan, world)
        assert smap == TS.plan_shard_map(leaves, plan, world)
        assert len(smap) == len(plan)
        for b, indices in enumerate(plan):
            e = smap[b]
            assert e["indices"] == indices
            assert e["elems"] == sum(leaves[i].numel() for i in indices)
            assert e["dtype"] == leaves[indices[0]].dtype
            assert e["bounds"] == TS.shard_bounds(e["elems"], world)


def _params(n=1500):
    rng = np.random.default_rng(0)
    return {"w": torch.from_numpy(rng.standard_normal((n, 4))
                                  .astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal(7).astype(np.float32)),
            "steps": torch.arange(5)}


def _twin_plan_fingerprint_world_independent_and_shape_sensitive():
    """test_zz_sharded_ckpt.py::test_plan_fingerprint_world_independent_and_shape_sensitive"""
    bb = 4096
    leaves, _ = TS.flatten_tree(_params())
    plan = TS.plan_buckets(leaves, bb)
    fp = TS.plan_fingerprint(leaves, plan)
    jleaves, _ = JS.flatten_tree({k: v.numpy()
                                  for k, v in _params().items()})
    assert fp == JS.plan_fingerprint(jleaves, plan)
    assert fp == TS.plan_fingerprint(list(leaves), plan)
    for world in (1, 2, 4, 7):
        TS.plan_shard_map(leaves, plan, world)
        assert TS.plan_fingerprint(leaves, plan) == fp
    other, _ = TS.flatten_tree(_params(n=1503))
    assert TS.plan_fingerprint(other, TS.plan_buckets(other, bb)) != fp
    merged = TS.plan_buckets(leaves, bb * 100)
    assert merged != plan
    assert TS.plan_fingerprint(leaves, merged) != fp


def _twin_reslice_spans_tile_exactly():
    """test_zz_sharded_ckpt.py::test_reslice_spans_tile_exactly"""
    for elems in (1, 5, 64, 1000, 1001):
        stream = torch.arange(elems)
        for old_world in (1, 2, 3, 4):
            old_shards = [stream[lo:hi] for lo, hi in
                          TS.shard_bounds(elems, old_world)]
            for new_world in (1, 2, 3, 4, 5):
                covered = []
                for new_rank in range(new_world):
                    lo, hi = TS.shard_bounds(elems, new_world)[new_rank]
                    spans = TS.reslice_spans(elems, old_world, new_world,
                                             new_rank)
                    assert spans == JS.reslice_spans(elems, old_world,
                                                     new_world, new_rank)
                    parts = [old_shards[r][a:b] for r, a, b in spans]
                    got = torch.cat(parts) if parts else stream[:0]
                    assert torch.equal(got, stream[lo:hi])
                    covered.append(got)
                assert torch.equal(torch.cat(covered), stream)


@pytest.mark.parametrize("twin", [
    _twin_bucket_plan_deterministic_and_size_targeted,
    _twin_shard_bounds_pin_backend_split,
    _twin_plan_shard_map_covers_plan,
    _twin_plan_fingerprint_world_independent_and_shape_sensitive,
    _twin_reslice_spans_tile_exactly,
], ids=lambda f: f.__name__.removeprefix("_twin_"))
def test_twin_of_jax_unit(twin):
    twin()


def _bytes(t):
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("dtype", sorted(TORCH_DTYPES))
def test_pack_unpack_roundtrip_bitwise(dtype):
    """Every bit pattern survives, NaN payloads and signed zeros too; the
    packed stream is the JAX package's for the same leaves."""
    rng = np.random.default_rng(3)
    np_dt = _np_dtype(dtype)
    raw = {"a": (3, 5), "b": (7,), "c": (), "d": (2, 2, 2)}
    tree = {}
    for k, shape in raw.items():
        n = int(np.prod(shape))
        bits = rng.integers(0, 1 << (8 * np_dt.itemsize), n,
                            dtype=np.uint64).astype(f"u{np_dt.itemsize}")
        tree[k] = bits.view(np_dt).reshape(shape)
    ttree = {k: torch.from_numpy(v.view(f"i{np_dt.itemsize}").copy())
             .view(TORCH_DTYPES[dtype]) for k, v in tree.items()}
    leaves, treedef = TS.flatten_tree(ttree)
    jleaves, _ = JS.flatten_tree(tree)
    plan = TS.plan_buckets(leaves, 16)
    assert plan == JS.plan_buckets(jleaves, 16)
    out = [None] * len(leaves)
    for bucket in plan:
        flat = TS.pack_bucket(leaves, bucket)
        assert flat.dtype == TORCH_DTYPES[dtype] and flat.dim() == 1
        ref = JS.pack_bucket(jleaves, bucket)
        assert _bytes(flat) == ref.tobytes()
        TS.unpack_bucket(flat, leaves, bucket, out)
    back = TS.unflatten_tree(treedef, out)
    for k, t in ttree.items():
        assert back[k].shape == t.shape and back[k].dtype == t.dtype
        assert _bytes(back[k]) == _bytes(t), k


@pytest.mark.parametrize("world", [1, 2, 3, 4, 7])
def test_pack_span_is_the_shard_of_the_packed_bucket(world):
    """A rank's span of a bucket, copied from the leaves alone, is that
    rank's slice of the packed bucket, bit for bit, for every shard of the
    plan's shard map: spans that start or end inside a leaf, cover
    several, or are empty."""
    rng = np.random.default_rng(11)
    shapes = {"a": (3, 5), "b": (7,), "c": (), "d": (2, 2, 2), "e": (1,)}
    tree = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in shapes.items()}
    leaves, _ = TS.flatten_tree(tree)
    plan = TS.plan_buckets(leaves, 64)
    for entry in TS.plan_shard_map(leaves, plan, world):
        flat = TS.pack_bucket(leaves, entry["indices"])
        for lo, hi in entry["bounds"]:
            span = TS.pack_span(leaves, entry["indices"], lo, hi)
            assert span.shape == (hi - lo,)
            assert _bytes(span) == _bytes(flat[lo:hi])
