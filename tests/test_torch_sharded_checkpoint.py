"""The port's sharded checkpoints (ray_tpu_torch.train.sharded_checkpoint)
against ray_tpu's (ray_tpu.train.sharded_checkpoint): one on-disk format,
so a generation written by either package restores in the other, at
another world size, bit for bit, params and optimizer slots both.

The tree is a small GPT-2's, made with numpy from a seed: numpy arrays
for ray_tpu, CPU tensors for the port. Gangs of the port run as threads
of the test process (tests/torch_gang.py); ray_tpu saves groupless, its
ranks acking by a directory scan, as test_zz_sharded_ckpt.py does.
"""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from ray_tpu.parallel import sharding as JS
from ray_tpu.train import sharded_checkpoint as JC
from ray_tpu_torch._private.tree import tree_leaves, tree_map, tree_unflatten
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.parallel import train_step as TT
from ray_tpu_torch.train import ddp as TD
from ray_tpu_torch.train import sharded_checkpoint as TC
from tests.torch_gang import run_gang

CFG = TG.GPT2Config(vocab_size=64, max_seq=16, n_layer=2, n_head=2,
                    d_model=32, remat=False, dtype=torch.float32)
BB = 16 << 10  # bucket bytes: the tree's ~100 KB spread over several buckets


def _tree(seed):
    """A GPT-2 param tree of CFG's shapes with seeded values, as numpy."""
    rng = np.random.default_rng(seed)
    shapes = TG.init(torch.Generator().manual_seed(0), CFG, device="cpu")
    return tree_map(lambda t: rng.standard_normal(tuple(t.shape))
                    .astype(np.float32), shapes)


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np_leaves(tree):
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
            for x in tree_leaves(tree)]


def _assert_same_bits(a, b, msg=""):
    la, lb = _np_leaves(a), _np_leaves(b)
    assert len(la) == len(lb), msg
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, msg
        assert x.tobytes() == y.tobytes(), msg


class _DuckZero:
    """A stand-in for either package's ZeroOptimizer, as in
    test_zz_sharded_ckpt.py::_FakeZero: over the real plan and shard map,
    its slots at (world, rank) are slices of full f32 vectors that are a
    pure function of the packed bucket, so every world slices the same
    streams. Both packages' save and restore take it."""

    def __init__(self, params, world, rank, step=9):
        leaves = _np_leaves(params)
        self._plan = JS.plan_buckets(leaves, BB)
        self._shard_map = JS.plan_shard_map(leaves, self._plan, world)
        self.plan_fingerprint = JS.plan_fingerprint(leaves, self._plan)
        self._bucket_bytes = BB
        self._group = None
        self._world, self._rank, self._step = world, rank, step
        self.full = []  # per bucket: slot -> the whole vector
        for indices in self._plan:
            packed = JS.pack_bucket(leaves, indices)
            self.full.append({"m": packed * np.float32(0.5) + np.float32(1),
                              "v": packed * packed})
        self.loaded = None

    def _ensure_plan(self, leaves):
        pass

    def shard_state_dict(self):
        buckets = []
        for b in range(len(self._plan)):
            lo, hi = self._shard_map[b]["bounds"][self._rank]
            buckets.append({k: v[lo:hi] for k, v in self.full[b].items()})
        return {"step": self._step,
                "plan_fingerprint": self.plan_fingerprint,
                "world": self._world, "rank": self._rank, "buckets": buckets}

    def load_shard_state_dict(self, state):
        self.loaded = state

    def expect(self, b, slot):
        lo, hi = self._shard_map[b]["bounds"][self._rank]
        return self.full[b][slot][lo:hi]


def _save_groupless(sc, params, world, root, step, opts=None):
    """Every rank's save; ranks 1.. harvest first, then rank 0 commits."""
    pend = [sc.save_sharded(params, None if opts is None else opts[r],
                            root=root, step=step, world=world, rank=r,
                            bucket_bytes=BB, asynchronous=False)
            for r in range(world)]
    for r in range(1, world):
        assert pend[r].result()["committed"]
    res = pend[0].result()
    assert res["committed"], res
    return res


def _zero_rank(rank, group, params, grads, steps):
    """``steps`` ZeroOptimizer(zero_adam) steps of one rank; its params
    (identical on every rank) and its shard state, as numpy."""
    zopt = TD.ZeroOptimizer(TD.zero_adam(1e-2), group, bucket_bytes=BB,
                            average=True)
    p = _torch(params)
    for s in range(steps):
        p = zopt.step(p, _torch(grads[s][rank]))
    return zopt, p


def _grads(world, steps, seed=3):
    return [[_tree(seed + 10 * s + r) for r in range(world)]
            for s in range(steps)]


# ------------------------------------------- one format, both directions


@pytest.mark.parametrize("new_world", [1, 2, 3, 4])
def test_ray_tpu_world4_save_restores_in_the_port(tmp_path, new_world):
    root = str(tmp_path)
    params = _tree(5)
    savers = [_DuckZero(params, 4, r) for r in range(4)]
    res = _save_groupless(JC, params, 4, root, 11, savers)
    assert sorted(res["manifest"]["shards"]) == ["0", "1", "2", "3"]
    for new_rank in range(new_world):
        loader = _DuckZero(params, new_world, new_rank)
        restored, meta = TC.restore_sharded(
            _torch(_tree(6)), loader, root=root, world=new_world,
            rank=new_rank)
        _assert_same_bits(restored, params, (new_world, new_rank))
        assert meta["world_saved"] == 4 and meta["step"] == 11
        assert meta["resharded"] == (new_world != 4)
        st = loader.loaded
        assert st["step"] == 11 and st["plan_fingerprint"] == loader.plan_fingerprint
        for b in range(len(loader._plan)):
            for slot in ("m", "v"):
                got = st["buckets"][b][slot].numpy()
                assert got.tobytes() == loader.expect(b, slot).tobytes()


def test_ray_tpu_save_restores_into_the_ports_zero_optimizer(tmp_path):
    """Slots saved by ray_tpu at world 4 land in the port's real
    ZeroOptimizer at world 2 (rank threads), each rank holding its span."""
    root = str(tmp_path)
    params = _tree(7)
    _save_groupless(JC, params, 4, root, 9,
                    [_DuckZero(params, 4, r) for r in range(4)])

    def rank(r, group):
        zopt = TD.ZeroOptimizer(TD.zero_adam(1e-2), group, bucket_bytes=BB)
        template = _torch(_tree(8))
        restored, meta = TC.restore_sharded(template, zopt, root=root)
        zopt._ensure_plan(tree_leaves(restored))  # installs the slots
        state = zopt.shard_state_dict()
        return restored, meta, state

    outs = run_gang(2, rank, name="ck_in")
    for r, (restored, meta, state) in enumerate(outs):
        _assert_same_bits(restored, params)
        assert meta["resharded"] and state["step"] == 9
        duck = _DuckZero(params, 2, r)
        assert state["plan_fingerprint"] == duck.plan_fingerprint
        for b, slots in enumerate(state["buckets"]):
            assert sorted(slots) == ["m", "v"]
            for slot, t in slots.items():
                assert t.numpy().tobytes() == duck.expect(b, slot).tobytes()


def test_port_world2_save_restores_in_ray_tpu(tmp_path):
    """The port saves at world 2 from its real ZeroOptimizer after a step
    (rank threads, the commit acked by allgather_object); ray_tpu
    restores at worlds 1, 3 and 4: params bit-exact, and each rank's
    slots the right span of the two ranks' slots concatenated."""
    root = str(tmp_path)
    params, grads = _tree(11), _grads(2, 1)

    def rank(r, group):
        zopt, p = _zero_rank(r, group, params, grads, 1)
        res = TC.save_sharded(p, zopt, root=root, asynchronous=False).result()
        return res, _np_leaves(p), zopt.shard_state_dict()["buckets"]

    outs = run_gang(2, rank, name="ck_out")
    (res0, leaves, slots0), (res1, _, slots1) = outs
    assert res0["committed"] and res1["committed"]
    assert res0["manifest"]["world"] == 2 and res1["manifest"] is None
    saved = tree_unflatten(params, leaves)
    full = [{k: np.concatenate([slots0[b][k].numpy(), slots1[b][k].numpy()])
             for k in slots0[b]} for b in range(len(slots0))]
    for new_world in (1, 3, 4):
        for new_rank in range(new_world):
            loader = _DuckZero(params, new_world, new_rank)
            restored, meta = JC.restore_sharded(params, loader, root=root,
                                                world=new_world, rank=new_rank)
            _assert_same_bits(restored, saved, (new_world, new_rank))
            assert meta["world_saved"] == 2 and meta["resharded"]
            assert loader.loaded["step"] == 1
            for b in range(len(full)):
                lo, hi = loader._shard_map[b]["bounds"][new_rank]
                for slot in ("m", "v"):
                    got = np.asarray(loader.loaded["buckets"][b][slot])
                    assert got.tobytes() == full[b][slot][lo:hi].tobytes()


def test_shard_files_and_manifest_equal_ray_tpus(tmp_path):
    """The same params and slots saved at world 2 by both packages: equal
    manifests but for the digests and sizes (zip timestamps differ), and
    equal npz members, in order, with equal dtypes, shapes and values."""
    params = _tree(13)
    roots = {}
    for name, sc, tree in (("jax", JC, params), ("port", TC, _torch(params))):
        roots[name] = str(tmp_path / name)
        _save_groupless(sc, tree, 2, roots[name], 4,
                        [_DuckZero(params, 2, r) for r in range(2)])
    gens = {k: JC.generation_dir(v, 4) for k, v in roots.items()}
    assert (sorted(os.listdir(gens["jax"])) == sorted(os.listdir(gens["port"]))
            == ["MANIFEST.json", "shard_00000_of_00002.npz",
                "shard_00001_of_00002.npz"])
    manifests = {}
    for k, gen in gens.items():
        with open(os.path.join(gen, JC.MANIFEST)) as f:
            manifests[k] = json.load(f)
        for spec in manifests[k]["shards"].values():
            assert len(spec.pop("sha256")) == 64 and spec.pop("bytes") > 0
    assert manifests["jax"] == manifests["port"]
    assert list(manifests["port"]) == list(manifests["jax"])
    for shard in ("shard_00000_of_00002.npz", "shard_00001_of_00002.npz"):
        with np.load(os.path.join(gens["jax"], shard)) as zj, \
                np.load(os.path.join(gens["port"], shard)) as zt:
            assert zt.files == zj.files
            assert "param_0" in zt.files and "opt_0_v" in zt.files
            for member in zj.files:
                a, b = zj[member], zt[member]
                assert (a.dtype, a.shape) == (b.dtype, b.shape), member
                assert a.tobytes() == b.tobytes(), member
            assert zt["param_0"].dtype == np.float32
            meta = json.loads(bytes(zt["meta"]).decode())
            assert meta == json.loads(bytes(zj["meta"]).decode())


# --------------------------------------------- resume, async, quarantine


def test_save_restore_and_a_step_equal_the_uninterrupted_step(tmp_path):
    """GPT-2's ZeRO train step at world 2 (rank threads): save after step
    1, restore into a fresh optimizer and params, and take step 2; its
    params are the uninterrupted run's, bit for bit, on both ranks."""
    root = str(tmp_path)
    rng = np.random.default_rng(17)
    tokens = torch.from_numpy(rng.integers(0, CFG.vocab_size, (4, 17)))

    def init(g):
        return TG.init(g, CFG, device="cpu")

    def loss(p, b):
        return TG.loss_fn(p, b, CFG)

    def rank(r, group):
        batch = {"tokens": tokens[2 * r:2 * r + 2]}

        def fresh():
            zopt = TD.ZeroOptimizer(TD.zero_adam(1e-2), group,
                                    bucket_bytes=BB, average=True)
            return zopt, TT.make_train_step(loss, None, host_optimizer=zopt)

        zopt, step = fresh()
        state = TT.make_zero_train_state(init, torch.Generator().manual_seed(0),
                                         device="cpu")
        state, _ = step(state, batch)
        state = step.finalize(state)
        res = TC.save_sharded(state.params, zopt, root=root,
                              asynchronous=False).result()
        assert res["committed"]
        state, _ = step(state, batch)
        straight = step.finalize(state).params

        zopt2, step2 = fresh()
        template = TT.make_zero_train_state(
            init, torch.Generator().manual_seed(99), device="cpu")
        params, meta = TC.restore_sharded(template.params, zopt2, root=root)
        assert meta["step"] == 1 and not meta["resharded"]
        resumed = dataclasses.replace(
            template, step=1,
            params=tree_map(lambda p: p.requires_grad_(True), params))
        resumed, _ = step2(resumed, batch)
        resumed = step2.finalize(resumed).params
        assert zopt2.step_count == 2
        return straight, resumed

    for straight, resumed in run_gang(2, rank, name="ck_resume"):
        _assert_same_bits(tree_map(lambda t: t.detach(), resumed),
                          tree_map(lambda t: t.detach(), straight))


def test_async_save_keeps_the_state_at_call_time(tmp_path):
    root = str(tmp_path)
    params = _tree(19)
    live = _torch(params)
    pending = TC.save_sharded(live, root=root, step=3, bucket_bytes=BB,
                              asynchronous=True, extra={"lr": 0.5})
    for leaf in tree_leaves(live):  # the caller moves on before the write
        leaf.mul_(-2.0)
    res = pending.result(timeout=60)
    assert res["committed"] and pending.done_writing()
    assert pending.snapshot_s > 0 and pending.write_s > 0 and pending.nbytes > 0
    restored, meta = TC.restore_sharded(_torch(params), root=root,
                                        bucket_bytes=BB)
    _assert_same_bits(restored, params)
    assert meta == {"step": 3, "path": res["path"], "world_saved": 1,
                    "resharded": False, "extra": {"lr": 0.5}}
    # and ray_tpu reads it too
    restored_j, meta_j = JC.restore_sharded(params, root=root, bucket_bytes=BB)
    _assert_same_bits(restored_j, params)
    assert meta_j == meta


def _flip_byte(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def _wreck(root, params):
    """Generations 1 and 2 good; 3 torn (no manifest); 4 a flipped byte;
    5 a shard missing; 6 a shard grown by a byte; all at world 2."""
    for step in range(1, 7):
        _save_groupless(JC, params, 2, root, step)
    gen = {s: JC.generation_dir(root, s) for s in range(3, 7)}
    os.remove(os.path.join(gen[3], JC.MANIFEST))
    _flip_byte(os.path.join(gen[4], JC.shard_filename(1, 2)))
    os.remove(os.path.join(gen[5], JC.shard_filename(0, 2)))
    with open(os.path.join(gen[6], JC.shard_filename(1, 2)), "ab") as f:
        f.write(b"\0")


def test_torn_and_corrupt_generations_same_verdicts_quarantine_fallback(
        tmp_path):
    params = _tree(23)
    roots = {k: str(tmp_path / k) for k in ("jax", "port")}
    _wreck(roots["jax"], params)
    shutil.copytree(roots["jax"], roots["port"])
    fingerprint = JS.plan_fingerprint(_np_leaves(params),
                                      JS.plan_buckets(_np_leaves(params), BB))
    verdicts = {}
    for k, sc in (("jax", JC), ("port", TC)):
        verdicts[k] = [sc.verify_generation(sc.generation_dir(roots[k], s),
                                            fp)
                       for s in range(1, 7) for fp in (None, fingerprint, "x")]
    assert verdicts["jax"] == verdicts["port"]
    reasons = [v["reason"] for v in verdicts["port"][1::3]]
    assert reasons == [None, None, "torn", "digest_mismatch",
                       "shard_missing", "size_mismatch"]
    assert {v["reason"] for v in verdicts["port"][2::3]} >= {"plan_mismatch"}
    summaries = {k: [(e["step"], e["status"], e["reason"], e["shard"])
                     for e in sc.summarize_checkpoints(roots[k])]
                 for k, sc in (("jax", JC), ("port", TC))}
    assert summaries["jax"] == summaries["port"]

    for k, sc, tree in (("jax", JC, params), ("port", TC, _torch(params))):
        restored, meta = sc.restore_sharded(tree, root=roots[k],
                                            bucket_bytes=BB)
        _assert_same_bits(restored, params)
        assert meta["step"] == 2
    assert sorted(os.listdir(roots["jax"])) == sorted(os.listdir(roots["port"]))
    assert sorted(os.listdir(roots["port"])) == [
        "gen_00000001", "gen_00000002", "gen_00000003.quarantined",
        "gen_00000004.quarantined", "gen_00000005.quarantined",
        "gen_00000006.quarantined"]


def test_prune_keeps_what_ray_tpus_keeps(tmp_path):
    """On two copies of one tree of committed, torn and quarantined
    generations, both packages' prune removes the same ones, and never
    the newest generation that verifies complete."""
    params = _tree(29)
    roots = {k: str(tmp_path / k) for k in ("jax", "port")}
    _wreck(roots["jax"], params)
    _save_groupless(JC, params, 2, roots["jax"], 8)
    os.rename(JC.generation_dir(roots["jax"], 4),
              JC.generation_dir(roots["jax"], 4) + JC.QUARANTINE_SUFFIX)
    os.makedirs(JC.generation_dir(roots["jax"], 9))  # a save in flight
    shutil.copytree(roots["jax"], roots["port"])
    for keep in (3, 1):
        removed = {k: sorted(os.path.basename(p)
                             for p in sc.prune_generations(roots[k], keep))
                   for k, sc in (("jax", JC), ("port", TC))}
        assert removed["jax"] == removed["port"]
        assert (sorted(os.listdir(roots["jax"]))
                == sorted(os.listdir(roots["port"])))
    kept = sorted(os.listdir(roots["port"]))
    assert "gen_00000008" in kept and "gen_00000009" in kept
