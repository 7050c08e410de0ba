"""The data-parallel gang on the device collective backend against the
same gang on gloo: bucketed DDP and its kill switch, ZeRO, the sharded
checkpoints' save and restore, and the Train backend's bring-up with
collective_backend="device" (and "nccl", which needs CUDA). At world 2
every element is one two-operand operation, so the device gang is gloo's
bit for bit; at world 4 it agrees within float reassociation, and its
bucketed sync is its kill switch's bit for bit (every element is summed
in rank order either way). The ranks are threads of this process
(tests/torch_gang.py); every wait has a timeout."""
import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.parallel import train_step as TT
from ray_tpu_torch.train import backend_executor as TB
from ray_tpu_torch.train import ddp as TD
from ray_tpu_torch.train import sharded_checkpoint as TC
from ray_tpu_torch.util import collective as col
from tests.test_torch_train_backend import ThreadWorkerGroup
from tests.torch_gang import run_gang

SHAPES = {"w1": (96, 64), "b1": (64,), "w2": (64, 11), "b2": (11,),
          "emb": (3, 7, 5)}
BUCKET = 8192  # bytes: several buckets, one leaf (w1) larger than one


def _tree(seed, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in sorted(shapes.items())}


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _bits(tree):
    return {k: v.detach().contiguous().numpy().tobytes()
            for k, v in tree.items()}


def _ddp(world, backend, average, monkeypatch, kill_switch):
    grads = [_tree(10 + r) for r in range(world)]
    monkeypatch.setenv("RAY_TPU_TORCH_TRAIN_BUCKET_DDP",
                       "0" if kill_switch else "1")
    return run_gang(world, lambda r, g: _bits(TD.sync_gradients(
        _torch(grads[r]), g, bucket_bytes=BUCKET, average=average)),
        backend=backend, name=f"dg_{backend}"), grads


@pytest.mark.parametrize("kill_switch", [False, True])
@pytest.mark.parametrize("average", [False, True])
def test_ddp_world2_device_is_gloo_bit_for_bit(monkeypatch, average,
                                               kill_switch):
    device, _ = _ddp(2, "device", average, monkeypatch, kill_switch)
    gloo, _ = _ddp(2, "gloo", average, monkeypatch, kill_switch)
    assert device == gloo
    assert device[0] == device[1]


def test_ddp_world4_within_reassociation_and_kill_switch_bitwise(
        monkeypatch):
    on, grads = _ddp(4, "device", False, monkeypatch, False)
    off, _ = _ddp(4, "device", False, monkeypatch, True)
    assert on == off == [on[0]] * 4
    for k, s in SHAPES.items():
        got = np.frombuffer(on[0][k], np.float32).reshape(s)
        exact = sum(g[k].astype(np.float64) for g in grads)
        bound = 3 * 2.0 ** -24 * sum(np.abs(g[k]) for g in grads)
        assert (np.abs(got - exact) <= bound).all(), k


def _zero(world, backend, make_opt, shapes, steps, bucket_bytes):
    p0 = _tree(1, shapes)
    gs = [[_tree(100 + 10 * s + r, shapes) for r in range(world)]
          for s in range(steps)]

    def rank(r, group):
        zopt = TD.ZeroOptimizer(make_opt(), group, bucket_bytes=bucket_bytes,
                                average=True)
        p = _torch(p0)
        for s in range(steps):
            p = zopt.step(p, _torch(gs[s][r]), timeout=20)
        state = zopt.shard_state_dict()
        return _bits(p), [{k: v.numpy().tobytes() for k, v in st.items()}
                          for st in state["buckets"]]

    return run_gang(world, rank, backend=backend, name=f"dz_{backend}")


def test_zero_world2_device_is_gloo_bit_for_bit():
    """Three ZeroOptimizer(zero_adam) steps: params and every rank's
    shard state are the same bits on both backends."""
    args = (lambda: TD.zero_adam(1e-2), SHAPES, 3, BUCKET)
    assert _zero(2, "device", *args) == _zero(2, "gloo", *args)


@pytest.mark.parametrize("kill_switch", [False, True])
def test_zero_world4_uneven_shards_agree_with_gloo(monkeypatch, kill_switch):
    """World 4 with shards of unequal lengths (buckets of 91 and 14
    elements): the device gang's ranks end with one set of params, each
    element within float reassociation of gloo's, which sums in another
    order."""
    monkeypatch.setenv("RAY_TPU_TORCH_TRAIN_BUCKET_DDP",
                       "0" if kill_switch else "1")
    shapes = {"a": (7, 13), "b": (5,), "c": (3, 3)}
    args = (lambda: TD.zero_sgd(0.5), shapes, 1, 64)
    device = _zero(4, "device", *args)
    gloo = _zero(4, "gloo", *args)
    assert all(d[0] == device[0][0] for d in device)
    grads = [_tree(100 + r, shapes) for r in range(4)]
    for k, s in shapes.items():
        a = np.frombuffer(device[0][0][k], np.float32)
        b = np.frombuffer(gloo[0][0][k], np.float32)
        # both within 3 roundings of the sum (times lr, averaged), apart
        # by at most twice that, plus the update's own roundings
        gsum = sum(np.abs(g[k]).reshape(-1) for g in grads)
        bound = 2 * 0.5 / 4 * 3 * 2.0 ** -24 * gsum + 2.0 ** -22 * np.abs(b)
        assert (np.abs(a - b) <= bound).all(), k


CFG = TG.GPT2Config(vocab_size=64, max_seq=16, n_layer=2, n_head=2,
                    d_model=32, remat=False, dtype=torch.float32)


def test_sharded_checkpoint_saves_and_restores_over_a_device_group(tmp_path):
    """GPT-2's ZeRO step at world 2 on a device group: save after step 1
    (the commit's allgather_object on the device group), restore into a
    fresh optimizer and params, take step 2: the uninterrupted run's
    params, bit for bit, on both ranks."""
    root = str(tmp_path)
    tokens = torch.from_numpy(
        np.random.default_rng(17).integers(0, CFG.vocab_size, (4, 17)))

    def init(g):
        return TG.init(g, CFG, device="cpu")

    def rank(r, group):
        batch = {"tokens": tokens[2 * r:2 * r + 2]}

        def fresh():
            zopt = TD.ZeroOptimizer(TD.zero_adam(1e-2), group,
                                    bucket_bytes=16 << 10, average=True)
            return zopt, TT.make_train_step(lambda p, b: TG.loss_fn(p, b, CFG),
                                            None, host_optimizer=zopt)

        zopt, step = fresh()
        state = TT.make_zero_train_state(
            init, torch.Generator().manual_seed(0), device="cpu")
        state, _ = step(state, batch)
        state = step.finalize(state)
        assert TC.save_sharded(state.params, zopt, root=root,
                               asynchronous=False).result()["committed"]
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
        return (col.get_backend(group),
                [t.detach().numpy().tobytes() for t in tree_leaves(straight)],
                [t.detach().numpy().tobytes()
                 for t in tree_leaves(step2.finalize(resumed).params)])

    for backend, straight, resumed in run_gang(2, rank, backend="device",
                                               name="dg_ckpt"):
        assert backend == "device" and straight == resumed


def test_train_backend_brings_up_a_device_gang(tmp_path):
    """TorchConfig(collective_backend="device", rank_threads=True): every
    rank's group is a device group, and a bucketed sync over it is gloo's
    bit for bit."""
    grads = [_tree(30 + r) for r in range(2)]
    out = {}
    for backend in ("device", "gloo"):
        group = ThreadWorkerGroup(2, f"file://{tmp_path / backend}")
        tb = TB.TorchConfig(group_name=f"tbd_{backend}", timeout_s=20.0,
                            collective_backend=backend,
                            rank_threads=True).backend_cls()
        tb.on_start(group, None)
        try:
            out[backend] = group.execute("run_setup", (
                lambda rank, world: (col.get_backend(tb.group_name_of(rank)),
                                     _bits(TD.sync_gradients(
                                         _torch(grads[rank]),
                                         tb.group_name_of(rank),
                                         bucket_bytes=BUCKET))), (), {}),
                timeout=30)
        finally:
            tb.on_shutdown(group)
    assert [b for b, _ in out["device"]] == ["device"] * 2
    assert [s for _, s in out["device"]] == [s for _, s in out["gloo"]]


def test_train_backend_nccl_is_a_config_that_needs_cuda(tmp_path):
    """collective_backend="nccl" is a working config; without CUDA its
    bring-up raises a clear error and leaves no group behind."""
    cfg = TB.TorchConfig(collective_backend="nccl", group_name="tbn",
                         timeout_s=10.0)
    assert cfg.collective_backend == "nccl"
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    group = ThreadWorkerGroup(1, f"file://{tmp_path / 'nccl'}")
    with pytest.raises(RuntimeError, match="CUDA"):
        cfg.backend_cls().on_start(group, None)
    assert not col.is_group_initialized("tbn")
