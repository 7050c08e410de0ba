"""The port's data-parallel step (ray_tpu_torch.train.ddp and the host
regimes of parallel.train_step) on gangs of rank threads
(tests/torch_gang.py), against numpy oracles and the JAX package's pure
functions: its shard optimizers and its plain train step. No ray_tpu
runtime is started."""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as JG
from ray_tpu.parallel import sharding as JS
from ray_tpu.parallel import train_step as JT
from ray_tpu.train import ddp as JD
from ray_tpu_torch._private.tree import tree_leaves, tree_map, tree_unflatten
from ray_tpu_torch.convert import params_from_jax, params_to_numpy
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.parallel import sharding as TS
from ray_tpu_torch.parallel import train_step as TT
from ray_tpu_torch.train import ddp as TD
from tests.torch_gang import run_gang

SHAPES = {"w1": (96, 64), "b1": (64,), "w2": (64, 11), "b2": (11,),
          "emb": (3, 7, 5)}
BUCKET = 8192  # bytes: several buckets, one leaf (w1) larger than one


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in sorted(SHAPES.items())}


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _bytes(tree):
    return {k: np.ascontiguousarray(np.asarray(v)).tobytes()
            for k, v in tree.items()}


def _sync(rank, group, grads, **kw):
    return {k: v.numpy().copy() for k, v in TD.sync_gradients(
        _torch(grads[rank]), group, bucket_bytes=BUCKET, **kw).items()}


# ---------------------------------------------------------- bucketed DDP
@pytest.mark.parametrize("average", [False, True])
def test_world2_bucketed_equals_whole_tree_and_pairwise_sum(monkeypatch,
                                                            average):
    grads = [_grads(10 + r) for r in range(2)]
    on = run_gang(2, lambda r, g: _sync(r, g, grads, average=average))
    monkeypatch.setenv("RAY_TPU_TORCH_TRAIN_BUCKET_DDP", "0")
    off = run_gang(2, lambda r, g: _sync(r, g, grads, average=average))
    expect = {k: grads[0][k] + grads[1][k] for k in SHAPES}
    if average:
        expect = {k: v / 2 for k, v in expect.items()}
    for out in on + off:
        assert _bytes(out) == _bytes(expect)


def test_world2_async_sync_counts_buckets_and_overlaps():
    grads = [_grads(20 + r) for r in range(2)]
    leaves, _ = TS.flatten_tree(_torch(grads[0]))
    n_buckets = len(TS.plan_buckets(leaves, BUCKET))
    assert n_buckets >= 3

    def rank(r, group):
        pending = TD.sync_gradients_async(_torch(grads[r]), group,
                                          bucket_bytes=BUCKET)
        assert pending.num_buckets == n_buckets
        out = pending.result(timeout=20)
        assert pending.poll() and pending.wait_s >= 0.0
        assert pending.result() is out  # harvested once
        return {k: v.numpy() for k, v in out.items()}

    a, b = run_gang(2, rank)
    assert _bytes(a) == _bytes(b) == _bytes(
        {k: grads[0][k] + grads[1][k] for k in SHAPES})


def test_world4_ranks_agree_and_sum_within_reassociation(monkeypatch):
    """Ranks are bit-identical to each other; against the f64 sum, each
    element is within 3 f32 roundings of its partial sums:
    |err| <= 3 * 2^-24 * sum_r |g_r|."""
    grads = [_grads(30 + r) for r in range(4)]
    on = run_gang(4, lambda r, g: _sync(r, g, grads))
    monkeypatch.setenv("RAY_TPU_TORCH_TRAIN_BUCKET_DDP", "0")
    off = run_gang(4, lambda r, g: _sync(r, g, grads))
    for outs in (on, off):
        assert all(_bytes(o) == _bytes(outs[0]) for o in outs)
    for k in SHAPES:
        exact = sum(g[k].astype(np.float64) for g in grads)
        bound = 3 * 2.0 ** -24 * sum(np.abs(g[k]) for g in grads)
        for outs in (on, off):
            assert (np.abs(outs[0][k] - exact) <= bound).all(), k


@pytest.mark.parametrize("case", ["bad_mode", "allreduce_wire", "shard_wire",
                                  "zero_wire", "default", "spelling"])
def test_mode_validation_raises_before_group_state(case):
    """The twin of test_zz_zero_ddp.py::test_mode_validation_raises_before_group_state:
    misuse fails at the call site; no group exists, none is touched."""
    g = {"g": torch.zeros(4)}
    if case == "bad_mode":
        with pytest.raises(ValueError, match="expected 'allreduce'"):
            TD.sync_gradients_async(g, "no_such_group", mode="zero3")
    elif case == "allreduce_wire":
        with pytest.raises(ValueError, match="reducescatter"):
            TD.sync_gradients_async(g, "no_such_group", mode="allreduce",
                                    wire_dtype="int8")
    elif case == "shard_wire":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TD.sync_gradients_async(g, "no_such_group",
                                    mode="reducescatter", wire_dtype="int8")
    elif case == "zero_wire":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TD.ZeroOptimizer(TD.zero_adam(0.1), "no_such_group",
                             wire_dtype="bf16")
    elif case == "default":
        # the twin's default comes from its knob, whose default this is
        default = inspect.signature(TD.sync_gradients_async).parameters["mode"]
        assert (TD._resolve_mode(default.default) == "allreduce"
                == JD._resolve_mode(None))
    else:
        assert (TD._resolve_mode(" ReduceScatter ") == "reducescatter"
                == JD._resolve_mode(" ReduceScatter "))


# ------------------------------------------------------ shard optimizers
@pytest.mark.parametrize("make", [
    lambda m: m.zero_sgd(0.1), lambda m: m.zero_sgd(0.05, momentum=0.9),
    lambda m: m.zero_adam(0.01), lambda m: m.zero_adam(3e-4, 0.8, 0.95, 1e-6),
], ids=["sgd", "momentum", "adam", "adam_custom"])
def test_shard_optimizer_bitwise_against_jax_twin(make):
    """_SgdShard / _AdamShard against ray_tpu.train.ddp's on the same
    numpy arrays over 6 steps, with values spread over 12 decades: every
    parameter and state element bit-identical."""
    rng = np.random.default_rng(7)
    n = 10007
    scale = rng.choice([1e-3, 1.0, 1e3], n).astype(np.float32)
    p0 = rng.standard_normal(n).astype(np.float32) * scale
    jopt, topt = make(JD), make(TD)
    assert topt.slots == jopt.slots and topt.name == jopt.name
    jp, tp = p0.copy(), torch.from_numpy(p0.copy())
    jst, tst = jopt.init(n, np.float32), topt.init(n, torch.float32)
    assert sorted(jst) == sorted(tst)
    for step in range(1, 7):
        g = (rng.standard_normal(n) * rng.choice([1e-6, 1e-2, 1.0, 1e2], n)
             ).astype(np.float32)
        jp = jopt.apply(jp, g, jst, step)
        tp = topt.apply(tp, torch.from_numpy(g.copy()), tst, step)
        assert tp.numpy().tobytes() == jp.tobytes(), step
        for k in jst:
            assert tst[k].numpy().tobytes() == jst[k].tobytes(), (step, k)


# ------------------------------------------------------------------ ZeRO
def _init_params():
    rng = np.random.default_rng(42)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in sorted(SHAPES.items())}


def _legacy_oracle(steps, world=2):
    """ray_tpu's legacy path in numpy: the world-2 pairwise sum of each
    rank's grads, then its _AdamShard applied over the full packed
    buckets of its own plan."""
    params = _init_params()
    leaves, treedef = JS.flatten_tree(params)
    plan = JS.plan_buckets(leaves, BUCKET)
    opt = JD.zero_adam(0.01)
    state = [opt.init(sum(leaves[i].size for i in b), np.float32)
             for b in plan]
    for step in range(steps):
        gs = [_grads(100 * step + r) for r in range(world)]
        synced = {k: gs[0][k] + gs[1][k] for k in SHAPES}
        gleaves, _ = JS.flatten_tree(synced)
        pleaves, _ = JS.flatten_tree(params)
        out = [None] * len(pleaves)
        for b, indices in enumerate(plan):
            pflat = opt.apply(JS.pack_bucket(pleaves, indices),
                              JS.pack_bucket(gleaves, indices), state[b],
                              step + 1)
            JS.unpack_bucket(pflat, pleaves, indices, out)
        params = JS.unflatten_tree(treedef, out)
    return params


def _zero_rank(rank, group, steps=3):
    zopt = TD.ZeroOptimizer(TD.zero_adam(0.01), group, bucket_bytes=BUCKET)
    params = _torch(_init_params())
    for step in range(steps):
        params = zopt.step(params, _torch(_grads(100 * step + rank)),
                           timeout=20)
    return {"params": {k: v.numpy().copy() for k, v in params.items()},
            "state_bytes": zopt.state_bytes(),
            "replicated": zopt.replicated_state_bytes(),
            "n_buckets": len(zopt.shard_map),
            "step": zopt.step_count, "fp": zopt.plan_fingerprint}


def test_zero_matches_legacy_bitwise_world2():
    """The twin of test_zz_zero_ddp.py::test_zero_matches_legacy_bitwise_world2:
    reducescatter + shard apply + allgather ends byte-identical to
    ray_tpu's allreduce + full apply, on both ranks; the shard states fold
    the replicated state over the world."""
    got = run_gang(2, _zero_rank)
    legacy = _bytes(_legacy_oracle(3))
    for g in got:
        assert _bytes(g["params"]) == legacy
        assert g["step"] == 3
        # 2 x shard is the replicated state to within one element per
        # bucket per slot (divmod rounding; adam has 2 f32 slots)
        assert abs(2 * g["state_bytes"] - g["replicated"]) <= \
            g["n_buckets"] * 4 * 2
        assert g["state_bytes"] < g["replicated"]
    assert got[0]["state_bytes"] + got[1]["state_bytes"] == got[0]["replicated"]
    leaves, _ = JS.flatten_tree(_init_params())
    assert got[0]["fp"] == got[1]["fp"] == JS.plan_fingerprint(
        leaves, JS.plan_buckets(leaves, BUCKET))


def test_zero_world4_uneven_shards(monkeypatch):
    """World 4, with buckets of 91 and 14 elements, so shards differ in
    length (23/23/23/22 and 4/4/3/3) and the gathers are padded and
    trimmed: the ranks end bit-identical, each element within float
    reassociation of p - lr * sum_r g_r (kill switch on and off). The
    sum's three adds round with at most 3 * 2^-24 * sum_r |g_r|; the
    product by lr and the subtraction add 2^-24 of their sizes each."""
    shapes = {"a": (7, 13), "b": (5,), "c": (3, 3)}
    rng = np.random.default_rng(4)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in sorted(shapes.items())}
    gs = [{k: rng.standard_normal(s).astype(np.float32)
           for k, s in sorted(shapes.items())} for _ in range(4)]
    lr = 0.5

    def rank(r, group):
        zopt = TD.ZeroOptimizer(TD.zero_sgd(lr), group, bucket_bytes=64)
        out = zopt.step(_torch(p0), _torch(gs[r]), timeout=20)
        assert [e["elems"] for e in zopt.shard_map] == [91, 14]
        return {k: v.numpy().copy() for k, v in out.items()}

    on = run_gang(4, rank)
    monkeypatch.setenv("RAY_TPU_TORCH_TRAIN_BUCKET_DDP", "0")
    off = run_gang(4, rank)
    for outs in (on, off):
        assert all(_bytes(o) == _bytes(outs[0]) for o in outs)
        for k in shapes:
            gsum = sum(g[k].astype(np.float64) for g in gs)
            exact = p0[k] - lr * gsum
            bound = (lr * 3 * 2.0 ** -24 * sum(np.abs(g[k]) for g in gs)
                     + 2.0 ** -24 * (np.abs(lr * gsum) + np.abs(exact)) * 2)
            assert (np.abs(outs[0][k] - exact) <= bound).all(), k


def test_kill_switch_keeps_shard_map(monkeypatch):
    """The twin of test_zz_zero_ddp.py::test_kill_switch_keeps_shard_map:
    the sharded mode gives the same shards, bit for bit, with the kill
    switch on; each is its slice of the pairwise sum."""
    xs = [np.random.default_rng(900 + r).standard_normal(9000)
          .astype(np.float32) for r in range(2)]

    def shards(r, group):
        out = TD.sync_gradients({"g": torch.from_numpy(xs[r].copy())}, group,
                                mode="reducescatter", bucket_bytes=16384)
        return [s.numpy().tobytes() for s in out]

    on = run_gang(2, shards)
    monkeypatch.setenv("RAY_TPU_TORCH_TRAIN_BUCKET_DDP", "0")
    off = run_gang(2, shards)
    assert on == off
    total = xs[0] + xs[1]
    plan = TS.plan_buckets([torch.from_numpy(xs[0])], 16384)
    assert len(plan) == 1 and len(on[0]) == 1
    for r, (lo, hi) in enumerate(TS.shard_bounds(9000, 2)):
        assert on[r][0] == total[lo:hi].tobytes()


def test_state_budget_raises():
    def rank(r, group):
        zopt = TD.ZeroOptimizer(TD.zero_adam(0.01), group,
                                bucket_bytes=BUCKET, state_budget_bytes=1024)
        with pytest.raises(RuntimeError, match="exceeds the per-rank budget"):
            zopt.step(_torch(_init_params()), _torch(_grads(r)), timeout=20)
        return True

    assert run_gang(2, rank) == [True, True]


def test_shard_state_dict_roundtrip():
    """A fresh optimizer loaded with a rank's shard state continues the run
    bit for bit; a shard state of another plan is refused."""
    def rank(r, group):
        params = _torch(_init_params())
        a = TD.ZeroOptimizer(TD.zero_adam(0.01), group, bucket_bytes=BUCKET)
        params = a.step(params, _torch(_grads(r)), timeout=20)
        saved = a.shard_state_dict()
        assert saved["step"] == 1 and saved["rank"] == r
        assert saved["world"] == 2
        assert saved["plan_fingerprint"] == a.plan_fingerprint
        b = TD.ZeroOptimizer(TD.zero_adam(0.01), group, bucket_bytes=BUCKET)
        b.load_shard_state_dict(saved)  # parks until b has a plan
        grads = _torch(_grads(10 + r))
        pa = a.step(params, grads, timeout=20)
        pb = b.step(params, grads, timeout=20)
        assert b.step_count == a.step_count == 2
        other = TD.ZeroOptimizer(TD.zero_adam(0.01), group,
                                 bucket_bytes=256)  # another plan
        other.load_shard_state_dict(saved)
        with pytest.raises(ValueError, match="fingerprint"):
            other.step(params, grads, timeout=20)
        return _bytes(pa), _bytes(pb)

    for pa, pb in run_gang(2, rank):
        assert pa == pb


# ------------------------------------------- the host regimes on GPT-2
B, S = 4, 32  # the global batch; each of the two ranks takes B // 2


def _gpt2_cfgs():
    common = dict(vocab_size=128, max_seq=S, n_layer=2, n_head=4, d_model=64,
                  remat=False)
    return (JG.GPT2Config(dtype=jnp.float32, **common),
            TG.GPT2Config(dtype=torch.float32, **common))


@pytest.fixture(scope="module")
def gpt2_setup():
    jcfg, tcfg = _gpt2_cfgs()
    params = jax.tree.map(np.asarray, JG.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 128, (B, S + 1)).astype(np.int32)
               for _ in range(3)]
    return jcfg, tcfg, params, batches


def test_host_grad_sync_step_matches_jax_plain_step(gpt2_setup):
    """Three steps of the world-2 host_grad_sync regime (averaged bucketed
    sync, 4 KiB buckets) on the two halves of each batch, against
    ray_tpu's plain make_train_step on the whole batch, f32. The mean of
    the ranks' losses is the whole batch's loss (rtol 1e-6; equal halves),
    grad_norm is the synced grads' (rtol 1e-5, other sum orders), and the
    params agree as in test_torch_gpt2's trajectory test (Adam moves each
    weight by ~lr whatever the gradient's scale)."""
    jcfg, tcfg, params, batches = gpt2_setup
    jopt = JT.default_optimizer(1e-3, warmup_steps=1, total_steps=10)
    jstate = JT.TrainState(step=jnp.zeros((), jnp.int32),
                           params=jax.tree.map(jnp.asarray, params),
                           opt_state=jopt.init(params))
    jstep = JT.make_train_step(lambda p, b: JG.loss_fn(p, b, jcfg), jopt,
                               donate=False)
    jmetrics = []
    for tok in batches:
        jstate, m = jstep(jstate, {"tokens": jnp.asarray(tok)})
        jmetrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})

    def rank(r, group):
        topt = TT.default_optimizer(1e-3, warmup_steps=1, total_steps=10)
        state = TT.make_train_state(lambda g: params_from_jax(params, "cpu"),
                                    torch.Generator(), topt, device="cpu")
        sync = lambda grads: TD.sync_gradients(grads, group, average=True,
                                               bucket_bytes=4096)
        step = TT.make_train_step(lambda p, b: TG.loss_fn(p, b, tcfg), topt,
                                  host_grad_sync=sync)
        out = []
        for tok in batches:
            half = tok[r * B // 2:(r + 1) * B // 2]
            state, m = step(state, {"tokens": torch.from_numpy(half)})
            out.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        assert state.step == 3
        return out, params_to_numpy(state.params)

    (m0, p0), (m1, p1) = run_gang(2, rank)
    for a, b in zip(tree_leaves(p0), tree_leaves(p1)):
        assert a.tobytes() == b.tobytes()
    for i, jm in enumerate(jmetrics):
        assert m0[i]["grad_norm"] == m1[i]["grad_norm"]
        np.testing.assert_allclose((m0[i]["loss"] + m1[i]["loss"]) / 2,
                                   jm["loss"], rtol=1e-6, err_msg=f"step {i}")
        np.testing.assert_allclose(m0[i]["grad_norm"], jm["grad_norm"],
                                   rtol=1e-5, err_msg=f"step {i}")
    for a, b in zip(tree_leaves(p0), jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=1e-5)


def test_host_optimizer_step_matches_legacy_bitwise(gpt2_setup):
    """Three steps of the ZeRO regime (zero_adam, averaged) at world 2
    against the port's legacy path on the same rank threads: an averaged
    allreduce of each rank's grads, then _AdamShard over the full packed
    buckets. finalize folds the last step's gathers into the state."""
    _, tcfg, params, batches = gpt2_setup

    def loss(p, b):
        return TG.loss_fn(p, b, tcfg)

    def rank(r, group):
        halves = [{"tokens": torch.from_numpy(t[r * B // 2:(r + 1) * B // 2])}
                  for t in batches]
        zopt = TD.ZeroOptimizer(TD.zero_adam(1e-3), group, bucket_bytes=4096,
                                average=True)
        state = TT.make_zero_train_state(
            lambda g: params_from_jax(params, "cpu"), torch.Generator(),
            device="cpu")
        assert state.opt_state == ()
        step = TT.make_train_step(loss, None, host_optimizer=zopt)
        for half in halves:
            state, m = step(state, half)
            assert torch.isfinite(m["grad_norm"])
        before = params_to_numpy(state.params)
        state = step.finalize(state)
        assert step.finalize(state) is state  # nothing left in flight
        zero = params_to_numpy(state.params)
        assert any(a.tobytes() != b.tobytes() for a, b in
                   zip(tree_leaves(before), tree_leaves(zero)))

        # the legacy path, on this rank's own group, from the same weights
        lp = params_from_jax(params, "cpu")
        leaves, treedef = TS.flatten_tree(lp)
        plan = TS.plan_buckets(leaves, 4096)
        opt = TD.zero_adam(1e-3)
        st = [opt.init(sum(leaves[i].numel() for i in b), torch.float32)
              for b in plan]
        for i, half in enumerate(halves):
            ps = tree_map(lambda p: p.requires_grad_(True), lp)
            grads = tree_unflatten(ps, torch.autograd.grad(
                loss(ps, half)[0], tree_leaves(ps)))
            synced = TD.sync_gradients(grads, group, average=True,
                                       bucket_bytes=4096)
            pleaves, _ = TS.flatten_tree(ps)
            gleaves, _ = TS.flatten_tree(synced)
            out = [None] * len(pleaves)
            for b, indices in enumerate(plan):
                pflat = opt.apply(TS.pack_bucket(pleaves, indices),
                                  TS.pack_bucket(gleaves, indices), st[b],
                                  i + 1)
                TS.unpack_bucket(pflat, pleaves, indices, out)
            lp = TS.unflatten_tree(treedef, [t.clone() for t in out])
        return zero, params_to_numpy(lp)

    (z0, l0), (z1, l1) = run_gang(2, rank)
    for z, l, z_other in zip(tree_leaves(z0), tree_leaves(l0), tree_leaves(z1)):
        assert z.tobytes() == l.tobytes() == z_other.tobytes()
    for l, l_other in zip(tree_leaves(l0), tree_leaves(l1)):
        assert l.tobytes() == l_other.tobytes()


def test_host_hooks_are_mutually_exclusive():
    _, tcfg = _gpt2_cfgs()
    with pytest.raises(ValueError, match="mutually exclusive"):
        TT.make_train_step(lambda p, b: TG.loss_fn(p, b, tcfg),
                           TT.default_optimizer(),
                           host_grad_sync=lambda g: g,
                           host_optimizer=TD.ZeroOptimizer(TD.zero_sgd(0.1)))
