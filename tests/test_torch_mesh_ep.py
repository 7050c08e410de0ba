"""The mesh's ep axis in the port (ray_tpu_torch.parallel.mesh's ep groups,
parallel.expert_parallel, models.layers.apply_moe over a layout's dp and
ep groups) against the JAX package: the coordinates against create_mesh's
device order, the ep groups, the MoE layer at dp 2 x ep 4 against
test_parallel.py's test_moe_ep_sharded (output, aux loss and gradients),
a capacity-tight case whose dropped (token, k) pairs must be the JAX
package's exactly, the refusals that stay, and that no collective of a dp 2 x ep 2
train step runs inside autograd's backward. GPT-2-tiny-MoE's loss, aux
loss and grads at dp 2 x ep 2 against JAX's mesh loss_fn are in
test_torch_mesh_ep_jax.py, five train steps in
test_torch_mesh_ep_train.py. The port's ranks are threads of this
process over one HashStore (tests/torch_gang.run_mesh), torch at two
intra-op threads, and every group and join has a timeout; each JAX
oracle is computed once a module."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import layers as JL
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig, create_mesh
from ray_tpu_torch import convert
from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.models import layers as TL
from ray_tpu_torch.parallel import mesh as M
from ray_tpu_torch.parallel import sharding as TS
from ray_tpu_torch.parallel import train_step as TT
from ray_tpu_torch.parallel.mesh import MeshConfig
from ray_tpu_torch.parallel.pipeline import StageTape
from ray_tpu_torch.util import collective as col
from tests.test_torch_gpt2_pipelined import two_threads  # noqa: F401
from tests.torch_gang import run_mesh

# test_moe_ep_sharded's layer: 4 experts, top-2, room for every token
EP_CFG = (4, 2, 8.0)
D, FF = 16, 32
# f32, as test_moe_ep_sharded and tests/test_torch_moe.py hold the layer
OUT_ATOL, AUX_RTOL = 1e-5, 1e-6
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
# the capacity-tight case: half the slots the pairs need
TIGHT_CFG = (4, 2, 0.5)


def _moe_cfgs(n_experts, top_k, cf):
    return (JL.MoEConfig(n_experts=n_experts, top_k=top_k,
                         capacity_factor=cf),
            TL.MoEConfig(n_experts=n_experts, top_k=top_k,
                         capacity_factor=cf))


def _moe_specs():
    return {k: TS.spec(*names) for k, names in TL.MOE_LOGICAL.items()}


def _layout(config, rank):
    """A hand-built layout (no groups): enough for what reads coordinates
    or refuses before any collective."""
    d, p, e, s, t = M.coordinates(config, rank)
    return M.RankLayout(config, rank, d, p, s, "dp", "pp", "sp", t, "tp", e,
                        "ep")


# ------------------------------------------------------------------ layout
@pytest.mark.parametrize("sizes", [dict(dp=2, ep=2, tp=2), dict(pp=2, ep=2),
                                   dict(dp=2, ep=4)])
def test_coordinates_are_the_jax_mesh_positions(sizes):
    """coordinates(config, r) is rank r's device's index on every axis of
    create_mesh's array of the same sizes (AXIS_ORDER dp, pp, ep, sp,
    tp), ep between pp and sp."""
    config = MeshConfig(**sizes)
    devices = np.asarray(create_mesh(
        JMeshConfig(**sizes),
        devices=jax.devices()[:config.world_size]).devices)
    assert devices.shape == tuple(config.axis_sizes().values())
    for r in range(config.world_size):
        assert devices[M.coordinates(config, r)].id == r


@pytest.mark.parametrize("sizes", [dict(dp=2, ep=2), dict(dp=2, ep=4)])
def test_rank_layouts_build_ep_groups(sizes):
    """init_rank_layout gives each rank its ep coordinate and an ep group
    of the ranks on its replica that hold the other experts, and a dp
    group of those that hold the same experts for the other replicas, in
    the JAX mesh's order along each axis."""
    config = MeshConfig(**sizes)
    devices = np.asarray(create_mesh(
        JMeshConfig(**sizes),
        devices=jax.devices()[:config.world_size]).devices)

    def rank(lay):
        out = {"coords": M.coordinates(config, lay.rank),
               "place": (lay.ep_rank, lay.ep)}
        for axis in ("dp", "ep"):
            group = getattr(lay, f"{axis}_group")
            out[axis] = [int(t) for t in col.allgather(
                torch.tensor([lay.rank]), group)]
        return out

    for r, got in enumerate(run_mesh(config, rank)):
        d, p, e, s, t = got["coords"]
        assert got["place"] == (e, config.ep)
        assert got["ep"] == [int(devices[d, p, i, s, t].id)
                             for i in range(config.ep)]
        assert got["dp"] == [int(devices[i, p, e, s, t].id)
                             for i in range(config.dp)]


def test_tree_shard_cuts_the_experts_over_ep():
    """A rank's block of w1 and w2 is its ep_rank-th block of E / ep
    experts, wg whole; tree_unshard puts the experts back in order."""
    rng = np.random.default_rng(0)
    E = 4
    whole = {"wg": torch.from_numpy(rng.standard_normal((D, E))),
             "w1": torch.from_numpy(rng.standard_normal((E, D, FF))),
             "w2": torch.from_numpy(rng.standard_normal((E, FF, D)))}
    specs = _moe_specs()
    assert specs["w1"] == ("ep", None, "tp") and specs["wg"] == (None, None)

    def rank(lay):
        mine = TS.tree_shard(whole, lay, specs)
        back = TS.tree_unshard(mine, lay, specs)
        return lay.ep_rank, mine, back

    for e, mine, back in run_mesh(MeshConfig(dp=2, ep=2), rank):
        assert torch.equal(mine["wg"], whole["wg"])
        for k in ("w1", "w2"):
            assert torch.equal(mine[k], whole[k][2 * e:2 * e + 2])
            assert torch.equal(back[k], whole[k])


# ------------------------------------------------------- the layer at ep
@pytest.fixture(scope="module")
def ep_case():
    """test_moe_ep_sharded's weights and input (jax.random, key 4), and
    the JAX package's apply_moe on them in f32: the output, the aux loss
    and the gradients of sum(out * cos(out)) + 3 aux."""
    jcfg, _ = _moe_cfgs(*EP_CFG)
    k = jax.random.PRNGKey(4)
    p = JL.init_moe(k, D, FF, jcfg)
    x = jax.random.normal(k, (4, 8, D))

    def loss(p, x):
        out, aux = JL.apply_moe(p, x, jcfg, compute_dtype=jnp.float32)
        return jnp.sum(out * jnp.cos(out)) + 3.0 * aux, (out, aux)

    (_, (out, aux)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p, x)
    return (jax.tree.map(np.asarray, p), np.asarray(x), np.asarray(out),
            float(aux), jax.tree.map(np.asarray, grads))


def _layer_on_ranks(params, x, cfg, config):
    """apply_moe on every rank of ``config``, each on its replica's rows
    of x and its block of the experts, on a StageTape, then the gradient
    of the rank's part of sum(out * cos(out)) + 3 aux (dp times its own
    rows' sum, plus its aux share, so that the mean over dp is the whole
    objective), averaged over dp and put back together over ep. Returns
    per rank: (layout, out, aux, grads of wg/w1/w2, grad of its rows of
    x)."""
    specs = _moe_specs()
    whole = convert.params_from_jax(params, "cpu")

    def rank(lay):
        rows = x.shape[0] // lay.dp
        xs = torch.tensor(x[lay.dp_rank * rows:(lay.dp_rank + 1) * rows],
                          requires_grad=True)
        mine = tree_map(lambda t: t.requires_grad_(True),
                        TS.tree_shard(whole, lay, specs))
        tape = StageTape()
        out, aux = TL.apply_moe(mine, xs, cfg, torch.float32,
                                dp_group=lay.dp_group, ep_group=lay.ep_group,
                                tape=tape)
        objective = lay.dp * torch.sum(out * torch.cos(out)) + 3.0 * aux
        names = sorted(mine)
        (gx,), gp = tape.backward(objective, torch.ones(()), [xs],
                                  [mine[n] for n in names])
        gp = {n: col.allreduce(g, lay.dp_group) / lay.dp
              for n, g in zip(names, gp)}
        gp = TS.tree_unshard(gp, lay, specs)
        return (lay, out.detach().numpy(), float(aux.detach()), gp,
                gx.numpy())

    return run_mesh(config, rank)


def test_apply_moe_at_dp2_ep4_matches_jax(ep_case):
    """The twin of test_moe_ep_sharded: at dp 2 x ep 4 (one expert a rank)
    every rank's output for its replica's rows is within the JAX test's
    atol of the JAX apply_moe's; the ranks' aux losses, averaged over dp,
    are JAX's within 1e-6 relative, and the same on the ep ranks of a
    replica."""
    params, x, out_w, aux_w, _ = ep_case
    _, cfg = _moe_cfgs(*EP_CFG)
    ranks = _layer_on_ranks(params, x, cfg, MeshConfig(dp=2, ep=4))
    rows = x.shape[0] // 2
    for lay, out, *_ in ranks:
        np.testing.assert_allclose(
            out, out_w[lay.dp_rank * rows:(lay.dp_rank + 1) * rows],
            atol=OUT_ATOL)
    aux = {lay.dp_rank: set() for lay, *_ in ranks}
    for lay, _, a, *_ in ranks:
        aux[lay.dp_rank].add(a)
    assert all(len(v) == 1 for v in aux.values())
    np.testing.assert_allclose(np.mean([v.pop() for v in aux.values()]),
                               aux_w, rtol=AUX_RTOL)


def test_apply_moe_grads_at_dp2_ep4_match_jax(ep_case):
    """The gradients of wg, w1 and w2 (averaged over dp, the experts put
    back together over ep) and of x (a replica's rows, of the mean over
    dp of the ranks' objectives) against jax.grad of sum(out * cos(out))
    + 3 aux on the whole batch: the router's through the gates' copy and
    the aux loss with the whole batch's top-1 fractions, the experts' and
    x's through each replica's own slots."""
    params, x, _, _, (gp_w, gx_w) = ep_case
    _, cfg = _moe_cfgs(*EP_CFG)
    rows = x.shape[0] // 2
    for lay, _, _, gp, gx in _layer_on_ranks(params, x, cfg,
                                             MeshConfig(dp=2, ep=4)):
        for n in ("wg", "w1", "w2"):
            assert np.abs(gp_w[n]).max() > 0
            np.testing.assert_allclose(gp[n].numpy(), gp_w[n], atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=n)
        np.testing.assert_allclose(
            gx / lay.dp, gx_w[lay.dp_rank * rows:(lay.dp_rank + 1) * rows],
            atol=GRAD_ATOL, rtol=GRAD_RTOL)


def _jax_dropped(params, x, jcfg):
    """The (b, s, k) pairs the JAX package's apply_moe drops, by its own
    lines (ray_tpu/models/layers.py:249-274) on the whole batch."""
    B, S, _ = x.shape
    E, K = jcfg.n_experts, jcfg.top_k
    C = max(1, int(jcfg.capacity_factor * K * B * S / E))
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, params["wg"]), -1)
    _, gate_idx = jax.lax.top_k(probs, K)
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.int32)
    pos = (jnp.cumsum(onehot.reshape(B * S * K, E), axis=0) - 1).reshape(
        B, S, K, E)
    kept = np.asarray(jnp.any((pos < C) & (onehot > 0), axis=-1))
    return {tuple(i) for i in np.argwhere(~kept)}, C


def test_capacity_tight_drops_are_the_jax_packages():
    """At capacity factor 0.5 on dp 2 x ep 2 the dropped (token, k) pairs,
    counted by each replica from the whole batch's slots, are exactly the
    JAX package's; some of replica 1's pairs are dropped only because
    replica 0's filled their expert's slots; and the outputs are JAX's
    apply_moe's."""
    jcfg, cfg = _moe_cfgs(*TIGHT_CFG)
    rng = np.random.default_rng(7)
    E = cfg.n_experts
    params = {"wg": rng.standard_normal((D, E)).astype(np.float32),
              "w1": (rng.standard_normal((E, D, FF)) * D ** -0.5
                     ).astype(np.float32),
              "w2": (rng.standard_normal((E, FF, D)) * FF ** -0.5
                     ).astype(np.float32)}
    x = rng.standard_normal((4, 8, D)).astype(np.float32)
    want, C = _jax_dropped(params, jnp.asarray(x), jcfg)
    out_w, _ = JL.apply_moe(params, jnp.asarray(x), jcfg,
                            compute_dtype=jnp.float32)
    assert 0 < len(want) < 4 * 8 * 2
    rows = 2

    def rank(lay):
        xs = torch.from_numpy(x[lay.dp_rank * rows:(lay.dp_rank + 1) * rows])
        wg = torch.from_numpy(params["wg"])
        _, _, _, slots = TL.route_tokens(wg, xs, cfg, dp_group=lay.dp_group)
        _, _, _, own = TL.route_tokens(wg, xs, cfg)
        mine = TS.tree_shard(convert.params_from_jax(params, "cpu"), lay,
                             _moe_specs())
        out, _ = TL.apply_moe(mine, xs, cfg, torch.float32,
                              dp_group=lay.dp_group, ep_group=lay.ep_group,
                              tape=StageTape())
        moved = (slots >= C) & (own < C)
        return (lay, {(b + lay.dp_rank * rows, s, k) for b, s, k in
                      torch.nonzero(slots >= C).tolist()},
                int(moved.sum()), out.detach().numpy())

    ranks = run_mesh(MeshConfig(dp=2, ep=2), rank)
    got = set().union(*(r[1] for r in ranks))
    assert got == want
    assert all(r[2] > 0 for r in ranks if r[0].dp_rank == 1)
    assert all(r[2] == 0 for r in ranks if r[0].dp_rank == 0)
    for lay, _, _, out in ranks:
        np.testing.assert_allclose(
            out, np.asarray(out_w)[lay.dp_rank * rows:(lay.dp_rank + 1)
                                   * rows], atol=OUT_ATOL)


# --------------------------------------------------------------- refusals
def _tiny_moe():
    return dataclasses.replace(TG.gpt2_tiny(), dtype=torch.float32,
                               moe=TL.MoEConfig(n_experts=4))


@pytest.mark.parametrize("what", ["pp2", "microbatches", "remat"])
def test_unported_moe_layouts_are_refused(what):
    """MoE at pp 2 (the JAX twin's message) and MoE over more than one
    microbatch (the router counts the whole batch) are refused before any
    collective. remat with MoE runs since the tape checkpoints each
    layer: at dp 2 x ep 2 its recompute reuses the router's slot counts
    rather than count again, and its metrics and grads are the same bits
    as remat off in f32 on the CPU. MoE at tp 2 or sp 2, at ep 1 or 2,
    runs: tests/test_torch_mesh_moe_*.py hold it to the JAX package."""
    cfg = _tiny_moe()
    if what == "remat":
        params = TG.init(torch.Generator().manual_seed(0), cfg, device="cpu")
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (8, 33)).astype(np.int32))

        def rank(lay):
            out = []
            for remat in (False, True):
                mine = tree_map(lambda t: t.requires_grad_(True),
                                TS.tree_shard(params, lay,
                                              TG.partition_specs(cfg)))
                metrics, grads = TT.pipelined_grads(
                    mine, {"tokens": tokens},
                    dataclasses.replace(cfg, remat=remat), lay, 1)
                out.append(({k: float(v) for k, v in metrics.items()},
                            tree_leaves(grads)))
            return out

        for (m_off, g_off), (m_on, g_on) in run_mesh(MeshConfig(dp=2, ep=2),
                                                     rank):
            assert m_on == m_off
            assert all(torch.equal(a, b) for a, b in zip(g_on, g_off,
                                                         strict=True))
        return
    sizes, m = {"pp2": (dict(pp=2), 4),
                "microbatches": (dict(dp=2, ep=2), 2)}[what]
    error, match = {"pp2": (NotImplementedError, "use pp=1 with MoE"),
                    "microbatches": (ValueError, "n_microbatches=1")}[what]
    lay = _layout(MeshConfig(**sizes), 0)
    with pytest.raises(error, match=match):
        TG.forward_pipelined({}, torch.zeros(8, 16, dtype=torch.int32), cfg,
                             lay, n_microbatches=m)


def test_unsharded_experts_and_a_missing_tape_are_refused():
    """At ep 2 a tree that holds every expert was not cut by tree_shard,
    and the layer over groups without a tape would run its sums inside
    autograd: both raise before any collective."""
    _, cfg = _moe_cfgs(*EP_CFG)
    rng = np.random.default_rng(0)
    whole = {"wg": torch.randn(D, 4), "w1": torch.randn(4, D, FF),
             "w2": torch.randn(4, FF, D)}
    x = torch.from_numpy(rng.standard_normal((2, 8, D)).astype(np.float32))

    def rank(lay):
        with pytest.raises(ValueError, match="tree_shard"):
            TL.apply_moe(whole, x, cfg, torch.float32, dp_group=lay.dp_group,
                         ep_group=lay.ep_group, tape=StageTape())
        with pytest.raises(ValueError, match="StageTape"):
            TL.apply_moe(TS.tree_shard(whole, lay, _moe_specs()), x, cfg,
                         torch.float32, dp_group=lay.dp_group,
                         ep_group=lay.ep_group)
        return True

    assert all(run_mesh(MeshConfig(dp=2, ep=2), rank))


# --------------------------------------------- no collective in backward
def test_no_collective_runs_inside_autograd_backward_at_dp2_ep2(monkeypatch):
    """Every collective call of a dp 2 x ep 2 train step of a tiny MoE
    model (the routing counts over dp, the ep sums and the ep copies'
    backward sums, the dp sync and the norm's) runs outside any autograd
    backward (graph task id -1), as test_torch_mesh_tp.py's recorder sees
    the tp ones."""
    cfg = _tiny_moe()
    params = TG.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 17)).astype(np.int32))
    calls, lock = [], threading.Lock()
    for op in ("allgather", "allgather_async", "allreduce",
               "allreduce_async", "barrier", "broadcast", "recv",
               "reducescatter", "reducescatter_async", "send", "sendrecv"):
        def probed(*a, _op=op, _fn=getattr(col, op), **kw):
            with lock:
                calls.append((_op, torch._C._current_graph_task_id(),
                              a[1] if len(a) > 1 else kw.get("group_name")))
            return _fn(*a, **kw)
        monkeypatch.setattr(col, op, probed)
    specs = TG.partition_specs(cfg)

    def rank(lay):
        o = TT.default_optimizer(1e-3, warmup_steps=1, total_steps=10)
        st = TT.make_train_state(
            lambda g: TS.tree_shard(params, lay, specs), torch.Generator(), o,
            device="cpu")
        TT.make_pipelined_train_step(cfg, o, lay, n_microbatches=1)(
            st, {"tokens": tokens})
        return lay.dp_group, lay.ep_group

    groups = run_mesh(MeshConfig(dp=2, ep=2), rank)
    dp_groups, ep_groups = {g[0] for g in groups}, {g[1] for g in groups}
    on_dp = [c for c in calls if c[2] in dp_groups]
    on_ep = [c for c in calls if c[2] in ep_groups]
    # per rank and layer: the routing counts over dp; the output's ep sum
    # and the two copies' sums over ep
    n_layer = cfg.n_layer
    assert len(on_dp) >= 4 * n_layer and len(on_ep) >= 4 * 3 * n_layer
    assert [c for c in calls if c[1] != -1] == []
