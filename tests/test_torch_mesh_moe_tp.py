"""The MoE layer on the mesh's tp axis in the port
(models.layers.apply_moe with a layout's tp group beside its dp and ep
groups: each rank holds its block of E / ep experts and of each expert's
hidden, the experts' output summed over tp) against the JAX package's
apply_moe on the whole batch, at tp 2, ep 2 x tp 2 and dp 2 x ep 2 x tp 2, in
f32 with test_parallel.py's test_moe_ep_sharded tolerance: the output,
the aux loss and the gradients of x, wg, w1 and w2, a capacity-tight
case whose dropped (token, k) pairs are the JAX package's, the router's
gradient bit-equal across tp, and that no collective of a train step at
ep 2 x tp 2 or sp 2 x ep 2 runs inside autograd's backward. The helpers
serve test_torch_mesh_moe_sp.py, which runs the layer on the sp axis.
The port's ranks are threads of this process over one HashStore
(tests/torch_gang.run_mesh), torch at two intra-op threads, and every
group and join has a timeout; each JAX oracle is computed once a
module."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import layers as JL
from ray_tpu_torch import convert
from ray_tpu_torch._private.tree import tree_map
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.models import layers as TL
from ray_tpu_torch.parallel import sharding as TS
from ray_tpu_torch.parallel import train_step as TT
from ray_tpu_torch.parallel.mesh import MeshConfig
from ray_tpu_torch.parallel.pipeline import StageTape
from ray_tpu_torch.parallel.ring_attention import shard_bounds
from ray_tpu_torch.util import collective as col
from tests.test_torch_gpt2_pipelined import two_threads  # noqa: F401
from tests.test_torch_mesh_ep import (D, EP_CFG, FF, GRAD_ATOL, GRAD_RTOL,
                                      OUT_ATOL, AUX_RTOL, TIGHT_CFG,
                                      _jax_dropped, _moe_cfgs, _moe_specs)
from tests.torch_gang import run_mesh

LAYOUTS = {"tp2": MeshConfig(tp=2), "ep2tp2": MeshConfig(ep=2, tp=2),
           "dp2ep2tp2": MeshConfig(dp=2, ep=2, tp=2)}
# the input: 4 rows of 8 tokens, as test_moe_ep_sharded's
X_SHAPE = (4, 8, D)


def jax_layer_case(key, cfg_args, x_shape):
    """Weights and input from jax.random ``key``, and the JAX package's
    apply_moe on them in f32: the output, the aux loss and the gradients
    of sum(out * cos(out)) + 3 aux."""
    jcfg, _ = _moe_cfgs(*cfg_args)
    k = jax.random.PRNGKey(key)
    p = JL.init_moe(k, D, FF, jcfg)
    x = jax.random.normal(k, x_shape)

    def loss(p, x):
        out, aux = JL.apply_moe(p, x, jcfg, compute_dtype=jnp.float32)
        return jnp.sum(out * jnp.cos(out)) + 3.0 * aux, (out, aux)

    (_, (out, aux)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p, x)
    return (jax.tree.map(np.asarray, p), np.asarray(x), np.asarray(out),
            float(aux), jax.tree.map(np.asarray, grads))


def tight_case(seed, x_shape):
    """Random f32 weights and input for the capacity-tight cases, the
    pairs the JAX package drops, its capacity and its output."""
    jcfg, _ = _moe_cfgs(*TIGHT_CFG)
    rng = np.random.default_rng(seed)
    E = jcfg.n_experts
    params = {"wg": rng.standard_normal((D, E)).astype(np.float32),
              "w1": (rng.standard_normal((E, D, FF)) * D ** -0.5
                     ).astype(np.float32),
              "w2": (rng.standard_normal((E, FF, D)) * FF ** -0.5
                     ).astype(np.float32)}
    x = rng.standard_normal(x_shape).astype(np.float32)
    want, C = _jax_dropped(params, jnp.asarray(x), jcfg)
    out, _ = JL.apply_moe(params, jnp.asarray(x), jcfg,
                          compute_dtype=jnp.float32)
    return params, x, want, C, np.asarray(out)


def block(a, lay):
    """The rank's block of a [B, S, ...] array: its replica's rows and its
    shard of the sequence."""
    rows = a.shape[0] // lay.dp
    lo, hi = shard_bounds(a.shape[1], lay.sp, lay.sp_rank)
    return a[lay.dp_rank * rows:(lay.dp_rank + 1) * rows, lo:hi]


def layer_on_ranks(params, x, cfg, config):
    """apply_moe on every rank of ``config``, each on its block of x
    (``block``) and its block of the experts and their hidden, on a
    StageTape, then the gradient of the rank's part of sum(out * cos(out))
    + 3 aux (dp times its own tokens' sum, plus its aux share), the
    params' summed over sp and averaged over dp, as the pipelined step
    does, and put back together over ep and tp. Returns per rank:
    (layout, out, its aux share, the aux summed over sp and averaged over
    dp, grads of wg/w1/w2, grad of its block of x, its grad of wg as it
    is)."""
    specs = _moe_specs()
    whole = convert.params_from_jax(params, "cpu")

    def rank(lay):
        xs = torch.tensor(block(x, lay), requires_grad=True)
        mine = tree_map(lambda t: t.requires_grad_(True),
                        TS.tree_shard(whole, lay, specs))
        tape = StageTape()
        out, aux = TL.apply_moe(mine, xs, cfg, torch.float32,
                                dp_group=lay.dp_group, ep_group=lay.ep_group,
                                sp_group=lay.sp_group, tp_group=lay.tp_group,
                                tape=tape)
        objective = lay.dp * torch.sum(out * torch.cos(out)) + 3.0 * aux
        names = sorted(mine)
        (gx,), gp = tape.backward(objective, torch.ones(()), [xs],
                                  [mine[n] for n in names])
        wg = gp[names.index("wg")].clone()
        gp = {n: col.allreduce(col.allreduce(g, lay.sp_group), lay.dp_group)
              / lay.dp for n, g in zip(names, gp)}
        gp = TS.tree_unshard(gp, lay, specs)
        total = col.allreduce(col.allreduce(aux.detach(), lay.sp_group),
                              lay.dp_group) / lay.dp
        return (lay, out.detach().numpy(), float(aux.detach()), float(total),
                gp, gx.numpy(), wg)

    return run_mesh(config, rank)


def check_layer(case, config):
    """Every rank's output for its block against the JAX output's same
    block (OUT_ATOL), the aux loss summed over sp and averaged over dp
    against JAX's (AUX_RTOL) and the same on every rank, and the grads of
    wg, w1, w2 and of the rank's block of x (of the mean over dp of the
    ranks' objectives) against jax.grad's."""
    params, x, out_w, aux_w, (gp_w, gx_w) = case
    _, cfg = _moe_cfgs(*EP_CFG)
    ranks = layer_on_ranks(params, x, cfg, config)
    for lay, out, _, total, gp, gx, _ in ranks:
        np.testing.assert_allclose(out, block(out_w, lay), atol=OUT_ATOL)
        np.testing.assert_allclose(total, aux_w, rtol=AUX_RTOL)
        for n in ("wg", "w1", "w2"):
            assert np.abs(gp_w[n]).max() > 0
            np.testing.assert_allclose(gp[n].numpy(), gp_w[n], atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=n)
        np.testing.assert_allclose(gx / lay.dp, block(gx_w, lay),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)
    assert len({r[3] for r in ranks}) == 1
    return ranks


def check_tight(case, config):
    """The pairs every rank drops at capacity factor 0.5, counted from the
    whole batch's slots, are exactly the JAX package's, and its output is
    JAX's apply_moe's for its block."""
    params, x, want, C, out_w = case
    _, cfg = _moe_cfgs(*TIGHT_CFG)
    assert 0 < len(want) < x.shape[0] * x.shape[1] * cfg.top_k

    def rank(lay):
        xs = torch.from_numpy(np.ascontiguousarray(block(x, lay)))
        _, _, _, slots = TL.route_tokens(torch.from_numpy(params["wg"]), xs,
                                         cfg, dp_group=lay.dp_group,
                                         sp_group=lay.sp_group)
        mine = TS.tree_shard(convert.params_from_jax(params, "cpu"), lay,
                             _moe_specs())
        out, _ = TL.apply_moe(mine, xs, cfg, torch.float32,
                              dp_group=lay.dp_group, ep_group=lay.ep_group,
                              sp_group=lay.sp_group, tp_group=lay.tp_group,
                              tape=StageTape())
        rows = xs.shape[0]
        lo, _ = shard_bounds(x.shape[1], lay.sp, lay.sp_rank)
        return (lay, {(b + lay.dp_rank * rows, s + lo, k) for b, s, k in
                      torch.nonzero(slots >= C).tolist()},
                out.detach().numpy())

    ranks = run_mesh(config, rank)
    for lay, got, out in ranks:
        assert got == {p for p in want if _in_block(p, x.shape, lay)}, \
            lay.rank
        np.testing.assert_allclose(out, block(out_w, lay), atol=OUT_ATOL)
    assert set().union(*(r[1] for r in ranks)) == want


def _in_block(pair, shape, lay) -> bool:
    """Whether the (b, s, k) pair's token lies in the rank's block."""
    b, s, _ = pair
    rows = shape[0] // lay.dp
    lo, hi = shard_bounds(shape[1], lay.sp, lay.sp_rank)
    return lay.dp_rank * rows <= b < (lay.dp_rank + 1) * rows and lo <= s < hi


@pytest.fixture(scope="module")
def ep_case():
    """test_moe_ep_sharded's weights and input (key 4) and JAX's layer."""
    return jax_layer_case(4, EP_CFG, X_SHAPE)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_apply_moe_at_tp_matches_jax(ep_case, name):
    """At tp 2 (every expert, half of each one's hidden a rank), ep 2 x
    tp 2 and dp 2 x ep 2 x tp 2 (two experts and half of each one's
    hidden a rank) the output, the aux loss and the grads of x, wg, w1
    and w2 against JAX's apply_moe on the whole batch."""
    check_layer(ep_case, LAYOUTS[name])


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_router_grad_is_bit_equal_across_tp(ep_case, name):
    """The router's gradient is the same bits on the tp ranks of each
    (dp, ep) coordinate: the router reads x before its tp copy, and the
    gates combine the experts' output summed over tp, the same on every
    rank; a copy before the router would sum its gradient over tp."""
    params, x, *_ = ep_case
    _, cfg = _moe_cfgs(*EP_CFG)
    ranks = layer_on_ranks(params, x, cfg, LAYOUTS[name])
    for lay, *_, wg in ranks:
        twin = next(r for r in ranks if r[0].tp_rank == 0
                    and r[0].dp_rank == lay.dp_rank
                    and r[0].ep_rank == lay.ep_rank)
        assert torch.equal(wg, twin[-1])


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_capacity_tight_drops_at_tp_are_the_jax_packages(name):
    """At capacity factor 0.5 the dropped (token, k) pairs are exactly
    the JAX package's, and the outputs are its apply_moe's."""
    check_tight(tight_case(7, X_SHAPE), LAYOUTS[name])


# --------------------------------------------- no collective in backward
def _tiny_moe():
    return dataclasses.replace(TG.gpt2_tiny(), dtype=torch.float32,
                               moe=TL.MoEConfig(n_experts=4))


@pytest.mark.parametrize("sizes", [dict(ep=2, tp=2), dict(sp=2, ep=2)],
                         ids=["ep2tp2", "sp2ep2"])
def test_no_collective_runs_inside_autograd_backward(monkeypatch, sizes):
    """Every collective call of a train step of a tiny MoE model at ep 2 x
    tp 2 and at sp 2 x ep 2 (the routing counts, the ep and tp sums and
    the copies' backward sums, the ring's hops, the sp sums of the grads
    and the aux loss, the norm's) runs outside any autograd backward
    (graph task id -1), as test_torch_mesh_ep.py's recorder sees the dp
    2 x ep 2 ones; the router ends the step bit-equal across the layout's
    ep, sp and tp groups."""
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
        st, _ = TT.make_pipelined_train_step(cfg, o, lay, n_microbatches=1)(
            st, {"tokens": tokens})
        return (lay, {a: getattr(lay, f"{a}_group") for a in sizes},
                st.params["blocks"]["moe"]["wg"])

    ranks = run_mesh(MeshConfig(**sizes), rank)
    n_layer = cfg.n_layer
    for axis in sizes:
        groups = {r[1][axis] for r in ranks}
        on = [c for c in calls if c[2] in groups]
        # per rank and layer at least the output's sum or the routing
        # counts over the axis
        assert len(on) >= 4 * n_layer, axis
    assert [c for c in calls if c[1] != -1] == []
    assert all(torch.equal(r[2], ranks[0][2]) for r in ranks)
