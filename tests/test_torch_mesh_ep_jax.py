"""GPT-2-tiny-MoE at the mesh's ep axis in the port against the JAX
package's own mesh loss: gpt2_tiny with MoEConfig() in every block (8
experts, top-2, capacity factor 1.25), its weights made by the JAX
gpt2.init and carried across with convert.params_from_jax, each rank's
tree cut by sharding.tree_shard with gpt2.partition_specs (4 experts a
rank), at dp 2 x ep 2 against jax.value_and_grad of gpt2.loss_fn(...,
mesh) on create_mesh(dp=2, ep=2) with the params laid out by
partition_specs and the batch on P("dp"), in f32 and bf16: the loss and
the aux loss the train step reports (averaged over dp), and every leaf's
gradient, averaged over dp and put back together by
sharding.tree_unshard, within test_torch_gpt2_pipelined.py's TOL; the
grads of the leaves every ep rank holds whole are the same bits on both
ep ranks of a replica. The port's ranks are threads of this process over
one HashStore (tests/torch_gang.run_mesh), torch at two intra-op
threads, and every group and join has a timeout; the JAX oracle and the
port's run are computed once a module and dtype."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ray_tpu.models import gpt2 as JG
from ray_tpu.models import layers as JL
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig, create_mesh
from ray_tpu_torch import convert
from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.models import layers as TL
from ray_tpu_torch.parallel import sharding as TS
from ray_tpu_torch.parallel import train_step as TT
from ray_tpu_torch.parallel.mesh import MeshConfig
from tests.test_torch_gpt2_pipelined import TOL, two_threads  # noqa: F401
from tests.torch_gang import run_mesh

B, S = 8, 32
SIZES = dict(dp=2, ep=2)


def _cfgs(dtype):
    """gpt2_tiny with MoEConfig() in every block, remat off."""
    jcfg = dataclasses.replace(JG.gpt2_tiny(), dtype=jnp.dtype(dtype),
                               moe=JL.MoEConfig(), remat=False)
    tcfg = dataclasses.replace(TG.gpt2_tiny(), dtype=getattr(torch, dtype),
                               moe=TL.MoEConfig(), remat=False)
    return jcfg, tcfg


def _is_ep(spec) -> bool:
    return any("ep" in TS.spec_axes(entry) for entry in spec)


def rank_params(params, lay, cfg):
    """This rank's tree: the whole model's, its experts cut to its block."""
    return tree_map(lambda t: t.requires_grad_(True), TS.tree_shard(
        convert.params_from_jax(params, "cpu"), lay, TG.partition_specs(cfg)))


@pytest.fixture(scope="module")
def setup():
    """GPT-2-tiny-MoE's f32 params from the JAX init (jitted: an eager
    init compiles each draw apart) and test_parallel.py's tiny_setup
    tokens."""
    jcfg, _ = _cfgs("float32")
    params = jax.tree.map(np.asarray, jax.jit(JG.init, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    tokens = np.array(jax.random.randint(
        jax.random.PRNGKey(1), (B, S + 1), 0, jcfg.vocab_size), np.int32)
    return params, tokens


@pytest.fixture(scope="module")
def oracle(setup):
    """Per dtype, computed once: JAX's loss, aux loss and grads of
    loss_fn's total on the dp 2 x ep 2 mesh."""
    params, tokens = setup
    cache = {}

    def get(dtype):
        if dtype not in cache:
            jcfg, _ = _cfgs(dtype)
            mesh = create_mesh(JMeshConfig(**SIZES),
                               devices=jax.devices()[:4])
            with jax.set_mesh(mesh):
                p = jax.tree.map(
                    lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                    params, JG.partition_specs(jcfg))
                t = jax.device_put(tokens, NamedSharding(mesh, P("dp")))
                (_, m), grads = jax.jit(jax.value_and_grad(
                    lambda p, t: JG.loss_fn(p, {"tokens": t}, jcfg, mesh),
                    has_aux=True))(p, t)
            cache[dtype] = ({k: float(v) for k, v in m.items()},
                            jax.tree.map(np.asarray, grads))
        return cache[dtype]

    return get


@pytest.fixture(scope="module")
def runs(setup):
    """Per dtype, computed once: each rank's layout, the metrics
    pipelined_grads gives it (averaged over dp), its grads (averaged over
    dp) as they are and put back together over ep."""
    params, tokens = setup
    cache = {}

    def get(dtype):
        if dtype not in cache:
            _, tcfg = _cfgs(dtype)
            specs = TG.partition_specs(tcfg)
            batch = {"tokens": torch.from_numpy(tokens)}

            def rank(lay):
                metrics, grads = TT.pipelined_grads(
                    rank_params(params, lay, tcfg), batch, tcfg, lay, 1)
                whole = tree_map(lambda g: g.detach().float().numpy(),
                                 TS.tree_unshard(grads, lay, specs))
                return (lay, {k: float(v) for k, v in metrics.items()},
                        whole, tree_leaves(grads))

            cache[dtype] = run_mesh(MeshConfig(**SIZES), rank)
        return cache[dtype]

    return get


@pytest.mark.parametrize("dtype", list(TOL))
def test_ep_loss_and_aux_loss_match_jax(oracle, runs, dtype):
    """The loss, the aux loss (each replica's share averaged over dp) and
    the total on every rank against JAX's mesh loss_fn, within TOL's loss
    bound; the aux loss is positive."""
    want, _ = oracle(dtype)
    assert want["aux_loss"] > 0
    for _, metrics, *_ in runs(dtype):
        for key in ("loss", "aux_loss", "total_loss"):
            np.testing.assert_allclose(metrics[key], want[key],
                                       atol=TOL[dtype][1], err_msg=key)


@pytest.mark.parametrize("dtype", list(TOL))
def test_ep_grads_match_jax(oracle, runs, dtype):
    """Every leaf's gradient of the total (the aux loss's share included),
    averaged over dp and put back together over ep, against
    jax.value_and_grad of the mesh loss_fn."""
    _, grads_w = oracle(dtype)
    tol = TOL[dtype][2]
    for _, _, whole, _ in runs(dtype):
        got, want = tree_leaves(whole), jax.tree_util.tree_leaves(grads_w)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(TOL))
def test_ep_whole_leaf_grads_are_bit_equal_across_ep(runs, dtype):
    """The grads of the leaves every ep rank holds whole (the router, the
    attention, the LayerNorms, the embeddings) are the same bits on the
    two ep ranks of each replica: each is computed from the same rows
    and from gradients summed over ep, the same on every member."""
    _, tcfg = _cfgs(dtype)
    whole = [not _is_ep(s) for s in tree_leaves(TG.partition_specs(tcfg))]
    assert 0 < sum(whole) < len(whole)
    ranks = runs(dtype)
    for lay, _, _, grads in ranks:
        twin = next(r for r in ranks if r[0].ep_rank == 0
                    and r[0].dp_rank == lay.dp_rank)
        assert all(torch.equal(a, b) for a, b, w in zip(grads, twin[3],
                                                        whole) if w)
