"""GPT-2-tiny-MoE on the mesh's tp and sp axes in the port against the
JAX package's own mesh loss: gpt2_tiny with MoEConfig() in every block (8
experts, top-2, capacity factor 1.25), its weights made by the JAX
gpt2.init and carried across with convert.params_from_jax, each rank's
tree cut by sharding.tree_shard with gpt2.partition_specs (4 experts a
rank, each expert's hidden halved at tp 2), at ep 2 x tp 2 against
jax.value_and_grad of gpt2.loss_fn(...,
mesh) on create_mesh of the same sizes, the params laid out by
partition_specs and the batch on P("dp"), in f32 and bf16: the loss and
the aux loss the train step reports, and every leaf's gradient put back
together by sharding.tree_unshard, within test_torch_gpt2_pipelined.py's
TOL (test_torch_mesh_ep_jax.py's); the grads of the leaves every rank of
an ep, a tp or an sp group holds whole are the same bits across it. The
fixtures and checks serve test_torch_mesh_moe_jax_sp.py (sp 2 x ep 2),
_3d.py, _dp.py, _ep1.py and _ep1_sp.py, which run them at the other
layouts, a few a file to keep each file's time short. The port's ranks
are
threads of this process over one HashStore (tests/torch_gang.run_mesh),
torch at two intra-op threads, and every group and join has a timeout;
the JAX oracle and the port's run are computed once a module, layout
and dtype."""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from ray_tpu.models import gpt2 as JG
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig, create_mesh
from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.parallel import sharding as TS
from ray_tpu_torch.parallel import train_step as TT
from ray_tpu_torch.parallel.mesh import MeshConfig
from tests.test_torch_gpt2_pipelined import TOL, two_threads  # noqa: F401
from tests.test_torch_mesh_ep_jax import B, S, _cfgs, rank_params
from tests.torch_gang import run_mesh

LAYOUTS = {"ep2tp2": dict(ep=2, tp=2), "sp2ep2": dict(ep=2, sp=2),
           "ep2sp2tp2": dict(ep=2, sp=2, tp=2),
           "dp2ep2tp2": dict(dp=2, ep=2, tp=2),
           "dp2sp2ep2": dict(dp=2, sp=2, ep=2),
           "tp2": dict(tp=2), "sp2": dict(sp=2), "dp2": dict(dp=2),
           "one": dict(dp=1)}
# this file's cases; test_torch_mesh_moe_jax_sp.py, _3d.py, _dp.py,
# _ep1.py and _ep1_sp.py run the others
CASES = [(dt, "ep2tp2") for dt in TOL]


def cuts(spec, axis) -> bool:
    """Whether a leaf of this spec is cut over ``axis``."""
    return any(axis in TS.spec_axes(entry) for entry in spec)


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


def jax_value_and_grad(params, tokens, jcfg, sizes):
    """JAX's metrics and grads of loss_fn's total on create_mesh(sizes),
    the params laid out by partition_specs and the batch on P("dp")."""
    config = JMeshConfig(**sizes)
    n = int(np.prod(list(sizes.values())))
    mesh = create_mesh(config, devices=jax.devices()[:n])
    with jax.set_mesh(mesh):
        p = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                         params, JG.partition_specs(jcfg))
        t = jax.device_put(tokens, NamedSharding(mesh, P("dp")))
        (_, m), grads = jax.jit(jax.value_and_grad(
            lambda p, t: JG.loss_fn(p, {"tokens": t}, jcfg, mesh),
            has_aux=True))(p, t)
    return ({k: float(v) for k, v in m.items()},
            jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module")
def oracle(setup):
    """Per (dtype, layout), computed once: JAX's loss, aux loss and grads
    of loss_fn's total on the layout's mesh."""
    params, tokens = setup
    cache = {}

    def get(dtype, name):
        if (dtype, name) not in cache:
            cache[dtype, name] = jax_value_and_grad(
                params, tokens, _cfgs(dtype)[0], LAYOUTS[name])
        return cache[dtype, name]

    return get


@pytest.fixture(scope="module")
def runs(setup):
    """Per (dtype, layout), computed once: each rank's layout, the metrics
    pipelined_grads gives it, its grads put back together over ep and tp,
    and as they are."""
    params, tokens = setup
    cache = {}

    def get(dtype, name):
        if (dtype, name) not in cache:
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

            cache[dtype, name] = run_mesh(MeshConfig(**LAYOUTS[name]), rank)
        return cache[dtype, name]

    return get


def check_loss_and_aux_loss(oracle, runs, dtype, name):
    """The loss, the aux loss (each sp rank's share summed over sp,
    averaged over dp) and the total on every rank against JAX's mesh
    loss_fn, within TOL's loss bound; the aux loss is positive."""
    want, _ = oracle(dtype, name)
    assert want["aux_loss"] > 0
    for _, metrics, *_ in runs(dtype, name):
        for key in ("loss", "aux_loss", "total_loss"):
            np.testing.assert_allclose(metrics[key], want[key],
                                       atol=TOL[dtype][1], err_msg=key)


def check_grads(oracle, runs, dtype, name):
    """Every leaf's gradient of the total (the aux loss's share included),
    averaged over dp and put back together over ep and tp, against
    jax.value_and_grad of the mesh loss_fn."""
    _, grads_w = oracle(dtype, name)
    tol = TOL[dtype][2]
    for _, _, whole, _ in runs(dtype, name):
        got, want = tree_leaves(whole), jax.tree_util.tree_leaves(grads_w)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


def check_whole_leaf_grads_are_bit_equal(runs, dtype, name):
    """On each axis of the layout, the grads of the leaves its ranks hold
    whole (over ep and tp the router, the LayerNorms and wpe among them;
    over sp every leaf) are the same bits on every rank of a group as on
    its first."""
    _, tcfg = _cfgs(dtype)
    specs = tree_leaves(TG.partition_specs(tcfg))
    ranks = runs(dtype, name)
    coords = ("dp", "ep", "sp", "tp")
    for axis in LAYOUTS[name]:
        whole = [not cuts(s, axis) for s in specs]
        for lay, _, _, grads in ranks:
            twin = next(r for r in ranks if all(
                getattr(r[0], f"{a}_rank") == (
                    0 if a == axis else getattr(lay, f"{a}_rank"))
                for a in coords))
            assert all(torch.equal(a, b) for a, b, w in zip(
                grads, twin[3], whole) if w), (axis, lay.rank)


@pytest.mark.parametrize("dtype,name", CASES)
def test_moe_loss_and_aux_loss_match_jax(oracle, runs, dtype, name):
    check_loss_and_aux_loss(oracle, runs, dtype, name)


@pytest.mark.parametrize("dtype,name", CASES)
def test_moe_grads_match_jax(oracle, runs, dtype, name):
    check_grads(oracle, runs, dtype, name)


@pytest.mark.parametrize("dtype,name", CASES)
def test_moe_whole_leaf_grads_are_bit_equal_across_groups(runs, dtype, name):
    check_whole_leaf_grads_are_bit_equal(runs, dtype, name)
