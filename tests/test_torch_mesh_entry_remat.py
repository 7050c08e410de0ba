"""remat on the tape (StageTape.checkpoint) through the port's mesh entry
point against the JAX package's remat (jax.checkpoint around each layer
body): GPT-2-tiny at tp 2 (this file) and sp 2
(test_torch_mesh_entry_remat_sp.py), GPT-2-tiny-MoE (MoEConfig() in
every block) at ep 2 x tp 2 (_remat_moe.py) and sp 2 x ep 2
(_remat_moe_sp.py), with remat=True on both sides, in f32 and bf16. Each
rank's tree comes from make_train_state(..., layout,
gpt2.partition_specs(cfg)) on weights made by the JAX gpt2.init, and its
gradient from the train step's own path (train_step.layout_grads over
gpt2.loss_fn(p, b, cfg, layout) on the rank's rows, batch_rows); the
loss (and the aux loss) on every rank and every leaf's gradient, put
back together by sharding.tree_unshard, against jax.value_and_grad of
gpt2.loss_fn(..., mesh) on create_mesh of the same sizes, within
test_torch_gpt2_pipelined.py's TOL. In f32 on the CPU, remat's metrics
and grads are the same bits as the port's own remat=False. The port's
ranks are threads of this process over one HashStore
(tests/torch_gang.run_on_mesh), torch at two intra-op threads, and every
group and join has a timeout; each JAX oracle and port run is computed
once a module."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as JG
from ray_tpu.models import layers as JL
from ray_tpu_torch import convert
from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.models import layers as TL
from ray_tpu_torch.parallel import mesh as M
from ray_tpu_torch.parallel import sharding as TS
from ray_tpu_torch.parallel import train_step as TT
from tests.test_torch_gpt2_pipelined import TOL, two_threads  # noqa: F401
from tests.test_torch_mesh_moe_jax import jax_value_and_grad
from tests.torch_gang import run_on_mesh

B, S = 8, 32
# name: (mesh sizes, MoE)
LAYOUTS = {"tp2": (dict(tp=2), False), "sp2": (dict(sp=2), False),
           "ep2tp2": (dict(ep=2, tp=2), True),
           "sp2ep2": (dict(ep=2, sp=2), True)}
# this file's cases; _remat_sp.py, _remat_moe.py and _remat_moe_sp.py run
# the others
CASES = [(dt, "tp2") for dt in TOL]


def remat_cfgs(dtype, moe, remat=True):
    """gpt2_tiny for both packages, with MoEConfig() in every block if
    ``moe``."""
    jcfg = dataclasses.replace(JG.gpt2_tiny(), dtype=jnp.dtype(dtype),
                               remat=remat,
                               moe=JL.MoEConfig() if moe else None)
    tcfg = dataclasses.replace(TG.gpt2_tiny(), dtype=getattr(torch, dtype),
                               remat=remat,
                               moe=TL.MoEConfig() if moe else None)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights():
    """Per model (dense or MoE), made once: f32 params from the JAX init
    (jitted) and test_parallel.py's tiny_setup tokens."""
    cache = {}

    def get(moe):
        if moe not in cache:
            jcfg, _ = remat_cfgs("float32", moe)
            params = jax.tree.map(np.asarray, jax.jit(
                JG.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
            tokens = np.array(jax.random.randint(
                jax.random.PRNGKey(1), (B, S + 1), 0, jcfg.vocab_size),
                np.int32)
            cache[moe] = params, tokens
        return cache[moe]

    return get


@pytest.fixture(scope="module")
def oracle(weights):
    """Per (dtype, layout), computed once: JAX's metrics and grads of
    loss_fn's total with remat=True on the layout's mesh."""
    cache = {}

    def get(dtype, name):
        if (dtype, name) not in cache:
            sizes, moe = LAYOUTS[name]
            params, tokens = weights(moe)
            cache[dtype, name] = jax_value_and_grad(
                params, tokens, remat_cfgs(dtype, moe)[0], sizes)
        return cache[dtype, name]

    return get


@pytest.fixture(scope="module")
def runs(weights):
    """Per (dtype, layout), computed once: on each rank, for remat on and
    off, its metrics, its grads put back together over ep and tp, and as
    they are."""
    cache = {}

    def get(dtype, name):
        if (dtype, name) not in cache:
            sizes, moe = LAYOUTS[name]
            params, tokens = weights(moe)
            batch = {"tokens": torch.from_numpy(tokens)}
            mesh = M.create_mesh(M.MeshConfig(**sizes), devices=[
                torch.device("cpu")] * int(np.prod(list(sizes.values()))))

            def rank(lay):
                out = {}
                for remat in (True, False):
                    _, cfg = remat_cfgs(dtype, moe, remat)
                    specs = TG.partition_specs(cfg)
                    state = TT.make_train_state(
                        lambda g: convert.params_from_jax(params, "cpu"),
                        None, TT.default_optimizer(), lay, specs)
                    metrics, grads = TT.layout_grads(
                        lambda p, b: TG.loss_fn(p, b, cfg, lay),
                        state.params, TT.batch_rows(batch, lay), lay)
                    whole = tree_map(lambda g: g.detach().float().numpy(),
                                     TS.tree_unshard(grads, lay, specs))
                    out[remat] = ({k: float(v) for k, v in metrics.items()},
                                  whole, tree_leaves(grads))
                return out

            cache[dtype, name] = run_on_mesh(mesh, rank, name=f"remat{name}")
        return cache[dtype, name]

    return get


def check_metrics(oracle, runs, dtype, name):
    """The loss and total (and the aux loss with MoE) on every rank
    against JAX's remat loss_fn, within TOL's loss bound."""
    want, _ = oracle(dtype, name)
    for out in runs(dtype, name):
        metrics = out[True][0]
        for key in ("loss", "aux_loss", "total_loss"):
            np.testing.assert_allclose(metrics[key], want[key],
                                       atol=TOL[dtype][1], err_msg=key)


def check_grads(oracle, runs, dtype, name):
    """Every leaf's gradient of the total, put back together over ep and
    tp, against jax.value_and_grad of JAX's remat loss_fn."""
    _, grads_w = oracle(dtype, name)
    tol = TOL[dtype][2]
    for out in runs(dtype, name):
        got = tree_leaves(out[True][1])
        want = jax.tree_util.tree_leaves(grads_w)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


def check_remat_is_remat_off(runs, dtype, name):
    """In f32, remat's metrics and every rank's grads are the same bits
    as remat off (the recompute replays the boundaries and the router's
    counts, and repeats the same operations)."""
    for out in runs(dtype, name):
        (m_on, _, g_on), (m_off, _, g_off) = out[True], out[False]
        assert m_on == m_off
        assert all(torch.equal(a, b) for a, b in zip(g_on, g_off,
                                                     strict=True))


@pytest.mark.parametrize("dtype,name", CASES)
def test_remat_metrics_match_jax(oracle, runs, dtype, name):
    check_metrics(oracle, runs, dtype, name)


@pytest.mark.parametrize("dtype,name", CASES)
def test_remat_grads_match_jax(oracle, runs, dtype, name):
    check_grads(oracle, runs, dtype, name)


@pytest.mark.parametrize("name", ["tp2"])
def test_remat_is_remat_off_in_f32(runs, name):
    check_remat_is_remat_off(runs, "float32", name)
