"""GPT-2 at the mesh's tp axis in the port against the JAX package's own
tp oracles, on gpt2_tiny weights made by the JAX gpt2.init and carried
across with convert.params_from_jax, each rank's tree cut by
convert.stage_params and sharding.tree_shard with gpt2.partition_specs:

at dp 2 x sp 2 x tp 2 against JAX's gpt2.forward on the same mesh with
the params laid out by partition_specs (test_parallel.py's
test_gpt2_sharded_forward_matches_unsharded): each last-stage rank's
block of the logits, the value and the grads of mean(logits ** 2), put
back together by sharding.tree_unshard, and the next-token loss, in f32
and bf16 with test_torch_gpt2_pipelined.py's TOL; and the grads of the
whole leaves bit-equal across the tp ranks. The fixtures and checks
serve test_torch_mesh_tp_pp.py too, which runs them at dp 2 x pp 2 x tp
2 against JAX's forward_pipelined (test_gpt2_pipelined_matches_dense).

Five train steps against the JAX package's are in
test_torch_mesh_tp_train.py. The port's ranks are threads of this process over one HashStore
(tests/torch_gang.run_mesh), torch at two intra-op threads, and every
group and join has a timeout; the JAX oracles and the port's runs are
computed once a module."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from ray_tpu.models import gpt2 as JG
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig, create_mesh
from ray_tpu_torch import convert
from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.parallel import sharding as TS
from ray_tpu_torch.parallel import train_step as TT
from ray_tpu_torch.parallel.mesh import MeshConfig
from ray_tpu_torch.parallel.ring_attention import shard_bounds
from ray_tpu_torch.util import collective as col
from tests.test_torch_gpt2_pipelined import TOL, _cfgs, two_threads  # noqa: F401
from tests.torch_gang import run_mesh

B, S = 8, 32
# name: (the port's layout, its microbatches a replica, the JAX mesh,
# whether the JAX oracle is the pipelined forward)
LAYOUTS = {"dp2sp2tp2": (MeshConfig(dp=2, sp=2, tp=2), 1,
                         JMeshConfig(dp=2, sp=2, tp=2), False),
           "dp2pp2tp2": (MeshConfig(dp=2, pp=2, tp=2), 4,
                         JMeshConfig(dp=2, pp=2, tp=2), True)}
# this file's cases; test_torch_mesh_tp_pp.py runs dp2pp2tp2's
CASES = [(dt, "dp2sp2tp2") for dt in TOL]


def _is_tp(spec) -> bool:
    return any("tp" in TS.spec_axes(entry) for entry in spec)


@pytest.fixture(scope="module")
def setup():
    """gpt2_tiny's f32 params and test_parallel.py's tiny_setup tokens."""
    jcfg, _ = _cfgs("float32")
    params = jax.tree.map(np.asarray, JG.init(jax.random.PRNGKey(0), jcfg))
    tokens = np.array(jax.random.randint(
        jax.random.PRNGKey(1), (B, S + 1), 0, jcfg.vocab_size), np.int32)
    return params, tokens


@pytest.fixture(scope="module")
def oracles(setup):
    """Per (dtype, layout), computed once: JAX's logits, the value and
    grads of mean(logits ** 2) and the next-token loss of those logits,
    from one forward on the layout's mesh."""
    params, tokens = setup
    cache = {}

    def get(dtype, name):
        if (dtype, name) in cache:
            return cache[dtype, name]
        jcfg, _ = _cfgs(dtype)
        _, m, jconfig, pipelined = LAYOUTS[name]
        mesh = create_mesh(jconfig)

        def f(p, t):
            if pipelined:
                logits, _ = JG.forward_pipelined(p, t[:, :-1], jcfg, mesh,
                                                 n_microbatches=4)
            else:
                logits, _ = JG.forward(p, t[:, :-1], jcfg, mesh)
            lse = jax.scipy.special.logsumexp(logits, axis=-1)
            tl = jnp.take_along_axis(logits, t[:, 1:, None], axis=-1)[..., 0]
            return (jnp.mean(logits.astype(jnp.float32) ** 2),
                    (logits, jnp.mean(lse - tl)))

        with jax.set_mesh(mesh):
            p = params
            if not pipelined:
                p = jax.tree.map(
                    lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                    params, JG.partition_specs(jcfg))
            (value, (logits, ce)), grads = jax.jit(
                jax.value_and_grad(f, has_aux=True))(p, tokens)
        cache[dtype, name] = (np.asarray(logits, np.float32), float(value),
                              jax.tree.map(np.asarray, grads), float(ce))
        return cache[dtype, name]

    return get


def _rank_params(params, lay, cfg):
    return tree_map(lambda t: t.requires_grad_(True), TS.tree_shard(
        convert.stage_params(convert.params_from_jax(params, "cpu"),
                             lay.pp_rank, lay.pp), lay,
        TG.partition_specs(cfg)))


@pytest.fixture(scope="module")
def runs(setup):
    """Per (dtype, layout), computed once: each rank's layout, its block
    of the logits (last stage), the value of mean(logits ** 2) (each
    rank's part over its block, summed over tp and sp, averaged over dp),
    its grads of it averaged over dp, put back together over tp and as
    they are, and the next-token loss pipelined_grads reports."""
    params, tokens = setup
    cache = {}

    def get(dtype, name):
        if (dtype, name) in cache:
            return cache[dtype, name]
        _, tcfg = _cfgs(dtype)
        config, m = LAYOUTS[name][:2]
        specs = TG.partition_specs(tcfg)
        batch = {"tokens": torch.from_numpy(tokens)}

        def rank(lay):
            rows = TT.dp_rows(batch, lay, m)["tokens"]
            rp = _rank_params(params, lay, tcfg)
            fwd = TG.forward_pipelined(rp, rows[:, :-1], tcfg, lay,
                                       n_microbatches=m)
            part = logits = None
            value = torch.zeros(())
            if lay.is_last_stage:
                part = ((fwd.logits.float() ** 2).sum()
                        / (rows.shape[0] * S * tcfg.vocab_size))
                value = part.detach()
                for group in (lay.tp_group, lay.sp_group):
                    value = col.allreduce(value, group)
                logits = fwd.logits.detach().float().numpy()
            grads, metrics = TT.sync_over_dp(fwd.backward(part),
                                             {"value": value}, lay)
            whole = tree_map(lambda g: g.detach().float().numpy(),
                             TS.tree_unshard(grads, lay, specs))
            loss = TT.pipelined_grads(rp, batch, tcfg, lay, m)[0]["loss"]
            return (lay, logits, float(metrics["value"]), whole,
                    tree_leaves(grads), float(loss))

        cache[dtype, name] = run_mesh(config, rank)
        return cache[dtype, name]

    return get


def check_logits(oracles, runs, dtype, name):
    """Each last-stage rank's logits, for its replica's rows, its shard of
    the sequence and its block of the vocab, against the same block of
    JAX's logits on the same mesh."""
    logits_w = oracles(dtype, name)[0]
    _, tcfg = _cfgs(dtype)
    rows = B // 2
    n = tcfg.vocab_size // 2
    for lay, logits, *_ in runs(dtype, name):
        if not lay.is_last_stage:
            assert logits is None
            continue
        lo, hi = shard_bounds(S, lay.sp, lay.sp_rank)
        np.testing.assert_allclose(
            logits, logits_w[lay.dp_rank * rows:(lay.dp_rank + 1) * rows,
                             lo:hi, lay.tp_rank * n:(lay.tp_rank + 1) * n],
            atol=TOL[dtype][0])


def check_grads(oracles, runs, dtype, name):
    """Every rank's grads of mean(logits ** 2), averaged over dp and put
    back together over tp (the block leaves its stage's slice), against
    JAX's value_and_grad on the same mesh."""
    grads_w = oracles(dtype, name)[2]
    _, tcfg = _cfgs(dtype)
    tol = TOL[dtype][2]
    for lay, _, _, whole, *_ in runs(dtype, name):
        per = tcfg.n_layer // lay.pp
        want = dict(grads_w)
        want["blocks"] = tree_map(
            lambda g: g[lay.pp_rank * per:(lay.pp_rank + 1) * per],
            grads_w["blocks"])
        for got, w in zip(tree_leaves(whole), tree_leaves(want),
                          strict=True):
            np.testing.assert_allclose(got, w, atol=tol, rtol=tol)


def check_value_and_next_token_loss(oracles, runs, dtype, name):
    """The value of mean(logits ** 2) on every last-stage rank, and the
    mean next-token loss (the vocab-parallel cross-entropy) that
    pipelined_grads gives every rank, against JAX's from the same
    logits."""
    _, value_w, _, ce_w = oracles(dtype, name)
    for lay, _, value, _, _, loss in runs(dtype, name):
        if lay.is_last_stage:
            np.testing.assert_allclose(value, value_w, atol=TOL[dtype][1])
        np.testing.assert_allclose(loss, ce_w, atol=TOL[dtype][1])


def check_whole_leaf_grads_are_bit_equal_across_tp(runs, dtype, name):
    """The grads of the leaves every tp rank holds whole (the LayerNorms,
    b2, wpe, ln_f) are the same bits on the two tp ranks of each (dp, pp,
    sp) coordinate: each is computed from tensors summed over tp, the
    same on every member."""
    _, tcfg = _cfgs(dtype)
    whole = [not _is_tp(s) for s in tree_leaves(TG.partition_specs(tcfg))]
    ranks = runs(dtype, name)
    for lay, *_, grads, _ in ranks:
        twin = next(r for r in ranks if r[0].tp_rank == 0 and (
            r[0].dp_rank, r[0].pp_rank, r[0].sp_rank) == (
                lay.dp_rank, lay.pp_rank, lay.sp_rank))
        pairs = [(a, b) for a, b, w in zip(grads, twin[4], whole) if w]
        assert len(pairs) == 8
        assert all(torch.equal(a, b) for a, b in pairs)


@pytest.mark.parametrize("dtype,name", CASES)
def test_tp_logits_match_jax(oracles, runs, dtype, name):
    check_logits(oracles, runs, dtype, name)


@pytest.mark.parametrize("dtype,name", CASES)
def test_tp_grads_match_jax(oracles, runs, dtype, name):
    check_grads(oracles, runs, dtype, name)


@pytest.mark.parametrize("dtype,name", CASES)
def test_tp_value_and_next_token_loss_match_jax(oracles, runs, dtype, name):
    check_value_and_next_token_loss(oracles, runs, dtype, name)


@pytest.mark.parametrize("dtype,name", CASES)
def test_tp_whole_leaf_grads_are_bit_equal_across_tp(runs, dtype, name):
    check_whole_leaf_grads_are_bit_equal_across_tp(runs, dtype, name)


def test_layouts_are_the_jax_oracles_meshes():
    """Each port layout has the sizes of the JAX mesh its oracle ran on."""
    for config, _, jconfig, _ in LAYOUTS.values():
        assert config.axis_sizes() == dataclasses.asdict(jconfig)
