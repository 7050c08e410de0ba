"""The mesh's tp axis in the port (ray_tpu_torch.parallel.mesh's tp
groups, the mesh half of parallel.sharding, gpt2.logical_axes and
partition_specs, parallel.tensor_parallel) against the JAX package: the
specs leaf for leaf, tree_shard against NamedSharding's shards, the rank
layout against create_mesh's device order, the vocab-parallel embedding
and cross-entropy against their one-rank versions, two train steps at
tp 2, pp 2 x tp 2, dp 2 x sp 2 x tp 2 and dp 2 x pp 2 x tp 2 against the
one-rank step, the refusals, and that no collective of a tp step runs
inside autograd's backward. GPT-2's
logits, grads and train steps at tp against the JAX oracles are in
test_torch_mesh_tp_jax.py. The port's ranks are threads of this process
over one HashStore (tests/torch_gang.run_mesh), torch at two intra-op
threads, and every group and join has a timeout."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ray_tpu.models import gpt2 as JG
from ray_tpu.models.layers import MoEConfig as JMoEConfig
from ray_tpu.parallel import sharding as JS
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig, create_mesh
from ray_tpu_torch import convert
from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.models.layers import MoEConfig
from ray_tpu_torch.parallel import mesh as M
from ray_tpu_torch.parallel import sharding as TS
from ray_tpu_torch.parallel import tensor_parallel as TP
from ray_tpu_torch.parallel import train_step as TT
from ray_tpu_torch.parallel.mesh import MeshConfig
from ray_tpu_torch.parallel.pipeline import StageTape
from ray_tpu_torch.util import collective as col
from tests.test_torch_gpt2_pipelined import _cfgs, two_threads  # noqa: F401
from tests.torch_gang import run_mesh

B, S = 8, 32


def _config_pairs():
    """(name, JAX config, port config): the tiny and the small presets
    and a MoE config."""
    moe = dict(vocab_size=128, max_seq=64, n_layer=2, n_head=2, d_model=32)
    return {
        "tiny": (JG.gpt2_tiny(), TG.gpt2_tiny()),
        "small": (JG.gpt2_small(), TG.gpt2_small()),
        "moe": (JG.GPT2Config(**moe, moe=JMoEConfig()),
                TG.GPT2Config(**moe, moe=MoEConfig())),
    }


@pytest.fixture(scope="module")
def setup():
    jcfg, _ = _cfgs("float32")
    params = jax.tree.map(np.asarray, JG.init(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    return params, tokens


def _rank_params(params, lay, cfg):
    """This rank's stage tree, cut to its tp block."""
    return tree_map(lambda t: t.requires_grad_(True), TS.tree_shard(
        convert.stage_params(convert.params_from_jax(params, "cpu"),
                             lay.pp_rank, lay.pp), lay,
        TG.partition_specs(cfg)))


# ------------------------------------------------------------------ specs
def test_rules_and_spec_match_jax():
    """DEFAULT_RULES are the JAX package's; spec gives JAX's
    PartitionSpec as a tuple, for names, None and a custom rule set, and
    both refuse a name without a rule; replicated is the empty spec."""
    assert TS.DEFAULT_RULES == JS.DEFAULT_RULES
    for names in [("batch", "seq", "embed"), ("vocab", None),
                  ("layers", "heads", "head_dim"), ()]:
        assert TS.spec(*names) == tuple(JS.spec(*names))
    rules = {"batch": ("dp", "sp"), "x": None}
    assert TS.spec("batch", "x", rules=rules) == tuple(
        JS.spec("batch", "x", rules=rules))
    for mod in (TS, JS):
        with pytest.raises(KeyError, match="No sharding rule"):
            mod.spec("nope")
    assert TS.replicated() == tuple(P())


@pytest.mark.parametrize("name", ["tiny", "small", "moe"])
def test_logical_axes_and_partition_specs_match_jax(name):
    """logical_axes and partition_specs leaf for leaf, in the same
    (sorted-key) order: wq/wk/wv on heads, wo on its first non-layer
    axis, w1/b1/w2 on the MLP hidden, wte on the vocab ride tp; the
    experts ride ep; the LayerNorms, b2 and wpe are whole."""
    jcfg, tcfg = _config_pairs()[name]
    is_names = lambda x: isinstance(x, tuple)  # noqa: E731
    want_axes = jax.tree_util.tree_leaves(JG.logical_axes(jcfg),
                                          is_leaf=is_names)
    assert tree_leaves(TG.logical_axes(tcfg)) == want_axes
    want = JG.partition_specs(jcfg)
    got = TG.partition_specs(tcfg)
    assert tree_leaves(got) == [tuple(s) for s in jax.tree_util.tree_leaves(
        want, is_leaf=lambda x: isinstance(x, P))]
    assert set(got) == set(want)
    blocks = got["blocks"]
    assert got["wte"] == ("tp", None) and got["wpe"] == (None, None)
    assert blocks["attn"]["wo"] == (None, "tp", None, None)
    assert blocks["ln1"]["scale"] == (None, None)
    if "mlp" in blocks:
        assert blocks["mlp"]["b2"] == (None, None)
        assert blocks["mlp"]["b1"] == (None, "tp")
    else:
        assert blocks["moe"]["w1"] == (None, "ep", None, "tp")


# ------------------------------------------------------------- tree_shard
def _layouts(config):
    """A hand-built layout per rank of ``config`` (no groups): enough for
    tree_shard, which only reads coordinates."""
    layouts = []
    for r in range(config.world_size):
        d, p, e, s, t = M.coordinates(config, r)
        layouts.append(M.RankLayout(config, r, d, p, s, "dp", "pp", "sp", t,
                                    "tp", e, "ep"))
    return layouts


@pytest.mark.parametrize("what", ["gpt2_tiny", "tuple_axes"])
def test_tree_shard_matches_named_sharding(setup, what):
    """Each rank's block of every leaf at dp 2 x sp 2 x tp 2 is the data
    of the shard jax.device_put(x, NamedSharding(mesh, spec)) puts on the
    device at the rank's place in create_mesh(...).devices, and a copy:
    GPT-2's tree by partition_specs, and leaves on specs that name two
    axes on one dimension, or several dimensions."""
    params, _ = setup
    if what == "gpt2_tiny":
        tree = params
        specs = TG.partition_specs(TG.gpt2_tiny())
    else:
        rng = np.random.default_rng(0)
        tree = {"a": rng.standard_normal((8, 6)).astype(np.float32),
                "b": rng.standard_normal((4, 2, 6)).astype(np.float32),
                "c": rng.standard_normal((2, 4)).astype(np.float32)}
        specs = {"a": (("dp", "sp"), "tp"), "b": ("sp", "tp", None),
                 "c": ("tp", ("dp",))}
    config = MeshConfig(dp=2, sp=2, tp=2)
    mesh = create_mesh(JMeshConfig(dp=2, sp=2, tp=2))
    devices = np.asarray(mesh.devices)
    jspecs = tree_map(lambda s: P(*s), specs)
    shards = []
    for leaf, spec in zip(tree_leaves(tree), tree_leaves(jspecs)):
        arr = jax.device_put(leaf, NamedSharding(mesh, spec))
        shards.append({s.device.id: np.asarray(s.data)
                       for s in arr.addressable_shards})
    whole = convert.params_from_jax(tree, "cpu")
    for lay in _layouts(config):
        got = TS.tree_shard(whole, lay, specs)
        device = devices[lay.dp_rank, lay.pp_rank, 0, lay.sp_rank,
                         lay.tp_rank]
        for key, (g, w) in enumerate(zip(tree_leaves(got),
                                         tree_leaves(whole))):
            np.testing.assert_array_equal(g.numpy(),
                                          shards[key][device.id])
            assert g.data_ptr() != w.data_ptr()


def test_tree_unshard_puts_the_blocks_back_together(setup):
    """tree_unshard over the axis groups of dp 2 x sp 2 x tp 2 gives every
    rank the whole tree back from the blocks tree_shard cut, bit for
    bit."""
    params, _ = setup
    whole = convert.params_from_jax(params, "cpu")
    specs = TG.partition_specs(TG.gpt2_tiny())
    specs["wpe"] = ("sp", ("dp", "tp"))

    def rank(lay):
        back = TS.tree_unshard(TS.tree_shard(whole, lay, specs), lay, specs)
        return all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                     tree_leaves(whole)))

    assert all(run_mesh(MeshConfig(dp=2, sp=2, tp=2), rank))


# ------------------------------------------------------------------ layout
@pytest.mark.parametrize("sizes", [dict(dp=2, sp=2, tp=2),
                                   dict(pp=2, tp=2)])
def test_layout_follows_the_jax_mesh_order_with_tp(sizes):
    """A global rank's (dp, pp, ep, sp, tp) coordinates are its device's
    place on the JAX mesh of the same sizes, tp the fastest axis, and each
    of its five groups holds, in order, the ranks that differ from it in
    that axis alone."""
    cfg = MeshConfig(**sizes)
    devices = np.asarray(create_mesh(
        JMeshConfig(**sizes), devices=jax.devices()[:cfg.world_size]).devices)

    def rank(lay):
        out = {"coords": (lay.dp_rank, lay.pp_rank, lay.ep_rank, lay.sp_rank,
                          lay.tp_rank)}
        for axis in M.LAYOUT_AXES:
            group = getattr(lay, f"{axis}_group")
            out[axis] = (col.get_rank(group),
                         [int(t) for t in col.allgather(
                             torch.tensor([lay.rank]), group)])
        return out

    for r, got in enumerate(run_mesh(cfg, rank)):
        coords = got["coords"]
        assert M.coordinates(cfg, r) == coords
        assert devices[coords].id == r
        for i, axis in enumerate(M.LAYOUT_AXES):
            members = []
            for c in range(getattr(cfg, axis)):
                place = list(coords)
                place[i] = c
                members.append(int(devices[tuple(place)].id))
            assert got[axis] == (coords[i], members)


# ------------------------------------------------ the tp module, one rank
def test_vocab_parallel_embedding_and_losses_match_one_rank():
    """At tp 2, the rows summed over the group are F.embedding's on the
    whole table, and the vocab-parallel token losses and their gradient,
    put back together over the vocab, are logsumexp - the target's logit
    and its gradient on the whole logits, in f32; no op of the backward
    communicates."""
    gen = torch.Generator().manual_seed(0)
    V, d = 16, 4
    wte = torch.randn(V, d, generator=gen)
    tokens = torch.randint(0, V, (3, 5), generator=gen)
    logits = torch.randn(3, 5, V, generator=gen) * 3
    cot = torch.randn(3, 5, generator=gen)
    whole = logits.clone().requires_grad_(True)
    want = (torch.logsumexp(whole, -1)
            - whole.gather(-1, tokens.unsqueeze(-1)).squeeze(-1))
    (want_grad,) = torch.autograd.grad(want, whole, cot)

    def rank(lay):
        t = lay.tp_rank
        rows = TP.vocab_parallel_embedding(
            tokens, wte[t * V // 2:(t + 1) * V // 2], lay.tp_group,
            StageTape())
        mine = logits[..., t * V // 2:(t + 1) * V // 2].clone()
        mine.requires_grad_(True)
        losses = TP.vocab_parallel_token_losses(mine, tokens, lay.tp_group)
        (grad,) = torch.autograd.grad(losses, mine, cot)
        return rows, losses.detach(), grad

    ranks = run_mesh(MeshConfig(tp=2), rank)
    for rows, losses, _ in ranks:
        assert torch.equal(rows, torch.nn.functional.embedding(tokens, wte))
        torch.testing.assert_close(losses, want.detach(), rtol=1e-6,
                                   atol=1e-6)
    torch.testing.assert_close(torch.cat([r[2] for r in ranks], dim=-1),
                               want_grad, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ train steps
@pytest.mark.parametrize("sizes", [dict(tp=2), dict(pp=2, tp=2),
                                   dict(dp=2, sp=2, tp=2),
                                   dict(dp=2, pp=2, tp=2)])
def test_tp_train_step_matches_the_one_rank_step(setup, sizes):
    """Two steps of make_pipelined_train_step at each of these tp meshes
    (the first at lr 0, as optax reads the schedule before its count
    moves) against make_train_step on one rank, f32: the loss, the
    global grad norm and the params put back together over tp
    (tree_unshard) and the stages (join_stages), within 1e-5, as
    test_train_step_matches_the_one_rank_step holds pp 2."""
    params, tokens = setup
    _, tcfg = _cfgs("float32")
    rng = np.random.default_rng(3)
    batches = [{"tokens": torch.from_numpy(tokens)},
               {"tokens": torch.from_numpy(rng.integers(
                   0, tcfg.vocab_size, (B, S + 1)).astype(np.int32))}]
    specs = TG.partition_specs(tcfg)

    def opt():
        return TT.default_optimizer(1e-2, warmup_steps=1, total_steps=10)

    state = TT.make_train_state(
        lambda g: convert.params_from_jax(params, "cpu"), torch.Generator(),
        opt(), device="cpu")
    step = TT.make_train_step(lambda p, b: TG.loss_fn(p, b, tcfg), opt())
    want = []
    for batch in batches:
        state, m = step(state, batch)
        want.append((float(m["loss"]), float(m["grad_norm"])))

    def rank(lay):
        o = opt()
        st = TT.make_train_state(lambda g: _rank_params(params, lay, tcfg),
                                 torch.Generator(), o, device="cpu")
        pstep = TT.make_pipelined_train_step(tcfg, o, lay, n_microbatches=2)
        got = []
        for batch in batches:
            st, m = pstep(st, batch)
            got.append((float(m["loss"]), float(m["grad_norm"])))
        return lay, got, TS.tree_unshard(st.params, lay, specs)

    ranks = run_mesh(MeshConfig(**sizes), rank)
    for _, got, _ in ranks:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    stages = [p for lay, _, p in sorted(
        ranks, key=lambda r: r[0].pp_rank) if lay.rank % (
            lay.sp * lay.tp) == 0 and lay.dp_rank == 0]
    for a, b in zip(tree_leaves(convert.join_stages(stages)),
                    tree_leaves(state.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-5)


# --------------------------------------------------------------- refusals
@pytest.mark.parametrize("what", ["n_head", "d_ff", "vocab_size"])
def test_a_dimension_tp_does_not_divide_is_refused(what):
    """n_head, the MLP hidden or the vocab not divisible by tp 2: the JAX
    package's device_put by partition_specs raises ValueError, and so
    does the port's tree_shard (validate_mesh_for_model names the heads
    on both)."""
    change = {"n_head": dict(n_head=3, d_model=48), "d_ff": dict(d_ff=129),
              "vocab_size": dict(vocab_size=255)}[what]
    jcfg = dataclasses.replace(JG.gpt2_tiny(), **change)
    tcfg = dataclasses.replace(TG.gpt2_tiny(), **change)
    mesh = create_mesh(JMeshConfig(dp=2, sp=2, tp=2))
    params = JG.init(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(ValueError, match="divisible by 2"):
        jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                     params, JG.partition_specs(jcfg))
    lay = _layouts(MeshConfig(dp=2, sp=2, tp=2))[1]
    with pytest.raises(ValueError, match="not divisible by tp=2"):
        TS.tree_shard(convert.params_from_jax(params, "cpu"), lay,
                      TG.partition_specs(tcfg))
    from ray_tpu.parallel.mesh import validate_mesh_for_model
    assert M.validate_mesh_for_model(
        lay, n_heads=tcfg.n_head, n_layers=2) == validate_mesh_for_model(
            mesh, n_heads=jcfg.n_head, n_layers=2)


def test_remat_and_unsharded_params_at_tp_are_refused(setup):
    """remat at tp 2 runs: each layer is a checkpointed region of the
    stage's tape, whose recompute replays the tp sums' outputs rather
    than sum again, its metrics and grads the same bits as remat off in
    f32 on the CPU. A stage tree that holds the whole vocab at tp 2 was
    not cut by tree_shard, and is still refused before any collective."""
    params, tokens = setup
    _, tcfg = _cfgs("float32")
    whole = convert.params_from_jax(params, "cpu")
    batch = {"tokens": torch.from_numpy(tokens)}

    def rank(lay):
        out = []
        for remat in (False, True):
            metrics, grads = TT.pipelined_grads(
                _rank_params(params, lay, tcfg), batch,
                dataclasses.replace(tcfg, remat=remat), lay, 1)
            out.append(({k: float(v) for k, v in metrics.items()},
                        tree_leaves(grads)))
        with pytest.raises(ValueError, match="tree_shard"):
            TG.forward_pipelined(whole, torch.from_numpy(tokens[:, :-1]),
                                 tcfg, lay)
        return out

    for (m_off, g_off), (m_on, g_on) in run_mesh(MeshConfig(tp=2), rank):
        assert m_on == m_off
        assert all(torch.equal(a, b) for a, b in zip(g_on, g_off,
                                                     strict=True))


def test_moe_is_refused_by_the_pipelined_forward_at_tp(setup):
    """MoE stays refused by the pipelined forward at tp 2, as the JAX
    twin refuses it on a tp 2 mesh."""
    _, tokens = setup
    jcfg, tcfg = _config_pairs()["moe"]
    mesh = create_mesh(JMeshConfig(dp=2, pp=2, tp=2))
    with jax.set_mesh(mesh), pytest.raises(NotImplementedError,
                                           match="MoE aux loss"):
        JG.forward_pipelined({}, jnp.asarray(tokens % 128), jcfg, mesh)

    def rank(lay):
        with pytest.raises(NotImplementedError, match="MoE aux loss"):
            TG.forward_pipelined({}, torch.from_numpy(tokens % 128), tcfg,
                                 lay)
        return True

    assert all(run_mesh(MeshConfig(pp=2, tp=2), rank))


# --------------------------------------------- no collective in backward
@pytest.mark.parametrize("sizes", [dict(pp=2, tp=2), dict(sp=2, tp=2)])
def test_no_collective_runs_inside_autograd_backward_at_tp(setup, sizes,
                                                           monkeypatch):
    """Every collective call of a tp 2 train step (pp 2 x tp 2, sp 2 x tp
    2), the tp copies', sums' and the cross-entropy's among them, runs
    outside any autograd backward (graph task id -1), as the recorder of
    test_torch_gpt2_pipelined.py sees it at pp 2 x sp 2."""
    params, tokens = setup
    _, tcfg = _cfgs("float32")
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

    def rank(lay):
        o = TT.default_optimizer(1e-3, warmup_steps=1, total_steps=10)
        st = TT.make_train_state(lambda g: _rank_params(params, lay, tcfg),
                                 torch.Generator(), o, device="cpu")
        TT.make_pipelined_train_step(tcfg, o, lay, n_microbatches=2)(
            st, {"tokens": torch.from_numpy(tokens)})
        return lay.tp_group

    tp_groups = set(run_mesh(MeshConfig(**sizes), rank))
    on_tp = [c for c in calls if c[2] in tp_groups]
    # per rank: the embed's or the unembed's, two copies and two sums a
    # layer, the cross-entropy's two and the norm's
    assert len(on_tp) >= 2 * 4 * TG.gpt2_tiny().n_layer // sizes.get("pp", 1)
    assert {op for op, _, _ in on_tp} == {"allreduce"}
    assert [c for c in calls if c[1] != -1] == []
