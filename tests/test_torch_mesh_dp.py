"""The mesh's dp axis in the port (ray_tpu_torch.parallel.mesh, sharding's
axis_size, train_step.dp_rows / sync_over_dp / pipelined_grads) against
the JAX package: the config and mesh helpers on the same inputs, the rank
layout against ``create_mesh``'s device order, and GPT-2's pipelined
logits, loss and grads at dp 2 x pp 2 and dp 2 x pp 2 x sp 2 against the
JAX oracles of test_torch_gpt2_pipelined.py (the same meshes, with that
file's tolerances). The port's ranks are threads of this process over one
HashStore (tests/torch_gang.run_mesh), torch at two intra-op threads, and
every group and join has a timeout."""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from ray_tpu.parallel import mesh as JM
from ray_tpu.parallel import sharding as JS
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig, create_mesh
from ray_tpu_torch import convert
from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.models import layers as TL
from ray_tpu_torch.parallel import mesh as M
from ray_tpu_torch.parallel import sharding as TS
from ray_tpu_torch.parallel import train_step as TT
from ray_tpu_torch.parallel.mesh import MeshConfig
from ray_tpu_torch.parallel.ring_attention import shard_bounds
from ray_tpu_torch.util import collective as col
from tests.test_torch_gpt2_pipelined import (  # noqa: F401 (fixtures)
    B, M as N_MICRO, S, TOL, _cfgs, oracles, setup, two_threads)
from tests.torch_gang import run_mesh

# the port's layout beside the JAX mesh its oracle ran on
# (test_torch_gpt2_pipelined.LAYOUTS)
DP_LAYOUTS = {"pp2": MeshConfig(dp=2, pp=2),
              "pp2sp2": MeshConfig(dp=2, pp=2, sp=2)}
DP_CASES = [(dt, name) for dt in TOL for name in DP_LAYOUTS]


# ------------------------------------------------------ config and helpers
@pytest.mark.parametrize("sizes,n", [
    (dict(dp=-1, pp=2), 8), (dict(pp=2, sp=-1), 8), (dict(dp=2, pp=2, sp=2), 8),
    (dict(dp=2, pp=2, sp=2, tp=-1), 8), (dict(dp=-1), 1),
    (dict(dp=-1, pp=-1), 8), (dict(dp=-1, pp=3), 8), (dict(dp=2, pp=2), 8)])
def test_resolved_and_axis_sizes_match_jax(sizes, n):
    """The same sizes resolve alike, or both refuse (two -1 axes, a count
    the fixed axes do not divide, a mesh of another size)."""
    try:
        want = JMeshConfig(**sizes).resolved(n).axis_sizes()
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" ")[0]):
            MeshConfig(**sizes).resolved(n)
        return
    got = MeshConfig(**sizes).resolved(n)
    assert got.axis_sizes() == want
    assert list(got.axis_sizes()) == list(M.AXIS_ORDER) == list(JM.AXIS_ORDER)
    assert got.world_size == n


def test_a_wild_axis_that_resolves_to_an_unported_size_is_refused():
    """tp=-1 and ep=-1 over 8 devices with dp 2 and pp 2 are tp 2 and ep
    2 in the JAX package, and in the port's, which holds both axes; a
    layout the model does not run (MoE at pp 2, with the ep the wild axis
    resolves to) is refused by the forward with the JAX twin's message,
    before any collective."""
    assert JMeshConfig(dp=2, pp=2, tp=-1).resolved(8).tp == 2
    assert MeshConfig(dp=2, pp=2, tp=-1).resolved(8).tp == 2
    assert JMeshConfig(dp=2, pp=2, ep=-1).resolved(8).ep == 2
    config = MeshConfig(dp=2, pp=2, ep=-1).resolved(8)
    assert config.ep == 2
    layout = M.RankLayout(config, 0, 0, 0, 0, "dp", "pp", "sp", 0, "tp", 0,
                          "ep")
    cfg = dataclasses.replace(TG.gpt2_tiny(), moe=TL.MoEConfig())
    with pytest.raises(NotImplementedError, match="use pp=1 with MoE"):
        TG.forward_pipelined({}, torch.zeros(2, 4, dtype=torch.int32), cfg,
                             layout)
    with pytest.raises(ValueError, match="resolve it first"):
        MeshConfig(dp=-1, pp=2).world_size


@pytest.mark.parametrize("n", [1, 2, 6, 8, 12, 16])
@pytest.mark.parametrize("axes", [("dp",), ("dp", "pp"), ("dp", "pp", "sp"),
                                  ("pp", "sp", "dp")])
def test_balanced_factorization_matches_jax(n, axes):
    assert M.balanced_factorization(n, axes) == JM.balanced_factorization(
        n, axes)


@pytest.mark.parametrize("sizes,n_heads,n_layers", [
    (dict(dp=2, pp=2, sp=2), 12, 12), (dict(dp=2, pp=4), 12, 6),
    (dict(pp=8), 4, 12), (dict(dp=8), 3, 5)])
def test_mesh_summary_validation_and_axis_size_match_jax(sizes, n_heads,
                                                         n_layers):
    """mesh_shape_summary, validate_mesh_for_model and sharding.axis_size
    of a port config and of a rank layout on it against the JAX package's
    on the mesh of the same sizes."""
    jmesh = create_mesh(JMeshConfig(**sizes))
    config = MeshConfig(**sizes)
    layout = M.RankLayout(config, 0, 0, 0, 0, "dp", "pp", "sp")
    for mesh in (config, layout):
        assert M.mesh_shape_summary(mesh) == JM.mesh_shape_summary(jmesh)
        assert M.validate_mesh_for_model(
            mesh, n_heads=n_heads, n_layers=n_layers
        ) == JM.validate_mesh_for_model(jmesh, n_heads=n_heads,
                                        n_layers=n_layers)
        for axis in (*M.AXIS_ORDER, None):
            assert TS.axis_size(mesh, axis) == JS.axis_size(jmesh, axis)


# ------------------------------------------------------------------ layout
def test_layout_follows_the_jax_mesh_order_at_dp2_pp2_sp2():
    """A global rank's (dp, pp, sp) coordinates are its device's place on
    the JAX mesh of the same sizes, and each of its three groups holds the
    ranks that differ from it in that axis alone, in order."""
    cfg = MeshConfig(dp=2, pp=2, sp=2)
    devices = np.asarray(create_mesh(JMeshConfig(dp=2, pp=2, sp=2)).devices)

    def rank(lay):
        out = {"coords": (lay.dp_rank, lay.pp_rank, lay.sp_rank)}
        for axis in M.LAYOUT_AXES:
            group = getattr(lay, f"{axis}_group")
            out[axis] = (col.get_rank(group),
                         col.get_collective_group_size(group),
                         [int(t) for t in col.allgather(
                             torch.tensor([lay.rank]), group)])
        return out

    for r, got in enumerate(run_mesh(cfg, rank)):
        d, p, s = got["coords"]
        assert M.coordinates(cfg, r) == (d, p, 0, s, 0)
        assert devices[d, p, 0, s, 0].id == r == (d * 2 + p) * 2 + s
        assert got["dp"] == (d, 2, [p * 2 + s + 4 * i for i in range(2)])
        assert got["pp"] == (p, 2, [d * 4 + s + 2 * i for i in range(2)])
        assert got["sp"] == (s, 2, [d * 4 + p * 2 + i for i in range(2)])
        assert got["tp"] == (0, 1, [r])


def test_dp_rows_cut_the_batch_as_the_dp_sharding_does():
    """Replica i takes rows [i B / dp, (i + 1) B / dp); a batch that does
    not divide into dp x n_microbatches is refused."""
    tokens = torch.arange(8 * 3).view(8, 3)
    for dp_rank in range(2):
        lay = M.RankLayout(MeshConfig(dp=2, pp=2), 0, dp_rank, 0, 0,
                           "dp", "pp", "sp")
        rows = TT.dp_rows({"tokens": tokens}, lay, 4)["tokens"]
        assert torch.equal(rows, tokens[4 * dp_rank:4 * dp_rank + 4])
        with pytest.raises(ValueError, match="does not divide"):
            TT.dp_rows({"tokens": tokens}, lay, 3)


# ------------------------------------------------------------ against JAX
def _rank_params(params, lay):
    return tree_map(lambda t: t.requires_grad_(True), convert.stage_params(
        convert.params_from_jax(params, "cpu"), lay.pp_rank, lay.pp))


@pytest.mark.parametrize("dtype,name", DP_CASES)
def test_dp_logits_and_grads_match_jax(setup, oracles, dtype, name):
    """Each last-stage rank's logits for its replica's rows and its shard
    of the sequence, the value of mean(logits ** 2) (each replica's mean
    over its rows, summed over sp, averaged over dp) and every rank's
    gradient of it, averaged over dp by sync_over_dp, against JAX's
    forward_pipelined and value_and_grad on the dp 2 mesh."""
    params, tokens = setup
    _, tcfg = _cfgs(dtype)
    logits_w, value_w, grads_w, _ = oracles[dtype, name]
    atol_logits, atol_loss, tol_grads = TOL[dtype]
    config = DP_LAYOUTS[name]

    def rank(lay):
        rows = TT.dp_rows({"tokens": torch.from_numpy(tokens)}, lay,
                          N_MICRO)["tokens"]
        fwd = TG.forward_pipelined(_rank_params(params, lay), rows[:, :-1],
                                   tcfg, lay, n_microbatches=N_MICRO)
        part = logits = None
        value = torch.zeros(())
        if lay.is_last_stage:
            part = (fwd.logits.float() ** 2).mean() / lay.sp
            value = part.detach()
            if lay.sp > 1:
                value = col.allreduce(value, lay.sp_group)
            logits = fwd.logits.detach().float().numpy()
        grads, metrics = TT.sync_over_dp(fwd.backward(part),
                                         {"value": value}, lay)
        return lay, logits, float(metrics["value"]), tree_map(
            lambda g: g.detach().float().numpy(), grads)

    per = tcfg.n_layer // config.pp
    rows = B // config.dp
    for lay, logits, value, grads in run_mesh(config, rank):
        if lay.is_last_stage:
            lo, hi = shard_bounds(S, lay.sp, lay.sp_rank)
            np.testing.assert_allclose(
                logits, logits_w[lay.dp_rank * rows:(lay.dp_rank + 1) * rows,
                                 lo:hi], atol=atol_logits)
            np.testing.assert_allclose(value, value_w, atol=atol_loss)
        else:
            assert logits is None
        want = dict(grads_w)
        want["blocks"] = tree_map(
            lambda g: g[lay.pp_rank * per:(lay.pp_rank + 1) * per],
            grads_w["blocks"])
        for got, w in zip(tree_leaves(grads), tree_leaves(want)):
            np.testing.assert_allclose(got, w, atol=tol_grads,
                                       rtol=tol_grads)


@pytest.mark.parametrize("dtype,name", DP_CASES)
def test_dp_next_token_loss_matches_jax(setup, oracles, dtype, name):
    """pipelined_grads, given the global batch, gives every rank of every
    replica the whole batch's mean next-token loss, as JAX's
    loss_fn(pipelined=True) computes it on the dp 2 mesh."""
    params, tokens = setup
    _, tcfg = _cfgs(dtype)
    want = oracles[dtype, name][3]

    def rank(lay):
        metrics, _ = TT.pipelined_grads(
            _rank_params(params, lay), {"tokens": torch.from_numpy(tokens)},
            tcfg, lay, n_microbatches=N_MICRO)
        return float(metrics["loss"]), float(metrics["total_loss"])

    for values in run_mesh(DP_LAYOUTS[name], rank):
        np.testing.assert_allclose(values, [want] * 2, atol=TOL[dtype][1])


@pytest.mark.parametrize("name", list(DP_LAYOUTS))
def test_dp_train_step_matches_the_one_rank_step(setup, name):
    """Two pipelined steps at dp 2 (the first at lr 0) against
    make_train_step on one rank, f32: the loss, the global grad norm and
    the params reassembled from the stages, within 1e-5 (as
    test_train_step_matches_the_one_rank_step); the two replicas end with
    the same params bit for bit."""
    params, tokens = setup
    _, tcfg = _cfgs("float32")
    rng = np.random.default_rng(3)
    batches = [{"tokens": torch.from_numpy(tokens)},
               {"tokens": torch.from_numpy(rng.integers(
                   0, tcfg.vocab_size, (B, S + 1)).astype(np.int32))}]

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
        st = TT.make_train_state(
            lambda g: convert.stage_params(
                convert.params_from_jax(params, "cpu"), lay.pp_rank, lay.pp),
            torch.Generator(), o, device="cpu")
        pstep = TT.make_pipelined_train_step(tcfg, o, lay,
                                             n_microbatches=N_MICRO)
        got = []
        for batch in batches:
            st, m = pstep(st, batch)
            got.append((float(m["loss"]), float(m["grad_norm"])))
        return lay, got, st.params

    ranks = run_mesh(DP_LAYOUTS[name], rank)
    for lay, got, _ in ranks:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    for lay, _, p in ranks:
        twin = next(q for other, _, q in ranks if other.dp_rank == 0
                    and (other.pp_rank, other.sp_rank)
                    == (lay.pp_rank, lay.sp_rank))
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                     tree_leaves(twin)))
    stages = [p for lay, _, p in ranks if lay.dp_rank == lay.sp_rank == 0]
    for a, b in zip(tree_leaves(convert.join_stages(stages)),
                    tree_leaves(state.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-5)


def test_no_collective_runs_inside_autograd_backward_at_dp2_pp2_sp2(
        setup, monkeypatch):
    """Every collective call of a dp 2 x pp 2 x sp 2 train step, the dp
    sync among them, runs outside any autograd backward (graph task id
    -1), as test_no_collective_runs_inside_autograd_backward records it
    at pp 2 x sp 2."""
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
        st = TT.make_train_state(
            lambda g: convert.stage_params(
                convert.params_from_jax(params, "cpu"), lay.pp_rank, lay.pp),
            torch.Generator(), o, device="cpu")
        TT.make_pipelined_train_step(tcfg, o, lay, n_microbatches=N_MICRO)(
            st, {"tokens": torch.from_numpy(tokens)})
        return lay.dp_group

    dp_groups = set(run_mesh(MeshConfig(dp=2, pp=2, sp=2), rank))
    assert {op for op, _, _ in calls} >= {"allreduce", "allreduce_async",
                                          "broadcast", "recv", "send",
                                          "sendrecv"}
    assert {g for _, _, g in calls} & dp_groups
    assert [c for c in calls if c[1] != -1] == []


def test_two_replicas_do_not_share_store_keys():
    """Every group's store prefix names its axis and the rank's other two
    coordinates, so the pp groups of two replicas never meet: a dp 2 x pp
    2 mesh's pp groups each sum their own replica's values."""
    def rank(lay):
        mine = torch.tensor([float(lay.dp_rank * 10 + lay.pp_rank)])
        return lay.dp_rank, float(col.allreduce(mine, lay.pp_group)[0])

    for dp_rank, total in run_mesh(MeshConfig(dp=2, pp=2), rank):
        assert total == dp_rank * 20 + 1
