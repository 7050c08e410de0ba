"""The port's pipelined GPT-2 (ray_tpu_torch.models.gpt2.forward_pipelined,
value_and_grad_pipelined, loss_fn(pipelined=True)) and its pipelined train
step against the JAX package's forward_pipelined at pp = 2 and at pp = 2
x sp = 2, on gpt2_tiny weights made by the JAX gpt2.init and carried
across with convert.params_from_jax. The port's ranks are threads of this
process (tests/torch_gang.run_mesh); the JAX oracles are computed once a
module. Tolerances: f32 as test_parallel.py's own f32 tests, bf16 as
test_gpt2_pipelined_pp_sp_joint_training's bounds."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as JG
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig, create_mesh
from ray_tpu_torch import convert
from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.parallel import train_step as TT
from ray_tpu_torch.parallel.mesh import MeshConfig
from ray_tpu_torch.parallel.ring_attention import shard_bounds
from ray_tpu_torch.util import collective as col
from tests.torch_gang import run_mesh

B, S, M = 8, 32, 4
LAYOUTS = {"pp2": (MeshConfig(pp=2), JMeshConfig(dp=2, pp=2, tp=2)),
           "pp2sp2": (MeshConfig(pp=2, sp=2), JMeshConfig(dp=2, pp=2, sp=2))}
# (logits atol, loss atol, grads atol and rtol)
TOL = {"float32": (1e-4, 1e-5, 1e-4), "bfloat16": (2e-2, 2e-3, 5e-2)}
CASES = [(dt, lay) for dt in TOL for lay in LAYOUTS]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Rank threads share the box with other test workers: two intra-op
    threads each while this file runs."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _cfgs(dtype):
    jcfg = dataclasses.replace(JG.gpt2_tiny(), dtype=jnp.dtype(dtype))
    tcfg = dataclasses.replace(TG.gpt2_tiny(), dtype=getattr(torch, dtype))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def setup():
    jcfg, _ = _cfgs("float32")
    params = jax.tree.map(np.asarray, JG.init(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    return params, tokens


@pytest.fixture(scope="module")
def oracles(setup):
    """Per (dtype, layout): JAX's pipelined logits, the value and grads of
    mean(logits ** 2) (test_parallel.py:217-247) and the next-token loss
    of those logits as loss_fn(pipelined=True) computes it
    (ray_tpu/models/gpt2.py:304-306), from the same forward."""
    params, tokens = setup
    out = {}
    for dtype, name in CASES:
        jcfg, _ = _cfgs(dtype)
        mesh = create_mesh(LAYOUTS[name][1])

        def f(p, t, cfg=jcfg, mesh=mesh):
            logits, _ = JG.forward_pipelined(p, t[:, :-1], cfg, mesh,
                                             n_microbatches=M)
            lse = jax.scipy.special.logsumexp(logits, axis=-1)
            tl = jnp.take_along_axis(logits, t[:, 1:, None], axis=-1)[..., 0]
            ce = jnp.mean(lse - tl)
            return jnp.mean(logits.astype(jnp.float32) ** 2), (logits, ce)

        with jax.set_mesh(mesh):
            (value, (logits, ce)), grads = jax.jit(
                jax.value_and_grad(f, has_aux=True))(params, tokens)
        out[dtype, name] = (np.asarray(logits, np.float32), float(value),
                            jax.tree.map(np.asarray, grads), float(ce))
    return out


def _rank_params(params, lay, device="cpu"):
    return tree_map(lambda t: t.requires_grad_(True), convert.stage_params(
        convert.params_from_jax(params, device), lay.pp_rank, lay.pp))


def _summed(value, lay):
    """A last-stage rank's part of a loss summed over its sp group."""
    if lay.sp > 1:
        value = col.allreduce(value, lay.sp_group)
    return float(value)


@pytest.mark.parametrize("dtype,name", CASES)
def test_logits_and_grads_match_jax(setup, oracles, dtype, name):
    """Each last-stage rank's logits for its shard of the sequence, the
    value of mean(logits ** 2) summed over the shards, and every rank's
    gradient of it (block leaves: its stage's slice; the embedding and
    final LayerNorm whole) against JAX's forward_pipelined and
    value_and_grad on the same weights and tokens."""
    params, tokens = setup
    _, tcfg = _cfgs(dtype)
    logits_w, value_w, grads_w, _ = oracles[dtype, name]
    atol_logits, atol_loss, tol_grads = TOL[dtype]
    n_logits = B * S * tcfg.vocab_size

    def rank(lay):
        rp = _rank_params(params, lay)
        fwd = TG.forward_pipelined(rp, torch.from_numpy(tokens[:, :-1]),
                                   tcfg, lay, n_microbatches=M)
        part = value = logits = None
        if lay.is_last_stage:
            part = (fwd.logits.float() ** 2).sum() / n_logits
            value = _summed(part.detach(), lay)
            logits = fwd.logits.detach().float().numpy()
        grads = fwd.backward(part)
        return lay, logits, value, tree_map(
            lambda g: g.detach().float().numpy(), grads)

    per = tcfg.n_layer // LAYOUTS[name][0].pp
    for lay, logits, value, grads in run_mesh(
            LAYOUTS[name][0], rank):
        if lay.is_last_stage:
            lo, hi = shard_bounds(S, lay.sp, lay.sp_rank)
            np.testing.assert_allclose(logits, logits_w[:, lo:hi],
                                       atol=atol_logits)
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


@pytest.mark.parametrize("dtype,name", CASES)
def test_next_token_loss_matches_jax(setup, oracles, dtype, name):
    """loss_fn(pipelined=True) and value_and_grad_pipelined give every rank
    the mean next-token loss over the whole batch and sequence, as JAX's
    loss_fn(pipelined=True) computes it."""
    params, tokens = setup
    _, tcfg = _cfgs(dtype)
    want = oracles[dtype, name][3]
    batch = {"tokens": torch.from_numpy(tokens)}

    def rank(lay):
        rp = _rank_params(params, lay)
        total, metrics = TG.loss_fn(rp, batch, tcfg, lay, pipelined=True,
                                    n_microbatches=M)
        (total2, _), _ = TG.value_and_grad_pipelined(rp, batch, tcfg, lay,
                                                     n_microbatches=M)
        assert float(metrics["aux_loss"]) == 0.0
        return float(total), float(metrics["loss"]), float(total2)

    for values in run_mesh(LAYOUTS[name][0], rank):
        np.testing.assert_allclose(values, [want] * 3, atol=TOL[dtype][1])


def test_sequence_shards_take_their_global_positions(setup):
    """At sp 2 (pp 1), the second shard's logits are the one-rank
    forward's for the second half of the sequence (wpe at the shard's
    global positions, not at wpe[:S_local]), and the loss is the mean
    over the whole sequence, each shard's sum over B * S."""
    params, tokens = setup
    _, tcfg = _cfgs("float32")
    full = convert.params_from_jax(params, "cpu")
    with torch.no_grad():
        want_logits, _ = TG.forward(full, torch.from_numpy(tokens[:, :-1]),
                                    tcfg)
        want_loss, _ = TG.loss_fn(full, {"tokens": torch.from_numpy(tokens)},
                                  tcfg)

    def rank(lay):
        rp = _rank_params(params, lay)
        with torch.no_grad():
            fwd = TG.forward_pipelined(rp, torch.from_numpy(tokens[:, :-1]),
                                       tcfg, lay, n_microbatches=M)
            loss, _ = TG.loss_fn(rp, {"tokens": torch.from_numpy(tokens)},
                                 tcfg, lay, pipelined=True, n_microbatches=M)
        return lay.sp_rank, fwd.logits.numpy(), float(loss)

    for i, logits, loss in run_mesh(MeshConfig(sp=2), rank):
        lo, hi = shard_bounds(S, 2, i)
        np.testing.assert_allclose(logits, want_logits[:, lo:hi].numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(loss, float(want_loss), rtol=1e-6)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_train_step_matches_the_one_rank_step(setup, name):
    """Two pipelined steps (the first at lr 0, as optax reads the schedule
    before its count moves) against make_train_step on one rank, f32:
    the loss, the global grad norm and the params reassembled from the
    stages, within 1e-5."""
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
        pstep = TT.make_pipelined_train_step(tcfg, o, lay, n_microbatches=M)
        got = []
        for batch in batches:
            st, m = pstep(st, batch)
            got.append((float(m["loss"]), float(m["grad_norm"])))
        return lay, got, st.params

    ranks = run_mesh(LAYOUTS[name][0], rank)
    for lay, got, _ in ranks:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    for sp_rank in range(ranks[0][0].sp):
        stages = [p for lay, _, p in ranks if lay.sp_rank == sp_rank]
        joined = convert.join_stages(stages)
        for a, b in zip(tree_leaves(joined), tree_leaves(state.params)):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(), atol=1e-5)


def test_no_collective_runs_inside_autograd_backward(setup, monkeypatch):
    """Every collective call of a pp 2 x sp 2 train step runs outside any
    autograd backward (graph task id -1). On a CUDA device autograd runs
    every graph's backward on one thread per device, so a collective
    blocked there would starve the peer it waits for. The probe does see
    a backward: inside a Function's backward the id is not -1."""
    params, tokens = setup
    _, tcfg = _cfgs("float32")
    calls, lock = [], threading.Lock()
    for op in ("allgather", "allgather_async", "allreduce",
               "allreduce_async", "barrier", "broadcast", "recv",
               "reducescatter", "reducescatter_async", "send", "sendrecv"):
        def probed(*a, _op=op, _fn=getattr(col, op), **kw):
            with lock:
                calls.append((_op, torch._C._current_graph_task_id()))
            return _fn(*a, **kw)
        monkeypatch.setattr(col, op, probed)

    def rank(lay):
        o = TT.default_optimizer(1e-3, warmup_steps=1, total_steps=10)
        st = TT.make_train_state(
            lambda g: convert.stage_params(
                convert.params_from_jax(params, "cpu"), lay.pp_rank, lay.pp),
            torch.Generator(), o, device="cpu")
        TT.make_pipelined_train_step(tcfg, o, lay, n_microbatches=M)(
            st, {"tokens": torch.from_numpy(tokens)})

    run_mesh(MeshConfig(pp=2, sp=2), rank)
    assert {op for op, _ in calls} >= {"allreduce", "allreduce_async",
                                       "broadcast", "recv", "send",
                                       "sendrecv"}
    assert [c for c in calls if c[1] != -1] == []

    seen = []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            seen.append(torch._C._current_graph_task_id())
            return g

    Probe.apply(torch.ones(2, requires_grad=True)).sum().backward()
    assert seen and seen[0] != -1


def test_remat_with_sp_is_refused(setup):
    """remat at sp 2 is no longer refused: each layer is a checkpointed
    region of the stage's tape, whose recompute replays the ring's
    forward rather than run it again, and whose backward runs the ring's
    between autograd calls. Its metrics and every rank's grads are the
    same bits as remat off, in f32 on the CPU."""
    params, tokens = setup
    _, tcfg = _cfgs("float32")

    def rank(lay):
        out = []
        for remat in (False, True):
            cfg = dataclasses.replace(tcfg, remat=remat)
            metrics, grads = TT.pipelined_grads(
                _rank_params(params, lay), {"tokens": torch.from_numpy(
                    tokens)}, cfg, lay, n_microbatches=M)
            out.append(({k: float(v) for k, v in metrics.items()},
                        tree_leaves(grads)))
        return out

    for (m_off, g_off), (m_on, g_on) in run_mesh(MeshConfig(sp=2), rank):
        assert m_on == m_off
        assert all(torch.equal(a, b) for a, b in zip(g_on, g_off,
                                                     strict=True))


def test_stage_params_round_trip(setup):
    """stage_params cuts the block leaves as JAX's [pp, L / pp, ...]
    reshape does, into copies; join_stages puts them back."""
    params, _ = setup
    full = convert.params_from_jax(params, "cpu")
    stages = [convert.stage_params(full, p, 2) for p in range(2)]
    wq = params["blocks"]["attn"]["wq"]
    staged = wq.reshape((2, wq.shape[0] // 2) + wq.shape[1:])
    for p in range(2):
        np.testing.assert_array_equal(
            stages[p]["blocks"]["attn"]["wq"].numpy(), staged[p])
        assert (stages[p]["wte"].data_ptr() != full["wte"].data_ptr())
    for a, b in zip(tree_leaves(convert.join_stages(stages)),
                    tree_leaves(full)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="not divisible"):
        convert.stage_params(full, 0, 3)
