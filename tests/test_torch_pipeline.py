"""The port's GPipe schedule (ray_tpu_torch.parallel.pipeline), its rank
layout (parallel.mesh) and its point-to-point collectives
(util.collective) against the JAX package's, with pipeline stages as
threads of this process (tests/torch_gang.py). The JAX oracle is computed
once a module."""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ray_tpu.models import gpt2 as JG
from ray_tpu.models.layers import MoEConfig as JMoEConfig
from ray_tpu.parallel import pipeline as JP
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig, create_mesh
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.models.layers import MoEConfig
from ray_tpu_torch.parallel import mesh as M
from ray_tpu_torch.parallel import pipeline as TP
from ray_tpu_torch.util import collective as col
from tests.torch_gang import run_gang, run_mesh


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Rank threads share the box with other test workers: two intra-op
    threads each while this file runs."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


# ------------------------------------------------------------------ GPipe
def _stage_inputs():
    """The stage function and shapes of tests/test_parallel.py:148: two
    stages of tanh(x @ w), w [8, 8], x [16, 8] in 4 microbatches."""
    rng = np.random.default_rng(5)
    ws = (rng.standard_normal((2, 8, 8)) * 0.1).astype(np.float32)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    return ws, x


@pytest.fixture(scope="module")
def gpipe_oracle():
    """JAX's gpipe outputs, and jax.grad of sum(y ** 2) with respect to the
    stacked params and x, on the mesh of test_parallel.py:149."""
    ws, x = _stage_inputs()
    mesh = create_mesh(JMeshConfig(dp=2, pp=2, tp=2))

    def stage_fn(p, x):
        return jnp.tanh(x @ p["w"])

    with jax.set_mesh(mesh):
        st = jax.device_put({"w": ws}, NamedSharding(mesh, P("pp")))

        def loss(s, x):
            y = JP.gpipe(stage_fn, s, JP.microbatch(x, 4), mesh)
            return jnp.sum(y ** 2), y

        (_, y), (gw, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(st, x)
    return (np.asarray(JP.unmicrobatch(y)), np.asarray(gw["w"]),
            np.asarray(gx))


@pytest.mark.parametrize("replicate", [True, False])
def test_gpipe_matches_jax(gpipe_oracle, replicate):
    """Forward (atol 1e-5) and the explicit backward schedule's grads of
    sum(y ** 2) for each stage's w and for the microbatches, against
    jax.grad through the JAX scan. With ``replicate`` the last stage's
    outputs reach every stage, as JAX's psum replicates them."""
    ws, x = _stage_inputs()
    y_want, gw_want, gx_want = gpipe_oracle

    def rank(lay):
        stacked = {"w": torch.from_numpy(ws).requires_grad_()}
        mb = TP.microbatch(torch.from_numpy(x), 4)
        run = TP.gpipe(lambda p, x, tape: torch.tanh(x @ p["w"]), stacked,
                       mb, lay, replicate=replicate)
        y = run.outputs
        g_mb, grads = run.backward(None if y is None else 2 * y)
        return (None if y is None else TP.unmicrobatch(y).detach().numpy(),
                grads["w"].numpy(),
                None if g_mb is None else TP.unmicrobatch(g_mb).numpy())

    outs = run_mesh(M.MeshConfig(pp=2), rank)
    for stage, (y, gw, g_mb) in enumerate(outs):
        if replicate or stage == 1:
            np.testing.assert_allclose(y, y_want, atol=1e-5)
        else:
            assert y is None
        np.testing.assert_allclose(gw, gw_want[stage], atol=1e-5)
        assert (g_mb is None) == (stage == 1)
    np.testing.assert_allclose(outs[0][2], gx_want, atol=1e-5)


def test_gpipe_without_grad_keeps_nothing():
    """Under no_grad the run saves no graph, and its backward refuses."""
    ws, x = _stage_inputs()

    def rank(lay):
        with torch.no_grad():
            run = TP.gpipe(lambda p, x, tape: torch.tanh(x @ p["w"]),
                           {"w": torch.from_numpy(ws)},
                           TP.microbatch(torch.from_numpy(x), 4), lay)
        assert not run.outputs.requires_grad
        with pytest.raises(RuntimeError, match="nothing to differentiate"):
            run.backward(None)
        return run.outputs.numpy()

    a, b = run_mesh(M.MeshConfig(pp=2), rank)
    np.testing.assert_array_equal(a, b)


def test_microbatch_round_trip_matches_jax():
    x = np.arange(6 * 3 * 2, dtype=np.float32).reshape(6, 3, 2)
    mb = TP.microbatch(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(mb.numpy(),
                                  np.asarray(JP.microbatch(x, 3)))
    np.testing.assert_array_equal(TP.unmicrobatch(mb).numpy(), x)
    for fn in (TP.microbatch, JP.microbatch):
        with pytest.raises(ValueError, match="not divisible"):
            fn(x if fn is JP.microbatch else torch.from_numpy(x), 4)


def test_stack_stage_params_matches_jax():
    rng = np.random.default_rng(7)
    stages = [{"a": {"w": rng.standard_normal((2, 3)).astype(np.float32)},
               "b": rng.standard_normal(4).astype(np.float32)}
              for _ in range(3)]
    want = JP.stack_stage_params(stages)
    got = TP.stack_stage_params(
        [{"a": {"w": torch.from_numpy(s["a"]["w"])},
          "b": torch.from_numpy(s["b"])} for s in stages])
    np.testing.assert_array_equal(got["a"]["w"].numpy(),
                                  np.asarray(want["a"]["w"]))
    np.testing.assert_array_equal(got["b"].numpy(), np.asarray(want["b"]))


def test_stage_tape_matches_one_autograd_call():
    """Cuts between autograd segments change nothing: the tape's grads of
    a chain with a cut at every step are autograd's through the chain."""
    rng = np.random.default_rng(8)
    x0 = torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32))
    ws = [torch.from_numpy(rng.standard_normal((5, 5)).astype(np.float32))
          .requires_grad_() for _ in range(3)]

    def chain(x, tape=None):
        for w in ws:
            x = tape.cut(x) if tape is not None else x
            x = torch.tanh(x @ w) + x
        return x

    x = x0.clone().requires_grad_()
    want = torch.autograd.grad(chain(x).square().sum(), [x] + ws)
    x = x0.clone().requires_grad_()
    tape = TP.StageTape()
    y = chain(x, tape)
    (gx,), gws = tape.backward(y, 2 * y.detach(), [x], ws)
    for g, w in zip([gx] + gws, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6)


# --------------------------------------------------------------- refusals
def _refusal_cfgs(kind):
    if kind == "moe":
        common = dict(vocab_size=128, max_seq=64, n_layer=2, n_head=2,
                      d_model=32, remat=False)
        return (JG.GPT2Config(moe=JMoEConfig(), **common),
                TG.GPT2Config(moe=MoEConfig(), **common), 2)
    common = dict(vocab_size=256, max_seq=128, n_layer=3, n_head=4,
                  d_model=64, remat=False)
    return JG.GPT2Config(**common), TG.GPT2Config(**common), 2


@pytest.mark.parametrize("kind,error,match", [
    ("moe", NotImplementedError, "MoE aux loss"),
    ("n_layer", ValueError, "not divisible by pp=2")])
def test_pipelined_forward_refusals_on_both_packages(kind, error, match):
    """The JAX forward_pipelined and the port's refuse the same configs
    (ray_tpu/models/gpt2.py:231-242), before any stage runs."""
    jcfg, tcfg, pp = _refusal_cfgs(kind)
    tokens = np.zeros((4, 16), np.int32)
    mesh = create_mesh(JMeshConfig(dp=2, pp=pp, tp=2))
    with jax.set_mesh(mesh), pytest.raises(error, match=match):
        JG.forward_pipelined({}, jnp.asarray(tokens), jcfg, mesh)

    def rank(lay):
        with pytest.raises(error, match=match):
            TG.forward_pipelined({}, torch.from_numpy(tokens), tcfg, lay)
        return True

    assert all(run_mesh(M.MeshConfig(pp=pp), rank))


# ------------------------------------------------------------------ layout
@pytest.mark.parametrize("axis", ["dp", "tp", "ep"])
def test_mesh_config_refuses_unported_axes(axis):
    """dp, tp and ep are ported, and a dp, a tp or an ep of 2 doubles the
    ranks of a layout; MoE at pp 2 with ep 2, which the JAX twin refuses,
    is refused by the forward with its message, before any collective."""
    if axis == "dp":
        assert M.MeshConfig(dp=2, pp=2).world_size == 4
    elif axis == "tp":
        assert M.MeshConfig(tp=2).world_size == 2
    else:
        assert M.MeshConfig(ep=2).world_size == 2
        config = M.MeshConfig(pp=2, ep=2)
        lay = M.RankLayout(config, 0, 0, 0, 0, "dp", "pp", "sp", 0, "tp", 0,
                           "ep")
        cfg = dataclasses.replace(TG.gpt2_tiny(), moe=MoEConfig())
        with pytest.raises(NotImplementedError, match="use pp=1 with MoE"):
            TG.forward_pipelined({}, torch.zeros(2, 4, dtype=torch.int32),
                                 cfg, lay)
    M.MeshConfig(**{axis: 1})


def test_layout_follows_the_jax_mesh_order():
    """A global rank's (pp, sp) coordinates are its device's place on the
    JAX mesh of the same sizes, and its groups hold the ranks that share
    its other coordinate."""
    cfg = M.MeshConfig(pp=2, sp=4)
    devices = np.asarray(create_mesh(JMeshConfig(pp=2, sp=4)).devices)
    layouts = run_mesh(cfg, lambda lay: (
        lay.pp_rank, lay.sp_rank, col.get_rank(lay.pp_group),
        col.get_collective_group_size(lay.pp_group),
        col.get_rank(lay.sp_group),
        col.get_collective_group_size(lay.sp_group),
        [int(t) for t in col.allgather(torch.tensor([lay.rank]),
                                       lay.sp_group)]))
    for rank, (p, s, pp_r, pp_n, sp_r, sp_n, sp_members) in enumerate(
            layouts):
        assert devices[0, p, 0, s, 0].id == rank
        assert (pp_r, pp_n, sp_r, sp_n) == (p, 2, s, 4)
        assert sp_members == [p * 4 + i for i in range(4)]


# ---------------------------------------------------------- point to point
def test_send_recv_round_trips():
    """Tensors of several dtypes and ranks arrive whole and in order on
    each channel; recv needs no shape."""
    sent = [torch.arange(6, dtype=torch.bfloat16).view(2, 3),
            torch.randn(2, 3, 4, generator=torch.Generator().manual_seed(0)),
            torch.tensor(7, dtype=torch.int64),
            torch.ones(0, 5)]

    def rank(r, group):
        if r == 0:
            for t in sent:
                col.send(t, 1, group)
            return col.recv(1, group)
        got = [col.recv(0, group) for _ in sent]
        col.send(torch.tensor([3.5]), 0, group)
        return got

    back, got = run_gang(2, rank)
    assert back.tolist() == [3.5]
    for a, b in zip(got, sent):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_sendrecv_ring_broadcast_and_barrier():
    """One ring hop at world 4 moves rank i's tensor to rank i + 1; a
    broadcast returns the root's tensor everywhere."""
    def rank(r, group):
        got = col.sendrecv(torch.full((3,), float(r)), (r + 1) % 4,
                           (r - 1) % 4, group)
        b = col.broadcast(torch.full((2,), 9.0) if r == 2 else
                          torch.zeros(2), 2, group)
        col.barrier(group)
        return got.tolist(), b.tolist()

    for r, (got, b) in enumerate(run_gang(4, rank)):
        assert got == [float((r - 1) % 4)] * 3
        assert b == [9.0, 9.0]


def test_recv_times_out_when_its_peer_never_sends():
    """A receive whose peer is alive but never sends fails after the
    group's timeout; it never hangs."""
    done = threading.Event()

    def rank(r, group):
        if r == 0:  # stays in the group, silent, until rank 1 gave up
            assert done.wait(30)
            return None
        t0 = time.monotonic()
        try:
            with pytest.raises(RuntimeError, match="[Tt]imed out"):
                col.recv(0, group)
        finally:
            done.set()
        return time.monotonic() - t0

    _, waited = run_gang(2, rank, timeout_s=1.0, join_timeout_s=60.0)
    assert 0.5 <= waited < 20


def test_send_refuses_the_quantized_wire():
    def rank(r, group):
        with pytest.raises(NotImplementedError, match="wire_dtype"):
            col.send(torch.ones(2), 1 - r, group, wire_dtype="bf16")
        return True

    assert all(run_gang(2, rank))
