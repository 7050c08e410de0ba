"""The port's mesh entry point beyond the train step: eval_step(loss_fn,
mesh, batch_spec) and gpt2.forward(..., mesh) at dp 2 x sp 2 x tp 2
against the JAX package's eval_step and forward on create_mesh of the
same sizes (gpt2_tiny, f32, test_torch_gpt2_pipelined.py's TOL); a mesh
of one rank, whose train step is the same bits as without a mesh;
attention="ring" (the ring over global arrays at sp 2, plain attention
at sp 1); a loss function that is not GPT-2's, differentiated by
autograd at dp alone and refused at tp; closures that change
gpt2.loss_fn's loss or its params, refused; and the batch specs and hooks
the port refuses. The port's ranks are threads of this process over one
HashStore (tests/torch_gang.run_on_mesh), torch at two intra-op threads,
and every group and join has a timeout."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from ray_tpu.models import gpt2 as JG
from ray_tpu.parallel import train_step as JT
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig, create_mesh
from ray_tpu_torch import convert
from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.models import layers as TL
from ray_tpu_torch.parallel import mesh as M
from ray_tpu_torch.parallel import train_step as TT
from tests.test_torch_gpt2_pipelined import TOL, _cfgs, two_threads  # noqa: F401
from tests.torch_gang import run_on_mesh

B, S = 8, 32
SIZES = dict(dp=2, sp=2, tp=2)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup():
    """gpt2_tiny's f32 params from the JAX init (jitted) and tokens."""
    jcfg, _ = _cfgs("float32")
    params = jax.tree.map(np.asarray, jax.jit(JG.init, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    tokens = np.array(jax.random.randint(
        jax.random.PRNGKey(1), (B, S + 1), 0, jcfg.vocab_size), np.int32)
    return params, tokens


def _mesh(sizes):
    return M.create_mesh(M.MeshConfig(**sizes),
                         devices=[CPU] * int(np.prod(list(sizes.values()))))


def test_eval_step_and_forward_match_jax(setup):
    """eval_step(loss_fn, mesh) given the global batch: the metrics on
    every rank against JAX's eval_step on its mesh; forward(..., layout)
    given a replica's rows: the rows' logits, put back together over sp
    and tp on every rank, against JAX's forward(..., mesh)."""
    params, tokens = setup
    jcfg, tcfg = _cfgs("float32")
    jmesh = create_mesh(JMeshConfig(**SIZES))
    with jax.set_mesh(jmesh):
        p = jax.tree.map(lambda x, s: jax.device_put(
            x, NamedSharding(jmesh, s)), params, JG.partition_specs(jcfg))
        want = JT.eval_step(lambda p, b: JG.loss_fn(p, b, jcfg, jmesh),
                            jmesh)(p, {"tokens": tokens})
        want = {k: float(v) for k, v in want.items()}
        logits_w, _ = jax.jit(lambda p, t: JG.forward(p, t, jcfg, jmesh))(
            p, tokens[:, :-1])
        logits_w = np.asarray(logits_w, np.float32)
    batch = {"tokens": torch.from_numpy(tokens)}

    def rank(lay):
        state = TT.make_train_state(
            lambda g: convert.params_from_jax(params, "cpu"), None,
            TT.default_optimizer(), lay, TG.partition_specs(tcfg))
        got = TT.eval_step(lambda p, b: TG.loss_fn(p, b, tcfg, lay), lay)(
            state.params, batch)
        rows = TT.batch_rows(batch, lay)["tokens"][:, :-1]
        logits, _ = TG.forward(state.params, rows, tcfg, lay)
        return lay, {k: float(v) for k, v in got.items()}, logits.numpy()

    atol_logits, atol_loss, _ = TOL["float32"]
    for lay, got, logits in run_on_mesh(_mesh(SIZES), rank, name="eval"):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=atol_loss,
                                       err_msg=k)
        rows = slice(lay.dp_rank * B // 2, (lay.dp_rank + 1) * B // 2)
        np.testing.assert_allclose(logits, logits_w[rows], atol=atol_logits)


def test_one_rank_mesh_is_the_plain_step(setup):
    """make_train_step on a single_device_mesh, and on the layout it
    joins, gives the same bits as with no mesh: two steps' metrics and
    the params after them."""
    params, tokens = setup
    _, tcfg = _cfgs("float32")
    batch = {"tokens": torch.from_numpy(tokens)}
    mesh = M.single_device_mesh("cpu")
    lay = mesh.join(0)
    try:
        runs = []
        for where in (None, mesh, lay):
            opt = TT.default_optimizer(1e-2, warmup_steps=1, total_steps=10)
            state = TT.make_train_state(
                lambda g: convert.params_from_jax(params, "cpu"), None, opt,
                where, TG.partition_specs(tcfg), device="cpu")
            step = TT.make_train_step(
                lambda p, b: TG.loss_fn(p, b, tcfg, where), opt, where)
            metrics = []
            for _ in range(2):
                state, m = step(state, batch)
                metrics.append({k: float(v) for k, v in m.items()})
            runs.append((metrics, tree_leaves(state.params)))
    finally:
        M.destroy_rank_layout(lay)
    for metrics, leaves in runs[1:]:
        assert metrics == runs[0][0]
        assert all(torch.equal(a, b) for a, b in zip(leaves, runs[0][1],
                                                     strict=True))


def test_ring_attention_impl():
    """apply_attention's "ring" over an sp group of 2, given the whole
    sequence, is the ring over global arrays: each rank's output is plain
    attention's on the whole sequence; with gradients it is refused (a
    stage runs "ring_local" on its tape). At sp 1 it is plain attention,
    and GPT2Config(attention="ring") trains on one device."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 16, 32)).astype(np.float32))
    params = TL.init_attention(torch.Generator().manual_seed(0), 32, 4,
                               device="cpu")

    def rank(lay):
        with torch.no_grad():
            out = TL.apply_attention(params, x, impl="ring",
                                     compute_dtype=torch.float32,
                                     sp_group=lay.sp_group)
        with pytest.raises(ValueError, match="ring_local"):
            TL.apply_attention(params, x.clone().requires_grad_(True),
                               impl="ring", compute_dtype=torch.float32,
                               sp_group=lay.sp_group)
        return out

    want = TL.apply_attention(params, x, impl="reference",
                              compute_dtype=torch.float32)
    for out in run_on_mesh(_mesh(dict(sp=2)), rank, name="ring"):
        np.testing.assert_allclose(out.numpy(), want.detach().numpy(),
                                   atol=1e-5)
    assert torch.equal(TL.apply_attention(params, x, impl="ring"),
                       TL.apply_attention(params, x, impl="reference"))
    _, tcfg = _cfgs("float32")
    cfg = TG.GPT2Config(**{**tcfg.__dict__, "attention": "ring"})
    p = TG.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (2, 9)).astype(np.int32))
    state = TT.make_train_state(lambda g: p, None, TT.default_optimizer(),
                                device="cpu")
    _, m = TT.make_train_step(lambda q, b: TG.loss_fn(q, b, cfg),
                              TT.default_optimizer())(state,
                                                      {"tokens": tokens})
    assert np.isfinite(float(m["loss"]))


def _linear_loss(p, b):
    pred = b["x"] @ p["w"]
    loss = ((pred - b["y"]) ** 2).mean()
    return loss, {"loss": loss}


def test_a_loss_that_is_not_gpt2s():
    """A loss function that hands no gradient over is differentiated by
    autograd on its replica's rows at dp 2, averaged over dp: the step
    is the one-device step on the whole batch (f32 reassociation). At
    tp 2 it is refused after its forward, before any backward."""
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for k, shape in (("x", (8, 4)), ("y", (8, 3)))}
    w = rng.standard_normal((4, 3)).astype(np.float32)

    def run(where):
        opt = TT.default_optimizer(1e-1, warmup_steps=1, total_steps=10)
        state = TT.make_train_state(
            lambda g: {"w": torch.from_numpy(w.copy())}, None, opt, where,
            device="cpu")
        step = TT.make_train_step(_linear_loss, opt, where,
                                  batch_spec=(("dp",), None))
        for _ in range(2):
            state, m = step(state, batch)
        return float(m["loss"]), float(m["grad_norm"]), state.params["w"]

    loss, norm, w_one = run(None)
    for got in run_on_mesh(_mesh(dict(dp=2)), run, name="lin"):
        np.testing.assert_allclose(got[:2], (loss, norm), rtol=1e-6)
        np.testing.assert_allclose(got[2].detach().numpy(),
                                   w_one.detach().numpy(), atol=1e-6)

    def refused(lay):
        with pytest.raises(ValueError, match="schedule"):
            run(lay)
        return True

    assert all(run_on_mesh(_mesh(dict(tp=2)), refused, name="lintp"))


@pytest.mark.parametrize("change", ["add_term", "scale", "other_params"])
def test_a_closure_that_changes_gpt2s_loss_is_refused(setup, change):
    """On a layout the gradient is the one gpt2.loss_fn's schedule
    computed for its own total, so a closure that returns another loss
    (GPT-2's plus an L2 term, or scaled), or hands loss_fn other params
    than the state's, is refused rather than given GPT-2's bare
    gradient."""
    params, tokens = setup
    _, tcfg = _cfgs("float32")
    batch = {"tokens": torch.from_numpy(tokens)}

    def l2(p):
        return sum((x.float() ** 2).sum() for x in tree_leaves(p))

    def rank(lay):
        def loss(p, b):
            if change == "other_params":
                p = tree_map(lambda t: t.detach().clone().requires_grad_(
                    True), p)
            total, m = TG.loss_fn(p, b, tcfg, lay)
            if change == "add_term":
                return total + 1e-4 * l2(p), m
            if change == "scale":
                return 2.0 * total, m
            return total, m

        opt = TT.default_optimizer()
        state = TT.make_train_state(
            lambda g: convert.params_from_jax(params, "cpu"), None, opt,
            lay, TG.partition_specs(tcfg))
        with pytest.raises(ValueError, match="loss function"):
            TT.make_train_step(loss, opt, lay)(state, batch)
        return True

    assert all(run_on_mesh(_mesh(dict(dp=2)), rank, name=f"chg{change}"))


def test_refusals():
    """On a layout of several ranks: a batch spec that does not cut the
    rows over dp, or names another axis, and the gang's host hooks are
    refused before any step; a Mesh of several ranks is refused where a
    rank's layout is wanted."""
    mesh = _mesh(dict(dp=2, tp=2))

    def rank(lay):
        opt = TT.default_optimizer()
        for spec in ((None, "sp"), (("tp",), None), (("dp",), "tp"),
                     (("dp",), None, "sp")):
            with pytest.raises(ValueError, match="batch_spec"):
                TT.make_train_step(_linear_loss, opt, lay, batch_spec=spec)
        with pytest.raises(ValueError, match="batch_spec"):
            TT.eval_step(_linear_loss, lay, batch_spec=(None, "sp"))(
                {}, {"x": torch.zeros(4, 1)})
        with pytest.raises(ValueError, match="host_grad_sync"):
            TT.make_train_step(_linear_loss, opt, lay,
                               host_grad_sync=lambda g: g)
        return True

    assert all(run_on_mesh(mesh, rank, name="refuse"))
    for fn in (lambda: TT.make_train_step(_linear_loss, None, mesh),
               lambda: TT.make_train_state(lambda g: {}, None, None, mesh),
               lambda: TG.loss_fn({}, {"tokens": torch.zeros(2, 3)},
                                  TG.gpt2_tiny(), mesh)):
        with pytest.raises(TypeError, match="join"):
            fn()
