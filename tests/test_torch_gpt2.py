"""The port's GPT-2 and training step (ray_tpu_torch.models.gpt2,
ray_tpu_torch.parallel.train_step) against the JAX package's, on weights
made by the JAX ``gpt2.init`` and carried across with
``convert.params_from_jax`` (jax.random streams cannot be reproduced in
torch). Tiny config: 2 layers, d 64, 4 heads, vocab 256, seq 64."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as JG
from ray_tpu.parallel import train_step as JT
from ray_tpu_torch._private.tree import tree_leaves
from ray_tpu_torch.convert import params_from_jax, params_to_numpy
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.parallel import train_step as TT

B, S = 2, 64


def _cfgs(dtype="float32", attention="flash", remat=False):
    common = dict(vocab_size=256, max_seq=S, n_layer=2, n_head=4, d_model=64,
                  remat=remat, attention=attention)
    return (JG.GPT2Config(dtype=jnp.dtype(dtype), **common),
            TG.GPT2Config(dtype=getattr(torch, dtype), **common))


def _tokens(seed, batch=B):
    return np.random.default_rng(seed).integers(0, 256, (batch, S + 1)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, JG.init(jax.random.PRNGKey(0), jcfg))


@pytest.mark.parametrize("remat", [False, True])
def test_forward_loss_and_grads_match_jax(jax_params, remat):
    """f32 compute, flash attention on both sides (Pallas in interpret mode
    against the port's plain kernel versions): the algorithm. remat is
    jax.checkpoint on one side and torch.utils.checkpoint on the other."""
    jcfg, tcfg = _cfgs(remat=remat)
    tok = _tokens(1)
    logits_j, _ = JG.forward(jax_params, jnp.asarray(tok[:, :-1]), jcfg)
    (loss_j, _), grads_j = jax.value_and_grad(
        lambda p: JG.loss_fn(p, {"tokens": jnp.asarray(tok)}, jcfg),
        has_aux=True)(jax_params)

    params = params_from_jax(jax_params, "cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    logits_t, aux = TG.forward(params, torch.from_numpy(tok[:, :-1]), tcfg)
    loss_t, metrics = TG.loss_fn(params, {"tokens": torch.from_numpy(tok)}, tcfg)
    grads_t = torch.autograd.grad(loss_t, leaves)
    loss_t = loss_t.detach()

    assert logits_t.shape == (B, S, 256) and logits_t.dtype == torch.float32
    assert float(aux) == 0.0 and float(metrics["aux_loss"]) == 0.0
    # f32 through two blocks and the tied projection, other sum orders
    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-6)
    flat_j = jax.tree_util.tree_leaves(grads_j)
    assert len(flat_j) == len(grads_t)
    for gt, gj in zip(grads_t, flat_j):
        assert tuple(gt.shape) == gj.shape
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-6,
                                   rtol=1e-4)


def test_bf16_loss_matches_jax(jax_params):
    """bf16 compute (the default): the residual stream and every matmul
    output round to bf16 at slightly different points in the two
    frameworks, so the loss (~5.5) agrees to 1% rather than to f32."""
    jcfg, tcfg = _cfgs("bfloat16")
    tok = _tokens(2)
    loss_j, _ = JG.loss_fn(jax_params, {"tokens": jnp.asarray(tok)}, jcfg)
    loss_t, _ = TG.loss_fn(params_from_jax(jax_params, "cpu"),
                           {"tokens": torch.from_numpy(tok)}, tcfg)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-2)


def test_train_trajectory_matches_jax(jax_params):
    """Four steps of make_train_step on the same batches with
    default_optimizer(1e-3, warmup 2, total 10), f32 compute. Step 0 runs
    at lr 0, as optax reads the schedule before its count increments."""
    jcfg, tcfg = _cfgs()
    batches = [_tokens(10 + i) for i in range(4)]

    jopt = JT.default_optimizer(1e-3, warmup_steps=2, total_steps=10)
    jstate = JT.TrainState(step=jnp.zeros((), jnp.int32),
                           params=jax.tree.map(jnp.asarray, jax_params),
                           opt_state=jopt.init(jax_params))
    jstep = JT.make_train_step(lambda p, b: JG.loss_fn(p, b, jcfg), jopt,
                               donate=False)
    topt = TT.default_optimizer(1e-3, warmup_steps=2, total_steps=10)
    tstate = TT.make_train_state(lambda g: params_from_jax(jax_params, "cpu"),
                                 torch.Generator(), topt, device="cpu")
    tstep = TT.make_train_step(lambda p, b: TG.loss_fn(p, b, tcfg), topt)

    initial = params_to_numpy(tstate.params)
    for i, tok in enumerate(batches):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tok)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(tok)})
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5,
                                       err_msg=f"step {i} {key}")
        if i == 0:  # lr(0) == 0: only the moments moved
            for a, b in zip(tree_leaves(params_to_numpy(tstate.params)),
                            tree_leaves(initial)):
                np.testing.assert_array_equal(a, b)
    assert tstate.step == 4 and int(jstate.step) == 4
    assert tstate.opt_state["count"] == 4
    # Adam moves each weight by ~lr per step whatever the gradient's scale,
    # so the params differ by ~lr * (relative gradient error) ~ 1e-9
    for a, b in zip(tree_leaves(params_to_numpy(tstate.params)),
                    jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=1e-5)


def test_eval_step_matches_loss(jax_params):
    _, tcfg = _cfgs()
    params = params_from_jax(jax_params, "cpu")
    batch = {"tokens": torch.from_numpy(_tokens(3))}
    metrics = TT.eval_step(lambda p, b: TG.loss_fn(p, b, tcfg))(params, batch)
    loss, _ = TG.loss_fn(params, batch, tcfg)
    assert float(metrics["loss"]) == float(loss)
    assert not metrics["loss"].requires_grad


def test_schedule_matches_optax():
    import optax

    ours = TT.warmup_cosine_decay_schedule(1e-3, 2, 10)
    ref = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10)
    assert ours(0) == 0.0 and ours(1) == pytest.approx(5e-4)
    # optax evaluates in f32, ours in f64: a few f32 ulps apart
    for count in range(14):
        assert ours(count) == pytest.approx(float(ref(count)), rel=1e-5, abs=1e-12)


def test_convert_carries_bf16_bits():
    import ml_dtypes

    a = np.random.default_rng(4).standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
    tree = {"w": a, "inner": {"b": np.arange(4, dtype=np.float32)}}
    t = params_from_jax(tree, "cpu")
    assert t["w"].dtype == torch.bfloat16 and t["inner"]["b"].dtype == torch.float32
    assert (t["w"].view(torch.int16).numpy().view(np.uint16)
            == a.view(np.uint16)).all()
    back = params_to_numpy(t)
    np.testing.assert_array_equal(back["w"], a.astype(np.float32))
    np.testing.assert_array_equal(back["inner"]["b"], tree["inner"]["b"])


def test_init_shapes_dtypes_and_scales(jax_params):
    _, tcfg = _cfgs()
    params = TG.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    ours = params_to_numpy(params)
    flat_j, _ = jax.tree_util.tree_flatten_with_path(jax_params)
    flat_t = tree_leaves(ours)
    assert len(flat_j) == len(flat_t)
    for (path, a), b in zip(flat_j, flat_t):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    assert abs(ours["wte"].std() - 0.02) < 2e-3
    assert abs(ours["wpe"].std() - 0.01) < 1e-3
    assert abs(ours["blocks"]["attn"]["wq"].std() - 0.02) < 2e-3
    assert (ours["blocks"]["ln1"]["scale"] == 1).all()
    assert (ours["blocks"]["mlp"]["b1"] == 0).all()
    assert TG.gpt2_small().n_params == JG.gpt2_small().n_params


@pytest.mark.parametrize("cfg, device, expect", [
    (TG.gpt2_tiny(), "cuda", "flash"),  # head dim 16: padded to 64
    (TG.gpt2_small(), "cuda", "flash"),  # bf16, head dim 64
    (dataclasses.replace(TG.gpt2_small(), dtype=torch.float32), "cuda",
     "flash"),
    (dataclasses.replace(TG.gpt2_tiny(), attention="reference"), "cuda",
     "reference"),
    (TG.gpt2_small(), "cpu", "reference"),
], ids=["tiny", "small_bf16", "small_f32", "explicit_reference", "cpu"])
def test_auto_attention_is_flash_on_the_card(cfg, device, expect):
    """"auto" is "flash" on any CUDA input, as ray_tpu's is on a TPU: the
    hand-written kernels are never swapped for the plain version there,
    and what no kernel takes raises. The choice is a pure function of
    the config and the device type, so it needs no GPU."""
    assert TG._resolve_attention(cfg, torch.device(device)) == expect


def test_explicit_flash_still_refuses_what_the_kernels_do_not_take():
    """"flash", explicit or from "auto" on the card, reaches the kernel
    wrapper's checks, which refuse before any launch what no kernel
    takes: a head dim of 0 and other dtypes. gpt2_tiny's head dim 16,
    bf16 head dims 65-256, f32 configs, f16 (through the f32 kernels) and
    every dtype above head dim 256 (the split-head-dim kernels) are
    taken."""
    from ray_tpu_torch.ops import flash_attention as fa

    for D, dtype in ((0, torch.bfloat16), (0, torch.float32),
                     (0, torch.float16), (64, torch.float64)):
        q = torch.zeros(2, 8, D, dtype=dtype)
        with pytest.raises(ValueError, match="head dim|bf16 or f32"):
            fa._check_cuda((q, q, q))
    for D, dtype in ((16, torch.bfloat16), (96, torch.bfloat16),
                     (128, torch.bfloat16), (192, torch.bfloat16),
                     (256, torch.bfloat16), (64, torch.float32),
                     (16, torch.float32), (256, torch.float32),
                     (64, torch.float16), (256, torch.float16),
                     (257, torch.bfloat16), (320, torch.float32),
                     (320, torch.float16)):
        q = torch.zeros(2, 8, D, dtype=dtype)
        assert fa._check_cuda((q, q, q)) == (2, 8)
