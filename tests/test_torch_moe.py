"""The port's routed MoE layer (ray_tpu_torch.models.layers.apply_moe) and
GPT-2 with MoE blocks against the JAX package's, on the same numpy
weights and inputs: the layer's output, aux loss and gradients at a
capacity factor that drops no token and at one that drops many, the
model's loss and every leaf's gradient, its parameter count and tree,
and a few training steps."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as JG
from ray_tpu.models import layers as JL
from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.convert import params_from_jax, params_to_numpy
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.models import layers as TL
from ray_tpu_torch.parallel import train_step as TT

B, S, D, FF, E = 2, 16, 32, 64, 4
# f32: the same arithmetic summed in another order; the aux loss is a sum
# of E products of means.
OUT_ATOL, AUX_RTOL = 1e-5, 1e-6
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
# bf16: chip_smoke.py's bound for bf16 outputs, element by element; the two
# frameworks round the einsums' outputs to bf16 after sums in other orders.
BF16_RTOL, BF16_ATOL_RMS, BF16_FLOOR = 2.0 ** -6, 2.0 ** -3, 1e-5


def _moe_case(seed):
    """Weights and input from numpy: a router sharp enough that no two of
    a token's probabilities tie within f32 noise."""
    rng = np.random.default_rng(seed)
    params = {
        "wg": rng.standard_normal((D, E)).astype(np.float32),
        "w1": (rng.standard_normal((E, D, FF)) * D ** -0.5).astype(np.float32),
        "w2": (rng.standard_normal((E, FF, D)) * FF ** -0.5).astype(np.float32),
    }
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    return params, x


def _dropped(params, x, cfg):
    _, _, _, slots = TL.route_tokens(torch.from_numpy(params["wg"]),
                                     torch.from_numpy(x), cfg)
    return int((slots >= TL.moe_capacity(cfg, B * S)).sum())


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_apply_moe_matches_jax_f32(cf):
    """cf 8.0 drops no (token, k) pair; cf 0.5 drops about half of them,
    which pins the slot order over the flattened (b, s, k) stream."""
    cfg_j = JL.MoEConfig(n_experts=E, top_k=2, capacity_factor=cf)
    cfg_t = TL.MoEConfig(n_experts=E, top_k=2, capacity_factor=cf)
    params, x = _moe_case(1)
    dropped = _dropped(params, x, cfg_t)
    assert (dropped == 0) if cf == 8.0 else (dropped >= B * S * 2 // 4)
    out_j, aux_j = JL.apply_moe(params, jnp.asarray(x), cfg_j,
                                compute_dtype=jnp.float32)
    out_t, aux_t = TL.apply_moe(params_from_jax(params, "cpu"),
                                torch.from_numpy(x), cfg_t,
                                compute_dtype=torch.float32)
    assert out_t.dtype == torch.float32 and aux_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               atol=OUT_ATOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=AUX_RTOL)
    assert float(aux_t) > 0


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_apply_moe_matches_jax_bf16(cf):
    cfg_j = JL.MoEConfig(n_experts=E, top_k=2, capacity_factor=cf)
    cfg_t = TL.MoEConfig(n_experts=E, top_k=2, capacity_factor=cf)
    params, x = _moe_case(2)
    out_j, aux_j = JL.apply_moe(params, jnp.asarray(x), cfg_j,
                                compute_dtype=jnp.bfloat16)
    out_t, aux_t = TL.apply_moe(params_from_jax(params, "cpu"),
                                torch.from_numpy(x), cfg_t,
                                compute_dtype=torch.bfloat16)
    want = np.asarray(out_j, dtype=np.float32)
    bound = (BF16_RTOL * np.abs(want) + BF16_ATOL_RMS
             * np.sqrt(np.mean(want * want)) + BF16_FLOOR)
    worst = float((np.abs(out_t.float().numpy() - want) / bound).max())
    assert worst <= 1.0, worst
    # the router is f32 on both sides whatever the compute dtype
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=AUX_RTOL)


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_apply_moe_grads_match_jax(cf):
    """The gradients of x, wg, w1 and w2 in f32 through out and the aux
    loss; wg gets its gradient through the combine weights and the aux
    loss."""
    cfg_j = JL.MoEConfig(n_experts=E, top_k=2, capacity_factor=cf)
    cfg_t = TL.MoEConfig(n_experts=E, top_k=2, capacity_factor=cf)
    params, x = _moe_case(3)

    def loss_j(p, x):
        out, aux = JL.apply_moe(p, x, cfg_j, compute_dtype=jnp.float32)
        return jnp.sum(out * jnp.cos(out)) + 3.0 * aux

    gp_j, gx_j = jax.grad(loss_j, argnums=(0, 1))(params, jnp.asarray(x))
    p_t = tree_map(lambda t: t.requires_grad_(True),
                   params_from_jax(params, "cpu"))
    x_t = torch.from_numpy(x).requires_grad_(True)
    out, aux = TL.apply_moe(p_t, x_t, cfg_t, compute_dtype=torch.float32)
    grads = torch.autograd.grad(torch.sum(out * torch.cos(out)) + 3.0 * aux,
                                [x_t, *(p_t[n] for n in ("wg", "w1", "w2"))])
    for g, want, name in zip(grads, [gx_j, gp_j["wg"], gp_j["w1"], gp_j["w2"]],
                             ("x", "wg", "w1", "w2")):
        assert np.abs(np.asarray(want)).max() > 0, name
        np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"d{name} (cf {cf})")


def test_apply_moe_matches_the_per_token_oracle():
    """With room for every token (cf 8.0), each token's output is its
    experts' MLPs weighted by its renormalized gates (the oracle of the
    JAX package's test_moe_matches_per_token_oracle, in torch)."""
    cfg = TL.MoEConfig(n_experts=E, top_k=2, capacity_factor=8.0)
    params, x = _moe_case(4)
    p = params_from_jax(params, "cpu")
    xt = torch.from_numpy(x)
    out, _ = TL.apply_moe(p, xt, cfg, compute_dtype=torch.float32)
    gates, experts = torch.topk(torch.softmax(xt @ p["wg"], -1), 2, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    want = torch.zeros_like(xt)
    for b in range(B):
        for s in range(S):
            want[b, s] = sum(
                gates[b, s, j] * (TL._gelu(xt[b, s] @ p["w1"][experts[b, s, j]])
                                  @ p["w2"][experts[b, s, j]])
                for j in range(2))
    torch.testing.assert_close(out, want, atol=1e-5, rtol=0)


# ----------------------------------------------------------- GPT-2 + MoE
def _gpt2_cfgs(dtype="float32", **over):
    """test_gpt2_moe_forward's config (tests/test_parallel.py), reference
    attention on both sides."""
    common = dict(vocab_size=128, max_seq=64, n_layer=2, n_head=2,
                  d_model=32, remat=False, attention="reference")
    common.update(over)
    return (JG.GPT2Config(dtype=jnp.dtype(dtype), moe=JL.MoEConfig(
                n_experts=4, top_k=2, capacity_factor=2.0), **common),
            TG.GPT2Config(dtype=getattr(torch, dtype), moe=TL.MoEConfig(
                n_experts=4, top_k=2, capacity_factor=2.0), **common))


@pytest.fixture(scope="module")
def moe_params():
    jcfg, _ = _gpt2_cfgs()
    return jax.tree.map(np.asarray, JG.init(jax.random.PRNGKey(0), jcfg))


def _gpt2_tokens(seed, batch=4, seq=16):
    return np.random.default_rng(seed).integers(0, 128, (batch, seq + 1)
                                                ).astype(np.int32)


def test_gpt2_moe_loss_and_grads_match_jax(moe_params):
    """loss_fn's total, loss and aux_loss, and every leaf's gradient, f32
    compute, the aux loss weighted by aux_loss_weight on both sides."""
    jcfg, tcfg = _gpt2_cfgs()
    tok = _gpt2_tokens(1)
    (total_j, m_j), grads_j = jax.value_and_grad(
        lambda p: JG.loss_fn(p, {"tokens": jnp.asarray(tok)}, jcfg),
        has_aux=True)(moe_params)
    params = params_from_jax(moe_params, "cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    total_t, m_t = TG.loss_fn(params, {"tokens": torch.from_numpy(tok)}, tcfg)
    grads_t = torch.autograd.grad(total_t, leaves)
    m_t = {k: v.detach() for k, v in m_t.items()}
    assert float(m_t["aux_loss"]) > 0
    for key in ("total_loss", "loss", "aux_loss"):
        np.testing.assert_allclose(float(m_t[key]), float(m_j[key]),
                                   rtol=1e-6, err_msg=key)
    flat_j = jax.tree_util.tree_leaves(grads_j)
    assert len(flat_j) == len(grads_t)
    for gt, gj in zip(grads_t, flat_j):
        assert tuple(gt.shape) == gj.shape
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-6,
                                   rtol=1e-4)


def test_gpt2_moe_bf16_loss_matches_jax(moe_params):
    """bf16 compute (the default): the residual stream and every einsum
    output round to bf16 at slightly different points, as for the dense
    model (test_torch_gpt2.py), so the loss agrees to 1%; the router is
    f32 on both sides but reads a bf16 residual stream."""
    jcfg, tcfg = _gpt2_cfgs("bfloat16")
    tok = _gpt2_tokens(2)
    _, m_j = JG.loss_fn(moe_params, {"tokens": jnp.asarray(tok)}, jcfg)
    _, m_t = TG.loss_fn(params_from_jax(moe_params, "cpu"),
                        {"tokens": torch.from_numpy(tok)}, tcfg)
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                               rtol=1e-2)
    np.testing.assert_allclose(float(m_t["aux_loss"]), float(m_j["aux_loss"]),
                               rtol=1e-2)


def test_gpt2_moe_remat_returns_the_pair(moe_params):
    """Under remat the checkpointed block returns (x, aux): the loss, the
    aux loss and every gradient are the ones without remat."""
    _, tcfg = _gpt2_cfgs()
    batch = {"tokens": torch.from_numpy(_gpt2_tokens(3))}
    out = []
    for remat in (False, True):
        params = params_from_jax(moe_params, "cpu")
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        total, m = TG.loss_fn(params, batch,
                              dataclasses.replace(tcfg, remat=remat))
        out.append((float(m["aux_loss"].detach()),
                    torch.autograd.grad(total, leaves)))
    assert out[0][0] == out[1][0] > 0
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_n_params_matches_jax_for_gpt2_small_moe():
    jcfg = dataclasses.replace(JG.gpt2_small(), moe=JL.MoEConfig())
    tcfg = dataclasses.replace(TG.gpt2_small(), moe=TL.MoEConfig())
    assert tcfg.n_params == jcfg.n_params
    assert TG.gpt2_small().n_params == JG.gpt2_small().n_params
    # 8 experts of 2 d f weights a block in place of the dense MLP
    assert tcfg.n_params - TG.gpt2_small().n_params == 12 * (
        7 * 2 * 768 * 3072 - 768 - 3072)


def test_init_tree_matches_jax(moe_params):
    """The same keys, shapes and dtypes as the JAX package's init: "moe"
    (wg, w1, w2, stacked [L, ...]) in place of "mlp"."""
    _, tcfg = _gpt2_cfgs()
    params = TG.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert "moe" in params["blocks"] and "mlp" not in params["blocks"]
    assert sorted(params["blocks"]["moe"]) == ["w1", "w2", "wg"]
    flat_t = tree_leaves(params)
    flat_j = jax.tree_util.tree_leaves(moe_params)
    paths_j = [jax.tree_util.keystr(k) for k, _ in
               jax.tree_util.tree_flatten_with_path(moe_params)[0]]
    assert len(flat_t) == len(flat_j) == len(paths_j)
    for t, j, path in zip(flat_t, flat_j, paths_j):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32, path
    assert tuple(params["blocks"]["moe"]["w1"].shape) == (2, 4, 32, 128)
    assert set(TL.MOE_LOGICAL) == set(JL.MOE_LOGICAL)
    assert all(tuple(TL.MOE_LOGICAL[k]) == tuple(JL.MOE_LOGICAL[k])
               for k in TL.MOE_LOGICAL)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_convert_carries_an_moe_tree(moe_params, dtype):
    """params_from_jax and params_to_numpy carry an MoE tree as it is, leaf
    for leaf and bit for bit (bf16 comes back as the f32 it holds)."""
    import ml_dtypes

    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype
    tree = jax.tree.map(lambda a: np.asarray(a).astype(np_dtype), moe_params)
    params = params_from_jax(tree, "cpu")
    back = params_to_numpy(params)
    assert sorted(params["blocks"]["moe"]) == ["w1", "w2", "wg"]
    for a, b in zip(jax.tree_util.tree_leaves(tree), tree_leaves(back)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.astype(np.float32), b)


def test_gpt2_moe_trains_on_the_cpu(moe_params):
    """make_train_step runs an MoE config unchanged: the aux loss is in
    its metrics, finite and positive at every step, and the loss falls on
    a repeated batch."""
    _, tcfg = _gpt2_cfgs()
    batch = {"tokens": torch.from_numpy(_gpt2_tokens(4))}
    opt = TT.default_optimizer(1e-2, warmup_steps=1, total_steps=20)
    state = TT.make_train_state(lambda g: params_from_jax(moe_params, "cpu"),
                                torch.Generator(), opt, device="cpu")
    step = TT.make_train_step(lambda p, b: TG.loss_fn(p, b, tcfg), opt)
    losses = []
    for _ in range(6):
        state, m = step(state, batch)
        assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
        assert torch.isfinite(m["aux_loss"]) and float(m["aux_loss"]) > 0
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[1] - 0.1, losses
