"""The port's layers (ray_tpu_torch.models.layers) against the JAX
package's (ray_tpu.models.layers): forward and VJP of the memory-lean
LayerNorm and MLP in f32 and bf16, and attention with the reference and
flash impls. Inputs are made with numpy from a seed and fed to both."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.models import layers as JL
from ray_tpu_torch.convert import params_from_jax
from ray_tpu_torch.models import layers as TL

# f32: the same arithmetic, summed in another order.
F32_ATOL, F32_RTOL = 1e-5, 1e-4
# bf16: outputs round to 8 significant bits (2^-8 = 0.4%), and the two
# frameworks round intermediates at slightly different points (XLA keeps
# some elementwise chains in f32): a few ulps of the largest value.
BF16_REL = 2e-2


def _np(x):
    x = x.detach() if isinstance(x, torch.Tensor) else x
    x = x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.astype(np.float32)


def _close_bf16(a, b, what):
    a, b = _np(a), _np(b)
    err = np.abs(a - b).max()
    assert err <= BF16_REL * max(1.0, np.abs(b).max()), f"{what}: {err}"


def _vjp_jax(fn, args, ct):
    out, vjp = jax.vjp(fn, *args)
    return out, vjp(ct)


def _vjp_torch(fn, args, ct):
    args = [a.requires_grad_(True) for a in args]
    out = fn(*args)
    return out, torch.autograd.grad(out, args, ct)


def _t(x):
    x = np.asarray(x)
    if x.dtype == ml_dtypes.bfloat16:
        return params_from_jax(x, "cpu")
    return torch.tensor(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    jdt = jnp.dtype(dtype)
    x = rng.standard_normal((4, 16, 32)).astype(jdt)
    scale = (rng.standard_normal(32) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(32) * 0.1).astype(np.float32)
    ct = rng.standard_normal((4, 16, 32)).astype(jdt)
    yj, gj = _vjp_jax(JL.layer_norm, (x, scale, bias), ct)
    yt, gt = _vjp_torch(TL.layer_norm, [_t(x), _t(scale), _t(bias)], _t(ct))
    assert str(yt.dtype).endswith(dtype) and str(gt[0].dtype).endswith(dtype)
    pairs = [("y", yt, yj)] + list(zip(("dx", "dscale", "dbias"), gt, gj))
    for name, a, b in pairs:
        if dtype == "float32":
            np.testing.assert_allclose(_np(a), _np(b), atol=F32_ATOL,
                                       rtol=F32_RTOL, err_msg=name)
        else:
            _close_bf16(a, b, name)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_mlp_matches_jax(compute):
    rng = np.random.default_rng(1)
    D, F = 32, 64
    params = JL.init_mlp(jax.random.PRNGKey(42), D, F)
    params = {k: np.asarray(v) for k, v in params.items()}
    params["b1"] = (rng.standard_normal(F) * 0.1).astype(np.float32)
    params["b2"] = (rng.standard_normal(D) * 0.1).astype(np.float32)
    x = rng.standard_normal((2, 8, D)).astype(np.float32)
    ct = rng.standard_normal((2, 8, D)).astype(np.float32)
    names = ("w1", "b1", "w2", "b2")

    def jfn(x, *ws):
        return JL.apply_mlp(dict(zip(names, ws)), x, compute_dtype=jnp.dtype(compute))

    def tfn(x, *ws):
        return TL.apply_mlp(dict(zip(names, ws)), x,
                            compute_dtype=getattr(torch, compute))

    args = [x] + [params[n] for n in names]
    yj, gj = _vjp_jax(jfn, args, ct)
    yt, gt = _vjp_torch(tfn, [_t(a) for a in args], _t(ct))
    pairs = [("y", yt, yj)] + list(zip(("dx",) + names, gt, gj))
    for name, a, b in pairs:
        if compute == "float32":
            np.testing.assert_allclose(_np(a), _np(b), atol=F32_ATOL,
                                       rtol=F32_RTOL, err_msg=name)
        else:
            _close_bf16(a, b, name)


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_attention_matches_jax(impl):
    """f32 compute; the JAX flash impl runs its Pallas kernels in interpret
    mode, the port's its kernels' plain versions (CPU tensors)."""
    rng = np.random.default_rng(2)
    d, h, S = 32, 4, 64
    params = {k: np.asarray(v) for k, v in
              JL.init_attention(jax.random.PRNGKey(3), d, h).items()}
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    ct = rng.standard_normal((2, S, d)).astype(np.float32)
    names = ("wq", "wk", "wv", "wo")

    def jfn(x, *ws):
        return JL.apply_attention(dict(zip(names, ws)), x, impl=impl,
                                  compute_dtype=jnp.float32)

    def tfn(x, *ws):
        return TL.apply_attention(dict(zip(names, ws)), x, impl=impl,
                                  compute_dtype=torch.float32)

    args = [x] + [params[n] for n in names]
    yj, gj = _vjp_jax(jfn, args, ct)
    yt, gt = _vjp_torch(tfn, [_t(a) for a in args], _t(ct))
    for name, a, b in [("y", yt, yj)] + list(zip(("dx",) + names, gt, gj)):
        np.testing.assert_allclose(_np(a), _np(b), atol=F32_ATOL,
                                   rtol=F32_RTOL, err_msg=name)


def test_attention_refuses_unported_impl():
    """An impl the port does not have is refused. "ring" is ported: at sp
    1 (no group) it is the one shard's attention, "reference"'s."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 4, 8)).astype(np.float32))
    params = TL.init_attention(torch.Generator().manual_seed(0), 8, 2,
                               device="cpu")
    with pytest.raises(ValueError, match="not ported"):
        TL.apply_attention(params, x, impl="splash")
    assert torch.equal(TL.apply_attention(params, x, impl="ring"),
                       TL.apply_attention(params, x, impl="reference"))
