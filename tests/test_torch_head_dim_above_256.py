"""Head dims above 256 in the port's flash attention
(ray_tpu_torch.ops.flash_attention): the route ``kernel_plan`` gives them
and what a wrapper computes on the card for them, with each kernel's
plain version in its place, against the JAX package's Pallas kernels run
in interpret mode on the same numpy inputs.

On the card every dtype runs the split-head-dim kernels of
``csrc/flash_attention_dsplit.cu`` at the head dim padded to a multiple
of 64: bf16 and f32 in their own dtype, float16 on f32 copies. Each
case's Pallas run is made and cached by the case itself, so no test's
setup carries the others'.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jfa
from ray_tpu_torch.ops import flash_attention as tfa

BH, S, JAX_BLOCK = 2, 129, 128  # S: one row past a 128-row tile
# f32: the JAX package's own bounds for its Pallas kernels (sums in
# another order); bf16 and float16: chip_smoke.py's element bound (float16
# on the card skips the reference's float16 rounding of p and ds, bf16
# rounds them at scales that differ, as test_torch_head_dim_256.py says).
O_ATOL, LSE_ATOL, GRAD_ATOL = 2e-5, 2e-5, 1e-4
RTOL, ATOL_RMS, FLOOR = 2.0 ** -6, 2.0 ** -3, 1e-5
DTYPES = ("float32", "bfloat16", "float16")
FAMILIES = {"float32": "f32_dsplit", "bfloat16": "bf16_dsplit",
            "float16": "f16_f32_dsplit"}


@functools.lru_cache(maxsize=None)
def _pallas_run(dtype, Dh, causal):
    """_flash_fwd and _flash_bwd of the JAX package on inputs from numpy,
    as f32 numpy arrays."""
    rng = np.random.default_rng(Dh + causal)
    q, k, v, do = (jnp.asarray(rng.standard_normal((BH, S, Dh),
                                                   dtype=np.float32),
                               dtype=dtype) for _ in range(4))
    kw = dict(scale=Dh ** -0.5, causal=causal, block_q=JAX_BLOCK,
              block_k=JAX_BLOCK, interpret=True)
    o, lse = jfa._flash_fwd(q, k, v, **kw)
    dq, dk, dv = jfa._flash_bwd(q, k, v, o, lse, do, **kw)
    return {n: np.asarray(x.astype(jnp.float32)) for n, x in dict(
        q=q, k=k, v=v, do=do, o=o, lse=lse, dq=dq, dk=dk, dv=dv).items()}


def _card_path(q, k, v, do, *, scale, causal):
    """What the wrappers do on the card above head dim 256, with the plain
    versions in the kernels' place: every input in the family's dtype (f32
    copies of float16), zero-padded to a multiple of 64; the forward, dq
    and dk/dv; the outputs sliced back and cast to the caller's dtype.
    delta = sum(do.o) in f32, as the autograd backward forms it."""
    dtype, D = q.dtype, q.shape[-1]
    plans = {tfa.kernel_plan(dtype, D, kernel) for kernel in tfa.KERNELS}
    assert len(plans) == 1
    family, Dk = plans.pop()
    assert Dk % tfa.DSPLIT_CHUNK == 0 and Dk - tfa.DSPLIT_CHUNK < D <= Dk
    qp, kp, vp, dop = tfa._kernel_inputs(family, (q, k, v, do), Dk)
    kw = dict(scale=scale, causal=causal)
    o, lse = tfa.flash_fwd_plain(qp, kp, vp, **kw)
    o = tfa._kernel_output(o, D, dtype)
    delta = (do.float() * o.float()).sum(dim=-1)
    dq = tfa.flash_bwd_dq_plain(qp, kp, vp, dop, lse, delta, **kw)
    dk, dv = tfa.flash_bwd_dkv_plain(qp, kp, vp, dop, lse, delta, **kw)
    return (o, lse, *(tfa._kernel_output(x, D, dtype) for x in (dq, dk, dv)))


def _worst(a, b):
    bound = RTOL * np.abs(b) + ATOL_RMS * np.sqrt(np.mean(b * b)) + FLOOR
    return float((np.abs(a - b) / bound).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Dh", [320, 512])
@pytest.mark.parametrize("dtype", DTYPES)
def test_head_dims_above_256_match_pallas(dtype, Dh, causal):
    """o, lse, dq, dk and dv along the card's route against the Pallas
    kernels on the same inputs: f32 within the JAX package's bounds, bf16
    and float16 within chip_smoke.py's element bound."""
    r = _pallas_run(dtype, Dh, causal)
    tdtype = getattr(torch, dtype)
    q, k, v, do = (torch.tensor(r[n]).to(tdtype) for n in ("q", "k", "v", "do"))
    assert tfa.kernel_plan(tdtype, Dh) == (FAMILIES[dtype], Dh)
    got = _card_path(q, k, v, do, scale=Dh ** -0.5, causal=causal)
    np.testing.assert_allclose(got[1].numpy(), r["lse"], atol=LSE_ATOL)
    for x, name, atol in zip((got[0], *got[2:]), ("o", "dq", "dk", "dv"),
                             (O_ATOL, GRAD_ATOL, GRAD_ATOL, GRAD_ATOL)):
        assert x.dtype == tdtype and x.shape == r[name].shape
        what = f"{name} {dtype} D={Dh} causal={causal}"
        if dtype == "float32":
            np.testing.assert_allclose(x.numpy(), r[name], atol=atol,
                                       err_msg=what)
        else:
            assert _worst(x.float().numpy(), r[name]) <= 1.0, what


@pytest.mark.parametrize("dtype,Dh,Dk", [
    (torch.bfloat16, 300, 320), (torch.float32, 257, 320),
    (torch.float16, 1000, 1024)])
def test_the_route_launches_the_dsplit_kernels(monkeypatch, dtype, Dh, Dk):
    """On the card each wrapper launches its dsplit entry (bf16 in bf16,
    f32 and float16 through the f32 one on f32 copies) at the head dim
    padded to a multiple of 64, counted under the entry's own name, and
    hands back the caller's dtype and head dim."""
    calls, given = [], []
    monkeypatch.setattr(tfa, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(tfa, "_launch", lambda entry, counter, device, *args:
                        calls.append((entry, counter, args[-3])))
    inputs = tfa._kernel_inputs

    def record(family, ts, hd):
        out = inputs(family, ts, hd)
        given.append({t.dtype for t in out})
        return out

    monkeypatch.setattr(tfa, "_kernel_inputs", record)
    x = torch.zeros(2, 40, Dh, dtype=dtype)
    rows = torch.zeros(2, 40)
    kw = dict(scale=1.0, causal=True)
    o, _ = tfa.flash_fwd(x, x, x, **kw)
    dq = tfa.flash_bwd_dq(x, x, x, x, rows, rows, **kw)
    dk, dv = tfa.flash_bwd_dkv(x, x, x, x, rows, rows, **kw)
    suffix = "_bf16ds" if dtype == torch.bfloat16 else "_f32ds"
    assert calls == [(k + suffix, k + suffix, Dk) for k in tfa.KERNELS]
    assert given == [{torch.bfloat16 if dtype == torch.bfloat16
                      else torch.float32}] * 3
    assert all(tfa._LIBRARY_OF[c[0]] == "flash_attention_dsplit"
               for c in calls)
    for y in (o, dq, dk, dv):
        assert y.dtype == dtype and y.shape == (2, 40, Dh)
