"""Head dims 129 to 256 in the port's flash attention
(ray_tpu_torch.ops.flash_attention): the routes of ``kernel_plan`` and
what a wrapper computes on the card for them, with each kernel's plain
version in its place, against the JAX package's Pallas kernels run in
interpret mode on the same numpy inputs.

On the card, f32 head dims 129-256 run the f32 kernels at head dim 256
(zero-padded). bf16 ones run the bf16_d256 forward, dq and dk/dv at head
dim 256, which round p and ds to bf16 as the bf16 Pallas kernels do.
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
# another order); bf16: chip_smoke.py's bound, element by element.
O_ATOL, LSE_ATOL, GRAD_ATOL = 2e-5, 2e-5, 1e-4
BF16_RTOL, BF16_ATOL_RMS, BF16_FLOOR = 2.0 ** -6, 2.0 ** -3, 1e-5
CASES = [(Dh, causal) for Dh in (192, 256) for causal in (True, False)]


@functools.lru_cache(maxsize=None)
def _pallas_run(dtype, Dh, causal):
    """_flash_fwd and _flash_bwd of the JAX package for one (dtype, head
    dim, causal) on inputs from numpy, made by the first case that asks
    for it (the bf16 and f32 cases of a head dim share nothing), so no
    case's setup carries the others' runs."""
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
    """What the wrappers do on the card at head dims 129-256, with the
    plain versions in the kernels' place: every input zero-padded to head
    dim 256; the forward, dq and dk/dv in the caller's dtype (in bf16 dq
    rounds ds to bf16 before ds.k, as _bwd_dq_kernel does); the outputs
    sliced back. delta = sum(do.o) in f32, as the autograd backward forms
    it."""
    dtype, D = q.dtype, q.shape[-1]
    family = {torch.float32: "f32", torch.bfloat16: "bf16_d256"}[dtype]
    assert [tfa.kernel_plan(dtype, D, kernel) for kernel in tfa.KERNELS
            ] == [(family, 256)] * 3
    qp, kp, vp, dop = (tfa.pad_head_dim(x, 256) for x in (q, k, v, do))
    kw = dict(scale=scale, causal=causal)
    o, lse = tfa.flash_fwd_plain(qp, kp, vp, **kw)
    o = tfa.unpad_head_dim(o, D)
    delta = (do.float() * o.float()).sum(dim=-1)
    dq = tfa.flash_bwd_dq_plain(qp, kp, vp, dop, lse, delta, **kw)
    dk, dv = tfa.flash_bwd_dkv_plain(qp, kp, vp, dop, lse, delta, **kw)
    return (o, lse, *(tfa.unpad_head_dim(x, D) for x in (dq, dk, dv)))


def _assert_close_bf16(a, b, what):
    bound = (BF16_RTOL * np.abs(b) + BF16_ATOL_RMS * np.sqrt(np.mean(b * b))
             + BF16_FLOOR)
    worst = float((np.abs(a - b) / bound).max())
    assert worst <= 1.0, (what, worst)


@pytest.mark.parametrize("Dh,causal", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dims_above_128_match_pallas(dtype, Dh, causal):
    """o, lse, dq, dk and dv along the card's route against the Pallas
    kernels on the same inputs: f32 within the JAX package's bounds, bf16
    within chip_smoke.py's (the bf16 forward, dq and dk/dv round p and ds
    to bf16 as the bf16 Pallas kernels do)."""
    r = _pallas_run(dtype, Dh, causal)
    tdtype = getattr(torch, dtype)
    q, k, v, do = (torch.tensor(r[n]).to(tdtype) for n in ("q", "k", "v", "do"))
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
            _assert_close_bf16(x.float().numpy(), r[name], what)


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv"])
@pytest.mark.parametrize("dtype,Dh,plan", [
    # bf16: all three on bf16_d256
    (torch.bfloat16, 129, ("bf16_d256", 256)),
    (torch.bfloat16, 192, ("bf16_d256", 256)),
    (torch.bfloat16, 256, ("bf16_d256", 256)),
    (torch.float32, 129, ("f32", 256)), (torch.float32, 200, ("f32", 256)),
    (torch.float32, 256, ("f32", 256)),
    # the routes below 129 are unchanged
    (torch.bfloat16, 128, ("bf16_wide", 128)),
    (torch.float32, 128, ("f32", 128)),
])
def test_kernel_plan_routes_head_dims_up_to_256(dtype, Dh, plan, kernel):
    assert tfa.kernel_plan(dtype, Dh, kernel) == plan
    q = torch.zeros(2, 8, Dh, dtype=dtype)
    assert tfa._check_cuda((q, q, q)) == (2, 8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Dh", [257, 512])
def test_kernel_plan_routes_head_dims_above_256_past_these_kernels(dtype,
                                                                    Dh):
    """Past 256 the head-dim-256 kernels give way to the split-head-dim
    ones (tests/test_torch_head_dim_above_256.py), at the head dim padded
    to a multiple of 64."""
    family = {torch.bfloat16: "bf16_dsplit", torch.float32: "f32_dsplit"}
    assert tfa.kernel_plan(dtype, Dh) == (family[dtype], -(-Dh // 64) * 64)
    assert tfa._check_cuda((torch.zeros(2, 8, Dh, dtype=dtype),) * 3) == (
        2, 8)


def test_bf16_f32_route_counts_under_the_f32_kernels(monkeypatch):
    """No bf16 route runs the f32 kernels any more (the bf16_f32 family,
    the bf16 dq at head dims 129-256 on f32 copies, is gone): bf16_d256
    counts all three of its kernels under names of its own, and a bf16
    head-dim-256 backward launches none of the f32 entries."""
    assert "bf16_f32" not in tfa._SUFFIXES
    assert not hasattr(tfa, "_as_f32")
    assert all(not n.endswith("bf16_f32") for n in tfa.LAUNCHES)
    assert {n for n in tfa.LAUNCHES if n.endswith("_bf16d256")} == {
        "flash_fwd_bf16d256", "flash_bwd_dq_bf16d256",
        "flash_bwd_dkv_bf16d256"}
    monkeypatch.setattr(tfa, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(tfa, "_launch", lambda entry, counter, device, *a:
                        tfa._count_launch(counter))
    monkeypatch.setattr(tfa, "LAUNCHES", dict.fromkeys(tfa.LAUNCHES, 0))
    x = torch.zeros(2, 40, 192, dtype=torch.bfloat16)
    rows = torch.zeros(2, 40)
    tfa.flash_bwd_dq(x, x, x, x, rows, rows, scale=1.0, causal=True)
    tfa.flash_bwd_dkv(x, x, x, x, rows, rows, scale=1.0, causal=True)
    assert {n: c for n, c in tfa.LAUNCHES.items() if c} == {
        "flash_bwd_dq_bf16d256": 1, "flash_bwd_dkv_bf16d256": 1}
