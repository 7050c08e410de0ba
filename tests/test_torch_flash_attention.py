"""The port's flash attention (ray_tpu_torch.ops.flash_attention) against
the JAX package's Pallas kernels, run here in Pallas interpret mode.

On CPU tensors the port computes each kernel's plain PyTorch version, so
these tests hold the plain versions — and the autograd wiring around them
— to the TPU kernels. Inputs are made with numpy from a seed and fed to
both packages in f32.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jfa
from ray_tpu_torch.ops import flash_attention as tfa

B, H, D = 2, 2, 32
# 192: S not a block multiple; 129: one row past a 128-row tile
CASES = [(256, True), (256, False), (192, True), (129, True)]
JAX_BLOCK = 128
# The JAX package's own bounds for its Pallas kernels against full
# attention (tests/test_parallel.py): f32 sums in another order.
O_ATOL = 2e-5
GRAD_ATOL = 1e-4


def _inputs(S, seed=0):
    rng = np.random.default_rng(seed + S)
    return [rng.standard_normal((B, S, H, D), dtype=np.float32) for _ in range(4)]


def _to_bh(x):
    S = x.shape[1]
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(B * H, S, D))


@pytest.fixture(scope="module")
def pallas_launchers():
    """_flash_fwd and _flash_bwd of the JAX package per case, with the
    cotangent of sum(o * cos(o)) as do."""
    out = {}
    for S, causal in CASES:
        q, k, v, _ = (_to_bh(x) for x in _inputs(S))
        kw = dict(scale=1.0 / D ** 0.5, causal=causal, block_q=JAX_BLOCK,
                  block_k=JAX_BLOCK, interpret=True)
        o, lse = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
        do = jnp.cos(o) - o * jnp.sin(o)
        dq, dk, dv = jfa._flash_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    o, lse, do, **kw)
        out[(S, causal)] = {name: np.asarray(x) for name, x in dict(
            q=q, k=k, v=v, o=o, lse=lse, do=do, dq=dq, dk=dk, dv=dv).items()}
    return out


@pytest.mark.parametrize("S,causal", CASES)
def test_flash_attention_matches_pallas(S, causal):
    """Forward and all three grads through the public flash_attention."""
    q, k, v, _ = _inputs(S)

    def loss_jax(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, block_q=JAX_BLOCK,
                                block_k=JAX_BLOCK, interpret=True)
        return jnp.sum(o * jnp.cos(o)), o

    (_, o_j), grads_j = jax.value_and_grad(loss_jax, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o_t = tfa.flash_attention(qt, kt, vt, causal=causal)
    grads_t = torch.autograd.grad(torch.sum(o_t * torch.cos(o_t)), (qt, kt, vt))
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j), atol=O_ATOL)
    for gt, gj, name in zip(grads_t, grads_j, "qkv"):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=GRAD_ATOL,
                                   err_msg=f"d{name} (S={S}, causal={causal})")


@pytest.mark.parametrize("S,causal", CASES)
def test_fwd_plain_matches_pallas_fwd(S, causal, pallas_launchers):
    r = pallas_launchers[(S, causal)]
    o, lse = tfa.flash_fwd_plain(*(torch.tensor(r[n]) for n in "qkv"),
                                 scale=1.0 / D ** 0.5, causal=causal)
    np.testing.assert_allclose(o.numpy(), r["o"], atol=O_ATOL)
    # lse ~ log(S) ~ 5-6 in f32: 2e-5 is a few ulps there
    np.testing.assert_allclose(lse.numpy(), r["lse"], atol=2e-5)


def _bwd_inputs(r):
    q, k, v, o, lse, do = (torch.tensor(r[n]) for n in
                           ("q", "k", "v", "o", "lse", "do"))
    delta = (do.float() * o.float()).sum(dim=-1)
    return q, k, v, do, lse, delta


@pytest.mark.parametrize("S,causal", CASES)
def test_bwd_dq_plain_matches_pallas_dq(S, causal, pallas_launchers):
    r = pallas_launchers[(S, causal)]
    dq = tfa.flash_bwd_dq_plain(*_bwd_inputs(r), scale=1.0 / D ** 0.5,
                                causal=causal)
    np.testing.assert_allclose(dq.numpy(), r["dq"], atol=GRAD_ATOL)


@pytest.mark.parametrize("S,causal", CASES)
def test_bwd_dkv_plain_matches_pallas_dkv(S, causal, pallas_launchers):
    r = pallas_launchers[(S, causal)]
    dk, dv = tfa.flash_bwd_dkv_plain(*_bwd_inputs(r), scale=1.0 / D ** 0.5,
                                     causal=causal)
    np.testing.assert_allclose(dk.numpy(), r["dk"], atol=GRAD_ATOL)
    np.testing.assert_allclose(dv.numpy(), r["dv"], atol=GRAD_ATOL)


def test_cpu_tensors_launch_no_kernel():
    tfa.reset_launch_counts()
    q, k, v, _ = (torch.from_numpy(x).requires_grad_(True) for x in _inputs(64))
    o = tfa.flash_attention(q, k, v, causal=True)
    o.sum().backward()
    assert set(tfa.LAUNCHES.values()) == {0}
    assert sorted(tfa.LAUNCHES) == sorted(
        [f"{n}{s}" for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
         for s in ("", "_f32", "_bf16w", "_bf16d256", "_bf16ds", "_f32ds")])


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    bf = torch.zeros(4, 128, 64, dtype=torch.bfloat16)
    assert tfa._check_cuda((bf, bf, bf)) == (4, 128)
    with pytest.raises(ValueError, match="head dim"):
        tfa._check_cuda((torch.zeros(4, 128, 0, dtype=torch.bfloat16),) * 3)
    with pytest.raises(ValueError, match="bf16"):
        tfa._check_cuda((bf, bf.float(), bf))
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(128, 4, 64, dtype=torch.bfloat16).transpose(0, 1)
        tfa._check_cuda((t, t, t))
    with pytest.raises(ValueError, match="f32"):
        tfa._check_cuda((bf,) * 4, (torch.zeros(4, 128),
                                    torch.zeros(4, 128, dtype=torch.float64)))
    assert (tfa.DQ_BLOCK_Q, tfa.DQ_BLOCK_K) == (128, 64)
    with pytest.raises(ValueError, match="dq 128x64"):
        tfa.flash_attention(*(torch.zeros(1, 64, 1, 64),) * 3, block_q=128)


def test_kernel_wrappers_refuse_unaligned_tensors():
    """The forward and dk/dv kernels read q, k, v and do through TMA, which
    takes 16-byte aligned rows: a contiguous view 2 bytes into its storage
    is refused before any launch."""
    flat = torch.zeros(4 * 128 * 64 + 1, dtype=torch.bfloat16)
    t = flat[1:].view(4, 128, 64)
    assert t.is_contiguous() and t.data_ptr() % 16
    bf = torch.zeros(4, 128, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        tfa._check_cuda((bf, t, bf))
    f32 = torch.zeros(4 * 128 + 1)[1:].view(4, 128)
    assert tfa._check_cuda((bf,) * 4, (f32, f32)) == (4, 128)


def test_launch_counts_stay_exact_under_rank_threads():
    """Rank threads of a gang launch at once: more threads than cores,
    switching every microsecond, lose no count."""
    import sys
    import threading

    threads, per_thread = 4 * (os.cpu_count() or 1), 2000
    tfa.reset_launch_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda: [tfa._count_launch("flash_fwd")
                            for _ in range(per_thread)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert tfa.LAUNCHES["flash_fwd"] == threads * per_thread
    tfa.reset_launch_counts()


# ----------------------------------- head dims other than 64, and f32
@pytest.fixture(scope="module")
def pallas_by_head_dim():
    """_flash_fwd and _flash_bwd of the JAX package in f32 at head dims 16
    and 32, S = 129 (one row past a 128-row tile), causal and not."""
    out = {}
    for Dh in (16, 32):
        for causal in (True, False):
            rng = np.random.default_rng(Dh + causal)
            q, k, v, do = (rng.standard_normal((3, 129, Dh), dtype=np.float32)
                           for _ in range(4))
            kw = dict(scale=Dh ** -0.5, causal=causal, block_q=JAX_BLOCK,
                      block_k=JAX_BLOCK, interpret=True)
            o, lse = jfa._flash_fwd(*(jnp.asarray(x) for x in (q, k, v)), **kw)
            dq, dk, dv = jfa._flash_bwd(*(jnp.asarray(x) for x in (q, k, v)),
                                        o, lse, jnp.asarray(do), **kw)
            out[(Dh, causal)] = {n: np.asarray(x) for n, x in dict(
                q=q, k=k, v=v, do=do, o=o, lse=lse, dq=dq, dk=dk, dv=dv).items()}
    return out


def _padded_path(q, k, v, do, *, scale, causal, head_dim):
    """What a wrapper does on the card, with each kernel's plain version in
    the kernel's place: zero-pad q, k, v and do to the kernel's head dim,
    compute at that head dim with the caller's scale, slice back."""
    D = q.shape[-1]

    def pad(x):
        return tfa.pad_head_dim(x, head_dim)

    def unpad(x):
        return tfa.unpad_head_dim(x, D)

    kw = dict(scale=scale, causal=causal)
    o, lse = tfa.flash_fwd_plain(pad(q), pad(k), pad(v), **kw)
    assert not o[..., D:].any()  # zero columns stay zero
    o = unpad(o)
    delta = (do.float() * o.float()).sum(dim=-1)
    dq = tfa.flash_bwd_dq_plain(pad(q), pad(k), pad(v), pad(do), lse, delta,
                                **kw)
    dk, dv = tfa.flash_bwd_dkv_plain(pad(q), pad(k), pad(v), pad(do), lse,
                                     delta, **kw)
    return o, lse, unpad(dq), unpad(dk), unpad(dv)


@pytest.mark.parametrize("Dh", [16, 32])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_versions_match_pallas_at_head_dim(Dh, causal,
                                                 pallas_by_head_dim):
    """f32 at head dims 16 and 32: the plain versions (what the f32 kernels
    compute), and the bf16 kernels' padding to head dim 64 with the plain
    versions standing in for the kernels."""
    r = pallas_by_head_dim[(Dh, causal)]
    q, k, v, do = (torch.tensor(r[n]) for n in ("q", "k", "v", "do"))
    kw = dict(scale=Dh ** -0.5, causal=causal)
    o, lse = tfa.flash_fwd_plain(q, k, v, **kw)
    delta = (do * o).sum(dim=-1)
    plain = (o, lse, tfa.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw),
             *tfa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw))
    padded = _padded_path(q, k, v, do, head_dim=64, **kw)
    for got in (plain, padded):
        for x, name, atol in zip(got, ("o", "lse", "dq", "dk", "dv"),
                                 (O_ATOL, 2e-5, GRAD_ATOL, GRAD_ATOL, GRAD_ATOL)):
            assert x.shape == r[name].shape
            np.testing.assert_allclose(x.numpy(), r[name], atol=atol,
                                       err_msg=f"{name} D={Dh} causal={causal}")


@pytest.mark.parametrize("Dh", [1, 16, 20, 32, 48, 63, 65, 96, 100])
def test_padding_to_the_kernels_head_dim_changes_nothing(Dh):
    """Zero columns add exact zeros to q.k^T and do.v^T, delta = sum(do.o)
    is unchanged, and the scale stays the caller's: the padded path equals
    the unpadded plain versions within f32 summation order."""
    rng = np.random.default_rng(Dh)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 70, Dh),
                                                        dtype=np.float32))
                   for _ in range(4))
    kw = dict(scale=Dh ** -0.5, causal=True)
    _, Dk = tfa.kernel_plan(torch.bfloat16, Dh)
    o, lse = tfa.flash_fwd_plain(q, k, v, **kw)
    delta = (do * o).sum(dim=-1)
    want = (o, lse, tfa.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw),
            *tfa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw))
    got = _padded_path(q, k, v, do, head_dim=Dk, **kw)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.is_contiguous()
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype,Dh,plan", [
    (torch.bfloat16, 64, ("bf16", 64)), (torch.bfloat16, 16, ("bf16", 64)),
    (torch.bfloat16, 1, ("bf16", 64)), (torch.bfloat16, 65, ("bf16_wide", 128)),
    (torch.bfloat16, 96, ("bf16_wide", 128)),
    (torch.bfloat16, 128, ("bf16_wide", 128)), (torch.float32, 16, ("f32", 16)),
    (torch.float32, 20, ("f32", 32)), (torch.float32, 33, ("f32", 64)),
    (torch.float32, 64, ("f32", 64)), (torch.float32, 100, ("f32", 128)),
    (torch.float32, 128, ("f32", 128)),
])
def test_kernel_plan_dispatches_by_dtype_and_head_dim(dtype, Dh, plan):
    assert tfa.kernel_plan(dtype, Dh) == plan
    x = torch.ones(2, 3, Dh, dtype=dtype)
    padded = tfa.pad_head_dim(x, plan[1])
    assert padded.shape == (2, 3, plan[1]) and padded.dtype == dtype
    assert padded[..., :Dh].eq(1).all() and not padded[..., Dh:].any()
    assert tfa.unpad_head_dim(padded, Dh).equal(x)
    assert tfa.pad_head_dim(x, Dh) is x


@pytest.mark.parametrize("dtype,Dh,match", [
    (torch.float32, 0, "f32 head dims of 1 and more, got 0"),
    (torch.float64, 64, "bf16 or f32"),
])
def test_kernel_plan_refuses_what_no_kernel_takes(dtype, Dh, match):
    with pytest.raises(ValueError, match=match):
        tfa.kernel_plan(dtype, Dh)
    with pytest.raises(ValueError):
        tfa._check_cuda((torch.zeros(2, 8, Dh, dtype=dtype),) * 3)


@pytest.mark.parametrize("dtype,Dh,plan", [
    (torch.bfloat16, 257, ("bf16_dsplit", 320)),
    (torch.bfloat16, 320, ("bf16_dsplit", 320)),
    (torch.float32, 257, ("f32_dsplit", 320)),
    (torch.float16, 320, ("f16_f32_dsplit", 320)),
])
def test_kernel_plan_routes_head_dims_above_256_to_the_dsplit_kernels(
        dtype, Dh, plan):
    """Above 256 every dtype runs the split-head-dim kernels at the head
    dim padded to a multiple of 64, which the wrappers' checks take."""
    for kernel in tfa.KERNELS:
        assert tfa.kernel_plan(dtype, Dh, kernel) == plan
    assert tfa._check_cuda((torch.zeros(2, 8, Dh, dtype=dtype),) * 3) == (
        2, 8)


# ------------------------------------------ bf16 at head dims 65 to 128
# chip_smoke.py's bound for bf16 outputs, element by element: both sides
# round p (or ds) to bf16 before the second product and their outputs to
# bf16, at scales that differ (the Pallas forward rounds p against its
# running max, the plain version against the row's max).
BF16_RTOL, BF16_ATOL_RMS, BF16_FLOOR = 2.0 ** -6, 2.0 ** -3, 1e-5


def _assert_close_bf16(a, b, what):
    a, b = (np.asarray(x, dtype=np.float32) for x in (a, b))
    bound = (BF16_RTOL * np.abs(b) + BF16_ATOL_RMS * np.sqrt(np.mean(b * b))
             + BF16_FLOOR)
    worst = float((np.abs(a - b) / bound).max())
    assert worst <= 1.0, (what, worst)


@pytest.fixture(scope="module")
def pallas_bf16_wide():
    """_flash_fwd and _flash_bwd of the JAX package on bf16 inputs at head
    dims 96 and 128, S = 129, causal and not."""
    out = {}
    for Dh in (96, 128):
        for causal in (True, False):
            rng = np.random.default_rng(Dh + causal)
            q, k, v, do = (jnp.asarray(rng.standard_normal((2, 129, Dh),
                                                           dtype=np.float32),
                                       dtype=jnp.bfloat16) for _ in range(4))
            kw = dict(scale=Dh ** -0.5, causal=causal, block_q=JAX_BLOCK,
                      block_k=JAX_BLOCK, interpret=True)
            o, lse = jfa._flash_fwd(q, k, v, **kw)
            dq, dk, dv = jfa._flash_bwd(q, k, v, o, lse, do, **kw)
            out[(Dh, causal)] = {n: np.asarray(x.astype(jnp.float32)) for n, x
                                 in dict(q=q, k=k, v=v, do=do, o=o, lse=lse,
                                         dq=dq, dk=dk, dv=dv).items()}
    return out


@pytest.mark.parametrize("Dh", [96, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_wide_plain_versions_match_pallas(Dh, causal, pallas_bf16_wide):
    """bf16 at head dims above 64: what a wrapper computes for the
    bf16_wide kernels (zero-padded to head dim 128, the plain versions in
    the kernels' place) against the Pallas kernels on the same bf16
    inputs, under chip_smoke.py's bf16 bound; lse within 2e-5."""
    r = pallas_bf16_wide[(Dh, causal)]
    q, k, v, do = (torch.tensor(r[n]).to(torch.bfloat16)
                   for n in ("q", "k", "v", "do"))
    family, Dk = tfa.kernel_plan(torch.bfloat16, Dh)
    assert (family, Dk) == ("bf16_wide", 128)
    o, lse, dq, dk, dv = _padded_path(q, k, v, do, scale=Dh ** -0.5,
                                      causal=causal, head_dim=Dk)
    assert o.dtype == dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    np.testing.assert_allclose(lse.numpy(), r["lse"], atol=2e-5)
    for x, name in zip((o, dq, dk, dv), ("o", "dq", "dk", "dv")):
        assert x.shape == r[name].shape
        _assert_close_bf16(x.float().numpy(), r[name],
                           f"{name} D={Dh} causal={causal}")
