"""float16 in the port's flash attention (ray_tpu_torch.ops.flash_attention)
against the JAX package's, which takes any float dtype and head dim.

On the card float16 runs the f32 kernels on f32 copies of its inputs
(``kernel_plan`` family "f16_f32"), and o, dq, dk and dv are cast back to
float16. Here the route's plumbing is checked with the launch replaced by
a record, and its arithmetic with the f32 kernels' plain versions in
their place, against ``ray_tpu``'s ``flash_attention`` in float16 (Pallas
in interpret mode), forward and gradients; the CPU path (the plain
versions in float16) is held to the same reference. Above head dim 256
every dtype runs the split-head-dim kernels (float16 on f32 copies), and
the port's route at head dim 320 is held to ``ray_tpu``'s in each dtype.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jfa
from ray_tpu_torch.ops import flash_attention as tfa

B, S, H = 1, 129, 2  # S: one row past a 128-row Pallas block
JAX_BLOCK = 128
# float16 against float16, element by element: |got - want| <= F16_RTOL
# |want| + F16_ATOL_RMS rms(want) + F16_FLOOR. Both sides round their
# outputs to float16 (2^-11 relative) and the reference rounds p and ds to
# float16 before the products that take them (the Pallas kernels' casts),
# which the f32 route does not: a sum of a row's rounded terms moves by up
# to ~2^-11 of its largest term. The bound is a quarter of the bf16 one
# (chip_smoke.py: 2^-6 and 2^-3), which the card test uses.
F16_RTOL, F16_ATOL_RMS, F16_FLOOR = 2.0 ** -8, 2.0 ** -5, 1e-4


def _worst(got, want):
    got, want = (np.asarray(x, dtype=np.float64) for x in (got, want))
    bound = (F16_RTOL * np.abs(want) + F16_ATOL_RMS * np.sqrt(np.mean(want ** 2))
             + F16_FLOOR)
    return float((np.abs(got - want) / bound).max())


def _inputs(D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D), dtype=np.float32)
            .astype(np.float16) for _ in range(4)]


def _reference(q, k, v, ct, causal):
    """ray_tpu's flash_attention in float16 (interpret mode): o and the
    gradients of sum(o * ct)."""
    args = [jnp.asarray(x) for x in (q, k, v)]

    def f(q, k, v):
        return jfa.flash_attention(q, k, v, causal=causal, block_q=JAX_BLOCK,
                                   block_k=JAX_BLOCK, interpret=True)

    o, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(ct))
    return [np.asarray(x.astype(jnp.float32)) for x in (o, *grads)]


def _card_route(q, k, v, ct, causal):
    """What the wrappers do with float16 CUDA tensors, with each f32
    kernel's plain version in its place: f32 copies padded to the f32
    kernels' head dim, the forward, delta = sum(do.o) in f32 as the
    autograd backward forms it, dq and dk/dv, each output cast back to
    float16."""
    D = q.shape[-1]
    family, Dk = tfa.kernel_plan(torch.float16, D)
    assert family == "f16_f32" and tfa._SUFFIXES[family] == "_f32"

    def to_bh(x):
        return torch.from_numpy(x).transpose(1, 2).reshape(B * H, S, D)

    qb, kb, vb, dob = (to_bh(x) for x in (q, k, v, ct))
    qf, kf, vf, dof = tfa._kernel_inputs(family, (qb, kb, vb, dob), Dk)
    assert {t.dtype for t in (qf, kf, vf, dof)} == {torch.float32}
    kw = dict(scale=D ** -0.5, causal=causal)
    o, lse = tfa.flash_fwd_plain(qf, kf, vf, **kw)
    o16 = tfa._kernel_output(o, D, torch.float16)
    delta = (dob.float() * o16.float()).sum(dim=-1)
    dq = tfa.flash_bwd_dq_plain(qf, kf, vf, dof, lse, delta, **kw)
    dk, dv = tfa.flash_bwd_dkv_plain(qf, kf, vf, dof, lse, delta, **kw)
    outs = [o16] + [tfa._kernel_output(x, D, torch.float16)
                    for x in (dq, dk, dv)]
    assert all(x.dtype == torch.float16 for x in outs)
    return [x.float().reshape(B, H, S, D).transpose(1, 2).numpy()
            for x in outs]


def _cpu_path(q, k, v, ct, causal):
    """The port's flash_attention on CPU float16 tensors (the plain
    versions in float16), o and the gradients of sum(o * ct)."""
    args = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = tfa.flash_attention(*args, causal=causal)
    o.backward(torch.from_numpy(ct))
    assert o.dtype == torch.float16
    return [x.float().detach().numpy() for x in (o, *(a.grad for a in args))]


@pytest.mark.parametrize("D,causal", [(64, True), (100, False), (256, True)])
@pytest.mark.parametrize("path", ["card_route", "cpu"])
def test_float16_matches_the_reference(path, D, causal):
    q, k, v, ct = _inputs(D, D + causal)
    want = _reference(q, k, v, ct, causal)
    got = (_card_route if path == "card_route" else _cpu_path)(
        q, k, v, ct, causal)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert np.isfinite(g).all(), name
        assert _worst(g, w) <= 1.0, (name, _worst(g, w))


@pytest.mark.parametrize("D,Dk", [(16, 16), (100, 128), (129, 256), (256, 256)])
def test_the_route_launches_the_f32_kernels_on_f32_copies(monkeypatch, D, Dk):
    """float16 [BH, S, D] on the card: each wrapper launches the *_f32 entry
    of flash_attention_f32.cu at the f32 kernels' head dim, counted under
    the *_f32 counters, on f32 tensors, and hands back float16."""
    calls = []
    monkeypatch.setattr(tfa, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(tfa, "_launch", lambda entry, counter, device, *args:
                        calls.append((entry, counter, args[-3])))
    seen = []
    inputs = tfa._kernel_inputs
    monkeypatch.setattr(tfa, "_kernel_inputs", lambda family, ts, hd: seen.append(
        family) or inputs(family, ts, hd))
    q, k, v, do = (torch.zeros(2, 40, D, dtype=torch.float16)
                   for _ in range(4))
    lse, delta = torch.zeros(2, 40), torch.zeros(2, 40)
    kw = dict(scale=1.0, causal=True)
    o, _ = tfa.flash_fwd(q, k, v, **kw)
    dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    assert calls == [("flash_fwd_f32", "flash_fwd_f32", Dk),
                     ("flash_bwd_dq_f32", "flash_bwd_dq_f32", Dk),
                     ("flash_bwd_dkv_f32", "flash_bwd_dkv_f32", Dk)]
    assert seen == ["f16_f32"] * 3
    assert all(tfa._LIBRARY_OF[e] == "flash_attention_f32" for e, _, _ in calls)
    for x in (o, dq, dk, dv):
        assert x.dtype == torch.float16 and x.shape == (2, 40, D)
    assert [t.dtype for t in inputs("f16_f32", (q,), Dk)] == [torch.float32]


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32,
                                   torch.bfloat16])
def test_head_dim_320_matches_the_reference(dtype):
    """The reference computes head dim 320 (interpret mode, a tiny shape);
    the port's route for it, the split-head-dim family of the dtype at
    320 with the plain versions in the kernels' place, gives the same o
    and gradients of sum(o * ct): f32 within the JAX package's bounds,
    float16 within this file's, bf16 within chip_smoke.py's."""
    jdtype = {torch.float16: jnp.float16, torch.float32: jnp.float32,
              torch.bfloat16: jnp.bfloat16}[dtype]
    rng = np.random.default_rng(320)
    q, k, v, ct = (rng.standard_normal((1, 16, 1, 320), dtype=np.float32)
                   for _ in range(4))
    args = [jnp.asarray(x, dtype=jdtype) for x in (q, k, v)]
    o, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(
        q, k, v, causal=True, block_q=16, block_k=16, interpret=True), *args)
    want = [np.asarray(x.astype(jnp.float32))
            for x in (o, *vjp(jnp.asarray(ct, dtype=jdtype)))]
    assert want[0].shape == (1, 16, 1, 320) and np.isfinite(want[0]).all()

    for kernel in tfa.KERNELS:
        family, Dk = tfa.kernel_plan(dtype, 320, kernel)
        assert family.endswith("_dsplit") and Dk == 320
    qb, kb, vb, ctb = (torch.from_numpy(x).to(dtype).reshape(1, 16, 320)
                       for x in (q, k, v, ct))
    qf, kf, vf, ctf = tfa._kernel_inputs(family, (qb, kb, vb, ctb), Dk)
    kw = dict(scale=320 ** -0.5, causal=True)
    o, lse = tfa.flash_fwd_plain(qf, kf, vf, **kw)
    o = tfa._kernel_output(o, 320, dtype)
    delta = (ctb.float() * o.float()).sum(dim=-1)
    dq = tfa.flash_bwd_dq_plain(qf, kf, vf, ctf, lse, delta, **kw)
    dk, dv = tfa.flash_bwd_dkv_plain(qf, kf, vf, ctf, lse, delta, **kw)
    got = [tfa._kernel_output(x, 320, dtype) for x in (dq, dk, dv)]
    for name, g, w in zip(("o", "dq", "dk", "dv"), (o, *got), want):
        assert g.dtype == dtype, name
        g = g.float().reshape(w.shape).numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(g, w, atol=1e-4, err_msg=name)
        elif dtype == torch.float16:
            assert _worst(g, w) <= 1.0, (name, _worst(g, w))
        else:
            bound = (2.0 ** -6 * np.abs(w) + 2.0 ** -3 * np.sqrt(
                np.mean(w * w)) + 1e-5)
            assert (np.abs(g - w) / bound).max() <= 1.0, name
