"""The accuracy of the f32 kernels' products, known without a card: the
forward, dq and dk/dv of ray_tpu_torch/ops/csrc/flash_attention_f32.cu take
every product on the tensor cores in TF32 (10 mantissa bits) as 3xTF32,
and this test emulates that arithmetic in numpy.

The model, as the kernels run it: x = big + small with big = tf32(x),
rounded to nearest with ties away from zero (``cvt.rna``), and small =
x - big, whose low 13 bits the tensor cores drop (read as TF32 by
truncation). a.b is big.big + big.small + small.big. An MMA sums 8
products (exact here) into an f32 accumulator and truncates, as the
tensor cores do; big.big and the small terms accumulate apart and are
added once, rounded, and for dp big.big restarts from 0 every two MMAs.
Each 32-row tile of the accumulating products
(ds.k, p^T.do, ds^T.q) starts from 0 and is added to the sum, rounded.
dq, dk and dv built so at a small shape stay within a quarter of the
card's f32 bound against an f64 reference (chip_smoke.py's F32_RTOL,
F32_ATOL_RMS, F32_FLOOR); one TF32 pass breaks it many times over.
Summing all three passes into one accumulator over the whole sequence
(CUTLASS's order) loses about twice as much as the kernels' arrangement
here, and read 0.65 of the bound on the card at S 1024 (PERF.md).

The forward streams K and V in the same 32-row tiles with the online
softmax: per tile the scores (3xTF32), the running max m and the rescale
factor corr = exp2((m_old - m) scale log2(e)), p = exp2(s scale log2(e) -
m scale log2(e)), l = l corr + the tile's row sums, o = o corr and then
the tile's p.v (3xTF32, from 0) added, rounded; at the end o / max(l,
1e-30) and lse = m scale + log(l). o built so stays within a quarter of
the f32 bound against f64 and against the Pallas _fwd_kernel (interpret
mode), lse within chip_smoke.py's 2e-5; one TF32 pass breaks the bound.

At head dim 256 the forward and dq run on wgmma (flash_fwd_d256_tc_kernel,
flash_bwd_dq_d256_tc_kernel) with 16-row K/V tiles: dq's s and dp
contract over 32 MMAs of 8 as above, the forward's s with big.big,
big.small and small.big in three chains added in f32 at the end; o and dq
take each tile's product (two MMAs over its 16 KV rows; dq as dq^T, the
same sums) from 0 and add it in f32, rounded; dk/dv
(flash_bwd_dkv_d256_tc_kernel) takes 8-row Q tiles. The same bounds hold
there.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.ops import flash_attention as jfa

# chip_smoke.py's bound for the f32 kernels against their plain versions
F32_RTOL = 2.0 ** -14
F32_ATOL_RMS = 2.0 ** -14
F32_FLOOR = 1e-6
LSE_ABS_TOL = 2e-5
BH, S, D, SEED = 2, 129, 64, 0
TILE = 32  # rows of a streamed tile at head dim 64
# head dim 256: the wgmma forward and dq stream 16-row K/V tiles, the
# dk/dv kernel 8-row Q tiles
D256, TILE256, DKV256_TILE = 256, 16, 8
MMA_K = 8  # products an MMA sums


def tf32_rna(x):
    """x rounded to 10 mantissa bits, to nearest, ties away from zero."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_trunc(x):
    """x with its low 13 mantissa bits dropped, as the tensor cores read an
    f32 register as TF32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def to_f32_toward_zero(x):
    """f64 -> f32, truncated toward zero."""
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def mma_sum(a, b, acc):
    """acc += a.b over the last axis of a / first of b, MMA by MMA: the
    sum of each MMA's 8 products is exact, the accumulator truncates."""
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    for k0 in range(0, a.shape[-1], MMA_K):
        part = np.matmul(a64[..., k0:k0 + MMA_K], b64[..., k0:k0 + MMA_K, :])
        acc = to_f32_toward_zero(acc.astype(np.float64) + part)
    return acc


def product(a, b, mode, restart=False):
    """a.b (a [..., M, K], b [..., K, N], f32) as the kernels take it:
    "3xtf32" (big.big and the small terms in accumulators of their own,
    added once, rounded; with ``restart``, as for dp, big.big also starts
    from 0 every two MMAs and is added in f32, rounded), "one_accumulator"
    (the three passes of every MMA into one accumulator) or "1xtf32"
    (big.big alone)."""
    big_a, big_b = tf32_rna(a), tf32_rna(b)
    small_a, small_b = tf32_trunc(a - big_a), tf32_trunc(b - big_b)
    zero = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    if mode == "1xtf32":
        return mma_sum(big_a, big_b, zero)
    big, small, part = zero, zero, zero
    for i, k0 in enumerate(range(0, a.shape[-1], MMA_K)):
        ba, sa = big_a[..., k0:k0 + MMA_K], small_a[..., k0:k0 + MMA_K]
        bb, sb = big_b[..., k0:k0 + MMA_K, :], small_b[..., k0:k0 + MMA_K, :]
        if mode == "one_accumulator":  # the small terms first, one sum
            big = mma_sum(ba, sb, big)
            big = mma_sum(sa, bb, big)
            big = mma_sum(ba, bb, big)
        else:
            if restart:
                part = mma_sum(ba, bb, part)
                if i % 2:
                    big, part = big + part, zero
            else:
                big = mma_sum(ba, bb, big)
            small = mma_sum(ba, sb, small)
            small = mma_sum(sa, bb, small)
    return big + (part + small)


def scores_three_chains(a, b, mode):
    """a.b as scores_ss of the head-dim-256 forward takes it: big.big,
    big.small and small.big each in a chain of its own, added in f32 at
    the end."""
    if mode != "3xtf32":
        return product(a, b, mode)
    big_a, big_b = tf32_rna(a), tf32_rna(b)
    small_a, small_b = tf32_trunc(a - big_a), tf32_trunc(b - big_b)
    zero = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    bb, bs, sb = zero, zero, zero
    for k0 in range(0, a.shape[-1], MMA_K):
        ba, sa = big_a[..., k0:k0 + MMA_K], small_a[..., k0:k0 + MMA_K]
        bbk, sbk = big_b[..., k0:k0 + MMA_K, :], small_b[..., k0:k0 + MMA_K, :]
        bb = mma_sum(ba, bbk, bb)
        bs = mma_sum(ba, sbk, bs)
        sb = mma_sum(sa, bbk, sb)
    return bb + (bs + sb)


def accumulate(a, b, mode, tile=TILE):
    """sum over the shared axis in ``tile``-row tiles, each tile's product
    from 0 and added in f32, rounded (in "one_accumulator", the whole
    axis into one accumulator, as before the kernels kept them apart)."""
    if mode == "one_accumulator":
        return product(a, b, mode)
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for t0 in range(0, a.shape[-1], tile):
        acc = acc + product(a[..., t0:t0 + tile], b[..., t0:t0 + tile, :],
                            mode)
    return acc


def backward(q, k, v, do, lse, delta, mode, scale, causal, tiles=(TILE,
                                                                  TILE),
             scores=product):
    """dq, dk, dv as the kernels compute them, products by ``mode``;
    ``tiles``: the rows of dq's K/V tiles and of dk/dv's Q tiles;
    ``scores``: how s and dp are taken."""
    mask = np.tril(np.ones((S, S), bool)) if causal else np.ones((S, S), bool)
    kt, vt = np.swapaxes(k, 1, 2), np.swapaxes(v, 1, 2)
    s = scores(q, kt, mode)
    dp = scores(do, vt, mode, restart=True)
    p = np.where(mask, np.exp(s * np.float32(scale) - lse[..., None]),
                 np.float32(0)).astype(np.float32)
    ds = (p * (dp - delta[..., None]) * np.float32(scale)).astype(np.float32)
    dq = accumulate(ds, k, mode, tiles[0])
    dv = accumulate(np.swapaxes(p, 1, 2), do, mode, tiles[1])
    dk = accumulate(np.swapaxes(ds, 1, 2), q, mode, tiles[1])
    return dq, dk, dv


def reference(q, k, v, do, scale, causal):
    """lse, delta and dq, dk, dv in f64."""
    q, k, v, do = (x.astype(np.float64) for x in (q, k, v, do))
    mask = np.tril(np.ones((S, S), bool)) if causal else np.ones((S, S), bool)
    s = np.where(mask, q @ np.swapaxes(k, 1, 2) * scale, -np.inf)
    m = s.max(-1, keepdims=True)
    lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    p = np.exp(s - lse[..., None])
    o = p @ v
    delta = (do * o).sum(-1)
    ds = p * (do @ np.swapaxes(v, 1, 2) - delta[..., None]) * scale
    return lse, delta, (ds @ k, np.swapaxes(ds, 1, 2) @ q,
                        np.swapaxes(p, 1, 2) @ do)


def worst_share(got, want):
    """The worst element's error over the card's f32 bound."""
    rms = np.sqrt(np.mean(want * want))
    bound = F32_RTOL * np.abs(want) + F32_ATOL_RMS * rms + F32_FLOOR
    return float((np.abs(got.astype(np.float64) - want) / bound).max())


@pytest.fixture(scope="module", params=[True, False], ids=["causal", "full"])
def case(request):
    causal = request.param
    rng = np.random.default_rng(SEED)
    q, k, v, do = (rng.standard_normal((BH, S, D), dtype=np.float32)
                   for _ in range(4))
    scale = D ** -0.5
    lse, delta, want = reference(q, k, v, do, scale, causal)
    shares = {}
    for mode in ("3xtf32", "one_accumulator", "1xtf32"):
        got = backward(q, k, v, do, lse.astype(np.float32),
                       delta.astype(np.float32), mode, scale, causal)
        shares[mode] = [worst_share(g, w) for g, w in zip(got, want)]
    return shares


def test_split_is_exact_to_tf32_rounding():
    """big is x rounded to TF32 as cvt.rna rounds (ties away from zero),
    x - big is exact in f32, and big + small carries x to ~2^-21."""
    x = np.array([1.0, 1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11,
                  1 + 2.0 ** -11 - 2.0 ** -23, 3.3e-3, -7.77e5], np.float32)
    big = tf32_rna(x)
    np.testing.assert_array_equal(
        big[:5], np.array([1.0, 1 + 2.0 ** -10, -(1 + 2.0 ** -10),
                           1 + 4 * 2.0 ** -11, 1.0], np.float32))
    assert not (big.view(np.uint32) & 0x1FFF).any()
    small = x - big
    np.testing.assert_array_equal(big.astype(np.float64) + small, x)
    rng = np.random.default_rng(SEED)
    y = rng.standard_normal(4096).astype(np.float32)
    two = tf32_rna(y).astype(np.float64) + tf32_trunc(y - tf32_rna(y))
    assert np.max(np.abs(two - y) / np.abs(y)) <= 2.0 ** -21


def test_3xtf32_is_within_a_quarter_of_the_f32_bound(case):
    """dq, dk, dv from 3xTF32 products against f64: the worst element of
    each within a quarter of the card's f32 bound."""
    assert max(case["3xtf32"]) <= 0.25, case["3xtf32"]


def test_one_tf32_pass_is_not_f32(case):
    """big.big alone, one TF32 pass, breaks the card's f32 bound."""
    assert max(case["1xtf32"]) > 1.0, case["1xtf32"]


def test_summing_the_passes_in_one_accumulator_costs_accuracy(case):
    """The three passes of every MMA, and every tile, into one truncating
    accumulator lose more than the kernels' arrangement does."""
    assert max(case["one_accumulator"]) > max(case["3xtf32"]), case


# ---------------------------------------------------------------- forward
LOG2E = np.float32(1.4426950408889634)
NEG_INF = np.float32(-1e30)


def forward(q, k, v, mode, scale, causal, tile=TILE, scores=product):
    """o and lse as the forward kernel computes them, products by
    ``mode``: ``tile``-row K/V tiles, the online max and sum in f32;
    ``scores``: how s is taken."""
    mask = np.tril(np.ones((S, S), bool)) if causal else np.ones((S, S), bool)
    scale2 = np.float32(scale) * LOG2E
    m = np.full((BH, S), NEG_INF, np.float32)  # running max of raw scores
    l = np.zeros((BH, S), np.float32)
    acc = np.zeros(q.shape, np.float32)
    for t0 in range(0, S, tile):
        kt = np.swapaxes(k[:, t0:t0 + tile], 1, 2)
        s = np.where(mask[:, t0:t0 + tile], scores(q, kt, mode), NEG_INF)
        m_new = np.maximum(m, s.max(-1))
        corr = np.exp2((m - m_new) * scale2)
        p = np.exp2(s * scale2 - (m_new * scale2)[..., None])
        l = l * corr + p.sum(-1, dtype=np.float32)
        acc = acc * corr[..., None] + product(p, v[:, t0:t0 + tile], mode)
        m = m_new
    lc = np.maximum(l, np.float32(1e-30))
    return acc / lc[..., None], m * np.float32(scale) + np.log(lc)


def _fwd_shares(causal, head_dim, tile, scores=product):
    """Per mode, o's worst element over the f32 bound against f64 and
    against the Pallas forward, and lse's largest error against f64."""
    rng = np.random.default_rng(SEED + 1)
    q, k, v = (rng.standard_normal((BH, S, head_dim), dtype=np.float32)
               for _ in range(3))
    scale = head_dim ** -0.5
    q64, k64, v64 = (x.astype(np.float64) for x in (q, k, v))
    mask = np.tril(np.ones((S, S), bool)) if causal else np.ones((S, S), bool)
    s64 = np.where(mask, q64 @ np.swapaxes(k64, 1, 2) * scale, -np.inf)
    lse64 = np.log(np.exp(s64 - s64.max(-1, keepdims=True)).sum(-1)) + \
        s64.max(-1)
    o64 = np.exp(s64 - lse64[..., None]) @ v64
    o_pl, _ = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             scale=scale, causal=causal, block_q=128,
                             block_k=128, interpret=True)
    o_pl = np.asarray(o_pl).astype(np.float64)
    out = {}
    for mode in ("3xtf32", "1xtf32"):
        o, lse = forward(q, k, v, mode, scale, causal, tile, scores)
        out[mode] = {"f64": worst_share(o, o64),
                     "pallas": worst_share(o, o_pl),
                     "lse": float(np.abs(lse - lse64).max())}
    return out


@pytest.fixture(scope="module", params=[True, False], ids=["causal", "full"])
def fwd_case(request):
    return _fwd_shares(request.param, D, TILE)


def test_forward_3xtf32_is_within_a_quarter_of_the_f32_bound(fwd_case):
    """The forward's o from 3xTF32 products, against f64 and against the
    Pallas forward: the worst element within a quarter of the card's f32
    bound; lse within 2e-5."""
    got = fwd_case["3xtf32"]
    assert got["f64"] <= 0.25 and got["pallas"] <= 0.25, got
    assert got["lse"] <= LSE_ABS_TOL, got


def test_forward_one_tf32_pass_is_not_f32(fwd_case):
    """big.big alone, one TF32 pass, breaks the f32 bound on o."""
    assert fwd_case["1xtf32"]["f64"] > 1.0, fwd_case["1xtf32"]


# ------------------------------------------------------------ head dim 256
@pytest.fixture(scope="module", params=[True, False], ids=["causal", "full"])
def case256(request):
    """dq, dk, dv at head dim 256 with its kernels' tiles, per mode."""
    causal = request.param
    rng = np.random.default_rng(SEED + 2)
    q, k, v, do = (rng.standard_normal((BH, S, D256), dtype=np.float32)
                   for _ in range(4))
    scale = D256 ** -0.5
    lse, delta, want = reference(q, k, v, do, scale, causal)
    shares = {}
    for mode in ("3xtf32", "1xtf32"):
        got = backward(q, k, v, do, lse.astype(np.float32),
                       delta.astype(np.float32), mode, scale, causal,
                       tiles=(TILE256, DKV256_TILE))
        shares[mode] = [worst_share(g, w) for g, w in zip(got, want)]
    return shares


@pytest.fixture(scope="module", params=[True, False], ids=["causal", "full"])
def fwd_case256(request):
    return _fwd_shares(request.param, D256, TILE256, scores_three_chains)


def test_d256_3xtf32_is_within_a_quarter_of_the_f32_bound(case256):
    """dq (16-row K/V tiles, dp's restart every two of its 32 MMAs), dk and
    dv (8-row Q tiles) at head dim 256 against f64: within a quarter of the
    card's f32 bound; one TF32 pass is not."""
    assert max(case256["3xtf32"]) <= 0.25, case256["3xtf32"]
    assert max(case256["1xtf32"]) > 1.0, case256["1xtf32"]


def test_d256_forward_3xtf32_is_within_a_quarter_of_the_f32_bound(
        fwd_case256):
    """The head-dim-256 forward's o (16-row K/V tiles, each tile's p.v from
    0, o = o.corr + it) against f64 and the Pallas forward within a quarter
    of the f32 bound, lse within 2e-5; one TF32 pass breaks the bound."""
    got = fwd_case256["3xtf32"]
    assert got["f64"] <= 0.25 and got["pallas"] <= 0.25, got
    assert got["lse"] <= LSE_ABS_TOL, got
    assert fwd_case256["1xtf32"]["f64"] > 1.0, fwd_case256["1xtf32"]
