"""The head-dim-256 plumbing of the wgmma kernels (flash_fwd_d256_kernel,
flash_bwd_dkv_d256_kernel and flash_bwd_dq_d256_kernel of
ray_tpu_torch/ops/csrc/flash_attention.cu), known without a card.

At head dim 256 a [rows, 256] tile lands as four 128-byte-swizzled boxes
[rows, 64], box h at h * rows * 128 bytes; a K-major operand's k-steps
4h to 4h + 3 read box h and an MN-major operand's box h feeds output
columns 64h to 64h + 63. The numpy model of shared memory, TMA's swizzle
and wgmma's descriptors is tests/test_torch_wgmma_layout.py's; here it is
driven at the head-dim-256 kernels' tile shapes and stage offsets, with
their constants read from the source, and the kernels' shared memory is
checked against the 232,448 bytes a block may take (the dq kernel's
products are tests/test_torch_wgmma_dq_d256.py's).
"""
import re

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import flash_attention as tfa
from tests.test_torch_wgmma_layout import (C, SRC, Smem, _c_entries,
                                           _cu_int_expr, _ints, half_desc,
                                           sw128_desc, values)

D = 256
MAX_SMEM = 232448  # bytes of shared memory a block may take on an H100


def _const(name):
    """A constexpr int of flash_attention.cu."""
    m = re.search(rf"constexpr int {name} = ([^;]+);", SRC)
    assert m, name
    return _cu_int_expr(m.group(1), C)


K_STAGES, V_STAGES = _const("kFwd256KStages"), _const("kFwd256VStages")
DKV_ROWS, DKV_STAGES = _const("kDkv256BlockM"), _const("kDkv256Stages")
DQ_K_STAGES, DQ_V_STAGES = _const("kDq256KStages"), _const("kDq256VStages")


def issue_abt(smem, desc_a, half_a, rows_a, desc_b, half_b, rows_b):
    """issue_abt<256>: d = A.B^T over D, k-step kk in box kk / 4. Returns d
    and the (tile, box) each k-step read."""
    d = np.zeros((rows_a, rows_b), dtype=np.int64)
    read = []
    for kk in range(D // 16):
        h, k = divmod(kk, C["kKStepsPerHalf"])
        a = smem.read_k_major(desc_a + h * half_a + k * C["kDescK16"], rows_a)
        b = smem.read_k_major(desc_b + h * half_b + k * C["kDescK16"], rows_b)
        read.append({(cell[0], cell[2] // C["kHalfD"]) for row in a + b
                     for cell in row})
        d += values(a) @ values(b).T
    return d, read


def issue_ab(smem, a, desc_b, half_b, cols):
    """issue_ab<cols, kK>: d += A.B over kK rows, A in registers, B read
    MN-major, one 64-column product a box. Returns d and the columns of B
    each box's product read."""
    d = np.zeros((a.shape[0], cols), dtype=np.int64)
    read = {}
    for kk in range(a.shape[1] // 16):
        for h in range(cols // C["kHalfD"]):
            b = smem.read_mn_major(desc_b + h * half_b + kk * C["kDescMN16"],
                                   C["kHalfD"])
            assert {cell[1] for row in b for cell in row} == set(
                range(16 * kk, 16 * kk + 16))
            read.setdefault(h, set()).update(cell[2] for row in b
                                             for cell in row)
            d[:, 64 * h:64 * h + 64] += a[:, 16 * kk:16 * kk + 16] @ values(b)
    return d, read


def test_the_head_dim_256_constants():
    assert (K_STAGES, V_STAGES) == (3, 2)
    assert (DKV_ROWS, DKV_STAGES) == (64, 2)
    assert (DQ_K_STAGES, DQ_V_STAGES) == (2, 1)
    assert C["kBlockM"] == 128 and C["kFwdBlockN"] == C["kDkvBlockN"] == 64


def test_four_boxes_cover_a_tile_once():
    """Each [rows, 256] tile at the kernels' shapes (the forward's 128 Q
    rows and 64-row K/V stages, dk/dv's 64 KV rows and 64-row Q/dO stages)
    fills rows * 512 bytes exactly, each element once, box h in its own
    rows * 128 bytes."""
    rng = np.random.default_rng(0)
    for rows in (C["kBlockM"], C["kFwdBlockN"], DKV_ROWS):
        smem = Smem()
        x = _ints(rng, rows, D)
        smem.tma_tile(4096, "x", x)
        assert sorted(smem.at) == list(range(4096, 4096 + rows * 2 * D, 2))
        assert sorted((r, c) for _, r, c, _ in smem.at.values()) == [
            (r, c) for r in range(rows) for c in range(D)]
        for a, (_, _, c, _) in smem.at.items():
            assert (a - 4096) // (rows * C["kRowBytes"]) == c // C["kHalfD"]


def test_forward_products_at_head_dim_256():
    """s = q.k^T (each warpgroup's 64 rows of the 128-row Q tile against a
    64-row K stage, 16 k-steps over four boxes) and o += p.v (the V stage
    MN-major, one product a box), exact, at the kernel's ring offsets: K
    stage 2 of 3 and V stage 1 of 2 after it."""
    rng = np.random.default_rng(1)
    n = C["kFwdBlockN"]
    q, k, v = _ints(rng, C["kBlockM"], D), _ints(rng, n, D), _ints(rng, n, D)
    tile = n * D * 2
    sQ = 1024
    sK = sQ + C["kBlockM"] * D * 2
    sV = sK + K_STAGES * tile
    smem = Smem()
    smem.tma_tile(sQ, "q", q)
    smem.tma_tile(sK + 2 * tile, "k", k)
    smem.tma_tile(sV + tile, "v", v)
    for wg in (0, 1):
        s, read = issue_abt(smem, sw128_desc(sQ + wg * 64 * C["kRowBytes"]),
                            half_desc(C["kBlockM"]), 64,
                            sw128_desc(sK + 2 * tile), half_desc(n), n)
        np.testing.assert_array_equal(s, q[64 * wg:64 * wg + 64] @ k.T)
        assert read == [{("q", kk // 4), ("k", kk // 4)} for kk in range(16)]
    p = _ints(rng, 64, n)
    o, cols = issue_ab(smem, p, sw128_desc(sV + tile), half_desc(n), D)
    np.testing.assert_array_equal(o, p @ v)
    assert cols == {h: set(range(64 * h, 64 * h + 64)) for h in range(4)}


def _dkv_smem(rng):
    """dk/dv's K and V (64 rows) and a Q and dO stage (stage 1 of 2) in
    shared memory, at the kernel's offsets."""
    n = C["kDkvBlockN"]
    k, v = _ints(rng, DKV_ROWS, D), _ints(rng, DKV_ROWS, D)
    q, do = _ints(rng, n, D), _ints(rng, n, D)
    sK = 1024
    sV = sK + DKV_ROWS * D * 2
    sQ = sV + DKV_ROWS * D * 2 + n * D * 2  # stage 1
    sdO = sV + DKV_ROWS * D * 2 + DKV_STAGES * n * D * 2 + n * D * 2
    smem = Smem()
    for base, name, x in ((sK, "k", k), (sV, "v", v), (sQ, "q", q),
                          (sdO, "do", do)):
        smem.tma_tile(base, name, x)
    descs = {name: sw128_desc(base) for name, base in
             (("k", sK), ("v", sV), ("q", sQ), ("do", sdO))}
    return smem, descs, dict(k=k, v=v, q=q, do=do)


def test_dkv_products_at_head_dim_256():
    """dk/dv's transposed scores over all four boxes, s^T = k.q^T (warpgroup
    0) and dp^T = v.do^T (warpgroup 1), and the accumulating products
    dv += p^T.do (warpgroup 0) and dk += ds^T.q (warpgroup 1) over all of
    D's columns, one MN-major product a box, exact."""
    rng = np.random.default_rng(2)
    smem, desc, x = _dkv_smem(rng)
    half_kv, half_q = half_desc(DKV_ROWS), half_desc(C["kDkvBlockN"])
    for a, b in (("k", "q"), ("v", "do")):
        d, read = issue_abt(smem, desc[a], half_kv, DKV_ROWS, desc[b], half_q,
                            C["kDkvBlockN"])
        np.testing.assert_array_equal(d, x[a] @ x[b].T)
        assert read == [{(a, kk // 4), (b, kk // 4)} for kk in range(16)]
    for b in ("do", "q"):
        pt = _ints(rng, DKV_ROWS, C["kDkvBlockN"])
        d, cols = issue_ab(smem, pt, desc[b], half_q, D)
        np.testing.assert_array_equal(d, pt @ x[b])
        assert cols == {h: set(range(64 * h, 64 * h + 64)) for h in range(4)}


def test_p_exchange_layout():
    """dk/dv's warpgroup 0 writes thread tw's 32 values of p^T at
    i * 128 + tw of a 16 KB buffer and warpgroup 1's thread tw reads the
    same places: the two warpgroups' fragments of a 64 x 64 accumulator
    match element for element, so each value lands where its reader looks,
    every float of the buffer once, and a warp's 32 accesses of one i hit
    32 distinct banks."""
    threads = 128
    where = {(tw, i): i * threads + tw for tw in range(threads)
             for i in range(32)}
    assert sorted(where.values()) == list(range(DKV_ROWS *
                                                C["kDkvBlockN"]))
    for warp in range(4):
        for i in range(32):
            assert len({where[(32 * warp + lane, i)] % 32
                        for lane in range(32)}) == 32


def test_head_dim_256_shared_memory_fits_one_block():
    """fwd256_smem_bytes(), dkv256_smem_bytes() and dq256_smem_bytes() as
    the source computes them fit the 227 KB a block may take;
    flash_fwd_kernel's four K/V stages at head dim 256 would not, nor would
    flash_bwd_dq_kernel's."""
    def body(fn):
        return re.search(rf"constexpr int {fn}\(\) \{{\s*return ([^;]+);",
                         SRC).group(1)

    env = {**C, "kFwd256KStages": K_STAGES, "kFwd256VStages": V_STAGES,
           "kDkv256BlockM": DKV_ROWS, "kDkv256Stages": DKV_STAGES,
           "kDq256KStages": DQ_K_STAGES, "kDq256VStages": DQ_V_STAGES}
    fwd, dkv, dq = (_cu_int_expr(body(fn), env) for fn in (
        "fwd256_smem_bytes", "dkv256_smem_bytes", "dq256_smem_bytes"))
    assert (fwd, dkv, dq) == (230488, 231496, 230456)
    assert max(fwd, dkv, dq) <= MAX_SMEM
    for fn in ("fwd_smem_bytes", "dq_smem_bytes"):
        four_stages = _cu_int_expr(re.sub(r"\bD\b", "256", body(fn)),
                                   {**C, "kFwdStages": _const("kFwdStages")})
        assert four_stages > MAX_SMEM, fn


def test_bf16_head_dim_256_launches_its_entries(monkeypatch):
    """bf16 head dim 200: the forward, dq and dk/dv launch the bf16_d256
    entries of flash_attention.cu at head dim 256 with the arguments they
    take."""
    calls = []
    monkeypatch.setattr(tfa, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(tfa, "_launch", lambda entry, counter, device, *args:
                        calls.append((entry, counter, args)))
    q, k, v, do = (torch.zeros(2, 40, 200, dtype=torch.bfloat16)
                   for _ in range(4))
    lse, delta = torch.zeros(2, 40), torch.zeros(2, 40)
    kw = dict(scale=1.0, causal=True)
    o, _ = tfa.flash_fwd(q, k, v, **kw)
    dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    assert o.shape == dq.shape == dk.shape == dv.shape == (2, 40, 200)
    assert o.dtype == dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert [(e, c, tfa._LIBRARY_OF[e]) for e, c, _ in calls] == [
        ("flash_fwd_bf16d256", "flash_fwd_bf16d256", "flash_attention"),
        ("flash_bwd_dq_bf16d256", "flash_bwd_dq_bf16d256", "flash_attention"),
        ("flash_bwd_dkv_bf16d256", "flash_bwd_dkv_bf16d256",
         "flash_attention")]
    for entry, _, args in calls:
        lib = tfa._LIBRARY_OF[entry]
        assert _c_entries(lib)[entry] == len(args) + 1
        assert len(tfa._ENTRIES[lib][entry]) == len(args) + 1
        assert args[-3] == D


@pytest.mark.parametrize("kernel,kid", [("flash_fwd_bf16d256", 0),
                                        ("flash_bwd_dkv_bf16d256", 1),
                                        ("flash_bwd_dq_bf16d256", 2)])
def test_bf16_d256_kernels_are_asked_about_at_256(kernel, kid):
    assert tfa._head_dim_of(kernel, None) == D
    assert tfa._KERNEL_IDS[kernel.removesuffix(tfa._suffix(kernel))] == kid
    assert tfa._LIBRARY_OF[tfa._entry(kernel)] == "flash_attention"
