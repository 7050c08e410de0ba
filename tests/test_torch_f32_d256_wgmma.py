"""The f32 forward and dq at head dim 256 on wgmma (flash_fwd_d256_tc_kernel
and flash_bwd_dq_d256_tc_kernel of
ray_tpu_torch/ops/csrc/flash_attention_f32.cu), known without a card.

A block is a consumer warpgroup and a producer warpgroup. The producer
splits each K and V element once into big and small and writes both into
a single stage each, eight 128-byte-swizzled slabs of 32 columns, each
the tile's 16 big rows then its 16 small ones (``split_at``). dq's s =
q.k^T and dp = do.v^T read that tile K-major through wgmma descriptors
against A fragments of Q or dO loaded as ``a_frag`` loads them; the
forward's s reads Q split the same way, by all threads at the start
(``split_q``), as a second descriptor; o^T +=
v^T.p^T and dq^T += k^T.ds^T read x^T (x = V or K) from
the same tile as register A fragments and p or ds, which the consumer
writes split (``x_at``), K-major as B. With the constants and index
expressions read from the source, a numpy model of shared memory, the
128-byte swizzle (bits 4-6 of a byte address XORed by bits 7-9) and
wgmma's K-major reads (element (row, k) of a k-step at start + SBO
(row / 8) + 128 (row % 8) + 4 k, 4-byte elements) checks:

1. every element the split pass writes lands once, and where the score
   product's descriptors read it, at the k index that the A fragment
   gives the same column (columns 0, 2, 4, 6, 1, 3, 5, 7 of a k-step);
   the products come out exact on small integers; a quarter warp's
   16-byte stores hit eight distinct chunks;
2. the A fragments of x^T and the B operand p or ds, as the consumer
   writes it, meet at the same KV row, and o^T and dq^T come out exact and
   are stored at the right (Q row, column);
3. each kernel's shared memory fits the 232,448 bytes a block may take;
4. the two single-stage rings, driven by the order of the mbarrier calls
   as the source has them, under random interleavings of producer and
   consumer: no wait blocks forever, the consumer finds the tile it waits
   for, and the producer never refills a stage the consumer still holds.
"""
import functools
import random
import re
from pathlib import Path

import numpy as np
import pytest

from ray_tpu_torch.ops import flash_attention as tfa
from tests.test_torch_wgmma_layout import decode, swizzle

# the f32 kernels' source: flash_attention_f32.cu after the headers it
# includes (tf32_mma.cuh's 3xTF32 helpers and tile constants, wgmma_tf32.cuh's
# barriers, descriptors and p or ds tile, shared with the dsplit kernels)
SRC = "".join((Path(tfa.__file__).resolve().parent / "csrc" / name).read_text()
              for name in ("tf32_mma.cuh", "wgmma_tf32.cuh",
                           "flash_attention_f32.cu"))
MAX_SMEM = 232448  # bytes of shared memory a block may take on an H100
D = 256


def _int_expr(expr, env):
    return int(eval(" ".join(expr.split()).replace("/", "//"), {}, dict(env)))


def _const(name, env):
    m = re.search(rf"constexpr int {name} = ([^;]+);", SRC)
    assert m, name
    return _int_expr(m.group(1), env)


def _function(signature):
    """The body of a function of the source, from its signature on."""
    body = SRC[SRC.index(signature):]
    return body[:body.index("\n}\n")]


C = {}
for _name in ("kTile", "kTcWarps", "kTcThreads", "kD256Threads", "kD256Rows",
              "kSlabCols", "kSlabBytes", "kSmallWords", "kKvTileBytes",
              "kQSlabBytes", "kQSplitBytes", "kXSplitBytes", "kDqStash",
              "kVtSmallWords"):
    C[_name] = _const(_name, C)
BN = C["kD256Rows"]
SPLIT_AT = _function("int split_at(int r, int c)")
X_AT = _function("int x_at(int row, int col)")
SCORES = _function("__device__ __forceinline__ void scores_rs(")
SCORES_SS = _function("__device__ __forceinline__ void scores_ss(")
SPLIT_Q = _function("__device__ __forceinline__ void split_q(")
ACCUMULATE = _function("__device__ __forceinline__ void accumulate_t(")
STORE_SPLIT = _function("__device__ __forceinline__ void store_split(")
STORE_X = _function("__device__ __forceinline__ void store_x(")
STORE_T = _function("__device__ __forceinline__ void store_t(")
STORE_SPLIT_T = _function("__device__ __forceinline__ void store_split_t(")
VT_AT = _function("int vt_at(int d, int kv)")
ACCUMULATE_PV = _function("__device__ __forceinline__ void accumulate_pv(")
PRODUCE = _function("__device__ __forceinline__ void produce_d256(")
FWD = _function("flash_fwd_d256_tc_kernel(const float*")
DQ = _function("flash_bwd_dq_d256_tc_kernel(const float*")


def split_at(r, c, rows=None):
    """split_at<rows> of the source: the word of element (r, c) of a split
    K or V tile (the default rows, 2 kD256Rows) or of one half of the
    forward's split Q tile (kTile rows)."""
    default = re.search(r"template <int kRows = ([^>]+)>", SRC).group(1)
    rows = _int_expr(default, C) if rows is None else rows
    f = _int_expr(re.search(r"const int f = ([^;]+);", SPLIT_AT).group(1),
                  dict(c=c))
    return _int_expr(re.search(r"return ([^;]+);", SPLIT_AT).group(1),
                     dict(C, r=r, c=c, f=f, kRows=rows))


def x_at(row, col):
    return _int_expr(re.search(r"return ([^;]+);", X_AT).group(1),
                     dict(C, row=row, col=col))


def a_frag_cols(kk, t):
    """The columns of a_frag's k indices t and t + 4 at k-step kk: the
    pair (c, c + 1), c = 8 kk + 2 t, as scores_d256 asks for them."""
    assert "fa[b] = a_frag<L>(opaque(a), row, 8 * kk + 2 * t4);" in SCORES
    assert "const float x[4] = {lo.x, hi.x, lo.y, hi.y};" in SRC  # a_frag
    c = 8 * kk + 2 * t
    return c, c + 1


def k_column(kk, k):
    """The tile column that the A fragment gives k index k of k-step kk."""
    return a_frag_cols(kk, k % 4)[k // 4]


def sw128_desc(saddr):
    """sw128_desc of the source, whose stride byte offset is read there."""
    sbo = int(re.search(r"\(uint64_t\)\((\d+) >> 4\) << 32",
                        _function("uint64_t sw128_desc(uint32_t saddr)"))
              .group(1))
    return ((saddr & 0x3FFFF) >> 4) | (1 << 16) | ((sbo >> 4) << 32) | (1 << 62)


def read_k_major(at, desc, rows, k=8):
    """A K-major operand of one k-step ([rows, 8] tf32): element (m, k) at
    start + SBO (m / 8) + 128 (m % 8) + 4 k, swizzled."""
    start, sbo = decode(desc)
    return [[at[swizzle(start + sbo * (m // 8) + 128 * (m % 8) + 4 * j)]
             for j in range(k)] for m in range(rows)]


@functools.lru_cache(maxsize=None)
def producer_writes():
    """{word: (half, row, column)} of a split tile, as store_split writes
    it: thread i, group u, k positions 0-3 from split_at(r, c0) (columns
    c0 + 0, 2, 4, 6) and 4-7 from split_at(r, c0 + 1) (c0 + 1, 3, 5, 7),
    big there and small kSmallWords on; and, per warp and store, the
    words each lane writes."""
    for line in ("const int r = i & 15;",
                 "const int c0 = 8 * ((i >> 4) + 8 * u);",
                 "const float lo[4] = {a.x, a.z, b.x, b.z}, "
                 "hi[4] = {a.y, a.w, b.y, b.w};",
                 "at_lo = split_at(r, c0), at_hi = split_at(r, c0 + 1);",
                 "uint32_t* small = big + kSmallWords;"):
        assert line in STORE_SPLIT, line
    assert "const int c4 = 2 * ((i >> 4) + 8 * u);" in SRC  # load_raw
    words, stores = {}, {}
    for i in range(C["kTcThreads"]):
        r = i & 15
        for u in range(4):
            c0 = 8 * ((i >> 4) + 8 * u)
            for half, cols in ((0, (0, 2, 4, 6)), (1, (1, 3, 5, 7))):
                at = split_at(r, c0 + half)
                assert at % 4 == 0  # a 16-byte store
                stores.setdefault((i // 32, u, half), []).append(at)
                for part, base in (("big", 0), ("small", C["kSmallWords"])):
                    for e, dc in enumerate(cols):
                        assert base + at + e not in words
                        words[base + at + e] = (part, r, c0 + dc)
    return words, stores


# ------------------------------------------------- 1. the split K/V tile
def test_the_constants():
    assert C == {"kTile": 64, "kTcWarps": 4, "kTcThreads": 128,
                 "kD256Threads": 256, "kD256Rows": 16, "kSlabCols": 32,
                 "kSlabBytes": 4096, "kSmallWords": 512,
                 "kKvTileBytes": 32768, "kQSlabBytes": 8192,
                 "kQSplitBytes": 65536, "kXSplitBytes": 8192,
                 "kDqStash": 12, "kVtSmallWords": 4096}
    for kernel in ("flash_fwd_d256_tc_kernel", "flash_bwd_dq_d256_tc_kernel"):
        assert f"__launch_bounds__(kD256Threads, 1)\n    {kernel}(" in SRC


def test_the_split_pass_writes_each_element_once_at_split_at():
    """Every word of the tile once; big (r, c) at split_at(r, c), small at
    split_at(kD256Rows + r, c), kSmallWords on."""
    words, _ = producer_writes()
    assert sorted(words) == list(range(C["kKvTileBytes"] // 4))
    for w, (part, r, c) in words.items():
        assert split_at(r + (BN if part == "small" else 0), c) == w
        assert split_at(r, c) + (C["kSmallWords"] if part == "small"
                                 else 0) == w


def test_a_quarter_warp_store_hits_eight_chunks():
    """16-byte stores go out a quarter warp (8 lanes) at a time: its 8
    lanes must hit 8 distinct 16-byte chunks of the 128-byte bank row."""
    _, stores = producer_writes()
    for lanes in stores.values():
        for q in range(4):
            chunks = {(w // 4) % 8 for w in lanes[8 * q:8 * q + 8]}
            assert len(chunks) == 8


def _score_offsets(kk):
    """The byte offsets from sb of k-step kk's big and small descriptors in
    scores_rs."""
    at = _int_expr(re.search(r"const uint32_t at = opaque\(sb\) \+ ([^;]+);",
                             SCORES).group(1), dict(C, kk=kk))
    assert "sml = sw128_desc(at + kSmallWords * 4);" in SCORES
    return at, at + 4 * C["kSmallWords"]


@pytest.mark.parametrize("kk", range(D // 8))
def test_the_score_descriptor_reads_the_a_fragment_column(kk):
    """k-step kk of dq's s = q.k^T and dp = do.v^T: the big and small
    descriptors at the source's addresses read, at (KV row n, k index k),
    the big and small halves of row n's element whose column the A
    fragment gives k index k."""
    words, _ = producer_writes()
    at = {4 * w: cell for w, cell in words.items()}
    for part, offset in zip(("big", "small"), _score_offsets(kk)):
        cells = read_k_major(at, sw128_desc(offset), BN)
        assert cells == [[(part, n, k_column(kk, k)) for k in range(8)]
                         for n in range(BN)]


@functools.lru_cache(maxsize=None)
def _split_q_writes():
    """{word: (half, Q row, column)} of the forward's split Q tile, as
    split_q writes it (big, and small kQSplitBytes on)."""
    for line in ("const int r = threadIdx.x & 63;",
                 "const int c0 = 8 * ((threadIdx.x >> 6) + 4 * u);",
                 "const float lo[4] = {a.x, a.z, b.x, b.z}, "
                 "hi[4] = {a.y, a.w, b.y, b.w};",
                 "const int at_lo = split_at<kTile>(r, c0), "
                 "at_hi = split_at<kTile>(r, c0 + 1);",
                 "uint32_t* small = big + kQSplitBytes / 4;"):
        assert line in SPLIT_Q, line
    words = {}
    for i in range(C["kD256Threads"]):
        r = i & 63
        for u in range(8):
            c0 = 8 * ((i >> 6) + 4 * u)
            for half, cols in ((0, (0, 2, 4, 6)), (1, (1, 3, 5, 7))):
                at = split_at(r, c0 + half, C["kTile"])
                for part, base in (("big", 0),
                                   ("small", C["kQSplitBytes"] // 4)):
                    for e, dc in enumerate(cols):
                        assert base + at + e not in words
                        words[base + at + e] = (part, r, c0 + dc)
    return words


@pytest.mark.parametrize("kk", range(D // 8))
def test_the_forward_reads_q_and_k_split_at_one_column(kk):
    """k-step kk of the forward's s = q.k^T (scores_ss): the Q descriptors
    read Q's big and small halves at (row m, k index k) and the K ones K's
    at (row n, k index k), both the same column; split_q writes every
    element once."""
    qw = _split_q_writes()
    assert sorted(qw) == list(range(C["kQSplitBytes"] // 2))
    qa = _int_expr(re.search(r"const uint32_t qa = opaque\(sq\) \+ ([^;]+);",
                             SCORES_SS).group(1), dict(C, kk=kk))
    ka = _int_expr(re.search(r"const uint32_t ka = opaque\(sk\) \+ ([^;]+);",
                             SCORES_SS).group(1), dict(C, kk=kk))
    assert "qs = sw128_desc(qa + kQSplitBytes);" in SCORES_SS
    assert "ks = sw128_desc(ka + kSmallWords * 4);" in SCORES_SS
    at = {4 * w: cell for w, cell in qw.items()}
    for part, offset in (("big", qa), ("small", qa + C["kQSplitBytes"])):
        cells = read_k_major(at, sw128_desc(offset), C["kTile"])
        assert cells == [[(part, m, k_column(kk, k)) for k in range(8)]
                         for m in range(C["kTile"])]
    words, _ = producer_writes()
    at = {4 * w: cell for w, cell in words.items()}
    for part, offset in (("big", ka), ("small", ka + 4 * C["kSmallWords"])):
        cells = read_k_major(at, sw128_desc(offset), BN)
        assert cells == [[(part, n, k_column(kk, k)) for k in range(8)]
                         for n in range(BN)]
    for line in ("wgmma_ss_tf32_n16(s, qb, kb, kk);",
                 "wgmma_ss_tf32_n16(bs, qb, ks, kk);",
                 "wgmma_ss_tf32_n16(sb, qs, kb, kk);",
                 "s[e] += bs[e] + sb[e];"):
        assert line in SCORES_SS, line


def test_scores_are_exact_on_small_integers():
    """s = a.b^T over the 32 k-steps, A as a_frag loads it, B through the
    descriptors, equals the product."""
    rng = np.random.default_rng(0)
    a = rng.integers(-8, 9, (C["kTile"], D))
    b = rng.integers(-8, 9, (BN, D))
    words, _ = producer_writes()
    at = {4 * w: cell for w, cell in words.items()}
    s = np.zeros((C["kTile"], BN), np.int64)
    for kk in range(D // 8):
        cells = read_k_major(at, sw128_desc(_score_offsets(kk)[0]), BN)
        bk = np.array([[b[r, c] for _, r, c in row] for row in cells]).T
        ak = np.array([[a[m, k_column(kk, k)] for k in range(8)]
                       for m in range(C["kTile"])])
        s += ak @ bk
    np.testing.assert_array_equal(s, a @ b.T)


# ------------------------------------------- 2. the transposed products
def _a_fragment(warp, lane, ks, mb):
    """The words accumulate_t loads for A = x^T (a0..a3) and the (row,
    k) of A each fragment element is: mma.sync's m16n8k8 tf32 A layout,
    rows 16 warp + g (+ 8), k indices t (+ 4)."""
    g, t = lane // 4, lane % 4
    d = 64 * mb + 16 * warp + g
    r = 8 * ks + t
    assert "ab[ks][e] = x[at[e]];" in ACCUMULATE
    assert "as[ks][e] = x[kSmallWords + at[e]];" in ACCUMULATE
    m = re.search(r"const int at\[4\] = \{([^}]+)\};", ACCUMULATE)
    exprs = [e.strip() for e in m.group(1).split("split_at(")[1:]]
    env = dict(r=r, d=d)
    words = []
    for e in exprs:
        row, col = (x.strip() for x in e.rstrip("), ").rsplit(",", 1))
        words.append(split_at(_int_expr(row, env), _int_expr(col, env)))
    cells = [(16 * warp + g, t), (16 * warp + g + 8, t),
             (16 * warp + g, t + 4), (16 * warp + g + 8, t + 4)]
    return words, cells


@functools.lru_cache(maxsize=None)
def _x_writes():
    """{word: (Q row, KV column)} of one half of the p or ds tile, as
    store_x writes it: thread (warp, g, t), values (n, h) at x_at(row + 8
    h, 8 n + 2 t) and the next word, the scores' layout."""
    assert "const int at = x_at(row + 8 * h, 8 * n + 2 * t4);" in STORE_X
    assert ("const float pair[2] = {v[4 * n + 2 * h], v[4 * n + 2 * h + "
            "1]};") in STORE_X
    words = {}
    for warp in range(C["kTcWarps"]):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for n in range(BN // 8):
                for h in range(2):
                    row, col = 16 * warp + g + 8 * h, 8 * n + 2 * t
                    at = x_at(row, col)
                    assert at % 2 == 0  # an 8-byte store
                    for e in range(2):
                        assert at + e not in words
                        words[at + e] = (row, col + e)
    return words


def test_the_x_tile_holds_each_score_once():
    words = _x_writes()
    cells = sorted(words.values())
    assert cells == [(r, c) for r in range(C["kTile"]) for c in range(BN)]
    assert max(words) < C["kXSplitBytes"] // 4


def _b_desc(nh, ks):
    """The descriptor accumulate_t gives B in the half of Q columns 32 nh to
    + 31 at k-step ks (p or ds at shared address 0)."""
    pa = _int_expr(re.search(r"const uint32_t pa = opaque\(sp\) \+ ([^;]+);",
                             ACCUMULATE).group(1), dict(nh=nh))
    for line in ("const uint64_t pb = sw128_desc(pa), "
                 "ps = sw128_desc(pa + kXSplitBytes);",
                 "wgmma_tf32_n32(big, ab[ks], pb + 2 * ks, ks);",
                 "wgmma_tf32_n32(small, ab[ks], ps + 2 * ks, ks);",
                 "wgmma_tf32_n32(small, as[ks], pb + 2 * ks, 1);"):
        assert line in ACCUMULATE, line
    return sw128_desc(pa) + 2 * ks


@pytest.mark.parametrize("nh", range(2))
@pytest.mark.parametrize("ks", range(BN // 8))
def test_p_columns_meet_the_kv_rows_of_x(ks, nh):
    """k-step ks of o^T += v^T.p^T (dq^T += k^T.ds^T) in the half of Q
    columns 32 nh to + 31: B read through the descriptor is p[32 nh +
    n][8 ks + k], and the A fragment of x^T at k index k is x[8 ks +
    k][d], big and small: both sides take KV row 8 ks + k."""
    words = _x_writes()
    at = {4 * w: cell for w, cell in words.items()}
    cells = read_k_major(at, _b_desc(nh, ks), 32)
    assert cells == [[(32 * nh + n, 8 * ks + k) for k in range(8)]
                     for n in range(32)]
    split = producer_writes()[0]
    for mb in range(4):
        for warp in range(C["kTcWarps"]):
            for lane in range(32):
                got, cells = _a_fragment(warp, lane, ks, mb)
                for w, (m, k) in zip(got, cells):
                    assert split[w] == ("big", 8 * ks + k, 64 * mb + m)
                    assert split[w + C["kSmallWords"]] == (
                        "small", 8 * ks + k, 64 * mb + m)


def test_transposed_products_are_exact_and_stored_by_q_row():
    """Each block's x^T.p^T over a tile's two k-steps, then store_t's
    writes of acc^T: out[q][d] = (p.x)[q][d] for every Q row and column."""
    rng = np.random.default_rng(1)
    p = rng.integers(-8, 9, (C["kTile"], BN))
    x = rng.integers(-8, 9, (BN, D))
    split = producer_writes()[0]
    xw = _x_writes()
    acc = np.zeros((D, C["kTile"]), np.int64)  # acc^T
    for mb in range(4):
        for ks in range(BN // 8):
            a = np.zeros((64, 8), np.int64)
            for warp in range(C["kTcWarps"]):
                for lane in range(32):
                    words, cells = _a_fragment(warp, lane, ks, mb)
                    for w, (m, k) in zip(words, cells):
                        _, r, c = split[w]
                        a[m, k] = x[r, c]
            at = {4 * w: cell for w, cell in xw.items()}
            for nh in range(2):
                cells = read_k_major(at, _b_desc(nh, ks), 32)
                b = np.array([[p[r, c] for r, c in row] for row in cells]).T
                acc[64 * mb:64 * mb + 64, 32 * nh:32 * nh + 32] += a @ b
    np.testing.assert_array_equal(acc, (p @ x).T)
    # store_t: acc[mb][4 j + 2 h + c] is (head-dim row 64 mb + 16 warp + g
    # + 8 h, Q column 8 j + 2 t + c), the wgmma accumulator layout
    for line in ("const int col = 8 * j + 2 * t4 + c;",
                 "float* dst = out + (size_t)(q0 + col) * 256 + w16 + g;",
                 "dst[64 * mb + 8 * h] = acc[mb][4 * j + 2 * h + c];"):
        assert line in STORE_T, line
    out = {}
    for warp in range(C["kTcWarps"]):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for j in range(8):
                for c in range(2):
                    col = 8 * j + 2 * t + c
                    for mb in range(4):
                        for h in range(2):
                            d = 64 * mb + 16 * warp + g + 8 * h
                            assert (col, d) not in out
                            out[(col, d)] = acc[d, col]
    assert len(out) == C["kTile"] * D
    want = p @ x
    assert all(v == want[q, d] for (q, d), v in out.items())


# --------------------------------------------------- 3. shared memory
@pytest.mark.parametrize("kernel,fn,want", [
    ("fwd", "fwd256_tc_smem_bytes", 214048),
    ("dq", "dq256_tc_smem_bytes", 220192)])
def test_shared_memory_fits_one_block(kernel, fn, want):
    """The kernel's tiles, laid out as its pointers take them, fit the
    bytes kernel_fn launches it with, within 232,448; every wgmma operand
    starts 1024-byte aligned (the swizzle's period)."""
    body = re.search(rf"constexpr int {fn}\(\) \{{\s*return ([^;]+);",
                     SRC).group(1)
    smem = _int_expr(body, C)
    assert smem == want <= MAX_SMEM
    src = FWD if kernel == "fwd" else DQ
    # the forward's Q split, K split and V transposed; dq's Q and dO raw,
    # K and V split and stash of 12 values a consumer thread
    if kernel == "fwd":
        tiles = 2 * C["kQSplitBytes"] + C["kKvTileBytes"] + \
            2 * 4 * C["kVtSmallWords"] + 2 * C["kXSplitBytes"]
        rows = 0
    else:
        tiles = 2 * C["kTile"] * D * 4 + 2 * C["kKvTileBytes"] + \
            2 * C["kXSplitBytes"]
        rows = C["kDqStash"] * C["kTcThreads"] * 4
    assert smem == 1024 + tiles + rows + 4 * 8
    for offset in (C["kTile"] * D * 4, C["kKvTileBytes"], C["kSlabBytes"],
                   C["kQSplitBytes"], C["kQSlabBytes"], C["kXSplitBytes"]):
        assert offset % 1024 == 0
    assert "align_1024(d256_smem)" in src
    assert f"*smem = {fn}();" in SRC


# ------------------------------------------------------- 4. the rings
CONSUMER_CALL = re.compile(
    r"\b(mbar_wait\((k|v)_bars, j & 1\)|release_stage\((k|v)_bars\))")


def _consumer(src):
    """The consumer loop's ring calls, in order: ("wait" | "release",
    ring)."""
    loop = src[src.index("for (int j = 0; j < n_tiles; ++j)"):]
    return [("wait" if m.group(2) else "release", m.group(2) or m.group(3))
            for m in CONSUMER_CALL.finditer(loop)]


def _producer(src):
    """The producer's stage order: the rings of its first and second
    operands, as the kernel passes its barriers."""
    m = re.search(r"produce_d256<(?:true|false)>\([^;]*?, (k|v)_bars, "
                  r"(k|v)_bars, n_tiles,\s*seq\);", src)
    return m.group(1), m.group(2)


def test_the_program_is_what_the_model_runs():
    assert _consumer(FWD) == [("wait", "k"), ("release", "k"),
                              ("wait", "v"), ("release", "v")]
    assert _consumer(DQ) == [("wait", "v"), ("release", "v"),
                             ("wait", "k"), ("release", "k")]
    assert _producer(FWD) == ("k", "v") and _producer(DQ) == ("v", "k")
    order = [PRODUCE.index(s) for s in (
        "mbar_wait(first_bars + 8, parity);", "store_split(s_first, a, i);",
        "fence_proxy_async();", "mbar_arrive(first_bars);",
        "mbar_wait(second_bars + 8, parity);",
        "store_split(s_second, b, i);", "mbar_arrive(second_bars);")]
    assert order == sorted(order)
    assert "const uint32_t parity = (j & 1) ^ 1;" in PRODUCE
    assert "mbar_arrive(bars + 8);" in _function(
        "__device__ __forceinline__ void release_stage(")
    for src in (FWD, DQ):
        for ring in "kv":
            assert f"mbar_init({ring}_bars, kTcThreads);" in src
            assert f"mbar_init({ring}_bars + 8, kTcWarps);" in src


class _Bar:
    """An mbarrier: completed phases, and arrivals toward the next."""

    def __init__(self, count):
        self.count, self.phase, self.arrived = count, 0, 0

    def done(self, parity):
        return (self.phase & 1) != parity

    def arrive(self, n=1):
        self.arrived += n
        assert self.arrived <= self.count
        if self.arrived == self.count:
            self.phase, self.arrived = self.phase + 1, 0


def _run(src, n_tiles, seed):
    """Producer and consumer of one block, interleaved at random, each
    warpgroup's arrivals counted whole. Fails on a deadlock, a tile not in
    its stage when waited for, or a stage refilled while held."""
    full = {r: _Bar(C["kTcThreads"]) for r in "kv"}
    empty = {r: _Bar(C["kTcWarps"]) for r in "kv"}
    tile_in, held = {r: None for r in "kv"}, {r: False for r in "kv"}
    consumer_ops = _consumer(src)
    first, second = _producer(src)

    def producer():
        for j in range(n_tiles):
            for ring in (first, second):
                while not empty[ring].done((j & 1) ^ 1):
                    yield False
                assert not held[ring], (ring, j)
                tile_in[ring] = j
                full[ring].arrive(C["kTcThreads"])
                yield True

    def consumer():
        for j in range(n_tiles):
            for kind, ring in consumer_ops:
                if kind == "wait":
                    while not full[ring].done(j & 1):
                        yield False
                    assert tile_in[ring] == j, (ring, j, tile_in[ring])
                    held[ring] = True
                else:
                    held[ring] = False
                    empty[ring].arrive(C["kTcWarps"])
                yield True

    rng = random.Random(seed)
    agents = [producer(), consumer()]
    live, blocked = [0, 1], 0
    while live:
        a = rng.choice(live)
        try:
            blocked = 0 if next(agents[a]) else blocked + 1
        except StopIteration:
            live.remove(a)
            blocked = 0
        assert blocked < 1000, f"deadlock at {n_tiles} tiles"


@pytest.mark.parametrize("kernel", ["fwd", "dq"])
@pytest.mark.parametrize("n_tiles", [1, 2, 3, 4, 9, 64])
def test_the_rings_never_deadlock_or_refill_a_held_stage(kernel, n_tiles):
    for seed in range(16):
        _run(FWD if kernel == "fwd" else DQ, n_tiles, seed)


# ------------------------------------------------ 5. dp's restart parts
@pytest.mark.parametrize("restart", [True, False])
def test_score_steps_reuse_buffers_only_when_done(restart):
    """scores_rs as dq runs it (a k-step at a time, two buffers): a k-step's
    A buffer and, for dp, a pair's part are rewritten only after the
    k-step that last used them is done (wgmma_wait<1> before k-step kk
    leaves k-steps up to kk - 2 done), and every pair's part is added to s
    once, in order, after both its k-steps and before it is restarted."""
    assert f"scores_rs<{'true' if restart else 'false'}>(s, t" in DQ
    for line in ("wgmma_wait<1>();  // k-step kk - 2, which read buffer b, "
                 "is done",
                 "if ((kk & 1) == 0 && kk >= 4) add_pair((kk >> 1) - 2);",
                 "wgmma_tf32_n16(part[(kk >> 1) & 1], fa[b].big, big, "
                 "kk & 1);",
                 "add_pair(kSteps / 2 - 2);", "add_pair(kSteps / 2 - 1);"):
        assert line in SCORES, line
    steps = D // 8
    done = -1  # the last k-step done
    reader = {}  # A buffer -> the last k-step that read it
    part_of = {}  # part buffer -> (pair, its k-steps issued)
    added = []

    def add(pair):
        q = pair & 1
        assert part_of[q][0] == pair and len(part_of[q][1]) == 2
        assert all(kk <= done for kk in part_of[q][1])
        added.append(pair)

    for kk in range(steps):
        if kk >= 2:
            done = kk - 2
            if restart and kk % 2 == 0 and kk >= 4:
                add((kk >> 1) - 2)
        b = kk & 1
        assert b not in reader or reader[b] <= done  # the buffer is free
        reader[b] = kk
        if restart:
            q = (kk >> 1) & 1
            if kk % 2 == 0:  # restarts the part: its pair was added
                prev = part_of.get(q)
                assert prev is None or prev[0] in added
                part_of[q] = (kk // 2, [kk])
            else:
                part_of[q][1].append(kk)
    done = steps - 1  # wgmma_wait<0>
    if restart:
        add(steps // 2 - 2)
        add(steps // 2 - 1)
        assert added == list(range(steps // 2))


# ------------------------------------- 6. the forward's p.v, direct form
def swizzle64(addr):
    """The 64-byte swizzle of a shared-memory byte address: bits 4-5 XORed
    by bits 7-8."""
    return addr ^ (((addr >> 7) & 3) << 4)


def sw64_desc_fields():
    """(stride byte offset, layout type) that sw64_desc encodes."""
    body = _function("uint64_t sw64_desc(uint32_t saddr)")
    sbo = int(re.search(r"\(uint64_t\)\((\d+) >> 4\) << 32", body).group(1))
    kind = int(re.search(r"\(\(uint64_t\)(\d) << 62\)", body).group(1))
    return sbo, kind


def vt_at(d, kv):
    return _int_expr(re.search(r"return ([^;]+);", VT_AT).group(1),
                     dict(C, d=d, kv=kv))


@functools.lru_cache(maxsize=None)
def _vt_writes():
    """{word: (half, KV row, head-dim column)} of the forward's transposed
    V tile, as store_split_t writes it."""
    for line in ("const int r = i & 15;",
                 "const int c0 = 8 * ((i >> 4) + 8 * u);",
                 "const int at = vt_at(c0 + e, r);",
                 "big[at] = f.big[e];", "big[kVtSmallWords + at] = f.small[e];"):
        assert line in STORE_SPLIT_T, line
    words = {}
    for i in range(C["kTcThreads"]):
        r = i & 15
        for u in range(4):
            c0 = 8 * ((i >> 4) + 8 * u)
            for e in range(8):
                for part, base in (("big", 0), ("small", C["kVtSmallWords"])):
                    w = base + vt_at(c0 + e, r)
                    assert w not in words
                    words[w] = (part, r, c0 + e)
    return words


def test_the_transposed_v_tile_is_written_once_in_the_64_byte_swizzle():
    """Every word of the forward's V tile is written once; the swizzle is
    the 64-byte one (sw64_desc: layout type 2, 8-row groups 512 bytes
    apart), element (d, kv) at 64 d + 4 kv before it."""
    words = _vt_writes()
    assert sorted(words) == list(range(2 * C["kVtSmallWords"]))
    assert sw64_desc_fields() == (512, 2)
    for d in range(256):
        for kv in range(BN):
            assert 4 * vt_at(d, kv) == swizzle64(64 * d + 4 * kv)


def _read_k_major64(at, start, rows):
    """A K-major operand of one k-step through a 64-byte-swizzle
    descriptor: element (m, k) at start + 512 (m / 8) + 64 (m % 8) + 4 k,
    swizzled."""
    return [[at[swizzle64(start + 512 * (m // 8) + 64 * (m % 8) + 4 * k)]
             for k in range(8)] for m in range(rows)]


def test_the_forward_pv_is_exact_on_small_integers():
    """o = p.v as accumulate_pv issues it: A = p through the 128-byte
    swizzle descriptor (+2 a k-step), B = chunk c of v^T (head-dim rows
    32 c on, +2048 bytes a chunk; small +4 kVtSmallWords bytes) through
    the 64-byte one; every chunk reads its own columns, and o comes out
    exact."""
    for line in ("const uint32_t vt = opaque(svt) + 32 * 64 * c;",
                 "vs = sw64_desc(vt + 4 * kVtSmallWords);",
                 "wgmma_ss_tf32_n32(big[c & 1], pb + 2 * ks, vb + 2 * ks, ks);",
                 "wgmma_ss_tf32_n32(small[c & 1], pb + 2 * ks, vs + 2 * ks, ks);",
                 "wgmma_ss_tf32_n32(small[c & 1], ps + 2 * ks, vb + 2 * ks, 1);"):
        assert line in ACCUMULATE_PV, line
    rng = np.random.default_rng(2)
    p = rng.integers(-8, 9, (C["kTile"], BN))
    v = rng.integers(-8, 9, (BN, D))
    xw = {4 * w: cell for w, cell in _x_writes().items()}
    vw = {4 * w: cell for w, cell in _vt_writes().items()}
    o = np.zeros((C["kTile"], D), np.int64)
    for c in range(8):
        for ks in range(BN // 8):
            a_cells = read_k_major(xw, sw128_desc(0) + 2 * ks, C["kTile"])
            a = np.array([[p[r, col] for r, col in row] for row in a_cells])
            assert [[col for _, col in row] for row in a_cells] == [
                [8 * ks + k for k in range(8)]] * C["kTile"]
            for part in ("big", "small"):
                start = 2048 * c + 32 * ks + (
                    4 * C["kVtSmallWords"] if part == "small" else 0)
                b_cells = _read_k_major64(vw, start, 32)
                assert b_cells == [[(part, 8 * ks + k, 32 * c + n)
                                    for k in range(8)] for n in range(32)]
            b = np.array([[v[r, col] for _, r, col in row] for row in b_cells])
            o[:, 32 * c:32 * c + 32] += a @ b.T
    np.testing.assert_array_equal(o, p @ v)
