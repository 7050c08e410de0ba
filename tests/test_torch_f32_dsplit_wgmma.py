"""The f32 dq and dk/dv above head dim 256 on wgmma (flash_bwd_dq_ws_kernel
and flash_bwd_dkv_ws_kernel of
ray_tpu_torch/ops/csrc/flash_attention_dsplit.cu), known without a card.

A block is a consumer warpgroup and a producer warpgroup; dk/dv's grid has
a dv block and a dk block for each 256-column chunk. The producer
writes every operand split into big and small: each 64-column step of the
score products as a ring stage (the block's own 64 rows, then kWsRows rows
of the other axis, each half two 128-byte-swizzled slabs of 32 columns,
``step_at``), and each tile's rows of the output chunk transposed
(``store_chunk_t``: [chunk columns, kWsRows], element (row, column) at
``x_at(column, row)``). The consumer reads the stages K-major through
wgmma descriptors (``step_desc``), writes p or ds split as a [64, kWsRows]
tile (``store_x``) and takes its product with the transposed chunk. With
the constants and index expressions read from the source, a numpy model of
shared memory, the 128-byte swizzle and wgmma's K-major reads checks:

1. every output column of dq, dk and dv, at every head dim from 320 to
   1024 in steps of 64, is stored by exactly one (chunk, warpgroup), and
   every row once;
2. the split passes write each element once, where the descriptors read
   it (the score products' A and B at one column, the accumulating
   products' p or ds and the transposed chunk at one row of the other
   axis), and 16-byte stores of a quarter warp hit eight chunks;
3. the products come out exact on small integers;
4. each kernel's shared memory fits the 232,448 bytes a block may take,
   and every wgmma operand starts 1024-byte aligned;
5. the ring and the chunk buffer, driven by the order of the mbarrier
   calls as the source has them, under random interleavings of producer
   and consumer: no wait blocks forever, the consumer finds the item it
   waits for, and the producer never refills a buffer still held.
"""
import functools
import random
import re
from pathlib import Path

import numpy as np
import pytest

from ray_tpu_torch.ops import flash_attention as tfa
from tests.test_torch_wgmma_layout import decode, swizzle

# the dsplit kernels' source after the headers it includes (tf32_mma.cuh's
# tile constants, wgmma_tf32.cuh's x_at, store_x and descriptors)
SRC = "".join((Path(tfa.__file__).resolve().parent / "csrc" / name).read_text()
              for name in ("tf32_mma.cuh", "wgmma_tf32.cuh",
                           "flash_attention_dsplit.cu"))
MAX_SMEM = 232448  # bytes of shared memory a block may take on an H100
HEAD_DIMS = range(320, 1025, 64)


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
for _name in ("kTile", "kChunk", "kTcWarps", "kTcThreads", "kSlabCols",
              "kXSplitBytes", "kWsThreads", "kWsRows", "kOutCols",
              "kOwnHalfBytes", "kOtherHalfBytes", "kStageBytes", "kStages",
              "kPieceCols"):
    C[_name] = _const(_name, C)
ROWS, T, WARPS = C["kWsRows"], C["kTile"], C["kTcWarps"]
COLS, PIECE = C["kOutCols"], C["kPieceCols"]
X_AT = _function("__device__ __forceinline__ int x_at(int row, int col)")
STEP_AT = _function("__device__ __forceinline__ int step_at(int r, int c)")
STEP_DESC = _function("__device__ __forceinline__ uint64_t step_desc(")
LOAD_STAGE = _function("__device__ __forceinline__ void load_stage(")
STORE_STAGE = _function("__device__ __forceinline__ void store_stage(")
LOAD_CHUNK = _function("__device__ __forceinline__ void load_chunk_t(")
STORE_CHUNK = _function("__device__ __forceinline__ void store_chunk_t(")
STORE_X = _function("__device__ __forceinline__ void store_x(")
PRODUCE = _function("__device__ __forceinline__ void ws_produce(")
SCORES = _function("__device__ __forceinline__ void ws_scores(")
ACCUMULATE = _function("__device__ __forceinline__ void ws_accumulate(")
STORE = _function("__device__ __forceinline__ void ws_store(")
DQ = _function("flash_bwd_dq_ws_kernel(const float*")
DKV = _function("flash_bwd_dkv_ws_kernel(const float*")
KERNEL_FN = _function("const void* kernel_fn(int kernel, int* smem")


def x_at(row, col):
    return _int_expr(re.search(r"return ([^;]+);", X_AT).group(1),
                     dict(C, row=row, col=col))


def step_at(r, c, rows):
    """step_at<rows> of the source: the word of element (r, c) of one half
    of a split step."""
    return _int_expr(re.search(r"return ([^;]+);", STEP_AT).group(1),
                     dict(C, r=r, c=c, kRows=rows, x_at=x_at))


def sw128_desc(saddr):
    """sw128_desc of the source, whose stride byte offset is read there."""
    sbo = int(re.search(r"\(uint64_t\)\((\d+) >> 4\) << 32",
                        _function("uint64_t sw128_desc(uint32_t saddr)"))
              .group(1))
    return ((saddr & 0x3FFFF) >> 4) | (1 << 16) | ((sbo >> 4) << 32) | (1 << 62)


def step_desc(a, kk, rows):
    return _int_expr(re.search(r"return ([^;]+);", STEP_DESC).group(1),
                     dict(C, a=a, kk=kk, kRows=rows, sw128_desc=sw128_desc))


def read_k_major(at, desc, rows, k=8):
    """A K-major operand of one k-step ([rows, 8] tf32): element (m, k) at
    start + SBO (m / 8) + 128 (m % 8) + 4 k, swizzled."""
    start, sbo = decode(desc)
    return [[at.get(swizzle(start + sbo * (m // 8) + 128 * (m % 8) + 4 * j))
             for j in range(k)] for m in range(rows)]


# ------------------------------------------------ 1. who stores a column
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_every_output_column_has_one_owner(kernel, D):
    """grid x = the chunks (D / kOutCols rounded up), twice over for dk/dv
    (grid_of); block x stores, in ws_store, columns c0 + kPieceCols pc + 8
    (e / 4) + 2 t (+ 1) of its pieces where they lie below D, c0 = x
    kOutCols (dk/dv: x / 2 kOutCols, into dv for even x, dk for odd): every
    column of every output once, every row of the block's tile once, and
    only the consumer warpgroup stores."""
    assert "*cols = kOutCols;" in KERNEL_FN
    assert ("return dim3(kernel == 1 ? 2 * chunks : chunks, tiles, bh);"
            in SRC)
    assert "chunks = (d + cols - 1) / cols;" in SRC
    if kernel == "dq":
        assert "c0 = blockIdx.x * kOutCols;" in DQ
        assert "ws_store(dq + (size_t)opaque(blockIdx.z) * seq * D, acc, q0, " \
            "c0, seq, D);" in DQ
    else:
        for line in ("const bool dk_block = blockIdx.x & 1;",
                     "const int c0 = (blockIdx.x >> 1) * kOutCols;",
                     "ws_store((dk_block ? dk : dv) + base, acc, k0, c0, seq, D);"):
            assert line in DKV, line
    for line in ("const int row = r0 + wr + g + 8 * ((e >> 1) & 1);",
                 "const int col = c0 + kPieceCols * pc + 8 * (e >> 2) + 2 * t4;",
                 "if (row < seq && col < D)",
                 "store2(out + (size_t)row * D + col, acc[pc][e], "
                 "acc[pc][e + 1]);"):
        assert line in STORE, line
    src = DQ if kernel == "dq" else DKV
    # ws_store is called after the producer's return, by the consumer
    assert src.index("ws_store(") > src.index("return;\n  }")
    chunks = (D + COLS - 1) // COLS
    owners = {}
    for x in range(chunks * (1 if kernel == "dq" else 2)):
        out, z = ("dq", x) if kernel == "dq" else ("dk" if x & 1 else "dv",
                                                   x >> 1)
        for warp in range(WARPS):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                for pc in range(COLS // PIECE):
                    for e in range(0, PIECE // 2, 2):
                        row = 16 * warp + g + 8 * ((e >> 1) & 1)
                        col = z * COLS + PIECE * pc + 8 * (e >> 2) + 2 * t
                        for cc in (col, col + 1):
                            if col < D:
                                assert (out, row, cc) not in owners
                                owners[(out, row, cc)] = x
    outs = ["dq"] if kernel == "dq" else ["dk", "dv"]
    assert sorted(owners) == [(o, r, c) for o in outs for r in range(T)
                              for c in range(D)]


# ------------------------------------------------- 2. the split passes
@functools.lru_cache(maxsize=None)
def stage_writes():
    """{word: (half, tile, row, column)} of a stage, as store_stage writes
    the elements load_stage gives producer thread i: own rows i / 16 + 8 u
    (u < 8), other rows i / 16 + 8 u (u < 4), columns 4 (i % 16) + e; and
    the words of each 16-byte store, per warp and store."""
    for line in ("const int r = i >> 4, col = c * kChunk + 4 * (i & 15);",
                 "const int row = own0 + r + 8 * u;",
                 "const int row = o0 + r + 8 * u;",
                 "t.x[8 + u] = ldg4(other + (size_t)row * D + col, row < seq);"):
        assert line in LOAD_STAGE, line
    for line in ("const int r = i >> 4, col = 4 * (i & 15);",
                 "uint32_t* other = st + 2 * kOwnHalfBytes / 4;",
                 "const int at = step_at<kTile>(r + 8 * u, col);",
                 "store_split4(st + at, st + kOwnHalfBytes / 4 + at, t.x[u]);",
                 "const int at = step_at<kWsRows>(r + 8 * u, col);",
                 "store_split4(other + at, other + kOtherHalfBytes / 4 + at, "
                 "t.x[8 + u]);"):
        assert line in STORE_STAGE, line
    words, stores = {}, {}
    own_half, other_half = C["kOwnHalfBytes"] // 4, C["kOtherHalfBytes"] // 4
    for i in range(C["kTcThreads"]):
        r, col = i >> 4, 4 * (i & 15)
        for tile, n_u, rows, base in (("own", 8, T, 0),
                                      ("other", 4, ROWS, 2 * own_half)):
            half = own_half if tile == "own" else other_half
            for u in range(n_u):
                at = step_at(r + 8 * u, col, rows)
                assert at % 4 == 0
                stores.setdefault((tile, i // 32, u), []).append(at)
                for part, off in (("big", 0), ("small", half)):
                    for e in range(4):
                        w = base + off + at + e
                        assert w not in words
                        words[w] = (part, tile, r + 8 * u, col + e)
    return words, stores


def test_the_constants():
    assert C == {"kTile": 64, "kChunk": 64, "kTcWarps": 4, "kTcThreads": 128,
                 "kSlabCols": 32, "kXSplitBytes": 8192, "kWsThreads": 256,
                 "kWsRows": 32, "kOutCols": 256, "kOwnHalfBytes": 16384,
                 "kOtherHalfBytes": 8192, "kStageBytes": 49152, "kStages": 3,
                 "kPieceCols": 32}
    for kernel in ("flash_bwd_dq_ws_kernel", "flash_bwd_dkv_ws_kernel"):
        assert f"__launch_bounds__(kWsThreads, 1)\n    {kernel}(" in SRC


def test_a_stage_is_written_once_and_16_byte_stores_hit_eight_chunks():
    words, stores = stage_writes()
    assert sorted(words) == list(range(C["kStageBytes"] // 4))
    for lanes in stores.values():
        for q in range(4):
            assert len({(w // 4) % 8 for w in lanes[8 * q:8 * q + 8]}) == 8


def _stage_descs(kk):
    """The four descriptors ws_scores gives k-step kk of a stage at 0:
    A big, A small (the own tile), B big, B small (the other tile)."""
    for line in ("const uint32_t b = a + 2 * kOwnHalfBytes;",
                 "const uint64_t ab = step_desc<kTile>(a, kk),",
                 "as = step_desc<kTile>(a + kOwnHalfBytes, kk);",
                 "const uint64_t bb = step_desc<kWsRows>(b, kk),",
                 "bs = step_desc<kWsRows>(b + kOtherHalfBytes, kk);",
                 "wgmma_ss_tf32_n32(part, ab, bb, kk);",
                 "wgmma_ss_tf32_n32(small, ab, bs, step | kk);",
                 "wgmma_ss_tf32_n32(small, as, bb, 1);"):
        assert line in SCORES, line
    b = 2 * C["kOwnHalfBytes"]
    return (step_desc(0, kk, T), step_desc(C["kOwnHalfBytes"], kk, T),
            step_desc(b, kk, ROWS), step_desc(b + C["kOtherHalfBytes"], kk,
                                              ROWS))


@pytest.mark.parametrize("kk", range(8))
def test_the_score_descriptors_read_one_column(kk):
    """k-step kk of a score product: A (64 rows) and B (kWsRows rows) read,
    at (row, k index k), the big or small half of that row's element at
    column 8 kk + k of the step, both at the same column."""
    words, _ = stage_writes()
    at = {4 * w: cell for w, cell in words.items()}
    descs = _stage_descs(kk)
    for desc, part, tile, rows in zip(descs, ("big", "small") * 2,
                                      ("own", "own", "other", "other"),
                                      (T, T, ROWS, ROWS)):
        assert read_k_major(at, desc, rows) == [
            [(part, tile, m, 8 * kk + k) for k in range(8)]
            for m in range(rows)]


def test_scores_are_exact_on_small_integers():
    """own.other^T over the 8 k-steps of a step, both read through the
    descriptors, equals the product."""
    rng = np.random.default_rng(0)
    a = rng.integers(-8, 9, (T, 64))
    b = rng.integers(-8, 9, (ROWS, 64))
    words, _ = stage_writes()
    at = {4 * w: cell for w, cell in words.items()}
    s = np.zeros((T, ROWS), np.int64)
    for kk in range(8):
        da, _, db, _ = _stage_descs(kk)
        ak = np.array([[a[r, c] for _, _, r, c in row]
                       for row in read_k_major(at, da, T)])
        bk = np.array([[b[r, c] for _, _, r, c in row]
                       for row in read_k_major(at, db, ROWS)])
        s += ak @ bk.T
    np.testing.assert_array_equal(s, a @ b.T)


@functools.lru_cache(maxsize=None)
def chunk_writes():
    """{word: (half, row of the other axis, chunk column)} of a transposed
    chunk, as store_chunk_t writes the registers that load_chunk_t fills:
    thread i, row i % 32, columns 8 (i / 32 + 4 u) + e, e < 8."""
    for line in ("const int row = r0 + (i & 31);",
                 "const int col = c0 + 8 * ((i >> 5) + 4 * u);",
                 "t.x[2 * u] = ldg4(p, valid);",
                 "t.x[2 * u + 1] = ldg4(p + 4, valid);"):
        assert line in LOAD_CHUNK, line
    for line in ("const int r = i & 31;",
                 "uint32_t* small = big + kOutCols * kSlabCols;",
                 "const int c = 8 * ((i >> 5) + 4 * u);",
                 "const float4 a = t.x[2 * u], b = t.x[2 * u + 1];",
                 "const int w = x_at(c + e, r);"):
        assert line in STORE_CHUNK, line
    words = {}
    for i in range(C["kTcThreads"]):
        r = i & 31
        for u in range(COLS // 32):
            c = 8 * ((i >> 5) + 4 * u)
            for e in range(8):
                for part, off in (("big", 0), ("small", COLS * C["kSlabCols"])):
                    w = off + x_at(c + e, r)
                    assert w not in words
                    words[w] = (part, r, c + e)
    return words


def test_a_transposed_chunk_is_written_once_a_bank_a_lane():
    """Every word of the [kOutCols, kWsRows] tile once; for one (u, e) a
    warp's 32 lanes (32 rows) write one 128-byte row, 32 distinct banks."""
    words = chunk_writes()
    assert sorted(words) == list(range(2 * COLS * C["kSlabCols"]))
    for u in range(COLS // 32):
        for e in range(8):
            for warp in range(WARPS):
                banks = {x_at(8 * (warp + 4 * u) + e, r) % 32
                         for r in range(32)}
                assert len(banks) == 32
    assert "load_chunk_t(t, job.chunk, o0, job.c0, job.seq, job.D, i);" \
        in PRODUCE
    assert "store_chunk_t(chunk, t, i);" in PRODUCE


@functools.lru_cache(maxsize=None)
def _x_writes():
    """{word: (row, column)} of one half of a [64, kWsRows] p or ds tile,
    as store_x<kWsRows> writes the scores' layout."""
    assert "for (int n = 0; n < kCols / 8; ++n)" in STORE_X
    assert "const int at = x_at(row + 8 * h, 8 * n + 2 * t4);" in STORE_X
    assert "store_x<kWsRows>(sds, s);" in DQ
    assert "store_x<kWsRows>(sx, x);" in DKV
    words = {}
    for warp in range(WARPS):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for n in range(ROWS // 8):
                for h in range(2):
                    row, col = 16 * warp + g + 8 * h, 8 * n + 2 * t
                    for e in range(2):
                        w = x_at(row, col) + e
                        assert w not in words
                        words[w] = (row, col + e)
    assert sorted(words) == list(range(C["kXSplitBytes"] // 4))
    return words


def test_a_stash_sits_where_its_thread_writes_the_tile():
    """dq's dp and dk/dv's p^T wait in the p or ds tile's words (stash_x)
    while the next score product is taken, and are read back (unstash_x)
    before store_x writes the same thread's values over them: value e of
    each thread lies at the word store_x gives it, so no thread's stash is
    overwritten by another's values, and the words are the tile's, each
    once."""
    body = _function("__device__ __forceinline__ int x_word(int e)")
    row_expr = re.search(r"const int row = ([^;]+);", body).group(1)
    word_expr = re.search(r"return ([^;]+);", body).group(1)
    for line in ("for (int e = 0; e < 16; ++e) x[x_word(e)] = "
                 "__float_as_uint(v[e]);",
                 "return __uint_as_float(x[x_word(e)]);"):
        assert line in SRC, line
    assert "stash_x(sds, s);" in DQ and "unstash_x(sds, e)" in DQ
    assert "stash_x(sx, x);" in DKV and "unstash_x(sx, e)" in DKV
    stored = {}
    for w, (row, col) in _x_writes().items():
        stored[(row, col)] = w
    seen = set()
    for tid in range(C["kTcThreads"]):
        row = _int_expr(row_expr.replace("threadIdx.x", str(tid)), C)
        g, t = (tid & 31) >> 2, tid & 3
        for e in range(16):
            w = _int_expr(word_expr.replace("threadIdx.x", str(tid)),
                          dict(C, row=row, e=e, x_at=x_at))
            want_row = 16 * (tid >> 5) + g + 8 * ((e >> 1) & 1)
            want_col = 8 * (e >> 2) + 2 * t + (e & 1)
            assert w == stored[(want_row, want_col)]
            assert w not in seen
            seen.add(w)
    assert seen == set(range(C["kXSplitBytes"] // 4))


def _accumulate_descs(ks, sx, st, small):
    """The descriptors ws_accumulate gives k-step ks: the p or ds tile's big
    and small halves (A), the chunk piece's big and small halves (B); its
    first pass takes big.big, its second big.small and small.big."""
    for line in ("const uint32_t x = opaque(sx), t = opaque(st);",
                 "wgmma_ss_tf32_n32(tmp, sw128_desc(x + 32 * ks), "
                 "sw128_desc(t + 32 * ks), ks);",
                 "wgmma_ss_tf32_n32(tmp, sw128_desc(x + 32 * ks), "
                 "sw128_desc(t + small + 32 * ks), ks);",
                 "wgmma_ss_tf32_n32(tmp, sw128_desc(x + kXSplitBytes + "
                 "32 * ks), sw128_desc(t + 32 * ks), 1);"):
        assert line in " ".join(ACCUMULATE.split()).replace("( ", "("), line
    return (sw128_desc(sx + 32 * ks), sw128_desc(sx + C["kXSplitBytes"] + 32 * ks),
            sw128_desc(st + 32 * ks), sw128_desc(st + small + 32 * ks))


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_accumulating_products_meet_at_one_row_and_are_exact(kernel):
    """out[64, kOutCols] += x[64, kWsRows].t[kWsRows, kOutCols] as the
    kernels issue it: A the p or ds tile (store_x), B kPieceCols columns a
    piece of the transposed chunk (store_chunk_t), both through the
    descriptors; at (m, k) A reads x's row m at column 8 ks + k, and at (n,
    k) B reads the chunk's column kPieceCols pc + n at row 8 ks + k; the
    product is exact."""
    call = (r"ws_accumulate\(acc\[pc\], {}, opaque\({}\) \+ pc \* "
            r"kPieceCols \* 128,\s+kOutCols \* 128\);")
    assert re.search(call.format("ds_at", "kt_at") if kernel == "dq" else
                     call.format("x_at_", "ch_at"),
                     DQ if kernel == "dq" else DKV)
    small = COLS * 128
    rng = np.random.default_rng(len(kernel))
    x = rng.integers(-8, 9, (T, ROWS))
    t = rng.integers(-8, 9, (ROWS, COLS))
    xw = {4 * w: ("x",) + cell for w, cell in _x_writes().items()}
    xw.update({C["kXSplitBytes"] + 4 * w: ("xs",) + cell
               for w, cell in _x_writes().items()})
    X0 = 1 << 17  # the chunk and the x tile apart in the model's memory
    mem = dict(xw)
    mem.update({X0 + 4 * w: c for w, c in chunk_writes().items()})
    out = np.zeros((T, COLS), np.int64)
    for pc in range(COLS // PIECE):
        for ks in range(ROWS // 8):
            xb, xs, tb, ts = _accumulate_descs(ks, 0, X0 + pc * PIECE * 128,
                                               small)
            a_cells = read_k_major(mem, xb, T)
            assert a_cells == [[("x", m, 8 * ks + k) for k in range(8)]
                               for m in range(T)]
            assert read_k_major(mem, xs, T) == [
                [("xs", m, 8 * ks + k) for k in range(8)] for m in range(T)]
            for part, desc in (("big", tb), ("small", ts)):
                assert read_k_major(mem, desc, PIECE) == [
                    [(part, 8 * ks + k, PIECE * pc + n) for k in range(8)]
                    for n in range(PIECE)]
            a = np.array([[x[m, c] for _, m, c in row] for row in a_cells])
            b = np.array([[t[r, c] for _, r, c in row]
                          for row in read_k_major(mem, tb, PIECE)])
            out[:, PIECE * pc:PIECE * pc + PIECE] += a @ b.T
    np.testing.assert_array_equal(out, x @ t)


# --------------------------------------------------- 4. shared memory
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_shared_memory_fits_one_block(kernel):
    """The tiles as each kernel's pointers lay them out fit the bytes
    kernel_fn launches it with, within 232,448, and every wgmma operand
    (each stage's halves, the chunk's pieces, the x tile's halves) starts
    1024-byte aligned, the swizzle's period."""
    body = re.search(r"constexpr int ws_smem_bytes\(\) \{\s*return ([^;]+);",
                     SRC).group(1)
    smem = _int_expr(body, C)
    assert smem == 230720 <= MAX_SMEM
    # f32's forward, dk/dv and dq all launch with it
    assert KERNEL_FN.count("*smem = ws_smem_bytes();") == 3
    src = DQ if kernel == "dq" else DKV
    chunk, x = ("kt", "sds") if kernel == "dq" else ("ch", "sx")
    for line in ("align_1024(ws_smem)",
                 f"uint32_t* {chunk} = ring + kStages * kStageBytes / 4;",
                 f"uint32_t* {x} = {chunk} + 2 * kOutCols * kSlabCols;",
                 f"float* rows = reinterpret_cast<float*>({x} + 2 * "
                 "kXSplitBytes / 4);",
                 "const uint32_t bars = smem_addr(rows + 2 * kWsRows);",
                 "ws_init_bars(bars);"):
        assert line in src, line
    assert "for (int s = 0; s <= kStages; ++s) {" in SRC  # ws_init_bars
    ring = C["kStages"] * C["kStageBytes"]
    x_tile = ring + 2 * COLS * 128
    bars = x_tile + 2 * C["kXSplitBytes"] + 2 * ROWS * 4
    assert smem == 1024 + bars + 16 * (C["kStages"] + 1)
    offsets = [ring + h * COLS * 128 + pc * PIECE * 128 for h in range(2)
               for pc in range(COLS // PIECE)]
    offsets += [x_tile, x_tile + C["kXSplitBytes"]]
    offsets += [s * C["kStageBytes"] + o for s in range(C["kStages"])
                for o in (0, C["kOwnHalfBytes"], 2 * C["kOwnHalfBytes"],
                          2 * C["kOwnHalfBytes"] + C["kOtherHalfBytes"])]
    offsets += [32 * 128, 64 * 128]  # a step's second slab (32, 64 rows)
    assert all(o % 1024 == 0 for o in offsets)


# ------------------------------------------------------- 5. the rings
def _consumer_order(src):
    """The consumer loop's buffer operations in order: ("scores", (first
    product, its steps)) for ws_scores from ring index phases n j (+ n),
    ("wait" | "release", "chunk")."""
    loop = src[src.index("for (int j = 0; j < n_tiles; ++j)"):]
    ops = []
    pat = re.compile(r"ws_scores\(\w+, ring_at, bars, ((?:2|phases) \* n \* j"
                     r"(?: \+ n)?), (n|dk_block \? n : 0)\)|mbar_wait\("
                     r"(?:kt|ch)_bars, j & 1\)|release_stage\((?:kt|ch)_bars\)")
    for m in pat.finditer(loop):
        if m.group(1):
            ops.append(("scores", (not m.group(1).endswith("+ n"),
                                   m.group(2))))
        elif m.group(0).startswith("mbar_wait"):
            ops.append(("wait", "chunk"))
        else:
            ops.append(("release", "chunk"))
    return ops


def _scores_order(n):
    """ws_scores' ring operations for n steps, as its code runs them: each
    step waits for its stage, issues its group, waits for the group whole
    and releases the stage."""
    order = [SCORES.index(line) for line in (
        "for (int step = 0; step < n; ++step) {",
        "mbar_wait(bars + 16 * slot, (at / kStages) & 1);",
        "wgmma_commit();", "wgmma_wait<0>();",
        "release_stage(bars + 16 * slot);")]
    assert order == sorted(order)
    assert "const int at = idx + step, slot = at % kStages;" in SCORES
    ops = []
    for step in range(n):
        ops += [("wait", step), ("release", step)]
    return ops


def _producer_items(n, n_tiles, phases):
    """The producer's items in order: ("stage", ring index) or ("chunk",
    tile), as ws_produce's store decodes item k."""
    for line in ("const int n = job.n_steps, per = job.phases * n + 1;",
                 "const int total = job.n_tiles * per;",
                 "const int j = k / per, s = k - j * per;",
                 "const int idx = job.phases * n * j + (s < n ? s : s - 1);",
                 "const int slot = idx % kStages;",
                 "mbar_wait(sb + 8, ((idx / kStages) & 1) ^ 1);",
                 "mbar_wait(cb + 8, (j & 1) ^ 1);",
                 "mbar_arrive(sb);", "mbar_arrive(cb);"):
        assert line in PRODUCE, line
    per = phases * n + 1
    items = []
    for k in range(n_tiles * per):
        j, s = divmod(k, per)
        items.append(("chunk", j) if s == n else
                     ("stage", phases * n * j + (s if s < n else s - 1)))
    return items


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


def _run(kernel, n, n_tiles, seed):
    """Producer and consumer of one block (dk/dv: a dv block, phases 1, or a
    dk block, phases 2), interleaved at random. Fails on a deadlock, an
    item not in its buffer when waited for, or a buffer refilled while
    held."""
    src = DQ if kernel == "dq" else DKV
    phases = 1 if kernel == "dv" else 2
    if kernel == "dq":
        assert "nullptr,     nullptr,  2," in src  # WsJob's phases
    else:
        assert "const int n = D / kChunk, phases = dk_block ? 2 : 1;" in src
    assert "mbar_init(bars + 16 * s, blocks * kTcThreads);" in SRC or \
        "mbar_init(bars + 16 * s, kTcThreads);" in SRC
    assert "mbar_init(bars + 16 * s + 8, kTcWarps);" in SRC
    stages = C["kStages"]
    bufs = [f"s{i}" for i in range(stages)] + ["chunk"]
    full = {b: _Bar(C["kTcThreads"]) for b in bufs}
    empty = {b: _Bar(WARPS) for b in bufs}
    holds, held = {b: None for b in bufs}, {b: False for b in bufs}

    def producer():
        for kind, x in _producer_items(n, n_tiles, phases):
            buf = "chunk" if kind == "chunk" else f"s{x % stages}"
            use = x if kind == "chunk" else x // stages
            while not empty[buf].done((use & 1) ^ 1):
                yield False
            assert not held[buf], (buf, kind, x)
            holds[buf] = (kind, x)
            full[buf].arrive(C["kTcThreads"])
            yield True

    def consumer():
        for j in range(n_tiles):
            for op, arg in _consumer_order(src):
                if op == "scores":
                    first, steps = arg
                    idx = phases * n * j + (0 if first else n)
                    n_steps = n if steps == "n" or phases == 2 else 0
                    for kind, step in _scores_order(n_steps):
                        at = idx + step
                        buf = f"s{at % stages}"
                        if kind == "wait":
                            while not full[buf].done((at // stages) & 1):
                                yield False
                            assert holds[buf] == ("stage", at)
                            held[buf] = True
                        else:
                            held[buf] = False
                            empty[buf].arrive(WARPS)
                        yield True
                elif op == "wait":
                    while not full["chunk"].done(j & 1):
                        yield False
                    assert holds["chunk"] == ("chunk", j)
                    held["chunk"] = True
                    yield True
                else:
                    held["chunk"] = False
                    empty["chunk"].arrive(WARPS)
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
        assert blocked < 1000, f"deadlock at n {n}, {n_tiles} tiles"


def test_the_consumer_orders_are_the_kernels():
    assert _consumer_order(DQ) == [("scores", (True, "n")),
                                   ("scores", (False, "n")),
                                   ("wait", "chunk"), ("release", "chunk")]
    assert _consumer_order(DKV) == [("scores", (True, "n")), ("wait", "chunk"),
                                    ("scores", (False, "dk_block ? n : 0")),
                                    ("release", "chunk")]


@pytest.mark.parametrize("kernel", ["dq", "dv", "dk"])
@pytest.mark.parametrize("n,n_tiles", [(5, 1), (5, 3), (6, 2), (8, 4),
                                       (16, 2), (1, 3), (2, 5)])
def test_the_rings_never_deadlock_or_refill_a_held_buffer(kernel, n, n_tiles):
    for seed in range(8):
        _run(kernel, n, n_tiles, seed)
