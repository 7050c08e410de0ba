"""bf16's dq and dk/dv above head dim 256 on wgmma (flash_bwd_dq_tma_kernel
and flash_bwd_dkv_tma_kernel of
ray_tpu_torch/ops/csrc/flash_attention_dsplit.cu), known without a card.

Both compute one 256-column chunk of their outputs a block (grid (chunks,
tiles, BH)) in two warpgroups fed by TMA, on the machinery of bf16's
forward above 256 (tests/test_torch_dsplit_fwd_wgmma.py): 64-column boxes
in the 128-byte swizzle through a ring of stages that the last of the
eight warps done with a stage refills, four stages deep. dq: 128 Q rows,
stages of a K, a V, a dO and a Q box, K's rows of the chunk in a buffer
of their own. dk/dv: 64 KV rows in both warpgroups, stages of a Q, a dO,
a V and a K box, the chunk's Q and dO in a buffer, p^T handed from
warpgroup 0 to 1 through shared memory. With the constants and index
expressions read from the source, numpy models of shared memory, TMA's
128-byte swizzle and wgmma's descriptors check:

1. every column of dq, dk and dv at head dims 320, 384, 520, 576 and 1024
   is stored by exactly one block and thread, every row once;
2. each kernel's shared memory fits the one block an SM it claims, with
   every TMA destination and wgmma operand 1024-byte aligned and no two
   regions overlapping, and a stage holds every box one 64-column k-step
   of the scores reads;
3. the rings, the chunk buffer and dk/dv's hand-over of p^T, driven by the
   order of the kernels' barrier and count operations under random
   interleavings of the warps and the copies in flight: no wait blocks
   forever, every wait finds the box or tile it expects, and no stage is
   refilled (nor p^T rewritten) while a warp still reads it;
4. the score descriptors read, at each k-step, the columns of the
   operands the k-step stands for, and the accumulating products read the
   chunk's columns; all of them are exact on small integers;
5. the masks zero exactly the causal and ragged entries, and the score
   path takes nothing from the chunk, so every chunk of a row computes
   the same p and ds;
6. the mma.sync templates these kernels replace are gone.
"""
import random
import re

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import flash_attention as tfa
from tests.test_torch_dsplit_fwd_wgmma import C as FWD_C
from tests.test_torch_dsplit_fwd_wgmma import _box, _flat
from tests.test_torch_f32_dsplit_wgmma import (SRC, _Bar, _const, _function,
                                               _int_expr)
from tests.test_torch_wgmma_layout import Smem, sw128_desc, values

MAX_SMEM = 232448  # bytes of shared memory a block may take on an H100
HEAD_DIMS = (320, 384, 520, 576, 1024)
# the split-head-dim source alone (SRC begins with the headers it includes)
CU = SRC[SRC.index("// Flash attention for Hopper (sm_90a) at head dims "
                   "above 256"):]

C = dict(FWD_C)
for _name in ("kBwdStages", "kDqStageBytes", "kDkvStageBytes", "kPtBytes"):
    C[_name] = _const(_name, C)
ROWS, KV, BOX = C["kTmaRows"], C["kTmaKv"], C["kBoxCols"]
COLS, STAGES = C["kOutCols"], C["kBwdStages"]
WARPS = C["kTmaThreads"] // 32
DQ = _function("flash_bwd_dq_tma_kernel(const __grid_constant__")
DKV = _function("flash_bwd_dkv_tma_kernel(const __grid_constant__")
SETUP = _function("__device__ __forceinline__ BwdBlock bwd_setup(")
LOAD_STAGE = _function(
    "__device__ __forceinline__ void bwd_load_stage(const BwdBlock& t,")
LOAD_CHUNK = _function(
    "__device__ __forceinline__ void bwd_load_chunk(const BwdBlock& t,")
DONE_BOX = _function(
    "__device__ __forceinline__ void bwd_done_box(const BwdBlock& t,")
DONE_CHUNK = _function(
    "__device__ __forceinline__ void bwd_done_chunk(const BwdBlock& t,")
BOX_FN = _function("__device__ __forceinline__ void bwd_issue_box(")
SCORES = _function("__device__ __forceinline__ void bwd_scores(")
STORE = _function("__device__ __forceinline__ void bwd_store(")
PV = _function("__device__ __forceinline__ void tma_pv(")
LAST_DONE = _function("__device__ __forceinline__ bool tma_last_done(")
KERNEL_FN = _function("const void* kernel_fn(int kernel, int* smem")
GRID_OF = _function("dim3 grid_of(int kernel, int bh, int seq, int d, int cols)")


def stage_bytes(kernel):
    return C["kDqStageBytes"] if kernel == "dq" else C["kDkvStageBytes"]


def _padded(D):
    family, Dk = tfa.kernel_plan(torch.bfloat16, D)
    assert family == "bf16_dsplit"
    return Dk


def test_the_constants():
    assert {k: C[k] for k in ("kBwdStages", "kDqStageBytes",
                              "kDkvStageBytes", "kPtBytes")} == {
        "kBwdStages": 4, "kDqStageBytes": 49152, "kDkvStageBytes": 32768,
        "kPtBytes": 16384}
    for kernel in ("flash_bwd_dq_tma_kernel", "flash_bwd_dkv_tma_kernel"):
        assert f"__launch_bounds__(kTmaThreads, 1)\n    {kernel}(" in CU
    # kernel_fn hands the new kernels to bf16's dq (2) and dk/dv (1), each
    # with its shared memory, two warpgroups and 256-column chunks
    assert "*threads = kF32 ? kWsThreads : kTmaThreads;" in KERNEL_FN
    assert "*cols = kOutCols;" in KERNEL_FN
    for case, smem, fn in (("case 1:", "tma_dkv_smem_bytes",
                            "flash_bwd_dkv_tma_kernel"),
                           ("case 2:", "tma_dq_smem_bytes",
                            "flash_bwd_dq_tma_kernel")):
        body = KERNEL_FN.split(case)[1]
        assert body.index(f"*smem = {smem}();") < body.index(
            f"return (const void*){fn};")


def test_the_mma_sync_templates_are_gone():
    """The 64-column mma.sync templates and everything only they used are
    gone from the source; pack_bf16, which the forward uses, stays."""
    for gone in (r"flash_bwd_dq_dsplit_kernel", r"flash_bwd_dkv_dsplit_kernel",
                 r"struct Io\b", r"\bIo<", r"\bkDqRows\b", r"\bkDkvRows\b",
                 r"\bkRowWords\b", r"\bkDqStage\b", r"\bkDkvStage\b",
                 r"\bkDkvOut\b", r"\bdq_smem_bytes\b", r"\bdkv_smem_bytes\b",
                 r"\bldsm_x4", r"\bmma_bf16\b", r"ldmatrix",
                 r"mma\.sync\.aligned", r"\bcp_async", r"load_rows_async",
                 r"\bsmem_u32\b"):
        assert not re.search(gone, CU), gone
    assert "__device__ __forceinline__ uint32_t pack_bf16(" in CU
    assert "pack_bf16(sc[8 * kk + 2 * i]" in CU  # tma_pack, the forward's


# ------------------------------------------------ 1. who stores a column
def _store_lines():
    for line in ("const int rr = row + 8 * r;", "if (rr >= seq) continue;",
                 "const int col = c0 + h * kBoxCols;",
                 "if (col >= D) continue;",
                 "out + (size_t)rr * D + col + 8 * j + 2 * tq) = "
                 "__floats2bfloat162_rn(acc[h][4 * j + 2 * r], "
                 "acc[h][4 * j + 2 * r + 1]);"):
        assert line in _flat(STORE), line
    assert "const int c0 = blockIdx.x * kOutCols;" in SETUP
    assert "(int)(threadIdx.x >> 7)};" in _flat(SETUP)  # the warpgroup


def _owners(kernel, Dk):
    """{(output, row of the block's tile, column): (chunk, thread)} as
    bwd_store stores them."""
    _store_lines()
    if kernel == "dq":
        for line in ("const int warp = threadIdx.x >> 5, lane = threadIdx.x "
                     "& 31;", "const int g = lane >> 2, tq = lane & 3;",
                     "const int wg_row0 = q0 + t.wg * 64;",
                     "const int row = wg_row0 + (warp & 3) * 16 + g;",
                     "bwd_store(dq + rbase * D, acc, row, t.c0, tq, seq, D);"):
            assert line in _flat(DQ), line
    else:
        for line in ("const int krow = k0 + (warp & 3) * 16 + g;",
                     "bwd_store((t.wg == 0 ? dv : dk) + (size_t)t.bh * seq * "
                     "D, acc, krow, t.c0, tq, seq, D);"):
            assert line in _flat(DKV), line
    owners = {}
    for x in range(-(-Dk // COLS)):
        for tid in range(C["kTmaThreads"]):
            warp, lane = tid >> 5, tid & 31
            wg = warp >> 2
            if kernel == "dq":
                out, row = "dq", 64 * wg + 16 * (warp & 3) + (lane >> 2)
            else:
                out, row = ("dv" if wg == 0 else "dk"), 16 * (warp & 3) + (
                    lane >> 2)
            for r in range(2):
                for h in range(COLS // BOX):
                    col0 = x * COLS + h * BOX
                    if col0 >= Dk:
                        continue
                    for j in range(8):
                        for cc in range(2):
                            key = (out, row + 8 * r,
                                   col0 + 8 * j + 2 * (lane & 3) + cc)
                            assert key not in owners, key
                            owners[key] = (x, tid)
    return owners


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_every_output_column_has_one_owner(kernel, D):
    """grid x = the chunks (D padded to a multiple of 64, over kOutCols,
    rounded up): every (row, column) of a block's tile of dq (128 rows),
    dk and dv (64 rows) is stored once; columns past D are not."""
    Dk = _padded(D)
    assert "return dim3(chunks, tiles, bh);" in GRID_OF
    assert "chunks = (d + cols - 1) / cols;" in GRID_OF
    owners = _owners(kernel, Dk)
    outs, rows = (["dq"], ROWS) if kernel == "dq" else (["dk", "dv"], KV)
    assert sorted(owners) == [(o, r, c) for o in outs for r in range(rows)
                              for c in range(Dk)]


@pytest.mark.parametrize("seq", [129, 200, 1000, 1024])
def test_every_row_has_one_block(seq):
    """grid y: dq's 128-row Q tiles, longest first, dk/dv's 64-row KV
    tiles; every row below S lies in one block's tile, rows past S are
    skipped (the store's rr >= seq)."""
    assert "const int rows = std::is_same_v<T, float> || kernel == 1 ? " \
        "kTile : kTmaRows;" in GRID_OF
    assert "const int q0 = (gridDim.y - 1 - blockIdx.y) * kTmaRows;" in DQ
    assert "const int k0 = blockIdx.y * kTmaKv;" in DKV
    for rows, first in ((ROWS, lambda y, n: (n - 1 - y) * ROWS),
                        (KV, lambda y, n: y * KV)):
        n = (seq + rows - 1) // rows
        got = sorted(r for y in range(n)
                     for r in range(first(y, n), first(y, n) + rows)
                     if r < seq)
        assert got == list(range(seq))


# --------------------------------------------------- 2. shared memory
def _smem_bytes(kernel):
    name = "tma_dq_smem_bytes" if kernel == "dq" else "tma_dkv_smem_bytes"
    body = re.search(rf"constexpr int {name}\(\) \{{\s*return ([^;]+);",
                     CU).group(1)
    return _int_expr(body, C)


def _regions(kernel):
    """{name: (start, end)} of what a block uses, as the kernel lays out
    its shared memory and its loads fill it."""
    dq = kernel == "dq"
    own_box = C["kQBoxBytes"] if dq else C["kKBoxBytes"]
    boxes = ([("k", C["kKBoxBytes"]), ("v", C["kKBoxBytes"]),
              ("do", own_box), ("q", own_box)] if dq else
             [("q", C["kKBoxBytes"]), ("do", C["kKBoxBytes"]),
              ("v", own_box), ("k", own_box)])
    # the offsets bwd_load_stage writes each box at
    flat = _flat(LOAD_STAGE)
    for line in ("constexpr int kStageBytes = kDq ? kDqStageBytes : "
                 "kDkvStageBytes;",
                 "constexpr int kOwnBox = kDq ? kQBoxBytes : kKBoxBytes;",
                 "const uint32_t bar = t.bars + 8 * slot, st = t.ring + slot "
                 "* kStageBytes;",
                 "tma_load(st, kDq ? t.k : t.q, bar, col, o, t.bh);",
                 "tma_load(st + kKBoxBytes, kDq ? t.v : t.dout, bar, col, o, "
                 "t.bh);",
                 "tma_load(st + 2 * kKBoxBytes, kDq ? t.dout : t.v, bar, col, "
                 "t.own0, t.bh);",
                 "tma_load(st + 2 * kKBoxBytes + kOwnBox, kDq ? t.q : t.k, "
                 "bar, col, t.own0, t.bh);",
                 "mbar_expect_tx(bar, kStageBytes);"):
        assert line in flat, line
    offsets = [0, C["kKBoxBytes"], 2 * C["kKBoxBytes"],
               2 * C["kKBoxBytes"] + own_box]
    assert sum(size for _, size in boxes) == stage_bytes(kernel)
    regions = {}
    for slot in range(STAGES):
        for (name, size), off in zip(boxes, offsets):
            a = slot * stage_bytes(kernel) + off
            regions[(name, slot)] = (a, a + size)
    ring = STAGES * stage_bytes(kernel)
    assert "ring + kBwdStages * kStageBytes," in _flat(SETUP)  # t.chunk
    for h in range(COLS // BOX):
        a = ring + h * C["kKBoxBytes"]
        regions[("chunk", h)] = (a, a + C["kKBoxBytes"])
        if not dq:  # dO's chunk, kVBytes on
            assert "tma_load(t.chunk + kVBytes + h * kKBoxBytes, t.dout, bar," \
                in _flat(LOAD_CHUNK)
            regions[("do chunk", h)] = (a + C["kVBytes"],
                                        a + C["kVBytes"] + C["kKBoxBytes"])
    if dq:
        assert "const uint32_t bars = ring + kBwdStages * kDqStageBytes + " \
            "kVBytes;" in DQ
        bars = ring + C["kVBytes"]
        n_bars = STAGES + 1
    else:
        assert "float* pt = reinterpret_cast<float*>(base + kBwdStages * " \
            "kDkvStageBytes + 2 * kVBytes);" in _flat(DKV)
        assert "const uint32_t bars = smem_addr(pt) + kPtBytes;" in DKV
        pt = ring + 2 * C["kVBytes"]
        regions["pt"] = (pt, pt + C["kPtBytes"])
        bars = pt + C["kPtBytes"]
        n_bars = STAGES + 3
    regions["barriers"] = (bars, bars + 8 * n_bars)
    regions["done"] = (bars + 8 * n_bars,
                       bars + 8 * n_bars + 4 * (STAGES + 1))
    return regions


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_shared_memory_fits_one_block(kernel):
    """The regions in use do not overlap, every box a TMA copy writes (and
    a wgmma reads) starts 1024-byte aligned, all within the smem
    function's bytes less the alignment slack, and one block takes an
    SM."""
    smem = _smem_bytes(kernel)
    assert smem == (230460 if kernel == "dq" else 214092)
    assert smem <= MAX_SMEM < 2 * smem
    regions = _regions(kernel)
    spans = sorted(regions.values())
    for (a0, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 <= b0
    assert spans[-1][1] <= smem - 1024
    for name, (start, _) in regions.items():
        if name in ("barriers", "done"):
            assert start % 8 == 0
        else:
            assert start % 1024 == 0, name
    # dq's warpgroups read their 64 rows of a [128, 64] box 8 KB apart
    assert "const uint32_t rows = t.wg * 64 * 128;" in BOX_FN
    assert (64 * 128) % 1024 == 0


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_a_stage_holds_every_box_of_a_k_step(kernel):
    """A stage holds the four boxes one 64-column k-step of the scores
    reads, of the other axis' tile (its first two) and of the block's own
    rows (the last two); a fifth stage would not fit beside the chunk."""
    regions = _regions(kernel)
    names = {n for n, slot in (k for k in regions if isinstance(k, tuple))
             if isinstance(slot, int) and n not in ("chunk", "do chunk")}
    assert names == {"k", "v", "do", "q"}
    assert _smem_bytes(kernel) + stage_bytes(kernel) > MAX_SMEM


# ------------------------------------------------------- 3. the rings
def _box_ops(nb, idx):
    """A warp's operations on the ring over one tile's boxes, as
    bwd_scores takes them: ("wait", i) then ("done", i - 1) for each box
    past the first; the kernel counts the last box done itself."""
    for line in ("bwd_issue_box<kDq>(x, y, t, idx++, 0); for (int b = 1; b "
                 "< t.nb; ++b) { bwd_issue_box<kDq>(x, y, t, idx++, b); "
                 "wgmma_wait<1>(); // box b - 1 is read "
                 "bwd_done_box<kDq>(t, idx - 2); }",):
        assert line in _flat(SCORES), line
    assert "mbar_wait(t.bars + 8 * slot, (idx / kBwdStages) & 1);" in \
        BOX_FN
    ops = []
    for b in range(nb):
        ops.append(("wait", idx + b))
        if b > 0:
            ops.append(("done", idx + b - 1))
    return ops


def _dq_ops(nb, n_w, n_kv):
    """One dq warp's operations, in the order of flash_bwd_dq_tma_kernel:
    each tile's boxes, the last counted done once the scores are waited
    for, the tile's chunk waited for and counted done once ds.k is; then
    the boxes of a tile the warp skips."""
    flat = _flat(DQ)
    order = [flat.index(line) for line in (
        "for (int it = 0; it < n_w; ++it) { bwd_scores<true>(dp, sc, t, "
        "idx); wgmma_wait<0>(); fence_regs(dp); fence_regs(sc); "
        "bwd_done_box<true>(t, idx - 1);",
        "tma_pack(da, sc); mbar_wait(chunk_full, it & 1); wgmma_fence(); "
        "tma_pv(acc, da, t.chunk); // dq[:, chunk] += ds.k[:, chunk] "
        "wgmma_wait<0>(); fence_regs(acc); fence_regs(da); "
        "bwd_done_chunk<true>(t, it); }",
        "for (; idx < n_kv * t.nb; ++idx) { mbar_wait(t.bars + 8 * (idx % "
        "kBwdStages), (idx / kBwdStages) & 1); bwd_done_box<true>(t, idx); }")]
    assert order == sorted(order)
    ops = []
    for it in range(n_w):
        ops += _box_ops(nb, it * nb)
        ops += [("done", it * nb + nb - 1), ("wait chunk", it),
                ("done chunk", it)]
    for i in range(n_w * nb, n_kv * nb):
        ops += [("wait", i), ("done", i)]
    return ops


def _dkv_ops(nb, n_q, wg):
    """One dk/dv warp's operations, in the order of
    flash_bwd_dkv_tma_kernel: as dq's, with the hand-over of p^T after each
    tile's scores (warpgroup 0 waits for it to be free, writes it, arrives
    on p_full; 1 waits on p_full, reads it, arrives on p_empty)."""
    flat = _flat(DKV)
    order = [flat.index(line) for line in (
        "for (int j = 0; j < n_q; ++j) {",
        "bwd_scores<false>(x, x, t, idx); wgmma_wait<0>(); fence_regs(x); "
        "bwd_done_box<false>(t, idx - 1);",
        "mbar_wait(p_empty, (j & 1) ^ 1);",
        "for (int i = 0; i < 32; ++i) pt[i * kTcThreads + tw] = x[i]; "
        "mbar_arrive(p_full);",
        "mbar_wait(p_full, j & 1);",
        "mbar_arrive(p_empty);",
        "tma_pack(pa, x); mbar_wait(chunk_full, j & 1); wgmma_fence();",
        "wgmma_wait<0>(); fence_regs(acc); fence_regs(pa); "
        "bwd_done_chunk<false>(t, j); }")]
    assert order == sorted(order)
    for line in ("mbar_init(p_full, kTcThreads);",
                 "mbar_init(p_empty, kTcThreads);"):
        assert line in DKV, line
    hand = ([("wait p_empty",), ("write pt",), ("arrive p_full",)] if wg == 0
            else [("wait p_full",), ("read pt",), ("arrive p_empty",)])
    ops = []
    for j in range(n_q):
        ops += _box_ops(nb, j * nb)
        ops.append(("done", j * nb + nb - 1))
        ops += [op + (j,) for op in hand]
        ops += [("wait chunk", j), ("done chunk", j)]
    return ops


def _run(kernel, nb, n_tiles, n_ws, seed):
    """The eight warps (dq: n_ws[w // 4] tiles used by warp w) and the
    copies in flight, interleaved at random. Thread 0's first loads go out
    before any warp starts. Fails on a deadlock, a wait that finds another
    box or tile, a stage or chunk refilled while a warp has waited for it
    and is not done, or p^T written while a warp of warpgroup 1 reads it."""
    flat = _flat(SETUP)
    for line in ("for (int i = 0; i < kBwdStages && i < t.nb * n_tiles; ++i) "
                 "bwd_load_stage<kDq>(t, i); bwd_load_chunk<kDq>(t, 0);",):
        assert line in flat, line
    assert "last = atomicAdd(done + i, 1) % (2 * kTcWarps) == " \
        "2 * kTcWarps - 1;" in LAST_DONE
    assert "if (tma_last_done(t.done, idx % kBwdStages) && idx + kBwdStages " \
        "< t.nb * t.n_tiles) bwd_load_stage<kDq>(t, idx + kBwdStages);" in \
        _flat(DONE_BOX)
    assert "if (tma_last_done(t.done, kBwdStages) && j + 1 < t.n_tiles) " \
        "bwd_load_chunk<kDq>(t, j + 1);" in _flat(DONE_CHUNK)
    stages = STAGES
    total = nb * n_tiles
    full = {s: _Bar(1) for s in range(stages)}
    full["chunk"] = _Bar(1)
    p_full, p_empty = _Bar(WARPS // 2), _Bar(WARPS // 2)
    holds = {}
    done = {s: 0 for s in list(range(stages)) + ["chunk"]}
    readers = {s: set() for s in list(range(stages)) + ["chunk"]}
    pt_readers = set()
    flying = []

    def issue(stage, what):
        assert not readers[stage], (stage, what, readers[stage])
        flying.append((stage, what))

    for i in range(min(stages, total)):
        issue(i % stages, ("box", i))
    issue("chunk", ("chunk", 0))

    def warp(w):
        ops = (_dq_ops(nb, n_ws[w // 4], n_tiles) if kernel == "dq"
               else _dkv_ops(nb, n_tiles, w // 4))
        for op in ops:
            kind = op[0]
            if kind in ("wait", "wait chunk"):
                stage, use, want = {
                    "wait": lambda: (op[1] % stages, op[1] // stages,
                                     ("box", op[1])),
                    "wait chunk": lambda: ("chunk", op[1], ("chunk", op[1]))
                }[kind]()
                while not full[stage].done(use & 1):
                    yield False
                assert holds[stage] == want, (w, op, holds[stage])
                readers[stage].add(w)
                yield True
            elif kind in ("done", "done chunk"):
                stage = op[1] % stages if kind == "done" else "chunk"
                readers[stage].discard(w)
                done[stage] += 1
                if done[stage] % WARPS == 0:  # the last of the eight
                    if kind == "done" and op[1] + stages < total:
                        issue(stage, ("box", op[1] + stages))
                    if kind == "done chunk" and op[1] + 1 < n_tiles:
                        issue("chunk", ("chunk", op[1] + 1))
                yield True
            elif kind == "wait p_empty":
                while not p_empty.done((op[1] & 1) ^ 1):
                    yield False
                yield True
            elif kind == "write pt":
                assert not pt_readers, (w, op, pt_readers)
                yield True
            elif kind == "arrive p_full":
                p_full.arrive()
                yield True
            elif kind == "wait p_full":
                while not p_full.done(op[1] & 1):
                    yield False
                pt_readers.add(w)
                yield True
            elif kind == "read pt":
                yield True
            else:  # arrive p_empty
                pt_readers.discard(w)
                p_empty.arrive()
                yield True

    rng = random.Random(seed)
    agents = {w: warp(w) for w in range(WARPS)}
    blocked = 0
    while agents or flying:
        if flying and (not agents or rng.random() < 0.3):
            stage, what = flying.pop(rng.randrange(len(flying)))
            holds[stage] = what
            full[stage].arrive()
            blocked = 0
            continue
        w = rng.choice(list(agents))
        try:
            blocked = 0 if next(agents[w]) else blocked + 1
        except StopIteration:
            del agents[w]
            blocked = 0
        assert blocked < 2000, f"deadlock: {kernel}, nb {nb}, {n_tiles} " \
            f"tiles, {n_ws}"


@pytest.mark.parametrize("nb,n_kv,n_ws", [
    (3, 2, (1, 2)), (5, 1, (1, 1)), (5, 3, (3, 3)), (8, 2, (1, 2)),
    (8, 4, (4, 4)), (9, 3, (3, 3)), (16, 2, (1, 2)), (6, 5, (4, 5))])
def test_dq_ring_never_deadlocks_or_refills_a_held_stage(nb, n_kv, n_ws):
    """Fewer boxes a tile than stages and more, under causal masking
    (warpgroup 0 skips the block's last KV tile) and not."""
    for seed in range(5):
        _run("dq", nb, n_kv, n_ws, seed)


@pytest.mark.parametrize("nb,n_q", [(3, 2), (5, 1), (5, 3), (8, 2), (8, 4),
                                    (16, 3), (6, 5)])
def test_dkv_ring_and_hand_over_never_deadlock_or_clobber(nb, n_q):
    """p^T single-buffered between the warpgroups."""
    for seed in range(5):
        _run("dkv", nb, n_q, (n_q, n_q), seed)


def test_dq_warpgroups_use_the_tiles_of_their_rows():
    """n_w: every tile for a non-causal block; under causal masking the
    tiles up to the warpgroup's last row, so warpgroup 0 of a 128-row tile
    skips at most the block's last 64-row tile."""
    flat = _flat(DQ)
    assert "const int n_w = causal ? (min(wg_row0 + 64, seq) + kTmaKv - 1) " \
        "/ kTmaKv : n_kv;" in flat
    assert "const int n_kv = ((causal ? min(q0 + kTmaRows, seq) : seq) + " \
        "kTmaKv - 1) / kTmaKv;" in flat
    assert "const int n_q = (seq - q_begin + kTmaKv - 1) / kTmaKv;" in DKV
    for seq in (129, 200, 1000, 1024):
        for q0 in range(0, seq, ROWS):
            n_kv = (min(q0 + ROWS, seq) + KV - 1) // KV
            for wg in (0, 1):
                n_w = (min(q0 + 64 * wg + 64, seq) + KV - 1) // KV
                assert n_kv - 1 <= n_w <= n_kv and n_w >= 1


# ------------------------------------------------ 4. the descriptors
def _stage_smem(kernel, D, idx, x):
    """Shared memory holding ring index idx's stage, as bwd_load_stage
    writes it: x maps each operand's name to its [rows, D + 64] values
    (zeros past D); the own operands take the block's rows, the others
    the tile's."""
    nb = D // BOX
    assert "const int slot = idx % kBwdStages, j = idx / t.nb, b = idx - " \
        "j * t.nb;" in LOAD_STAGE
    assert "const int col = b * kBoxCols, o = t.o_begin + j * kTmaKv;" in \
        LOAD_STAGE
    dq = kernel == "dq"
    own_box = C["kQBoxBytes"] if dq else C["kKBoxBytes"]
    b = idx % nb
    smem = Smem()
    st = (idx % STAGES) * stage_bytes(kernel)
    names = ["k", "v", "do", "q"] if dq else ["q", "do", "v", "k"]
    offsets = [0, C["kKBoxBytes"], 2 * C["kKBoxBytes"],
               2 * C["kKBoxBytes"] + own_box]
    for name, off in zip(names, offsets):
        _box(smem, st + off, name, x[name], b * BOX)
    return smem


def _issue_descs(kernel, idx, wg):
    """The descriptors bwd_issue_box gives ring index idx for warpgroup wg,
    k-step 0 (a k-step is +2, 32 bytes): dq [(dO, V), (Q, K)], dk/dv [(A,
    B)]."""
    flat = _flat(BOX_FN)
    assert "const int slot = idx % kBwdStages;" in flat
    st = (idx % STAGES) * stage_bytes(kernel)
    if kernel == "dq":
        for line in ("const uint32_t st = opaque(t.ring) + slot * "
                     "kDqStageBytes;",
                     "const uint64_t dk = sw128_desc(st), dv = sw128_desc(st "
                     "+ kKBoxBytes);",
                     "const uint64_t ddo = sw128_desc(st + 2 * kKBoxBytes + "
                     "rows);",
                     "const uint64_t dq = sw128_desc(st + 2 * kKBoxBytes + "
                     "kQBoxBytes + rows);",
                     "wgmma_bf16_ss(x, ddo + 2 * kk, dv + 2 * kk, b | kk);",
                     "wgmma_bf16_ss(y, dq + 2 * kk, dk + 2 * kk, b | kk);"):
            assert line in flat, line
        rows = wg * 64 * 128
        return [(sw128_desc(st + 2 * C["kKBoxBytes"] + rows),
                 sw128_desc(st + C["kKBoxBytes"])),
                (sw128_desc(st + 2 * C["kKBoxBytes"] + C["kQBoxBytes"] +
                            rows), sw128_desc(st))]
    for line in ("const uint32_t st = opaque(t.ring) + slot * kDkvStageBytes;",
                 "const uint64_t da = sw128_desc(st + (t.wg == 0 ? 3 * "
                 "kKBoxBytes : 2 * kKBoxBytes));",
                 "const uint64_t db = sw128_desc(st + t.wg * kKBoxBytes);",
                 "wgmma_bf16_ss(x, da + 2 * kk, db + 2 * kk, b | kk);"):
        assert line in flat, line
    return [(sw128_desc(st + (3 if wg == 0 else 2) * C["kKBoxBytes"]),
             sw128_desc(st + wg * C["kKBoxBytes"]))]


def _operands(kernel, D, rng):
    """Small integers for each operand, [rows, D + 64] (zeros past D):
    the own axis' 128 (dq) or 64 (dk/dv) rows, the other axis' 64."""
    own_rows = ROWS if kernel == "dq" else KV
    names = {"dq": {"q": own_rows, "do": own_rows, "k": KV, "v": KV},
             "dkv": {"k": own_rows, "v": own_rows, "q": KV, "do": KV}}[kernel]
    return {n: np.pad(rng.integers(-8, 9, (r, D)), ((0, 0), (0, BOX)))
            for n, r in names.items()}


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("D", [320, 512, 576])
def test_scores_read_their_columns_and_are_exact(kernel, D):
    """One tile's score products of each warpgroup, box by box through the
    ring, as TMA writes the boxes and the descriptors read them: k-step
    kk of box b reads columns 64 b + 16 kk to + 15 of both operands, the
    A rows the warpgroup's, and the sums are exact. dq: dp = do.v^T and s
    = q.k^T; dk/dv: s^T = k.q^T (warpgroup 0), dp^T = v.do^T (1)."""
    rng = np.random.default_rng(D)
    nb = D // BOX
    x = _operands(kernel, D, rng)
    if kernel == "dq":
        pairs = [("do", "v"), ("q", "k")]
    else:
        pairs = {0: [("k", "q")], 1: [("v", "do")]}
    sums = {}
    first = 3 * nb  # the tile's first box sits in the ring's middle
    for b in range(nb):
        idx = first + b
        smem = _stage_smem(kernel, D, idx, x)
        for wg in (0, 1):
            names = pairs if kernel == "dq" else pairs[wg]
            arow = 64 * wg if kernel == "dq" else 0
            for (an, bn), (da, db) in zip(names,
                                          _issue_descs(kernel, idx, wg)):
                for kk in range(BOX // 16):
                    a = smem.read_k_major(da + 2 * kk, 64)
                    bt = smem.read_k_major(db + 2 * kk, KV)
                    cols = list(range(BOX * b + 16 * kk,
                                      BOX * b + 16 * kk + 16))
                    assert [[(c[0], c[1], c[2]) for c in row] for row in a] \
                        == [[(an, arow + m, c) for c in cols]
                            for m in range(64)]
                    assert [[(c[0], c[1], c[2]) for c in row] for row in bt] \
                        == [[(bn, m, c) for c in cols] for m in range(KV)]
                    key = (wg, an)
                    sums[key] = sums.get(key, 0) + values(a) @ values(bt).T
    for (wg, an), s in sums.items():
        bn = dict(pairs)[an] if kernel == "dq" else pairs[wg][0][1]
        arow = 64 * wg if kernel == "dq" else 0
        np.testing.assert_array_equal(
            s, x[an][arow:arow + 64, :D] @ x[bn][:, :D].T)


@pytest.mark.parametrize("kernel,D,chunk", [
    ("dq", 320, 0), ("dq", 320, 1), ("dq", 512, 1), ("dq", 1024, 3),
    ("dkv", 320, 1), ("dkv", 512, 0), ("dkv", 576, 2)])
def test_accumulating_products_read_the_chunk_and_are_exact(kernel, D, chunk):
    """out[:, chunk] += x.y[:, chunk] of a tile (tma_pv over the chunk's
    buffer): dq ds.k, dk/dv p^T.do (warpgroup 0, dO's chunk kVBytes on)
    and ds^T.q (1). The buffer holds the chunk's boxes that lie below D
    (bwd_load_chunk), box h at h * kKBoxBytes; k-step kk of box h reads
    the tile's rows 16 kk to + 15, columns c0 + 64 h on, and the product
    is exact; boxes past D are neither loaded nor stored."""
    assert "wgmma_bf16_rs(acc[h], pa[kk], sw128_desc(opaque(sv) + h * " \
        "kKBoxBytes) + kk * 128);" in _flat(PV)
    flat = _flat(LOAD_CHUNK)
    for line in ("const int o = t.o_begin + j * kTmaKv;",
                 "tma_load(t.chunk + h * kKBoxBytes, kDq ? t.k : t.q, bar, "
                 "t.c0 + h * kBoxCols, o, t.bh);",
                 "tma_load(t.chunk + kVBytes + h * kKBoxBytes, t.dout, bar, "
                 "t.c0 + h * kBoxCols, o, t.bh);",
                 "mbar_expect_tx(bar, (kDq ? 1 : 2) * t.chunk_boxes * "
                 "kKBoxBytes);"):
        assert line in flat, line
    assert "min(kOutCols, D - c0) / kBoxCols," in _flat(SETUP)
    if kernel == "dq":
        assert "tma_pv(acc, da, t.chunk); // dq[:, chunk] += ds.k[:, chunk]" \
            in _flat(DQ)
        users = {0: ("k", 0)}
    else:
        assert "tma_pv(acc, pa, t.chunk + (t.wg == 0 ? kVBytes : 0));" in \
            _flat(DKV)
        users = {0: ("do", C["kVBytes"]), 1: ("q", 0)}
    rng = np.random.default_rng(chunk + D)
    c0 = chunk * COLS
    boxes = min(COLS, D - c0) // BOX
    ring = STAGES * stage_bytes(kernel)
    y = {n: rng.integers(-8, 9, (KV, D + BOX)) for n in ("k", "q", "do")}
    smem = Smem()
    for h in range(boxes):
        for name, off in ({"dq": [("k", 0)],
                           "dkv": [("q", 0), ("do", C["kVBytes"])]}[kernel]):
            _box(smem, ring + off + h * C["kKBoxBytes"], name, y[name],
                 c0 + h * BOX)
    for wg, (name, off) in users.items():
        xa = rng.integers(-8, 9, (64, KV))
        out = np.zeros((64, boxes * BOX), np.int64)
        for kk in range(KV // 16):
            for h in range(boxes):
                b = smem.read_mn_major(sw128_desc(ring + off + h *
                                                  C["kKBoxBytes"]) + kk * 128,
                                       BOX)
                assert {(c[0], c[1], c[2]) for row in b for c in row} == {
                    (name, r, c) for r in range(16 * kk, 16 * kk + 16)
                    for c in range(c0 + h * BOX, c0 + h * BOX + BOX)}
                out[:, h * BOX:(h + 1) * BOX] += \
                    xa[:, 16 * kk:16 * kk + 16] @ values(b)
        np.testing.assert_array_equal(
            out, xa @ y[name][:, c0:c0 + boxes * BOX])


# ------------------------------------- 5. the masks, one order, one p
def test_dq_mask_zeroes_the_causal_and_ragged_entries():
    """A KV tile's p is zeroed where the column passes the row (causal) or
    S, only in the tiles flagged masked, and every such entry of rows
    below S lies in a flagged tile."""
    flat = _flat(DQ)
    for line in ("const bool masked = (causal && k0 + kTmaKv - 1 > wg_row0) "
                 "|| k0 + kTmaKv > seq;",
                 "const int h = i >> 1, col = k0 + 8 * j + 2 * tq + (i & 1);",
                 "if (masked && ((causal && col > row + 8 * h) || col >= seq)) "
                 "p = 0.f;",
                 "sc[4 * j + i] = p * (dp[4 * j + i] - dl[h]) * scale; // ds"):
        assert line in flat, line
    for seq in (129, 200, 1024):
        for causal in (True, False):
            for q0 in range(0, seq, ROWS):
                n_kv = ((min(q0 + ROWS, seq) if causal else seq) + KV - 1) \
                    // KV
                for wg in (0, 1):
                    r0 = q0 + 64 * wg
                    rows = np.arange(r0, r0 + 64)[:, None]
                    for it in range(n_kv):
                        k0 = it * KV
                        cols = np.arange(k0, k0 + KV)[None, :]
                        want = (causal & (cols > rows)) | (cols >= seq)
                        masked = (causal and k0 + KV - 1 > r0) or \
                            k0 + KV > seq
                        if not masked:
                            assert not want[rows[:, 0] < seq].any()


def test_dkv_mask_zeroes_the_causal_and_ragged_entries():
    """p^T of a Q tile is zeroed where the Q row precedes the KV row
    (causal) or passes S, only in flagged tiles, and every such entry of
    KV rows below S lies in a flagged tile; warpgroup 1's ds^T takes p^T,
    so it is zero there too."""
    flat = _flat(DKV)
    for line in ("const bool masked = (causal && q0 < k0 + kTmaKv - 1) || "
                 "q0 + kTmaKv > seq;",
                 "const int c = q0 + 8 * n + 2 * tq + (i & 1);",
                 "if (masked && ((causal && c < krow + 8 * (i >> 1)) || c >= "
                 "seq)) p = 0.f;",
                 "x[i] = pt[i * kTcThreads + tw] * (x[i] - rv[2 * (i >> 2) + "
                 "(i & 1)]) * scale;",
                 "const int q_begin = causal ? k0 : 0;"):
        assert line in flat, line
    for seq in (129, 200, 1024):
        for causal in (True, False):
            for k0 in range(0, seq, KV):
                q_begin = k0 if causal else 0
                kv = np.arange(k0, k0 + KV)[:, None]
                for q0 in range(q_begin, seq, KV):
                    qs = np.arange(q0, q0 + KV)[None, :]
                    want = (causal & (qs < kv)) | (qs >= seq)
                    masked = (causal and q0 < k0 + KV - 1) or q0 + KV > seq
                    if not masked:
                        assert not want[kv[:, 0] < seq].any()
                # Q tiles before q_begin see only masked entries
                for q0 in range(0, q_begin, KV):
                    qs = np.arange(q0, q0 + KV)[None, :]
                    assert (qs < kv).all()


def test_the_hand_over_reads_what_warpgroup_0_wrote():
    """Thread tw of warpgroup 1 reads p^T value i at the word thread tw of
    warpgroup 0 wrote it (i * kTcThreads + tw), and both hold the same
    (KV row, Q column) there: the accumulator layout of a 64-row wgmma is
    the warpgroup's own, and both take all 64 KV rows."""
    flat = _flat(DKV)
    assert "const int tw = threadIdx.x & (kTcThreads - 1);" in flat
    assert "const int krow = k0 + (warp & 3) * 16 + g;" in flat
    words = {}
    for tw in range(C["kTcThreads"]):
        for i in range(32):
            w = i * C["kTcThreads"] + tw
            assert w not in words
            words[w] = tw
    assert sorted(words) == list(range(C["kPtBytes"] // 4))


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_the_score_path_takes_nothing_from_the_chunk(kernel):
    """Every chunk's block takes the same score products in the same order
    and the same p and ds: the chunk (c0, blockIdx.x) reaches only the
    chunk's loads and the output's columns, so every chunk of a row sees
    the same p and ds bit for bit."""
    body = DQ if kernel == "dq" else DKV
    allowed = {"dq": ("bwd_store(dq + rbase * D, acc, row, t.c0, tq, seq, "
                      "D);",),
               "dkv": ("bwd_store((t.wg == 0 ? dv : dk) + (size_t)t.bh * seq "
                       "* D, acc, krow, t.c0, tq, seq, D);",)}[kernel]
    flat = _flat(body)
    for line in allowed:
        assert line in flat, line
        flat = flat.replace(line, "")
    assert "c0" not in flat and "blockIdx.x" not in flat
    for fn in (BOX_FN, SCORES, LOAD_STAGE, DONE_BOX):
        assert "c0" not in fn and "blockIdx" not in fn
    setup = _flat(SETUP)
    for line in ("const int c0 = blockIdx.x * kOutCols;",
                 "min(kOutCols, D - c0) / kBoxCols,"):
        assert line in setup, line
        setup = setup.replace(line, "")
    assert "blockIdx.x" not in setup and setup.count("c0") == 1  # t.c0
