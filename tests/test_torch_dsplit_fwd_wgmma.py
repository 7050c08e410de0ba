"""The two forwards above head dim 256 on wgmma (flash_fwd_ws_kernel, f32,
and flash_fwd_tma_kernel, bf16, of
ray_tpu_torch/ops/csrc/flash_attention_dsplit.cu), known without a card.

Both compute one 256-column chunk of o a block (grid (chunks, Q tiles,
BH)). The f32 one runs the machinery of the f32 dq and dk/dv on wgmma
(tests/test_torch_f32_dsplit_wgmma.py) as a dv block does: a producer
warpgroup splits each 64-column step of q.k^T and each KV tile's rows of
V's chunk, transposed, into shared memory, and the consumer takes 3xTF32
wgmma from there. The bf16 one is two warpgroups of 64 Q rows that take
their operands from TMA: Q resident while D <= 512 and streamed beside K
above, K in 64-column boxes through a ring of stages, V's chunk in one
stage; thread 0 issues the first loads and then the last of the eight
warps done with a stage refills it. With the constants and index
expressions read from the source, numpy models of shared memory, TMA's
128-byte swizzle and wgmma's descriptors check:

1. every output column at head dims 320, 384, 520, 576 and 1024 is stored
   by exactly one block and thread, every row once, lse by chunk 0 only;
2. each kernel's shared memory fits the one block an SM it claims at head
   dims 512 (Q resident in bf16) and 1024 (Q streamed), with every TMA
   destination and wgmma operand 1024-byte aligned and no two regions
   overlapping;
3. the rings, driven by the order of the kernels' barrier and count
   operations under random interleavings of the warps and the copies in
   flight: no wait blocks forever, every wait finds the box or tile it
   expects, and no stage is refilled while a warp still reads it;
4. the score descriptors read, at each k-step, the columns of q and k the
   k-step stands for, and p.v reads the chunk's columns of v;
5. the products are exact on small integers (bf16 through the
   descriptors; 3xTF32 through its split and its order of sums, with
   operands that need the small terms), and the score path takes nothing
   from the chunk, so every chunk of a row computes the same p.
"""
import random
import re

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import flash_attention as tfa
from tests.test_torch_f32_dsplit_wgmma import (C as WS, SRC, _Bar, _const,
                                               _function, _int_expr,
                                               _producer_items,
                                               _scores_order, chunk_writes,
                                               _x_writes, _accumulate_descs,
                                               read_k_major, stage_writes,
                                               step_desc)
from tests.test_torch_wgmma_layout import Smem, sw128_desc, values

MAX_SMEM = 232448  # bytes of shared memory a block may take on an H100
HEAD_DIMS = (320, 384, 520, 576, 1024)

C = dict(WS)
for _name in ("kTmaThreads", "kTmaRows", "kTmaKv", "kBoxCols", "kKBoxBytes",
              "kQBoxBytes", "kQBoxes", "kKStages", "kRingBytes", "kVBytes"):
    C[_name] = _const(_name, C)
ROWS, KV, BOX = C["kTmaRows"], C["kTmaKv"], C["kBoxCols"]
STAGES, COLS = C["kKStages"], C["kOutCols"]
WARPS = C["kTmaThreads"] // 32
FWD = _function("flash_fwd_ws_kernel(const float*")
TMA = _function("flash_fwd_tma_kernel(const __grid_constant__")
KSTAGE_AT = _function("__device__ __forceinline__ uint32_t kstage_at(")
LOAD_K = _function("__device__ __forceinline__ void tma_load_k(")
LOAD_V = _function("__device__ __forceinline__ void tma_load_v(")
LAST_DONE = _function("__device__ __forceinline__ bool tma_last_done(")
DONE_K = _function("__device__ __forceinline__ void tma_done_k(")
DONE_V = _function("__device__ __forceinline__ void tma_done_v(")
ISSUE_BOX = _function("__device__ __forceinline__ void tma_issue_box(")
SCORES = _function("__device__ __forceinline__ void tma_scores(")
PV = _function("__device__ __forceinline__ void tma_pv(")
KERNEL_FN = _function("const void* kernel_fn(int kernel, int* smem")
GRID_OF = _function("dim3 grid_of(int kernel, int bh, int seq, int d, int cols)")


def _flat(text):
    return " ".join(text.split())


def kstage_at(slot, resident, ring=0):
    """kstage_at of the source: the byte offset of K stage `slot`."""
    expr = re.search(r"return ([^;]+);", KSTAGE_AT).group(1)
    a, b = re.match(r"\s*resident\s*\?(.+):(.+)", expr, re.S).groups()
    return _int_expr(a if resident else b, dict(C, ring=ring, slot=slot))


def _padded(D):
    family, Dk = tfa.kernel_plan(torch.float32, D)
    assert family == "f32_dsplit"
    assert tfa.kernel_plan(torch.bfloat16, D) == ("bf16_dsplit", Dk)
    return Dk


def test_the_constants():
    assert {k: C[k] for k in ("kTmaThreads", "kTmaRows", "kTmaKv",
                              "kBoxCols", "kKBoxBytes", "kQBoxBytes",
                              "kQBoxes", "kKStages", "kRingBytes",
                              "kVBytes", "kOutCols")} == {
        "kTmaThreads": 256, "kTmaRows": 128, "kTmaKv": 64, "kBoxCols": 64,
        "kKBoxBytes": 8192, "kQBoxBytes": 16384, "kQBoxes": 8,
        "kKStages": 8, "kRingBytes": 196608, "kVBytes": 32768,
        "kOutCols": 256}
    assert "__launch_bounds__(kTmaThreads, 1)\n    flash_fwd_tma_kernel(" in SRC
    assert "__launch_bounds__(kWsThreads, 1)\n    flash_fwd_ws_kernel(" in SRC
    # the old mma.sync forward and what only it used are gone
    for gone in ("flash_fwd_dsplit_kernel", "kFwdRows", "kFwdStage",
                 "fwd_smem_bytes<", "struct Io<float>"):
        assert gone not in SRC, gone


# ------------------------------------------------ 1. who stores a column
def _owners_f32(Dk):
    """(row, column) -> (chunk, thread) as ws_store stores the f32
    forward's pieces, rows of one 64-row Q tile."""
    for line in ("ws_store(o + base, acc, q0, c0, seq, D);",
                 "const int q0 = tile * kTile, c0 = blockIdx.x * kOutCols;"):
        assert line in FWD, line
    store = _function("__device__ __forceinline__ void ws_store(")
    for line in ("const int row = r0 + wr + g + 8 * ((e >> 1) & 1);",
                 "const int col = c0 + kPieceCols * pc + 8 * (e >> 2) + 2 * t4;",
                 "if (row < seq && col < D)"):
        assert line in store, line
    owners = {}
    piece = C["kPieceCols"]
    for x in range(-(-Dk // COLS)):
        for tid in range(C["kTcThreads"]):
            w, g, t = tid >> 5, (tid & 31) >> 2, tid & 3
            for pc in range(COLS // piece):
                for e in range(0, piece // 2, 2):
                    row = 16 * w + g + 8 * ((e >> 1) & 1)
                    col = x * COLS + piece * pc + 8 * (e >> 2) + 2 * t
                    for cc in (col, col + 1):
                        if col < Dk:
                            assert (row, cc) not in owners
                            owners[(row, cc)] = (x, tid)
    return owners, C["kTile"]


def _owners_bf16(Dk):
    """(row, column) -> (chunk, thread) as flash_fwd_tma_kernel stores o,
    rows of one 128-row Q tile."""
    for line in ("const int c0 = blockIdx.x * kOutCols, bh = blockIdx.z;",
                 "const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;",
                 "const int wg = warp >> 2;",
                 "const int g = lane >> 2, tq = lane & 3;",
                 "const int row = wg_row0 + (warp & 3) * 16 + g;",
                 "const int rr = row + 8 * r;", "if (rr >= seq) continue;",
                 "const int col = c0 + h * kBoxCols;",
                 "if (col >= D) continue;",
                 "out + (size_t)rr * D + col + 8 * j + 2 * tq"):
        assert line in _flat(TMA), line
    owners = {}
    for x in range(-(-Dk // COLS)):
        for tid in range(C["kTmaThreads"]):
            warp, lane = tid >> 5, tid & 31
            row = 64 * (warp >> 2) + 16 * (warp & 3) + (lane >> 2)
            for r in range(2):
                for h in range(COLS // BOX):
                    col0 = x * COLS + h * BOX
                    if col0 >= Dk:
                        continue
                    for j in range(8):
                        for cc in range(2):
                            key = (row + 8 * r, col0 + 8 * j + 2 * (lane & 3)
                                   + cc)
                            assert key not in owners
                            owners[key] = (x, tid)
    return owners, ROWS


@pytest.mark.parametrize("kernel", ["f32", "bf16"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_every_output_column_has_one_owner(kernel, D):
    """grid x = the chunks (D padded to a multiple of 64, over kOutCols,
    rounded up): every (row, column) of a Q tile's rows of o is stored
    once; columns past D are not."""
    Dk = _padded(D)
    assert "*cols = kOutCols;" in KERNEL_FN.split("case 1:")[0]
    assert "return dim3(kernel == 1 ? 2 * chunks : chunks, tiles, bh);" \
        in GRID_OF
    # bf16's forward and dq take 128-row Q tiles, every other kernel 64
    assert "const int rows = std::is_same_v<T, float> || kernel == 1 ? " \
        "kTile : kTmaRows;" in GRID_OF
    owners, rows = (_owners_f32 if kernel == "f32" else _owners_bf16)(Dk)
    assert sorted(owners) == [(r, c) for r in range(rows) for c in range(Dk)]


def test_lse_is_written_by_chunk_0_alone():
    assert "if (blockIdx.x == 0 && t4 == 0 && row < seq)" in FWD
    assert "if (blockIdx.x == 0 && tq == 0)" in TMA
    assert TMA.index("if (rr >= seq) continue;") < TMA.index(
        "if (blockIdx.x == 0 && tq == 0)")


# --------------------------------------------------- 2. shared memory
def _tma_regions(D):
    """{name: (start, end)} of what a bf16 block uses at head dim D, as
    the kernel and its loads lay it out, and whether Q is resident."""
    for line in ("uint8_t* base = align_1024(tma_smem);",
                 "const uint32_t bars = ring + kRingBytes + kVBytes;",
                 "const uint32_t v_full = bars + 8 * kKStages, "
                 "q_full = v_full + 8;",
                 "int* done = reinterpret_cast<int*>(base + kRingBytes + "
                 "kVBytes + 8 * (kKStages + 2));",
                 "n_kv, min(kOutCols, D - c0) / kBoxCols, nb <= kQBoxes,",
                 "tma_load(ring + b * kQBoxBytes, &tm_q, q_full, b * "
                 "kBoxCols, q0, bh);"):
        assert line in _flat(TMA), line
    assert "tma_load(t.ring + kRingBytes + h * kKBoxBytes, t.v, bar," \
        in _flat(LOAD_V)
    nb = D // BOX
    resident = nb <= C["kQBoxes"]
    regions = {}
    if resident:
        for b in range(nb):
            regions[("q", b)] = (b * C["kQBoxBytes"], (b + 1) * C["kQBoxBytes"])
    for s in range(STAGES):
        st = kstage_at(s, resident)
        regions[("k", s)] = (st, st + C["kKBoxBytes"])
        if not resident:
            regions[("q stage", s)] = (st + C["kKBoxBytes"],
                                       st + C["kKBoxBytes"] + C["kQBoxBytes"])
    for h in range(COLS // BOX):
        v = C["kRingBytes"] + h * C["kKBoxBytes"]
        regions[("v", h)] = (v, v + C["kKBoxBytes"])
    bars = C["kRingBytes"] + C["kVBytes"]
    regions["barriers"] = (bars, bars + 8 * (STAGES + 2))
    regions["done"] = (bars + 8 * (STAGES + 2),
                       bars + 8 * (STAGES + 2) + 4 * (STAGES + 1))
    return regions, resident


@pytest.mark.parametrize("D", [512, 1024])
def test_bf16_shared_memory_fits_one_block(D):
    """Q resident at 512, streamed at 1024: the regions in use do not
    overlap, every box a TMA copy writes (and a wgmma reads) starts
    1024-byte aligned, all within tma_fwd_smem_bytes less the alignment
    slack, and one block takes an SM."""
    body = re.search(r"constexpr int tma_fwd_smem_bytes\(\) \{\s*return "
                     r"([^;]+);", SRC).group(1)
    smem = _int_expr(body, C)
    assert smem == 230516 <= MAX_SMEM < 2 * smem
    assert "*smem = tma_fwd_smem_bytes();" in KERNEL_FN
    regions, resident = _tma_regions(D)
    assert resident == (D == 512)
    spans = sorted(regions.values())
    for (a0, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 <= b0
    assert spans[-1][1] <= smem - 1024
    for name, (start, _) in regions.items():
        if name not in ("barriers", "done"):
            assert start % 1024 == 0, name
        else:
            assert start % 8 == 0
    # a streamed stage's Q box is a [128, 64] box, its warpgroups' rows 64
    # rows (8 KB) apart, both aligned
    assert "t.wg * 64 * 128;" in ISSUE_BOX
    assert (64 * 128) % 1024 == 0


def test_f32_forward_lays_shared_memory_out_as_dk_dv():
    """The f32 forward takes the layout of flash_bwd_dkv_ws_kernel (ring,
    transposed chunk, p tile, the chunk's row words, barriers): the
    230,720 bytes tests/test_torch_f32_dsplit_wgmma.py checks."""
    for line in ("align_1024(ws_smem)",
                 "uint32_t* vt = ring + kStages * kStageBytes / 4;",
                 "uint32_t* sp = vt + 2 * kOutCols * kSlabCols;",
                 "float* rows = reinterpret_cast<float*>(sp + 2 * "
                 "kXSplitBytes / 4);",
                 "const uint32_t bars = smem_addr(rows + 2 * kWsRows);",
                 "const uint32_t vt_bars = bars + 16 * kStages;",
                 "ws_init_bars(bars);"):
        assert line in FWD, line
    assert KERNEL_FN.split("case 1:")[0].count("*smem = ws_smem_bytes();") == 1


# ------------------------------------------------------- 3. the rings
def _bf16_ops(nb, n_w, n_kv, resident):
    """One warp's operations on the ring and V's stage, in the order of
    flash_fwd_tma_kernel and tma_scores: ("wait", box) on a K stage's full
    barrier, ("done", box), ("wait v", tile), ("done v", tile), ("wait
    q",)."""
    flat = _flat(TMA)
    order = [flat.index(line) for line in (
        "if (t.resident) mbar_wait(q_full, 0);",
        "tma_scores(sc, t, idx); // tile 0", "wgmma_wait<0>();",
        "tma_done_k(t, idx - 1);",
        "for (int it = 1; it < n_w; ++it) { tma_scores(sc, t, idx); "
        "mbar_wait(v_full, (it - 1) & 1);",
        "wgmma_wait<1>(); // the scores of tile it fence_regs(sc); "
        "tma_done_k(t, idx - 1);",
        "wgmma_wait<0>(); // p.v of tile it - 1 fence_regs(acc); "
        "fence_regs(pa); tma_done_v(t, it - 1);",
        "mbar_wait(v_full, (n_w - 1) & 1);",
        "tma_done_v(t, n_w - 1);",
        "for (; idx < n_kv * nb; ++idx) { mbar_wait(bars + 8 * (idx % "
        "kKStages), (idx / kKStages) & 1); tma_done_k(t, idx); }")]
    assert order == sorted(order)
    scores = _flat(SCORES)
    for line in ("tma_issue_box(sc, t, idx++, 0); for (int b = 1; b < t.nb;"
                 " ++b) { tma_issue_box(sc, t, idx++, b); wgmma_wait<1>(); "
                 "// box b - 1 is read tma_done_k(t, idx - 2); }",):
        assert line in scores, line
    assert "mbar_wait(t.bars + 8 * slot, (idx / kKStages) & 1);" in ISSUE_BOX
    ops = [("wait q",)] if resident else []
    idx = 0
    for it in range(n_w):
        for b in range(nb):
            ops.append(("wait", idx))
            if b > 0:
                ops.append(("done", idx - 1))
            idx += 1
        if it > 0:
            ops.append(("wait v", it - 1))
        ops.append(("done", idx - 1))
        if it > 0:
            ops.append(("done v", it - 1))
    ops += [("wait v", n_w - 1), ("done v", n_w - 1)]
    for i in range(idx, n_kv * nb):
        ops += [("wait", i), ("done", i)]
    return ops


def _run_bf16(nb, n_kv, n_ws, seed):
    """The eight warps (n_ws[w // 4] tiles used by warp w) and the copies
    in flight, interleaved at random. Thread 0's first loads go out before
    any warp starts (the kernel's __syncthreads orders the barriers'
    initialisation; the waits that come first spin until the copies land).
    Fails on a deadlock, a wait that finds another box or tile, or a stage
    refilled while a warp has waited for it and is not done."""
    for line in ("for (int i = 0; i < kKStages && i < nb * n_kv; ++i) "
                 "tma_load_k(t, i); tma_load_v(t, 0);",):
        assert line in _flat(TMA), line
    assert "last = atomicAdd(done + i, 1) % (2 * kTcWarps) == 2 * kTcWarps - 1;" \
        in LAST_DONE
    assert "if (tma_last_done(t.done, idx % kKStages) && idx + kKStages < " \
        "t.nb * t.n_kv) tma_load_k(t, idx + kKStages);" in _flat(DONE_K)
    assert "if (tma_last_done(t.done, kKStages) && j + 1 < t.n_kv) " \
        "tma_load_v(t, j + 1);" in _flat(DONE_V)
    resident = nb <= C["kQBoxes"]
    total = nb * n_kv
    full = {s: _Bar(1) for s in range(STAGES)}
    full["v"], full["q"] = _Bar(1), _Bar(1)
    holds = {}  # stage -> what the last copy into it brought
    done = {s: 0 for s in list(range(STAGES)) + ["v"]}
    readers = {s: set() for s in list(range(STAGES)) + ["v", "q"]}
    flying = []  # copies issued, not landed: (stage, what)

    def issue(stage, what):
        assert not readers[stage], (stage, what, readers[stage])
        flying.append((stage, what))

    if resident:
        issue("q", ("q",))
    for i in range(min(STAGES, total)):
        issue(i % STAGES, ("k", i))
    issue("v", ("v", 0))

    def warp(w):
        n_w = n_ws[w // 4]
        for op in _bf16_ops(nb, n_w, n_kv, resident):
            kind = op[0]
            if kind.startswith("wait"):
                stage, use, want = {
                    "wait": (op[1] % STAGES if kind == "wait" else None,
                             op[1] // STAGES if kind == "wait" else None,
                             ("k", op[1]) if kind == "wait" else None),
                    "wait v": ("v", op[1] if kind == "wait v" else None,
                               ("v", op[1]) if kind == "wait v" else None),
                    "wait q": ("q", 0, ("q",))}[kind]
                while not full[stage].done(use & 1):
                    yield False
                assert holds[stage] == want, (w, op, holds[stage])
                if stage != "q":
                    readers[stage].add(w)
                yield True
            else:
                stage = op[1] % STAGES if kind == "done" else "v"
                readers[stage].discard(w)
                done[stage] += 1
                if done[stage] % WARPS == 0:  # the last of the eight
                    if kind == "done" and op[1] + STAGES < total:
                        issue(stage, ("k", op[1] + STAGES))
                    if kind == "done v" and op[1] + 1 < n_kv:
                        issue("v", ("v", op[1] + 1))
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
        assert blocked < 2000, f"deadlock: nb {nb}, {n_kv} tiles, {n_ws}"
    return done


@pytest.mark.parametrize("nb,n_kv,n_ws", [
    (5, 1, (1, 1)), (5, 3, (3, 3)), (8, 2, (1, 2)), (8, 4, (4, 4)),
    (9, 2, (1, 2)), (9, 3, (3, 3)), (16, 2, (1, 2)), (16, 3, (3, 3)),
    (6, 5, (4, 5))])
def test_bf16_ring_never_deadlocks_or_refills_a_held_stage(nb, n_kv, n_ws):
    """Q resident (nb <= 8) and streamed (9, 16), under causal masking
    (warpgroup 0 skips the last tile) and not."""
    for seed in range(6):
        _run_bf16(nb, n_kv, n_ws, seed)


def test_bf16_warpgroups_use_the_tiles_of_their_rows():
    """n_w: every tile for a non-causal block; under causal masking the
    tiles up to the warpgroup's last row, so warpgroup 0 of a 128-row tile
    skips at most the last 64-row tile."""
    assert "const int n_w = causal ? (min(wg_row0 + 64, seq) + kTmaKv - 1) " \
        "/ kTmaKv : n_kv;" in _flat(TMA)
    assert "const int n_kv = ((causal ? min(q0 + kTmaRows, seq) : seq) + " \
        "kTmaKv - 1) / kTmaKv;" in _flat(TMA)
    for seq in (129, 200, 1000, 1024):
        for q0 in range(0, seq, ROWS):
            n_kv = (min(q0 + ROWS, seq) + KV - 1) // KV
            for wg in (0, 1):
                n_w = (min(q0 + 64 * wg + 64, seq) + KV - 1) // KV
                assert n_kv - 1 <= n_w <= n_kv and n_w >= 1


def _run_f32(n, n_tiles, seed):
    """The f32 forward's producer (ws_produce with phases 1: each tile's n
    steps, then its chunk) and consumer (ws_scores over the tile's steps,
    the chunk waited for and released), interleaved at random."""
    for line in ("const WsJob job{q + base, k + base, nullptr, nullptr, "
                 "v + base, nullptr, nullptr, 1, q0, 0, n_tiles, n, c0, seq, "
                 "D};",
                 "ws_scores(s, ring_at, bars, n * j, n);",
                 "mbar_wait(vt_bars, j & 1);", "release_stage(vt_bars);",
                 "ws_produce(job, ring, vt, rows, bars);"):
        assert line in _flat(FWD), line
    order = [FWD.index(x) for x in ("ws_scores(s, ring_at, bars, n * j, n);",
                                    "mbar_wait(vt_bars, j & 1);",
                                    "release_stage(vt_bars);")]
    assert order == sorted(order)
    stages = WS["kStages"]
    bufs = [f"s{i}" for i in range(stages)] + ["chunk"]
    full = {b: _Bar(WS["kTcThreads"]) for b in bufs}
    empty = {b: _Bar(WS["kTcWarps"]) for b in bufs}
    holds, held = {b: None for b in bufs}, {b: False for b in bufs}

    def producer():
        for kind, x in _producer_items(n, n_tiles, 1):
            buf = "chunk" if kind == "chunk" else f"s{x % stages}"
            use = x if kind == "chunk" else x // stages
            while not empty[buf].done((use & 1) ^ 1):
                yield False
            assert not held[buf], (buf, kind, x)
            holds[buf] = (kind, x)
            full[buf].arrive(WS["kTcThreads"])
            yield True

    def consumer():
        for j in range(n_tiles):
            for kind, step in _scores_order(n):
                at = n * j + step
                buf = f"s{at % stages}"
                if kind == "wait":
                    while not full[buf].done((at // stages) & 1):
                        yield False
                    assert holds[buf] == ("stage", at)
                    held[buf] = True
                else:
                    held[buf] = False
                    empty[buf].arrive(WS["kTcWarps"])
                yield True
            while not full["chunk"].done(j & 1):
                yield False
            assert holds["chunk"] == ("chunk", j)
            held["chunk"] = True
            yield True
            held["chunk"] = False
            empty["chunk"].arrive(WS["kTcWarps"])
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


@pytest.mark.parametrize("n,n_tiles", [(5, 1), (5, 3), (8, 4), (16, 2),
                                       (1, 3)])
def test_f32_ring_never_deadlocks_or_refills_a_held_buffer(n, n_tiles):
    for seed in range(6):
        _run_f32(n, n_tiles, seed)


# ------------------------------------------------ 4. the descriptors
def _issue_box_descs(ring, idx, b, wg, resident):
    """The Q and K descriptors tma_issue_box gives box b (ring index idx)
    of warpgroup wg, k-step 0; a k-step is +2 (32 bytes)."""
    flat = _flat(ISSUE_BOX)
    for line in ("const int slot = idx % kKStages;",
                 "const uint32_t st = opaque(kstage_at(t.ring, slot, "
                 "t.resident));",
                 "const uint32_t qa = (t.resident ? opaque(t.ring) + b * "
                 "kQBoxBytes : st + kKBoxBytes) + t.wg * 64 * 128;",
                 "const uint64_t dq = sw128_desc(qa), dk = sw128_desc(st);",
                 "for (int kk = 0; kk < kBoxCols / 16; ++kk) "
                 "wgmma_bf16_ss(sc, dq + 2 * kk, dk + 2 * kk, b | kk);"):
        assert line in flat, line
    st = kstage_at(idx % STAGES, resident, ring)
    qa = (ring + b * C["kQBoxBytes"] if resident else st + C["kKBoxBytes"]) \
        + wg * 64 * 128
    return sw128_desc(qa), sw128_desc(st)


def _box(smem, base, name, x, col0):
    """A TMA box [rows, 64] of x's columns col0.. at base, in the 128-byte
    swizzle, each element named (name, row, column of x)."""
    box = Smem()
    box.tma_tile(base, name, x[:, col0:col0 + BOX])
    for a, (n, r, c, v) in box.at.items():
        assert a not in smem.at
        smem.at[a] = (n, r, c + col0, v)


@pytest.mark.parametrize("D", [320, 512, 576])
def test_bf16_scores_read_their_columns_and_are_exact(D):
    """One KV tile's s = q.k^T of each warpgroup, box by box through the
    ring (Q resident at 320 and 512, streamed in the stages at 576), as
    TMA writes the boxes (tma_load_k, the resident Q loads) and the
    descriptors read them: k-step kk of box b reads columns 64 b + 16 kk
    to + 15 of the warpgroup's Q rows and of K, and s is exact."""
    k_col = re.search(r"tma_load\(st, t\.k, bar, ([^,]+), j \* kTmaKv, "
                      r"t\.bh\);", LOAD_K).group(1)
    q_col = re.search(r"tma_load\(st \+ kKBoxBytes, t\.q, bar, ([^,]+), "
                      r"t\.q0, t\.bh\);", _flat(LOAD_K)).group(1)
    res_col = re.search(r"tma_load\(ring \+ b \* kQBoxBytes, &tm_q, q_full, "
                        r"([^,]+), q0, bh\);", _flat(TMA)).group(1)
    rng = np.random.default_rng(D)
    nb = D // BOX
    resident = nb <= C["kQBoxes"]
    q = rng.integers(-8, 9, (ROWS, D))
    k = rng.integers(-8, 9, (KV, D))
    ring = 0
    s = {0: np.zeros((64, KV), np.int64), 1: np.zeros((64, KV), np.int64)}
    first = 3 * nb  # the tile's first box sits in the ring's middle
    q = np.pad(q, ((0, 0), (0, BOX)))  # a column past D reads zeros
    k = np.pad(k, ((0, 0), (0, BOX)))

    def col(expr, b):
        return _int_expr(expr, dict(C, b=b))

    resident_q = Smem()
    if resident:
        for b in range(nb):
            _box(resident_q, ring + b * C["kQBoxBytes"], "q", q,
                 col(res_col, b))
    for b in range(nb):
        idx = first + b
        smem = Smem()
        smem.at = dict(resident_q.at)
        st = kstage_at(idx % STAGES, resident, ring)
        _box(smem, st, "k", k, col(k_col, b))
        if not resident:
            _box(smem, st + C["kKBoxBytes"], "q", q, col(q_col, b))
        for wg in (0, 1):
            dq, dk = _issue_box_descs(ring, idx, b, wg, resident)
            for kk in range(BOX // 16):
                a = smem.read_k_major(dq + 2 * kk, 64)
                bt = smem.read_k_major(dk + 2 * kk, KV)
                cols = list(range(BOX * b + 16 * kk, BOX * b + 16 * kk + 16))
                assert [[(c[0], c[1], c[2]) for c in row] for row in a] == [
                    [("q", 64 * wg + m, c) for c in cols] for m in range(64)]
                assert [[(c[0], c[1], c[2]) for c in row] for row in bt] == [
                    [("k", m, c) for c in cols] for m in range(KV)]
                s[wg] += values(a) @ values(bt).T
    for wg in (0, 1):
        np.testing.assert_array_equal(
            s[wg], q[64 * wg:64 * wg + 64, :D] @ k[:, :D].T)


@pytest.mark.parametrize("D,chunk", [(320, 0), (320, 1), (512, 1),
                                     (1024, 3)])
def test_bf16_pv_reads_the_chunk_of_v_and_is_exact(D, chunk):
    """o[:, chunk] += p.v of a tile: V's stage holds the chunk's boxes that
    lie below D (tma_load_v), box h at kRingBytes + h * kKBoxBytes; k-step
    kk of box h reads V rows 16 kk to + 15, columns c0 + 64 h on, and the
    product is exact; boxes past D are neither loaded nor stored."""
    flat = _flat(PV)
    assert "wgmma_bf16_rs(acc[h], pa[kk], sw128_desc(opaque(sv) + h * " \
        "kKBoxBytes) + kk * 128);" in flat
    assert "tma_pv(acc, pa, ring + kRingBytes);" in _flat(TMA)
    load = re.search(r"tma_load\(t\.ring \+ kRingBytes \+ h \* kKBoxBytes, "
                     r"t\.v, bar, ([^,]+), j \* kTmaKv, t\.bh\);",
                     _flat(LOAD_V))
    rng = np.random.default_rng(chunk)
    v = rng.integers(-8, 9, (KV, D + BOX))  # columns past D: another head's
    p = rng.integers(-8, 9, (64, KV))
    c0 = chunk * COLS
    v_boxes = min(COLS, D - c0) // BOX
    sv = C["kRingBytes"]
    smem = Smem()
    for h in range(v_boxes):
        col = _int_expr(load.group(1).replace("t.c0", "c0"),
                        dict(C, c0=c0, h=h))
        _box(smem, sv + h * C["kKBoxBytes"], "v", v, col)
    o = np.zeros((64, v_boxes * BOX), np.int64)
    for kk in range(KV // 16):
        for h in range(v_boxes):
            b = smem.read_mn_major(sw128_desc(sv + h * C["kKBoxBytes"]) +
                                   kk * 128, BOX)
            assert {(c[1], c[2]) for row in b for c in row} == {
                (r, c) for r in range(16 * kk, 16 * kk + 16)
                for c in range(c0 + h * BOX, c0 + h * BOX + BOX)}
            o[:, h * BOX:(h + 1) * BOX] += p[:, 16 * kk:16 * kk + 16] @ \
                values(b)
    np.testing.assert_array_equal(o, p @ v[:, c0:c0 + v_boxes * BOX])


def test_f32_forward_takes_the_wgmma_machinery_as_a_dv_block():
    """s = q.k^T from the ring's steps (own Q, other K; the descriptors of
    tests/test_torch_f32_dsplit_wgmma.py), p written split as a [64,
    kWsRows] tile, o += p.v from V's chunk transposed (the transposed
    chunk's layout), the chunk from c0 = blockIdx.x * kOutCols."""
    for line in ("store_x<kWsRows>(sp, s);",
                 "ws_accumulate(acc[pc], sp_at, opaque(vt_at) + pc * "
                 "kPieceCols * 128, kOutCols * 128);",
                 "const int q0 = tile * kTile, c0 = blockIdx.x * kOutCols;"):
        assert line in _flat(FWD), line
    # the producer's chunk item loads rows o0.. of its job's chunk (V)
    # from column c0: load_chunk_t(t, job.chunk, o0, job.c0, ...)
    assert "load_chunk_t(t, job.chunk, o0, job.c0, job.seq, job.D, i);" \
        in SRC


def test_f32_forward_products_are_exact_through_the_descriptors():
    """s over one step (the step descriptors) and o[:, piece] += p.v (the p
    tile and the transposed chunk's descriptors), as the forward issues
    them, on small integers."""
    rows, piece = WS["kWsRows"], WS["kPieceCols"]
    rng = np.random.default_rng(5)
    q = rng.integers(-8, 9, (WS["kTile"], 64))
    k = rng.integers(-8, 9, (rows, 64))
    words, _ = stage_writes()
    at = {4 * w: cell for w, cell in words.items()}
    s = np.zeros((WS["kTile"], rows), np.int64)
    b_off = 2 * WS["kOwnHalfBytes"]
    for kk in range(8):
        a_cells = read_k_major(at, step_desc(0, kk, WS["kTile"]), WS["kTile"])
        b_cells = read_k_major(at, step_desc(b_off, kk, rows), rows)
        a = np.array([[q[r, c] for _, _, r, c in row] for row in a_cells])
        b = np.array([[k[r, c] for _, _, r, c in row] for row in b_cells])
        s += a @ b.T
    np.testing.assert_array_equal(s, q @ k.T)
    p = rng.integers(-8, 9, (WS["kTile"], rows))
    v = rng.integers(-8, 9, (rows, COLS))
    mem = {4 * w: ("x",) + cell for w, cell in _x_writes().items()}
    x0 = 1 << 17
    mem.update({x0 + 4 * w: c for w, c in chunk_writes().items()})
    o = np.zeros((WS["kTile"], COLS), np.int64)
    for pc in range(COLS // piece):
        for ks in range(rows // 8):
            xb, _, tb, _ = _accumulate_descs(ks, 0, x0 + pc * piece * 128,
                                             COLS * 128)
            a = np.array([[p[m, c] for _, m, c in row]
                          for row in read_k_major(mem, xb, WS["kTile"])])
            b = np.array([[v[r, c] for _, r, c in row]
                          for row in read_k_major(mem, tb, piece)])
            o[:, piece * pc:piece * pc + piece] += a @ b.T
    np.testing.assert_array_equal(o, p @ v)


# ------------------------------------------- 5. one order, one p
def _tf32_rna(x):
    """tf32_rna of tf32_mma.cuh: (bits + 0x1000) & 0xffffe000."""
    body = _function("__device__ __forceinline__ uint32_t tf32_rna(float x)")
    assert "return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;" in body
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(
        np.float32)


def test_3xtf32_scores_in_the_kernels_order_are_exact():
    """ws_scores' order: per 64-column step big.big from 0 into a part
    added to s in f32, the small terms (big.small, small.big) chained over
    all steps and added last. On q of small integers and k of small
    integers plus multiples of 2^-12 (not tf32: its small half carries
    them), every product and sum is exact in f32, so the emulation of that
    order equals q.k^T; without the small terms it does not."""
    scores = _flat(_function("__device__ __forceinline__ void ws_scores("))
    for line in ("wgmma_ss_tf32_n32(part, ab, bb, kk);",
                 "wgmma_ss_tf32_n32(small, ab, bs, step | kk);",
                 "wgmma_ss_tf32_n32(small, as, bb, 1);",
                 "for (int e = 0; e < 16; ++e) s[e] += part[e];",
                 "for (int e = 0; e < 16; ++e) s[e] += small[e];"):
        assert line in scores, line
    rng = np.random.default_rng(7)
    n_steps = 8  # D 512
    q = rng.integers(-4, 5, (64, 64 * n_steps)).astype(np.float32)
    k = (rng.integers(-4, 5, (32, 64 * n_steps)) +
         rng.integers(-3, 4, (32, 64 * n_steps)) * 2.0 ** -12).astype(
        np.float32)

    def split(x):
        big = _tf32_rna(x)
        return big, (x - big).astype(np.float32)

    qb, qs = split(q)
    kb, ks = split(k)
    assert np.all(qs == 0) and np.any(ks != 0)
    s = np.zeros((64, 32), np.float32)
    small = np.zeros((64, 32), np.float32)
    for step in range(n_steps):
        cols = slice(64 * step, 64 * step + 64)
        part = (qb[:, cols] @ kb[:, cols].T).astype(np.float32)
        s = (s + part).astype(np.float32)
        small = (small + qb[:, cols] @ ks[:, cols].T +
                 qs[:, cols] @ kb[:, cols].T).astype(np.float32)
    s = (s + small).astype(np.float32)
    exact = q.astype(np.float64) @ k.astype(np.float64).T
    np.testing.assert_array_equal(s.astype(np.float64), exact)
    assert not np.array_equal((qb @ kb.T).astype(np.float64), exact)


@pytest.mark.parametrize("kernel", ["f32", "bf16"])
def test_the_score_path_takes_nothing_from_the_chunk(kernel):
    """Every chunk's block takes the same score product in the same order
    and the same softmax steps: the chunk (c0, blockIdx.x) reaches only
    V's loads, the output's columns and the lse guard, so every chunk of
    a row sees the same p bit for bit."""
    if kernel == "f32":
        body = FWD
        allowed = ("const int q0 = tile * kTile, c0 = blockIdx.x * kOutCols;",
                   "v + base, nullptr, nullptr, 1, q0, 0, n_tiles, n, c0, "
                   "seq, D};",
                   "if (blockIdx.x == 0 && t4 == 0 && row < seq)",
                   "ws_store(o + base, acc, q0, c0, seq, D);")
        helpers = ("__device__ __forceinline__ void ws_scores(",)
    else:
        body = TMA
        allowed = ("const int c0 = blockIdx.x * kOutCols, bh = blockIdx.z;",
                   "const TmaBlock t{&tm_q, &tm_k, &tm_v, ring, bars, done, "
                   "q0, c0, bh, nb, n_kv, min(kOutCols, D - c0) / kBoxCols, "
                   "nb <= kQBoxes, wg};",
                   "if (blockIdx.x == 0 && tq == 0)",
                   "const int col = c0 + h * kBoxCols;")
        helpers = ("__device__ __forceinline__ void tma_scores(",
                   "__device__ __forceinline__ void tma_issue_box(",
                   "__device__ __forceinline__ void tma_softmax(",
                   "__device__ __forceinline__ void tma_load_k(")
    flat = _flat(body)
    for line in allowed:
        assert line in flat, line
        flat = flat.replace(line, "")
    assert "c0" not in flat and "blockIdx.x" not in flat
    for h in helpers:
        fn = _function(h)
        assert "c0" not in fn and "blockIdx" not in fn, h
