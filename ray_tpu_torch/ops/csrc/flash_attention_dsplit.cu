// Flash attention for Hopper (sm_90a) at head dims above 256: forward, dq
// and dk/dv, each block computing one chunk of its output's head dim, in
// bf16 and in f32.
//
// They compute what the Pallas TPU kernels of ray_tpu/ops/flash_attention.py
// compute, at any head dim:
//   flash_fwd_tma_kernel (bf16),     <- _fwd_kernel     (flash_attention.py:29)
//   flash_fwd_ws_kernel (f32)
//   flash_bwd_dq_tma_kernel (bf16),  <- _bwd_dq_kernel  (flash_attention.py:160)
//   flash_bwd_dq_ws_kernel (f32)
//   flash_bwd_dkv_tma_kernel (bf16), <- _bwd_dkv_kernel (flash_attention.py:212)
//   flash_bwd_dkv_ws_kernel (f32)
// The *_ws kernels are f32's forward, dq and dk/dv on 3xTF32 wgmma, the
// *_tma kernels bf16's on bf16 wgmma fed by TMA (each further down, with
// its own notes). Sums, the softmax and lse are f32; o, dq, dk and dv are
// written in the inputs' type. In bf16, p (forward and dv) and ds (dq and
// dk) are rounded to bf16 before the products that take them, as the bf16
// Pallas kernels cast them (flash_attention.py:196-199).
//
// Layout: q, k, v, o, do, dq, dk, dv are [BH, S, D], contiguous and
// 16-byte aligned, D a multiple of 64 (the wrapper pads any other head dim
// with zero columns, which add nothing to q.k^T or do.v^T); lse and delta
// are [BH, S] f32. A ragged S is masked at the tile edges as in
// flash_attention_f32.cu.
//
// Why the head dim is split: the other kernels keep a [rows, D] f32
// accumulator in registers, which at D 320 would take 160 registers a
// thread for one 64-row tile of 4 warps, and no limit on D would hold. Here
// a block owns a tile of its own axis (Q rows for the forward and dq, KV
// rows for dk/dv) and one 256-column chunk of the output's columns, so its
// accumulators do not grow with D. The scores still contract over the
// whole head dim, so a block streams q and k (and do and v) through shared
// memory in 64-column steps, summing each step's product into s, and only
// then takes the softmax, the mask and the accumulating product with its
// own chunk's columns. Every chunk's block computes s in the same order,
// so the chunks of a row see the same p bit for bit, and lse is written by
// chunk 0's block only. The price is that the scores are computed once for
// each chunk: the forward does (D / 256 + 1) products of a tile pair where
// one block with the whole row would do 2, dq 2 D / 256 + 1 for 3, dk/dv
// 2 + 2 D / 256 for 4 in one block (bf16) or 8 in a dv block and a dk
// block (f32) (at D 512: 3 / 2, 5 / 3, 6 / 4 and 8 / 4). A last chunk past
// D is computed on zero columns and not stored.
//
// What bounds them on an H100: at B*H 24, S 1024, D 512, causal the
// forward's two products are 25.8 GFLOP (bf16: 0.026 ms at 989 TFLOP/s;
// f32: 0.156 ms at 3xTF32's 165) against 101 MB of traffic in bf16 (0.030
// ms), so the bf16 forward is bound by bytes and the rest by operations
// (bf16 dq 0.0391 ms, dk/dv 0.0522; f32 0.2345 and 0.3127); the recomputed
// scores above are work the bound does not count. What holds the kernels
// from it is their loads: a block reads the other axis' tiles over all of
// D once for each chunk and each tile of its own axis. The f32 wgmma
// kernels split each operand once for each use and take every product
// from shared memory; what bounds them on the card is their producer's
// loads (their note). The bf16 ones load by TMA: the forward keeps its Q
// tile resident while D <= 512, dq and dk/dv stream every operand through
// a deeper ring (their notes).
//
// The host entry points return cudaGetLastError() right after the launch,
// -3 for a head dim that is not a positive multiple of 64, and for bf16
// -1 if the CUDA driver has no cuTensorMapEncodeTiled, -2 if it refuses a
// tensor map.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"
#include "wgmma_tf32.cuh"

namespace {

// head-dim columns of a step of the scores
constexpr int kChunk = 64;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ----------------------------------- f32 forward, dq and dk/dv on wgmma
//
// flash_bwd_dq_ws_kernel and flash_bwd_dkv_ws_kernel: the f32 backward
// above head dim 256 (and float16's, on f32 copies); flash_fwd_ws_kernel,
// the forward, runs the same machinery as a dv block does (its note). A
// block is two
// warpgroups, as in flash_attention_f32.cu's head-dim-256 kernels:
// warpgroup 0, the consumer, owns a 64-row tile of its own axis (Q for dq,
// KV for dk/dv) and one 256-column chunk of one output, and issues every
// product as 3xTF32 wgmma with both operands split in shared memory;
// warpgroup 1, the producer, reads the operands from device memory and
// writes them split into big and small where the consumer's descriptors
// read them, so no element is split twice for one use. Per tile of
// kWsRows rows of the other axis the consumer takes the score products
// over all of D in 64-column steps, each step a stage of a ring (the
// block's own 64 rows and the tile's kWsRows rows of one step, split),
// then p and ds in registers, writes them split as a [64, kWsRows] tile,
// and adds its product with the tile's rows of the chunk, which the
// producer writes transposed ([256 columns, kWsRows], K-major for wgmma,
// whose tf32 operands have no transpose bit).
//
//   dq:  dp = do.v^T (own dO, other V), then s = q.k^T, p from lse,
//        ds = p (dp - delta) scale, dq[:, chunk] += ds.k[:, chunk].
//   dv:  s^T = k.q^T (own K, other Q), p^T from lse, dv[:, chunk] +=
//        p^T.do[:, chunk].
//   dk:  s^T and p^T as dv's, then dp^T = v.do^T, ds^T = p^T (dp^T -
//        delta) scale, dk[:, chunk] += ds^T.q[:, chunk].
// dk/dv's grid has a dv block and a dk block for each chunk, side by side.
//
// Why these widths: the scores are computed once for each chunk of the
// output, so a chunk as wide as the registers allow cuts the recompute
// that 64-column chunks took. A consumer thread holds its 64 x
// 256 output (128 registers) and, while it takes a score product, the
// sum, the small terms' chain and the step's part of a 64 x kWsRows tile
// (16 registers each at kWsRows 32; 64 rows would take 96 and did not
// fit). At D 512 dq does (2 D / 256 + 1) / 3 = 1.67x the products of a
// whole-row kernel, against 5.7x at 64 columns; dk/dv (dv 1 product + its
// accumulation, dk 2 + its) 2 (1.5 + 2.5) / 4 = 2x, against 4.5x, and 25%
// fewer of the producer's loads than one block with dk and dv of 128
// columns each (3.19 against 3.86 ms on the card). A last chunk past D is
// computed on zero columns and not stored.
//
// What bounds them: the producer. It reads the block's own 64 rows again
// for every kWsRows rows of the other axis (two thirds of its loads), and
// on the card its loads, not the tensor cores or shared memory, set the
// pace: without them (zeros written instead) dq ran 1.45 and dk/dv 2.65
// ms, with them the consumer waits on full stages most of its time
// (PERF.md). Loads that skip L1, deeper register prefetch, L2 bulk
// prefetch and a 2-block cluster that wrote each stage into both blocks
// through distributed shared memory all ran no faster or slower; the own
// tile's loads with L2's evict-last priority, and a grid with the chunks
// fastest, so that a tile's chunks read the same steps at once, ran 9% and
// 10-18% faster.
//
// Order of the sums: every step's big.big product goes from 0 into a
// part of its own and is added to the score in f32 when the step is done;
// the small terms (big.small, small.big) chain across all steps and are
// added last. The accumulating products go from 0 into a temporary,
// big.big and then the small terms, each added to the output in f32.
// Every chunk's block computes the scores in this one order with the same
// instructions, so every chunk sees the same p bit for bit.
//
// The ring: a stage's full barrier counts the producer's 128 threads (each
// writes, fences for the async proxy, arrives), its empty one the
// consumer's 4 warps (each arrives once its wgmmas that read the stage are
// done). The transposed chunk has a single buffer with barriers of its
// own. The producer runs one item ahead in registers (an item is a stage
// or a transposed chunk; it loads item k + 1 before it waits to store item
// k), in the consumer's order: the first product's steps, the chunk with
// the tile's lse and delta (dk/dv), the second product's steps. Shared
// memory, both kernels: 1024 (alignment) + 3 stages of 48 KB + the chunk
// 64 KB + the p or ds tile 16 KB + lse and delta 256 + 8 barriers =
// 230,720 bytes: one block an SM.

constexpr int kWsThreads = 2 * kTcThreads;  // consumer, then producer
constexpr int kWsRows = 32;                 // rows of the other axis a tile
constexpr int kOutCols = 256;               // output columns a block takes
// A split step ([rows, 64 columns]) takes two slabs of [rows, 128 bytes] a
// half (step_at); a stage is the block's own 64 rows, big then small, then
// the other axis' kWsRows rows, big then small.
constexpr int kOwnHalfBytes = kTile * kChunk * 4;
constexpr int kOtherHalfBytes = kWsRows * kChunk * 4;
constexpr int kStageBytes = 2 * kOwnHalfBytes + 2 * kOtherHalfBytes;
constexpr int kStages = 3;
// Output columns of one accumulating product (its wgmma's N, m64n32k8):
// 64-column pieces spilled at the cap of 255 registers, 16-column ones ran
// 5% slower.
constexpr int kPieceCols = 32;

// Both kernels: the ring, the transposed chunk (big, small), the p or ds
// tile (big, small), the tile's lse and delta, the barriers.
constexpr int ws_smem_bytes() {
  return 1024 + kStages * kStageBytes + 2 * kOutCols * 128 +
         2 * kXSplitBytes + 2 * kWsRows * 4 + 2 * (kStages + 1) * 8;
}

// Word of element (r, c) of one half of a split step of kRows rows: slab
// c / 32, then x_at's row of 128 bytes (the 128-byte swizzle).
template <int kRows>
__device__ __forceinline__ int step_at(int r, int c) {
  return (c >> 5) * kRows * kSlabCols + x_at(r, c & 31);
}

// The descriptor of k-step kk (8 columns) of a split step half of kRows
// rows at shared address a.
template <int kRows>
__device__ __forceinline__ uint64_t step_desc(uint32_t a, int kk) {
  return sw128_desc(a + (kk >> 2) * kRows * 128 + (kk & 3) * 32);
}

// The producer's registers of one item.
struct WsRaw {
  float4 x[16];
  float row;  // dk/dv: the lse or delta value this thread loads
};

__device__ __forceinline__ float4 ldg4(const float* p, bool valid) {
  return valid ? __ldg(reinterpret_cast<const float4*>(p))
               : make_float4(0.f, 0.f, 0.f, 0.f);
}

// L2's evict-last priority as a cache-policy operand (CUTLASS's
// CacheHintSm90::EVICT_LAST): the block's own tile, read again for every
// tile of the other axis, stays in L2 while the streamed tiles pass (dq
// 9% faster on the card).
constexpr uint64_t kEvictLast = 0x14F0000000000000ull;

__device__ __forceinline__ float4 ldg4h(const float* p, bool valid,
                                        uint64_t policy) {
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid)
    asm volatile(
        "ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
        : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
        : "l"(p), "l"(policy));
  return r;
}

// Producer thread i's share of a stage: rows own0 + i / 16 + 8 u of own (u
// < 8) and o0 + i / 16 + 8 u of other (u < 4), columns 64 c + 4 (i % 16)
// to + 3 (a half warp reads a row's 256 bytes); rows past seq as zeros.
__device__ __forceinline__ void load_stage(WsRaw& t, const float* own,
                                           int own0, const float* other,
                                           int o0, int c, int seq, int D,
                                           int i) {
  const int r = i >> 4, col = c * kChunk + 4 * (i & 15);
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int row = own0 + r + 8 * u;
    t.x[u] = ldg4h(own + (size_t)row * D + col, row < seq, kEvictLast);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int row = o0 + r + 8 * u;
    t.x[8 + u] = ldg4(other + (size_t)row * D + col, row < seq);
  }
}

__device__ __forceinline__ void store_split4(uint32_t* big, uint32_t* small,
                                             float4 v) {
  const float x[4] = {v.x, v.y, v.z, v.w};
  const Tf32<4> f = split(x);
  *reinterpret_cast<uint4*>(big) =
      make_uint4(f.big[0], f.big[1], f.big[2], f.big[3]);
  *reinterpret_cast<uint4*>(small) =
      make_uint4(f.small[0], f.small[1], f.small[2], f.small[3]);
}

// Writes the share split into the stage at st: four columns a 16-byte
// chunk, the eight lanes of a quarter warp on eight chunks of one row.
__device__ __forceinline__ void store_stage(uint32_t* st, const WsRaw& t,
                                            int i) {
  const int r = i >> 4, col = 4 * (i & 15);
  uint32_t* other = st + 2 * kOwnHalfBytes / 4;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int at = step_at<kTile>(r + 8 * u, col);
    store_split4(st + at, st + kOwnHalfBytes / 4 + at, t.x[u]);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int at = step_at<kWsRows>(r + 8 * u, col);
    store_split4(other + at, other + kOtherHalfBytes / 4 + at, t.x[8 + u]);
  }
}

// Producer thread i's share of a chunk to transpose: row r0 + i % 32 of
// src, columns c0 + 8 (i / 32 + 4 u) to + 7 (u < kOutCols / 32) into x[2
// u] and x[2 u + 1]; rows past seq and columns past D as zeros.
__device__ __forceinline__ void load_chunk_t(WsRaw& t, const float* src,
                                             int r0, int c0, int seq, int D,
                                             int i) {
  const int row = r0 + (i & 31);
#pragma unroll
  for (int u = 0; u < kOutCols / 32; ++u) {
    const int col = c0 + 8 * ((i >> 5) + 4 * u);
    const bool valid = row < seq && col < D;
    const float* p = src + (size_t)row * D + col;
    t.x[2 * u] = ldg4(p, valid);
    t.x[2 * u + 1] = ldg4(p + 4, valid);
  }
}

// Writes the share split and transposed into a [kOutCols, kWsRows] tile at
// big (small kOutCols * kSlabCols words on): element (row r, column c) at
// x_at(c, r), so a warp's 32 rows fill one 128-byte row, one bank each.
__device__ __forceinline__ void store_chunk_t(uint32_t* big, const WsRaw& t,
                                              int i) {
  const int r = i & 31;
  uint32_t* small = big + kOutCols * kSlabCols;
#pragma unroll
  for (int u = 0; u < kOutCols / 32; ++u) {
    const int c = 8 * ((i >> 5) + 4 * u);
    const float4 a = t.x[2 * u], b = t.x[2 * u + 1];
    const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    const Tf32<8> f = split(x);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int w = x_at(c + e, r);
      big[w] = f.big[e];
      small[w] = f.small[e];
    }
  }
}

// What a block's producer streams: a head's [seq, D] matrices (the first
// and the second score product's own and other operands; the matrix whose
// chunk goes transposed: dq K, dv dO, dk Q), the [seq] lse and delta that
// go beside the chunk (dv lse, dk both, dq neither: null), and the tiles:
// how many score products (phases: dv 1, dq and dk 2), the own tile's
// first row, the other axis' first row and tiles, the steps, the chunk's
// first column.
struct WsJob {
  const float *own1, *other1, *own2, *other2, *chunk, *lse, *delta;
  int phases, own0, o_begin, n_tiles, n_steps, c0, seq, D;
};

// Warpgroup 1. Items in the consumer's order, for each tile j of the other
// axis: the first product's n steps, the transposed chunk with its rows'
// lse and delta, the second product's n steps. Stage idx of the ring goes
// into slot idx % kStages (full barrier at bars + 16 slot, empty one 8 on);
// the chunk into its own buffer (barriers at bars + 16 kStages). Item k +
// 1 loads into registers before item k waits for its buffer (two items
// ahead ran no faster).
__device__ __forceinline__ void ws_produce(const WsJob& job, uint32_t* ring,
                                           uint32_t* chunk, float* rows,
                                           uint32_t bars) {
  const int i = threadIdx.x - kTcThreads;
  const int n = job.n_steps, per = job.phases * n + 1;
  const int total = job.n_tiles * per;
  auto load = [&](WsRaw& t, int k) {
    const int j = k / per, s = k - j * per;
    const int o0 = job.o_begin + j * kWsRows;
    if (s == n) {
      load_chunk_t(t, job.chunk, o0, job.c0, job.seq, job.D, i);
      const float* r = i < kWsRows ? job.lse : job.delta;
      const int row = o0 + (i & 31);
      t.row = i < 2 * kWsRows && r != nullptr && row < job.seq
                  ? __ldg(r + row)
                  : 0.f;
    } else if (s < n) {
      load_stage(t, job.own1, job.own0, job.other1, o0, s, job.seq, job.D, i);
    } else {
      load_stage(t, job.own2, job.own0, job.other2, o0, s - n - 1, job.seq,
                 job.D, i);
    }
  };
  auto store = [&](const WsRaw& t, int k) {
    const int j = k / per, s = k - j * per;
    if (s == n) {
      const uint32_t cb = bars + 16 * kStages;
      mbar_wait(cb + 8, (j & 1) ^ 1);  // chunk j - 1 released
      store_chunk_t(chunk, t, i);
      if (i < 2 * kWsRows) rows[i] = t.row;
      fence_proxy_async();
      mbar_arrive(cb);
    } else {
      const int idx = job.phases * n * j + (s < n ? s : s - 1);
      const int slot = idx % kStages;
      const uint32_t sb = bars + 16 * slot;
      mbar_wait(sb + 8, ((idx / kStages) & 1) ^ 1);  // use idx - kStages
      store_stage(ring + slot * (kStageBytes / 4), t, i);
      fence_proxy_async();
      mbar_arrive(sb);
    }
  };
  WsRaw a, b;
  load(a, 0);
  for (int k = 0; k < total; k += 2) {
    if (k + 1 < total) load(b, k + 1);
    store(a, k);
    if (k + 1 < total) {
      if (k + 2 < total) load(a, k + 2);
      store(b, k + 1);
    }
  }
}

// s[64 x kWsRows] of the consumer warpgroup = own.other^T over the n
// stages from ring index idx on (the ring at shared address ring, its
// barriers at bars; n may be 0), as 3xTF32 wgmma m64n32k8, every operand
// split in shared memory: per k-step big.big into the step's part,
// big.small and small.big into the small chain. Each step is one wgmma
// group, waited for whole before its part is added to s in f32 and its
// stage released: a part read after wgmma_wait<1>, with the next stage's
// mbarrier wait between, made ptxas serialize every wgmma, and a second
// part in flight spilled at the cap of 255 registers.
__device__ __forceinline__ void ws_scores(float (&s)[16], uint32_t ring,
                                          uint32_t bars, int idx, int n) {
  float part[16], small[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) s[e] = small[e] = 0.f;
  for (int step = 0; step < n; ++step) {
    const int at = idx + step, slot = at % kStages;
    mbar_wait(bars + 16 * slot, (at / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 8; ++kk) {
      // the addresses through opaque() each k-step, so that they are
      // computed where they are used, not held in registers
      const uint32_t a = opaque(ring) + slot * kStageBytes;
      const uint32_t b = a + 2 * kOwnHalfBytes;
      const uint64_t ab = step_desc<kTile>(a, kk),
                     as = step_desc<kTile>(a + kOwnHalfBytes, kk);
      const uint64_t bb = step_desc<kWsRows>(b, kk),
                     bs = step_desc<kWsRows>(b + kOtherHalfBytes, kk);
      wgmma_ss_tf32_n32(part, ab, bb, kk);
      wgmma_ss_tf32_n32(small, ab, bs, step | kk);
      wgmma_ss_tf32_n32(small, as, bb, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int e = 0; e < 16; ++e) s[e] += part[e];
    release_stage(bars + 16 * slot);
  }
  fence_regs(small);
#pragma unroll
  for (int e = 0; e < 16; ++e) s[e] += small[e];
}

// acc[64 x kPieceCols] += x.t over kWsRows as 3xTF32 wgmma: A the split
// [64, kWsRows] p or ds tile at shared address sx (small kXSplitBytes on),
// B kPieceCols rows of a split transposed chunk at st (small `small` bytes
// on). big.big from 0 in a temporary, waited for and added to acc in f32,
// then the small terms likewise: one temporary beside the outputs, where
// big and small at once spilled at the cap of 255 registers.
__device__ __forceinline__ void ws_accumulate(float (&acc)[kPieceCols / 2],
                                              uint32_t sx, uint32_t st,
                                              int small) {
  float tmp[kPieceCols / 2];
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kWsRows / 8; ++ks) {
    const uint32_t x = opaque(sx), t = opaque(st);
    wgmma_ss_tf32_n32(tmp, sw128_desc(x + 32 * ks),
                      sw128_desc(t + 32 * ks), ks);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(tmp);
#pragma unroll
  for (int e = 0; e < kPieceCols / 2; ++e) acc[e] += tmp[e];
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kWsRows / 8; ++ks) {
    const uint32_t x = opaque(sx), t = opaque(st);
    wgmma_ss_tf32_n32(tmp, sw128_desc(x + 32 * ks),
                      sw128_desc(t + small + 32 * ks), ks);
    wgmma_ss_tf32_n32(tmp, sw128_desc(x + kXSplitBytes + 32 * ks),
                      sw128_desc(t + 32 * ks), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(tmp);
#pragma unroll
  for (int e = 0; e < kPieceCols / 2; ++e) acc[e] += tmp[e];
}

// Stores a consumer thread's [64, kPieceCols kPieces] output, rows r0 +
// wr + g (+ 8), columns c0 + kPieceCols pc + 8 (e / 4) + 2 t (+ 1): what
// lies in [0, seq) x [0, D).
template <int kPieces>
__device__ __forceinline__ void ws_store(
    float* out, const float (&acc)[kPieces][kPieceCols / 2], int r0, int c0,
    int seq, int D) {
  const int wr = (threadIdx.x >> 5) * 16, g = (threadIdx.x & 31) >> 2;
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int pc = 0; pc < kPieces; ++pc)
#pragma unroll
    for (int e = 0; e < kPieceCols / 2; e += 2) {
      const int row = r0 + wr + g + 8 * ((e >> 1) & 1);
      const int col = c0 + kPieceCols * pc + 8 * (e >> 2) + 2 * t4;
      if (row < seq && col < D)
        store2(out + (size_t)row * D + col, acc[pc][e], acc[pc][e + 1]);
    }
}

// Value e of a consumer thread's [64, kWsRows] score tile (the scores'
// layout), kept raw at its word of one half of a p or ds tile (x_at, as
// store_x writes it): stash_x writes them all, unstash_x reads one back.
__device__ __forceinline__ int x_word(int e) {
  const int row = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
  return x_at(row + 8 * ((e >> 1) & 1), 8 * (e >> 2) + 2 * (threadIdx.x & 3) +
                                            (e & 1));
}

__device__ __forceinline__ void stash_x(uint32_t* x, const float (&v)[16]) {
#pragma unroll
  for (int e = 0; e < 16; ++e) x[x_word(e)] = __float_as_uint(v[e]);
}

__device__ __forceinline__ float unstash_x(const uint32_t* x, int e) {
  return __uint_as_float(x[x_word(e)]);
}

// The ring's kStages barrier pairs, then the chunk's.
__device__ __forceinline__ void ws_init_bars(uint32_t bars) {
  if (threadIdx.x == 0) {
    for (int s = 0; s <= kStages; ++s) {
      mbar_init(bars + 16 * s, kTcThreads);
      mbar_init(bars + 16 * s + 8, kTcWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// Replaces _bwd_dq_kernel (flash_attention.py:160) for f32 head dims above
// 256. Per KV tile of kWsRows rows: dp = do.v^T, s = q.k^T, ds = p (dp -
// delta) scale with p = exp(s scale - lse), written split, then dq[:,
// chunk] += ds.k[:, chunk].
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dq_ws_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, int seq, int D,
                           float scale, int causal) {
  extern __shared__ uint8_t ws_smem[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(align_1024(ws_smem));
  uint32_t* kt = ring + kStages * kStageBytes / 4;  // K^T: big, small
  uint32_t* sds = kt + 2 * kOutCols * kSlabCols;    // ds: big, small
  float* rows = reinterpret_cast<float*>(sds + 2 * kXSplitBytes / 4);
  const uint32_t bars = smem_addr(rows + 2 * kWsRows);
  const uint32_t kt_bars = bars + 16 * kStages;
  // grid (chunks, Q tiles, BH): the chunks of a tile run side by side and
  // read the same steps, from L2
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = tile * kTile, c0 = blockIdx.x * kOutCols;
  const size_t base = (size_t)blockIdx.z * seq * D;
  const int n = D / kChunk;
  const int kv_end = causal ? min(seq, q0 + kTile) : seq;
  const int n_tiles = (kv_end + kWsRows - 1) / kWsRows;
  ws_init_bars(bars);
  if (threadIdx.x >= kTcThreads) {
    const WsJob job{dout + base, v + base, q + base, k + base, k + base,
                    nullptr,     nullptr,  2,        q0,       0,
                    n_tiles,     n,        c0,       seq,      D};
    ws_produce(job, ring, kt, rows, bars);
    return;
  }

  const int wr = (threadIdx.x >> 5) * 16;  // the warp's rows in the tile
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  // p = exp(s scale - lse) = exp2(s scale log2(e) - lse log2(e))
  const float scale2 = scale * kLog2e;
  const size_t rbase = (size_t)blockIdx.z * seq;
  float lse2[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    lse2[h] = row < seq ? lse[rbase + row] * kLog2e : 0.f;
    delta_r[h] = row < seq ? delta[rbase + row] : 0.f;
  }
  const uint32_t ring_at = smem_addr(ring), kt_at = smem_addr(kt);
  const uint32_t ds_at = smem_addr(sds);
  float acc[kOutCols / kPieceCols][kPieceCols / 2];
#pragma unroll
  for (int pc = 0; pc < kOutCols / kPieceCols; ++pc)
#pragma unroll
    for (int e = 0; e < kPieceCols / 2; ++e) acc[pc][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kWsRows;
    float s[16];
    ws_scores(s, ring_at, bars, 2 * n * j, n);  // dp
    // dp waits in the ds tile's words while s is taken (the registers are
    // at the cap), each thread's values where it writes its ds
    stash_x(sds, s);
    ws_scores(s, ring_at, bars, 2 * n * j + n, n);
    // only a tile past S or across the diagonal has masked entries
    const bool edge =
        k0 + kWsRows > seq || (causal && k0 + kWsRows - 1 > q0 + wr);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int h = (e >> 1) & 1, row = q0 + wr + g + 8 * h,
                col = k0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
      float p = exp2f(fmaf(s[e], scale2, -lse2[h]));
      if (edge && (col >= seq || (causal && col > row))) p = 0.f;
      s[e] = p * (unstash_x(sds, e) - delta_r[h]) * scale;  // ds
    }
    store_x<kWsRows>(sds, s);
    fence_proxy_async();
    named_sync(1, kTcThreads);  // ds is written
    mbar_wait(kt_bars, j & 1);
#pragma unroll
    for (int pc = 0; pc < kOutCols / kPieceCols; ++pc)
      ws_accumulate(acc[pc], ds_at, opaque(kt_at) + pc * kPieceCols * 128,
                    kOutCols * 128);
    release_stage(kt_bars);
  }
  ws_store(dq + (size_t)opaque(blockIdx.z) * seq * D, acc, q0, c0, seq, D);
}

// Replaces _bwd_dkv_kernel (flash_attention.py:212) for f32 head dims above
// 256, as two kinds of block: of each pair of blocks in grid x, the first
// computes dv's chunk, the second dk's. Per Q tile of kWsRows rows, in
// transposed scores (rows the block's KV rows, columns Q rows): s^T =
// k.q^T and p^T from lse; a dv block then adds dv[:, chunk] += p^T.do[:,
// chunk]; a dk block takes dp^T = v.do^T, ds^T = p^T (dp^T - delta) scale
// and adds dk[:, chunk] += ds^T.q[:, chunk]. Each block holds one 64 x 256
// output; the dv block skips dp^T (a product of zero steps).
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dkv_ws_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int seq, int D, float scale, int causal) {
  extern __shared__ uint8_t ws_smem[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(align_1024(ws_smem));
  uint32_t* ch = ring + kStages * kStageBytes / 4;  // dO^T or Q^T: big, small
  uint32_t* sx = ch + 2 * kOutCols * kSlabCols;     // p^T or ds^T
  float* rows = reinterpret_cast<float*>(sx + 2 * kXSplitBytes / 4);
  // rows: the Q tile's lse, then its delta
  const uint32_t bars = smem_addr(rows + 2 * kWsRows);
  const uint32_t ch_bars = bars + 16 * kStages;
  // grid (2 chunks, KV tiles, BH), as dq's; the longest column runs first
  const bool dk_block = blockIdx.x & 1;
  const int k0 = blockIdx.y * kTile;
  const int c0 = (blockIdx.x >> 1) * kOutCols;
  const size_t base = (size_t)blockIdx.z * seq * D;
  const size_t rbase = (size_t)blockIdx.z * seq;
  const int n = D / kChunk, phases = dk_block ? 2 : 1;
  // Q tiles wholly before this KV tile see none of it under causal masking
  const int q_begin = causal ? k0 : 0;
  const int n_tiles = (seq - q_begin + kWsRows - 1) / kWsRows;
  ws_init_bars(bars);
  if (threadIdx.x >= kTcThreads) {
    const WsJob job{k + base,
                    q + base,
                    v + base,
                    dout + base,
                    (dk_block ? q : dout) + base,
                    lse + rbase,
                    dk_block ? delta + rbase : nullptr,
                    phases,
                    k0,
                    q_begin,
                    n_tiles,
                    n,
                    c0,
                    seq,
                    D};
    ws_produce(job, ring, ch, rows, bars);
    return;
  }

  const int wr = (threadIdx.x >> 5) * 16;  // the warp's KV rows in the tile
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  const float scale2 = scale * kLog2e;  // exp(x) = exp2(x log2(e))
  const uint32_t ring_at = smem_addr(ring), ch_at = smem_addr(ch);
  const uint32_t x_at_ = smem_addr(sx);
  float acc[kOutCols / kPieceCols][kPieceCols / 2];
#pragma unroll
  for (int pc = 0; pc < kOutCols / kPieceCols; ++pc)
#pragma unroll
    for (int e = 0; e < kPieceCols / 2; ++e) acc[pc][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = q_begin + j * kWsRows;
    float x[16];
    ws_scores(x, ring_at, bars, phases * n * j, n);  // s^T
    mbar_wait(ch_bars, j & 1);  // the tile's chunk, lse and delta
    // only a tile past S or across the diagonal has masked entries (KV
    // rows past S are never stored, so they need no mask)
    const bool edge = q0 + kWsRows > seq || (causal && q0 < k0 + wr + 15);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int a = 8 * (e >> 2) + 2 * t4 + (e & 1), row = q0 + a,
                col = k0 + wr + g + 8 * ((e >> 1) & 1);
      float p = exp2f(fmaf(x[e], scale2, -rows[a] * kLog2e));
      if (edge && (row >= seq || (causal && col > row))) p = 0.f;
      x[e] = p;
    }
    // p^T waits in its tile's words while a dk block takes dp^T
    stash_x(sx, x);
    ws_scores(x, ring_at, bars, phases * n * j + n, dk_block ? n : 0);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float p = unstash_x(sx, e);
      const float dlt = rows[kWsRows + 8 * (e >> 2) + 2 * t4 + (e & 1)];
      x[e] = dk_block ? p * (x[e] - dlt) * scale : p;  // ds^T or p^T
    }
    store_x<kWsRows>(sx, x);
    fence_proxy_async();
    named_sync(1, kTcThreads);  // p^T or ds^T is written
#pragma unroll
    for (int pc = 0; pc < kOutCols / kPieceCols; ++pc)
      ws_accumulate(acc[pc], x_at_, opaque(ch_at) + pc * kPieceCols * 128,
                    kOutCols * 128);
    release_stage(ch_bars);
  }
  ws_store((dk_block ? dk : dv) + base, acc, k0, c0, seq, D);
}

// Replaces _fwd_kernel (flash_attention.py:29) for f32 head dims above
// 256. A block as dq's (grid (chunks, Q tiles, BH)): the consumer owns 64
// Q rows and one 256-column chunk of o; the producer streams the score
// product's steps (own Q, other K) and each KV tile's rows of the chunk of
// V, transposed, as a dv block streams dO's (phases 1, no lse or delta).
// Per KV tile of kWsRows rows: s = q.k^T (ws_scores), the online softmax
// of flash_attention_f32.cu's flash_fwd_d256_tc_kernel in the scores'
// layout, p written split, o = o.corr + p.v[:, chunk] (ws_accumulate). At
// the end o = acc / max(l, 1e-30) and lse = m scale + log(l), written by
// chunk 0's block.
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_ws_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int seq, int D, float scale,
                        int causal) {
  extern __shared__ uint8_t ws_smem[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(align_1024(ws_smem));
  uint32_t* vt = ring + kStages * kStageBytes / 4;  // V^T: big, small
  uint32_t* sp = vt + 2 * kOutCols * kSlabCols;     // p: big, small
  // the chunk's lse and delta words, which the forward's producer fills
  // with zeros
  float* rows = reinterpret_cast<float*>(sp + 2 * kXSplitBytes / 4);
  const uint32_t bars = smem_addr(rows + 2 * kWsRows);
  const uint32_t vt_bars = bars + 16 * kStages;
  // grid (chunks, Q tiles, BH), as dq's
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = tile * kTile, c0 = blockIdx.x * kOutCols;
  const size_t base = (size_t)blockIdx.z * seq * D;
  const int n = D / kChunk;
  const int kv_end = causal ? min(seq, q0 + kTile) : seq;
  const int n_tiles = (kv_end + kWsRows - 1) / kWsRows;
  ws_init_bars(bars);
  if (threadIdx.x >= kTcThreads) {
    const WsJob job{q + base, k + base, nullptr, nullptr, v + base,
                    nullptr,  nullptr,  1,       q0,      0,
                    n_tiles,  n,        c0,      seq,     D};
    ws_produce(job, ring, vt, rows, bars);
    return;
  }

  const int wr = (threadIdx.x >> 5) * 16;  // the warp's rows in the tile
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  const float scale2 = scale * kLog2e;  // exp(x) = exp2(x log2(e))
  const uint32_t ring_at = smem_addr(ring), vt_at = smem_addr(vt);
  const uint32_t sp_at = smem_addr(sp);
  float m[2] = {kNegInf, kNegInf};  // running max of the raw scores
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  float acc[kOutCols / kPieceCols][kPieceCols / 2];
#pragma unroll
  for (int pc = 0; pc < kOutCols / kPieceCols; ++pc)
#pragma unroll
    for (int e = 0; e < kPieceCols / 2; ++e) acc[pc][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kWsRows;
    float s[16];
    ws_scores(s, ring_at, bars, n * j, n);
    // only a tile past S or across the diagonal has masked entries
    const bool edge =
        k0 + kWsRows > seq || (causal && k0 + kWsRows - 1 > q0 + wr);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int h = (e >> 1) & 1, row = q0 + wr + g + 8 * h,
                col = k0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
      if (edge && (col >= seq || (causal && col > row))) s[e] = kNegInf;
      mx[h] = fmaxf(mx[h], s[e]);
    }
    float corr[2], ms[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      corr[h] = exp2f((m[h] - mx[h]) * scale2);
      m[h] = mx[h];
      ms[h] = mx[h] * scale2;
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      s[e] = exp2f(fmaf(s[e], scale2, -ms[(e >> 1) & 1]));  // p
      sum[(e >> 1) & 1] += s[e];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
    store_x<kWsRows>(sp, s);
    fence_proxy_async();
    named_sync(1, kTcThreads);  // p is written
#pragma unroll
    for (int pc = 0; pc < kOutCols / kPieceCols; ++pc)
#pragma unroll
      for (int e = 0; e < kPieceCols / 2; ++e) acc[pc][e] *= corr[(e >> 1) & 1];
    mbar_wait(vt_bars, j & 1);  // the tile's rows of V^T
#pragma unroll
    for (int pc = 0; pc < kOutCols / kPieceCols; ++pc)
      ws_accumulate(acc[pc], sp_at, opaque(vt_at) + pc * kPieceCols * 128,
                    kOutCols * 128);
    release_stage(vt_bars);
  }
  float lc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lc[h] = fmaxf(quad_sum(l[h]), 1e-30f);
    const int row = q0 + wr + g + 8 * h;
    if (blockIdx.x == 0 && t4 == 0 && row < seq)
      lse[(size_t)blockIdx.z * seq + row] = m[h] * scale + logf(lc[h]);
  }
#pragma unroll
  for (int pc = 0; pc < kOutCols / kPieceCols; ++pc)
#pragma unroll
    for (int e = 0; e < kPieceCols / 2; ++e) acc[pc][e] /= lc[(e >> 1) & 1];
  ws_store(o + base, acc, q0, c0, seq, D);
}

// -------------------------------------------------- bf16 forward on wgmma
//
// flash_fwd_tma_kernel: the bf16 forward above head dim 256, built on
// flash_attention.cu's flash_fwd_d256_kernel: TMA loads in the 128-byte
// swizzle, bf16 wgmma m64n64k16 with f32 sums, the online softmax of its
// 64 rows in each consumer warpgroup's registers, p packed to bf16 as the
// register A operand of o += p.v, and p.v of KV tile j - 1 issued after the
// scores of tile j, so that it runs on the tensor cores while the softmax
// of tile j runs. A block is two warpgroups (64 Q rows each, 128 a block)
// and computes one kOutCols-column chunk of o (grid (chunks, Q tiles,
// BH)), o[64 x 256] f32 in a thread's 128 registers.
//
// The scores contract over all of D in 64-column TMA boxes: per 64-row KV
// tile, box b of K (8 KB) goes through a ring of kKStages stages, and the
// two warpgroups add q[:, box b].k[:, box b]^T into s (4 k-steps a box,
// one wgmma group a box; a warp is done with a box as soon as the group
// after its own is issued and its own is complete, so one box's products
// are in flight while the next box is awaited). The block's Q tile stays
// in shared memory while D <= kQBoxes * 64 (512): 128 KB at D 512, loaded
// once. Above that the ring's stages take each Q box beside its K box, in
// the same 192 KB: Q is then read again for every KV tile. V's tile holds the chunk's 64-column
// boxes (a [64, 256] bf16 tile, 32 KB) in one stage; boxes past D are not
// loaded, and the products that read them write only columns that are not
// stored. No warp only loads: thread 0 issues the first loads (Q, the
// first kKStages K boxes, V's tile 0), and then the last of the eight
// warps done with a stage refills it (a count a stage in shared memory):
// K box i + kKStages once box i is done, V's tile j + 1 once tile j is. So
// no warp ever waits for a stage to empty, and a load goes out the moment
// its stage is free.
//
// Why these widths: a chunk of 256 columns (o's 128 registers a thread,
// with s 32 and p 16: ~200) takes the scores once per 256 columns of o, so
// at D 512 a forward does (D + 256) / 2 / 256 = 1.5 times the products of
// a whole-row kernel, against 4.5 for the mma.sync template's 64-column
// chunks; 128 Q rows a block share each K box between two warpgroups, and
// a resident Q tile is read once per block instead of once per KV tile
// (the template's 64 KB per 128 KV rows and chunk at D 512).
//
// Order of the sums: every chunk's block adds the boxes of a KV tile into
// s in the same order with the same instructions and takes the same
// softmax steps, so every chunk of a row sees the same p bit for bit.
//
// Shared memory: 1024 (alignment) + 192 KB (Q and the K ring) + V 32 KB +
// 10 barriers and 9 counts = 230,516 bytes: one block an SM.

// Two warpgroups, both consumers. A ninth (producer) warp would cap every
// thread at 168 registers (the SM splits a block's warps over four
// register files of 16K), and the consumers spilled there; a producer
// warpgroup under setmaxnreg left ptxas at 168 all the same. So the
// consumers' own lanes issue the loads (tma_done_k, tma_done_v).
constexpr int kTmaThreads = 2 * kTcThreads;
constexpr int kTmaRows = 128;  // Q rows of a block, 64 a consumer warpgroup
constexpr int kTmaKv = 64;     // KV rows of a tile
constexpr int kBoxCols = 64;   // bf16 columns of a box: one 128-byte row
constexpr int kKBoxBytes = kTmaKv * 128;    // a [64, 64] K or V box
constexpr int kQBoxBytes = kTmaRows * 128;  // a [128, 64] Q box
constexpr int kQBoxes = 8;  // Q boxes that stay resident: D <= 512
constexpr int kKStages = 8;
// The ring's 192 KB: resident Q (kQBoxes boxes) and K stages of one box
// each, or K stages of a K box and a Q box each
constexpr int kRingBytes = kQBoxes * kQBoxBytes + kKStages * kKBoxBytes;
static_assert(kKStages * (kKBoxBytes + kQBoxBytes) == kRingBytes,
              "streamed Q fits where resident Q and the K ring lie");
constexpr int kVBytes = kOutCols / kBoxCols * kKBoxBytes;

// The ring, V's stage, then a full barrier for each K stage, V's and Q's,
// then the counts of warps done with each K stage and with V.
constexpr int tma_fwd_smem_bytes() {
  return 1024 + kRingBytes + kVBytes + 8 * (kKStages + 2) +
         4 * (kKStages + 1);
}

// Shared address of K stage `slot` in the ring at `ring` (its Q box, when
// Q streams, kKBoxBytes on).
__device__ __forceinline__ uint32_t kstage_at(uint32_t ring, int slot,
                                              bool resident) {
  return resident ? ring + kQBoxes * kQBoxBytes + slot * kKBoxBytes
                  : ring + slot * (kKBoxBytes + kQBoxBytes);
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// One [rows x 64] box of a [BH, S, D] tensor map at (col, row, bh) into
// shared memory; the box's bytes complete a transaction on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(bh)
      : "memory");
}

// d[64 x 64] (+)= A.B in bf16 with f32 sums, A [64, 16 of K] and B [64 of
// N, 16 of K] read K-major from shared memory; acc = 0 overwrites d.
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[32], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 64] += A.B, A bf16 fragments in registers (mma.sync's m16n8k16 A
// layout, a 16-row slab a warp), B [16 of K, 64 of N] read MN-major from
// shared memory.
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int H>
__device__ __forceinline__ void fence_regs(float (&d)[H][32]) {
#pragma unroll
  for (int h = 0; h < H; ++h) fence_regs(d[h]);
}

__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// 2^x on the special-function unit, denormals flushed (p and the rescale
// factors are either 0 or far above the denormal range).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One KV tile of the online softmax for this thread's rows row and row + 8
// (flash_attention.cu's softmax_tile at 64 KV rows): sc holds the raw
// scores, masked to NEG_INF where the tile crosses the diagonal or S; m is
// the running raw max, l this thread's share of the row sums, corr the
// factor that rescales the output accumulated so far. On return sc holds
// p = exp2(s scale log2(e) - m scale log2(e)).
__device__ __forceinline__ void tma_softmax(float (&sc)[32], float (&m)[2],
                                            float (&l)[2], float (&corr)[2],
                                            bool masked, int k0, int row,
                                            int t, int seq, int causal,
                                            float scale_log2) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + 8 * j + 2 * t + (i & 1);
        if ((causal && col > row + 8 * (i >> 1)) || col >= seq)
          sc[4 * j + i] = kNegInf;
      }
  }
  // row maxima as a tree (row: i = 0, 1; row + 8: i = 2, 3)
  float r[2][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    r[0][j] = fmaxf(sc[4 * j], sc[4 * j + 1]);
    r[1][j] = fmaxf(sc[4 * j + 2], sc[4 * j + 3]);
  }
#pragma unroll
  for (int w = 4; w >= 1; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) {
      r[0][j] = fmaxf(r[0][j], r[0][j + w]);
      r[1][j] = fmaxf(r[1][j], r[1][j + w]);
    }
  float ms[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mnew = quad_max(fmaxf(m[h], r[h][0]));
    corr[h] = exp2_ftz((m[h] - mnew) * scale_log2);
    m[h] = mnew;
    ms[h] = mnew * scale_log2;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i)
    sc[i] = exp2_ftz(fmaf(sc[i], scale_log2, -ms[(i >> 1) & 1]));
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    r[0][j] = sc[4 * j] + sc[4 * j + 1];
    r[1][j] = sc[4 * j + 2] + sc[4 * j + 3];
  }
#pragma unroll
  for (int w = 4; w >= 1; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) {
      r[0][j] += r[0][j + w];
      r[1][j] += r[1][j + w];
    }
  l[0] = fmaf(l[0], corr[0], r[0][0]);
  l[1] = fmaf(l[1], corr[1], r[1][0]);
}

// What a block of flash_fwd_tma_kernel loads and where: the tensor maps;
// the ring's shared address (V's stage kRingBytes on) and its barriers'
// (each K stage's full barrier at bars + 8 s, V's at bars + 8 kKStages,
// Q's 8 on); the warps done with each K stage and with V, counted in
// done[]; the block's Q rows, chunk and head; the K boxes a
// tile and the KV tiles; V's boxes below D; whether Q stays resident; and
// the consumer warpgroup.
struct TmaBlock {
  const CUtensorMap *q, *k, *v;
  uint32_t ring, bars;
  int* done;
  int q0, c0, bh, nb, n_kv, v_boxes;
  bool resident;
  int wg;
};

// K box idx (box idx % nb of KV tile idx / nb), and its Q box when Q
// streams, into stage idx % kKStages.
__device__ __forceinline__ void tma_load_k(const TmaBlock& t, int idx) {
  const int slot = idx % kKStages, j = idx / t.nb, b = idx - j * t.nb;
  const uint32_t bar = t.bars + 8 * slot;
  const uint32_t st = kstage_at(t.ring, slot, t.resident);
  mbar_expect_tx(bar, t.resident ? kKBoxBytes : kKBoxBytes + kQBoxBytes);
  tma_load(st, t.k, bar, b * kBoxCols, j * kTmaKv, t.bh);
  if (!t.resident)
    tma_load(st + kKBoxBytes, t.q, bar, b * kBoxCols, t.q0, t.bh);
}

// V's boxes of KV tile j below D, the chunk's columns, into V's stage.
__device__ __forceinline__ void tma_load_v(const TmaBlock& t, int j) {
  const uint32_t bar = t.bars + 8 * kKStages;
  mbar_expect_tx(bar, t.v_boxes * kKBoxBytes);
  for (int h = 0; h < t.v_boxes; ++h)
    tma_load(t.ring + kRingBytes + h * kKBoxBytes, t.v, bar,
             t.c0 + h * kBoxCols, j * kTmaKv, t.bh);
}

// Counts this warp done with the stage of done[i] (its wgmmas that read
// it are complete); true for the last of the eight warps, whose first
// lane then owns the stage.
__device__ __forceinline__ bool tma_last_done(int* done, int i) {
  __syncwarp();
  bool last = false;
  if ((threadIdx.x & 31) == 0) {
    __threadfence_block();
    last = atomicAdd(done + i, 1) % (2 * kTcWarps) == 2 * kTcWarps - 1;
    if (last) __threadfence_block();
  }
  return last;
}

// This warp is done with K box idx: the last warp refills its stage with
// box idx + kKStages.
__device__ __forceinline__ void tma_done_k(const TmaBlock& t, int idx) {
  if (tma_last_done(t.done, idx % kKStages) &&
      idx + kKStages < t.nb * t.n_kv)
    tma_load_k(t, idx + kKStages);
}

// This warp is done with V's tile j: the last warp loads tile j + 1.
__device__ __forceinline__ void tma_done_v(const TmaBlock& t, int j) {
  if (tma_last_done(t.done, kKStages) && j + 1 < t.n_kv) tma_load_v(t, j + 1);
}

// Waits for K box idx (box b of its tile) and issues its 4 k-steps of s +=
// q[:, box].k[:, box]^T as one wgmma group (box 0 overwrites s).
__device__ __forceinline__ void tma_issue_box(float (&sc)[32],
                                              const TmaBlock& t, int idx,
                                              int b) {
  const int slot = idx % kKStages;
  mbar_wait(t.bars + 8 * slot, (idx / kKStages) & 1);
  const uint32_t st = opaque(kstage_at(t.ring, slot, t.resident));
  const uint32_t qa =
      (t.resident ? opaque(t.ring) + b * kQBoxBytes : st + kKBoxBytes) +
      t.wg * 64 * 128;
  const uint64_t dq = sw128_desc(qa), dk = sw128_desc(st);
#pragma unroll
  for (int kk = 0; kk < kBoxCols / 16; ++kk)
    wgmma_bf16_ss(sc, dq + 2 * kk, dk + 2 * kk, b | kk);
  wgmma_commit();
}

// s = q.k^T of the next KV tile (its first box at ring index idx, which
// moves past the tile), a wgmma group a box, this warp done with each box
// once the next box's group is issued and its own is done; returns with
// the last box's group in flight. Box 0 is issued
// before the loop, so that no wgmma or wait sits in a branch (ptxas
// serializes wgmmas in a divergent path, C7520).
__device__ __forceinline__ void tma_scores(float (&sc)[32], const TmaBlock& t,
                                           int& idx) {
  wgmma_fence();
  tma_issue_box(sc, t, idx++, 0);
  for (int b = 1; b < t.nb; ++b) {
    tma_issue_box(sc, t, idx++, b);
    wgmma_wait<1>();  // box b - 1 is read
    tma_done_k(t, idx - 2);
  }
}

// o += p.v of a tile as one wgmma group: A p's bf16 fragments, B V's boxes
// at sv MN-major, a k-step 16 KV rows (2048 bytes) on.
__device__ __forceinline__ void tma_pv(float (&acc)[kOutCols / kBoxCols][32],
                                       const uint32_t (&pa)[kTmaKv / 16][4],
                                       uint32_t sv) {
#pragma unroll
  for (int kk = 0; kk < kTmaKv / 16; ++kk)
#pragma unroll
    for (int h = 0; h < kOutCols / kBoxCols; ++h)
      wgmma_bf16_rs(acc[h], pa[kk],
                    sw128_desc(opaque(sv) + h * kKBoxBytes) + kk * 128);
  wgmma_commit();
}

// p in the scores' layout as the bf16 A fragments of p.v: k-step kk takes
// columns 16 kk to 16 kk + 15, the accumulator's layout being mma.sync's
// C and wgmma's register A mma.sync's A.
__device__ __forceinline__ void tma_pack(uint32_t (&pa)[kTmaKv / 16][4],
                                         const float (&sc)[32]) {
#pragma unroll
  for (int kk = 0; kk < kTmaKv / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
}

// Replaces _fwd_kernel (flash_attention.py:29) for bf16 head dims above
// 256. Per 64-row KV tile each consumer warpgroup takes s = q.k^T over the
// boxes of D, then (from the second tile on) issues p.v of the tile before,
// runs the online softmax of the tile, rescales o and packs p to bf16. At
// the end o = acc / max(l, 1e-30) and lse = m scale + log(l), written by
// chunk 0's block. Under causal masking warpgroup 0's rows may end before
// the block's last KV tile: it counts that tile's K boxes done unread.
__global__ void __launch_bounds__(kTmaThreads, 1)
    flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int seq, int D,
                         float scale, int causal) {
  extern __shared__ uint8_t tma_smem[];
  uint8_t* base = align_1024(tma_smem);
  const uint32_t ring = smem_addr(base);
  const uint32_t bars = ring + kRingBytes + kVBytes;
  const uint32_t v_full = bars + 8 * kKStages, q_full = v_full + 8;
  int* done = reinterpret_cast<int*>(base + kRingBytes + kVBytes +
                                     8 * (kKStages + 2));
  // grid (chunks, Q tiles, BH): the longest rows first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTmaRows;
  const int c0 = blockIdx.x * kOutCols, bh = blockIdx.z;
  const int nb = D / kBoxCols;
  const int n_kv = ((causal ? min(q0 + kTmaRows, seq) : seq) + kTmaKv - 1) /
                   kTmaKv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const TmaBlock t{&tm_q, &tm_k, &tm_v, ring, bars, done, q0, c0, bh, nb,
                   n_kv, min(kOutCols, D - c0) / kBoxCols, nb <= kQBoxes,
                   wg};

  if (threadIdx.x == 0) {
    for (int s = 0; s <= kKStages + 1; ++s) mbar_init(bars + 8 * s, 1);
    for (int s = 0; s <= kKStages; ++s) done[s] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the first loads; the consumers issue the rest
    if (t.resident) {
      mbar_expect_tx(q_full, nb * kQBoxBytes);
      for (int b = 0; b < nb; ++b)
        tma_load(ring + b * kQBoxBytes, &tm_q, q_full, b * kBoxCols, q0, bh);
    }
    for (int i = 0; i < kKStages && i < nb * n_kv; ++i) tma_load_k(t, i);
    tma_load_v(t, 0);
  }

  // warpgroup wg owns rows q0 + 64 wg .. + 63 and uses the first n_w KV
  // tiles
  const int g = lane >> 2, tq = lane & 3;
  const int wg_row0 = q0 + wg * 64;
  const int row = wg_row0 + (warp & 3) * 16 + g;  // and row + 8
  const int n_w = causal ? (min(wg_row0 + 64, seq) + kTmaKv - 1) / kTmaKv
                         : n_kv;
  const float scale_log2 = scale * kLog2e;
  float acc[kOutCols / kBoxCols][32];
#pragma unroll
  for (int h = 0; h < kOutCols / kBoxCols; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of the raw scores
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  float corr[2];
  float sc[32];
  uint32_t pa[kTmaKv / 16][4];
  int idx = 0;  // ring index of the next K box
  auto masked = [&](int it) {
    const int k0 = it * kTmaKv;
    return (causal && k0 + kTmaKv - 1 > wg_row0) || k0 + kTmaKv > seq;
  };

  if (t.resident) mbar_wait(q_full, 0);
  tma_scores(sc, t, idx);  // tile 0
  wgmma_wait<0>();
  fence_regs(sc);
  tma_done_k(t, idx - 1);
  tma_softmax(sc, m, l, corr, masked(0), 0, row, tq, seq, causal,
              scale_log2);
  tma_pack(pa, sc);
  for (int it = 1; it < n_w; ++it) {
    tma_scores(sc, t, idx);
    mbar_wait(v_full, (it - 1) & 1);
    tma_pv(acc, pa, ring + kRingBytes);  // of tile it - 1
    wgmma_wait<1>();                     // the scores of tile it
    fence_regs(sc);
    tma_done_k(t, idx - 1);
    tma_softmax(sc, m, l, corr, masked(it), it * kTmaKv, row, tq, seq,
                causal, scale_log2);
    wgmma_wait<0>();  // p.v of tile it - 1
    fence_regs(acc);
    fence_regs(pa);
    tma_done_v(t, it - 1);
#pragma unroll
    for (int h = 0; h < kOutCols / kBoxCols; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][i] *= corr[(i >> 1) & 1];
    tma_pack(pa, sc);
  }
  mbar_wait(v_full, (n_w - 1) & 1);
  wgmma_fence();
  tma_pv(acc, pa, ring + kRingBytes);  // of the last tile
  wgmma_wait<0>();
  fence_regs(acc);
  tma_done_v(t, n_w - 1);
  // the K boxes of the tiles this warpgroup skips, each counted done once
  // it is in (only then is the stage's count that of this box); their V
  // tiles load for the other warpgroup alone
  for (; idx < n_kv * nb; ++idx) {
    mbar_wait(bars + 8 * (idx % kKStages), (idx / kKStages) & 1);
    tma_done_k(t, idx);
  }

  float lc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) lc[r] = fmaxf(quad_sum(l[r]), 1e-30f);
  __nv_bfloat16* out = o + (size_t)bh * seq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    if (rr >= seq) continue;
    if (blockIdx.x == 0 && tq == 0)
      lse[(size_t)bh * seq + rr] = m[r] * scale + logf(lc[r]);
#pragma unroll
    for (int h = 0; h < kOutCols / kBoxCols; ++h) {
      const int col = c0 + h * kBoxCols;
      if (col >= D) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)rr * D + col +
                                           8 * j + 2 * tq) =
            __floats2bfloat162_rn(acc[h][4 * j + 2 * r] / lc[r],
                                  acc[h][4 * j + 2 * r + 1] / lc[r]);
    }
  }
}

// ------------------------------------------- bf16 dq and dk/dv on wgmma
//
// flash_bwd_dq_tma_kernel and flash_bwd_dkv_tma_kernel: the bf16 backward
// above head dim 256, on flash_fwd_tma_kernel's machinery (TMA boxes of 64
// columns in the 128-byte swizzle through a ring whose stages the last of
// the eight warps done with them refills, bf16 wgmma m64n64k16 with f32
// sums) and the products of flash_attention.cu's head-dim-256 backward
// kernels. A block is two warpgroups and computes one kOutCols-column
// chunk of its outputs (grid (chunks, tiles, BH)), a [64, 256] f32
// accumulator in a thread's 128 registers.
//
//   dq:    128 Q rows, 64 a warpgroup. Per 64-row KV tile, over the boxes
//          of D: dp = do.v^T and s = q.k^T (both products of a box in one
//          wgmma group); then p from lse, ds = p (dp - delta) scale, packed
//          to bf16 as the register A operand of dq[:, chunk] += ds.k[:,
//          chunk], K's rows of the chunk read MN-major.
//   dk/dv: 64 KV rows, every row in both warpgroups; per 64-row Q tile,
//          warpgroup 0 takes s^T = k.q^T over the boxes of D, p^T from lse
//          and dv[:, chunk] += p^T.do[:, chunk]; warpgroup 1 dp^T = v.do^T,
//          ds^T = p^T (dp^T - delta) scale and dk[:, chunk] += ds^T.q[:,
//          chunk]. p^T passes from warpgroup 0 to 1 through shared memory
//          in f32, as in flash_bwd_dkv_d256_kernel.
//
// Why these widths: the scores are taken once for each chunk, so 256
// columns (the widest accumulator the registers hold beside s and dp)
// cut the 64-column templates' recompute: at D 512 dq does (2 D / 256 +
// 1) / 3 = 1.67 times the products of a whole-row kernel, against 5.7,
// and dk/dv (2 + 2 x 256 / D) 2 / 4 = 1.5, against 4.5. 128 Q rows a dq
// block share each K and V box between two warpgroups.
//
// What binds them is the wait for boxes, not L2's bytes or the tensor
// cores: every box of the other axis is read once for each chunk and each
// tile of the block's own axis, and a box's products take less time than
// its load. So a stage holds every box one k-step of 64 columns needs, the
// block's own rows among them (dq: K, V, dO and Q, 48 KB; dk/dv: Q, dO, V
// and K, 32 KB), and the ring is as deep as shared memory allows: 4 stages,
// 3 of them loading while one is read. Keeping the own tile resident
// instead (Q 128 KB, K 64 KB at D 512) read ~1.07 and ~1.76 GB from L2,
// not ~1.47 and ~2.14, but left 2 and 3 stages and ran 28% and 16% slower
// on the card (PERF.md). The chunk's rows of the other axis (dq: K's,
// dk/dv: Q's and dO's) have a buffer of their own, loaded once a tile: the
// boxes the scores read are gone by the time ds is known. A chunk's boxes
// past D are not loaded; the products that read them write only columns
// that are not stored.
//
// Order of the sums: every chunk's block adds the boxes into s and dp in
// the same order with the same instructions and takes p and ds in the
// same steps, so every chunk of a row sees the same p and ds bit for bit.
//
// Loads: no warp only loads (a ninth warp caps every thread at 168
// registers, the forward's note). Thread 0 issues the first loads (the
// first stages and tile 0's chunk); then the last of the eight warps done
// with a stage refills it with box idx + kBwdStages, and the last done
// with the chunk loads the next tile's. Under causal masking dq's
// warpgroup 0 may end a KV tile before the block: it counts that tile's
// boxes done unread, as the forward does.
constexpr int kBwdStages = 4;
// dq: a stage is a K, a V, a dO and a Q box (dO's and Q's [128, 64])
constexpr int kDqStageBytes = 2 * kKBoxBytes + 2 * kQBoxBytes;
// dk/dv: a stage is a Q, a dO, a V and a K box
constexpr int kDkvStageBytes = 4 * kKBoxBytes;
constexpr int kPtBytes = kTmaKv * kTmaKv * 4;

// The ring, K's chunk, a full barrier for each stage and the chunk's, the
// counts of warps done with each stage and with the chunk.
constexpr int tma_dq_smem_bytes() {
  return 1024 + kBwdStages * kDqStageBytes + kVBytes + 8 * (kBwdStages + 1) +
         4 * (kBwdStages + 1);
}

// The ring, the chunk of Q and of dO, p^T, a full barrier for each stage
// and the chunk's, p^T's full and empty ones, the counts.
constexpr int tma_dkv_smem_bytes() {
  return 1024 + kBwdStages * kDkvStageBytes + 2 * kVBytes + kPtBytes +
         8 * (kBwdStages + 3) + 4 * (kBwdStages + 1);
}

// What a block of the bf16 backward loads and where: the tensor maps; the
// ring's shared address (stage s kStageBytes s on) and the chunk's; the
// barriers (stage s's full barrier at bars + 8 s, the chunk's at bars + 8
// kBwdStages); the warps done with each stage and with the chunk, counted
// in done[] (the chunk's at done[kBwdStages]); the own tile's first row,
// the other axis' first row, the chunk's first column, the head; the boxes
// of D, the other axis' tiles, the chunk's boxes below D; the warpgroup.
struct BwdBlock {
  const CUtensorMap *q, *k, *v, *dout;
  uint32_t ring, chunk, bars;
  int* done;
  int own0, o_begin, c0, bh, nb, n_tiles, chunk_boxes, wg;
};

// Ring index idx (box idx % nb of the other axis' tile idx / nb) into
// stage idx % kBwdStages. dq: K's and V's box of the KV tile, dO's and Q's
// of the block's rows; dk/dv: Q's and dO's box of the Q tile, V's and K's
// of the block's rows.
template <bool kDq>
__device__ __forceinline__ void bwd_load_stage(const BwdBlock& t, int idx) {
  constexpr int kStageBytes = kDq ? kDqStageBytes : kDkvStageBytes;
  constexpr int kOwnBox = kDq ? kQBoxBytes : kKBoxBytes;
  const int slot = idx % kBwdStages, j = idx / t.nb, b = idx - j * t.nb;
  const uint32_t bar = t.bars + 8 * slot, st = t.ring + slot * kStageBytes;
  const int col = b * kBoxCols, o = t.o_begin + j * kTmaKv;
  mbar_expect_tx(bar, kStageBytes);
  tma_load(st, kDq ? t.k : t.q, bar, col, o, t.bh);
  tma_load(st + kKBoxBytes, kDq ? t.v : t.dout, bar, col, o, t.bh);
  tma_load(st + 2 * kKBoxBytes, kDq ? t.dout : t.v, bar, col, t.own0, t.bh);
  tma_load(st + 2 * kKBoxBytes + kOwnBox, kDq ? t.q : t.k, bar, col, t.own0,
           t.bh);
}

// The chunk's boxes below D of the other axis' tile j: dq K's, dk/dv Q's
// and then dO's (kVBytes on).
template <bool kDq>
__device__ __forceinline__ void bwd_load_chunk(const BwdBlock& t, int j) {
  const uint32_t bar = t.bars + 8 * kBwdStages;
  const int o = t.o_begin + j * kTmaKv;
  mbar_expect_tx(bar, (kDq ? 1 : 2) * t.chunk_boxes * kKBoxBytes);
  for (int h = 0; h < t.chunk_boxes; ++h) {
    tma_load(t.chunk + h * kKBoxBytes, kDq ? t.k : t.q, bar,
             t.c0 + h * kBoxCols, o, t.bh);
    if constexpr (!kDq)
      tma_load(t.chunk + kVBytes + h * kKBoxBytes, t.dout, bar,
               t.c0 + h * kBoxCols, o, t.bh);
  }
}

// This warp is done with ring index idx: the last warp refills its stage
// with idx + kBwdStages.
template <bool kDq>
__device__ __forceinline__ void bwd_done_box(const BwdBlock& t, int idx) {
  if (tma_last_done(t.done, idx % kBwdStages) &&
      idx + kBwdStages < t.nb * t.n_tiles)
    bwd_load_stage<kDq>(t, idx + kBwdStages);
}

// This warp is done with tile j's chunk: the last warp loads tile j + 1's.
template <bool kDq>
__device__ __forceinline__ void bwd_done_chunk(const BwdBlock& t, int j) {
  if (tma_last_done(t.done, kBwdStages) && j + 1 < t.n_tiles)
    bwd_load_chunk<kDq>(t, j + 1);
}

// Waits for ring index idx (box b of its tile) and issues its products as
// one wgmma group (box 0 overwrites the scores). dq: dp += do[:, box].v[:,
// box]^T and s += q[:, box].k[:, box]^T of the warpgroup's 64 rows; dk/dv:
// x += k[:, box].q[:, box]^T (s^T, warpgroup 0) or v[:, box].do[:, box]^T
// (dp^T, warpgroup 1), y untouched.
template <bool kDq>
__device__ __forceinline__ void bwd_issue_box(float (&x)[32], float (&y)[32],
                                              const BwdBlock& t, int idx,
                                              int b) {
  const int slot = idx % kBwdStages;
  mbar_wait(t.bars + 8 * slot, (idx / kBwdStages) & 1);
  if constexpr (kDq) {
    const uint32_t st = opaque(t.ring) + slot * kDqStageBytes;
    const uint32_t rows = t.wg * 64 * 128;  // the warpgroup's rows of a box
    const uint64_t dk = sw128_desc(st), dv = sw128_desc(st + kKBoxBytes);
    const uint64_t ddo = sw128_desc(st + 2 * kKBoxBytes + rows);
    const uint64_t dq = sw128_desc(st + 2 * kKBoxBytes + kQBoxBytes + rows);
#pragma unroll
    for (int kk = 0; kk < kBoxCols / 16; ++kk)
      wgmma_bf16_ss(x, ddo + 2 * kk, dv + 2 * kk, b | kk);
#pragma unroll
    for (int kk = 0; kk < kBoxCols / 16; ++kk)
      wgmma_bf16_ss(y, dq + 2 * kk, dk + 2 * kk, b | kk);
  } else {
    const uint32_t st = opaque(t.ring) + slot * kDkvStageBytes;
    const uint64_t da =
        sw128_desc(st + (t.wg == 0 ? 3 * kKBoxBytes : 2 * kKBoxBytes));
    const uint64_t db = sw128_desc(st + t.wg * kKBoxBytes);
#pragma unroll
    for (int kk = 0; kk < kBoxCols / 16; ++kk)
      wgmma_bf16_ss(x, da + 2 * kk, db + 2 * kk, b | kk);
  }
  wgmma_commit();
}

// The scores of the next tile of the other axis (its first box at ring
// index idx, which moves past the tile), a wgmma group a box, this warp
// done with each box once the next box's group is issued and its own is
// done; returns with the last box's group in flight (as tma_scores).
template <bool kDq>
__device__ __forceinline__ void bwd_scores(float (&x)[32], float (&y)[32],
                                           const BwdBlock& t, int& idx) {
  wgmma_fence();
  bwd_issue_box<kDq>(x, y, t, idx++, 0);
  for (int b = 1; b < t.nb; ++b) {
    bwd_issue_box<kDq>(x, y, t, idx++, b);
    wgmma_wait<1>();  // box b - 1 is read
    bwd_done_box<kDq>(t, idx - 2);
  }
}

// The block's TMA state and thread 0's first loads: the barriers, the
// first stages and tile 0's chunk. The own tile's first row, the other
// axis' first row and tiles as the kernel gives them; the chunk's buffer
// after the ring.
template <bool kDq>
__device__ __forceinline__ BwdBlock bwd_setup(
    const CUtensorMap* q, const CUtensorMap* k, const CUtensorMap* v,
    const CUtensorMap* dout, uint32_t ring, uint32_t bars, int* done,
    int own0, int o_begin, int n_tiles, int D) {
  constexpr int kStageBytes = kDq ? kDqStageBytes : kDkvStageBytes;
  const int c0 = blockIdx.x * kOutCols;
  const BwdBlock t{q,
                   k,
                   v,
                   dout,
                   ring,
                   ring + kBwdStages * kStageBytes,
                   bars,
                   done,
                   own0,
                   o_begin,
                   c0,
                   (int)blockIdx.z,
                   D / kBoxCols,
                   n_tiles,
                   min(kOutCols, D - c0) / kBoxCols,
                   (int)(threadIdx.x >> 7)};
  if (threadIdx.x == 0) {
    for (int s = 0; s <= kBwdStages; ++s) mbar_init(bars + 8 * s, 1);
    for (int s = 0; s <= kBwdStages; ++s) done[s] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < kBwdStages && i < t.nb * n_tiles; ++i)
      bwd_load_stage<kDq>(t, i);
    bwd_load_chunk<kDq>(t, 0);
  }
  return t;
}

// Stores a warpgroup's [64, kOutCols] accumulator as bf16: rows row and
// row + 8 below seq, the chunk's columns below D.
__device__ __forceinline__ void bwd_store(
    __nv_bfloat16* out, const float (&acc)[kOutCols / kBoxCols][32], int row,
    int c0, int tq, int seq, int D) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    if (rr >= seq) continue;
#pragma unroll
    for (int h = 0; h < kOutCols / kBoxCols; ++h) {
      const int col = c0 + h * kBoxCols;
      if (col >= D) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)rr * D + col +
                                           8 * j + 2 * tq) =
            __floats2bfloat162_rn(acc[h][4 * j + 2 * r],
                                  acc[h][4 * j + 2 * r + 1]);
    }
  }
}

// Replaces _bwd_dq_kernel (flash_attention.py:160) for bf16 head dims
// above 256. Per 64-row KV tile each warpgroup takes dp and s over the
// boxes of D, ds in registers, then dq[:, chunk] += ds.k[:, chunk] from
// the chunk's buffer. grid (chunks, 128-row Q tiles, BH), the longest
// rows first.
__global__ void __launch_bounds__(kTmaThreads, 1)
    flash_bwd_dq_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dq, int seq, int D,
                            float scale, int causal) {
  extern __shared__ uint8_t tma_smem[];
  uint8_t* base = align_1024(tma_smem);
  const uint32_t ring = smem_addr(base);
  const uint32_t bars = ring + kBwdStages * kDqStageBytes + kVBytes;
  const uint32_t chunk_full = bars + 8 * kBwdStages;
  int* done = reinterpret_cast<int*>(base + kBwdStages * kDqStageBytes +
                                     kVBytes + 8 * (kBwdStages + 1));
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTmaRows;
  const int n_kv = ((causal ? min(q0 + kTmaRows, seq) : seq) + kTmaKv - 1) /
                   kTmaKv;
  const BwdBlock t = bwd_setup<true>(&tm_q, &tm_k, &tm_v, &tm_do, ring, bars,
                                     done, q0, 0, n_kv, D);

  // warpgroup wg owns rows q0 + 64 wg .. + 63 and uses the first n_w KV
  // tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wg_row0 = q0 + t.wg * 64;
  const int row = wg_row0 + (warp & 3) * 16 + g;  // and row + 8
  const int n_w = causal ? (min(wg_row0 + 64, seq) + kTmaKv - 1) / kTmaKv
                         : n_kv;
  // p = exp(s scale - lse) = exp2(s scale log2(e) - lse log2(e))
  const float scale_log2 = scale * kLog2e;
  const size_t rbase = (size_t)t.bh * seq;
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    lse2[h] = r < seq ? lse[rbase + r] * kLog2e : 0.f;
    dl[h] = r < seq ? delta[rbase + r] : 0.f;
  }
  float acc[kOutCols / kBoxCols][32];
#pragma unroll
  for (int h = 0; h < kOutCols / kBoxCols; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  float dp[32], sc[32];
  uint32_t da[kTmaKv / 16][4];
  int idx = 0;  // ring index of the next box

  for (int it = 0; it < n_w; ++it) {
    bwd_scores<true>(dp, sc, t, idx);
    wgmma_wait<0>();
    fence_regs(dp);
    fence_regs(sc);
    bwd_done_box<true>(t, idx - 1);
    const int k0 = it * kTmaKv;
    // only a tile past S or across the diagonal has masked entries
    const bool masked = (causal && k0 + kTmaKv - 1 > wg_row0) ||
                        k0 + kTmaKv > seq;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1, col = k0 + 8 * j + 2 * tq + (i & 1);
        float p = exp2_ftz(fmaf(sc[4 * j + i], scale_log2, -lse2[h]));
        if (masked && ((causal && col > row + 8 * h) || col >= seq)) p = 0.f;
        sc[4 * j + i] = p * (dp[4 * j + i] - dl[h]) * scale;  // ds
      }
    tma_pack(da, sc);
    mbar_wait(chunk_full, it & 1);
    wgmma_fence();
    tma_pv(acc, da, t.chunk);  // dq[:, chunk] += ds.k[:, chunk]
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(da);
    bwd_done_chunk<true>(t, it);
  }
  // the boxes of the tile this warpgroup skips, each counted done once it
  // is in (only then is the stage's count that of this box)
  for (; idx < n_kv * t.nb; ++idx) {
    mbar_wait(t.bars + 8 * (idx % kBwdStages), (idx / kBwdStages) & 1);
    bwd_done_box<true>(t, idx);
  }
  bwd_store(dq + rbase * D, acc, row, t.c0, tq, seq, D);
}

// Replaces _bwd_dkv_kernel (flash_attention.py:212) for bf16 head dims
// above 256. Per 64-row Q tile warpgroup 0 takes s^T, p^T (written to
// shared memory for warpgroup 1) and dv[:, chunk] += p^T.do[:, chunk];
// warpgroup 1 dp^T, ds^T and dk[:, chunk] += ds^T.q[:, chunk]; one code
// path, the operands chosen by warpgroup (ptxas serializes wgmmas on
// divergent paths). grid (chunks, 64-row KV tiles, BH); under causal
// masking a KV tile's Q tiles start at its diagonal, so KV tile 0 has the
// most and runs first.
__global__ void __launch_bounds__(kTmaThreads, 1)
    flash_bwd_dkv_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int seq, int D,
                             float scale, int causal) {
  extern __shared__ uint8_t tma_smem[];
  uint8_t* base = align_1024(tma_smem);
  const uint32_t ring = smem_addr(base);
  // p^T: [32][128] f32, a thread's 32 values 128 words apart
  float* pt = reinterpret_cast<float*>(base + kBwdStages * kDkvStageBytes +
                                       2 * kVBytes);
  const uint32_t bars = smem_addr(pt) + kPtBytes;
  const uint32_t chunk_full = bars + 8 * kBwdStages;
  const uint32_t p_full = chunk_full + 8, p_empty = p_full + 8;
  int* done = reinterpret_cast<int*>(reinterpret_cast<uint8_t*>(pt) +
                                     kPtBytes + 8 * (kBwdStages + 3));
  const int k0 = blockIdx.y * kTmaKv;
  // Q tiles wholly before this KV tile see none of it under causal masking
  const int q_begin = causal ? k0 : 0;
  const int n_q = (seq - q_begin + kTmaKv - 1) / kTmaKv;
  if (threadIdx.x == 0) {
    mbar_init(p_full, kTcThreads);
    mbar_init(p_empty, kTcThreads);
  }
  const BwdBlock t = bwd_setup<false>(&tm_q, &tm_k, &tm_v, &tm_do, ring,
                                      bars, done, k0, q_begin, n_q, D);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int tw = threadIdx.x & (kTcThreads - 1);
  const int krow = k0 + (warp & 3) * 16 + g;  // and krow + 8
  const float scale_log2 = scale * kLog2e;
  // warpgroup 0 reads its Q columns' lse (in log2 units), 1 their delta
  const float* rows = (t.wg == 0 ? lse : delta) + (size_t)t.bh * seq;
  const float rows_scale = t.wg == 0 ? kLog2e : 1.f;
  float acc[kOutCols / kBoxCols][32];  // dv (warpgroup 0) or dk (1)
#pragma unroll
  for (int h = 0; h < kOutCols / kBoxCols; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  float x[32], rv[16];
  uint32_t pa[kTmaKv / 16][4];
  int idx = 0;  // ring index of the next box

  for (int j = 0; j < n_q; ++j) {
    const int q0 = q_begin + j * kTmaKv;
    // this thread's Q columns q0 + 8 n + 2 tq (+ 1), read under the scores
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = q0 + 8 * n + 2 * tq + e;
        rv[2 * n + e] = c < seq ? rows[c] * rows_scale : 0.f;
      }
    bwd_scores<false>(x, x, t, idx);
    wgmma_wait<0>();
    fence_regs(x);
    bwd_done_box<false>(t, idx - 1);
    if (t.wg == 0) {
      // only a tile past S or across the diagonal has masked entries (KV
      // rows past S are never stored, so they need no mask)
      const bool masked = (causal && q0 < k0 + kTmaKv - 1) ||
                          q0 + kTmaKv > seq;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = q0 + 8 * n + 2 * tq + (i & 1);
          float p =
              exp2_ftz(fmaf(x[4 * n + i], scale_log2, -rv[2 * n + (i & 1)]));
          if (masked && ((causal && c < krow + 8 * (i >> 1)) || c >= seq))
            p = 0.f;
          x[4 * n + i] = p;
        }
      mbar_wait(p_empty, (j & 1) ^ 1);
#pragma unroll
      for (int i = 0; i < 32; ++i) pt[i * kTcThreads + tw] = x[i];
      mbar_arrive(p_full);
    } else {
      mbar_wait(p_full, j & 1);
#pragma unroll
      for (int i = 0; i < 32; ++i)  // ds^T
        x[i] = pt[i * kTcThreads + tw] * (x[i] - rv[2 * (i >> 2) + (i & 1)]) *
               scale;
      mbar_arrive(p_empty);
    }
    tma_pack(pa, x);
    mbar_wait(chunk_full, j & 1);
    wgmma_fence();
    // dv[:, chunk] += p^T.do[:, chunk] or dk[:, chunk] += ds^T.q[:, chunk]
    tma_pv(acc, pa, t.chunk + (t.wg == 0 ? kVBytes : 0));
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    bwd_done_chunk<false>(t, j);
  }
  bwd_store((t.wg == 0 ? dv : dk) + (size_t)t.bh * seq * D, acc, krow, t.c0,
            tq, seq, D);
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda), in its
// CUDA 12 form; looked up once (C++11 makes the static's initialisation
// thread-safe, so two host threads may launch at once).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiledFn lookup_encode_tiled() {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                              &found) == cudaSuccess &&
      found == cudaDriverEntryPointSuccess)
    return reinterpret_cast<EncodeTiledFn>(p);
  return nullptr;
}

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = lookup_encode_tiled();
  return fn;
}

// A [BH, S, D] bf16 tensor as a 3-D tensor map with [box_rows x 64] boxes
// (one 128-byte swizzle row wide) in the 128-byte swizzle; rows past S
// read as zeros. -1 if the driver has no cuTensorMapEncodeTiled, -2 if it
// refuses the map.
int make_map(CUtensorMap* map, const void* ptr, int bh, int seq, int d,
             int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return -1;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)seq, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)seq * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kBoxCols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -2;
}

// -------------------------------------------------------------- launching

// The kernel (0 forward, 1 dk/dv, 2 dq, as in flash_attention.cu) for T,
// its dynamic shared memory, its threads a block and the output columns a
// block takes; nullptr for another kernel id. Every one is a wgmma kernel
// with kOutCols-column chunks: f32's a producer and a consumer warpgroup,
// bf16's two consumer warpgroups fed by TMA.
template <typename T>
const void* kernel_fn(int kernel, int* smem, int* threads, int* cols) {
  constexpr bool kF32 = std::is_same_v<T, float>;
  *threads = kF32 ? kWsThreads : kTmaThreads;
  *cols = kOutCols;
  switch (kernel) {
    case 0:
      if constexpr (kF32) {
        *smem = ws_smem_bytes();
        return (const void*)flash_fwd_ws_kernel;
      } else {
        *smem = tma_fwd_smem_bytes();
        return (const void*)flash_fwd_tma_kernel;
      }
    case 1:
      if constexpr (kF32) {
        *smem = ws_smem_bytes();
        return (const void*)flash_bwd_dkv_ws_kernel;
      } else {
        *smem = tma_dkv_smem_bytes();
        return (const void*)flash_bwd_dkv_tma_kernel;
      }
    case 2:
      if constexpr (kF32) {
        *smem = ws_smem_bytes();
        return (const void*)flash_bwd_dq_ws_kernel;
      } else {
        *smem = tma_dq_smem_bytes();
        return (const void*)flash_bwd_dq_tma_kernel;
      }
  }
  return nullptr;
}

// Raises the kernel's dynamic shared-memory limit to what it launches
// with; -3 for a head dim that is not a positive multiple of 64.
template <typename T>
int prepare(int kernel, int d, int* smem, int* threads, int* cols) {
  if (d <= 0 || d % kChunk) return -3;
  const void* fn = kernel_fn<T>(kernel, smem, threads, cols);
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

// (chunks, tiles of the own axis, BH): f32's dk/dv takes two blocks a
// chunk (dv's, dk's), bf16's forward and dq 128-row Q tiles
template <typename T>
dim3 grid_of(int kernel, int bh, int seq, int d, int cols) {
  const int rows = std::is_same_v<T, float> || kernel == 1 ? kTile : kTmaRows;
  const int tiles = (seq + rows - 1) / rows, chunks = (d + cols - 1) / cols;
  if (std::is_same_v<T, float>)
    return dim3(kernel == 1 ? 2 * chunks : chunks, tiles, bh);
  return dim3(chunks, tiles, bh);
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int seq, int d, float scale, int causal,
               void* stream) {
  int smem, threads, cols;
  const int e = prepare<T>(0, d, &smem, &threads, &cols);
  if (e != 0) return e;
  const dim3 grid = grid_of<T>(0, bh, seq, d, cols);
  if constexpr (std::is_same_v<T, float>) {
    flash_fwd_ws_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o,
        (float*)lse, seq, d, scale, causal);
  } else {
    CUtensorMap tq, tk, tv;
    int err = make_map(&tq, q, bh, seq, d, kTmaRows);
    if (err == 0) err = make_map(&tk, k, bh, seq, d, kTmaKv);
    if (err == 0) err = make_map(&tv, v, bh, seq, d, kTmaKv);
    if (err != 0) return err;
    flash_fwd_tma_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        tq, tk, tv, (T*)o, (float*)lse, seq, d, scale, causal);
  }
  return (int)cudaGetLastError();
}

// The four [BH, S, D] bf16 tensor maps of the backward: Q's and dO's with
// the boxes of dq's own 128 rows, or all of 64 rows for dk/dv.
int bwd_maps(CUtensorMap (&m)[4], const void* q, const void* k,
             const void* v, const void* dout, int bh, int seq, int d,
             int own_rows) {
  int err = make_map(&m[0], q, bh, seq, d, own_rows);
  if (err == 0) err = make_map(&m[1], k, bh, seq, d, kTmaKv);
  if (err == 0) err = make_map(&m[2], v, bh, seq, d, kTmaKv);
  if (err == 0) err = make_map(&m[3], dout, bh, seq, d, own_rows);
  return err;
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int seq,
              int d, float scale, int causal, void* stream) {
  int smem, threads, cols;
  const int e = prepare<T>(2, d, &smem, &threads, &cols);
  if (e != 0) return e;
  const dim3 grid = grid_of<T>(2, bh, seq, d, cols);
  if constexpr (std::is_same_v<T, float>) {
    flash_bwd_dq_ws_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)dout, (const float*)lse, (const float*)delta,
        (float*)dq, seq, d, scale, causal);
  } else {
    CUtensorMap m[4];
    const int err = bwd_maps(m, q, k, v, dout, bh, seq, d, kTmaRows);
    if (err != 0) return err;
    flash_bwd_dq_tma_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        m[0], m[1], m[2], m[3], (const float*)lse, (const float*)delta,
        (T*)dq, seq, d, scale, causal);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int seq, int d, float scale, int causal, void* stream) {
  int smem, threads, cols;
  const int e = prepare<T>(1, d, &smem, &threads, &cols);
  if (e != 0) return e;
  const dim3 grid = grid_of<T>(1, bh, seq, d, cols);
  if constexpr (std::is_same_v<T, float>) {
    flash_bwd_dkv_ws_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)dout, (const float*)lse, (const float*)delta,
        (float*)dk, (float*)dv, seq, d, scale, causal);
  } else {
    CUtensorMap m[4];
    const int err = bwd_maps(m, q, k, v, dout, bh, seq, d, kTmaKv);
    if (err != 0) return err;
    flash_bwd_dkv_tma_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        m[0], m[1], m[2], m[3], (const float*)lse, (const float*)delta,
        (T*)dk, (T*)dv, seq, d, scale, causal);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int attributes(int kernel, int* out) {
  int smem, threads, cols;
  const void* fn = kernel_fn<T>(kernel, &smem, &threads, &cols);
  if (fn == nullptr) return -3;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = smem;
  out[3] = (int)attr.localSizeBytes;
  const int p = prepare<T>(kernel, kChunk, &smem, &threads, &cols);
  if (p != 0) return p;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], fn,
                                                           threads, smem);
}

}  // namespace

extern "C" {

// bf16 and f32 at head dim d, a positive multiple of 64
int flash_fwd_bf16ds(const void* q, const void* k, const void* v, void* o,
                     void* lse, int bh, int seq, int d, float scale,
                     int causal, void* stream) {
  return launch_fwd<__nv_bfloat16>(q, k, v, o, lse, bh, seq, d, scale,
                                   causal, stream);
}

int flash_bwd_dq_bf16ds(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int bh, int seq, int d, float scale,
                        int causal, void* stream) {
  return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, bh, seq, d,
                                  scale, causal, stream);
}

int flash_bwd_dkv_bf16ds(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, int bh, int seq, int d,
                         float scale, int causal, void* stream) {
  return launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, bh,
                                   seq, d, scale, causal, stream);
}

int flash_fwd_f32ds(const void* q, const void* k, const void* v, void* o,
                    void* lse, int bh, int seq, int d, float scale,
                    int causal, void* stream) {
  return launch_fwd<float>(q, k, v, o, lse, bh, seq, d, scale, causal,
                           stream);
}

int flash_bwd_dq_f32ds(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, int bh, int seq, int d, float scale,
                       int causal, void* stream) {
  return launch_dq<float>(q, k, v, dout, lse, delta, dq, bh, seq, d, scale,
                          causal, stream);
}

int flash_bwd_dkv_f32ds(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int bh, int seq, int d,
                        float scale, int causal, void* stream) {
  return launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, bh, seq, d,
                           scale, causal, stream);
}

// Of the forward (0), dk/dv (1) or dq (2) in bf16 (bf16 != 0) or f32:
// out[0] registers a thread, out[1] its dynamic shared memory, out[2] the
// blocks that one SM holds at once with it, out[3] its local memory a
// thread in bytes (spills). Every head dim runs the same kernel. Returns
// a cudaError_t, or -3 for another kernel.
int flash_dsplit_kernel_attributes(int kernel, int bf16, int* out) {
  return bf16 ? attributes<__nv_bfloat16>(kernel, out)
              : attributes<float>(kernel, out);
}

}  // extern "C"
