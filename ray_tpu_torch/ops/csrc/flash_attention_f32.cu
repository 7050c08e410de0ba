// Flash attention for Hopper (sm_90a) in f32 at head dims 16-256: forward,
// dq and dk/dv, every product on the tensor cores as 3xTF32.
//
// They compute what the Pallas TPU kernels of ray_tpu/ops/flash_attention.py
// compute for f32 inputs:
//   flash_fwd_tc_kernel, flash_fwd_d256_tc_kernel
//                           <- _fwd_kernel      (flash_attention.py:29)
//   flash_bwd_dq_tc_kernel, flash_bwd_dq_d256_tc_kernel
//                           <- _bwd_dq_kernel   (flash_attention.py:160)
//   flash_bwd_dkv_tc_kernel, flash_bwd_dkv_d256_tc_kernel
//                           <- _bwd_dkv_kernel  (flash_attention.py:212)
// The first of each pair is a template on the head dim D (16-128), the
// second is head dim 256's. Sums, softmax and
// accumulators are f32, as are o, dq, dk, dv and lse (the Pallas kernels'
// casts of p and ds to the input type are no-ops in f32). Masked scores
// are -1e30, as in the Pallas kernels. The bf16 kernels, at every head
// dim, are flash_attention.cu's.
//
// Layout: q, k, v, o, do, dq, dk, dv are [BH, S, D] f32, contiguous and
// 16-byte aligned; lse and delta are [BH, S] f32. D is 16, 32, 64, 128 or
// 256; the wrapper pads any other D up with zero columns. A ragged S is masked
// at the tile edges: rows past S load as zeros, columns past S are
// masked, rows past S are not stored.
//
// What bounds them on an H100: at GPT-2-small's attention shape in f32
// (BH 192, S 1024, D 64, causal) the forward does 25.8 GFLOP, dq 38.7 and
// dk/dv 51.6 against ~0.2-0.3 GB of traffic, so they are bound by
// operations. The CUDA cores' f32 peak is 67 TFLOP/s; the tensor cores
// take TF32 (10 mantissa bits) at 495. One TF32 pass is not f32, but three
// are nearly: x = big + small with big = tf32(x), rounded to nearest, and
// small = x - big, and a.b is taken as big.big + big.small + small.big with
// f32 accumulation (the dropped small.small term and small's truncation to
// TF32 are ~2^-21 of a product). That is 495 / 3 = 165 TFLOP/s of
// f32-accurate products, 2.5x the FFMA peak; through mma.sync, which
// reaches ~310 TFLOP/s of TF32 on the card (scripts/mma_sync_rate.py),
// ~103.
//
// One design serves the templates: one 128-thread block a 64-row tile of
// its own axis (Q rows for the forward and dq, KV rows for dk/dv), 4 warps
// of 16 rows each. The other axis streams in tiles of 32 rows (16 at D
// 128) through a 2-stage cp.async ring, so the next tile loads under this
// one's products. Head dim 256 has kernels of its own, further down: dk/dv
// with 8 warps that split its products by output, the forward and dq on
// wgmma with a warpgroup that splits each K and V tile once for the block.
// Tiles sit in shared memory as raw f32, rows unpadded and XOR-swizzled
// so that all three fragment reads (tf32_mma.cuh) are free of bank
// conflicts; each fragment is split into big and small as it is read, in
// integer and FMA operations. Every product is mma.sync.m16n8k8 tf32:
// scores (q.k^T, do.v^T, or k.q^T, v.do^T in dk/dv) contract over D with
// the columns d, d + 1 of a pair read at once; the softmax, masks,
// exp(s - lse) and ds = p (dp - delta) scale happen in registers in the
// accumulator layout, which is the A operand's layout of the accumulating
// product (p.v; ds.k; p^T.do, ds^T.q) once its 8 columns are taken in the
// order 0, 2, 4, 6, 1, 3, 5, 7, so p and ds never leave registers. The
// tensor cores truncate as they accumulate, so big.big and the small terms
// accumulate apart and each tile's accumulating product starts from 0 (see
// tile_scores). Under causal masking whole future tiles are skipped, by
// the block and by each warp.
//
// The host entry points return cudaGetLastError() right after the launch,
// or -3 for a head dim the kernels are not built for.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"
#include "wgmma_tf32.cuh"

namespace {

// Rows of a streamed tile (the other axis): 32, 16 at D 128, where the
// accumulators of a 16 x 128 output a warp take 64 registers each.
template <int D>
constexpr int kStreamRows = D >= 128 ? 16 : 32;

// Blocks an SM is built for: registers stay under 65,536 / (128 x this).
template <int D>
constexpr int kMinBlocks = D >= 128 ? 2 : 3;

// ---------------------------------------------------------------- forward

template <int D>
constexpr int fwd_tc_smem_bytes() {
  return (kTile + 2 * 2 * kStreamRows<D>) * D * 4;
}

// Replaces _fwd_kernel (flash_attention.py:29). Bound at the main shape:
// 0.156 ms by 3xTF32 operations (two products per tile pair). One block
// a 64-row Q tile, which stays in shared memory; K and V tiles stream
// through the ring. Each warp keeps the online softmax of its 16 rows in
// registers, in the accumulator layout: a row's columns of one n-tile sit
// on the 4 threads of a quad, so its max over the tile is two shuffles
// after the thread's own max over all n-tiles, and l is the thread's share
// of the row sum until the end. Per KV tile: s = q.k^T (3xTF32), the mask
// where the tile crosses the diagonal or S, m and the rescale factor corr,
// p = exp2(s scale log2(e) - m scale log2(e)), o *= corr, then o += p.v
// (3xTF32, p as the A operand straight from the registers). At the end
// o = acc / max(l, 1e-30) and lse = m scale + log(l), as _fwd_kernel
// writes them. Q is split on every tile, as in dq: splitting it once into
// registers (64 more at D 64, so 2 blocks an SM, not 3) read ~1% faster
// on the card, inside the spread between runs (PERF.md).
template <int D>
__global__ void __launch_bounds__(kTcThreads, kMinBlocks<D>)
    flash_fwd_tc_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int seq, float scale,
                        int causal) {
  constexpr int BN = kStreamRows<D>, NT = BN / 8;
  extern __shared__ __align__(16) uint32_t tc_smem[];
  uint32_t* sq = tc_smem;
  uint32_t* ring = sq + kTile * D;  // [stage][k, v][BN rows]
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * kTile;
  const size_t base = (size_t)blockIdx.y * seq * D;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's rows in the tile
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;

  const int kv_end = causal ? min(seq, q0 + kTile) : seq;
  const int n_tiles = (kv_end + BN - 1) / BN;
  load_tile_async<D, kTile>(sq, q + base, q0, seq);
  load_tile_async<D, BN>(ring, k + base, 0, seq);
  load_tile_async<D, BN>(ring + BN * D, v + base, 0, seq);
  cp_async_commit();

  const float scale2 = scale * kLog2e;  // exp(x) = exp2(x log2(e))
  float m[2] = {kNegInf, kNegInf};  // running max of the raw scores
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    if (j + 1 < n_tiles) {  // the next tile loads under this one
      uint32_t* next = ring + ((j + 1) & 1) * 2 * BN * D;
      load_tile_async<D, BN>(next, k + base, k0 + BN, seq);
      load_tile_async<D, BN>(next + BN * D, v + base, k0 + BN, seq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t* sk = ring + (j & 1) * 2 * BN * D;
    const uint32_t* sv = sk + BN * D;
    // under causal masking a tile wholly after the warp's rows adds nothing
    if (!causal || k0 <= q0 + wr + 15) {
      float s[NT][4];
      tile_scores<D, NT, false>(s, sq, sk, wr);
      // only a tile past S or across the diagonal has masked entries
      const bool edge = k0 + BN > seq || (causal && k0 + BN - 1 > q0 + wr);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, row = q0 + wr + g + 8 * h,
                    col = k0 + 8 * n + 2 * t4 + (e & 1);
          if (edge && (col >= seq || (causal && col > row)))
            s[n][e] = kNegInf;
          mx[h] = fmaxf(mx[h], s[n][e]);
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
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2f(fmaf(s[n][e], scale2, -ms[e >> 1]));  // p
          sum[e >> 1] += s[n][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
      accumulate<D, NT>(acc, s, sv);  // o += p . v
    }
    __syncthreads();  // this stage is read: the next load may refill it
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    const float lc = fmaxf(quad_sum(l[h]), 1e-30f);
    if (row >= seq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(o + base + (size_t)row * D + 8 * n + 2 * t4, acc[n][2 * h] / lc,
             acc[n][2 * h + 1] / lc);
    if (t4 == 0) lse[(size_t)blockIdx.y * seq + row] = m[h] * scale + logf(lc);
  }
}

// --------------------------------------------------------- dq and dk/dv

template <int D>
constexpr int dq_tc_smem_bytes() {
  return (2 * kTile + 2 * 2 * kStreamRows<D>) * D * 4;
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, kMinBlocks<D>)
    flash_bwd_dq_tc_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, int seq, float scale,
                           int causal) {
  constexpr int BN = kStreamRows<D>, NT = BN / 8;
  extern __shared__ __align__(16) uint32_t tc_smem[];
  uint32_t* sq = tc_smem;
  uint32_t* sdo = sq + kTile * D;
  uint32_t* ring = sdo + kTile * D;  // [stage][k, v][BN rows]
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * kTile;
  const size_t base = (size_t)blockIdx.y * seq * D;
  const size_t rbase = (size_t)blockIdx.y * seq;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's rows in the tile
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;

  const int kv_end = causal ? min(seq, q0 + kTile) : seq;
  const int n_tiles = (kv_end + BN - 1) / BN;
  load_tile_async<D, kTile>(sq, q + base, q0, seq);
  load_tile_async<D, kTile>(sdo, dout + base, q0, seq);
  load_tile_async<D, BN>(ring, k + base, 0, seq);
  load_tile_async<D, BN>(ring + BN * D, v + base, 0, seq);
  cp_async_commit();

  // p = exp(s scale - lse) = exp2(s scale log2(e) - lse log2(e))
  const float scale2 = scale * kLog2e;
  float lse2[2], delta_r[2], acc[D / 8][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    lse2[h] = row < seq ? lse[rbase + row] * kLog2e : 0.f;
    delta_r[h] = row < seq ? delta[rbase + row] : 0.f;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    if (j + 1 < n_tiles) {  // the next tile loads under this one
      uint32_t* next = ring + ((j + 1) & 1) * 2 * BN * D;
      load_tile_async<D, BN>(next, k + base, k0 + BN, seq);
      load_tile_async<D, BN>(next + BN * D, v + base, k0 + BN, seq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t* sk = ring + (j & 1) * 2 * BN * D;
    const uint32_t* sv = sk + BN * D;
    // under causal masking a tile wholly after the warp's rows adds nothing
    if (!causal || k0 <= q0 + wr + 15) {
      float s[NT][4], dp[NT][4];
      tile_scores<D, NT, false>(s, sq, sk, wr);
      tile_scores<D, NT, true>(dp, sdo, sv, wr);
      // only a tile past S or across the diagonal has masked entries
      const bool edge = k0 + BN > seq || (causal && k0 + BN - 1 > q0 + wr);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, row = q0 + wr + g + 8 * h,
                    col = k0 + 8 * n + 2 * t4 + (e & 1);
          float p = exp2f(fmaf(s[n][e], scale2, -lse2[h]));
          if (edge && (col >= seq || (causal && col > row))) p = 0.f;
          s[n][e] = p * (dp[n][e] - delta_r[h]) * scale;  // ds
        }
      accumulate<D, NT>(acc, s, sk);  // dq += ds . k
    }
    __syncthreads();  // this stage is read: the next load may refill it
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    if (row >= seq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(dq + base + (size_t)row * D + 8 * n + 2 * t4, acc[n][2 * h],
             acc[n][2 * h + 1]);
  }
}

template <int D>
constexpr int dkv_tc_smem_bytes() {
  return (2 * kTile + 2 * 2 * kStreamRows<D>) * D * 4 +
         2 * 2 * kStreamRows<D> * 4;
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, kMinBlocks<D>)
    flash_bwd_dkv_tc_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int seq, float scale, int causal) {
  constexpr int BN = kStreamRows<D>, NT = BN / 8;
  extern __shared__ __align__(16) uint32_t tc_smem[];
  uint32_t* sk = tc_smem;
  uint32_t* sv = sk + kTile * D;
  uint32_t* ring = sv + kTile * D;  // [stage][q, do][BN rows]
  float* rows = reinterpret_cast<float*>(ring + 2 * 2 * BN * D);
  // rows: [stage][lse, delta][BN]
  const int k0 = blockIdx.x * kTile;  // the longest column runs come first
  const size_t base = (size_t)blockIdx.y * seq * D;
  const size_t rbase = (size_t)blockIdx.y * seq;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's KV rows in the tile
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  const float scale2 = scale * kLog2e;  // exp(x) = exp2(x log2(e))

  // Q tiles wholly before this KV tile see none of it under causal masking
  const int q_begin = causal ? k0 : 0;
  const int n_tiles = (seq - q_begin + BN - 1) / BN;
  load_tile_async<D, kTile>(sk, k + base, k0, seq);
  load_tile_async<D, kTile>(sv, v + base, k0, seq);
  load_tile_async<D, BN>(ring, q + base, q_begin, seq);
  load_tile_async<D, BN>(ring + BN * D, dout + base, q_begin, seq);
  load_rows_async(rows, lse + rbase, q_begin, BN, seq);
  load_rows_async(rows + BN, delta + rbase, q_begin, BN, seq);
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = q_begin + j * BN;
    if (j + 1 < n_tiles) {  // the next tile loads under this one
      const int nxt = (j + 1) & 1;
      uint32_t* next = ring + nxt * 2 * BN * D;
      load_tile_async<D, BN>(next, q + base, q0 + BN, seq);
      load_tile_async<D, BN>(next + BN * D, dout + base, q0 + BN, seq);
      load_rows_async(rows + nxt * 2 * BN, lse + rbase, q0 + BN, BN, seq);
      load_rows_async(rows + nxt * 2 * BN + BN, delta + rbase, q0 + BN, BN,
                      seq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t* sq = ring + (j & 1) * 2 * BN * D;
    const uint32_t* sdo = sq + BN * D;
    const float* slse = rows + (j & 1) * 2 * BN;
    const float* sdelta = slse + BN;
    // under causal masking a Q tile wholly before the warp's rows adds
    // nothing
    if (!causal || q0 + BN - 1 >= k0 + wr) {
      // transposed scores: rows are the warp's KV rows, columns Q rows
      float p[NT][4], ds[NT][4];
      tile_scores<D, NT, false>(p, sk, sq, wr);
      tile_scores<D, NT, true>(ds, sv, sdo, wr);
      // only a tile past S or across the diagonal has masked entries (KV
      // rows past S are never stored, so they need no mask)
      const bool edge = q0 + BN > seq || (causal && q0 < k0 + wr + 15);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int a = 8 * n + 2 * t4 + (e & 1), row = q0 + a,
                    col = k0 + wr + g + 8 * (e >> 1);
          float pe = exp2f(fmaf(p[n][e], scale2, -slse[a] * kLog2e));
          if (edge && (row >= seq || (causal && col > row))) pe = 0.f;
          ds[n][e] = pe * (ds[n][e] - sdelta[a]) * scale;
          p[n][e] = pe;
        }
      accumulate<D, NT>(dv_acc, p, sdo);  // dv += p^T . do
      accumulate<D, NT>(dk_acc, ds, sq);  // dk += ds^T . q
    }
    __syncthreads();  // this stage is read: the next load may refill it
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + wr + g + 8 * h;
    if (row >= seq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const size_t at = base + (size_t)row * D + 8 * n + 2 * t4;
      store2(dk + at, dk_acc[n][2 * h], dk_acc[n][2 * h + 1]);
      store2(dv + at, dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  }
}

// dk/dv at D 256: dk and dv of a 16 x 256 output a warp take 128
// accumulator registers a thread each, 256 together, past the cap of 255,
// so flash_bwd_dkv_tc_kernel's warp cannot hold both. Here a block of 8
// warps takes 64 KV rows, K and V resident (64 KB each), and splits the
// four products of a Q tile by output, as flash_bwd_dkv_d256_kernel of
// flash_attention.cu does with its warpgroups. Warp w < 4 computes
// s^T = k.q^T of its 16 KV rows, p^T and dv += p^T.do; warp w + 4, on the
// same rows, dp^T = v.do^T, ds^T = p^T.(dp^T - delta).scale and
// dk += ds^T.q, each warp with one 16 x 256 accumulator. p^T passes from
// warp w to warp w + 4 through shared memory: the two warps' fragments of
// a 16 x kDkv256Rows score tile sit on the same lanes, so each lane writes
// its values at [pair][i][lane] and the lane of the same number reads
// them back (a warp's 32 accesses of one i hit 32 banks), with a named
// barrier of the pair's 64 threads between (bar.arrive by the writer,
// bar.sync by the reader). 4 products a Q tile for the two passes' 5,
// eight warps an SM for four, and one launch. The Q/dO ring holds 2
// stages of kDkv256Rows rows: 1 __syncthreads a tile, after the tile has
// landed, guards both the ring and the exchange. 16-row Q tiles would
// halve the barriers and the A fragments' reads of the scores, but
// spilled 108 bytes a thread at the cap of 255 registers; 8 rows spill
// nothing.
constexpr int kDkv256Rows = 8;
constexpr int kDkv256Threads = 2 * kTcThreads;

constexpr int dkv256_tc_smem_bytes() {
  return (2 * kTile + 2 * 2 * kDkv256Rows) * 256 * 4 +
         2 * 2 * kDkv256Rows * 4 + kTcWarps * 16 * kDkv256Rows * 4;
}

// Replaces _bwd_dkv_kernel (flash_attention.py:212) for f32 head dims
// 129-256. Bound at B*H 48, S 1024, D 256, causal: 0.313 ms by 3xTF32
// operations (four products per tile pair), as at the main shape.
__global__ void __launch_bounds__(kDkv256Threads, 1)
    flash_bwd_dkv_d256_tc_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 const float* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 float* __restrict__ dk,
                                 float* __restrict__ dv, int seq,
                                 float scale, int causal) {
  constexpr int D = 256, BN = kDkv256Rows, NT = BN / 8;
  constexpr int kThreads = kDkv256Threads;
  extern __shared__ __align__(16) uint32_t tc_smem[];
  uint32_t* sk = tc_smem;
  uint32_t* sv = sk + kTile * D;
  uint32_t* ring = sv + kTile * D;  // [stage][q, do][BN rows]
  float* rows = reinterpret_cast<float*>(ring + 2 * 2 * BN * D);
  // rows: [stage][lse, delta][BN]
  float* xp = rows + 2 * 2 * BN;  // p^T: [pair][NT * 4][32 lanes]
  const int k0 = blockIdx.x * kTile;  // the longest column runs come first
  const size_t base = (size_t)blockIdx.y * seq * D;
  const size_t rbase = (size_t)blockIdx.y * seq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = warp % kTcWarps;  // warps pair and pair + 4: one KV slab
  const bool dv_warp = warp < kTcWarps;
  const int wr = pair * 16;  // the pair's KV rows in the tile
  const int g = lane >> 2, t4 = lane & 3;
  const float scale2 = scale * kLog2e;  // exp(x) = exp2(x log2(e))
  float* x_slot = xp + pair * NT * 4 * 32 + lane;  // + 32 i

  // Q tiles wholly before this KV tile see none of it under causal masking
  const int q_begin = causal ? k0 : 0;
  const int n_tiles = (seq - q_begin + BN - 1) / BN;
  auto load_stage = [&](int j) {
    const int q0 = q_begin + j * BN;
    uint32_t* st = ring + (j & 1) * 2 * BN * D;
    float* r = rows + (j & 1) * 2 * BN;
    load_tile_async<D, BN, kThreads>(st, q + base, q0, seq);
    load_tile_async<D, BN, kThreads>(st + BN * D, dout + base, q0, seq);
    load_rows_async<kThreads>(r, lse + rbase, q0, BN, seq);
    load_rows_async<kThreads>(r + BN, delta + rbase, q0, BN, seq);
  };
  load_tile_async<D, kTile, kThreads>(sk, k + base, k0, seq);
  load_tile_async<D, kTile, kThreads>(sv, v + base, k0, seq);
  load_stage(0);
  cp_async_commit();

  float acc[D / 8][4];  // dv (warps 0-3) or dk (warps 4-7)
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = q_begin + j * BN;
    cp_async_wait<0>();  // tile j, issued under tile j - 1
    // tile j is visible to all, and all are done with tile j - 1: its
    // stage may be refilled and the exchange rewritten
    __syncthreads();
    if (j + 1 < n_tiles) {
      load_stage(j + 1);
      cp_async_commit();
    }
    const uint32_t* sq = ring + (j & 1) * 2 * BN * D;
    const uint32_t* sdo = sq + BN * D;
    const float* slse = rows + (j & 1) * 2 * BN;
    const float* sdelta = slse + BN;
    // under causal masking a Q tile wholly before the pair's rows adds
    // nothing; both warps of a pair skip it, so neither waits on the other
    if (causal && q0 + BN - 1 < k0 + wr) continue;
    // only a tile past S or across the diagonal has masked entries (KV
    // rows past S are never stored, so they need no mask)
    const bool edge = q0 + BN > seq || (causal && q0 < k0 + wr + 15);
    float x[NT][4];  // transposed: rows are the pair's KV rows, columns Q
    if (dv_warp) {
      tile_scores<D, NT, false>(x, sk, sq, wr);  // s^T = k . q^T
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int a = 8 * n + 2 * t4 + (e & 1), row = q0 + a,
                    col = k0 + wr + g + 8 * (e >> 1);
          float pe = exp2f(fmaf(x[n][e], scale2, -slse[a] * kLog2e));
          if (edge && (row >= seq || (causal && col > row))) pe = 0.f;
          x[n][e] = pe;
          x_slot[32 * (4 * n + e)] = pe;
        }
      named_arrive(1 + pair, 64);
      accumulate<D, NT>(acc, x, sdo);  // dv += p^T . do
    } else {
      tile_scores<D, NT, true>(x, sv, sdo, wr);  // dp^T = v . do^T
      named_sync(1 + pair, 64);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int a = 8 * n + 2 * t4 + (e & 1);
          x[n][e] = x_slot[32 * (4 * n + e)] * (x[n][e] - sdelta[a]) * scale;
        }
      accumulate<D, NT>(acc, x, sq);  // dk += ds^T . q
    }
  }
  float* out = dv_warp ? dv : dk;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + wr + g + 8 * h;
    if (row >= seq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(out + base + (size_t)row * D + 8 * n + 2 * t4, acc[n][2 * h],
             acc[n][2 * h + 1]);
  }
}

// ------------------------------------------- head dim 256 on wgmma
//
// The forward and dq at D 256 (flash_fwd_d256_tc_kernel,
// flash_bwd_dq_d256_tc_kernel). The templates above spend ~1,500
// instructions a warp a tile there on fragment loads and big/small splits
// around 192 mma.sync, at ~0.3 IPC, each of four warps splitting the same
// K and V fragments again. Here the products are wgmma and each K and V
// element is split once a block. A block is two warpgroups: warpgroup 0,
// the consumer, owns 64 Q rows and issues every product; warpgroup 1, the
// producer, streams kD256Rows-row K and V tiles from device memory into
// registers (two tiles ahead), splits each element into big and small,
// and writes both into a single shared-memory stage for each of K and V,
// guarded by mbarriers (full: all 128 producer threads have written the
// tile and fenced it for the async proxy; empty: the consumer's four
// warps are done with it).
//
// tf32 wgmma reads shared-memory operands K-major only (the transpose bits
// exist for 16-bit types alone), so each product takes the form whose B
// operand is K-major as it lies in shared memory:
//   * s = q.k^T and dp = do.v^T, m64n16k8, B = the split K or V tile:
//     eight 128-byte-swizzled slabs of 32 columns, each the tile's 16 big
//     rows then its 16 small ones, the byte geometry of a bf16 tile's 64
//     columns in flash_attention.cu (a k-step of 8 tf32 is 32 bytes, as
//     one of 16 bf16). a_frag takes columns c, c + 1 of a k-step (c = 8 kk
//     + 2 t) as k indices t, t + 4, so every split tile holds column 8 kk
//     + o at k position (o >> 1) | ((o & 1) << 2) (split_at). The forward
//     splits Q into shared memory the same way when it starts (split_q)
//     and takes A from there (scores_ss); dq has no room for Q and dO both
//     split, keeps them raw (Layout<256>) and loads and splits A per
//     k-step in registers (scores_rs), at ~4x the cost a k-step;
//   * the consumer writes p or ds split into shared memory as [64 Q rows,
//     16 KV] (one 128-byte row a Q row, half of it used; x_at). The forward
//     takes o += p.v with both operands there (accumulate_pv, m64n32k8 a
//     chunk of 32 head-dim columns): A = p, B = v^T, which its producer
//     writes transposed, [256 rows, 16 KV] in 64-byte rows and the 64-byte
//     swizzle (vt_at). dq has no room for K both ways and takes dq^T +=
//     k^T.ds^T (accumulate_t, m64n32k8 a 64-row block of the head dim and
//     32 Q columns): A = k^T read by each thread from the split K tile
//     (already big and small), B = ds; dq^T sits transposed in registers
//     (a thread holds 16 Q columns of it) and is stored so (store_t).
// The order of accumulation is the templates': big.big and the small
// terms in accumulators of their own, dp's big.big restarting from 0 every
// two k-steps, and every tile's o or dq product from 0 in two temporaries
// a block half, added to the output in f32.
//
// Registers of a consumer thread: o or dq^T 128; in the forward's scores s
// and its two small terms 24; in dq's, s or dp 8, the small terms 8, dp's
// restart parts 16 and two buffers of A fragments 16; in the accumulating
// products big and small 16 + 16 (the forward's two chunks in flight, 64)
// and dq's A fragments 16. dq still meets the cap of 255, so its consumer
// keeps dp (while s is taken) and its rows' lse and delta in shared memory
// (kDqStash). Shared memory: forward 1024 (alignment) + Q split 128 KB +
// K split 32 KB + V transposed 32 KB + p split 16 KB + 4 barriers =
// 214,048 bytes; dq 1024 + Q and dO 128 KB + K and V split 64 KB + ds
// split 16 KB + the stash 6 KB + 4 barriers = 220,192 bytes: one block an
// SM.

constexpr int kD256Threads = 2 * kTcThreads;  // two warpgroups: consumer,
                                              // then producer
constexpr int kD256Rows = 16;                 // KV rows of a streamed tile
// A split K or V tile: eight slabs of 32 columns, each [2 kD256Rows rows,
// 128 bytes], the tile's big rows then its small ones (kSmallWords on).
constexpr int kSlabBytes = 2 * kD256Rows * 128;
constexpr int kSmallWords = kD256Rows * kSlabCols;
constexpr int kKvTileBytes = 8 * kSlabBytes;
// One half (big or small) of the forward's split Q tile: eight slabs of
// [kTile rows, 128 bytes].
constexpr int kQSlabBytes = kTile * 128;
constexpr int kQSplitBytes = 8 * kQSlabBytes;
// A split [kTile, kD256Rows] p or ds tile takes kXSplitBytes a half
// (wgmma_tf32.cuh), half of each 128-byte row used.

// The forward's V tile, transposed: [256 head-dim rows, kD256Rows KV
// columns] a half, 64-byte rows in the 64-byte swizzle (vt_at), big then
// small (kVtSmallWords on).
constexpr int kVtSmallWords = 256 * kD256Rows;

constexpr int fwd256_tc_smem_bytes() {
  return 1024 + 2 * kQSplitBytes + kKvTileBytes + 2 * kVtSmallWords * 4 +
         2 * kXSplitBytes + 4 * 8;
}

// dq's per-thread stash: each consumer thread's dp while s is taken, and
// its rows' lse and delta, one word a value at a stride of kTcThreads
constexpr int kDqStash = 12;

constexpr int dq256_tc_smem_bytes() {
  return 1024 + 2 * kTile * 256 * 4 + 2 * kKvTileBytes + 2 * kXSplitBytes +
         kDqStash * kTcThreads * 4 + 4 * 8;
}

// d[64 x 16] (+)= A.B in TF32: A one k-step's fragments in registers
// (mma.sync's m16n8k8 tf32 A layout, a 16-row slab a warp), B [16 of N, 8
// of K] read K-major through a descriptor; acc = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_n16(float (&d)[8],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// wgmma shared-memory descriptor of a tile of 64-byte rows in the 64-byte
// swizzle (layout type 2): 8-row groups 512 bytes apart; a K-major k-step
// (8 tf32, 32 bytes) is +2.
__device__ __forceinline__ uint64_t sw64_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

// d[64 x 32] (+)= A.B in TF32, as wgmma_tf32_n16 with 32 columns.
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// Word of element (r, c) of a split tile whose slabs hold kRows rows: a K
// or V tile (the default: r < kD256Rows a row's big half and kD256Rows +
// r its small half) or one half of the forward's Q tile (kTile rows). Slab
// c / 32 at kRows * 128 bytes, row r at 128 bytes, k-step (c % 32) / 8 at
// 32 bytes, column o = c % 8 at k position (o >> 1) | ((o & 1) << 2)
// (a_frag's order), the 16-byte chunks XORed by r % 8 (the swizzle).
template <int kRows = 2 * kD256Rows>
__device__ __forceinline__ int split_at(int r, int c) {
  const int f = (c & 24) | ((c >> 1) & 3) | ((c & 1) << 2);
  return (c >> 5) * (kRows * kSlabCols) + r * kSlabCols +
         (((f >> 2) ^ (r & 7)) << 2) + (f & 3);
}

// Word of element (d, kv) of one half of the forward's transposed V tile:
// row d at 64 bytes, kv in natural order, the 16-byte chunks XORed by
// (d / 2) % 4 (the 64-byte swizzle: address bits 4-5 ^= bits 7-8).
__device__ __forceinline__ int vt_at(int d, int kv) {
  return d * kD256Rows + (((kv >> 2) ^ ((d >> 1) & 3)) << 2) + (kv & 3);
}

// The producer's share of a K or V tile: thread i of warpgroup 1 takes row
// i % 16, columns 8 (i / 16 + 8 u) to + 7 for u < 4, so that the eight
// lanes of a quarter warp write eight rows of one column group, eight
// distinct chunks of the swizzle.
struct RawTile {
  float4 x[4][2];
};

// This thread's share of rows [r0, r0 + kD256Rows) of one head's [seq,
// 256] matrix; rows past seq as zeros.
__device__ __forceinline__ void load_raw(RawTile& t, const float* src,
                                         int r0, int seq, int i) {
  const int r = i & 15;
  const bool valid = r0 + r < seq;
  const float4* row =
      reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * 256);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int c4 = 2 * ((i >> 4) + 8 * u);  // the column group's float4
#pragma unroll
    for (int h = 0; h < 2; ++h)
      t.x[u][h] = valid ? __ldg(row + c4 + h) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Splits the share into big and small and writes them to one stage (big at
// big, small kSmallWords on): k positions 0-3 of a column group take its
// columns 0, 2, 4, 6, positions 4-7 columns 1, 3, 5, 7.
__device__ __forceinline__ void store_split(uint32_t* big, const RawTile& t,
                                            int i) {
  uint32_t* small = big + kSmallWords;
  const int r = i & 15;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int c0 = 8 * ((i >> 4) + 8 * u);
    const float4 a = t.x[u][0], b = t.x[u][1];
    const float lo[4] = {a.x, a.z, b.x, b.z}, hi[4] = {a.y, a.w, b.y, b.w};
    const Tf32<4> fl = split(lo), fh = split(hi);
    const int at_lo = split_at(r, c0), at_hi = split_at(r, c0 + 1);
    *reinterpret_cast<uint4*>(big + at_lo) =
        make_uint4(fl.big[0], fl.big[1], fl.big[2], fl.big[3]);
    *reinterpret_cast<uint4*>(big + at_hi) =
        make_uint4(fh.big[0], fh.big[1], fh.big[2], fh.big[3]);
    *reinterpret_cast<uint4*>(small + at_lo) =
        make_uint4(fl.small[0], fl.small[1], fl.small[2], fl.small[3]);
    *reinterpret_cast<uint4*>(small + at_hi) =
        make_uint4(fh.small[0], fh.small[1], fh.small[2], fh.small[3]);
  }
}

// As store_split, into the forward's transposed V tile: element (row r,
// column c) at vt_at(c, r), one word at a time.
__device__ __forceinline__ void store_split_t(uint32_t* big, const RawTile& t,
                                              int i) {
  const int r = i & 15;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int c0 = 8 * ((i >> 4) + 8 * u);
    const float x[8] = {t.x[u][0].x, t.x[u][0].y, t.x[u][0].z, t.x[u][0].w,
                        t.x[u][1].x, t.x[u][1].y, t.x[u][1].z, t.x[u][1].w};
    const Tf32<8> f = split(x);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int at = vt_at(c0 + e, r);
      big[at] = f.big[e];
      big[kVtSmallWords + at] = f.small[e];
    }
  }
}

// The forward's Q tile, rows [q0, q0 + kTile) of one head's [seq, 256]
// matrix (rows past seq as zeros), split into big (at big) and small
// (kQSplitBytes on), by all threads of the block: thread i takes row i %
// 64 and column groups i / 64 + 4 u, so the eight lanes of a quarter warp
// write eight rows of one group.
__device__ __forceinline__ void split_q(uint32_t* big, const float* src,
                                        int q0, int seq) {
  uint32_t* small = big + kQSplitBytes / 4;
  const int r = threadIdx.x & 63;
  const bool valid = q0 + r < seq;
  const float4* row =
      reinterpret_cast<const float4*>(src + (size_t)(q0 + r) * 256);
#pragma unroll 2
  for (int u = 0; u < 8; ++u) {
    const int c0 = 8 * ((threadIdx.x >> 6) + 4 * u);
    const float4 a = valid ? __ldg(row + c0 / 4) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 b =
        valid ? __ldg(row + c0 / 4 + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float lo[4] = {a.x, a.z, b.x, b.z}, hi[4] = {a.y, a.w, b.y, b.w};
    const Tf32<4> fl = split(lo), fh = split(hi);
    const int at_lo = split_at<kTile>(r, c0), at_hi = split_at<kTile>(r, c0 + 1);
    *reinterpret_cast<uint4*>(big + at_lo) =
        make_uint4(fl.big[0], fl.big[1], fl.big[2], fl.big[3]);
    *reinterpret_cast<uint4*>(big + at_hi) =
        make_uint4(fh.big[0], fh.big[1], fh.big[2], fh.big[3]);
    *reinterpret_cast<uint4*>(small + at_lo) =
        make_uint4(fl.small[0], fl.small[1], fl.small[2], fl.small[3]);
    *reinterpret_cast<uint4*>(small + at_hi) =
        make_uint4(fh.small[0], fh.small[1], fh.small[2], fh.small[3]);
  }
}

// Warpgroup 1: for each tile j, the first operand's tile (K in the
// forward, V in dq) then the second's (transposed with kSecondT: the
// forward's V) go into their stages once the consumer has released the
// tile before (a stage's full barrier at bars, its empty one at bars +
// 8). The rows of the next two tiles of each are
// in flight in registers (a0/b0 even tiles, a1/b1 odd ones): tile j + 2
// loads right after tile j is stored, so a load has two of the
// consumer's tiles to land.
template <bool kSecondT>
__device__ __forceinline__ void produce_d256(const float* first,
                                             const float* second,
                                             uint32_t* s_first,
                                             uint32_t* s_second,
                                             uint32_t first_bars,
                                             uint32_t second_bars,
                                             int n_tiles, int seq) {
  const int i = threadIdx.x - kTcThreads;
  RawTile a0, b0, a1, b1;
  load_raw(a0, first, 0, seq, i);
  load_raw(b0, second, 0, seq, i);
  load_raw(a1, first, kD256Rows, seq, i);
  load_raw(b1, second, kD256Rows, seq, i);
  auto step = [&](RawTile& a, RawTile& b, int j) {
    const uint32_t parity = (j & 1) ^ 1;  // tile j - 1's release
    mbar_wait(first_bars + 8, parity);
    store_split(s_first, a, i);
    fence_proxy_async();
    mbar_arrive(first_bars);
    if (j + 2 < n_tiles) load_raw(a, first, (j + 2) * kD256Rows, seq, i);
    mbar_wait(second_bars + 8, parity);
    if constexpr (kSecondT)
      store_split_t(s_second, b, i);
    else
      store_split(s_second, b, i);
    fence_proxy_async();
    mbar_arrive(second_bars);
    if (j + 2 < n_tiles) load_raw(b, second, (j + 2) * kD256Rows, seq, i);
  };
  for (int j = 0; j < n_tiles; j += 2) {
    step(a0, b0, j);
    if (j + 1 < n_tiles) step(a1, b1, j + 1);
  }
}

// s[64 x kD256Rows] = a.b^T of the consumer warpgroup, contracted over D
// = 256 as 3xTF32, with a from registers (dq, whose Q and dO cannot both
// sit in shared memory split): a the raw [64, 256] Q or dO tile
// (Layout<256>), whose fragments are loaded and split a k-step at a time
// into two buffers, a buffer rewritten only once the k-step that read it
// is done (wgmma_wait<1> before the next k-step's loads; two k-steps a
// buffer ran 4% faster but spilled at the cap of 255 registers); b the
// split K or V tile at shared address sb, its big rows and its small ones
// kSmallWords on. big.big and the small terms accumulate apart; with
// kRestart (dp) big.big restarts from 0 every two k-steps (pair p into
// part[p % 2]), each pair's part added to s in f32 once its k-steps are
// done. The addresses pass through opaque() each k-step, so that they are
// computed where they are used.
template <bool kRestart>
__device__ __forceinline__ void scores_rs(float (&s)[8], const uint32_t* a,
                                          uint32_t sb) {
  using L = Layout<256>;
  constexpr int kSteps = 256 / 8;
  const int row = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
  const int t4 = threadIdx.x & 3;
  float small[8], part[2][8];
  Tf32<4> fa[2];
  auto add_pair = [&](int pair) {
    fence_regs(part[pair & 1]);
#pragma unroll
    for (int e = 0; e < 8; ++e) s[e] += part[pair & 1][e];
  };
  if constexpr (kRestart) {
#pragma unroll
    for (int e = 0; e < 8; ++e) s[e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int b = kk & 1;
    if (kk >= 2) {
      wgmma_wait<1>();  // k-step kk - 2, which read buffer b, is done
      // and so is pair kk / 2 - 2, whose part pair kk / 2 is about to reuse
      if constexpr (kRestart) {
        if ((kk & 1) == 0 && kk >= 4) add_pair((kk >> 1) - 2);
      }
    }
    fa[b] = a_frag<L>(opaque(a), row, 8 * kk + 2 * t4);
    const uint32_t at = opaque(sb) + (kk >> 2) * kSlabBytes + (kk & 3) * 32;
    const uint64_t big = sw128_desc(at),
                   sml = sw128_desc(at + kSmallWords * 4);
    wgmma_fence();
    if constexpr (kRestart)
      wgmma_tf32_n16(part[(kk >> 1) & 1], fa[b].big, big, kk & 1);
    else
      wgmma_tf32_n16(s, fa[b].big, big, kk);
    wgmma_tf32_n16(small, fa[b].big, sml, kk);
    wgmma_tf32_n16(small, fa[b].small, big, 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(small);
  if constexpr (kRestart) {
    add_pair(kSteps / 2 - 2);
    add_pair(kSteps / 2 - 1);
  } else {
    fence_regs(s);
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] += small[e];
}

// s[64 x kD256Rows] = q.k^T of the consumer warpgroup over D = 256 as
// 3xTF32 with both operands split in shared memory (the forward): q's big
// half at sq, its small half kQSplitBytes on; k the split K tile at sk,
// its small rows kSmallWords on. With no register operand nothing waits
// between products: the 96 issue back to back, in three chains (big.big,
// big.small, small.big) added in f32 at the end. The addresses pass
// through opaque() each k-step, as in scores_rs.
__device__ __forceinline__ void scores_ss(float (&s)[8], uint32_t sq,
                                          uint32_t sk) {
  float bs[8], sb[8];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 256 / 8; ++kk) {
    const uint32_t qa = opaque(sq) + (kk >> 2) * kQSlabBytes + (kk & 3) * 32;
    const uint32_t ka = opaque(sk) + (kk >> 2) * kSlabBytes + (kk & 3) * 32;
    const uint64_t qb = sw128_desc(qa), qs = sw128_desc(qa + kQSplitBytes);
    const uint64_t kb = sw128_desc(ka), ks = sw128_desc(ka + kSmallWords * 4);
    wgmma_ss_tf32_n16(s, qb, kb, kk);
    wgmma_ss_tf32_n16(bs, qb, ks, kk);
    wgmma_ss_tf32_n16(sb, qs, kb, kk);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(bs);
  fence_regs(sb);
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] += bs[e] + sb[e];
}

// acc^T[256 x 64] of the consumer warpgroup += x^T.p^T over a tile's
// kD256Rows KV rows, as 3xTF32: x the split K or V tile at sx (words), read
// as the A operand x^T, already big and small, at each 64-row block mb of
// the head dim; p the split [64, kD256Rows] p or ds tile at shared address
// sp, the B operand. A block's product goes in two halves of 32 Q columns
// nh (m64n32k8), each from 0 with big.big and the small terms apart in
// 16 + 16 temporaries (64-column halves would take 32 + 32, past what the
// 128 accumulator registers leave), and epi(acc[mb], nh, big, small) adds
// it in f32.
template <typename Epi>
__device__ __forceinline__ void accumulate_t(float (&acc)[4][32],
                                             const uint32_t* sx, uint32_t sp,
                                             Epi epi) {
  const int w16 = (threadIdx.x >> 5) * 16, g = (threadIdx.x & 31) >> 2;
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int mb = 0; mb < 4; ++mb) {
    // A fragments of x^T: rows d, d + 8 of the block (head-dim columns of
    // x), k indices t, t + 4 of k-step ks (KV rows 8 ks + t, + 4)
    const uint32_t* x = opaque(sx);
    const int d = 64 * mb + w16 + g;
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int r = 8 * ks + t4;
      const int at[4] = {split_at(r, d), split_at(r, d + 8),
                         split_at(r + 4, d), split_at(r + 4, d + 8)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ab[ks][e] = x[at[e]];
        as[ks][e] = x[kSmallWords + at[e]];
      }
    }
#pragma unroll
    for (int nh = 0; nh < 2; ++nh) {
      // B: Q rows 32 nh on, 4096 bytes a half
      const uint32_t pa = opaque(sp) + 4096 * nh;
      const uint64_t pb = sw128_desc(pa), ps = sw128_desc(pa + kXSplitBytes);
      float big[16], small[16];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        wgmma_tf32_n32(big, ab[ks], pb + 2 * ks, ks);
        wgmma_tf32_n32(small, ab[ks], ps + 2 * ks, ks);
        wgmma_tf32_n32(small, as[ks], pb + 2 * ks, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(big);
      fence_regs(small);
      epi(acc[mb], nh, big, small);
    }
  }
}

// Stores acc^T (dq^T) into rows q0 + col of a head's [seq, 256] out, this
// thread's head-dim rows 64 mb + wr + g, + 8 and Q columns col = 8 j + 2 t,
// + 1; rows past seq are not stored.
__device__ __forceinline__ void store_t(float* out, const float (&acc)[4][32],
                                        int q0, int seq) {
  const int w16 = (threadIdx.x >> 5) * 16, g = (threadIdx.x & 31) >> 2;
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = 8 * j + 2 * t4 + c;
      if (q0 + col >= seq) continue;
      float* dst = out + (size_t)(q0 + col) * 256 + w16 + g;
#pragma unroll
      for (int mb = 0; mb < 4; ++mb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          dst[64 * mb + 8 * h] = acc[mb][4 * j + 2 * h + c];
        }
    }
}

// o[64 x 256] of the consumer warpgroup = o.corr + p.v over a tile's
// kD256Rows KV rows, as 3xTF32 with both operands in shared memory: A = p,
// the split [64, kD256Rows] tile at sp (K-major, x_at); B = v^T, the
// transposed split V tile at svt (K-major, vt_at). o goes in eight chunks
// of 32 head-dim columns (m64n32k8), each from 0 with big.big and the
// small terms apart, a chunk issued before the one before it is waited
// for and added: o[c] = o[c].corr + (big + small), rows g and g + 8.
__device__ __forceinline__ void accumulate_pv(float (&o)[8][16], uint32_t sp,
                                              uint32_t svt,
                                              const float (&corr)[2]) {
  float big[2][16], small[2][16];
  auto issue = [&](int c) {
    const uint64_t pb = sw128_desc(opaque(sp)),
                   ps = sw128_desc(opaque(sp) + kXSplitBytes);
    const uint32_t vt = opaque(svt) + 32 * 64 * c;  // rows 32 c on
    const uint64_t vb = sw64_desc(vt), vs = sw64_desc(vt + 4 * kVtSmallWords);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kD256Rows / 8; ++ks) {
      wgmma_ss_tf32_n32(big[c & 1], pb + 2 * ks, vb + 2 * ks, ks);
      wgmma_ss_tf32_n32(small[c & 1], pb + 2 * ks, vs + 2 * ks, ks);
      wgmma_ss_tf32_n32(small[c & 1], ps + 2 * ks, vb + 2 * ks, 1);
    }
    wgmma_commit();
  };
  auto add = [&](int c) {
    fence_regs(big[c & 1]);
    fence_regs(small[c & 1]);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      o[c][i] = o[c][i] * corr[(i >> 1) & 1] + (big[c & 1][i] + small[c & 1][i]);
  };
  issue(0);
#pragma unroll
  for (int c = 1; c < 8; ++c) {
    issue(c);
    wgmma_wait<1>();  // chunk c - 1
    add(c - 1);
  }
  wgmma_wait<0>();
  add(7);
}

// Replaces _fwd_kernel (flash_attention.py:29) for f32 head dims 129-256.
// Bound at B*H 48, S 1024, D 256, causal: 0.156 ms by 3xTF32 operations
// (two products per tile pair). The whole block splits its Q tile into
// shared memory first. Per KV tile the consumer takes s = q.k^T, releases
// K, runs the online softmax of its 64 rows in the scores' layout (m and
// l as in flash_fwd_tc_kernel), writes p split, then o = o.corr + p.v
// (accumulate_pv) and releases V. At the end o = acc / max(l, 1e-30) and
// lse = m scale + log(l), as _fwd_kernel writes them.
__global__ void __launch_bounds__(kD256Threads, 1)
    flash_fwd_d256_tc_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             float* __restrict__ o, float* __restrict__ lse,
                             int seq, float scale, int causal) {
  constexpr int D = 256, BN = kD256Rows;
  extern __shared__ uint8_t d256_smem[];
  uint32_t* sq = reinterpret_cast<uint32_t*>(align_1024(d256_smem));
  uint32_t* sk = sq + 2 * kQSplitBytes / 4;  // Q split: big, then small
  uint32_t* svt = sk + kKvTileBytes / 4;     // split K, then V transposed
  uint32_t* sp = svt + 2 * kVtSmallWords;    // p: big, then small
  const uint32_t k_bars = smem_addr(sp + 2 * kXSplitBytes / 4);  // full, empty
  const uint32_t v_bars = k_bars + 16;
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * kTile;
  const size_t base = (size_t)blockIdx.y * seq * D;
  const int kv_end = causal ? min(seq, q0 + kTile) : seq;
  const int n_tiles = (kv_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(k_bars, kTcThreads);
    mbar_init(k_bars + 8, kTcWarps);
    mbar_init(v_bars, kTcThreads);
    mbar_init(v_bars + 8, kTcWarps);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  split_q(sq, q + base, q0, seq);
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x >= kTcThreads) {
    produce_d256<true>(k + base, v + base, sk, svt, k_bars, v_bars, n_tiles,
                       seq);
    return;
  }

  const int wr = (threadIdx.x >> 5) * 16;  // the warp's rows in the tile
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  const float scale2 = scale * kLog2e;  // exp(x) = exp2(x log2(e))
  const uint32_t sq_at = smem_addr(sq), sk_at = smem_addr(sk);
  const uint32_t svt_at = smem_addr(svt), sp_at = smem_addr(sp);
  float m[2] = {kNegInf, kNegInf};  // running max of the raw scores
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  float acc[8][16];                 // o, 32 head-dim columns a chunk
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[c][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    float s[8];
    mbar_wait(k_bars, j & 1);
    scores_ss(s, opaque(sq_at), opaque(sk_at));
    release_stage(k_bars);
    // only a tile past S or across the diagonal has masked entries
    const bool edge = k0 + BN > seq || (causal && k0 + BN - 1 > q0 + wr);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int h = (i >> 1) & 1, row = q0 + wr + g + 8 * h,
                col = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      if (edge && (col >= seq || (causal && col > row))) s[i] = kNegInf;
      mx[h] = fmaxf(mx[h], s[i]);
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
    for (int i = 0; i < 8; ++i) {
      s[i] = exp2f(fmaf(s[i], scale2, -ms[(i >> 1) & 1]));  // p
      sum[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
    store_x<kD256Rows>(sp, s);
    fence_proxy_async();
    named_sync(1, kTcThreads);  // p is written
    mbar_wait(v_bars, j & 1);
    accumulate_pv(acc, sp_at, svt_at, corr);
    release_stage(v_bars);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    const float lc = fmaxf(quad_sum(l[h]), 1e-30f);
    if (row >= seq) continue;
    if (t4 == 0) lse[(size_t)blockIdx.y * seq + row] = m[h] * scale + logf(lc);
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        store2(o + base + (size_t)row * D + 32 * c + 8 * jj + 2 * t4,
               acc[c][4 * jj + 2 * h] / lc, acc[c][4 * jj + 2 * h + 1] / lc);
  }
}

// Replaces _bwd_dq_kernel (flash_attention.py:160) for f32 head dims
// 129-256. Bound at B*H 48, S 1024, D 256, causal: 0.2345 ms by 3xTF32
// operations (three products per tile pair). Per KV tile the consumer
// takes dp = do.v^T first and releases V, so that the producer refills V
// under the rest of the tile, then s = q.k^T, ds = p.(dp - delta).scale
// with p recomputed from lse, writes ds split, and dq^T += k^T.ds^T from
// the same K stage, then releases K.
__global__ void __launch_bounds__(kD256Threads, 1)
    flash_bwd_dq_d256_tc_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                float* __restrict__ dq, int seq, float scale,
                                int causal) {
  constexpr int D = 256, BN = kD256Rows;
  extern __shared__ uint8_t d256_smem[];
  uint32_t* sq = reinterpret_cast<uint32_t*>(align_1024(d256_smem));
  uint32_t* sdo = sq + kTile * D;
  uint32_t* sk = sdo + kTile * D;          // split K
  uint32_t* sv = sk + kKvTileBytes / 4;    // split V
  uint32_t* sds = sv + kKvTileBytes / 4;   // ds: big, then small
  float* stash = reinterpret_cast<float*>(sds + 2 * kXSplitBytes / 4);
  const uint32_t k_bars = smem_addr(stash + kDqStash * kTcThreads);
  const uint32_t v_bars = k_bars + 16;
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * kTile;
  const size_t base = (size_t)blockIdx.y * seq * D;
  const size_t rbase = (size_t)blockIdx.y * seq;
  const int kv_end = causal ? min(seq, q0 + kTile) : seq;
  const int n_tiles = (kv_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(k_bars, kTcThreads);
    mbar_init(k_bars + 8, kTcWarps);
    mbar_init(v_bars, kTcThreads);
    mbar_init(v_bars + 8, kTcWarps);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  load_tile_async<D, kTile, kD256Threads>(sq, q + base, q0, seq);
  load_tile_async<D, kTile, kD256Threads>(sdo, dout + base, q0, seq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (threadIdx.x >= kTcThreads) {
    produce_d256<false>(v + base, k + base, sv, sk, v_bars, k_bars, n_tiles,
                        seq);
    return;
  }

  const int wr = (threadIdx.x >> 5) * 16;  // the warp's rows in the tile
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  // p = exp(s scale - lse) = exp2(s scale log2(e) - lse log2(e))
  const float scale2 = scale * kLog2e;
  // The consumer is at the cap of 255 registers: its rows' lse and delta
  // wait in the stash (values 8-11), and so does dp (0-7) while s is
  // taken; each thread reads back only what it wrote.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    stash[(8 + h) * kTcThreads + threadIdx.x] =
        row < seq ? lse[rbase + row] * kLog2e : 0.f;
    stash[(10 + h) * kTcThreads + threadIdx.x] =
        row < seq ? delta[rbase + row] : 0.f;
  }
  // the shared-memory tiles, by word, from one opaque() base a tile
  constexpr int kDoW = kTile * D, kKW = 2 * kTile * D;
  constexpr int kVW = kKW + kKvTileBytes / 4, kDsW = kVW + kKvTileBytes / 4;
  constexpr int kStashW = kDsW + 2 * kXSplitBytes / 4;
  float acc[4][32];  // dq^T
#pragma unroll
  for (int mb = 0; mb < 4; ++mb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mb][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    float s[8];
    const uint32_t* t = opaque(sq);
    const uint32_t t_at = smem_addr(t);
    float* st = reinterpret_cast<float*>(const_cast<uint32_t*>(t) + kStashW) +
                threadIdx.x;
    mbar_wait(v_bars, j & 1);
    scores_rs<true>(s, t + kDoW, t_at + 4 * kVW);  // dp
    release_stage(v_bars);
#pragma unroll
    for (int i = 0; i < 8; ++i) st[i * kTcThreads] = s[i];
    mbar_wait(k_bars, j & 1);
    scores_rs<false>(s, t, t_at + 4 * kKW);
    // only a tile past S or across the diagonal has masked entries
    const bool edge = k0 + BN > seq || (causal && k0 + BN - 1 > q0 + wr);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int h = (i >> 1) & 1, row = q0 + wr + g + 8 * h,
                col = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      float p = exp2f(fmaf(s[i], scale2, -st[(8 + h) * kTcThreads]));
      if (edge && (col >= seq || (causal && col > row))) p = 0.f;
      s[i] = p * (st[i * kTcThreads] - st[(10 + h) * kTcThreads]) *
             scale;  // ds
    }
    store_x<kD256Rows>(const_cast<uint32_t*>(t) + kDsW, s);
    fence_proxy_async();
    named_sync(1, kTcThreads);  // ds is written
    accumulate_t(acc, t + kKW, t_at + 4 * kDsW,
                 [](float (&a)[32], int nh, const float (&big)[16],
                    const float (&small)[16]) {
#pragma unroll
                   for (int k = 0; k < 16; ++k)
                     a[16 * nh + k] += big[k] + small[k];
                 });
    release_stage(k_bars);
  }
  // base again, from an opaque() head index, so that it is not held in
  // registers through the loop
  store_t(dq + (size_t)opaque(blockIdx.y) * seq * D, acc, q0, seq);
}

// -------------------------------------------------------------- launching

// f(std::integral_constant<int, D>) for a head dim the kernels are built
// for (16, 32, 64, 128, 256); -3 for another.
template <typename F>
int with_head_dim(int d, F f) {
  switch (d) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
    case 256: return f(std::integral_constant<int, 256>());
    default: return -3;
  }
}

// The kernel (0 forward, 1 dk/dv, 2 dq, as in flash_attention.cu) at head
// dim D (head dim 256's own kernels at 256), its dynamic shared memory and
// its threads a block; nullptr for another kernel id.
template <int D>
const void* kernel_fn(int kernel, int* smem, int* threads) {
  *threads = kTcThreads;
  if constexpr (D == 256) {
    switch (kernel) {
      case 0:
        *smem = fwd256_tc_smem_bytes();
        *threads = kD256Threads;
        return (const void*)flash_fwd_d256_tc_kernel;
      case 1:
        *smem = dkv256_tc_smem_bytes();
        *threads = kDkv256Threads;
        return (const void*)flash_bwd_dkv_d256_tc_kernel;
      case 2:
        *smem = dq256_tc_smem_bytes();
        *threads = kD256Threads;
        return (const void*)flash_bwd_dq_d256_tc_kernel;
    }
  } else {
    switch (kernel) {
      case 0:
        *smem = fwd_tc_smem_bytes<D>();
        return (const void*)flash_fwd_tc_kernel<D>;
      case 1:
        *smem = dkv_tc_smem_bytes<D>();
        return (const void*)flash_bwd_dkv_tc_kernel<D>;
      case 2:
        *smem = dq_tc_smem_bytes<D>();
        return (const void*)flash_bwd_dq_tc_kernel<D>;
    }
  }
  return nullptr;
}

// Raises the kernel's dynamic shared-memory limit to what it launches with.
template <int D>
cudaError_t prepare(int kernel, int* smem, int* threads) {
  const void* fn = kernel_fn<D>(kernel, smem, threads);
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *smem);
}

int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int seq, int d, float scale, int causal,
               void* stream) {
  return with_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    int smem, threads;
    const cudaError_t e = prepare<D>(0, &smem, &threads);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((seq + kTile - 1) / kTile, bh);
    auto fn = [] {
      if constexpr (D == 256)
        return flash_fwd_d256_tc_kernel;
      else
        return flash_fwd_tc_kernel<D>;
    }();
    fn<<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o,
        (float*)lse, seq, scale, causal);
    return (int)cudaGetLastError();
  });
}

int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int seq,
              int d, float scale, int causal, void* stream) {
  return with_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    int smem, threads;
    const cudaError_t e = prepare<D>(2, &smem, &threads);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((seq + kTile - 1) / kTile, bh);
    auto fn = [] {
      if constexpr (D == 256)
        return flash_bwd_dq_d256_tc_kernel;
      else
        return flash_bwd_dq_tc_kernel<D>;
    }();
    fn<<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
        (const float*)lse, (const float*)delta, (float*)dq, seq, scale,
        causal);
    return (int)cudaGetLastError();
  });
}

int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int seq, int d, float scale, int causal, void* stream) {
  return with_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    int smem, threads;
    const cudaError_t e = prepare<D>(1, &smem, &threads);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((seq + kTile - 1) / kTile, bh);
    auto fn = [] {
      if constexpr (D == 256)
        return flash_bwd_dkv_d256_tc_kernel;
      else
        return flash_bwd_dkv_tc_kernel<D>;
    }();
    fn<<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
        (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, seq,
        scale, causal);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// f32 at head dim d (16, 32, 64, 128 or 256)
int flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                  void* lse, int bh, int seq, int d, float scale, int causal,
                  void* stream) {
  return launch_fwd(q, k, v, o, lse, bh, seq, d, scale, causal, stream);
}

int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int bh, int seq, int d, float scale,
                     int causal, void* stream) {
  return launch_dq(q, k, v, dout, lse, delta, dq, bh, seq, d, scale, causal,
                   stream);
}

int flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int bh, int seq, int d, float scale,
                      int causal, void* stream) {
  return launch_dkv(q, k, v, dout, lse, delta, dk, dv, bh, seq, d, scale,
                    causal, stream);
}

// Of the forward (0), dk/dv (1) or dq (2) at head dim d: out[0] registers
// a thread, out[1] its dynamic shared memory, out[2] the blocks that one
// SM holds at once with it, out[3] its local memory a thread in bytes
// (spills). Returns a cudaError_t, or -3 for another kernel or head dim.
int flash_f32_kernel_attributes(int kernel, int d, int* out) {
  return with_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    int smem, threads;
    const void* fn = kernel_fn<D>(kernel, &smem, &threads);
    if (fn == nullptr) return -3;
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, fn);
    if (e != cudaSuccess) return (int)e;
    out[0] = attr.numRegs;
    out[1] = smem;
    out[3] = (int)attr.localSizeBytes;
    e = prepare<D>(kernel, &smem, &threads);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], fn, threads,
                                                        smem);
    return (int)e;
  });
}

}  // extern "C"
