// Flash attention for Hopper (sm_90a) at head dims above 256: forward, dq
// and dk/dv, each block computing one 64-column chunk of its output's head
// dim, in bf16 and in f32.
//
// They compute what the Pallas TPU kernels of ray_tpu/ops/flash_attention.py
// compute, at any head dim:
//   flash_fwd_dsplit_kernel      <- _fwd_kernel      (flash_attention.py:29)
//   flash_bwd_dq_dsplit_kernel   <- _bwd_dq_kernel   (flash_attention.py:160)
//   flash_bwd_dkv_dsplit_kernel  <- _bwd_dkv_kernel  (flash_attention.py:212)
// each a template on the input type T (bf16 or f32). Sums, the softmax and
// lse are f32; o, dq, dk and dv are written in T. In bf16, p (forward and
// dv) and ds (dq and dk) are rounded to bf16 before the products that take
// them, as the bf16 Pallas kernels cast them (flash_attention.py:196-199).
//
// Layout: q, k, v, o, do, dq, dk, dv are [BH, S, D] in T, contiguous and
// 16-byte aligned, D a multiple of 64 (the wrapper pads any other head dim
// with zero columns, which add nothing to q.k^T or do.v^T); lse and delta
// are [BH, S] f32. A ragged S is masked at the tile edges as in
// flash_attention_f32.cu.
//
// Why the head dim is split: the other kernels keep a [rows, D] f32
// accumulator in registers, which at D 320 would take 160 registers a
// thread for one 64-row tile of 4 warps, and no limit on D would hold. Here
// a block owns a 64-row tile of its own axis (Q rows for the forward and
// dq, KV rows for dk/dv) and one 64-column chunk of the output (grid z),
// so its accumulators are 16 x 64 a warp (dk/dv: two) at every D. The
// scores still contract over the whole head dim, so a block streams q and
// k (and do and v) through shared memory in 64-column steps, summing each
// step's product into s, and only then takes the softmax, the mask and
// the accumulating product with its own chunk's columns. Every chunk's
// block computes s in the same order, so the chunks of a row see the same
// p bit for bit, and lse is written by chunk 0's block only. The price is
// that the scores are computed once for each of the D / 64 chunks: a
// forward does (D / 64 + 1) products of a tile pair where one block with
// the whole row would do 2, dq 2 D / 64 + 1 for 3, dk/dv 2 D / 64 + 2 for
// 4 (at D 512: 9 / 2, 17 / 3 and 18 / 4 times the work). No kernel holds
// more than a 64-column step of any row, so shared memory does not grow
// with D either.
//
// Products: mma.sync on tiles loaded by cp.async into a two-stage ring,
// so that the next step's loads run under this step's products. In f32
// every product is 3xTF32 m16n8k8 on tiles in tf32_mma.cuh's layout, as
// in flash_attention_f32.cu, and every 64-column step's product starts
// from 0 and is added to s in f32. In bf16 every product is m16n8k16 on
// raw bf16 tiles (fragments by ldmatrix, .trans for the accumulating
// product's B) with f32 sums, p and ds packed to bf16 as its A operand.
//
// What bounds them on an H100: at B*H 24, S 1024, D 512, causal the
// forward's two products are 25.8 GFLOP (bf16: 0.026 ms at 989 TFLOP/s;
// f32: 0.156 ms at 3xTF32's 165) against 101 MB of traffic in bf16 (0.030
// ms), so the bf16 forward is bound by bytes and the rest by operations;
// the recomputed scores above are work the bound does not count. What
// holds them far from it is traffic from L2: a 64-column step reads a
// 64-row tile of the block's own axis again for every tile of the other
// axis and every chunk, for a few products a warp (PERF.md).
//
// The host entry points return cudaGetLastError() right after the launch,
// or -3 for a head dim that is not a positive multiple of 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

// head-dim columns of a step, and of an output chunk
constexpr int kChunk = 64;
using CL = Layout<kChunk>;  // a 64-column step or chunk of a tile
// Rows of the other axis a step streams: each step reads the block's
// own 64-row tile again, so more rows a step mean less traffic, up to
// what the registers hold without spilling. bf16: 128 for the forward,
// 64 for dq and dk/dv, which hold two score tiles; f32, whose 3xTF32
// scores take three accumulators: 32, 32 and 16.
constexpr bool kBf16(int bytes) { return bytes == 2; }
template <typename T>
constexpr int kFwdRows = kBf16(sizeof(T)) ? 128 : 32;
template <typename T>
constexpr int kDqRows = kBf16(sizeof(T)) ? 64 : 32;
template <typename T>
constexpr int kDkvRows = kBf16(sizeof(T)) ? 64 : 16;

// 4-byte words of one 64-column row of a tile in shared memory
template <typename T>
constexpr int kRowWords = kChunk * (int)sizeof(T) / 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// four 8 x 8 matrices of 16-bit values from shared memory, lane l giving
// the address of row l % 8 of matrix l / 8 (.trans: each transposed)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a.b for a 16 x 16 bf16 A (row-major) and a 16 x 8 bf16 B
// (column-major), f32 sums; the accumulator layout is mma_tf32's
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// What differs between the input types: how a tile is laid out and
// loaded into shared memory, how one 64-column step's scores and an
// accumulating product are taken (in bf16, p and ds rounded to bf16 as
// they are packed into its A operand), and how a pair of outputs is
// stored.
template <typename T>
struct Io;

// f32: tiles as tf32_mma.cuh lays them out, every product 3xTF32; each
// step's scores start from 0 and are added to s in f32
template <>
struct Io<float> {
  // rows [r0, r0 + kRows) and columns [c0, c0 + 64) of one head's [seq, ld]
  // matrix; rows past seq as zeros
  template <int kRows>
  static __device__ __forceinline__ void load(uint32_t* dst, const float* src,
                                              int r0, int c0, int seq,
                                              int ld) {
    constexpr int kChunks = kChunk / 4;  // 16-byte copies a row
    for (int i = threadIdx.x; i < kRows * kChunks; i += kTcThreads) {
      const int r = i / kChunks, ch = i % kChunks;
      const bool valid = r0 + r < seq;
      cp_async16(dst + CL::chunk(r, ch),
                 src + (size_t)(valid ? r0 + r : 0) * ld + c0 + ch * 4,
                 valid);
    }
  }
  // s[16 x 8 NT] += a[16 rows from `row`] . b[8 NT rows]^T over one step
  template <bool kRestart, int NT>
  static __device__ __forceinline__ void scores(float (&s)[NT][4],
                                                const uint32_t* a,
                                                const uint32_t* b, int row) {
    float part[NT][4];
    tile_scores<kChunk, NT, kRestart>(part, a, b, row);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += part[n][e];
  }
  // acc[16 x 64] += x[16 x 8 NT] . tile[8 NT x 64], x in the accumulator
  // layout
  template <int NT>
  static __device__ __forceinline__ void accumulate(
      float (&acc)[kChunk / 8][4], const float (&x)[NT][4],
      const uint32_t* tile) {
    ::accumulate<kChunk, NT>(acc, x, tile);
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

// bf16: tiles raw, 128 bytes a row with its 16-byte chunks XOR-swizzled
// by the row, so that the 8 rows of an ldmatrix hit 8 distinct chunks of
// banks; every product bf16 mma.sync m16n8k16 with f32 sums, p and ds
// rounded to bf16 as the A operand is packed
template <>
struct Io<__nv_bfloat16> {
  // element (r, c) of a tile, c a multiple of 8 (one 16-byte chunk)
  static __device__ __forceinline__ int at(int r, int c) {
    return r * kChunk + ((((c >> 3) ^ r) & 7) << 3);
  }
  template <int kRows>
  static __device__ __forceinline__ void load(uint32_t* dst,
                                              const __nv_bfloat16* src,
                                              int r0, int c0, int seq,
                                              int ld) {
    constexpr int kChunks = kChunk / 8;  // 16-byte copies a row
    auto* t = reinterpret_cast<__nv_bfloat16*>(dst);
    for (int i = threadIdx.x; i < kRows * kChunks; i += kTcThreads) {
      const int r = i / kChunks, ch = i % kChunks;
      const bool valid = r0 + r < seq;
      cp_async16(reinterpret_cast<uint32_t*>(t + at(r, 8 * ch)),
                 src + (size_t)(valid ? r0 + r : 0) * ld + c0 + ch * 8,
                 valid);
    }
  }
  template <bool kRestart, int NT>
  static __device__ __forceinline__ void scores(float (&s)[NT][4],
                                                const uint32_t* a,
                                                const uint32_t* b, int row) {
    static_assert(NT % 2 == 0, "B fragments load two n-tiles at a time");
    const auto* A = reinterpret_cast<const __nv_bfloat16*>(a);
    const auto* B = reinterpret_cast<const __nv_bfloat16*>(b);
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks) {
      uint32_t fa[4];  // rows row..row+15, columns 16 ks..16 ks+15
      ldsm_x4(fa, A + at(row + (lane & 15), 16 * ks + 8 * (lane >> 4)));
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t fb[4];  // b rows 8 n..8 n+15: two n-tiles
        ldsm_x4(fb, B + at(8 * n + (lane & 7) + 8 * (lane >> 4),
                           16 * ks + 8 * ((lane >> 3) & 1)));
        mma_bf16(s[n], fa, fb[0], fb[1]);
        mma_bf16(s[n + 1], fa, fb[2], fb[3]);
      }
    }
  }
  template <int NT>
  static __device__ __forceinline__ void accumulate(
      float (&acc)[kChunk / 8][4], const float (&x)[NT][4],
      const uint32_t* tile) {
    static_assert(NT % 2 == 0, "a k-step takes two n-tiles of x");
    const auto* V = reinterpret_cast<const __nv_bfloat16*>(tile);
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      const uint32_t a[4] = {pack_bf16(x[j][0], x[j][1]),
                             pack_bf16(x[j][2], x[j][3]),
                             pack_bf16(x[j + 1][0], x[j + 1][1]),
                             pack_bf16(x[j + 1][2], x[j + 1][3])};
#pragma unroll
      for (int n = 0; n < kChunk / 8; n += 2) {
        uint32_t fb[4];  // tile rows 8 j..8 j+15, columns 8 n..8 n+15
        ldsm_x4_t(fb, V + at(8 * j + (lane & 7) + 8 * ((lane >> 3) & 1),
                             8 * n + 8 * (lane >> 4)));
        mma_bf16(acc[n], a, fb[0], fb[1]);
        mma_bf16(acc[n + 1], a, fb[2], fb[3]);
      }
    }
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a,
                                                float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

// ---------------------------------------------------------------- forward

// a stage: [Q 64 rows, K kFwdRows rows] of one 64-column step; then V's
// rows of the block's chunk, a buffer for each of two K/V tiles
template <typename T>
constexpr int kFwdStage = (kTile + kFwdRows<T>) * kRowWords<T>;
template <typename T>
constexpr int fwd_smem_bytes() {
  return (2 * kFwdStage<T> + 2 * kFwdRows<T> * kRowWords<T>) * 4;
}

// Replaces _fwd_kernel for head dims above 256. Per K/V tile: s = q.k^T
// over all of D in 64-column steps, then the online softmax of
// flash_attention_f32.cu's flash_fwd_tc_kernel and o[:, chunk] += p.v[:,
// chunk]. grid (Q tiles, BH, D / 64).
template <typename T>
__global__ void __launch_bounds__(kTcThreads, 2)
    flash_fwd_dsplit_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o,
                            float* __restrict__ lse, int seq, int D,
                            float scale, int causal) {
  constexpr int BN = kFwdRows<T>, NT = BN / 8;
  constexpr int W = kRowWords<T>;  // words a tile row
  extern __shared__ __align__(16) uint32_t ds_smem[];
  uint32_t* ring = ds_smem;
  uint32_t* vbuf = ring + 2 * kFwdStage<T>;
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * kTile;
  const int c_out = blockIdx.z * kChunk;
  const size_t base = (size_t)blockIdx.y * seq * D;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's rows in the tile
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;

  const int nc = D / kChunk;
  const int kv_end = causal ? min(seq, q0 + kTile) : seq;
  const int n_steps = (kv_end + BN - 1) / BN * nc;
  auto load_step = [&](int i) {
    const int j = i / nc, c = i % nc;
    uint32_t* st = ring + (i & 1) * kFwdStage<T>;
    Io<T>::template load<kTile>(st, q + base, q0, c * kChunk, seq, D);
    Io<T>::template load<BN>(st + kTile * W, k + base, j * BN,
                             c * kChunk, seq, D);
    if (c == 0)
      Io<T>::template load<BN>(vbuf + (j & 1) * BN * W, v + base,
                               j * BN, c_out, seq, D);
  };
  load_step(0);
  cp_async_commit();

  const float scale2 = scale * kLog2e;  // exp(x) = exp2(x log2(e))
  float m[2] = {kNegInf, kNegInf};  // running max of the raw scores
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  float s[NT][4], acc[kChunk / 8][4];
#pragma unroll
  for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    const int j = i / nc, c = i % nc, k0 = j * BN;
    if (i + 1 < n_steps) {  // the next step loads under this one
      load_step(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // under causal masking a tile wholly after the warp's rows adds nothing
    if (!causal || k0 <= q0 + wr + 15) {
      if (c == 0) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      }
      const uint32_t* st = ring + (i & 1) * kFwdStage<T>;
      Io<T>::template scores<false>(s, st, st + kTile * W, wr);
      if (c == nc - 1) {
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
        for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
        Io<T>::accumulate(acc, s, vbuf + (j & 1) * BN * W);
      }
    }
    __syncthreads();  // this stage is read: the next load may refill it
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    const float lc = fmaxf(quad_sum(l[h]), 1e-30f);
    if (row >= seq) continue;
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n)
      Io<T>::store2(o + base + (size_t)row * D + c_out + 8 * n + 2 * t4,
                    acc[n][2 * h] / lc, acc[n][2 * h + 1] / lc);
    if (blockIdx.z == 0 && t4 == 0)
      lse[(size_t)blockIdx.y * seq + row] = m[h] * scale + logf(lc);
  }
}

// --------------------------------------------------------------------- dq

// a stage: [Q 64, dO 64, K kDqRows, V kDqRows rows] of one 64-column step;
// then K's rows of the block's chunk, a buffer for each of two K/V tiles
template <typename T>
constexpr int kDqStage = (2 * kTile + 2 * kDqRows<T>) * kRowWords<T>;
template <typename T>
constexpr int dq_smem_bytes() {
  return (2 * kDqStage<T> + 2 * kDqRows<T> * kRowWords<T>) * 4;
}

// Replaces _bwd_dq_kernel for head dims above 256. Per K/V tile: s = q.k^T
// and dp = do.v^T over all of D, p = exp(s scale - lse), ds = p (dp -
// delta) scale, rounded to k's type, then dq[:, chunk] += ds.k[:, chunk].
// grid (Q tiles, BH, D / 64).
template <typename T>
__global__ void __launch_bounds__(kTcThreads, 2)
    flash_bwd_dq_dsplit_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const T* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               T* __restrict__ dq, int seq, int D,
                               float scale, int causal) {
  constexpr int BN = kDqRows<T>, NT = BN / 8;
  constexpr int W = kRowWords<T>;  // words a tile row
  extern __shared__ __align__(16) uint32_t ds_smem[];
  uint32_t* ring = ds_smem;
  uint32_t* kbuf = ring + 2 * kDqStage<T>;
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * kTile;
  const int c_out = blockIdx.z * kChunk;
  const size_t base = (size_t)blockIdx.y * seq * D;
  const size_t rbase = (size_t)blockIdx.y * seq;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's rows in the tile
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;

  const int nc = D / kChunk;
  const int kv_end = causal ? min(seq, q0 + kTile) : seq;
  const int n_steps = (kv_end + BN - 1) / BN * nc;
  auto load_step = [&](int i) {
    const int j = i / nc, c = i % nc;
    uint32_t* st = ring + (i & 1) * kDqStage<T>;
    Io<T>::template load<kTile>(st, q + base, q0, c * kChunk, seq, D);
    Io<T>::template load<kTile>(st + kTile * W, dout + base, q0,
                                c * kChunk, seq, D);
    Io<T>::template load<BN>(st + 2 * kTile * W, k + base, j * BN,
                             c * kChunk, seq, D);
    Io<T>::template load<BN>(st + (2 * kTile + BN) * W, v + base, j * BN,
                             c * kChunk, seq, D);
    if (c == 0)
      Io<T>::template load<BN>(kbuf + (j & 1) * BN * W, k + base,
                               j * BN, c_out, seq, D);
  };
  load_step(0);
  cp_async_commit();

  // p = exp(s scale - lse) = exp2(s scale log2(e) - lse log2(e))
  const float scale2 = scale * kLog2e;
  float lse2[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    lse2[h] = row < seq ? lse[rbase + row] * kLog2e : 0.f;
    delta_r[h] = row < seq ? delta[rbase + row] : 0.f;
  }
  float s[NT][4], dp[NT][4], acc[kChunk / 8][4];
#pragma unroll
  for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    const int j = i / nc, c = i % nc, k0 = j * BN;
    if (i + 1 < n_steps) {  // the next step loads under this one
      load_step(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // under causal masking a tile wholly after the warp's rows adds nothing
    if (!causal || k0 <= q0 + wr + 15) {
      if (c == 0) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      }
      const uint32_t* st = ring + (i & 1) * kDqStage<T>;
      Io<T>::template scores<false>(s, st, st + 2 * kTile * W, wr);
      Io<T>::template scores<true>(dp, st + kTile * W,
                                   st + (2 * kTile + BN) * W, wr);
      if (c == nc - 1) {
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
        Io<T>::accumulate(acc, s, kbuf + (j & 1) * BN * W);
      }
    }
    __syncthreads();  // this stage is read: the next load may refill it
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    if (row >= seq) continue;
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n)
      Io<T>::store2(dq + base + (size_t)row * D + c_out + 8 * n + 2 * t4,
                    acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

// ------------------------------------------------------------------ dk/dv

// a stage: [K 64, V 64, Q kDkvRows, dO kDkvRows rows] of one 64-column
// step; then, for each of two Q tiles, Q's and dO's rows of the block's
// chunk, and lse and delta of the tile's rows
template <typename T>
constexpr int kDkvStage = (2 * kTile + 2 * kDkvRows<T>) * kRowWords<T>;
template <typename T>
constexpr int kDkvOut = 2 * kDkvRows<T> * kRowWords<T>;
template <typename T>
constexpr int dkv_smem_bytes() {
  return (2 * kDkvStage<T> + 2 * kDkvOut<T> + 2 * 2 * kDkvRows<T>) * 4;
}

// Replaces _bwd_dkv_kernel for head dims above 256. Per Q tile, in
// transposed scores (rows the warp's KV rows, columns Q rows): s^T = k.q^T
// and dp^T = v.do^T over all of D, p^T from lse, ds^T = p^T (dp^T -
// delta) scale; then dv[:, chunk] += p^T.do[:, chunk] (p in do's type) and
// dk[:, chunk] += ds^T.q[:, chunk] (ds in q's type). grid (KV tiles, BH,
// D / 64).
template <typename T>
__global__ void __launch_bounds__(kTcThreads, 2)
    flash_bwd_dkv_dsplit_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const T* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                T* __restrict__ dk, T* __restrict__ dv,
                                int seq, int D, float scale, int causal) {
  constexpr int BN = kDkvRows<T>, NT = BN / 8;
  constexpr int W = kRowWords<T>;  // words a tile row
  extern __shared__ __align__(16) uint32_t ds_smem[];
  uint32_t* ring = ds_smem;
  uint32_t* outb = ring + 2 * kDkvStage<T>;  // [Q tile][q, do][BN rows]
  float* rows = reinterpret_cast<float*>(outb + 2 * kDkvOut<T>);
  // rows: [Q tile][lse, delta][BN]
  const int k0 = blockIdx.x * kTile;  // the longest column runs come first
  const int c_out = blockIdx.z * kChunk;
  const size_t base = (size_t)blockIdx.y * seq * D;
  const size_t rbase = (size_t)blockIdx.y * seq;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's KV rows in the tile
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  const float scale2 = scale * kLog2e;  // exp(x) = exp2(x log2(e))

  const int nc = D / kChunk;
  // Q tiles wholly before this KV tile see none of it under causal masking
  const int q_begin = causal ? k0 : 0;
  const int n_steps = (seq - q_begin + BN - 1) / BN * nc;
  auto load_step = [&](int i) {
    const int j = i / nc, c = i % nc, q0 = q_begin + j * BN;
    uint32_t* st = ring + (i & 1) * kDkvStage<T>;
    Io<T>::template load<kTile>(st, k + base, k0, c * kChunk, seq, D);
    Io<T>::template load<kTile>(st + kTile * W, v + base, k0,
                                c * kChunk, seq, D);
    Io<T>::template load<BN>(st + 2 * kTile * W, q + base, q0,
                             c * kChunk, seq, D);
    Io<T>::template load<BN>(st + (2 * kTile + BN) * W, dout + base, q0,
                             c * kChunk, seq, D);
    if (c == 0) {
      uint32_t* ob = outb + (j & 1) * kDkvOut<T>;
      Io<T>::template load<BN>(ob, q + base, q0, c_out, seq, D);
      Io<T>::template load<BN>(ob + BN * W, dout + base, q0, c_out, seq,
                               D);
      float* r = rows + (j & 1) * 2 * BN;
      load_rows_async(r, lse + rbase, q0, BN, seq);
      load_rows_async(r + BN, delta + rbase, q0, BN, seq);
    }
  };
  load_step(0);
  cp_async_commit();

  float p[NT][4], ds[NT][4];
  float dk_acc[kChunk / 8][4], dv_acc[kChunk / 8][4];
#pragma unroll
  for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    const int j = i / nc, c = i % nc, q0 = q_begin + j * BN;
    if (i + 1 < n_steps) {  // the next step loads under this one
      load_step(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // under causal masking a Q tile wholly before the warp's rows adds
    // nothing
    if (!causal || q0 + BN - 1 >= k0 + wr) {
      if (c == 0) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[n][e] = ds[n][e] = 0.f;
      }
      const uint32_t* st = ring + (i & 1) * kDkvStage<T>;
      Io<T>::template scores<false>(p, st, st + 2 * kTile * W, wr);
      Io<T>::template scores<true>(ds, st + kTile * W,
                                   st + (2 * kTile + BN) * W, wr);
      if (c == nc - 1) {
        const uint32_t* ob = outb + (j & 1) * kDkvOut<T>;
        const float* slse = rows + (j & 1) * 2 * BN;
        const float* sdelta = slse + BN;
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
        Io<T>::accumulate(dv_acc, p, ob + BN * W);  // p^T . do
        Io<T>::accumulate(dk_acc, ds, ob);                // ds^T . q
      }
    }
    __syncthreads();  // this stage is read: the next load may refill it
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + wr + g + 8 * h;
    if (row >= seq) continue;
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n) {
      const size_t at = base + (size_t)row * D + c_out + 8 * n + 2 * t4;
      Io<T>::store2(dk + at, dk_acc[n][2 * h], dk_acc[n][2 * h + 1]);
      Io<T>::store2(dv + at, dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  }
}

// -------------------------------------------------------------- launching

// The kernel (0 forward, 1 dk/dv, 2 dq, as in flash_attention.cu) for T
// and its dynamic shared memory; nullptr for another kernel id.
template <typename T>
const void* kernel_fn(int kernel, int* smem) {
  switch (kernel) {
    case 0:
      *smem = fwd_smem_bytes<T>();
      return (const void*)flash_fwd_dsplit_kernel<T>;
    case 1:
      *smem = dkv_smem_bytes<T>();
      return (const void*)flash_bwd_dkv_dsplit_kernel<T>;
    case 2:
      *smem = dq_smem_bytes<T>();
      return (const void*)flash_bwd_dq_dsplit_kernel<T>;
  }
  return nullptr;
}

// Raises the kernel's dynamic shared-memory limit to what it launches
// with; -3 for a head dim that is not a positive multiple of 64.
template <typename T>
int prepare(int kernel, int d, int* smem) {
  if (d <= 0 || d % kChunk) return -3;
  const void* fn = kernel_fn<T>(kernel, smem);
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

dim3 grid_of(int bh, int seq, int d) {
  return dim3((seq + kTile - 1) / kTile, bh, d / kChunk);
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int seq, int d, float scale, int causal,
               void* stream) {
  int smem;
  const int e = prepare<T>(0, d, &smem);
  if (e != 0) return e;
  flash_fwd_dsplit_kernel<T>
      <<<grid_of(bh, seq, d), kTcThreads, smem, (cudaStream_t)stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, seq, d,
          scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int seq,
              int d, float scale, int causal, void* stream) {
  int smem;
  const int e = prepare<T>(2, d, &smem);
  if (e != 0) return e;
  flash_bwd_dq_dsplit_kernel<T>
      <<<grid_of(bh, seq, d), kTcThreads, smem, (cudaStream_t)stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
          (const float*)lse, (const float*)delta, (T*)dq, seq, d, scale,
          causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int seq, int d, float scale, int causal, void* stream) {
  int smem;
  const int e = prepare<T>(1, d, &smem);
  if (e != 0) return e;
  flash_bwd_dkv_dsplit_kernel<T>
      <<<grid_of(bh, seq, d), kTcThreads, smem, (cudaStream_t)stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
          (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, seq, d,
          scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int attributes(int kernel, int* out) {
  int smem;
  const void* fn = kernel_fn<T>(kernel, &smem);
  if (fn == nullptr) return -3;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = smem;
  out[3] = (int)attr.localSizeBytes;
  const int p = prepare<T>(kernel, kChunk, &smem);
  if (p != 0) return p;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], fn, kTcThreads, smem);
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
