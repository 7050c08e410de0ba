// Flash attention for Hopper (sm_90a): forward, dq and dk/dv kernels.
//
// Replaces the three Pallas TPU kernels of ray_tpu/ops/flash_attention.py:
//   flash_fwd_kernel     <- _fwd_kernel      (flash_attention.py:29)
//   flash_bwd_dq_kernel  <- _bwd_dq_kernel   (flash_attention.py:160)
//   flash_bwd_dkv_kernel <- _bwd_dkv_kernel  (flash_attention.py:212)
//
// Layout: q, k, v, o, do, dq, dk, dv are [BH, S, 64] bf16, contiguous;
// lse and delta are [BH, S] f32. A ragged S is masked at the tile edges
// (rows past S load as zeros, columns past S are masked, rows past S are
// not stored), so nothing is padded in memory.
//
// What bounds them on an H100: at GPT-2-small's shape (BH 192, S 1024,
// D 64, causal) the forward moves ~0.10 GB and does ~26 GFLOP, so the
// least time is ~30 us from HBM and ~26 us from the bf16 tensor cores:
// the two bounds are close, and the kernels must both stream q/k/v once
// and keep the S x S scores out of device memory. The design:
//   * one 128-thread block per (b*h, 64-row tile); each warp owns 16 rows;
//   * the tile loop over the other sequence axis runs inside the block,
//     with 64x64 K/V (or Q/dO) tiles staged in shared memory by 16-byte
//     loads, rows padded by 8 elements so fragment loads hit 32 banks;
//   * the products run on the tensor cores as mma.sync m16n8k16 (bf16 in,
//     f32 accumulate); scores, probabilities and accumulators live in
//     registers, and the score fragment is reused directly as the A
//     operand of the next product (p.v, ds.k, p^T.do, ds^T.q);
//   * under causal masking, tiles wholly in the future are skipped, and
//     the forward and dq grids start with the longest rows so the tail of
//     the grid is short.
// Not yet done (later work): wgmma, TMA, a cp.async pipeline across tiles,
// and warp specialisation. Each entry point returns cudaGetLastError()
// right after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;         // head dim
constexpr int kTile = 64;      // rows per tile, on both sequence axes
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kLd = kD + 8;    // shared-memory row stride in elements
constexpr float kNegInf = -1e30f;  // the Pallas kernels' NEG_INF

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two neighbouring bf16 of one row (the lower column in the low half).
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 of one column, from rows r and r + 1.
__device__ __forceinline__ uint32_t ld_col_pair(const bf16* p) {
  const uint16_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint16_t hi = *reinterpret_cast<const uint16_t*>(p + kLd);
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of a [S, 64] matrix into shared memory; rows at or
// past S are zero.
__device__ __forceinline__ void load_tile(bf16* smem, const bf16* g, int row0,
                                          int S) {
#pragma unroll
  for (int c = threadIdx.x; c < kTile * (kD / 8); c += kThreads) {
    const int r = c >> 3;
    const int col = (c & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * kD + col);
    *reinterpret_cast<uint4*>(smem + r * kLd + col) = val;
  }
}

// A fragments (16 rows starting at row w0, all 64 columns) of a tile.
__device__ __forceinline__ void load_a(uint32_t a[4][4], const bf16* s, int w0,
                                       int g, int t) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    a[ks][0] = ld_pair(s + (w0 + g) * kLd + ks * 16 + t * 2);
    a[ks][1] = ld_pair(s + (w0 + g + 8) * kLd + ks * 16 + t * 2);
    a[ks][2] = ld_pair(s + (w0 + g) * kLd + ks * 16 + 8 + t * 2);
    a[ks][3] = ld_pair(s + (w0 + g + 8) * kLd + ks * 16 + 8 + t * 2);
  }
}

// acc[16 x 64] = A[16 x 64] . T^T, where T is a 64 x 64 tile in shared
// memory (rows of T are the output columns): s = q.k^T, dp = do.v^T, ...
__device__ __forceinline__ void mm_abt(float acc[8][4], const uint32_t a[4][4],
                                       const bf16* tile, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const bf16* p = tile + (nt * 8 + g) * kLd + ks * 16 + t * 2;
      mma16816(acc[nt], a[ks], ld_pair(p), ld_pair(p + 8));
    }
  }
}

// acc[16 x 64] += P[16 x 64] . T, with P the f32 fragment of a previous
// product rounded to bf16 and T a 64 x 64 tile in shared memory:
// o += p.v, dq += ds.k, dv += p^T.do, dk += ds^T.q.
__device__ __forceinline__ void mm_pt(float acc[8][4], const float p[8][4],
                                      const bf16* tile, int g, int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * j][0], p[2 * j][1]);
    a[1] = pack_bf16(p[2 * j][2], p[2 * j][3]);
    a[2] = pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]);
    a[3] = pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const bf16* c = tile + (j * 16 + t * 2) * kLd + nt * 8 + g;
      mma16816(acc[nt], a, ld_col_pair(c), ld_col_pair(c + 8 * kLd));
    }
  }
}

// Stores a 16 x 64 f32 fragment (rows w0.. of the tile starting at row0)
// as bf16, skipping rows at or past S.
__device__ __forceinline__ void store_rows(bf16* out, const float acc[8][4],
                                           int row0, int S, int g, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + half * 8;
    if (row >= S) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      __nv_bfloat162 v = __floats2bfloat162_rn(acc[nt][2 * half],
                                               acc[nt][2 * half + 1]);
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * kD + nt * 8 +
                                         t * 2) = v;
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Replaces _fwd_kernel (ray_tpu/ops/flash_attention.py:29). Bound at the
// main shape: ~30 us by bytes (q, k, v read, o and lse written once).
// One block per (Q tile, b*h); the Q fragments stay in registers for the
// whole KV loop, with the online softmax (m, l, acc) in f32 registers.
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int S, float scale, int causal) {
  __shared__ __align__(16) bf16 sQ[kTile * kLd];
  __shared__ __align__(16) bf16 sK[kTile * kLd];
  __shared__ __align__(16) bf16 sV[kTile * kLd];
  const int nt_seq = (S + kTile - 1) / kTile;
  const int qt = nt_seq - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * S * kD;
  const int q0 = qt * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = warp * 16;
  const int row[2] = {q0 + w0 + g, q0 + w0 + g + 8};

  load_tile(sQ, q + base, q0, S);
  __syncthreads();
  uint32_t qa[4][4];
  load_a(qa, sQ, w0, g, t);

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  const int n_kv = causal ? qt + 1 : nt_seq;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile(sK, k + base, k0, S);
    load_tile(sV, v + base, k0, S);
    __syncthreads();

    float s[8][4];
    mm_abt(s, qa, sK, g, t);
    float mcur[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + nt * 8 + t * 2 + (i & 1);
        float x = s[nt][i] * scale;
        if ((causal && col > row[i >> 1]) || col >= S) x = kNegInf;
        s[nt][i] = x;
        mcur[i >> 1] = fmaxf(mcur[i >> 1], x);
      }
    }
    float mnew[2], corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mnew[r] = fmaxf(m[r], quad_max(mcur[r]));
      corr[r] = expf(m[r] - mnew[r]);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[nt][i] - mnew[i >> 1]);
        s[nt][i] = p;
        rsum[i >> 1] += p;
      }
      acc[nt][0] *= corr[0];
      acc[nt][1] *= corr[0];
      acc[nt][2] *= corr[1];
      acc[nt][3] *= corr[1];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * corr[r] + quad_sum(rsum[r]);
      m[r] = mnew[r];
    }
    mm_pt(acc, s, sV, g, t);
  }

  float lc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) lc[r] = fmaxf(l[r], 1e-30f);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    acc[nt][0] /= lc[0];
    acc[nt][1] /= lc[0];
    acc[nt][2] /= lc[1];
    acc[nt][3] /= lc[1];
  }
  store_rows(o + base, acc, q0 + w0, S, g, t);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < S) lse[(size_t)bh * S + row[r]] = m[r] + logf(lc[r]);
  }
}

// Replaces _bwd_dq_kernel (flash_attention.py:160). Bound at the main
// shape: ~39 us by tensor-core operations (three products per tile pair).
// One block per (Q tile, b*h): the Q and dO fragments and the row lse and
// delta stay in registers; each KV tile recomputes p from lse, and
// dq = sum over KV tiles of ds.k accumulates in f32 registers.
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int S, float scale, int causal) {
  __shared__ __align__(16) bf16 sQ[kTile * kLd];
  __shared__ __align__(16) bf16 sdO[kTile * kLd];
  __shared__ __align__(16) bf16 sK[kTile * kLd];
  __shared__ __align__(16) bf16 sV[kTile * kLd];
  const int nt_seq = (S + kTile - 1) / kTile;
  const int qt = nt_seq - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * S * kD;
  const int q0 = qt * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = warp * 16;
  const int row[2] = {q0 + w0 + g, q0 + w0 + g + 8};

  load_tile(sQ, q + base, q0, S);
  load_tile(sdO, dout + base, q0, S);
  __syncthreads();
  uint32_t qa[4][4], da[4][4];
  load_a(qa, sQ, w0, g, t);
  load_a(da, sdO, w0, g, t);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = row[r] < S ? lse[(size_t)bh * S + row[r]] : 0.f;
    delta_r[r] = row[r] < S ? delta[(size_t)bh * S + row[r]] : 0.f;
  }

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  const int n_kv = causal ? qt + 1 : nt_seq;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile(sK, k + base, k0, S);
    load_tile(sV, v + base, k0, S);
    __syncthreads();

    float s[8][4], dp[8][4];
    mm_abt(s, qa, sK, g, t);
    mm_abt(dp, da, sV, g, t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + nt * 8 + t * 2 + (i & 1);
        float x = s[nt][i] * scale;
        if ((causal && col > row[i >> 1]) || col >= S) x = kNegInf;
        const float p = expf(x - lse_r[i >> 1]);
        s[nt][i] = p * (dp[nt][i] - delta_r[i >> 1]) * scale;  // ds
      }
    }
    mm_pt(acc, s, sK, g, t);
  }
  store_rows(dq + base, acc, q0 + w0, S, g, t);
}

// Replaces _bwd_dkv_kernel (flash_attention.py:212). Bound at the main
// shape: ~52 us by tensor-core operations (four products per tile pair).
// One block per (KV tile, b*h): dv = sum over Q tiles of p^T.do and
// dk = sum of ds^T.q, both in f32 registers. Each warp owns 16 KV rows;
// scores are held transposed (KV rows x Q columns), so lse and delta are
// staged per column in shared memory. The K and V fragments are re-read
// from shared memory per Q tile to leave registers for the two
// accumulators (162 registers, no spills).
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int S, float scale, int causal) {
  __shared__ __align__(16) bf16 sK[kTile * kLd];
  __shared__ __align__(16) bf16 sV[kTile * kLd];
  __shared__ __align__(16) bf16 sQ[kTile * kLd];
  __shared__ __align__(16) bf16 sdO[kTile * kLd];
  __shared__ float sL[kTile];
  __shared__ float sDelta[kTile];
  const int nt_seq = (S + kTile - 1) / kTile;
  const int kt = blockIdx.x;  // KV tile 0 has the most Q tiles under causal
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * S * kD;
  const int k0 = kt * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = warp * 16;
  const int krow[2] = {k0 + w0 + g, k0 + w0 + g + 8};

  load_tile(sK, k + base, k0, S);
  load_tile(sV, v + base, k0, S);

  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    dk_acc[nt][0] = dk_acc[nt][1] = dk_acc[nt][2] = dk_acc[nt][3] = 0.f;
    dv_acc[nt][0] = dv_acc[nt][1] = dv_acc[nt][2] = dv_acc[nt][3] = 0.f;
  }

  for (int qt = causal ? kt : 0; qt < nt_seq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile(sQ, q + base, q0, S);
    load_tile(sdO, dout + base, q0, S);
    if (threadIdx.x < kTile) {
      const int r = q0 + threadIdx.x;
      sL[threadIdx.x] = r < S ? lse[(size_t)bh * S + r] : 0.f;
      sDelta[threadIdx.x] = r < S ? delta[(size_t)bh * S + r] : 0.f;
    }
    __syncthreads();

    float p[8][4], dp[8][4];
    {
      uint32_t a[4][4];
      load_a(a, sK, w0, g, t);
      mm_abt(p, a, sQ, g, t);  // s^T = k.q^T
      load_a(a, sV, w0, g, t);
      mm_abt(dp, a, sdO, g, t);  // dp^T = v.do^T
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = nt * 8 + t * 2 + (i & 1);
        const int qcol = q0 + c;
        float x = p[nt][i] * scale;
        if ((causal && qcol < krow[i >> 1]) || krow[i >> 1] >= S || qcol >= S)
          x = kNegInf;
        const float pv = expf(x - sL[c]);
        p[nt][i] = pv;
        dp[nt][i] = pv * (dp[nt][i] - sDelta[c]) * scale;  // ds^T
      }
    }
    mm_pt(dv_acc, p, sdO, g, t);
    mm_pt(dk_acc, dp, sQ, g, t);
  }
  store_rows(dk + base, dk_acc, k0 + w0, S, g, t);
  store_rows(dv + base, dv_acc, k0 + w0, S, g, t);
}

}  // namespace

extern "C" {

int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int seq, float scale, int causal,
                   void* stream) {
  const dim3 grid((seq + kTile - 1) / kTile, bh);
  flash_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      seq, scale, causal);
  return (int)cudaGetLastError();
}

int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int seq, float scale, int causal,
                      void* stream) {
  const dim3 grid((seq + kTile - 1) / kTile, bh);
  flash_bwd_dq_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, seq, scale, causal);
  return (int)cudaGetLastError();
}

int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int seq, float scale,
                       int causal, void* stream) {
  const dim3 grid((seq + kTile - 1) / kTile, bh);
  flash_bwd_dkv_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, seq,
      scale, causal);
  return (int)cudaGetLastError();
}

}  // extern "C"
