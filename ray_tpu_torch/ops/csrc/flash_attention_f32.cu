// Flash attention in f32 for Hopper (sm_90a): forward, dq and dk/dv.
//
// The f32 twins of the bf16 kernels in flash_attention.cu. They compute
// what the Pallas TPU kernels of ray_tpu/ops/flash_attention.py compute
// when given f32 inputs, where the casts of p and ds to the input dtype
// keep them in f32:
//   flash_fwd_f32_kernel     <- _fwd_kernel      (flash_attention.py:29)
//   flash_bwd_dq_f32_kernel  <- _bwd_dq_kernel   (flash_attention.py:160)
//   flash_bwd_dkv_f32_kernel <- _bwd_dkv_kernel  (flash_attention.py:212)
// f32 products and sums, an f32 online softmax, p and ds kept in f32, and
// masked scores set to -1e30 as in the Pallas kernels.
//
// Layout: q, k, v, o, do, dq, dk, dv are [BH, S, D] f32, contiguous and
// 16-byte aligned; lse and delta are [BH, S] f32. D is 16, 32, 64 or 128
// (a template argument); the wrapper pads any other D up to the next of
// these with zero columns. A ragged S is masked at the tile edges: rows
// past S load as zeros, columns past S are masked, rows past S are not
// stored.
//
// What bounds them on an H100: the tensor cores take no f32 (TF32 keeps
// 10 bits of mantissa, which is not f32), so every product is an FFMA on
// the CUDA cores, whose peak is 67 TFLOP/s. At GPT-2-small's attention
// shape (BH 192, S 1024, D 64, causal) the forward does ~26 GFLOP (0.39
// ms at that peak) and moves ~0.21 GB (0.06 ms), so all three kernels
// are bound by operations. The design is a plain tiled one, right before
// fast: one 256-thread block per 64-row tile of its own sequence axis
// (Q rows for the forward and dq, KV rows for dk/dv); the 64-row tiles of
// the other axis are staged through shared memory one at a time, rows
// padded to D + 1 floats so that a column walk hits 32 banks; each thread
// holds a 4 x 4 block of a 64 x 64 score tile (rows ty + 16 i, columns
// tx + 16 j), reduces a row's max and sum across its 16-lane half-warp
// with shuffles, and writes p (or ds) to shared memory, from where the
// accumulating product (o += p.v, dq += ds.k, dv += p^T.do, dk +=
// ds^T.q) reads it; its accumulators are 4 rows x D / 16 columns. Under
// causal masking tiles wholly in the future are skipped, and the forward
// and dq grids start with the longest rows. The host entry points return
// cudaGetLastError() right after the launch, or -3 for a head dim the
// kernels are not built for.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kTile = 64;        // rows of every tile, on both axes
constexpr int kLdS = kTile + 1;  // padded row of a 64 x 64 tile of p or ds
constexpr float kNegInf = -1e30f;  // the Pallas kernels' NEG_INF

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [r0, r0 + 64) of one head's [seq, D] matrix into shared memory at
// row stride D + 1, 16 bytes a thread per load; rows past seq read as 0.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int seq) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < seq)
      x = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * D + c);
    float* d = dst + r * (D + 1) + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

// Entries [r0, r0 + 64) of one head's [seq] row vector; past seq as 0.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int seq) {
  for (int i = threadIdx.x; i < kTile; i += kThreads)
    dst[i] = r0 + i < seq ? src[r0 + i] : 0.f;
}

// s[i][j] = a[ty + 16 i] . b[tx + 16 j] over D, for two [64, D] tiles in
// shared memory.
template <int D>
__device__ __forceinline__ void scores(float (&s)[4][4], const float* a,
                                       const float* b, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// s = a.b^T and t = c.d^T on the same rows and columns, in one walk of D.
template <int D>
__device__ __forceinline__ void two_scores(float (&s)[4][4], float (&t)[4][4],
                                           const float* a, const float* b,
                                           const float* c, const float* d,
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 4
  for (int x = 0; x < D; ++x) {
    float av[4], bv[4], cv[4], dv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a[(ty + 16 * i) * (D + 1) + x];
      cv[i] = c[(ty + 16 * i) * (D + 1) + x];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j] = b[(tx + 16 * j) * (D + 1) + x];
      dv[j] = d[(tx + 16 * j) * (D + 1) + x];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        t[i][j] = fmaf(cv[i], dv[j], t[i][j]);
      }
  }
}

// scale * s, or NEG_INF where masked (causal future, or a column past S)
__device__ __forceinline__ float masked(float s, float scale, int row,
                                        int col, int seq, int causal) {
  const float x = s * scale;
  return (col >= seq || (causal && col > row)) ? kNegInf : x;
}

// ----------------------------------------------------------------- forward

template <int D>
constexpr int fwd_smem_bytes() {
  return (3 * kTile * (D + 1) + kTile * kLdS) * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int seq, float scale,
                         int causal) {
  constexpr int LD = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kTile * LD;
  float* sv = sk + kTile * LD;
  float* sp = sv + kTile * LD;
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * kTile;
  const size_t base = (size_t)blockIdx.y * seq * D;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<D>(sq, q + base, q0, seq);
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  const int kv_end = causal ? min(seq, q0 + kTile) : seq;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // the last tile's reads of sk, sv and sp are done
    load_tile<D>(sk, k + base, k0, seq);
    load_tile<D>(sv, v + base, k0, seq);
    __syncthreads();
    float s[4][4];
    scores<D>(s, sq, sk, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked(s[i][j], scale, row, k0 + tx + 16 * j, seq, causal);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
        sp[(ty + 16 * i) * kLdS + tx + 16 * j] = s[i][j];
      }
      l[i] = l[i] * corr + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
#pragma unroll 8
    for (int n = 0; n < kTile; ++n) {  // acc += p . v
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = sv[n * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sp[(ty + 16 * i) * kLdS + n];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= seq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      o[base + (size_t)row * D + tx + 16 * c] = acc[i][c] / lc;
    if (tx == 0) lse[(size_t)blockIdx.y * seq + row] = m[i] + logf(lc);
  }
}

// ---------------------------------------------------------------------- dq

template <int D>
constexpr int dq_smem_bytes() {
  return (4 * kTile * (D + 1) + kTile * kLdS) * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int seq, float scale,
                            int causal) {
  constexpr int LD = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + kTile * LD;
  float* sk = sdo + kTile * LD;
  float* sv = sk + kTile * LD;
  float* sds = sv + kTile * LD;
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * kTile;
  const size_t base = (size_t)blockIdx.y * seq * D;
  const size_t rbase = (size_t)blockIdx.y * seq;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<D>(sq, q + base, q0, seq);
  load_tile<D>(sdo, dout + base, q0, seq);
  float lse_r[4], delta_r[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < seq ? lse[rbase + row] : 0.f;
    delta_r[i] = row < seq ? delta[rbase + row] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  const int kv_end = causal ? min(seq, q0 + kTile) : seq;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();
    load_tile<D>(sk, k + base, k0, seq);
    load_tile<D>(sv, v + base, k0, seq);
    __syncthreads();
    float s[4][4], dp[4][4];
    two_scores<D>(s, dp, sq, sk, sdo, sv, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x =
            masked(s[i][j], scale, row, k0 + tx + 16 * j, seq, causal);
        const float p = expf(x - lse_r[i]);
        sds[(ty + 16 * i) * kLdS + tx + 16 * j] =
            p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int n = 0; n < kTile; ++n) {  // acc += ds . k
      float kv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = sk[n * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = sds[(ty + 16 * i) * kLdS + n];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= seq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dq[base + (size_t)row * D + tx + 16 * c] = acc[i][c];
  }
}

// ------------------------------------------------------------------- dk/dv

template <int D>
constexpr int dkv_smem_bytes() {
  return (4 * kTile * (D + 1) + 2 * kTile * kLdS + 2 * kTile) * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int seq, float scale, int causal) {
  constexpr int LD = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + kTile * LD;
  float* sq = sv + kTile * LD;
  float* sdo = sq + kTile * LD;
  float* sp = sdo + kTile * LD;
  float* sds = sp + kTile * kLdS;
  float* slse = sds + kTile * kLdS;
  float* sdelta = slse + kTile;
  const int k0 = blockIdx.x * kTile;  // the longest column runs come first
  const size_t base = (size_t)blockIdx.y * seq * D;
  const size_t rbase = (size_t)blockIdx.y * seq;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<D>(sk, k + base, k0, seq);
  load_tile<D>(sv, v + base, k0, seq);
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  // Q tiles wholly before this KV tile see none of it under causal masking
  for (int q0 = causal ? k0 : 0; q0 < seq; q0 += kTile) {
    __syncthreads();
    load_tile<D>(sq, q + base, q0, seq);
    load_tile<D>(sdo, dout + base, q0, seq);
    load_rows(slse, lse + rbase, q0, seq);
    load_rows(sdelta, delta + rbase, q0, seq);
    __syncthreads();
    // the thread's block of the tile: Q rows ty + 16 i, KV columns tx + 16 j
    float s[4][4], dp[4][4];
    two_scores<D>(s, dp, sq, sk, sdo, sv, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int a = ty + 16 * i, row = q0 + a;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x =
            masked(s[i][j], scale, row, k0 + tx + 16 * j, seq, causal);
        const float p = row < seq ? expf(x - slse[a]) : 0.f;
        sp[a * kLdS + tx + 16 * j] = p;
        sds[a * kLdS + tx + 16 * j] = p * (dp[i][j] - sdelta[a]) * scale;
      }
    }
    __syncthreads();
    // dv += p^T . do and dk += ds^T . q, on KV rows ty + 16 i
#pragma unroll 4
    for (int a = 0; a < kTile; ++a) {
      float dov[NC], qv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        dov[c] = sdo[a * LD + tx + 16 * c];
        qv[c] = sq[a * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sp[a * kLdS + ty + 16 * i];
        const float ds = sds[a * kLdS + ty + 16 * i];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv_acc[i][c] = fmaf(p, dov[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(ds, qv[c], dk_acc[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= seq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[base + (size_t)row * D + tx + 16 * c] = dk_acc[i][c];
      dv[base + (size_t)row * D + tx + 16 * c] = dv_acc[i][c];
    }
  }
}

// -------------------------------------------------------------- launching

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int seq, float scale, int causal,
               void* stream) {
  constexpr int smem = fwd_smem_bytes<D>();
  const cudaError_t e =
      cudaFuncSetAttribute(flash_fwd_f32_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((seq + kTile - 1) / kTile, bh);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o,
      (float*)lse, seq, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int seq,
              float scale, int causal, void* stream) {
  constexpr int smem = dq_smem_bytes<D>();
  const cudaError_t e =
      cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((seq + kTile - 1) / kTile, bh);
  flash_bwd_dq_f32_kernel<D><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dq, seq, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int seq, float scale, int causal, void* stream) {
  constexpr int smem = dkv_smem_bytes<D>();
  const cudaError_t e =
      cudaFuncSetAttribute(flash_bwd_dkv_f32_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((seq + kTile - 1) / kTile, bh);
  flash_bwd_dkv_f32_kernel<D><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, seq,
      scale, causal);
  return (int)cudaGetLastError();
}

// The kernel (0 forward, 1 dk/dv, 2 dq, as in flash_attention.cu) at head
// dim D, and its dynamic shared memory.
template <int D>
const void* kernel_fn(int kernel, int* smem) {
  switch (kernel) {
    case 0:
      *smem = fwd_smem_bytes<D>();
      return (const void*)flash_fwd_f32_kernel<D>;
    case 1:
      *smem = dkv_smem_bytes<D>();
      return (const void*)flash_bwd_dkv_f32_kernel<D>;
    case 2:
      *smem = dq_smem_bytes<D>();
      return (const void*)flash_bwd_dq_f32_kernel<D>;
    default:
      return nullptr;
  }
}

const void* kernel_at(int kernel, int d, int* smem) {
  switch (d) {
    case 16: return kernel_fn<16>(kernel, smem);
    case 32: return kernel_fn<32>(kernel, smem);
    case 64: return kernel_fn<64>(kernel, smem);
    case 128: return kernel_fn<128>(kernel, smem);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

int flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                  void* lse, int bh, int seq, int d, float scale, int causal,
                  void* stream) {
  switch (d) {
    case 16: return launch_fwd<16>(q, k, v, o, lse, bh, seq, scale, causal, stream);
    case 32: return launch_fwd<32>(q, k, v, o, lse, bh, seq, scale, causal, stream);
    case 64: return launch_fwd<64>(q, k, v, o, lse, bh, seq, scale, causal, stream);
    case 128: return launch_fwd<128>(q, k, v, o, lse, bh, seq, scale, causal, stream);
    default: return -3;
  }
}

int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int bh, int seq, int d, float scale,
                     int causal, void* stream) {
  switch (d) {
    case 16: return launch_dq<16>(q, k, v, dout, lse, delta, dq, bh, seq, scale, causal, stream);
    case 32: return launch_dq<32>(q, k, v, dout, lse, delta, dq, bh, seq, scale, causal, stream);
    case 64: return launch_dq<64>(q, k, v, dout, lse, delta, dq, bh, seq, scale, causal, stream);
    case 128: return launch_dq<128>(q, k, v, dout, lse, delta, dq, bh, seq, scale, causal, stream);
    default: return -3;
  }
}

int flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int bh, int seq, int d, float scale,
                      int causal, void* stream) {
  switch (d) {
    case 16: return launch_dkv<16>(q, k, v, dout, lse, delta, dk, dv, bh, seq, scale, causal, stream);
    case 32: return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, bh, seq, scale, causal, stream);
    case 64: return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, seq, scale, causal, stream);
    case 128: return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh, seq, scale, causal, stream);
    default: return -3;
  }
}

// Of the forward (0), dk/dv (1) or dq (2) at head dim d: out[0] registers a
// thread, out[1] its dynamic shared memory, out[2] the blocks that one SM
// holds at once with it. Returns a cudaError_t, or -3 for another kernel
// or head dim.
int flash_f32_kernel_attributes(int kernel, int d, int* out) {
  int smem = 0;
  const void* fn = kernel_at(kernel, d, &smem);
  if (fn == nullptr) return -3;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = smem;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], fn, kThreads,
                                                      smem);
  return (int)e;
}

}  // extern "C"
