// Flash attention for Hopper (sm_90a) in f32 at head dims 16-256: forward,
// dq and dk/dv, every product on the tensor cores as 3xTF32.
//
// They compute what the Pallas TPU kernels of ray_tpu/ops/flash_attention.py
// compute for f32 inputs:
//   flash_fwd_tc_kernel     <- _fwd_kernel      (flash_attention.py:29)
//   flash_bwd_dq_tc_kernel  <- _bwd_dq_kernel   (flash_attention.py:160)
//   flash_bwd_dkv_tc_kernel, flash_bwd_dkv_d256_tc_kernel
//                           <- _bwd_dkv_kernel  (flash_attention.py:212)
// Each but the last is a template on the head dim D. Sums, softmax and
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
// One design serves all three: one 128-thread block a 64-row tile of its
// own axis (Q rows for the forward and dq, KV rows for dk/dv), 4 warps of
// 16 rows each. The other axis streams in tiles of 32 rows (16 at D 128, 8
// at D 256) through a 2-stage cp.async ring, so the next tile loads under this one's
// products (dk/dv at D 256 has a kernel of its own, with 8 warps that
// split its products by output: flash_bwd_dkv_d256_tc_kernel, below).
// Tiles sit in shared memory as raw f32, rows unpadded and XOR-swizzled
// so that all three fragment reads below are free of bank conflicts; each
// fragment is split into big and small as it is read, in integer and FMA
// operations. Every product is mma.sync.m16n8k8 tf32:
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

namespace {

constexpr int kTile = 64;          // rows of a block's own tile
constexpr float kNegInf = -1e30f;  // the Pallas kernels' NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// elements (c, c + 1) of a row, c even
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// the max and sum over the 4 threads of a quad, which hold one row's
// columns of an accumulator tile
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;

// Rows of a streamed tile (the other axis): 32, 16 at D 128, where the
// accumulators of a 16 x 128 output a warp take 64 registers each, and 8
// at D 256, where they take 128.
template <int D>
constexpr int kStreamRows = D >= 256 ? 8 : D >= 128 ? 16 : 32;

// Blocks an SM is built for: registers stay under 65,536 / (128 x this),
// and at 1 under the cap of 255 a thread.
template <int D>
constexpr int kMinBlocks = D >= 256 ? 1 : D >= 128 ? 2 : 3;

// Where element (r, c) of a [rows, D] f32 tile sits in shared memory, in
// 4-byte words. Rows are unpadded; each row's words are XOR-swizzled by
// its row so that, with g = lane / 4 and t = lane % 4, the three reads of
// the kernels hit distinct banks: the pair (c, c + 1) at row g, column
// 8 kd + 2 t (an A or a score B fragment; 8-byte reads, so per half-warp),
// and single elements at rows 8 j + 2 t (+ 1), column 8 n + g (the B
// fragment of an accumulating product).
template <int D>
struct Layout {
  // bits 3 and 4 of the word: (r1, r0 ^ r2) takes distinct values on rows
  // 0-3, 4-7, {0, 2, 4, 6} and {1, 3, 5, 7}; a 16-float row has bit 3 only
  static __device__ __forceinline__ int swz(int r) {
    if constexpr (D >= 32)
      return ((r & 2) | ((r ^ (r >> 2)) & 1)) << 3;
    else
      return ((r >> 1) & 1) << 3;
  }
  static __device__ __forceinline__ int at(int r, int c) {
    return r * D + (c ^ swz(r));
  }
  static __device__ __forceinline__ int chunk(int r, int ch) {
    return at(r, 4 * ch);  // 16-byte chunk ch of row r
  }
  static __device__ __forceinline__ float2 pair(const uint32_t* t, int r,
                                                int c) {
    return *reinterpret_cast<const float2*>(t + at(r, c));
  }
  static __device__ __forceinline__ float one(const uint32_t* t, int r,
                                              int c) {
    return __uint_as_float(t[at(r, c)]);
  }
};

__device__ __forceinline__ void cp_async16(uint32_t* dst, const void* src,
                                           bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + kRows) of one head's [seq, D] matrix into a swizzled
// tile, 16 bytes a copy; rows past seq are zero-filled.
template <int D, int kRows, int kThreads = kTcThreads>
__device__ __forceinline__ void load_tile_async(uint32_t* dst,
                                                const float* src, int r0,
                                                int seq) {
  using L = Layout<D>;
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, ch = i % kChunks;
    const bool valid = r0 + r < seq;
    cp_async16(dst + L::chunk(r, ch),
               src + (size_t)(valid ? r0 + r : 0) * D + ch * 4, valid);
  }
}

// Entries [r0, r0 + n) of one head's [seq] f32 row vector; past seq as 0.
template <int kThreads = kTcThreads>
__device__ __forceinline__ void load_rows_async(float* dst, const float* src,
                                                int r0, int n, int seq) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool valid = r0 + i < seq;
    cp_async4(dst + i, src + (valid ? r0 + i : 0), valid);
  }
}

// An operand fragment in TF32: big = tf32(x) (round to nearest, ties away
// from zero) and small = x - big (exact in f32); the tensor cores read the
// top 10 mantissa bits of small, so its rounding is their truncation,
// ~2^-21 of x (one integer round of small cost 8-9% of dq and dk/dv on
// the card; PERF.md).
template <int N>
struct Tf32 {
  uint32_t big[N], small[N];
};

// What cvt.rna.tf32.f32 gives for a finite x, in two integer operations:
// cvt runs on the conversion pipe, a sixteenth of the FMA rate, and took
// about a quarter of dq's time on the card (PERF.md)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

template <int N>
__device__ __forceinline__ Tf32<N> split(const float (&x)[N]) {
  Tf32<N> f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    f.big[i] = tf32_rna(x[i]);
    f.small[i] = __float_as_uint(x[i] - __uint_as_float(f.big[i]));
  }
  return f;
}

// c += a.b for a 16 x 8 A (row-major) and an 8 x 8 B (column-major).
// Fragments, with g = lane / 4 and t = lane % 4: a = A[g][t], A[g + 8][t],
// A[g][t + 4], A[g + 8][t + 4]; b = B[t][g], B[t + 4][g]; c = C[g][2t],
// C[g][2t + 1], C[g + 8][2t], C[g + 8][2t + 1].
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of rows (r, r + 8) of a tile at k-step columns (c, c + 1):
// k index t is column c, t + 4 is c + 1 (c = 8 kd + 2 t).
template <typename L>
__device__ __forceinline__ Tf32<4> a_frag(const uint32_t* tile, int r, int c) {
  const float2 lo = L::pair(tile, r, c), hi = L::pair(tile, r + 8, c);
  const float x[4] = {lo.x, hi.x, lo.y, hi.y};
  return split(x);
}

// The B fragment of a score product (B = tile^T): column n = tile row r,
// k indices t, t + 4 = tile columns c, c + 1.
template <typename L>
__device__ __forceinline__ Tf32<2> b_frag(const uint32_t* tile, int r, int c) {
  const float2 p = L::pair(tile, r, c);
  const float x[2] = {p.x, p.y};
  return split(x);
}

// The B fragment of an accumulating product (B = tile): k indices t, t + 4
// = tile rows r, r + 1 (r = 8 j + 2 t), column n = tile column c.
template <typename L>
__device__ __forceinline__ Tf32<2> bt_frag(const uint32_t* tile, int r,
                                           int c) {
  const float x[2] = {L::one(tile, r, c), L::one(tile, r + 1, c)};
  return split(x);
}

// The A fragment of an accumulating product from an accumulator tile x of
// 16 x 8: its columns 2t and 2t + 1 are the k indices t and t + 4.
__device__ __forceinline__ Tf32<4> acc_frag(const float (&x)[4]) {
  const float a[4] = {x[0], x[2], x[1], x[3]};
  return split(a);
}

// The tensor cores add into their f32 accumulator with truncation, up to
// an ulp of the accumulator each time, toward zero, so the errors of a
// sum add up. Summing the 3 passes of every k-step into one accumulator
// (CUTLASS's order, the small terms first) read up to 0.65 of the f32
// bound on the card, at dq elements near 0 where ds = p (dp - delta)
// cancels (PERF.md). So big.big and the small terms accumulate apart, the
// small ones (~2^-11 of the sum, and so are their truncations) in an
// accumulator of their own, added once at the end. dp, whose error the
// cancellation carries into ds whole, also restarts big.big from 0 every
// two k-steps and adds it in f32, rounded (kRestart): 0.45 of the bound
// without, 0.30 with, for 1-4% of the kernels' time. An error in s moves
// p by a relative ~1e-6 only.

// s[16 x BN] = a[16 rows from `row`] . b[BN rows]^T, contracted over D
template <int D, int NT, bool kRestart>
__device__ __forceinline__ void tile_scores(float (&s)[NT][4],
                                            const uint32_t* a,
                                            const uint32_t* b, int row) {
  using L = Layout<D>;
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  float small[NT][4], part[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = small[n][e] = part[n][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < D / 8; ++kd) {
    const int col = 8 * kd + 2 * t4;
    const Tf32<4> fa = a_frag<L>(a, row + g, col);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const Tf32<2> fb = b_frag<L>(b, 8 * n + g, col);
      if constexpr (kRestart) {
        mma_tf32(part[n], fa.big, fb.big);
        if (kd & 1) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] += part[n][e];
            part[n][e] = 0.f;
          }
        }
      } else {
        mma_tf32(s[n], fa.big, fb.big);
      }
      mma_tf32(small[n], fa.big, fb.small);
      mma_tf32(small[n], fa.small, fb.big);
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] += part[n][e] + small[n][e];
}

// acc[16 x D] += x[16 x BN] . tile[BN x D], x in the accumulator layout:
// each tile's product starts from 0 and is added to acc in f32, rounded
template <int D, int NT>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                           const float (&x)[NT][4],
                                           const uint32_t* tile) {
  using L = Layout<D>;
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  Tf32<4> a[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) a[j] = acc_frag(x[j]);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    float big[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const Tf32<2> fb = bt_frag<L>(tile, 8 * j + 2 * t4, 8 * n + g);
      mma_tf32(big, a[j].big, fb.big);
      mma_tf32(small, a[j].big, fb.small);
      mma_tf32(small, a[j].small, fb.big);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += big[e] + small[e];
  }
}

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

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
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
// dim D, its dynamic shared memory and its threads a block; nullptr for
// another kernel id.
template <int D>
const void* kernel_fn(int kernel, int* smem, int* threads) {
  *threads = kTcThreads;
  switch (kernel) {
    case 0:
      *smem = fwd_tc_smem_bytes<D>();
      return (const void*)flash_fwd_tc_kernel<D>;
    case 1:
      if constexpr (D == 256) {
        *smem = dkv256_tc_smem_bytes();
        *threads = kDkv256Threads;
        return (const void*)flash_bwd_dkv_d256_tc_kernel;
      } else {
        *smem = dkv_tc_smem_bytes<D>();
        return (const void*)flash_bwd_dkv_tc_kernel<D>;
      }
    case 2:
      *smem = dq_tc_smem_bytes<D>();
      return (const void*)flash_bwd_dq_tc_kernel<D>;
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
    flash_fwd_tc_kernel<D><<<grid, threads, smem, (cudaStream_t)stream>>>(
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
    flash_bwd_dq_tc_kernel<D>
        <<<grid, threads, smem, (cudaStream_t)stream>>>(
            (const float*)q, (const float*)k, (const float*)v,
            (const float*)dout, (const float*)lse, (const float*)delta,
            (float*)dq, seq, scale, causal);
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
