// The 3xTF32 mma.sync helpers of the f32 flash attention kernels, shared
// by flash_attention_f32.cu and flash_attention_dsplit.cu: shared-memory
// tile layouts and loads, the TF32 split, the m16n8k8 product and its
// fragments, and the two products every kernel is built from
// (tile_scores, accumulate). flash_attention_f32.cu's opening note says
// how they keep f32 accuracy.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace
