// The Hopper building blocks of the f32 wgmma kernels, shared by
// flash_attention_f32.cu (the forward and dq at head dim 256) and
// flash_attention_dsplit.cu (dq and dk/dv above 256), as in
// flash_attention.cu: mbarriers, named barriers, wgmma's fences, waits and
// shared-memory descriptors in the 128-byte swizzle, the products with both
// operands in shared memory, and the split p or ds tile the consumer
// writes. tf32_mma.cuh holds the 3xTF32 split they build on.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kSlabCols = 32;  // f32 columns of a 128-byte row
// one half (big or small) of a split [kTile, 32] p or ds tile (a 128-byte
// row a row of the tile)
constexpr int kXSplitBytes = kTile * 128;

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to 1024 bytes, the period of the
// 128-byte swizzle.
__device__ __forceinline__ uint8_t* align_1024(uint8_t* raw) {
  return raw + ((1024u - (smem_addr(raw) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Waits until the barrier has completed the phase of the given parity; a
// wait that never ends traps after 2^26 failed polls, so that a fault in
// the pipeline fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// Makes this thread's shared-memory writes visible to wgmma (the async
// proxy); a barrier after it makes them visible to the other threads' too.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Waits until at most N of this warpgroup's committed wgmma groups are
// pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving register reads of an accumulator before
// the wait for the asynchronous wgmma that writes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: 8-row groups
// 1024 bytes apart, 14-bit start address in 16-byte units, layout type 1 =
// 128-byte swizzle; a K-major k-step (8 tf32, 32 bytes) is +2.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64 x 32] (+)= A.B in TF32, both read K-major from shared memory.
__device__ __forceinline__ void wgmma_ss_tf32_n32(float (&d)[16], uint64_t da,
                                                  uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// Word of element (row, col) of one half of a split [kTile, 32] p or ds
// tile (or any tile of 128-byte rows): row at 128 bytes, col in natural
// order, the 16-byte chunks XORed by row % 8.
__device__ __forceinline__ int x_at(int row, int col) {
  return row * kSlabCols + (((col >> 2) ^ (row & 7)) << 2) + (col & 3);
}

// x, which the compiler may not treat as known: the shared-memory
// addresses derived from it are recomputed in each tile instead of being
// hoisted out of the tile loop into registers the products need.
template <typename T>
__device__ __forceinline__ T opaque(T x) {
  if constexpr (sizeof(T) == 8)
    asm volatile("" : "+l"(x));
  else
    asm volatile("" : "+r"(x));
  return x;
}

// A consumer warp's release of a stage (its empty barrier at bars + 8).
__device__ __forceinline__ void release_stage(uint32_t bars) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bars + 8);
}

// Writes this thread's kCols / 2 values of a [64, kCols] tile in the
// scores' layout (rows wr + g, + 8; columns 8 n + 2 t, + 1), split, into
// the p or ds tile at x (big; small kXSplitBytes on).
template <int kCols>
__device__ __forceinline__ void store_x(uint32_t* x,
                                        const float (&v)[kCols / 2]) {
  const int row = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float pair[2] = {v[4 * n + 2 * h], v[4 * n + 2 * h + 1]};
      const Tf32<2> f = split(pair);
      const int at = x_at(row + 8 * h, 8 * n + 2 * t4);
      *reinterpret_cast<uint2*>(x + at) = make_uint2(f.big[0], f.big[1]);
      *reinterpret_cast<uint2*>(x + kXSplitBytes / 4 + at) =
          make_uint2(f.small[0], f.small[1]);
    }
}

// d[64 x 16] (+)= A.B in TF32, A [64, 8 of K] and B [16 of N, 8 of K] both
// read K-major from shared memory through descriptors.
__device__ __forceinline__ void wgmma_ss_tf32_n16(float (&d)[8], uint64_t da,
                                                  uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

}  // namespace
