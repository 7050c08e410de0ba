// Flash attention for Hopper (sm_90a) in bf16: forward, dq and dk/dv
// kernels at head dims 64 and 128, and three of their own at 256.
//
// Replaces the three Pallas TPU kernels of ray_tpu/ops/flash_attention.py:
//   flash_fwd_kernel<D>, flash_fwd_d256_kernel <- _fwd_kernel (:29)
//   flash_bwd_dq_kernel<D>, flash_bwd_dq_d256_kernel <- _bwd_dq_kernel
//                                               (flash_attention.py:160)
//   flash_bwd_dkv_kernel<D>, flash_bwd_dkv_d256_kernel <- _bwd_dkv_kernel
//                                               (flash_attention.py:212)
//
// Layout: q, k, v, o, do, dq, dk, dv are [BH, S, D] bf16, contiguous, D 64,
// 128 or 256 (the wrapper pads other head dims with zero columns); lse and
// delta are [BH, S] f32. A ragged S is masked at the tile edges (rows past S
// load as zeros, columns past S are masked, rows past S are not stored),
// so nothing is padded in memory.
//
// What bounds them on an H100: at GPT-2-small's shape (BH 192, S 1024,
// D 64, causal) the forward moves ~0.10 GB and does ~26 GFLOP, so the
// least time is ~30 us from HBM and ~26 us from the bf16 tensor cores;
// dq does three products per tile pair and dk/dv four, so both are bound
// by the tensor cores (~39 and ~52 us). At D 128 with half the heads (BH
// 96) the bytes and the operations are the same. The kernels must stream
// their inputs once, keep the S x S scores out of device memory, and keep
// the tensor cores fed. One design serves all of them (256 threads, two
// warpgroups; the head-dim-256 kernels, further down, change what a block
// holds to fit shared memory and registers):
//   * one block per (128-row tile, b*h): Q rows for the forward and dq,
//     KV rows for dk/dv; each warpgroup owns 64 rows, the M of one wgmma;
//   * the block's own tiles (Q; Q and dO; or K and V) are loaded once by
//     TMA; the tiles of the other sequence axis (K and V, or Q and dO with
//     the matching lse and delta) stream through a ring of shared-memory
//     stages guarded by mbarriers (full: the TMA bytes have landed; empty:
//     all eight warps are done with the stage). The first warp also issues
//     each tile's loads two tiles before the tile is needed, so loads
//     overlap the tensor cores without a producer warp: a ninth warp would
//     cost registers, since the SM spreads a block's warps over four
//     register files of 16K registers each;
//   * TMA writes every tile in the 128-byte swizzle through a 3-D tensor
//     map [BH, S, D], whose bounds zero-fill rows past S without reading
//     the next head. The swizzle takes boxes at most 128 bytes wide, one
//     row of 64 bf16: a [rows, D] tile lands as D / 64 halves [rows, 64],
//     one box each at column 64 h, half h at h * rows * 128 bytes,
//     each 1024-byte aligned as the swizzle's period needs;
//   * every product is a wgmma: scores (s = q.k^T and dp = do.v^T; s^T =
//     k.q^T and dp^T = v.do^T) with both operands in shared memory,
//     K-major, k-steps 0-3 reading half 0 and 4-7 half 1; the accumulating
//     products (o += p.v; dq += ds.k; dv += p^T.do, dk += ds^T.q) with p
//     or ds packed from the f32 score fragment to bf16 as the register A
//     operand and B read MN-major from the same swizzled tile, one
//     m64n64k16 per half of D;
//   * probabilities run on exp2 of scores scaled by scale * log2(e) in one
//     FFMA (the backward kernels recompute p from lse in log2 units); the
//     mask is applied only on diagonal and ragged tiles, and a tile wholly
//     masked for a warpgroup is skipped.
//
// Under causal masking the grids start with the longest rows of each
// head. The host entry points encode the tensor maps
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so no
// -lcuda) and return cudaGetLastError() right after the launch, or -1 if
// the CUDA driver has no cuTensorMapEncodeTiled, -2 if it refuses a tensor
// map, -3 for a head dim the kernel is not built for.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernels' NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// Two warpgroups, one of whose threads also issues the TMA loads.
constexpr int kWgThreads = 256;
// One 128-byte swizzle row holds 64 bf16 columns of the head dim: a tile
// of D columns is D / 64 such halves.
constexpr int kHalfD = 64;
constexpr int kRowBytes = kHalfD * 2;
constexpr int kBlockM = 128;  // rows of the block's own tile
constexpr int kFwdBlockN = 64;  // forward: K/V rows per stage
constexpr int kFwdStages = 4;
constexpr int kDqBlockN = 64;  // dq: K/V rows per stage
constexpr int kDqStages = 4;
constexpr int kDkvBlockN = 64;  // dk/dv: Q/dO rows per stage
constexpr int kDkvStages = 4;
// Blocks an SM holds: the forward at D 64 keeps to 128 registers a thread
// so that two do; at D 128 its o accumulator alone takes 64.
template <int D>
constexpr int kFwdMinBlocks = D == 64 ? 2 : 1;
// dq at D 64 fits 128 registers with its products in turn, so two blocks
// share an SM; at D 128 its dq accumulator alone takes 64.
template <int D>
constexpr int kDqMinBlocks = D == 64 ? 2 : 1;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------ Hopper building blocks

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to 1024 bytes, the period of the
// 128-byte swizzle, so that TMA and wgmma agree on where each row's
// 16-byte chunks sit.
__device__ __forceinline__ uint8_t* align_1024(uint8_t* raw) {
  return raw + ((1024u - (smem_addr(raw) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Waits until the barrier has completed the phase of the given parity.
// A wait that never ends (a fault in the pipeline) traps after 2^26
// failed polls, seconds at least, so that it fails the launch instead of
// hanging the card.
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

// A [kRows, D] tile at (row, bh): one box a half, half h at
// dst + h * kRows * 128 bytes. The barrier's expect_tx counts every half.
template <int D, int kRows>
__device__ __forceinline__ void tma_load_tile(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int row, int bh) {
#pragma unroll
  for (int h = 0; h < D / kHalfD; ++h)
    tma_load(dst + h * kRows * kRowBytes, map, bar, h * kHalfD, row, bh);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Waits until at most N of this warpgroup's committed wgmma groups are
// pending; groups complete in the order they were committed.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving register reads or writes of an
// accumulator across the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int H, int N>
__device__ __forceinline__ void fence_regs(float (&d)[H][N]) {
#pragma unroll
  for (int h = 0; h < H; ++h) fence_regs(d[h]);
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// wgmma shared-memory descriptor of a tile half written by TMA in the
// 128-byte swizzle: 8-row groups 1024 bytes apart (stride byte offset),
// 14-bit start address in 16-byte units, layout type 1 = 128-byte
// swizzle. The leading byte offset is unused: a K-major operand's k-step
// (16 columns, 32 bytes) and an MN-major operand's N (64) each lie within
// one 128-byte swizzle row, and the other half of D is a descriptor of its
// own. A k-step of 16 advances a K-major operand by 32 bytes (+2) and an
// MN-major one by 16 rows, 2048 bytes (+128); the next half of a [rows, D]
// tile starts rows * 128 bytes on (half_desc).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
constexpr uint64_t kDescK16 = 32 >> 4;                // K-major k-step
constexpr uint64_t kDescMN16 = (16 * kRowBytes) >> 4;  // MN-major k-step
constexpr int kKStepsPerHalf = kHalfD / 16;            // K-major k-steps a half
__host__ __device__ constexpr uint64_t half_desc(int rows) {
  return (uint64_t)(rows * kRowBytes) >> 4;
}

// ------------------------------------------------ wgmma wrappers

// d[64 x 64] (+)= A . B, A and B both read K-major from shared memory
// through descriptors; acc = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 64] += A . B, A bf16 fragments in registers (the layout of
// mma.sync's m16n8k16 A, one 16-row slab per warp), B read MN-major
// from shared memory through a descriptor.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// 2^x on the special-function unit, denormals flushed (p and the rescale
// factors are either 0 or far above the denormal range).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The bf16 A fragment of k-step kk (columns 16kk..16kk+15) of a 64-row
// f32 accumulator: wgmma's A register layout per warp is mma.sync's
// m16n8k16 A layout, and the accumulator's is its C layout, so the score
// fragment becomes the next product's A operand without any shuffle.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&d)[N],
                                       int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

template <int N>
__device__ __forceinline__ void pack_all(uint32_t (&a)[N / 8][4],
                                         const float (&d)[N]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) pack_a(a[kk], d, kk);
}

// Stores a 64 x D f32 accumulator fragment (one 64 x 64 fragment a half
// of D) as bf16: this thread's rows row and row + 8, columns
// 64 h + 8j + 2t; rows at or past S are skipped.
template <int D>
__device__ __forceinline__ void store_frag(bf16* out,
                                           const float (&d)[D / kHalfD][32],
                                           int row, int S, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r >= S) continue;
#pragma unroll
    for (int h = 0; h < D / kHalfD; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * D + h * kHalfD +
                                           8 * j + 2 * t) =
            __floats2bfloat162_rn(d[h][4 * j + 2 * half],
                                  d[h][4 * j + 2 * half + 1]);
  }
}

template <int H>
__device__ __forceinline__ void scale_rows(float (&acc)[H][32],
                                           const float (&f)[2]) {
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[h][4 * j + 0] *= f[0];
      acc[h][4 * j + 1] *= f[0];
      acc[h][4 * j + 2] *= f[1];
      acc[h][4 * j + 3] *= f[1];
    }
}

// One KV tile of the online softmax for this thread's rows row and
// row + 8. sc holds the raw scores q.k^T; masked (when the tile crosses
// the diagonal or S) they become NEG_INF. m is the running raw max, l this
// thread's share of the row sums; corr is the factor by which the output
// accumulated so far must be rescaled. On return sc holds
// p = exp2(s * scale * log2(e) - m * scale * log2(e)) in f32.
template <int kN>
__device__ __forceinline__ void softmax_tile(float (&sc)[kN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], bool masked,
                                             int k0, int row, int t, int S,
                                             int causal, float scale_log2) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + 8 * j + 2 * t + (i & 1);
        if ((causal && col > row + 8 * (i >> 1)) || col >= S)
          sc[4 * j + i] = kNegInf;
      }
  }
  // row maxima as a tree (rows row: i = 0, 1; row + 8: i = 2, 3)
  float r[2][kN / 8];
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    r[0][j] = fmaxf(sc[4 * j], sc[4 * j + 1]);
    r[1][j] = fmaxf(sc[4 * j + 2], sc[4 * j + 3]);
  }
#pragma unroll
  for (int w = kN / 16; w >= 1; w /= 2)
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
  for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      sc[4 * j + i] = exp2_ftz(fmaf(sc[4 * j + i], scale_log2, -ms[i >> 1]));
  }
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    r[0][j] = sc[4 * j] + sc[4 * j + 1];
    r[1][j] = sc[4 * j + 2] + sc[4 * j + 3];
  }
#pragma unroll
  for (int w = kN / 16; w >= 1; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) {
      r[0][j] += r[0][j + w];
      r[1][j] += r[1][j + w];
    }
  l[0] = fmaf(l[0], corr[0], r[0][0]);
  l[1] = fmaf(l[1], corr[1], r[1][0]);
}

// d = A.B^T over D, A and B both 64-row operands read K-major from
// shared memory: s = q.k^T, dp = do.v^T, s^T = k.q^T, dp^T = v.do^T.
// desc_a and desc_b point at the operands' rows in half 0 of their tiles;
// half_a and half_b step to half 1 (half_desc).
template <int D>
__device__ __forceinline__ void issue_abt(float (&d)[32], uint64_t desc_a,
                                          uint64_t half_a, uint64_t desc_b,
                                          uint64_t half_b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int h = kk / kKStepsPerHalf;
    const uint64_t k = (kk % kKStepsPerHalf) * kDescK16;
    wgmma_ss_n64(d, desc_a + h * half_a + k, desc_b + h * half_b + k, kk);
  }
}

// d += A.B over kK rows, A the bf16 fragments of p or ds in registers, B
// a [kK, D] tile read MN-major from shared memory, one m64n64k16 a half of
// D: o += p.v, dq += ds.k, dv += p^T.do, dk += ds^T.q.
template <int D, int kK>
__device__ __forceinline__ void issue_ab(float (&d)[D / kHalfD][32],
                                         const uint32_t (&a)[kK / 16][4],
                                         uint64_t desc_b, uint64_t half_b) {
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk)
#pragma unroll
    for (int h = 0; h < D / kHalfD; ++h)
      wgmma_rs_n64(d[h], a[kk], desc_b + h * half_b + kk * kDescMN16, 1);
}

template <int D>
constexpr int fwd_smem_bytes() {
  return 1024 + kBlockM * D * 2 + 2 * kFwdStages * kFwdBlockN * D * 2 +
         (1 + 2 * kFwdStages) * 8;
}

// Replaces _fwd_kernel (ray_tpu/ops/flash_attention.py:29). Bound at the
// main shape: ~30 us by bytes (q, k, v read, o and lse written once).
// One block per (128-row Q tile, b*h); the Q tile stays in shared memory
// and 64-row K and V tiles stream through kStages stages. Each warpgroup
// keeps the online softmax (m, l, o) of its 64 rows in f32 registers.
// o += p.v of tile j - 1 runs on the tensor cores while the softmax of
// tile j runs on the other units (FlashAttention-3's
// intra-warpgroup pipelining); p is packed to bf16 only after that product
// is done, so no register that an in-flight wgmma reads is redefined
// (ptxas would serialise the wgmmas otherwise). At D 64 at most 128
// registers a thread, so that two blocks share an SM. At D 128 o takes 64
// registers, s 32 and p 16: under 128 a thread they would spill, so one
// block an SM, with registers to spare and the same 64-row K/V tiles in 4
// stages (160 KB of shared memory). 128-row K/V tiles, FlashAttention-3's
// choice at this head dim, would double s and p (~200 registers) and leave
// room for 2 stages of 64 KB only, too few to keep a load ahead of the
// pipelined p.v.
template <int D>
__global__ void __launch_bounds__(kWgThreads, kFwdMinBlocks<D>)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 bf16* __restrict__ o, float* __restrict__ lse, int S,
                 float scale, int causal) {
  constexpr int kN = kFwdBlockN;
  constexpr int kStages = kFwdStages;
  constexpr int kH = D / kHalfD;
  constexpr int kAhead = kStages - 2;  // tiles in flight beyond the two in use
  constexpr int kQBytes = kBlockM * D * 2;
  constexpr int kKVBytes = kN * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const uint32_t sQ = smem_addr(sm);
  const uint32_t sK = sQ + kQBytes;
  const uint32_t sV = sK + kStages * kKVBytes;
  const uint32_t bar_q = sV + kStages * kKVBytes;
  const uint32_t bar_full = bar_q + 8;                // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 * stage

  const int q0 = ((S + kBlockM - 1) / kBlockM - 1 - blockIdx.x) * kBlockM;
  const int bh = blockIdx.y;  // a head's tiles run together, longest first
  const int n_kv = ((causal ? min(q0 + kBlockM, S) : S) + kN - 1) / kN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kWgThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Thread 0 is also the producer: K/V tile j goes into its stage once all
  // eight warps have released tile j - kStages. It is issued kAhead tiles
  // before it is needed, when that release is two tiles old.
  auto issue_kv = [&](int j) {
    const int s = j % kStages;
    mbar_expect_tx(bar_full + 8 * s, 2 * kKVBytes);
    tma_load_tile<D, kN>(sK + s * kKVBytes, &tm_k, bar_full + 8 * s, j * kN,
                         bh);
    tma_load_tile<D, kN>(sV + s * kKVBytes, &tm_v, bar_full + 8 * s, j * kN,
                         bh);
  };
  auto produce = [&](int j) {
    if (threadIdx.x == 0 && j < n_kv) {
      mbar_wait(bar_empty + 8 * (j % kStages), ((j / kStages) & 1) ^ 1);
      issue_kv(j);
    }
    __syncwarp();
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q, kQBytes);
    tma_load_tile<D, kBlockM>(sQ, &tm_q, bar_q, q0, bh);
  }
  for (int j = 0; j < kAhead; ++j) produce(j);

  // warpgroup wg owns rows q0 + 64 wg .. + 63 and uses the first n_w KV
  // tiles (under causal masking the block's last tile may lie wholly in
  // warpgroup 0's future)
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int wg_row0 = q0 + wg * 64;
  const int row = wg_row0 + (warp & 3) * 16 + g;  // and row + 8
  const int n_w = causal ? (min(wg_row0 + 64, S) + kN - 1) / kN : n_kv;
  const float scale_log2 = scale * kLog2e;
  auto masked = [&](int it) {
    const int k0 = it * kN;
    return (causal && k0 + kN - 1 > wg_row0) || k0 + kN > S;
  };
  auto wait_full = [&](int it) {
    mbar_wait(bar_full + 8 * (it % kStages), (it / kStages) & 1);
  };
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * (it % kStages));
  };
  auto desc_k = [&](int it) {
    return sw128_desc(sK + (it % kStages) * kKVBytes);
  };
  auto desc_v = [&](int it) {
    return sw128_desc(sV + (it % kStages) * kKVBytes);
  };
  constexpr uint64_t half_q = half_desc(kBlockM), half_kv = half_desc(kN);

  float acc[kH][32];
#pragma unroll
  for (int h = 0; h < kH; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of the raw scores
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  float corr[2];
  float sc[kN / 2];
  uint32_t pa[kN / 16][4];

  mbar_wait(bar_q, 0);
  const uint64_t desc_q = sw128_desc(sQ + wg * 64 * kRowBytes);
  produce(kAhead);
  wait_full(0);
  wgmma_fence();
  issue_abt<D>(sc, desc_q, half_q, desc_k(0), half_kv);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  softmax_tile<kN>(sc, m, l, corr, masked(0), 0, row, t, S, causal,
                   scale_log2);
  pack_all(pa, sc);
  for (int it = 1; it < n_w; ++it) {
    produce(it + kAhead);
    wait_full(it);
    wgmma_fence();
    issue_abt<D>(sc, desc_q, half_q, desc_k(it), half_kv);
    wgmma_commit();
    issue_ab<D, kN>(acc, pa, desc_v(it - 1), half_kv);
    wgmma_commit();
    wgmma_wait<1>();  // the scores of tile it
    fence_regs(sc);
    softmax_tile<kN>(sc, m, l, corr, masked(it), it * kN, row, t, S, causal,
                     scale_log2);
    wgmma_wait<0>();  // p.v of tile it - 1
    fence_regs(acc);
    fence_regs(pa);
    release(it - 1);
    scale_rows(acc, corr);
    pack_all(pa, sc);
  }
  wgmma_fence();
  issue_ab<D, kN>(acc, pa, desc_v(n_w - 1), half_kv);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  release(n_w - 1);
  for (int it = n_w; it < n_kv; ++it) {  // tiles this warpgroup skips
    produce(it + kAhead);
    wait_full(it);
    release(it);
  }

  float lc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) lc[r] = fmaxf(quad_sum(l[r]), 1e-30f);
#pragma unroll
  for (int h = 0; h < kH; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[h][4 * j + 0] /= lc[0];
      acc[h][4 * j + 1] /= lc[0];
      acc[h][4 * j + 2] /= lc[1];
      acc[h][4 * j + 3] /= lc[1];
    }
  store_frag<D>(o + (size_t)bh * S * D, acc, row, S, t);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row + 8 * r < S)
        lse[(size_t)bh * S + row + 8 * r] = m[r] * scale + logf(lc[r]);
  }
}

template <int D>
constexpr int dq_smem_bytes() {
  return 1024 + 2 * kBlockM * D * 2 + 2 * kDqStages * kDqBlockN * D * 2 +
         (1 + 2 * kDqStages) * 8;
}

// ds = p.(dp - delta).scale of one KV tile, in place of the scores
// s = q.k^T, for this thread's rows row and row + 8, with p recomputed as
// exp2(s.scale.log2(e) - lse2) (lse2: lse in log2 units). Masked elements
// (the tile crosses the diagonal or S) get p = 0, which is what the Pallas
// kernel's exp(NEG_INF - lse) gives.
__device__ __forceinline__ void dq_tile(float (&sc)[32], const float (&dp)[32],
                                        const float (&lse2)[2],
                                        const float (&dl)[2], bool masked,
                                        int k0, int row, int t, int S,
                                        int causal, float scale,
                                        float scale_log2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = i >> 1;
      float p = exp2_ftz(fmaf(sc[4 * j + i], scale_log2, -lse2[h]));
      if (masked) {
        const int col = k0 + 8 * j + 2 * t + (i & 1);
        if ((causal && col > row + 8 * h) || col >= S) p = 0.f;
      }
      sc[4 * j + i] = p * (dp[4 * j + i] - dl[h]) * scale;
    }
  }
}

// Replaces _bwd_dq_kernel (flash_attention.py:160). Bound at the main
// shape: ~39 us by tensor-core operations (three products per tile pair).
// One block per (128-row Q tile, b*h): Q and dO stay in shared memory for
// the whole loop, each thread holds lse (in log2 units) and delta of its
// two rows in registers, and 64-row K and V tiles stream through kStages
// stages. Per KV tile each warpgroup runs s = q.k^T and dp = do.v^T, turns
// them into ds in registers, packs ds to bf16 (the Pallas kernel's cast
// before ds.k) and accumulates dq += ds.k in f32 registers, with B read
// MN-major from the same swizzled K tile. Each tile's products run in
// turn: overlapping ds.k of tile j - 1 with ds of tile j, as the forward
// overlaps p.v, needs the s, dp, dq and ds fragments live at once, and at
// the 128 registers a thread that two blocks an SM allow at D 64 ptxas
// then spills and serialises the wgmmas (slower on the card; PERF.md).
// Without the overlap dq fits in 126 registers there, and the four
// warpgroups of two blocks an SM hide each other's exponentials. At D 128
// (bound ~39 us as at D 64: the same bytes and operations at half the
// heads) the dq accumulator takes 64 registers, so one block an SM (Q and
// dO 64 KB, 4 stages of K and V 128 KB); the overlap then fits under 255
// registers but ran no faster on the card (PERF.md), so both head dims
// share one loop.
template <int D>
__global__ void __launch_bounds__(kWgThreads, kDqMinBlocks<D>)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int S, float scale, int causal) {
  constexpr int kN = kDqBlockN;
  constexpr int kStages = kDqStages;
  constexpr int kH = D / kHalfD;
  constexpr int kAhead = kStages - 2;  // tiles in flight beyond the two in use
  constexpr int kQBytes = kBlockM * D * 2;
  constexpr int kKVBytes = kN * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const uint32_t sQ = smem_addr(sm);
  const uint32_t sdO = sQ + kQBytes;
  const uint32_t sK = sdO + kQBytes;                   // + stage * kKVBytes
  const uint32_t sV = sK + kStages * kKVBytes;         // + stage * kKVBytes
  const uint32_t bar_q = sV + kStages * kKVBytes;      // Q and dO
  const uint32_t bar_full = bar_q + 8;                 // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;   // + 8 * stage

  const int q0 = ((S + kBlockM - 1) / kBlockM - 1 - blockIdx.x) * kBlockM;
  const int bh = blockIdx.y;  // a head's tiles run together, longest first
  const int n_kv = ((causal ? min(q0 + kBlockM, S) : S) + kN - 1) / kN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kWgThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Thread 0 is also the producer, as in the forward: K/V tile j goes into
  // its stage once all eight warps have released tile j - kStages, kAhead
  // tiles before it is needed.
  auto produce = [&](int j) {
    if (threadIdx.x == 0 && j < n_kv) {
      const int s = j % kStages;
      mbar_wait(bar_empty + 8 * s, ((j / kStages) & 1) ^ 1);
      mbar_expect_tx(bar_full + 8 * s, 2 * kKVBytes);
      tma_load_tile<D, kN>(sK + s * kKVBytes, &tm_k, bar_full + 8 * s, j * kN,
                           bh);
      tma_load_tile<D, kN>(sV + s * kKVBytes, &tm_v, bar_full + 8 * s, j * kN,
                           bh);
    }
    __syncwarp();
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q, 2 * kQBytes);
    tma_load_tile<D, kBlockM>(sQ, &tm_q, bar_q, q0, bh);
    tma_load_tile<D, kBlockM>(sdO, &tm_do, bar_q, q0, bh);
  }
  for (int j = 0; j < kAhead; ++j) produce(j);

  // warpgroup wg owns rows q0 + 64 wg .. + 63 and uses the first n_w KV
  // tiles (under causal masking the block's last tile may lie wholly in
  // warpgroup 0's future)
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int wg_row0 = q0 + wg * 64;
  const int row = wg_row0 + (warp & 3) * 16 + g;  // and row + 8
  const int n_w = causal ? (min(wg_row0 + 64, S) + kN - 1) / kN : n_kv;
  const float scale_log2 = scale * kLog2e;
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    lse2[h] = r < S ? lse[(size_t)bh * S + r] * kLog2e : 0.f;
    dl[h] = r < S ? delta[(size_t)bh * S + r] : 0.f;
  }
  auto wait_full = [&](int it) {
    mbar_wait(bar_full + 8 * (it % kStages), (it / kStages) & 1);
  };
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * (it % kStages));
  };
  auto desc_k = [&](int it) {
    return sw128_desc(sK + (it % kStages) * kKVBytes);
  };
  auto desc_v = [&](int it) {
    return sw128_desc(sV + (it % kStages) * kKVBytes);
  };
  constexpr uint64_t half_q = half_desc(kBlockM), half_kv = half_desc(kN);
  float acc[kH][32];
#pragma unroll
  for (int h = 0; h < kH; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  float sc[32], dp[32];
  uint32_t da[4][4];

  mbar_wait(bar_q, 0);
  const uint64_t desc_q = sw128_desc(sQ + wg * 64 * kRowBytes);
  const uint64_t desc_do = sw128_desc(sdO + wg * 64 * kRowBytes);
  for (int it = 0; it < n_w; ++it) {
    produce(it + kAhead);
    wait_full(it);
    wgmma_fence();
    issue_abt<D>(sc, desc_q, half_q, desc_k(it), half_kv);
    issue_abt<D>(dp, desc_do, half_q, desc_v(it), half_kv);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    const int k0 = it * kN;
    const bool masked = (causal && k0 + kN - 1 > wg_row0) || k0 + kN > S;
    dq_tile(sc, dp, lse2, dl, masked, k0, row, t, S, causal, scale,
            scale_log2);
    pack_all(da, sc);
    wgmma_fence();
    issue_ab<D, kN>(acc, da, desc_k(it), half_kv);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    release(it);
  }
  for (int it = n_w; it < n_kv; ++it) {  // tiles this warpgroup skips
    produce(it + kAhead);
    wait_full(it);
    release(it);
  }
  store_frag<D>(dq + (size_t)bh * S * D, acc, row, S, t);
}

template <int D>
constexpr int dkv_smem_bytes() {
  return 1024 + 2 * kBlockM * D * 2 + 2 * kDkvStages * kDkvBlockN * D * 2 +
         2 * kDkvStages * kDkvBlockN * 4 + (1 + 2 * kDkvStages) * 8;
}

// p^T and ds^T of one Q tile, in place of the transposed scores s^T (KV
// rows krow, krow + 8 x this thread's Q columns) and dp^T. L holds the
// tile's lse in log2 units, Dl its delta.
__device__ __forceinline__ void dkv_tile(float (&st)[32], float (&dpt)[32],
                                         const float* L, const float* Dl,
                                         bool masked, int q0, int krow, int t,
                                         int S, int causal, float scale,
                                         float scale_log2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = 8 * j + 2 * t + (i & 1);
      float p = exp2_ftz(fmaf(st[4 * j + i], scale_log2, -L[c]));
      if (masked) {
        const int kr = krow + 8 * (i >> 1);
        if ((causal && q0 + c < kr) || kr >= S || q0 + c >= S) p = 0.f;
      }
      st[4 * j + i] = p;
      dpt[4 * j + i] = p * (dpt[4 * j + i] - Dl[c]) * scale;  // ds^T
    }
  }
}

// Replaces _bwd_dkv_kernel (flash_attention.py:212). Bound at the main
// shape: ~52 us by tensor-core operations (four products per tile pair).
// One block per (128-row KV tile, b*h): K and V stay in shared memory for
// the whole loop, and Q, dO (64 rows) and the matching lse (in log2
// units) and delta stream through kStages stages. Each warpgroup holds
// its 64 KV rows' dk and dv in f32 registers; scores are held transposed
// (KV rows x Q columns). Warp 0 is also the producer: its lanes stage lse
// and delta with plain loads and arrive on the stage's barrier, and lane 0
// adds the TMA bytes of Q and dO. Per Q tile, the two score products run,
// then p^T and ds^T, then the two accumulating products: the scores are
// not overlapped with the previous tile's gradients as the forward does,
// since holding both sets of fragments takes ~220 registers a thread at
// D 64 for no gain, and a block of 256 threads already has the SM to
// itself. At D 128 dk and dv take 128 registers, s^T and dp^T 64 and their
// packed fragments 32: ptxas fits that in the cap of 255 without a spill.
// 32-row Q tiles (m64n32k16 score products) took 199 registers but ran
// 1.3x slower on the card, and overlapping their scores with the previous
// tile's gradients slower still (PERF.md).
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int S, float scale, int causal) {
  constexpr int kN = kDkvBlockN;
  constexpr int kStages = kDkvStages;
  constexpr int kH = D / kHalfD;
  constexpr int kAhead = kStages - 2;  // tiles in flight beyond the two in use
  constexpr int kKVBytes = kBlockM * D * 2;
  constexpr int kQBytes = kN * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const uint32_t sK = smem_addr(sm);
  const uint32_t sV = sK + kKVBytes;
  const uint32_t sQ = sV + kKVBytes;            // + stage * kQBytes
  const uint32_t sdO = sQ + kStages * kQBytes;  // + stage * kQBytes
  float* sL = reinterpret_cast<float*>(sm + 2 * kKVBytes +
                                       2 * kStages * kQBytes);  // [stage][kN]
  float* sDelta = sL + kStages * kN;                            // [stage][kN]
  const uint32_t bar_kv = smem_addr(sDelta + kStages * kN);
  const uint32_t bar_full = bar_kv + 8;               // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 * stage

  const int k0 = blockIdx.x * kBlockM;  // KV tile 0 has the most Q tiles
  const int bh = blockIdx.y;
  const int qt0 = causal ? k0 / kN : 0;
  const int n_it = (S + kN - 1) / kN - qt0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);
      mbar_init(bar_empty + 8 * s, kWgThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Q/dO tile j (with its lse and delta) goes into its stage once all eight
  // warps have released tile j - kStages, kAhead tiles before it is needed.
  auto produce = [&](int j) {
    if (warp != 0 || j >= n_it) return;
    const int s = j % kStages;
    const int q0 = (qt0 + j) * kN;
    mbar_wait(bar_empty + 8 * s, ((j / kStages) & 1) ^ 1);
    for (int c = lane; c < kN; c += 32) {
      const int r = q0 + c;
      sL[s * kN + c] = r < S ? lse[(size_t)bh * S + r] * kLog2e : 0.f;
      sDelta[s * kN + c] = r < S ? delta[(size_t)bh * S + r] : 0.f;
    }
    if (lane == 0) {
      mbar_expect_tx(bar_full + 8 * s, 2 * kQBytes);
      tma_load_tile<D, kN>(sQ + s * kQBytes, &tm_q, bar_full + 8 * s, q0, bh);
      tma_load_tile<D, kN>(sdO + s * kQBytes, &tm_do, bar_full + 8 * s, q0,
                           bh);
    } else {
      mbar_arrive(bar_full + 8 * s);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_kv, 2 * kKVBytes);
    tma_load_tile<D, kBlockM>(sK, &tm_k, bar_kv, k0, bh);
    tma_load_tile<D, kBlockM>(sV, &tm_v, bar_kv, k0, bh);
  }
  for (int j = 0; j < kAhead; ++j) produce(j);

  // warpgroup wg owns KV rows k0 + 64 wg .. + 63. It uses the Q tiles from
  // it_w on: under causal masking the block's first Q tile lies wholly
  // before warpgroup 1's rows; KV rows wholly past S use none. Warpgroup 0
  // (the producer's) always uses every tile.
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int wg_row0 = k0 + wg * 64;
  const int krow = wg_row0 + (warp & 3) * 16 + g;  // and krow + 8
  const int it_w = wg_row0 >= S ? n_it : (causal ? wg_row0 / kN - qt0 : 0);
  const float scale_log2 = scale * kLog2e;
  auto wait_full = [&](int it) {
    mbar_wait(bar_full + 8 * (it % kStages), (it / kStages) & 1);
  };
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * (it % kStages));
  };

  float dk_acc[kH][32], dv_acc[kH][32];
#pragma unroll
  for (int h = 0; h < kH; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[h][i] = dv_acc[h][i] = 0.f;

  for (int it = 0; it < it_w; ++it) {  // Q tiles this warpgroup skips
    wait_full(it);
    release(it);
  }
  if (it_w < n_it) {
    mbar_wait(bar_kv, 0);
    const uint64_t desc_k = sw128_desc(sK + wg * 64 * kRowBytes);
    const uint64_t desc_v = sw128_desc(sV + wg * 64 * kRowBytes);
    constexpr uint64_t half_kv = half_desc(kBlockM), half_q = half_desc(kN);
    float st[32], dpt[32];
    uint32_t pa[4][4], da[4][4];
    auto issue_scores = [&](int it) {  // s^T = k.q^T, dp^T = v.do^T
      const int s = it % kStages;
      issue_abt<D>(st, desc_k, half_kv, sw128_desc(sQ + s * kQBytes), half_q);
      issue_abt<D>(dpt, desc_v, half_kv, sw128_desc(sdO + s * kQBytes),
                   half_q);
    };
    auto issue_grads = [&](int it) {  // dv += p^T.do, dk += ds^T.q
      const int s = it % kStages;
      issue_ab<D, kN>(dv_acc, pa, sw128_desc(sdO + s * kQBytes), half_q);
      issue_ab<D, kN>(dk_acc, da, sw128_desc(sQ + s * kQBytes), half_q);
    };
    auto elementwise = [&](int it) {
      const int s = it % kStages;
      const int q0 = (qt0 + it) * kN;
      const bool masked = (causal && q0 < wg_row0 + 63) || q0 + kN > S ||
                          wg_row0 + 64 > S;
      dkv_tile(st, dpt, sL + s * kN, sDelta + s * kN, masked, q0, krow, t, S,
               causal, scale, scale_log2);
    };

    for (int it = it_w; it < n_it; ++it) {
      produce(it + kAhead);
      wait_full(it);
      wgmma_fence();
      issue_scores(it);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      elementwise(it);
      pack_all(pa, st);
      pack_all(da, dpt);
      wgmma_fence();
      issue_grads(it);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      release(it);
    }
  }
  store_frag<D>(dk + (size_t)bh * S * D, dk_acc, krow, S, t);
  store_frag<D>(dv + (size_t)bh * S * D, dv_acc, krow, S, t);
}

// ------------------------------------------------ head dim 256
//
// bf16 head dims 129-256 (the wrapper pads them to 256) have a forward, a
// dk/dv and a dq of their own (the dq after the dk/dv below). At D 256 a [rows, D] tile lands as four 64-column boxes, box h at
// h * rows * 128 bytes: k-steps 4h to 4h + 3 of a K-major operand read box
// h, and an MN-major operand's box h feeds output columns 64h to 64h + 63.

// Forward at D 256: the Q tile alone takes 64 KB and a 64-row K or V tile
// 32 KB, so flash_fwd_kernel's four stages of K and V (256 KB) do not fit
// the 227 KB a block may take. K and V get rings of their own, three K
// stages and two V stages: 1024 + 64 KB + 5 x 32 KB + 11 barriers =
// 230,488 bytes. A K tile is released as soon as its scores are done and
// a V tile once p.v of it is, so K is issued two tiles ahead of its use
// and V one. In registers o takes 128 a thread, s 32 and p 16; with the
// pipelined p.v all three are live: 202 registers, one block an SM.
constexpr int kFwd256KStages = 3;
constexpr int kFwd256VStages = 2;

constexpr int fwd256_smem_bytes() {
  return 1024 + kBlockM * 256 * 2 +
         (kFwd256KStages + kFwd256VStages) * kFwdBlockN * 256 * 2 +
         (1 + 2 * (kFwd256KStages + kFwd256VStages)) * 8;
}

// Replaces _fwd_kernel (flash_attention.py:29) for bf16 head dims 129-256.
// Bound at B*H 48, S 1024, D 256, causal: ~30 us by bytes, as at the main
// shape. The loop is flash_fwd_kernel's (128 Q rows a block, 64-row K/V
// tiles, o += p.v of tile j - 1 on the tensor cores while the softmax of
// tile j runs) over the two rings.
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_d256_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      bf16* __restrict__ o, float* __restrict__ lse, int S,
                      float scale, int causal) {
  constexpr int D = 256;
  constexpr int kN = kFwdBlockN;
  constexpr int kKS = kFwd256KStages, kVS = kFwd256VStages;
  constexpr int kH = D / kHalfD;
  constexpr int kQBytes = kBlockM * D * 2;
  constexpr int kTileBytes = kN * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const uint32_t sQ = smem_addr(sm);
  const uint32_t sK = sQ + kQBytes;           // + stage * kTileBytes
  const uint32_t sV = sK + kKS * kTileBytes;  // + stage * kTileBytes
  const uint32_t bar_q = sV + kVS * kTileBytes;
  const uint32_t k_full = bar_q + 8;          // + 8 * stage
  const uint32_t k_empty = k_full + 8 * kKS;  // + 8 * stage
  const uint32_t v_full = k_empty + 8 * kKS;  // + 8 * stage
  const uint32_t v_empty = v_full + 8 * kVS;  // + 8 * stage

  const int q0 = ((S + kBlockM - 1) / kBlockM - 1 - blockIdx.x) * kBlockM;
  const int bh = blockIdx.y;  // a head's tiles run together, longest first
  const int n_kv = ((causal ? min(q0 + kBlockM, S) : S) + kN - 1) / kN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kKS; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kWgThreads / 32);
    }
    for (int s = 0; s < kVS; ++s) {
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, kWgThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Thread 0 is also the producer. At tile j it issues K tile j + 2, once
  // all eight warps have released tile j + 2 - kKS from that stage, and V
  // tile j, once they have released tile j - kVS.
  auto produce = [&](int j) {
    if (threadIdx.x == 0) {
      const int jk = j + 2;
      if (jk < n_kv) {
        const int s = jk % kKS;
        mbar_wait(k_empty + 8 * s, ((jk / kKS) & 1) ^ 1);
        mbar_expect_tx(k_full + 8 * s, kTileBytes);
        tma_load_tile<D, kN>(sK + s * kTileBytes, &tm_k, k_full + 8 * s,
                             jk * kN, bh);
      }
      if (j < n_kv) {
        const int s = j % kVS;
        mbar_wait(v_empty + 8 * s, ((j / kVS) & 1) ^ 1);
        mbar_expect_tx(v_full + 8 * s, kTileBytes);
        tma_load_tile<D, kN>(sV + s * kTileBytes, &tm_v, v_full + 8 * s,
                             j * kN, bh);
      }
    }
    __syncwarp();
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q, kQBytes);
    tma_load_tile<D, kBlockM>(sQ, &tm_q, bar_q, q0, bh);
    for (int j = 0; j < 2 && j < n_kv; ++j) {  // K tiles 0 and 1
      mbar_expect_tx(k_full + 8 * j, kTileBytes);
      tma_load_tile<D, kN>(sK + j * kTileBytes, &tm_k, k_full + 8 * j,
                           j * kN, bh);
    }
  }
  produce(0);

  // warpgroup wg owns rows q0 + 64 wg .. + 63 and uses the first n_w KV
  // tiles (under causal masking the block's last tile may lie wholly in
  // warpgroup 0's future)
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int wg_row0 = q0 + wg * 64;
  const int row = wg_row0 + (warp & 3) * 16 + g;  // and row + 8
  const int n_w = causal ? (min(wg_row0 + 64, S) + kN - 1) / kN : n_kv;
  const float scale_log2 = scale * kLog2e;
  auto masked = [&](int it) {
    const int k0 = it * kN;
    return (causal && k0 + kN - 1 > wg_row0) || k0 + kN > S;
  };
  auto wait_k = [&](int it) {
    mbar_wait(k_full + 8 * (it % kKS), (it / kKS) & 1);
  };
  auto wait_v = [&](int it) {
    mbar_wait(v_full + 8 * (it % kVS), (it / kVS) & 1);
  };
  auto release_k = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty + 8 * (it % kKS));
  };
  auto release_v = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty + 8 * (it % kVS));
  };
  auto desc_k = [&](int it) {
    return sw128_desc(sK + (it % kKS) * kTileBytes);
  };
  auto desc_v = [&](int it) {
    return sw128_desc(sV + (it % kVS) * kTileBytes);
  };
  constexpr uint64_t half_q = half_desc(kBlockM), half_kv = half_desc(kN);

  float acc[kH][32];
#pragma unroll
  for (int h = 0; h < kH; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of the raw scores
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  float corr[2];
  float sc[kN / 2];
  uint32_t pa[kN / 16][4];

  mbar_wait(bar_q, 0);
  const uint64_t desc_q = sw128_desc(sQ + wg * 64 * kRowBytes);
  wait_k(0);
  wgmma_fence();
  issue_abt<D>(sc, desc_q, half_q, desc_k(0), half_kv);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  release_k(0);
  softmax_tile<kN>(sc, m, l, corr, masked(0), 0, row, t, S, causal,
                   scale_log2);
  pack_all(pa, sc);
  for (int it = 1; it < n_w; ++it) {
    produce(it);
    wait_k(it);
    wait_v(it - 1);
    wgmma_fence();
    issue_abt<D>(sc, desc_q, half_q, desc_k(it), half_kv);
    wgmma_commit();
    issue_ab<D, kN>(acc, pa, desc_v(it - 1), half_kv);
    wgmma_commit();
    wgmma_wait<1>();  // the scores of tile it
    fence_regs(sc);
    release_k(it);
    softmax_tile<kN>(sc, m, l, corr, masked(it), it * kN, row, t, S, causal,
                     scale_log2);
    wgmma_wait<0>();  // p.v of tile it - 1
    fence_regs(acc);
    fence_regs(pa);
    release_v(it - 1);
    scale_rows(acc, corr);
    pack_all(pa, sc);
  }
  wait_v(n_w - 1);
  wgmma_fence();
  issue_ab<D, kN>(acc, pa, desc_v(n_w - 1), half_kv);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  release_v(n_w - 1);
  for (int it = n_w; it < n_kv; ++it) {  // tiles this warpgroup skips
    produce(it);
    wait_k(it);
    release_k(it);
    wait_v(it);
    release_v(it);
  }

  float lc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) lc[r] = fmaxf(quad_sum(l[r]), 1e-30f);
#pragma unroll
  for (int h = 0; h < kH; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[h][4 * j + 0] /= lc[0];
      acc[h][4 * j + 1] /= lc[0];
      acc[h][4 * j + 2] /= lc[1];
      acc[h][4 * j + 3] /= lc[1];
    }
  store_frag<D>(o + (size_t)bh * S * D, acc, row, S, t);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row + 8 * r < S)
        lse[(size_t)bh * S + row + 8 * r] = m[r] * scale + logf(lc[r]);
  }
}

// dk/dv at D 256: flash_bwd_dkv_kernel gives each warpgroup dk and dv of
// its 64 KV rows, 256 registers a thread at D 256 for the accumulators
// alone. Here a block takes 64 KV rows (K and V, 32 KB each), both
// warpgroups work on all of them, and Q, dO (64 rows, 32 KB each) with
// their lse and delta stream through two stages. The four products of a
// Q tile are split by output: warpgroup 0 computes s^T = k.q^T, p^T and
// dv += p^T.do, warpgroup 1 dp^T = v.do^T, ds^T = p^T.(dp^T -
// delta).scale and dk += ds^T.q, each holding one [64, 256] accumulator
// (128 registers; 208 in all). p^T passes from warpgroup 0 to 1 through
// shared memory in f32, double-buffered (2 x 16 KB, each thread's 32
// values at a stride of 128 floats, so a warp's accesses hit 32 banks),
// with mbarriers for full and empty: 1024 + 64 KB + 128 KB + 1 KB of lse
// and delta + 32 KB + 9 barriers = 231,496 bytes. Each warpgroup
// computing the whole s^T and dp^T and half of dk's and dv's columns, as
// flash_bwd_dkv_kernel does at D 128 for all of them, takes 6 products
// for 4 and ran 1.27x slower on the card (PERF.md).
constexpr int kDkv256BlockM = 64;  // KV rows a block
constexpr int kDkv256Stages = 2;

constexpr int dkv256_smem_bytes() {
  return 1024 + 2 * kDkv256BlockM * 256 * 2 +
         2 * kDkv256Stages * kDkvBlockN * 256 * 2 +
         2 * kDkv256Stages * kDkvBlockN * 4 +
         2 * kDkvBlockN * kDkv256BlockM * 4 + (1 + 2 * kDkv256Stages + 4) * 8;
}

// p^T of one Q tile in place of the transposed scores s^T (KV rows krow,
// krow + 8 x this thread's Q columns), masked elements 0: the first half
// of dkv_tile. L holds the tile's lse in log2 units.
__device__ __forceinline__ void p_tile(float (&st)[32], const float* L,
                                       bool masked, int q0, int krow, int t,
                                       int S, int causal, float scale_log2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = 8 * j + 2 * t + (i & 1);
      float p = exp2_ftz(fmaf(st[4 * j + i], scale_log2, -L[c]));
      if (masked) {
        const int kr = krow + 8 * (i >> 1);
        if ((causal && q0 + c < kr) || kr >= S || q0 + c >= S) p = 0.f;
      }
      st[4 * j + i] = p;
    }
  }
}

// Replaces _bwd_dkv_kernel (flash_attention.py:212) for bf16 head dims
// 129-256. Bound at B*H 48, S 1024, D 256, causal: ~52 us by tensor-core
// operations, as at the main shape. One block per (64-row KV tile, b*h);
// Q tiles from the diagonal on under causal masking. The producer warp
// stages lse and delta with plain loads and issues the TMA of Q and dO, as
// in flash_bwd_dkv_kernel; it is warp 4, the first of warpgroup 1, which
// runs behind warpgroup 0 and so finds the stage it refills released.
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkv_d256_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                          float scale, int causal) {
  constexpr int D = 256;
  constexpr int kM = kDkv256BlockM;
  constexpr int kN = kDkvBlockN;
  constexpr int kStages = kDkv256Stages;
  constexpr int kKVBytes = kM * D * 2;
  constexpr int kQBytes = kN * D * 2;
  constexpr int kProducer = 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const uint32_t sK = smem_addr(sm);
  const uint32_t sV = sK + kKVBytes;
  const uint32_t sQ = sV + kKVBytes;            // + stage * kQBytes
  const uint32_t sdO = sQ + kStages * kQBytes;  // + stage * kQBytes
  float* sL = reinterpret_cast<float*>(sm + 2 * kKVBytes +
                                       2 * kStages * kQBytes);  // [stage][kN]
  float* sDelta = sL + kStages * kN;                            // [stage][kN]
  float* sP = sDelta + kStages * kN;  // p^T: [buffer][32][128]
  const uint32_t bar_kv = smem_addr(sP + 2 * kN * kM);
  const uint32_t bar_full = bar_kv + 8;               // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 * stage
  const uint32_t p_full = bar_empty + 8 * kStages;    // + 8 * buffer
  const uint32_t p_empty = p_full + 16;               // + 8 * buffer

  const int k0 = blockIdx.x * kM;  // KV tile 0 has the most Q tiles
  const int bh = blockIdx.y;
  const int qt0 = causal ? k0 / kN : 0;
  const int n_it = (S + kN - 1) / kN - qt0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);
      mbar_init(bar_empty + 8 * s, kWgThreads / 32);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(p_full + 8 * b, kWgThreads / 2);
      mbar_init(p_empty + 8 * b, kWgThreads / 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Q/dO tile j (with its lse and delta) goes into its stage once all eight
  // warps have released tile j - kStages; it is issued one tile ahead.
  auto produce = [&](int j) {
    if (warp != kProducer || j >= n_it) return;
    const int s = j % kStages;
    const int q0 = (qt0 + j) * kN;
    mbar_wait(bar_empty + 8 * s, ((j / kStages) & 1) ^ 1);
    for (int c = lane; c < kN; c += 32) {
      const int r = q0 + c;
      sL[s * kN + c] = r < S ? lse[(size_t)bh * S + r] * kLog2e : 0.f;
      sDelta[s * kN + c] = r < S ? delta[(size_t)bh * S + r] : 0.f;
    }
    if (lane == 0) {
      mbar_expect_tx(bar_full + 8 * s, 2 * kQBytes);
      tma_load_tile<D, kN>(sQ + s * kQBytes, &tm_q, bar_full + 8 * s, q0, bh);
      tma_load_tile<D, kN>(sdO + s * kQBytes, &tm_do, bar_full + 8 * s, q0,
                           bh);
    } else {
      mbar_arrive(bar_full + 8 * s);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_kv, 2 * kKVBytes);
    tma_load_tile<D, kM>(sK, &tm_k, bar_kv, k0, bh);
    tma_load_tile<D, kM>(sV, &tm_v, bar_kv, k0, bh);
  }
  produce(0);

  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int krow = k0 + (warp & 3) * 16 + g;  // and krow + 8
  const float scale_log2 = scale * kLog2e;
  auto wait_full = [&](int it) {
    mbar_wait(bar_full + 8 * (it % kStages), (it / kStages) & 1);
  };
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * (it % kStages));
  };
  auto masked = [&](int q0) {
    return (causal && q0 < k0 + kM - 1) || q0 + kN > S || k0 + kM > S;
  };
  constexpr uint64_t half_kv = half_desc(kM), half_q = half_desc(kN);
  mbar_wait(bar_kv, 0);
  const uint64_t desc_k = sw128_desc(sK), desc_v = sw128_desc(sV);

  const int tw = threadIdx.x & (kWgThreads / 2 - 1);
  float acc[D / kHalfD][32];  // dv (warpgroup 0) or dk (warpgroup 1)
#pragma unroll
  for (int h = 0; h < D / kHalfD; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  float sc[32];
  uint32_t pa[4][4];
  // s^T = k.q^T (warpgroup 0) or dp^T = v.do^T (warpgroup 1), then
  // dv += p^T.do or dk += ds^T.q: one code path for both warpgroups,
  // since ptxas serialises wgmmas issued on divergent paths
  const uint64_t desc_a = wg == 0 ? desc_k : desc_v;
  const uint32_t sB = wg == 0 ? sQ : sdO, sC = wg == 0 ? sdO : sQ;
  for (int it = 0; it < n_it; ++it) {
    produce(it + 1);
    wait_full(it);
    const int s = it % kStages, b = it & 1;
    const int q0 = (qt0 + it) * kN;
    float* P = sP + b * kN * kM;  // [32][128]
    wgmma_fence();
    issue_abt<D>(sc, desc_a, half_kv, sw128_desc(sB + s * kQBytes), half_q);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    if (wg == 0) {
      p_tile(sc, sL + s * kN, masked(q0), q0, krow, t, S, causal,
             scale_log2);
      mbar_wait(p_empty + 8 * b, ((it >> 1) & 1) ^ 1);
#pragma unroll
      for (int i = 0; i < 32; ++i) P[i * (kWgThreads / 2) + tw] = sc[i];
      mbar_arrive(p_full + 8 * b);
    } else {
      const float* Dl = sDelta + s * kN;
      mbar_wait(p_full + 8 * b, (it >> 1) & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 8 * j + 2 * t + (i & 1);
          sc[4 * j + i] = P[(4 * j + i) * (kWgThreads / 2) + tw] *
                          (sc[4 * j + i] - Dl[c]) * scale;  // ds^T
        }
      mbar_arrive(p_empty + 8 * b);
    }
    pack_all(pa, sc);
    wgmma_fence();
    issue_ab<D, kN>(acc, pa, sw128_desc(sC + s * kQBytes), half_q);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    release(it);
  }
  store_frag<D>((wg == 0 ? dv : dk) + (size_t)bh * S * D, acc, krow, S, t);
}

// dq at D 256: the Q and dO tiles of 128 rows take 64 KB each, and a
// 64-row K or V tile 32 KB, so of flash_bwd_dq_kernel's four stages of
// both only three tiles fit beside them. K and V get rings of their own,
// two K stages and one V stage: 1024 + 128 KB + 3 x 32 KB + 7 barriers =
// 230,456 bytes. A K tile is held from its scores to ds.k, the whole of
// a tile's work, and a V tile only until dp is done, so K gets the second
// stage: K tile j + 1 loads during all of tile j, and V tile j + 1 from
// the end of dp (j) on, under ds and ds.k. In registers dq takes 128 a
// thread, s and dp 32 each and ds 16, one block an SM.
constexpr int kDq256KStages = 2;
constexpr int kDq256VStages = 1;

constexpr int dq256_smem_bytes() {
  return 1024 + 2 * kBlockM * 256 * 2 +
         (kDq256KStages + kDq256VStages) * kDqBlockN * 256 * 2 +
         (1 + 2 * (kDq256KStages + kDq256VStages)) * 8;
}

// Replaces _bwd_dq_kernel (flash_attention.py:160) for bf16 head dims
// 129-256. Bound at B*H 48, S 1024, D 256, causal: ~39 us by tensor-core
// operations, as at the main shape. The loop is flash_bwd_dq_kernel's (128
// Q rows a block, each warpgroup 64 of them; per 64-row K/V tile s = q.k^T
// and dp = do.v^T, ds = p.(dp - delta).scale packed to bf16, dq += ds.k in
// f32) over the two rings, with dp issued before s so that V is released
// as soon as dp is done.
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_d256_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int S, float scale,
                         int causal) {
  constexpr int D = 256;
  constexpr int kN = kDqBlockN;
  constexpr int kKS = kDq256KStages, kVS = kDq256VStages;
  constexpr int kH = D / kHalfD;
  constexpr int kQBytes = kBlockM * D * 2;
  constexpr int kTileBytes = kN * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const uint32_t sQ = smem_addr(sm);
  const uint32_t sdO = sQ + kQBytes;
  const uint32_t sK = sdO + kQBytes;          // + stage * kTileBytes
  const uint32_t sV = sK + kKS * kTileBytes;  // + stage * kTileBytes
  const uint32_t bar_q = sV + kVS * kTileBytes;  // Q and dO
  const uint32_t k_full = bar_q + 8;             // + 8 * stage
  const uint32_t k_empty = k_full + 8 * kKS;     // + 8 * stage
  const uint32_t v_full = k_empty + 8 * kKS;     // + 8 * stage
  const uint32_t v_empty = v_full + 8 * kVS;     // + 8 * stage

  const int q0 = ((S + kBlockM - 1) / kBlockM - 1 - blockIdx.x) * kBlockM;
  const int bh = blockIdx.y;  // a head's tiles run together, longest first
  const int n_kv = ((causal ? min(q0 + kBlockM, S) : S) + kN - 1) / kN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kKS; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kWgThreads / 32);
    }
    for (int s = 0; s < kVS; ++s) {
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, kWgThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Thread 0 is also the producer: a K tile j goes into its stage once all
  // eight warps have released tile j - kKS (after its ds.k), issued at the
  // start of tile j - 1; a V tile j once they have released tile j - kVS
  // (after its dp), issued after the ds of tile j - 1.
  auto produce = [&](uint32_t ring, uint32_t full, uint32_t empty,
                     int stages, const CUtensorMap* map, int j) {
    if (threadIdx.x == 0 && j < n_kv) {
      const int s = j % stages;
      mbar_wait(empty + 8 * s, ((j / stages) & 1) ^ 1);
      mbar_expect_tx(full + 8 * s, kTileBytes);
      tma_load_tile<D, kN>(ring + s * kTileBytes, map, full + 8 * s, j * kN,
                           bh);
    }
    __syncwarp();
  };
  auto produce_k = [&](int j) { produce(sK, k_full, k_empty, kKS, &tm_k, j); };
  auto produce_v = [&](int j) { produce(sV, v_full, v_empty, kVS, &tm_v, j); };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q, 2 * kQBytes);
    tma_load_tile<D, kBlockM>(sQ, &tm_q, bar_q, q0, bh);
    tma_load_tile<D, kBlockM>(sdO, &tm_do, bar_q, q0, bh);
  }
  produce_k(0);
  produce_v(0);

  // warpgroup wg owns rows q0 + 64 wg .. + 63 and uses the first n_w KV
  // tiles (under causal masking the block's last tile may lie wholly in
  // warpgroup 0's future)
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int wg_row0 = q0 + wg * 64;
  const int row = wg_row0 + (warp & 3) * 16 + g;  // and row + 8
  const int n_w = causal ? (min(wg_row0 + 64, S) + kN - 1) / kN : n_kv;
  const float scale_log2 = scale * kLog2e;
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    lse2[h] = r < S ? lse[(size_t)bh * S + r] * kLog2e : 0.f;
    dl[h] = r < S ? delta[(size_t)bh * S + r] : 0.f;
  }
  auto wait_k = [&](int it) {
    mbar_wait(k_full + 8 * (it % kKS), (it / kKS) & 1);
  };
  auto wait_v = [&](int it) {
    mbar_wait(v_full + 8 * (it % kVS), (it / kVS) & 1);
  };
  auto release_k = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty + 8 * (it % kKS));
  };
  auto release_v = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty + 8 * (it % kVS));
  };
  auto desc_k = [&](int it) {
    return sw128_desc(sK + (it % kKS) * kTileBytes);
  };
  auto desc_v = [&](int it) {
    return sw128_desc(sV + (it % kVS) * kTileBytes);
  };
  constexpr uint64_t half_q = half_desc(kBlockM), half_kv = half_desc(kN);
  float acc[kH][32];
#pragma unroll
  for (int h = 0; h < kH; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  float sc[32], dp[32];
  uint32_t da[4][4];

  mbar_wait(bar_q, 0);
  const uint64_t desc_q = sw128_desc(sQ + wg * 64 * kRowBytes);
  const uint64_t desc_do = sw128_desc(sdO + wg * 64 * kRowBytes);
  for (int it = 0; it < n_w; ++it) {
    produce_k(it + 1);
    wait_k(it);
    wait_v(it);
    wgmma_fence();
    issue_abt<D>(dp, desc_do, half_q, desc_v(it), half_kv);
    wgmma_commit();
    issue_abt<D>(sc, desc_q, half_q, desc_k(it), half_kv);
    wgmma_commit();
    wgmma_wait<1>();  // dp
    fence_regs(dp);
    release_v(it);
    wgmma_wait<0>();  // s
    fence_regs(sc);
    const int k0 = it * kN;
    const bool masked = (causal && k0 + kN - 1 > wg_row0) || k0 + kN > S;
    dq_tile(sc, dp, lse2, dl, masked, k0, row, t, S, causal, scale,
            scale_log2);
    produce_v(it + 1);
    pack_all(da, sc);
    wgmma_fence();
    issue_ab<D, kN>(acc, da, desc_k(it), half_kv);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    release_k(it);
  }
  for (int it = n_w; it < n_kv; ++it) {  // tiles this warpgroup skips
    produce_k(it + 1);
    wait_k(it);
    wait_v(it);
    release_v(it);
    produce_v(it + 1);
    release_k(it);
  }
  store_frag<D>(dq + (size_t)bh * S * D, acc, row, S, t);
}

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

// Looked up once; C++11 makes the static's initialisation thread-safe, so
// two host threads may launch at once.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = lookup_encode_tiled();
  return fn;
}

// A [BH, S, D] bf16 tensor as a 3-D tensor map with [box_rows x 64] boxes
// (one 128-byte swizzle row wide) in the 128-byte swizzle; rows past S
// read as zeros.
int make_map(CUtensorMap* map, const void* ptr, int bh, int seq, int d,
             int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return -1;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)seq, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)seq * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kHalfD, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -2;
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int seq, float scale, int causal,
               void* stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, bh, seq, D, kBlockM);
  if (err == 0) err = make_map(&tk, k, bh, seq, D, kFwdBlockN);
  if (err == 0) err = make_map(&tv, v, bh, seq, D, kFwdBlockN);
  if (err != 0) return err;
  constexpr int smem = fwd_smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((seq + kBlockM - 1) / kBlockM, bh);
  flash_fwd_kernel<D><<<grid, kWgThreads, smem, (cudaStream_t)stream>>>(
      tq, tk, tv, (bf16*)o, (float*)lse, seq, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int seq, float scale, int causal, void* stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = make_map(&tq, q, bh, seq, D, kDkvBlockN);
  if (err == 0) err = make_map(&tk, k, bh, seq, D, kBlockM);
  if (err == 0) err = make_map(&tv, v, bh, seq, D, kBlockM);
  if (err == 0) err = make_map(&tdo, dout, bh, seq, D, kDkvBlockN);
  if (err != 0) return err;
  constexpr int smem = dkv_smem_bytes<D>();
  const cudaError_t e =
      cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((seq + kBlockM - 1) / kBlockM, bh);
  flash_bwd_dkv_kernel<D><<<grid, kWgThreads, smem, (cudaStream_t)stream>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (bf16*)dk,
      (bf16*)dv, seq, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int seq,
              float scale, int causal, void* stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = make_map(&tq, q, bh, seq, D, kBlockM);
  if (err == 0) err = make_map(&tk, k, bh, seq, D, kDqBlockN);
  if (err == 0) err = make_map(&tv, v, bh, seq, D, kDqBlockN);
  if (err == 0) err = make_map(&tdo, dout, bh, seq, D, kBlockM);
  if (err != 0) return err;
  constexpr int smem = dq_smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((seq + kBlockM - 1) / kBlockM, bh);
  flash_bwd_dq_kernel<D><<<grid, kWgThreads, smem, (cudaStream_t)stream>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (bf16*)dq, seq,
      scale, causal);
  return (int)cudaGetLastError();
}

int launch_fwd256(const void* q, const void* k, const void* v, void* o,
                  void* lse, int bh, int seq, float scale, int causal,
                  void* stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, bh, seq, 256, kBlockM);
  if (err == 0) err = make_map(&tk, k, bh, seq, 256, kFwdBlockN);
  if (err == 0) err = make_map(&tv, v, bh, seq, 256, kFwdBlockN);
  if (err != 0) return err;
  constexpr int smem = fwd256_smem_bytes();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_d256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((seq + kBlockM - 1) / kBlockM, bh);
  flash_fwd_d256_kernel<<<grid, kWgThreads, smem, (cudaStream_t)stream>>>(
      tq, tk, tv, (bf16*)o, (float*)lse, seq, scale, causal);
  return (int)cudaGetLastError();
}

int launch_dkv256(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int bh, int seq, float scale, int causal,
                  void* stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = make_map(&tq, q, bh, seq, 256, kDkvBlockN);
  if (err == 0) err = make_map(&tk, k, bh, seq, 256, kDkv256BlockM);
  if (err == 0) err = make_map(&tv, v, bh, seq, 256, kDkv256BlockM);
  if (err == 0) err = make_map(&tdo, dout, bh, seq, 256, kDkvBlockN);
  if (err != 0) return err;
  constexpr int smem = dkv256_smem_bytes();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_d256_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((seq + kDkv256BlockM - 1) / kDkv256BlockM, bh);
  flash_bwd_dkv_d256_kernel
      <<<grid, kWgThreads, smem, (cudaStream_t)stream>>>(
          tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (bf16*)dk,
          (bf16*)dv, seq, scale, causal);
  return (int)cudaGetLastError();
}

int launch_dq256(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int bh, int seq, float scale, int causal,
                 void* stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = make_map(&tq, q, bh, seq, 256, kBlockM);
  if (err == 0) err = make_map(&tk, k, bh, seq, 256, kDqBlockN);
  if (err == 0) err = make_map(&tv, v, bh, seq, 256, kDqBlockN);
  if (err == 0) err = make_map(&tdo, dout, bh, seq, 256, kBlockM);
  if (err != 0) return err;
  constexpr int smem = dq256_smem_bytes();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_d256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((seq + kBlockM - 1) / kBlockM, bh);
  flash_bwd_dq_d256_kernel<<<grid, kWgThreads, smem, (cudaStream_t)stream>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (bf16*)dq, seq,
      scale, causal);
  return (int)cudaGetLastError();
}

// The forward (0), dk/dv (1) or dq (2) at head dim d and the dynamic shared
// memory of one block; nullptr for a kernel not built at d.
const void* kernel_fn(int kernel, int d, int* smem) {
  if (d == 64) {
    switch (kernel) {
      case 0: *smem = fwd_smem_bytes<64>(); return (const void*)flash_fwd_kernel<64>;
      case 1: *smem = dkv_smem_bytes<64>(); return (const void*)flash_bwd_dkv_kernel<64>;
      case 2: *smem = dq_smem_bytes<64>(); return (const void*)flash_bwd_dq_kernel<64>;
    }
  } else if (d == 128) {
    switch (kernel) {
      case 0: *smem = fwd_smem_bytes<128>(); return (const void*)flash_fwd_kernel<128>;
      case 1: *smem = dkv_smem_bytes<128>(); return (const void*)flash_bwd_dkv_kernel<128>;
      case 2: *smem = dq_smem_bytes<128>(); return (const void*)flash_bwd_dq_kernel<128>;
    }
  } else if (d == 256) {
    switch (kernel) {
      case 0: *smem = fwd256_smem_bytes(); return (const void*)flash_fwd_d256_kernel;
      case 1: *smem = dkv256_smem_bytes(); return (const void*)flash_bwd_dkv_d256_kernel;
      case 2: *smem = dq256_smem_bytes(); return (const void*)flash_bwd_dq_d256_kernel;
    }
  }
  return nullptr;
}

}  // namespace

extern "C" {

int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int seq, float scale, int causal,
                   void* stream) {
  return launch_fwd<64>(q, k, v, o, lse, bh, seq, scale, causal, stream);
}

int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int seq, float scale, int causal,
                      void* stream) {
  return launch_dq<64>(q, k, v, dout, lse, delta, dq, bh, seq, scale, causal,
                       stream);
}

int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int seq, float scale,
                       int causal, void* stream) {
  return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, seq, scale,
                        causal, stream);
}

// bf16 at head dim d = 128 (the wider bf16 head dims, padded to it); -3
// for another d
int flash_fwd_bf16w(const void* q, const void* k, const void* v, void* o,
                    void* lse, int bh, int seq, int d, float scale,
                    int causal, void* stream) {
  if (d != 128) return -3;
  return launch_fwd<128>(q, k, v, o, lse, bh, seq, scale, causal, stream);
}

int flash_bwd_dq_bf16w(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, int bh, int seq, int d, float scale,
                       int causal, void* stream) {
  if (d != 128) return -3;
  return launch_dq<128>(q, k, v, dout, lse, delta, dq, bh, seq, scale, causal,
                        stream);
}

int flash_bwd_dkv_bf16w(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int bh, int seq, int d,
                        float scale, int causal, void* stream) {
  if (d != 128) return -3;
  return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh, seq, scale,
                         causal, stream);
}

// bf16 at head dim d = 256 (head dims 129-256, padded to it); -3 for
// another d
int flash_fwd_bf16d256(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int seq, int d, float scale,
                       int causal, void* stream) {
  if (d != 256) return -3;
  return launch_fwd256(q, k, v, o, lse, bh, seq, scale, causal, stream);
}

int flash_bwd_dq_bf16d256(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, int bh, int seq, int d,
                          float scale, int causal, void* stream) {
  if (d != 256) return -3;
  return launch_dq256(q, k, v, dout, lse, delta, dq, bh, seq, scale, causal,
                      stream);
}

int flash_bwd_dkv_bf16d256(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int bh,
                           int seq, int d, float scale, int causal,
                           void* stream) {
  if (d != 256) return -3;
  return launch_dkv256(q, k, v, dout, lse, delta, dk, dv, bh, seq, scale,
                       causal, stream);
}

// The dynamic shared memory of one block of the forward (0), dk/dv (1) or
// dq (2) at head dim d; -3 for a kernel not built at d.
int flash_dynamic_smem_bytes(int kernel, int d) {
  int smem;
  return kernel_fn(kernel, d, &smem) == nullptr ? -3 : smem;
}

// Of the forward (0), dk/dv (1) or dq (2) at head dim d: out[0] registers
// a thread, out[1] the dynamic shared memory that the kernel's launches
// allow themselves (the runtime's default of 48 KB before the first
// launch), out[2] the blocks that one SM holds at once at the shared
// memory it launches with, out[3] its local memory a thread in bytes
// (spills). Returns a cudaError_t, or -3 for a kernel not built at d.
int flash_kernel_attributes(int kernel, int d, int* out) {
  int smem;
  const void* fn = kernel_fn(kernel, d, &smem);
  if (fn == nullptr) return -3;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = attr.maxDynamicSharedSizeBytes;
  out[3] = (int)attr.localSizeBytes;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], fn, kWgThreads,
                                                      smem);
  return (int)e;
}

}  // extern "C"
