#!/usr/bin/env python3
"""Measures the rate of warp-level tensor-core products (``mma.sync``) on
one GPU, the instruction the f32 dq and dk/dv kernels of
``ray_tpu_torch/ops/csrc/flash_attention_f32.cu`` are built on:

    python scripts/mma_sync_rate.py

Builds a small CUDA source with ``nvcc`` into ``build/mma_sync_rate/``
and times, with CUDA events, kernels in which every warp issues
``m16n8k8`` tf32 or ``m16n8k16`` bf16 products (f32 accumulators) on
registers only: ``chains`` independent accumulators a warp (the
instruction-level parallelism a warp offers) at 4, 8 and 16 warps an SM.
Prints the card's name and power limit, then one line a case with its
TFLOP/s and the cycles an SM sub-partition takes for one instruction.
Needs one CUDA device and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "mma_sync_rate")
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int CHAINS>
__global__ void tf32_rate(const uint32_t* in, float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = in[(threadIdx.x + i) & 63];
  for (int i = 0; i < 2; ++i) b[i] = in[(threadIdx.x + 7 * i) & 63];
  float c[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int k = 0; k < CHAINS; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int CHAINS>
__global__ void bf16_rate(const uint32_t* in, float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = in[(threadIdx.x + i) & 63];
  for (int i = 0; i < 2; ++i) b[i] = in[(threadIdx.x + 7 * i) & 63];
  float c[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int k = 0; k < CHAINS; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// Milliseconds of one launch of the kind (0 tf32, 1 bf16) at `chains`
// accumulators a warp, `blocks` blocks of 128 threads, `iters` steps.
extern "C" float mma_rate_ms(int kind, int chains, int blocks, int iters,
                             const void* in, void* out) {
  cudaEvent_t t0, t1;
  cudaEventCreate(&t0);
  cudaEventCreate(&t1);
  const uint32_t* i = (const uint32_t*)in;
  float* o = (float*)out;
  auto launch = [&]() {
    if (kind == 0) {
      if (chains == 1) tf32_rate<1><<<blocks, 128>>>(i, o, iters);
      else if (chains == 3) tf32_rate<3><<<blocks, 128>>>(i, o, iters);
      else tf32_rate<8><<<blocks, 128>>>(i, o, iters);
    } else {
      if (chains == 1) bf16_rate<1><<<blocks, 128>>>(i, o, iters);
      else if (chains == 3) bf16_rate<3><<<blocks, 128>>>(i, o, iters);
      else bf16_rate<8><<<blocks, 128>>>(i, o, iters);
    }
  };
  launch();  // warm-up
  cudaEventRecord(t0);
  launch();
  cudaEventRecord(t1);
  cudaEventSynchronize(t1);
  float ms = -1.f;
  if (cudaGetLastError() == cudaSuccess) cudaEventElapsedTime(&ms, t0, t1);
  cudaEventDestroy(t0);
  cudaEventDestroy(t1);
  return ms;
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mma_sync_rate: needs a CUDA device", file=sys.stderr)
        return 1
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    os.makedirs(OUT, exist_ok=True)
    src, lib = os.path.join(OUT, "rate.cu"), os.path.join(OUT, "librate.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", lib, src], check=True)
    rate = ctypes.CDLL(lib).mma_rate_ms
    rate.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    rate.restype = ctypes.c_float
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_ghz = 1.755  # the H100 SXM's clock under tensor load, for cycles
    inp = torch.randint(0, 1 << 20, (64,), dtype=torch.int32, device="cuda")
    iters = 4096
    for kind, name, macs in ((0, "tf32 m16n8k8", 16 * 8 * 8),
                             (1, "bf16 m16n8k16", 16 * 8 * 16)):
        for chains in (1, 3, 8):
            for warps_per_sm in (4, 8, 16):
                blocks = sms * warps_per_sm // 4
                out = torch.empty(blocks * 128, device="cuda")
                ms = rate(kind, chains, blocks, iters, inp.data_ptr(),
                          out.data_ptr())
                if ms <= 0:
                    print(f"mma_sync_rate: {name} launch failed")
                    return 1
                n = blocks * 4 * iters * chains  # instructions
                tflops = 2 * macs * n / (ms * 1e-3) / 1e12
                cycles = ms * 1e-3 * clock_ghz * 1e9 / (n / (4 * sms))
                print(f"{name}: {chains} chains a warp, {warps_per_sm} warps "
                      f"an SM: {tflops:.1f} TFLOP/s, {cycles:.2f} cycles an "
                      f"instruction a sub-partition (at {clock_ghz} GHz)",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
