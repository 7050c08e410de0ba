#!/usr/bin/env python3
"""Variants of the wgmma kernels above head dim 256 (of
ray_tpu_torch/ops/csrc/flash_attention_dsplit.cu: f32's forward, dq and
dk/dv, flash_fwd_ws_kernel, flash_bwd_dq_ws_kernel and
flash_bwd_dkv_ws_kernel, and bf16's, flash_fwd_tma_kernel,
flash_bwd_dq_tma_kernel and flash_bwd_dkv_tma_kernel) on one GPU, in one
process:

    python scripts/dsplit_ab.py [variant ...]

Each variant is the source with a few lines replaced; it builds into a
library of its own under build/dsplit_ab/<variant>/ with the package's
nvcc flags, is called through its C entry points, and (unless it computes
something else on purpose) is held to the plain versions within the bound
of its dtype. Then each is timed at chip_smoke.py's DSPLIT_SHAPE (B*H 24,
S 1024, D 512, causal) in turns, v0..vn then vn..v0, with chip_smoke.py's
``time_ms``. Variants (all of them by default):

  base        the source as it is
  noload      the loads replaced: f32's producer writes zeros where it
              would load, bf16's loads are no copies and arrive on their
              barriers with no bytes to wait for: what the consumers and
              (f32) the split alone take (not checked)
  lookahead2  f32's producer two items ahead in registers, not one
  profile     clock64 counters, summed over the blocks of one launch. f32:
              the consumer's waits for full stages and for its wgmmas,
              the producer's waits for free stages, its loads and its
              stores; bf16's forward (thread 0): the consumers' waits for
              K boxes and for V, and their time counting boxes done and
              refilling stages; bf16's dq and dk/dv (the first thread of
              each warpgroup): the waits for ring stages and for the
              chunk, the time counting boxes done and refilling stages,
              and dk/dv's waits to hand p^T over

Prints the card's name and power limit, each variant's registers, local
bytes and checks, its times, and the profile's counters. Needs one CUDA
device.
"""
from __future__ import annotations

import ctypes
import importlib.util
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "ray_tpu_torch", "ops", "csrc")
SOURCE = "flash_attention_dsplit.cu"
SHAPE = (24, 1024, 512)
CHECKS = [(24, 1024, 512, True), (2, 129, 320, True), (2, 1000, 576, False),
          (1, 1000, 1024, True), (2, 200, 448, True), (2, 1024, 512, False)]
# kernel -> (C entry, its kernel id for the attributes, bf16)
KERNELS = {"fwd": ("flash_fwd_f32ds", 0, False),
           "dq": ("flash_bwd_dq_f32ds", 2, False),
           "dk/dv": ("flash_bwd_dkv_f32ds", 1, False),
           "bf16 fwd": ("flash_fwd_bf16ds", 0, True),
           "bf16 dq": ("flash_bwd_dq_bf16ds", 2, True),
           "bf16 dk/dv": ("flash_bwd_dkv_bf16ds", 1, True)}

LOAD = ('''  return valid ? __ldg(reinterpret_cast<const float4*>(p))
               : make_float4(0.f, 0.f, 0.f, 0.f);''')
HINTED_LOAD = "  if (valid)\n    asm volatile("
TMA_COPY = '''      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),'''
TMA_BYTES = '''      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)'''
LOOP = '''  WsRaw a, b;
  load(a, 0);
  for (int k = 0; k < total; k += 2) {
    if (k + 1 < total) load(b, k + 1);
    store(a, k);
    if (k + 1 < total) {
      if (k + 2 < total) load(a, k + 2);
      store(b, k + 1);
    }
  }'''
LOOP2 = '''  WsRaw r0, r1, r2;
  load(r0, 0);
  if (1 < total) load(r1, 1);
  for (int k = 0; k < total; k += 3) {
    if (k + 2 < total) load(r2, k + 2);
    store(r0, k);
    if (k + 1 < total) {
      if (k + 3 < total) load(r0, k + 3);
      store(r1, k + 1);
    }
    if (k + 2 < total) {
      if (k + 4 < total) load(r1, k + 4);
      store(r2, k + 2);
    }
  }'''
COUNTERS = ["consumer waits for full stages", "consumer waits for its wgmmas",
            "producer waits for free stages", "producer loads",
            "producer splits and stores", "consumers wait for K boxes",
            "consumers wait for V", "consumers count boxes done and refill",
            "warpgroups wait for ring stages", "warpgroups wait for the chunk",
            "warpgroups count boxes done and refill",
            "warpgroups wait to hand p^T over"]
# kernel -> the counters it adds to
COUNTERS_OF = {"fwd": range(5), "dq": range(5), "dk/dv": range(5),
               "bf16 fwd": range(5, 8), "bf16 dq": range(8, 11),
               "bf16 dk/dv": range(8, 12)}
PROFILE_DEF = '''__device__ unsigned long long g_prof[12];
__device__ __forceinline__ void prof_add(int i, long long t0) {
  atomicAdd(&g_prof[i], (unsigned long long)(clock64() - t0));
}

// What a block's producer streams:'''
PROFILE_READ = '''
extern "C" int ws_prof(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  const unsigned long long zero[12] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  return (int)e;
}
'''
# (text, text with counters): thread 0 counts for the consumers, thread
# kTcThreads (f32) for the producer
PROFILE_EDITS = [
    ("    mbar_wait(bars + 16 * slot, (at / kStages) & 1);\n",
     "    long long t0 = clock64();\n"
     "    mbar_wait(bars + 16 * slot, (at / kStages) & 1);\n"
     "    if (threadIdx.x == 0) prof_add(0, t0);\n"),
    ("    wgmma_commit();\n    wgmma_wait<0>();\n    fence_regs(part);",
     "    wgmma_commit();\n    t0 = clock64();\n    wgmma_wait<0>();\n"
     "    if (threadIdx.x == 0) prof_add(1, t0);\n    fence_regs(part);"),
    ("      mbar_wait(sb + 8, ((idx / kStages) & 1) ^ 1);  // use idx - kStages\n"
     "      store_stage(ring + slot * (kStageBytes / 4), t, i);\n"
     "      fence_proxy_async();\n      mbar_arrive(sb);",
     "      long long t0 = clock64();\n"
     "      mbar_wait(sb + 8, ((idx / kStages) & 1) ^ 1);  // use idx - kStages\n"
     "      if (i == 0) prof_add(2, t0);\n      t0 = clock64();\n"
     "      store_stage(ring + slot * (kStageBytes / 4), t, i);\n"
     "      fence_proxy_async();\n      mbar_arrive(sb);\n"
     "      if (i == 0) prof_add(4, t0);"),
    ("  auto load = [&](WsRaw& t, int k) {\n",
     "  auto load = [&](WsRaw& t, int k) {\n    const long long tl = clock64();\n"),
    ("                 job.D, i);\n    }\n  };",
     "                 job.D, i);\n    }\n    if (i == 0) prof_add(3, tl);\n  };"),
    ("  mbar_wait(t.bars + 8 * slot, (idx / kKStages) & 1);\n",
     "  const long long t0 = clock64();\n"
     "  mbar_wait(t.bars + 8 * slot, (idx / kKStages) & 1);\n"
     "  if (threadIdx.x == 0) prof_add(5, t0);\n"),
    ("    mbar_wait(v_full, (it - 1) & 1);\n",
     "    const long long t0 = clock64();\n"
     "    mbar_wait(v_full, (it - 1) & 1);\n"
     "    if (threadIdx.x == 0) prof_add(6, t0);\n"),
    ("__device__ __forceinline__ void tma_done_k(const TmaBlock& t, int idx) {\n",
     "__device__ __forceinline__ void tma_done_k(const TmaBlock& t, int idx) {\n"
     "  const long long t0 = clock64();\n"),
    ("    tma_load_k(t, idx + kKStages);\n}",
     "    tma_load_k(t, idx + kKStages);\n"
     "  if (threadIdx.x == 0) prof_add(7, t0);\n}"),
    ("  mbar_wait(t.bars + 8 * slot, (idx / kBwdStages) & 1);\n",
     "  const long long t0 = clock64();\n"
     "  mbar_wait(t.bars + 8 * slot, (idx / kBwdStages) & 1);\n"
     "  if ((threadIdx.x & 127) == 0) prof_add(8, t0);\n"),
    ("    mbar_wait(chunk_full, it & 1);\n",
     "    const long long t0 = clock64();\n"
     "    mbar_wait(chunk_full, it & 1);\n"
     "    if ((threadIdx.x & 127) == 0) prof_add(9, t0);\n"),
    ("    mbar_wait(chunk_full, j & 1);\n",
     "    const long long t0 = clock64();\n"
     "    mbar_wait(chunk_full, j & 1);\n"
     "    if ((threadIdx.x & 127) == 0) prof_add(9, t0);\n"),
    ("__device__ __forceinline__ void bwd_done_box(const BwdBlock& t, int idx) {\n",
     "__device__ __forceinline__ void bwd_done_box(const BwdBlock& t, int idx) {\n"
     "  const long long t0 = clock64();\n"),
    ("    bwd_load_stage<kDq>(t, idx + kBwdStages);\n}",
     "    bwd_load_stage<kDq>(t, idx + kBwdStages);\n"
     "  if ((threadIdx.x & 127) == 0) prof_add(10, t0);\n}"),
    ("      mbar_wait(p_empty, (j & 1) ^ 1);\n",
     "      const long long t1 = clock64();\n"
     "      mbar_wait(p_empty, (j & 1) ^ 1);\n"
     "      if (threadIdx.x == 0) prof_add(11, t1);\n"),
    ("      mbar_wait(p_full, j & 1);\n",
     "      const long long t1 = clock64();\n"
     "      mbar_wait(p_full, j & 1);\n"
     "      if (threadIdx.x == kTcThreads) prof_add(11, t1);\n"),
]


def _replace(text, old, new):
    if text.count(old) != 1:
        sys.exit(f"dsplit_ab: the source no longer has one {old[:60]!r}")
    return text.replace(old, new)


def variants(src):
    """{name: (source, whether its results are the kernels')}."""
    profile = _replace(src, "// What a block's producer streams:",
                       PROFILE_DEF)
    for old, new in PROFILE_EDITS:
        profile = _replace(profile, old, new)
    noload = _replace(src, LOAD, "  return make_float4(0.f, 0.f, 0.f, 0.f);")
    # the own tile's hinted load, too
    noload = _replace(noload, HINTED_LOAD, "  if (false)\n    asm volatile(")
    noload = _replace(noload, TMA_COPY, '      "" ::"r"(dst),')
    noload = _replace(noload, TMA_BYTES, TMA_BYTES.replace('"r"(bytes)',
                                                           '"r"(0)'))
    return {"base": (src, True), "noload": (noload, False),
            "lookahead2": (_replace(src, LOOP, LOOP2), True),
            "profile": (profile + PROFILE_READ, True)}


def check(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"dsplit_ab: a launch returned {err}")


def build(names, sources):
    from ray_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    jobs = {}
    for name in names:
        out = os.path.join(REPO, "build", "dsplit_ab", name)
        os.makedirs(out, exist_ok=True)
        for header in os.listdir(CSRC):
            if header.endswith(".cuh"):
                shutil.copy(os.path.join(CSRC, header), out)
        with open(os.path.join(out, SOURCE), "w") as f:
            f.write(sources[name][0])
        jobs[name] = (subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", os.path.join(out, "lib.so"),
             os.path.join(out, SOURCE)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"dsplit_ab: {name} did not build\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(os.path.join(out, "lib.so"))
    return libs


def main(names) -> int:
    import torch

    sys.path.insert(0, REPO)
    from ray_tpu_torch.ops import flash_attention as fa

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timer", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if not torch.cuda.is_available():
        print("dsplit_ab: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    with open(os.path.join(CSRC, SOURCE)) as f:
        sources = variants(f.read())
    names = names or list(sources)
    libs = build(names, sources)
    for lib in libs.values():
        lib.flash_fwd_f32ds.argtypes = fa._FWD_D
        lib.flash_fwd_bf16ds.argtypes = fa._FWD_D
        lib.flash_bwd_dq_f32ds.argtypes = fa._DQ_D
        lib.flash_bwd_dkv_f32ds.argtypes = fa._DKV_D
        lib.flash_bwd_dq_bf16ds.argtypes = fa._DQ_D
        lib.flash_bwd_dkv_bf16ds.argtypes = fa._DKV_D
        lib.flash_dsplit_kernel_attributes.argtypes = fa._ATTRIBUTES
    for name, lib in libs.items():
        for which, (_, kernel, bf16) in KERNELS.items():
            out = (ctypes.c_int * 4)()
            lib.flash_dsplit_kernel_attributes(kernel, int(bf16), out)
            print(f"{name} {which}: {out[0]} registers, {out[1]} bytes of "
                  f"shared memory, {out[2]} blocks an SM, {out[3]} bytes of "
                  f"local memory", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)

    def launches(lib, ins, scale, causal):
        """{kernel: (launch, its outputs)} on ins[dtype] = (q, k, v, do,
        lse, delta)."""
        stream = torch.cuda.current_stream().cuda_stream
        out = {}
        for which, (entry, _, bf16) in KERNELS.items():
            q, k, v, do, lse, delta = ins[bf16]
            BH, S, D = q.shape
            fn = getattr(lib, entry)
            if which in ("fwd", "bf16 fwd"):
                outs = (torch.empty_like(q), torch.empty_like(lse))
                args = (q, k, v, *outs)
            elif which.endswith("dq"):
                outs = (torch.empty_like(q),)
                args = (q, k, v, do, lse, delta, *outs)
            else:
                outs = (torch.empty_like(k), torch.empty_like(v))
                args = (q, k, v, do, lse, delta, *outs)
            ptrs = [x.data_ptr() for x in args]
            out[which] = (lambda fn=fn, ptrs=ptrs, BH=BH, S=S, D=D: check(
                fn(*ptrs, BH, S, D, scale, int(causal), stream)), outs)
        return out

    def worst(a, b, bf16):
        rtol, atol, floor = ((2 ** -6, 2 ** -3, 1e-5) if bf16 else
                             (2 ** -14, 2 ** -14, 1e-6))
        if a.dim() == 2:  # lse
            return (a - b).abs().max().item() / 2e-5
        a, b = a.float(), b.float()
        return ((a - b).abs() / (rtol * b.abs() + atol * b.square().mean()
                                 .sqrt() + floor)).max().item()

    for BH, S, D, causal in CHECKS:
        kw = dict(scale=D ** -0.5, causal=causal)
        ins, want = {}, {}
        for bf16 in (False, True):
            dtype = torch.bfloat16 if bf16 else torch.float32
            q, k, v, do = (torch.randn(BH, S, D, generator=gen, device="cuda")
                           .to(dtype) for _ in range(4))
            o, lse = fa.flash_fwd_plain(q, k, v, **kw)
            delta = (do.float() * o.float()).sum(-1)
            ins[bf16] = (q, k, v, do, lse, delta)
            pre = "bf16 " if bf16 else ""
            want[pre + "fwd"] = (o, lse)
            want[pre + "dq"] = (fa.flash_bwd_dq_plain(q, k, v, do, lse,
                                                      delta, **kw),)
            want[pre + "dk/dv"] = fa.flash_bwd_dkv_plain(q, k, v, do, lse,
                                                         delta, **kw)
        for name, lib in libs.items():
            for which, (fn, outs) in launches(lib, ins, **kw).items():
                fn()
                torch.cuda.synchronize()
                if not sources[name][1]:
                    continue
                bf16 = KERNELS[which][2]
                w = max(worst(a, b, bf16) for a, b in zip(outs, want[which]))
                print(f"check {name} {which} BH={BH} S={S} D={D} causal="
                      f"{causal}: worst element {w:.3f} of the "
                      f"{'bf16' if bf16 else 'f32'} bound "
                      f"{'ok' if w <= 1 else 'FAIL'}", flush=True)
        if (BH, S, D) != SHAPE or not causal:
            continue
        timed = {name: launches(lib, ins, **kw) for name, lib in libs.items()}
        times = {name: {w: [] for w in KERNELS} for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            for which, (fn, _) in timed[name].items():
                times[name][which].append(
                    smoke.time_ms(torch, fn, warmup=3, reps=20))
        for name in libs:
            print(f"time {name} (BH={BH} S={S} D={D} causal): " + ", ".join(
                f"{w} {' / '.join(f'{t:.4f}' for t in ts)} ms"
                for w, ts in times[name].items()), flush=True)
        if "profile" in libs:
            lib = libs["profile"]
            lib.ws_prof.argtypes = [ctypes.c_void_p]
            counts = (ctypes.c_ulonglong * len(COUNTERS))()
            for which, (fn, _) in timed["profile"].items():
                lib.ws_prof(ctypes.addressof(counts))  # reset
                fn()
                torch.cuda.synchronize()
                lib.ws_prof(ctypes.addressof(counts))
                kept = COUNTERS_OF[which]
                print(f"profile {which}, Mcycles summed over the blocks: "
                      + ", ".join(f"{COUNTERS[i]} {counts[i] / 1e6:.1f}"
                                  for i in kept), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
