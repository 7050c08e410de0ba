#!/usr/bin/env python3
"""Variants of the f32 dq and dk/dv above head dim 256 (flash_bwd_dq_ws_kernel
and flash_bwd_dkv_ws_kernel of ray_tpu_torch/ops/csrc/flash_attention_dsplit.cu)
on one GPU, in one process:

    python scripts/dsplit_ab.py [variant ...]

Each variant is the source with a few lines replaced; it builds into a
library of its own under build/dsplit_ab/<variant>/ with the package's
nvcc flags, is called through its C entry points, and (unless it computes
something else on purpose) is held to the plain versions within the f32
bound. Then each is timed at chip_smoke.py's DSPLIT_SHAPE (B*H 24, S 1024,
D 512, causal) in turns, v0..vn then vn..v0, with chip_smoke.py's
``time_ms``. Variants (all of them by default):

  base        the source as it is
  noload      the producer writes zeros where it would load: what the
              consumer and the split alone take (not checked)
  lookahead2  the producer two items ahead in registers, not one
  profile     clock64 counters, summed over the blocks of one launch: the
              consumer's waits for full stages and for its wgmmas, the
              producer's waits for free stages, its loads and its stores

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
CHECKS = [(24, 1024, 512, True), (2, 129, 320, True), (2, 1000, 576, False)]

LOAD = ('''  return valid ? __ldg(reinterpret_cast<const float4*>(p))
               : make_float4(0.f, 0.f, 0.f, 0.f);''')
HINTED_LOAD = "  if (valid)\n    asm volatile("
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
            "producer splits and stores"]
PROFILE_DEF = '''__device__ unsigned long long g_prof[5];
__device__ __forceinline__ void prof_add(int i, long long t0) {
  atomicAdd(&g_prof[i], (unsigned long long)(clock64() - t0));
}

// What a block's producer streams:'''
PROFILE_READ = '''
extern "C" int ws_prof(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  const unsigned long long zero[5] = {0, 0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  return (int)e;
}
'''
# (text, text with counters): thread 0 counts for the consumer, thread
# kTcThreads for the producer
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
        lib.flash_bwd_dq_f32ds.argtypes = fa._DQ_D
        lib.flash_bwd_dkv_f32ds.argtypes = fa._DKV_D
        lib.flash_dsplit_kernel_attributes.argtypes = fa._ATTRIBUTES
    for name, lib in libs.items():
        for kernel, which in ((2, "dq"), (1, "dk/dv")):
            out = (ctypes.c_int * 4)()
            lib.flash_dsplit_kernel_attributes(kernel, 0, out)
            print(f"{name} {which}: {out[0]} registers, {out[1]} bytes of "
                  f"shared memory, {out[2]} blocks an SM, {out[3]} bytes of "
                  f"local memory", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)

    def launches(lib, q, k, v, do, lse, delta, scale, causal):
        BH, S, D = q.shape
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        stream = torch.cuda.current_stream().cuda_stream
        common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr())

        def run_dq():
            check(lib.flash_bwd_dq_f32ds(*common, dq.data_ptr(), BH, S, D,
                                         scale, int(causal), stream))

        def run_dkv():
            check(lib.flash_bwd_dkv_f32ds(*common, dk.data_ptr(),
                                          dv.data_ptr(), BH, S, D, scale,
                                          int(causal), stream))
        return {"dq": (run_dq, (dq,)), "dk/dv": (run_dkv, (dk, dv))}

    timed = {}
    for BH, S, D, causal in CHECKS:
        q, k, v, do = (torch.randn(BH, S, D, generator=gen, device="cuda")
                       for _ in range(4))
        kw = dict(scale=D ** -0.5, causal=causal)
        o, lse = fa.flash_fwd_plain(q, k, v, **kw)
        delta = (do * o).sum(-1)
        want = {"dq": (fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw),),
                "dk/dv": fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)}
        for name, lib in libs.items():
            for which, (fn, outs) in launches(lib, q, k, v, do, lse, delta,
                                              **kw).items():
                fn()
                torch.cuda.synchronize()
                if not sources[name][1]:
                    continue
                worst = max(((a - b).abs() / (2 ** -14 * b.abs() + 2 ** -14 *
                             b.square().mean().sqrt() + 1e-6)).max().item()
                            for a, b in zip(outs, want[which]))
                print(f"check {name} {which} BH={BH} S={S} D={D} causal="
                      f"{causal}: worst element {worst:.3f} of the f32 bound "
                      f"{'ok' if worst <= 1 else 'FAIL'}", flush=True)
        if (BH, S, D) == SHAPE and causal:
            timed = {name: launches(lib, q, k, v, do, lse, delta, **kw)
                     for name, lib in libs.items()}
            times = {name: {w: [] for w in ("dq", "dk/dv")} for name in libs}
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
                    print(f"profile {which}, Mcycles summed over the blocks: "
                          + ", ".join(f"{c} {counts[i] / 1e6:.1f}"
                                      for i, c in enumerate(COUNTERS)),
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
