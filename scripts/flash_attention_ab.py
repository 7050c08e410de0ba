#!/usr/bin/env python3
"""Times the flash-attention kernels of several checkouts of this repository
on one GPU, each checkout in its own process, in the order given:

    python scripts/flash_attention_ab.py build/ab/parent . . build/ab/parent

For each ROOT the child process imports ROOT's
``ray_tpu_torch.ops.flash_attention`` (its kernels build from ROOT's own
sources into ROOT/build/) and times, at GPT-2-small's attention shape
(B*H 192, S 1024, D 64, causal), in bf16 and in f32 (TF32 off, as in
chip_smoke.py), and in bf16 at chip_smoke.py's wide shape (B*H 96, S
1024, D 128, causal: the bf16_wide kernels), and in f32 and in bf16 at
chip_smoke.py's head-dim-256 shape (B*H 48, S 1024, D 256, causal), the
three kernels of each through their wrappers and
``F.scaled_dot_product_attention``'s forward and backward in that dtype.
The names end in the shape's suffix: ``_f32``, ``_bf16w``, ``_f32_d256``
and ``_bf16d256`` (bf16 at head dim 256: whatever route the root's
wrappers take there, the bf16_d256 kernels, or in an older root the f32
dq on bf16 cast to f32 beside them). A shape whose head dim a root's
kernels do not take is left out of its run.
Every root is timed with ``time_ms`` of THIS checkout's chip_smoke.py, so
two versions of the kernels are compared by one method. The host's own
time per wrapper call is measured too (the device is left to drain before
each such loop, so it is the host's work alone).

The f32 kernels at head dim 256 are flash_attention_f32.cu's
flash_fwd_d256_tc_kernel and flash_bwd_dq_d256_tc_kernel (3xTF32 on
wgmma) and flash_bwd_dkv_d256_tc_kernel, under ``_f32_d256``. Head dim
512 (B*H 24, chip_smoke.py's DSPLIT_SHAPE) times the split-head-dim
kernels of flash_attention_dsplit.cu, under ``_f32ds`` and ``_bf16ds``, and
float16's route there (the f32 kernels on f32 copies) under ``_f16ds``.
``FLASH_AB_SHAPES`` (suffixes, comma-separated, "" for the bf16 main
shape) times those shapes alone.

Prints the card's name and power limit, one JSON line per run, and the
median over the runs of each root. Needs one CUDA device.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
B = 16
# suffix -> (B*H, S, D, dtype name)
SHAPES = {"": (192, 1024, 64, "bfloat16"), "_f32": (192, 1024, 64, "float32"),
          "_bf16w": (96, 1024, 128, "bfloat16"),
          "_f32_d256": (48, 1024, 256, "float32"),
          "_bf16d256": (48, 1024, 256, "bfloat16"),
          "_f32ds": (24, 1024, 512, "float32"),
          "_bf16ds": (24, 1024, 512, "bfloat16"),
          "_f16ds": (24, 1024, 512, "float16")}
NAMES = [f"{name}{suffix}" for suffix in SHAPES for name in (
    "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "sdpa_fwd", "sdpa_bwd")]


def child(root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention as fa

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timer", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if not torch.cuda.is_available():
        sys.exit("flash_attention_ab: needs a CUDA device")
    if os.path.dirname(os.path.abspath(fa.__file__)) != os.path.join(
            os.path.abspath(root), "ray_tpu_torch", "ops"):
        sys.exit(f"flash_attention_ab: imported {fa.__file__}, not {root}'s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    fns = {}
    only = os.environ.get("FLASH_AB_SHAPES")
    for suffix, (BH, S, D, dtype) in SHAPES.items():
        if only is not None and suffix not in only.split(","):
            continue
        try:
            fa.kernel_plan(getattr(torch, dtype), D)
        except ValueError:
            continue  # this root's kernels do not take the head dim
        fns.update(functions(torch, F, fa, gen, suffix, BH, S, D, dtype))
    out = {"root": root}
    for name, fn in fns.items():
        out[name] = statistics.median(
            smoke.time_ms(torch, fn, warmup=3, reps=30) for _ in range(3))
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if name not in fns:
            continue
        fns[name]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fns[name]()
        out[f"{name}_host_us"] = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
    print(json.dumps(out), flush=True)


def functions(torch, F, fa, gen, suffix, BH, S, D, dtype):
    """{name + suffix: fn} of the three kernels and SDPA's forward and
    backward on one set of seeded [BH, S, D] inputs of ``dtype``."""
    kw = dict(scale=D ** -0.5, causal=True)
    q, k, v, do = (torch.randn(BH, S, D, generator=gen, device="cuda")
                   .to(getattr(torch, dtype)) for _ in range(4))
    o_ref, lse = fa.flash_fwd_plain(q, k, v, **kw)
    delta = (do.float() * o_ref.float()).sum(dim=-1)
    b = math.gcd(BH, B)
    q4, k4, v4 = (x.view(b, BH // b, S, D).detach().requires_grad_(True)
                  for x in (q, k, v))
    out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                          scale=kw["scale"])
    do4 = do.view(b, BH // b, S, D)
    fns = {
        "flash_fwd": lambda: fa.flash_fwd(q, k, v, **kw),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw),
        "sdpa_fwd": lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, scale=kw["scale"]),
        "sdpa_bwd": lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                                retain_graph=True),
    }
    return {name + suffix: fn for name, fn in fns.items()}


def main(roots) -> int:
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    runs = []
    for root in roots:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", root], stdout=subprocess.PIPE,
                             text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout, flush=True)
            return res.returncode
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    for root in dict.fromkeys(roots):
        mine = [r for r in runs if r["root"] == root]
        cells = ", ".join(
            f"{n} {statistics.median(r[n] for r in mine):.4f} ms" for n in NAMES
            if n in mine[0])
        print(f"median of {len(mine)} run(s) of {root}: {cells}", flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
