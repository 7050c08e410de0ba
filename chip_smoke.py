#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python chip_smoke.py        # from the repository root, on a GPU machine

Phases, each of which exits non-zero on failure:

1. header: the card's name and power limit, and the kernels' build, with
   each kernel's registers, dynamic shared memory and blocks per SM;
2. each hand-written kernel against its plain PyTorch version on the card,
   in bf16, at GPT-2-small's attention shape (B*H 192, S 1024, D 64,
   causal), two ragged S (1000, and 129: one row past a 128-row tile) and
   a non-causal case; times of the kernel, the plain version and the
   PyTorch library call (SDPA) beside the bound, with the kernel's TFLOP/s
   and the share of its bound that it reaches; and the backward as
   ``_FlashAttention.backward`` runs it (delta, dq, dk/dv) against SDPA's;
3. the main path: GPT-2-small at full width (12 layers, 12 heads, d 768,
   vocab 50304, seq 1024) training at batch 16 through ``make_train_step``
   (2 warm-up and 5 timed steps, weights from a seeded generator), with
   every launch counter set to 0 just before and read just after; the
   gradients of the attention leaves from the same weights, and the first
   step's loss and grad norm, held against reference attention (whose
   step is timed too); then one more step under ``torch.profiler``:
   device time by kernel category and by operator, and the device's busy
   time, from which PERF.md's "Where the time goes" is written.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of
the repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
HEAD_DIM = 64
SCALE = 1.0 / math.sqrt(HEAD_DIM)
# Kernel vs plain version, both in bf16 with f32 accumulation, element by
# element: |kernel - plain| <= BF16_RTOL * |plain| + ATOL_RMS * rms(plain)
# + ABS_FLOOR. The two round at the same points but sum in other orders,
# so (a) an output may round to the neighbouring bf16 value, at most one
# ulp, which is at most half of BF16_RTOL; and (b) now and then one term's
# bf16 rounding (p before p.v and dv, ds before dq and dk) falls the other
# way, which moves that sum by up to an ulp of its largest term, ~2^-8 of
# it: up to 7.8e-3 in dk at the main shape, where the tensor's rms is
# 0.11. With these limits the worst element of each check reads at most
# 0.32 of its bound, and a forward that skips one KV tile in the last 64
# rows only reads 6 to 29 times it (PERF.md, PR 1). ABS_FLOOR is f32
# noise where the exact result is 0 (at S = 1, dq = 0 since o = v).
BF16_RTOL = 2.0 ** -6
ATOL_RMS = 2.0 ** -3
ABS_FLOOR = 1e-5
# lse is f32 throughout; it is at most ~8 here, where an f32 ulp is 9.5e-7.
LSE_ABS_TOL = 2e-5
# GPT-2-small's first step, flash vs reference attention on the card, both
# bf16 (flash rounds p to bf16 before p.v, reference keeps it f32). At
# init the loss is ~ln(V) whatever attention computes, so the gate that
# sees the kernels is the gradient of the attention leaves: wq and wk get
# theirs only through dq and dk, wv through dv, wo through o. Readings
# (PERF.md, PR 1): loss 2.5e-6 and grad norm 1.8e-4 relative; attention
# leaves 1.0e-2 to 1.4e-2, against 4.6e-2 for wq when dq skips one KV tile
# in the last 64 rows of the sequence only, and 0.32 when the second
# warpgroup of every 128-row dq tile skips KV tile 0 (PERF.md).
# ATTN_GRAD_RTOL sits between.
LOSS_RTOL = 1e-4
GRAD_NORM_RTOL = 2e-3
ATTN_GRAD_RTOL = 2.5e-2  # ||g_flash - g_ref|| / ||g_ref|| per attention leaf

KERNELS = [
    {"name": "flash_fwd", "replaces": "ray_tpu/ops/flash_attention.py:29"},
    {"name": "flash_bwd_dq", "replaces": "ray_tpu/ops/flash_attention.py:160"},
    {"name": "flash_bwd_dkv", "replaces": "ray_tpu/ops/flash_attention.py:212"},
]
SOURCE = "ray_tpu_torch/ops/csrc/flash_attention.cu"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def time_ms(torch, fn, *, warmup: int, reps: int) -> float:
    """Median device time of one call, from CUDA events around each call.
    The timed calls are queued behind a device-side wait (``_sleep``) long
    enough for the host to enqueue all of them, so each call starts on the
    device as soon as the previous one ends and the host's own time per
    call (tens of microseconds for a kernel's wrapper, more for an autograd
    backward; ``scripts/flash_attention_ab.py`` prints it) is not counted
    as device time, as it was when each call started on an idle device."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    # 2e9 cycles a second covers the H100's clocks; at most half a second
    torch.cuda._sleep(int(min(2 * reps * host_s, 0.5) * 2e9))
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events)


def attention_bound(kernel: str, BH: int, S: int, causal: bool):
    """Least time for the function on the card: the larger of its tensor
    core FLOPs over the bf16 peak and its bytes (each input read once,
    each output written once) over the HBM rate."""
    pairs = S * (S + 1) // 2 if causal else S * S  # (q, k) pairs computed
    mat = BH * S * HEAD_DIM * 2  # one bf16 [BH, S, D] tensor
    vec = BH * S * 4  # one f32 [BH, S] tensor
    products, nbytes = {
        "flash_fwd": (2, 3 * mat + mat + vec),  # q.k^T, p.v
        "flash_bwd_dq": (3, 4 * mat + 2 * vec + mat),  # + do.v^T, ds.k
        "flash_bwd_dkv": (4, 4 * mat + 2 * vec + 2 * mat),  # + p^T.do, ds^T.q
    }[kernel]
    flops = products * 2 * HEAD_DIM * pairs * BH
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def header(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi exited {smi.returncode}: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    return card


def build_kernels():
    from ray_tpu_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s into {_build.build_dir()}",
          flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if any(key in line for key in ("registers", "spill", "Compiling entry",
                                           "Performance Loss")):
                print(f"  {name}: {line.strip()}")
    from ray_tpu_torch.ops import flash_attention as fa
    for spec in KERNELS:
        name = spec["name"]
        attrs = fa.kernel_attributes(name)
        print(f"  flash_attention: {name}: {fa.dynamic_smem_bytes(name)} bytes "
              f"of dynamic shared memory, {attrs['registers']} registers, "
              f"{attrs['blocks_per_sm']} blocks per SM", flush=True)


def check_kernels(torch, F, fa):
    """Each kernel against its plain version; returns per-kernel results
    at the main path's shape."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(BH, S):
        return torch.randn(BH, S, HEAD_DIM, generator=gen,
                           device="cuda").to(torch.bfloat16)

    def bf16_check(a, b):
        """(max |a - b|, rms(b), worst |a - b| over its element's bound)."""
        a, b = a.float(), b.float()
        diff = (a - b).abs()
        rms = b.square().mean().sqrt().item()
        share = diff / (BF16_RTOL * b.abs() + ATOL_RMS * rms + ABS_FLOOR)
        at = share.argmax()
        return (diff.max().item(), rms, share.view(-1)[at].item(),
                b.view(-1)[at].item())

    def lse_check(a, b):
        e = (a - b).abs().max().item()
        return e, b.square().mean().sqrt().item(), e / LSE_ABS_TOL, None

    results, failures = {}, []
    cases = [("main", 192, 1024, True), ("ragged", 24, 1000, True),
             ("ragged129", 24, 129, True), ("noncausal", 24, 1024, False)]
    for label, BH, S, causal in cases:
        q, k, v, do = (rand(BH, S) for _ in range(4))
        kw = dict(scale=SCALE, causal=causal)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, **kw)
        delta = (do.float() * o_ref.float()).sum(dim=-1)
        dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, **kw)
        dq_ref = fa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, **kw)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, **kw)
        dk_ref, dv_ref = fa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, **kw)
        torch.cuda.synchronize()
        checks = {
            "flash_fwd": [("o", *bf16_check(o, o_ref)),
                          ("lse", *lse_check(lse, lse_ref))],
            "flash_bwd_dq": [("dq", *bf16_check(dq, dq_ref))],
            "flash_bwd_dkv": [("dk", *bf16_check(dk, dk_ref)),
                              ("dv", *bf16_check(dv, dv_ref))],
        }
        for name, rows in checks.items():
            for what, e, rms, worst, at in rows:
                ok = math.isfinite(worst) and worst <= 1.0
                where = "" if at is None else f" (plain value {at:.3e})"
                print(f"check {label:9s} BH={BH} S={S} causal={causal} "
                      f"{name}.{what}: max_abs_err {e:.3e} rms {rms:.3e} "
                      f"err/rms {e / rms:.2e}; worst element {worst:.3f} of "
                      f"its bound{where} {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    failures.append(f"{name}.{what} ({label})")
        if label != "main":
            continue

        # timings at the main path's shape
        fns = {
            "flash_fwd": (lambda: fa.flash_fwd(q, k, v, **kw),
                          lambda: fa.flash_fwd_plain(q, k, v, **kw)),
            "flash_bwd_dq": (
                lambda: fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, **kw),
                lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, **kw)),
            "flash_bwd_dkv": (
                lambda: fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, **kw),
                lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, **kw)),
        }
        B, H = 16, 12
        q4, k4, v4 = (x.view(B, H, S, HEAD_DIM).detach().requires_grad_(True)
                      for x in (q, k, v))
        sdpa_fwd_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, scale=SCALE), warmup=3, reps=20)
        out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                              scale=SCALE)
        do4 = do.view(B, H, S, HEAD_DIM)
        sdpa_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
            out4, (q4, k4, v4), do4, retain_graph=True), warmup=3, reps=20)
        library = {"flash_fwd": sdpa_fwd_ms, "flash_bwd_dq": sdpa_bwd_ms,
                   "flash_bwd_dkv": sdpa_bwd_ms}
        for name, (kernel_fn, plain_fn) in fns.items():
            bound_ms, bound_by, flops, nbytes = attention_bound(name, BH, S, causal)
            ms = time_ms(torch, kernel_fn, warmup=3, reps=20)
            plain_ms = time_ms(torch, plain_fn, warmup=1, reps=5)
            tflops = flops / (ms * 1e-3) / 1e12
            results[name] = {
                "max_abs_err": max(row[1] for row in checks[name]),
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library[name],
                "tflops": tflops, "bound_share": bound_ms / ms,
            }
            print(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
                  f"SDPA {library[name]:.4f} ms, bound {bound_ms * 1e3:.1f} us "
                  f"({bound_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), "
                  f"{tflops:.1f} TFLOP/s, {bound_ms / ms:.3f} of the bound",
                  flush=True)
        # the backward pair as _FlashAttention.backward runs it (delta, dq,
        # dk/dv) against SDPA's whole backward; printed, not gated
        qf, kf, vf = (x.detach().requires_grad_(True) for x in (q, k, v))
        of = fa._FlashAttention.apply(qf, kf, vf, SCALE, causal)
        flash_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
            of, (qf, kf, vf), do, retain_graph=True), warmup=3, reps=20)
        o_det = of.detach()
        delta_ms = time_ms(torch, lambda: (do.float() * o_det.float()).sum(dim=-1),
                           warmup=3, reps=20)
        print(f"time backward: flash (delta + dq + dk/dv) {flash_bwd_ms:.4f} ms "
              f"(delta {delta_ms:.4f}, dq {results['flash_bwd_dq']['ms']:.4f}, "
              f"dk/dv {results['flash_bwd_dkv']['ms']:.4f} alone), SDPA "
              f"{sdpa_bwd_ms:.4f} ms: {flash_bwd_ms / sdpa_bwd_ms:.2f}x SDPA's",
              flush=True)
        del q4, k4, v4, out4, qf, kf, vf, of, o_det
    if failures:
        fail(f"kernels disagree with their plain versions: {', '.join(failures)}")
    return results


def train(torch, fa):
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel.train_step import (default_optimizer,
                                                   make_train_state,
                                                   make_train_step)

    cfg = dataclasses.replace(gpt2.gpt2_small(), remat=False)
    B, S, warmup, timed = 16, 1024, 2, 5
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    batch = {"tokens": tokens}

    def run(run_cfg):
        opt = default_optimizer(1e-4, warmup_steps=10, total_steps=1000)
        state = make_train_state(lambda g: gpt2.init(g, run_cfg),
                                 torch.Generator(device="cuda").manual_seed(0), opt)
        step = make_train_step(lambda p, b: gpt2.loss_fn(p, b, run_cfg), opt)
        return state, step

    def steps(state, step, n):
        """n steps; returns the state, their metrics and their seconds."""
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state, m = step(state, batch)
            out.append(m)
        torch.cuda.synchronize()
        return state, out, time.perf_counter() - t0

    # reference attention from the same weights: its first step is the
    # yardstick for flash's, and 3 more steps time the whole step with it
    ref_cfg = dataclasses.replace(cfg, attention="reference")
    state, step = run(ref_cfg)
    state, (m,), _ = steps(state, step, 1)
    ref_loss, ref_gn = float(m["loss"]), float(m["grad_norm"])
    state, _, ref_dt = steps(state, step, 3)
    print(f"train: reference attention step {ref_dt / 3 * 1e3:.1f} ms", flush=True)
    del state, step, m
    torch.cuda.empty_cache()

    state, step = run(cfg)
    check_attention_grads(torch, gpt2, state.params, batch, ref_cfg, cfg)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    state, metrics, _ = steps(state, step, warmup)
    state, timed_metrics, dt = steps(state, step, timed)
    launches = dict(fa.LAUNCHES)
    metrics += timed_metrics

    losses = [float(m["loss"]) for m in metrics]
    print(f"train: losses {losses}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail("non-finite training loss")
    expected = cfg.n_layer * (warmup + timed)
    for name, n in launches.items():
        print(f"train: {name} launched {n} times (expected {expected})")
        if n != expected:
            fail(f"{name} launched {n} times on the main path, expected {expected}")
    gn = float(metrics[0]["grad_norm"])
    loss_rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    gn_rel = abs(gn - ref_gn) / abs(ref_gn)
    print(f"train: first step flash loss {losses[0]:.6f} grad_norm {gn:.6f}; "
          f"reference loss {ref_loss:.6f} grad_norm {ref_gn:.6f}; relative "
          f"differences {loss_rel:.2e} (limit {LOSS_RTOL:.0e}) and "
          f"{gn_rel:.2e} (limit {GRAD_NORM_RTOL:.0e})", flush=True)
    if not loss_rel <= LOSS_RTOL:
        fail("first-step loss disagrees with reference attention")
    if not gn_rel <= GRAD_NORM_RTOL:
        fail("first-step grad norm disagrees with reference attention")

    step_ms = dt / timed * 1e3
    tokens_per_s = timed * B * S / dt
    flops_per_token = 6 * cfg.n_params + 6 * cfg.n_layer * S * cfg.d_model
    mfu = tokens_per_s * flops_per_token / PEAK_BF16_FLOPS
    print(f"train: GPT-2-small batch {B} seq {S}: step {step_ms:.1f} ms, "
          f"{tokens_per_s:.0f} tokens/s, MFU {mfu:.4f} (989 TFLOP/s peak), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    profile_step(torch, step, state, batch, step_ms)
    return launches


def check_attention_grads(torch, gpt2, params, batch, ref_cfg, cfg):
    """The gradients of the attention leaves (wq, wk, wv, wo, each stacked
    over the 12 layers) from one loss_fn call on the same weights, with
    reference and with flash attention."""
    attn = params["blocks"]["attn"]
    names = sorted(attn)
    grads, bad = [], []
    for run_cfg in (ref_cfg, cfg):
        loss, _ = gpt2.loss_fn(params, batch, run_cfg)
        grads.append(torch.autograd.grad(loss, [attn[n] for n in names]))
    for name, g_ref, g in zip(names, *grads):
        rel = ((g - g_ref).norm() / g_ref.norm()).item()
        ok = rel <= ATTN_GRAD_RTOL
        print(f"train: grad of {name}: norm {g.norm().item():.6e} flash, "
              f"{g_ref.norm().item():.6e} reference; ||flash - reference|| / "
              f"||reference|| {rel:.3e} (limit {ATTN_GRAD_RTOL:.1e}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append(name)
    del grads
    torch.cuda.empty_cache()
    if bad:
        fail(f"attention gradients disagree with reference attention: {bad}")


def category(kernel: str) -> str:
    name = kernel.lower()
    if "flash_" in name:
        return "flash attention (ours)"
    if any(s in name for s in ("gemm", "xmma", "nvjet", "cutlass", "cublas")):
        return "matmul (cuBLAS)"
    if "reduce" in name:
        return "reductions"
    if "memcpy" in name or "memset" in name:
        return "copies"
    return "elementwise and other"


def profile_step(torch, step, state, batch, step_ms):
    """One more main-path step under torch.profiler: device time by kernel
    category and by operator. The profiler's own host cost stretches the
    profiled step's wall time, so the device's idle share is taken against
    the unprofiled step time ``step_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(t for _, _, t in rows)
    if busy_us == 0:
        print("profile: the profiler saw no device time (not measured)")
        return
    print(f"profile: one step, device busy {busy_us / 1e3:.1f} ms in "
          f"{sum(c for _, c, _ in rows)} kernels; idle share "
          f"{1 - busy_us / (step_ms * 1e3):.3f} of the unprofiled "
          f"{step_ms:.1f} ms step (wall {wall_us / 1e3:.1f} ms with the "
          f"profiler on)")
    shares = {}
    for key, _, t in rows:
        shares[category(key)] = shares.get(category(key), 0.0) + t
    for cat, t in sorted(shares.items(), key=lambda kv: -kv[1]):
        print(f"profile: {cat}: {t / 1e3:.2f} ms ({t / busy_us:.3f})")
    for key, count, t in sorted(rows, key=lambda r: -r[2])[:8]:
        print(f"profile:   {t / 1e3:8.2f} ms  x{count:<4d} {key[:100]}")
    # the operators that launched them, by input shapes
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"profile:   {e.self_device_time_total / 1e3:8.2f} ms  "
              f"x{e.count:<4d} {e.key} {str(e.input_shapes)[:90]}")


def main() -> int:
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ray_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = header(torch)
    build_kernels()
    results = check_kernels(torch, F, fa)
    launches = train(torch, fa)

    kernels = []
    for spec in KERNELS:
        name = spec["name"]
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": spec["replaces"], "launches": launches[name],
                        **results[name]})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
