#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python chip_smoke.py        # from the repository root, on a GPU machine

Phases, each of which exits non-zero on failure:

1. header: the card's name and power limit, and the kernels' build (one
   ``nvcc`` a source, started together), with each kernel's registers,
   dynamic shared memory, blocks per SM and local memory a thread (the
   bf16 ones at head dim 64, the f32 ones at each head dim they are built
   for, 256 among them, the bf16_wide ones at 128, the bf16_d256 ones at
   256, the split-head-dim ones, which serve every head dim above 256, at
   512), failing if a kernel spills to local memory, but the f32 dq and
   the f32 dk/dv up to head dim 128 (at 256 and above none may);
2. each hand-written kernel against its plain PyTorch version on the card:
   in bf16 at GPT-2-small's attention shape (B*H 192, S 1024, D 64,
   causal), the gang's (B*H 96, phase 4, and phase 6d's ranks' at 6
   heads), one microbatch of phase 6a's stages (B*H 48) and of phase
   6e's ranks (B*H 24, 6 heads), two ragged S (1000, and 129:
   one row past a 128-row tile), a non-causal case and head dims 16 and
   32 (zero-padded to 64); in f32 at the main shape and at head dims 16
   (gpt2_tiny's), 32 and 128 (S 1000 causal among them), causal and
   not; in bf16 at head dims 96 and 128 (the bf16_wide kernels, padded
   to 128), among them S 129 causal at head dim 128 and the wide shape
   (B*H 96, S 1024, D 128, causal: GPT-2-small's width in heads of 128);
   in f32 and in bf16 at head dims 129, 192 and 256 (f32: the f32
   kernels at head dim 256; bf16: the bf16_d256 kernels); in float16 at
   head dims 64 and 256, which run the f32 kernels on f32 copies (held to
   the plain versions in float16 under the bf16 bound); in f32 and in
   bf16 at head dims 300 (padded to 320), 320 (B*H 8) and 512 (B*H 24),
   S 1024 causal and not and S 129 (the split-head-dim kernels), and in
   float16 at 320. At the main
   shape (for bf16_wide the wide one; for head dim 256 B*H 48, S 1024, D 256,
   causal: the main shape's operations; above 256 B*H 24, S 1024, D 512,
   causal), times of the kernel, the plain
   version and the PyTorch library call (SDPA, in the kernel's dtype)
   beside the bound, with the kernel's TFLOP/s and the share of its bound
   that it reaches (for f32 the bound of 3xTF32 on the tensor cores and,
   beside it, of FFMA on the CUDA cores); in bf16 the backward as
   ``_FlashAttention.backward`` runs it (delta, dq, dk/dv) against
   SDPA's, and in f32 dq + dk/dv against SDPA's backward;
3. the main path: GPT-2-small at full width (12 layers, 12 heads, d 768,
   vocab 50304, seq 1024) training at batch 16 through ``make_train_step``
   (2 warm-up and 5 timed steps, weights from a seeded generator), with
   every launch counter set to 0 just before and read just after; the
   gradients of the attention leaves from the same weights, and the first
   step's loss and grad norm, held against reference attention (whose
   step is timed too); then one more step under ``torch.profiler``:
   device time by kernel category and by operator, and the device's busy
   time, from which PERF.md's "Where the time goes" is written;
3b. the tiny configs: gpt2_tiny (head dim 16) under attention="auto" in
   bf16 (the bf16 kernels, padded) and in f32 (the f32 kernels),
   gpt2_tiny with two heads of 128 in bf16 (the bf16_wide kernels), and
   with one head of 256 in bf16 (the bf16_d256 kernels) and in f32 (the
   f32 kernels at head dim 256), and with one head of 320 in bf16 and in
   f32 (the split-head-dim kernels), 3 steps each,
   its launch counts exact and its first step held
   to reference attention (phase 3's limits in bf16, an order tighter in
   f32);
3c. GPT-2-small-MoE at full width (12 layers, 12 heads, d 768, ff 3072,
   vocab 50304, seq 1024, 8 experts, top-2, capacity factor 1.25) at
   batch 8 (2 warm-up and 5 timed steps, seeded weights, bf16, flash
   attention), after ``apply_moe`` in f32 at its width is held to a
   per-token loop, and the same model's first step in f32 (loss, grad
   norm, attention leaves' gradients) to reference attention's by phase
   3b's f32 limits (in bf16 the router's top-k sends a few tokens to
   other experts under either attention, which moves the step by more
   than phase 3's limits whatever attention computes: the bf16 first
   step is printed beside it); its aux loss must be finite and positive
   at every step; it prints the step ms, tokens/s, peak memory, the share of
   (token, k) pairs past capacity, the launch counts and, for one more
   step, phase 3's profile;
4. the data-parallel Train gang at world 2: two rank threads share the
   card, each GPT-2-small at full width on batch 8 (the main path's 16
   between them) and each with its own device group
   (``COLLECTIVE_BACKEND``: the ranks exchange through the card's memory)
   over one in-memory store. Bucketed DDP (``make_train_step(host_grad_sync=...)``, 4 MiB
   buckets): the ranks' synced grads and params are bit-identical, the
   synced grads are bit-identical to the whole-tree sync of the kill
   switch, and the first step's loss, grad norm and attention leaves'
   grads are the one-card step's on batch 16 with reference attention,
   within phase 3's limits. ZeRO (``ZeroOptimizer(zero_adam)``): one
   step's params are bit-identical to an allreduce then the full apply,
   on both ranks, and each rank holds its half of the replicated state.
   Each run is timed (2 warm-up and 3 timed steps: step ms, host sync ms,
   ms blocked in the bucket waits; for ZeRO also the ms of a step spent
   packing grads and params, in the host Adam and in the gathers) and
   its launch counts are set to 0 just before and read just after. Both
   runs are repeated with gloo groups, timed the same way, and (phase
   8b) their synced grads and params must be the device backend's, bit
   for bit;
5. checkpoints: the same gang at world 2, brought up by
   ``TorchBackend.on_start`` over a loopback TCP store, takes ZeRO steps
   and saves sharded checkpoints asynchronously after steps 1 and 2
   (each write overlapping the next step, each save harvested); restored
   at world 2 into fresh optimizers, params and slots are bit-identical
   to the state at save and one step from them is the uninterrupted
   step, bit for bit; restored at world 1 the params are too and the
   slots are the ranks' slots concatenated; with one byte of the newest
   shard flipped, restore falls back to the older generation and renames
   the bad one ``.quarantined``. It prints the snapshot, background write,
   harvest wait and restore times and the bytes a shard, and deletes its
   ~3 GB directory (``CKPT_DIR``, under ``build/``) at the end;
6. the pipeline: GPT-2-small at full width on phase 3's weights and
   batch (16, in 4 microbatches, bf16), its ranks threads of this process
   with their axis groups on the device backend (``parallel/mesh.py``), each
   on its own CUDA stream: 6a at pp 2 (two stages of 6 blocks, flash
   attention in the stages; 2 warm-up and 3 timed steps), 6b at pp 2 x
   sp 2 (four ranks of 512 tokens, ring attention; 1 warm-up and 2 timed
   steps), 6c at dp 2 x pp 2 (two replicas of 8 rows, each in 4
   microbatches of 2, their grads and metrics averaged over dp; 1
   warm-up and 2 timed steps), 6d at tp 2 (two ranks of 6 heads, half
   the MLP hidden and half the vocab each, the batch as one microbatch;
   1 warm-up and 2 timed steps) and 6e at pp 2 x tp 2 (four ranks; 1
   warm-up and 2 timed steps). Each run's first step (the loss, the
   global grad norm and the attention leaves' grads reassembled from
   replica 0's stages and tp blocks) is held to the one-card step on the
   same weights and batch with reference attention by phase 3's limits;
   the launch counts are exact (dp x tp x 12 layers x microbatches of
   each bf16 kernel a step: 6a 48, 6b none (ring attention), 6c 96, 6d
   24, 6e 96); 6c's replicas end with bit-equal params, and at tp 2 the
   leaves every tp rank holds whole (the LayerNorms, b2, wpe) end
   bit-equal across the tp ranks. It prints the step ms and tokens/s
   beside the card, each rank's ms in each collective (the dp sync, the
   tp sums and the tp copies' backward sums among them), its resident
   params and moments, and the card's peak memory;
6f-6h. expert parallelism (EP_RUNS): GPT-2-small-MoE (phase 3c's model,
   weights and batch of 8) on four rank threads, each holding 4 of the 8
   experts (``tree_shard``), the router counting slots, capacity and the
   aux loss's top-1 fractions over the whole batch (1 warm-up and 2
   timed steps each, bf16): 6f at dp 2 x ep 2 (a replica's 4 rows a
   rank, flash attention), 6g at ep 2 x tp 2 (all 8 rows a rank, 6 heads,
   half the vocab and half of each expert's hidden, flash attention), 6h
   at sp 2 x ep 2 (all 8 rows and half the sequence a rank, ring
   attention). Each run's first step in f32 (loss, aux loss, global grad
   norm, the router's grad norm) is held to the one-card f32 step on the
   same weights and batch by phase 3b's f32 limits; the aux loss must be
   finite and positive at every step; the launch counts are exact (4
   ranks x 12 layers of each bf16 kernel a step at sp 1: 48; none through
   the ring); on each axis the leaves its ranks hold whole (over ep and
   tp the router, the LayerNorms and wpe among them; over dp and sp every
   leaf) end bit-equal across its groups. It prints the step ms and
   tokens/s beside the card, each rank's ms in the slot prefix (the
   routing counts' allreduces), the ep and tp sums, the ep and tp
   copies' backward sums, the ring hops, the sp grad sums and the dp
   sync, its resident params and moments, the card's peak memory, and
   the share of (token, k) pairs past capacity;
7. the mesh entry point (MESH_RUNS), as a user calls it: ``create_mesh``
   over the card named four times, each rank thread's ``Mesh.join``,
   ``make_train_state(..., layout, gpt2.partition_specs(cfg))`` and
   ``make_train_step(lambda p, b: gpt2.loss_fn(p, b, cfg, layout, ...),
   opt, layout, batch_spec=...)`` given the global batch, with
   ``remat=True`` as ``gpt2_small()`` ships (each layer a checkpointed
   region of its stage's tape): 7a GPT-2-small at dp 2 x tp 2 (dp=-1
   resolved) on phase 3's weights and batch of 16, 7b GPT-2-small-MoE
   with attention="ring" at sp 2 x ep 2 on phase 3c's weights and batch
   of 8, 7c GPT-2-small at dp 2 x pp 2, pipelined in 2 microbatches,
   batch_spec (("dp",), None) (1 warm-up and 2 timed steps each, bf16).
   Each run's f32 first step (loss, aux loss, grad norm) is held to the
   one-card f32 step on the same weights and batch by phase 3b's f32
   limits; the launch counts are exact (the forward twice a layer, for
   the recompute: 7a and 7c 4 ranks x 12 layers' worth a step of the
   forward twice and of dq and dk/dv once; the ring none); on each axis
   the leaves its ranks hold whole (over pp those outside the blocks)
   end bit-equal across its groups. It prints the step ms, tokens/s and
   the card's peak memory beside the card, and for 7a the peak of one
   step with remat off;
8. the collective backends (``util/collective``): (a) a device group of
   2 and of 4 rank threads runs allreduce (sum, product, min, max),
   reducescatter over an uneven dim 0, broadcast from every rank, a
   sendrecv ring and allgather on CUDA tensors in f32, bf16 and int64,
   every result on the card and held to the host's reduction in rank
   order (bit for bit in int64, in min and max and at world 2; within
   REASSOC_ULPS roundings otherwise), and a profile of a CUDA-input
   allreduce and sendrecv, taken in a child process of this script
   (``PROFILE_COLLECTIVES``), must show no copy between host and card; (b)
   runs in phase 4; (c) an NCCL group at world 1 runs every op, each
   result on the card, and two NCCL ranks on one card are refused within
   seconds (if torch has no NCCL, the backend's refusal is printed); (d)
   a rank that raises while its peers wait in an allreduce poisons the
   group: they raise ``CollectiveGroupError`` naming it within POISON_S;
9. serving (``serving``): (a) the GPU probe (``probe_chips``,
   ``probe_devices``, ``detect_resources``) in a child process of this
   script (``PROBE_GPUS``), which must leave CUDA uninitialized there,
   count the card, give CUDA's total memory to the MiB and one GPU, and
   ``publish_local_device_gauges`` here, which must publish ``in_use``
   and ``limit``; (b) phase 3's GPT-2-small weights (seed 0) through
   ``Checkpoint.from_torch`` and ``to_torch("cuda")``, every leaf back
   bit for bit; (c) ``TorchPredictor.from_checkpoint`` on them (12
   layers, 12 heads of 64, d 768, vocab 50304, S 1024, bf16, remat on as
   shipped) behind the port's ``@batch`` (max 16, buckets 1-16, 5 ms),
   answering the last position's f32 logits and their argmax to
   SERVE_CLIENTS threads sending SERVE_REQUESTS requests of 1024 token
   ids from a seed, staggered (SERVE_STAGGER_S) so that batches pad,
   every batch reaching the card through one ``iter_device_batches``
   stream, after a warm-up call of each bucket: every answer within
   LOGITS_ATOL_RMS and LOGITS_RTOL of the request run alone with
   reference attention, its greedy token the reference's where the
   margin is clear; some pad slot run; ``flash_fwd`` launched 12 times
   a batch call and every other kernel never; no new batch signature
   after warm-up; it prints requests/s, tokens/s, p50 and p99 latency, the
   batches by bucket, the pad waste and the card's peak memory; (d)
   DEVICE_BATCHES batches through ``iter_device_batches`` under a
   consumer running the forward, each as the consumer's stream read it
   after the forward equal to its host source bit for bit (checked two
   batches later), and a profile, in a child process
   (``PROFILE_DEVICE_BATCHES``), whose batch copies must be pinned and
   on another stream than the forward's.

Each multi-rank phase prints its step beside the same step on gloo as
PERF.md records it (``GLOO_STEP_MS``); 6d and 6f (``PROFILED_RUNS``)
then take one more step under the profiler, whose ranks' kernel time is
printed against the step (``RankProfile``).

The line before the last is ``{"kernels": [...]}``, where each kernel's
``launches`` is its count on the path that runs it (the main path for
the bf16 kernels, the f32 tiny config for the f32 ones, the wide tiny
config for the bf16_wide ones, the bf16 tiny config with a head of 256
for the bf16_d256 ones, the tiny configs with a head of 320 for the
split-head-dim ones, the f32 tiny config with a head of 256 for the
f32 kernels' head-dim-256 instances, listed apart as ``*_f32_d256``),
and ``tiny_launches``, ``moe_launches``,
``gang_launches``, ``pipeline_launches`` (phase 6's runs and 6f-6h's),
``entry_launches`` (phase 7's) and ``serve_launches`` (9c's traffic) the
other runs'; the last
line is ``{"ok": true,
"device": {...}}``. Without
CUDA, or without the rest of the repository beside it, the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import queue
import statistics
import subprocess
import sys
import threading
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores (FFMA)
# f32-accurate products on the tensor cores: 3xTF32 (big.small + small.big
# + big.big) at a third of the dense TF32 peak of 495 TFLOP/s
PEAK_3XTF32_FLOPS = 495e12 / 3
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
HEAD_DIM = 64  # GPT-2-small's, the main path's
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
# The f32 kernels against their plain versions (f32 throughout, TF32
# off): the kernels take their products as 3xTF32 on the tensor cores,
# ~2^-21 of a product, and sum in another order than the plain version
# (tests/test_torch_tf32_split.py emulates the forward, dq and dk/dv
# within a quarter of this bound, and shows one TF32 pass outside it).
# The bound, F32_RTOL of the element plus F32_ATOL_RMS of the rms plus
# F32_FLOOR, sits ~50x above f32 summation noise and ~1000x below what a
# skipped tile or a wrong mask moves (the bf16 bound of the same shape).
# The card tests read these limits too.
F32_RTOL = 2.0 ** -14
F32_ATOL_RMS = 2.0 ** -14
F32_FLOOR = 1e-6
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
# GPT-2-small's forward alone (phase 9c, serving): the last position's f32
# logits of a request answered in a padded batch with flash attention,
# against the same request run alone with reference attention (f32
# softmax and p.v), both bf16 compute, element by element:
# |l - r| <= LOGITS_ATOL_RMS * rms(r), and ||l - r|| / ||r|| <= LOGITS_RTOL.
# The two differ by flash's bf16 p and by the batch's other GEMM shapes
# (other cuBLAS kernels, other bf16 roundings of the residual stream).
# Readings (PERF.md, PR 29): worst element 5.6e-2 of the rms, norm 1.21e-2;
# a forward whose last 128 rows drop KV tile 0's p.v read 0.583 and 0.120.
# The greedy token must be the reference's wherever its top-2 margin
# exceeds twice the element bound.
LOGITS_ATOL_RMS = 2.0 ** -3
LOGITS_RTOL = 2.0 ** -5

# The data-parallel gang phase: two rank threads share the card, each on
# half the main path's batch, with 4 MiB buckets (the port's default).
# Its first step is held to the one-card step on the whole batch, with
# reference attention, by the first-step and attention-grad limits above. Every group op times out after
# GANG_OP_TIMEOUT_S, and the phase fails if a rank is still running after
# GANG_JOIN_S.
GANG_BATCH = 8
GANG_BUCKET_BYTES = 4 << 20
GANG_OP_TIMEOUT_S = 120.0
GANG_JOIN_S = 600.0

# Every multi-rank phase (4, 5, 6a-6h, 7) runs its rank threads' groups on
# the device backend: the ranks exchange through the card's memory
# (util/collective/device_backend.py). Each phase prints its step beside
# the same step on gloo through host memory, in ms, as PERF.md section 5
# records it (earlier runs of this script on an NVIDIA H100 80GB HBM3 at
# 700 W).
COLLECTIVE_BACKEND = "device"
GLOO_STEP_MS = {
    "gang ddp": "~590", "gang zero": "~2783",
    "pipeline pp2": "410.5-738.2", "pipeline pp2sp2": "3225.1-5158.5",
    "pipeline dp2pp2": "1251.9-1920.3",
    "pipeline tp2": "5169.8, later 5714.0-6869.7",
    "pipeline pp2tp2": "3646.9, later 3969.1-5385.7",
    "experts dp2ep2": "2987.5, over later calls 2221.4-5436.4",
    "experts ep2tp2": "6076.7", "experts sp2ep2": "5082.3",
    "entry dp2tp2": "2738.2-5616.0", "entry sp2ep2": "4767.1-7377.6",
    "entry dp2pp2": "1124.2-2187.2"}
# Phase 8, the collective backends on the card: each op of a device group
# at DEVICE_WORLDS rank threads over DEVICE_OP_SHAPE (its 1027 rows cut
# unevenly over 2 and 4), float results at world 4 within REASSOC_ULPS
# roundings of the host's rank-order reduction; a poisoned peer must
# raise within POISON_S
DEVICE_WORLDS = (2, 4)
DEVICE_OP_SHAPE = (1027, 33)
REASSOC_ULPS = 3
POISON_S = 2.0

# The tiny-config phase: gpt2_tiny (head dim 16) under attention="auto",
# in bf16 (the bf16 kernels, padded to head dim 64) and in f32 (the f32
# kernels), TINY_STEPS steps each at batch TINY_BATCH. Its first step is
# held to reference attention by phase 3's limits in bf16, and by limits
# an order tighter in f32, where flash and reference differ only by f32
# summation order (the card test read ~1e-6 relative).
TINY_BATCH = 8
TINY_STEPS = 3
TINY_F32_LIMITS = (1e-5, 2e-4, 2.5e-3)  # loss, grad norm, attention leaves
# bf16 head dims above 64 run on the bf16_wide kernels: gpt2_tiny with
# two heads of 128 (d_model 256) in phase 3b, and in phase 2 the shape
# of GPT-2-small's attention width in heads of 128 (B*H 16 x 6)
WIDE_TINY = dict(d_model=256, n_head=2)
WIDE_SHAPE = (96, 1024, 128)
# Head dims 129-256 run at head dim 256, f32 on the f32 kernels, bf16 on
# the bf16_d256 kernels: gpt2_tiny with one head of 256 in phase 3b, and
# in phase 2 B*H 48 (the main shape's operations at four times the head
# dim)
D256_TINY = dict(d_model=256, n_head=1)
D256_SHAPE = (48, 1024, 256)
# Head dims above 256 run the split-head-dim kernels (bf16_dsplit,
# f32_dsplit; float16 on f32 copies), at the head dim padded to a multiple
# of 64: gpt2_tiny with one head of 320 in phase 3b, and in phase 2 head
# dims 320 (B*H 8) and 512 (B*H 24), timed at DSPLIT_SHAPE, causal
D320_TINY = dict(d_model=320, n_head=1)
DSPLIT_SHAPE = (24, 1024, 512)

# Phase 3c, GPT-2-small-MoE: batch 8, where the dense dispatch tensors
# [B, S, E, C] (C = 2560) take 168 M elements, 335 MB in bf16, each; the
# layer is first held in f32 at its width on MOE_ORACLE_TOKENS (2 x 16)
# with room for every token (capacity factor 8) to a per-token loop,
# within MOE_ORACLE_ATOL (f32 sums of 768 and 3072 terms in other orders).
MOE_BATCH = 8
MOE_ORACLE_TOKENS = (2, 16)
MOE_ORACLE_ATOL = 1e-5

# Phase 6, the pipeline: GPT-2-small at full width on batch PIPE_BATCH
# (phase 3's weights and tokens) in PIPE_MICROBATCHES microbatches (at pp
# 1, one), the ranks threads as in phase 4: 6a at pp 2 (flash attention in
# the stages), 6b at pp 2 x sp 2 (ring attention), 6c at dp 2 x pp 2, 6d
# at tp 2, 6e at pp 2 x tp 2. Each run's first step is held to the
# one-card step with reference attention by phase 3's limits.
PIPE_BATCH = 16
PIPE_MICROBATCHES = 4
# (name, dp, pp, sp, tp, microbatches, warm-up steps, timed steps): 6a,
# 6b, 6c (each replica's 8 rows as 4 microbatches of 2), 6d (with one
# stage there is no bubble to fill: the batch as one microbatch) and 6e
# the runs of phases 6 and 6f-6h whose rank threads take one more step
# under the profiler (RankProfile), after their gates
PROFILED_RUNS = ("tp2", "dp2ep2")
# Phase 8's profile of an allreduce and a sendrecv runs in a process of
# its own (``python chip_smoke.py PROFILE_COLLECTIVES``): in a process that
# had already run four profiler sessions (phases 3, 3c, 6d and 6f) a fifth
# saw no device event on the card, twice
PROFILE_COLLECTIVES = "--profile-collectives"
PIPE_RUNS = (("pp2", 1, 2, 1, 1, PIPE_MICROBATCHES, 2, 3),
             ("pp2sp2", 1, 2, 2, 1, PIPE_MICROBATCHES, 1, 2),
             ("dp2pp2", 2, 2, 1, 1, PIPE_MICROBATCHES, 1, 2),
             ("tp2", 1, 1, 1, 2, 1, 1, 2),
             ("pp2tp2", 1, 2, 1, 2, PIPE_MICROBATCHES, 1, 2))

# Phases 6f-6h, expert parallelism: GPT-2-small-MoE (phase 3c's model,
# seeded weights and batch of MOE_BATCH rows) on four rank threads, each
# its block of the batch as one microbatch (the router counts slots,
# capacity and the aux loss's top-1 fractions over the whole batch) and 4
# of the 8 experts. Each run's first step is held in f32 to the one-card
# f32 step by phase 3b's f32 limits (the aux loss by the loss's), as
# phase 3c holds its own (in bf16 the router's top-k moves a few tokens
# to other experts on rounding alone).
# (name, dp, ep, sp, tp, warm-up steps, timed steps): 6f, each rank its
# replica's 4 rows; 6g, each rank all 8 rows, 6 heads, half the vocab and
# half of each of its experts' hidden (1536); 6h, each rank all 8 rows
# and half the sequence (512 positions), ring attention over sp
EP_RUNS = (("dp2ep2", 2, 2, 1, 1, 1, 2),
           ("ep2tp2", 1, 2, 1, 2, 1, 2),
           ("sp2ep2", 1, 2, 2, 1, 1, 2))

# Phase 7, the mesh entry point: every run through create_mesh over the
# card named four times, each rank's Mesh.join, make_train_state(...,
# layout, gpt2.partition_specs(cfg)) and make_train_step(lambda p, b:
# gpt2.loss_fn(p, b, cfg, layout, ...), opt, layout, batch_spec=...), each
# rank given the global batch, with remat=True as gpt2_small() ships. Each
# run's f32 first step (loss, aux loss, grad norm) is held to the one-card
# f32 step on the same weights and batch by phase 3b's f32 limits, as 6f-6h
# hold theirs.
# (name, mesh axes, MoE, pipelined, microbatches, batch_spec, batch,
# warm-up steps, timed steps): 7a, GPT-2-small at dp 2 x tp 2 (dp=-1
# resolved over four ranks) on phase 3's weights and batch; 7b,
# GPT-2-small-MoE with attention="ring" at sp 2 x ep 2 on phase 3c's; 7c,
# GPT-2-small at dp 2 x pp 2, pipelined in 2 microbatches (the JAX dry
# run's config C at four devices)
MESH_RUNS = (("dp2tp2", dict(dp=-1, tp=2), False, False, 1,
              (("dp",), "sp"), PIPE_BATCH, 1, 2),
             ("sp2ep2", dict(sp=2, ep=2), True, False, 1,
              (("dp",), "sp"), MOE_BATCH, 1, 2),
             ("dp2pp2", dict(dp=2, pp=2), False, True, 2,
              (("dp",), None), PIPE_BATCH, 1, 2))
MESH_DEVICES = 4

# Phase 5, checkpoints: the gang's GPT-2-small ZeRO state at world 2 under
# the repository's build/ directory (two generations, ~3 GB), deleted at
# the end.
CKPT_DIR = "build/chip_smoke_checkpoints"

# Phase 9, serving: (a) the GPU probe in a child process of this script
# (``PROBE_GPUS``), which must leave CUDA uninitialized there; (b) phase
# 3's GPT-2-small weights through Checkpoint.from_torch / to_torch under
# SERVE_DIR (deleted at the end); (c) TorchPredictor.from_checkpoint on
# them behind the port's @batch (SERVE_MAX_BATCH, power-of-two buckets,
# SERVE_WAIT_S), SERVE_CLIENTS client threads sending SERVE_REQUESTS
# requests of max_seq token ids drawn from SERVE_SEED, client c waiting
# c * SERVE_STAGGER_S before each so that arrivals spread past the wait and
# batches come in sizes the buckets pad, every batch reaching the card
# through one iter_device_batches stream; (d) DEVICE_BATCHES batches of
# DEVICE_BATCH_ROWS rows (token ids and an f32 block of DEVICE_BATCH_COLS
# columns a token) through iter_device_batches under a consumer running
# the forward, each held to its host source, and a profile, taken in a
# child process (``PROFILE_DEVICE_BATCHES``), of the copies
SERVE_DIR = "build/chip_smoke_serving"
SERVE_MAX_BATCH = 16
SERVE_WAIT_S = 0.005
SERVE_CLIENTS = 8
SERVE_STAGGER_S = 0.002
SERVE_REQUESTS = 64
SERVE_SEED = 9
DEVICE_BATCHES = 64
DEVICE_BATCH_ROWS = 8
DEVICE_BATCH_COLS = 256
PROFILED_DEVICE_BATCHES = 6
PROBE_GPUS = "--probe-gpus"
PROFILE_DEVICE_BATCHES = "--profile-device-batches"

REPLACES = {"flash_fwd": "ray_tpu/ops/flash_attention.py:29",
            "flash_bwd_dq": "ray_tpu/ops/flash_attention.py:160",
            "flash_bwd_dkv": "ray_tpu/ops/flash_attention.py:212"}
# each family's kernels' source, by suffix: the wgmma kernels (bf16 at
# head dim 64, bf16_wide at 128, bf16_d256 at 256), the 3xTF32 mma.sync
# ones (f32) and the split-head-dim ones (bf16_dsplit, f32_dsplit: head
# dims above 256)
WGMMA_CU = "ray_tpu_torch/ops/csrc/flash_attention.cu"
MMA_SYNC_CU = "ray_tpu_torch/ops/csrc/flash_attention_f32.cu"
DSPLIT_CU = "ray_tpu_torch/ops/csrc/flash_attention_dsplit.cu"
SOURCES = {"": WGMMA_CU, "_f32": MMA_SYNC_CU, "_bf16w": WGMMA_CU,
           "_bf16d256": WGMMA_CU, "_bf16ds": DSPLIT_CU, "_f32ds": DSPLIT_CU}
KERNELS = [{"name": base + suffix, "replaces": where}
           for suffix in SOURCES for base, where in REPLACES.items()]
SOURCE_OF = {base + suffix: source for suffix, source in SOURCES.items()
             for base in REPLACES}
# the head dims each family's kernels are built for (one split-head-dim
# kernel serves every head dim above 256: asked for at 512)
HEAD_DIMS_OF = {"": (64,), "_f32": (16, 32, 64, 128, 256), "_bf16w": (128,),
                "_bf16d256": (256,), "_bf16ds": (512,), "_f32ds": (512,)}
# the head dims at which a kernel may show local memory (spills); every
# other kernel and head dim must show none. The f32 dq and dk/dv
# templates spill a little at the register caps of 3 blocks an SM, up to
# head dim 128; head dim 256's own kernels must not
MAY_SPILL = {"flash_bwd_dq_f32": (16, 32, 64, 128),
             "flash_bwd_dkv_f32": (16, 32, 64, 128)}
# what the kernels' line calls the f32 kernels' head-dim-256 instances
D256 = "_d256"


def family(name: str) -> str:
    """"_f32" for an f32 kernel's name, "_bf16w" for a bf16_wide one's (bf16
    at head dims 65-128), "_bf16d256" for a bf16_d256 one's (129-256),
    "_bf16ds" and "_f32ds" for the split-head-dim ones (above 256), ""
    for a bf16 one's."""
    return next((s for s in ("_f32", "_bf16w", "_bf16d256", "_bf16ds",
                             "_f32ds") if name.endswith(s)), "")


def suffix_of(on_f32_kernels: bool, head_dim: int) -> str:
    """The family suffix of the three kernels that take a dtype at a head
    dim (``on_f32_kernels``: f32, or float16 through the f32 kernels)."""
    if head_dim > D256_SHAPE[2]:
        return "_f32ds" if on_f32_kernels else "_bf16ds"
    if on_f32_kernels:
        return "_f32"
    if head_dim > WIDE_SHAPE[2]:
        return "_bf16d256"
    return "_bf16w" if head_dim > HEAD_DIM else ""


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


def attention_bound(kernel: str, BH: int, S: int, causal: bool,
                    D: int = HEAD_DIM):
    """Least time for the function on the card: the larger of its FLOPs
    over the peak of its type (bf16: the tensor cores; f32: 3xTF32 on the
    tensor cores, f32-accurate) and its bytes (each input read once, each
    output written once) over the HBM rate. Returns (ms, what bounds it,
    FLOPs, bytes, the ms of the FLOPs at the FFMA peak of the CUDA cores
    for f32, else None)."""
    f32 = family(kernel) in ("_f32", "_f32ds")
    pairs = S * (S + 1) // 2 if causal else S * S  # (q, k) pairs computed
    mat = BH * S * D * (4 if f32 else 2)  # one [BH, S, D] tensor
    vec = BH * S * 4  # one f32 [BH, S] tensor
    products, nbytes = {
        "flash_fwd": (2, 3 * mat + mat + vec),  # q.k^T, p.v
        "flash_bwd_dq": (3, 4 * mat + 2 * vec + mat),  # + do.v^T, ds.k
        "flash_bwd_dkv": (4, 4 * mat + 2 * vec + 2 * mat),  # + p^T.do, ds^T.q
    }[kernel.removesuffix(family(kernel))]
    flops = products * 2 * D * pairs * BH
    peak = PEAK_3XTF32_FLOPS if f32 else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    ffma_ms = max(flops / PEAK_F32_FLOPS, t_bytes) * 1e3 if f32 else None
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes,
            ffma_ms)


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
    spilled = []
    for spec in KERNELS:
        name = spec["name"]
        source = SOURCE_OF[name]
        for D in HEAD_DIMS_OF[family(name)]:
            attrs = fa.kernel_attributes(name, D)
            # a wgmma kernel's attributes read the shared memory its last
            # launch allowed itself; the module knows what it launches with
            smem = (fa.dynamic_smem_bytes(name, D) if source == WGMMA_CU
                    else attrs["max_dynamic_smem"])
            print(f"  {os.path.basename(source)}: {name} at head dim {D}: "
                  f"{smem} bytes of dynamic shared memory, "
                  f"{attrs['registers']} registers, "
                  f"{attrs['blocks_per_sm']} blocks per SM, "
                  f"{attrs['local_bytes']} bytes of local memory", flush=True)
            if attrs["local_bytes"] and D not in MAY_SPILL.get(name, ()):
                spilled.append(f"{name} at head dim {D}")
    if spilled:
        fail(f"kernels spill to local memory: {', '.join(spilled)}")


def check_kernels(torch, F, fa):
    """Each kernel against its plain version, in bf16 and in f32; returns
    per-kernel results at the main path's shape (GPT-2-small's attention:
    B*H 192, S 1024, D 64, causal) in the kernel's dtype."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(BH, S, D, dtype):
        return torch.randn(BH, S, D, generator=gen, device="cuda").to(dtype)

    def close_check(a, b):
        """(max |a - b|, rms(b), worst |a - b| over its element's bound,
        the plain value there), with the bound of b's dtype."""
        if b.dtype == torch.float32:
            rtol, atol_rms, floor = F32_RTOL, F32_ATOL_RMS, F32_FLOOR
        else:
            rtol, atol_rms, floor = BF16_RTOL, ATOL_RMS, ABS_FLOOR
        a, b = a.float(), b.float()
        diff = (a - b).abs()
        rms = b.square().mean().sqrt().item()
        share = diff / (rtol * b.abs() + atol_rms * rms + floor)
        at = share.argmax()
        return (diff.max().item(), rms, share.view(-1)[at].item(),
                b.view(-1)[at].item())

    def lse_check(a, b):
        e = (a - b).abs().max().item()
        return e, b.square().mean().sqrt().item(), e / LSE_ABS_TOL, None

    bf16, f32 = torch.bfloat16, torch.float32
    results, failures = {}, []
    cases = [("main", 192, 1024, 64, True, bf16),
             ("gang", GANG_BATCH * 12, 1024, 64, True, bf16),
             # one microbatch of phase 6a's stages, and of 6e's ranks (6
             # heads each; 6d's ranks run the gang's 96)
             ("pipe", PIPE_BATCH // PIPE_MICROBATCHES * 12, 1024, 64, True,
              bf16),
             ("pipe_tp", PIPE_BATCH // PIPE_MICROBATCHES * 6, 1024, 64, True,
              bf16),
             ("ragged", 24, 1000, 64, True, bf16),
             ("ragged129", 24, 129, 64, True, bf16),
             ("noncausal", 24, 1024, 64, False, bf16),
             # head dims below 64: zero-padded to 64 for the bf16 kernels
             ("pad16", 24, 1024, 16, True, bf16),
             ("pad32", 24, 1000, 32, True, bf16),
             ("pad16nc", 8, 129, 16, False, bf16),
             ("main", 192, 1024, 64, True, f32),
             ("f32tiny", 8, 129, 16, True, f32),
             ("f32tinync", 8, 129, 16, False, f32),
             ("f32d32", 8, 257, 32, True, f32),
             ("f32d128", 8, 200, 128, False, f32),
             ("f32d128c", 8, 1000, 128, True, f32),
             # head dims above 64: the bf16_wide kernels, padded to 128
             ("wide", *WIDE_SHAPE, True, bf16),
             ("wide129", 24, 129, 128, True, bf16),
             ("bf16d96", 24, 1000, 96, True, bf16),
             ("bf16d96nc", 8, 129, 96, False, bf16),
             ("bf16d128", 8, 200, 128, False, bf16),
             # head dims 129-256: the f32 kernels at head dim 256, in
             # bf16 the bf16_d256 ones
             ("f32d129", 8, 129, 129, True, f32),
             ("f32d192", 8, 1000, 192, False, f32),
             ("f32d256", 8, 1024, 256, False, f32),
             ("f32d256r", 8, 129, 256, True, f32),
             ("d256", *D256_SHAPE, True, f32),
             ("bf16d129", 8, 1000, 129, True, bf16),
             ("bf16d192", 8, 129, 192, False, bf16),
             ("bf16d256", 8, 1024, 256, False, bf16),
             ("bf16d256r", 8, 129, 256, True, bf16),
             ("d256", *D256_SHAPE, True, bf16),
             # float16: the f32 kernels on f32 copies, outputs cast back
             ("f16", 24, 1000, 64, True, torch.float16),
             ("f16d256", 8, 129, 256, False, torch.float16),
             # head dims above 256: the split-head-dim kernels, padded to
             # a multiple of 64 (300 to 320), float16 on f32 copies
             ("f32d320", 8, 1024, 320, True, f32),
             ("f32d320nc", 8, 1024, 320, False, f32),
             ("f32d512nc", 24, 1024, 512, False, f32),
             ("f32d300r", 8, 129, 300, True, f32),
             # the forwards and f32's dq and dk/dv above 256 take
             # 256-column chunks: a narrow last one (384), a head dim
             # padded to 576 (520) and four chunks (1000, padded to 1024);
             # bf16's forward keeps Q resident up to 512 and streams it
             # above (520, 576, 1000)
             ("f32d384", 8, 1024, 384, True, f32),
             ("f32d384nc", 8, 129, 384, False, f32),
             ("f32d520", 8, 129, 520, True, f32),
             ("f32d576nc", 8, 1024, 576, False, f32),
             ("f32d1000", 2, 1024, 1000, True, f32),
             ("f32d1000nc", 2, 129, 1000, False, f32),
             ("dsplit", *DSPLIT_SHAPE, True, f32),
             ("bf16d320", 8, 1024, 320, True, bf16),
             ("bf16d320nc", 8, 1024, 320, False, bf16),
             ("bf16d512nc", 24, 1024, 512, False, bf16),
             ("bf16d300r", 8, 129, 300, False, bf16),
             ("bf16d384", 8, 1024, 384, True, bf16),
             ("bf16d384nc", 8, 129, 384, False, bf16),
             ("bf16d520", 8, 129, 520, True, bf16),
             ("bf16d576nc", 8, 1024, 576, False, bf16),
             ("bf16d576", 8, 129, 576, True, bf16),
             ("bf16d1000", 2, 1024, 1000, True, bf16),
             ("bf16d1000nc", 2, 129, 1000, False, bf16),
             # bf16's dq and dk/dv: a last 256-column chunk of three
             # 64-column boxes (448; 320 and 384 give one and two), and
             # whole chunks with a one-row last tile (512 at S 129: dq's
             # second 128-row Q tile, dk/dv's third 64-row KV tile)
             ("bf16d448", 8, 1000, 448, True, bf16),
             ("bf16d512r", 8, 129, 512, True, bf16),
             ("dsplit", *DSPLIT_SHAPE, True, bf16),
             ("f16d320", 8, 129, 320, True, torch.float16),
             ("f16d520nc", 4, 1024, 520, False, torch.float16)]
    for label, BH, S, D, causal, dtype in cases:
        suffix = suffix_of(dtype != bf16, D)
        q, k, v, do = (rand(BH, S, D, dtype) for _ in range(4))
        kw = dict(scale=1.0 / math.sqrt(D), causal=causal)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, **kw)
        delta = (do.float() * o_ref.float()).sum(dim=-1)
        dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, **kw)
        dq_ref = fa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, **kw)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, **kw)
        dk_ref, dv_ref = fa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, **kw)
        torch.cuda.synchronize()
        checks = {
            "flash_fwd" + suffix: [
                ("o", *close_check(o, o_ref)),
                ("lse", *lse_check(lse, lse_ref))],
            "flash_bwd_dq" + suffix: [
                ("dq", *close_check(dq, dq_ref))],
            "flash_bwd_dkv" + suffix: [
                ("dk", *close_check(dk, dk_ref)),
                ("dv", *close_check(dv, dv_ref))],
        }
        for name, rows in checks.items():
            for what, e, rms, worst, at in rows:
                ok = math.isfinite(worst) and worst <= 1.0
                where = "" if at is None else f" (plain value {at:.3e})"
                print(f"check {label:9s} BH={BH} S={S} D={D} causal={causal} "
                      f"{name}.{what}: max_abs_err {e:.3e} rms {rms:.3e} "
                      f"err/rms {e / rms:.2e}; worst element {worst:.3f} of "
                      f"its bound{where} {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    failures.append(f"{name}.{what} ({label})")
        if label in ("main", "wide", "d256", "dsplit"):
            # the f32 kernels' head-dim-256 times go under names of
            # their own
            tag = D256 if label == "d256" and dtype == f32 else ""
            results.update(time_kernels(torch, F, fa, suffix, checks,
                                        q, k, v, do, lse_ref, delta, kw,
                                        tag=tag))
        del q, k, v, do, o, lse, o_ref, lse_ref, delta, dq, dq_ref, dk, dv
        del dk_ref, dv_ref
        torch.cuda.empty_cache()
    if failures:
        fail(f"kernels disagree with their plain versions: {', '.join(failures)}")
    return results


def time_kernels(torch, F, fa, suffix, checks, q, k, v, do, lse_ref, delta,
                 kw, tag):
    """Device times of the three kernels that take the inputs (``suffix``:
    their family's suffix), their plain versions and SDPA in the inputs'
    dtype, beside the bound (of that dtype); for bf16 also the backward as
    ``_FlashAttention.backward`` runs it, for f32 dq + dk/dv against
    SDPA's backward. Results go under each kernel's name followed by
    ``tag``."""
    BH, S, D = q.shape
    causal = kw["causal"]
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
    B = math.gcd(BH, 16)
    H = BH // B
    q4, k4, v4 = (x.view(B, H, S, D).detach().requires_grad_(True)
                  for x in (q, k, v))
    sdpa_fwd_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal, scale=kw["scale"]), warmup=3, reps=20)
    out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                          scale=kw["scale"])
    do4 = do.view(B, H, S, D)
    sdpa_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        out4, (q4, k4, v4), do4, retain_graph=True), warmup=3, reps=20)
    library = {"flash_fwd": sdpa_fwd_ms, "flash_bwd_dq": sdpa_bwd_ms,
               "flash_bwd_dkv": sdpa_bwd_ms}
    results = {}
    for base, (kernel_fn, plain_fn) in fns.items():
        name = base + suffix
        bound_ms, bound_by, flops, nbytes, ffma_ms = attention_bound(
            name, BH, S, causal, D)
        ms = time_ms(torch, kernel_fn, warmup=3, reps=20)
        plain_ms = time_ms(torch, plain_fn, warmup=1, reps=5)
        tflops = flops / (ms * 1e-3) / 1e12
        results[name + tag] = {
            "max_abs_err": max(row[1] for row in checks[name]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library[base],
            "tflops": tflops, "bound_share": bound_ms / ms,
        }
        also = ""
        if ffma_ms is not None:
            results[name + tag].update(ffma_bound_ms=ffma_ms,
                                       ffma_bound_share=ffma_ms / ms)
            also = (f"; FFMA bound {ffma_ms * 1e3:.1f} us (67 TFLOP/s), "
                    f"{ffma_ms / ms:.3f} of it")
        print(f"time {name}{tag} ({q.dtype} BH={BH} S={S} D={D}): kernel "
              f"{ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, SDPA ({q.dtype}) {library[base]:.4f} ms, "
              f"bound {bound_ms * 1e3:.1f} us ({bound_by}"
              f"{', 3xTF32 165 TFLOP/s' if ffma_ms is not None else ''}; "
              f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), "
              f"{tflops:.1f} TFLOP/s, {bound_ms / ms:.3f} of the bound{also}",
              flush=True)
    dq_name, dkv_name = (base + suffix + tag
                         for base in ("flash_bwd_dq", "flash_bwd_dkv"))
    if q.dtype == torch.float32:
        pair = results[dq_name]["ms"] + results[dkv_name]["ms"]
        print(f"time f32 kernels' backward{tag} ({q.dtype}, "
              f"D={D}): dq + dk/dv {pair:.4f} ms, SDPA's backward in "
              f"{q.dtype} (dq, dk, dv in one call) {sdpa_bwd_ms:.4f} ms: "
              f"{pair / sdpa_bwd_ms:.2f}x SDPA's", flush=True)
        return results
    if suffix == "_bf16w":
        return results
    # the backward pair as _FlashAttention.backward runs it (delta, dq,
    # dk/dv) against SDPA's whole backward; printed, not gated
    qf, kf, vf = (x.detach().requires_grad_(True) for x in (q, k, v))
    of = fa._FlashAttention.apply(qf, kf, vf, kw["scale"], causal)
    flash_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        of, (qf, kf, vf), do, retain_graph=True), warmup=3, reps=20)
    o_det = of.detach()
    delta_ms = time_ms(torch, lambda: (do.float() * o_det.float()).sum(dim=-1),
                       warmup=3, reps=20)
    print(f"time backward ({q.dtype}, D={D}): flash (delta + dq + dk/dv) "
          f"{flash_bwd_ms:.4f} ms (delta {delta_ms:.4f}, dq "
          f"{results[dq_name]['ms']:.4f}, dk/dv {results[dkv_name]['ms']:.4f} "
          f"alone), SDPA {sdpa_bwd_ms:.4f} ms: "
          f"{flash_bwd_ms / sdpa_bwd_ms:.2f}x SDPA's", flush=True)
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
    for name, n in launches.items():
        expected = 0 if family(name) else cfg.n_layer * (warmup + timed)
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


def check_attention_grads(torch, gpt2, params, batch, ref_cfg, cfg, *,
                          limit=ATTN_GRAD_RTOL, tag="train", gate=True):
    """The gradients of the attention leaves (wq, wk, wv, wo, each stacked
    over the layers) from one loss_fn call on the same weights, with
    reference and with flash attention, within ``limit`` relative; with
    ``gate`` False printed only."""
    attn = params["blocks"]["attn"]
    names = sorted(attn)
    grads, bad = [], []
    for run_cfg in (ref_cfg, cfg):
        loss, _ = gpt2.loss_fn(params, batch, run_cfg)
        grads.append(torch.autograd.grad(loss, [attn[n] for n in names]))
    for name, g_ref, g in zip(names, *grads):
        rel = ((g - g_ref).norm() / g_ref.norm()).item()
        ok = rel <= limit
        verdict = (("ok" if ok else "FAIL") if gate
                   else "(printed, not gated)")
        print(f"{tag}: grad of {name}: norm {g.norm().item():.6e} flash, "
              f"{g_ref.norm().item():.6e} reference; ||flash - reference|| / "
              f"||reference|| {rel:.3e} (limit {limit:.1e}) {verdict}",
              flush=True)
        if gate and not ok:
            bad.append(name)
    del grads
    torch.cuda.empty_cache()
    if bad:
        fail(f"attention gradients disagree with reference attention: {bad}")


def tiny_configs(torch, fa):
    """gpt2_tiny (head dim 16) under attention="auto" in bf16 and in f32,
    with two heads of 128 in bf16 (the bf16_wide kernels), with one head
    of 256 in bf16 (the bf16_d256 kernels) and in f32 (the f32 kernels at
    head dim 256), and with one head of 320 in bf16 and in f32 (the
    split-head-dim kernels),
    TINY_STEPS steps each, its first step held to reference attention;
    returns each run's launch counts, set to 0 just before its steps and
    read just after."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel.train_step import (default_optimizer,
                                                   make_train_state,
                                                   make_train_step)

    base = gpt2.gpt2_tiny()
    tokens = torch.randint(0, base.vocab_size, (TINY_BATCH, base.max_seq + 1),
                           device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(2))
    batch = {"tokens": tokens}
    out, bad = {}, []
    bf16_limits = (LOSS_RTOL, GRAD_NORM_RTOL, ATTN_GRAD_RTOL)
    for dtype, widths, name, (loss_rtol, gn_rtol, attn_rtol) in (
            (torch.bfloat16, {}, "", bf16_limits),
            (torch.float32, {}, "", TINY_F32_LIMITS),
            (torch.bfloat16, WIDE_TINY, " wide", bf16_limits),
            (torch.bfloat16, D256_TINY, " d256", bf16_limits),
            (torch.float32, D256_TINY, " d256", TINY_F32_LIMITS),
            (torch.bfloat16, D320_TINY, " d320", bf16_limits),
            (torch.float32, D320_TINY, " d320", TINY_F32_LIMITS)):
        tag = f"tiny {str(dtype).removeprefix('torch.')}{name}"
        cfg = dataclasses.replace(base, dtype=dtype, **widths)
        ref_cfg = dataclasses.replace(cfg, attention="reference")

        def run(run_cfg):
            opt = default_optimizer(1e-3, warmup_steps=1, total_steps=10)
            state = make_train_state(
                lambda g: gpt2.init(g, run_cfg),
                torch.Generator(device="cuda").manual_seed(0), opt)
            return state, make_train_step(
                lambda p, b: gpt2.loss_fn(p, b, run_cfg), opt)

        state, step = run(ref_cfg)
        _, m = step(state, batch)
        ref = (float(m["loss"]), float(m["grad_norm"]))
        state, step = run(cfg)
        check_attention_grads(torch, gpt2, state.params, batch, ref_cfg, cfg,
                              limit=attn_rtol, tag=tag)
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        metrics = []
        for _ in range(TINY_STEPS):
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        torch.cuda.synchronize()
        launches = out[tag] = dict(fa.LAUNCHES)
        (loss, gn) = metrics[0]
        loss_rel, gn_rel = abs(loss - ref[0]) / ref[0], abs(gn - ref[1]) / ref[1]
        print(f"{tag}: gpt2_tiny (head dim {cfg.d_model // cfg.n_head}) "
              f"attention=auto, batch {TINY_BATCH}, {TINY_STEPS} steps: losses "
              f"{[x for x, _ in metrics]}; first step against reference "
              f"attention: loss {loss_rel:.2e} (limit {loss_rtol:.0e}), grad "
              f"norm {gn_rel:.2e} (limit {gn_rtol:.0e}); launches {launches}",
              flush=True)
        ran = {base + suffix_of(dtype == torch.float32,
                                cfg.d_model // cfg.n_head)
               for base in REPLACES}
        for name, n in launches.items():
            want = cfg.n_layer * TINY_STEPS if name in ran else 0
            if n != want:
                bad.append(f"{tag}: {name} launched {n} times, expected {want}")
        if not all(math.isfinite(x) for pair in metrics for x in pair):
            bad.append(f"{tag}: non-finite loss or grad norm")
        if not loss_rel <= loss_rtol:
            bad.append(f"{tag}: first-step loss disagrees with reference")
        if not gn_rel <= gn_rtol:
            bad.append(f"{tag}: first-step grad norm disagrees with reference")
        del state, step
    if bad:
        fail("; ".join(bad))
    return out


def moe_layer_check(torch, L):
    """Gate (a) of phase 3c: ``apply_moe`` on the card in f32 (TF32 off)
    at GPT-2-small-MoE's width, on MOE_ORACLE_TOKENS tokens with room for
    every one (capacity factor 8), against a loop over the tokens: each
    token's top-k experts' MLPs weighted by its renormalized gates (the
    oracle of ``tests/test_parallel.py``'s
    ``test_moe_matches_per_token_oracle``), within MOE_ORACLE_ATOL."""
    cfg = L.MoEConfig(capacity_factor=8.0)
    d, f, E = 768, 3072, cfg.n_experts
    gen = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    # a router sharp enough that no two of a token's probabilities tie,
    # and experts whose outputs are O(1)
    params = {"wg": randn(d, E), "w1": randn(E, d, f, scale=d ** -0.5),
              "w2": randn(E, f, d, scale=f ** -0.5)}
    x = randn(*MOE_ORACLE_TOKENS, d)
    out, aux = L.apply_moe(params, x, cfg, compute_dtype=torch.float32)
    probs = torch.softmax(x @ params["wg"], dim=-1)
    gates, experts = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    want = torch.zeros_like(x)
    for b in range(x.shape[0]):
        for s in range(x.shape[1]):
            want[b, s] = sum(
                gates[b, s, j] * (L._gelu(x[b, s] @ params["w1"][e]) @
                                  params["w2"][e])
                for j, e in enumerate(experts[b, s].tolist()))
    err = (out - want).abs().max().item()
    ok = err <= MOE_ORACLE_ATOL and math.isfinite(float(aux))
    print(f"moe check: apply_moe in f32 at d {d}, ff {f}, {E} experts, "
          f"top-{cfg.top_k}, on {x.shape[0]} x {x.shape[1]} tokens against "
          f"the per-token loop: max_abs_err {err:.3e} (limit "
          f"{MOE_ORACLE_ATOL:.0e}), rms of the output "
          f"{want.square().mean().sqrt().item():.3e}, aux {float(aux):.4f} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("apply_moe disagrees with the per-token loop on the card")


def moe(torch, fa, card: str):
    """Phase 3c: GPT-2-small-MoE at full width, batch MOE_BATCH, seq 1024,
    through make_train_step (2 warm-up and 5 timed steps); returns the
    launch counts of the timed run, set to 0 just before its steps and
    read just after."""
    from ray_tpu_torch._private.tree import (tree_leaves, tree_map,
                                             tree_unflatten)
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models import layers as L
    from ray_tpu_torch.parallel.train_step import (default_optimizer,
                                                   global_norm,
                                                   make_train_state,
                                                   make_train_step)

    torch.cuda.empty_cache()
    moe_layer_check(torch, L)
    cfg = dataclasses.replace(gpt2.gpt2_small(), remat=False,
                              moe=L.MoEConfig())
    B, S, warmup, timed = MOE_BATCH, 1024, 2, 5
    C = L.moe_capacity(cfg.moe, B * S)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(4))
    batch = {"tokens": tokens}

    def run(run_cfg):
        opt = default_optimizer(1e-4, warmup_steps=10, total_steps=1000)
        state = make_train_state(lambda g: gpt2.init(g, run_cfg),
                                 torch.Generator(device="cuda").manual_seed(0), opt)
        return state, make_train_step(lambda p, b: gpt2.loss_fn(p, b, run_cfg),
                                      opt)

    def steps(state, step, n):
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state, m = step(state, batch)
            out.append(m)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return state, [{k: float(v) for k, v in m.items()} for m in out], dt

    # Gate (b), the first step against reference attention, is taken in
    # f32 on this model. In bf16 the router's top-k turns the rounding by
    # which flash and reference attention differ into other experts for a
    # few tokens a layer, and at init a layer's output outweighs the
    # residual stream (wte is drawn at 0.02), so a token whose experts
    # change changes whole: with the plain versions on the CPU, no kernel
    # involved, the loss moves by 1.1e-4 and the attention leaves'
    # gradients by 0.11-0.14, against 5.4e-6 and 0.7-1.0e-2 for the dense
    # model, while in f32 no token changes experts
    # (scripts/moe_routing_sensitivity.py). The bf16 first step is printed
    # beside it.
    f32_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = tree_map(lambda p: p.requires_grad_(True), gpt2.init(
        torch.Generator(device="cuda").manual_seed(0), f32_cfg))
    f32_ref_cfg = dataclasses.replace(f32_cfg, attention="reference")
    first = []
    for run_cfg in (f32_ref_cfg, f32_cfg):
        total, m = gpt2.loss_fn(params, batch, run_cfg)
        grads = torch.autograd.grad(total, tree_leaves(params))
        first.append((float(m["loss"].detach()),
                      float(global_norm(tree_unflatten(params, grads)))))
        del total, m, grads
    check_attention_grads(torch, gpt2, params, batch, f32_ref_cfg, f32_cfg,
                          limit=TINY_F32_LIMITS[2], tag="moe f32")
    del params
    torch.cuda.empty_cache()
    (ref_loss, ref_gn), (loss, gn) = first
    loss_rel, gn_rel = abs(loss - ref_loss) / ref_loss, abs(gn - ref_gn) / ref_gn
    print(f"moe f32: first step flash loss {loss:.6f} grad_norm {gn:.6f}; "
          f"reference loss {ref_loss:.6f} grad_norm {ref_gn:.6f}; relative "
          f"differences {loss_rel:.2e} (limit {TINY_F32_LIMITS[0]:.0e}) and "
          f"{gn_rel:.2e} (limit {TINY_F32_LIMITS[1]:.0e})", flush=True)
    bad = []
    if not loss_rel <= TINY_F32_LIMITS[0]:
        bad.append("the f32 first-step loss disagrees with reference attention")
    if not gn_rel <= TINY_F32_LIMITS[1]:
        bad.append("the f32 first-step grad norm disagrees with reference "
                   "attention")

    ref_cfg = dataclasses.replace(cfg, attention="reference")
    state, step = run(ref_cfg)
    state, (ref,), _ = steps(state, step, 1)
    del state, step
    torch.cuda.empty_cache()
    state, step = run(cfg)
    check_attention_grads(torch, gpt2, state.params, batch, ref_cfg, cfg,
                          tag="moe bf16", gate=False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    state, metrics, _ = steps(state, step, warmup)
    state, timed_metrics, dt = steps(state, step, timed)
    launches = dict(fa.LAUNCHES)
    metrics += timed_metrics
    peak = torch.cuda.max_memory_allocated()

    # the share of (token, k) pairs past capacity, layer by layer, in one
    # more forward from the state after the timed steps
    dropped = []
    apply_moe = L.apply_moe

    def counting(params, x, moe_cfg, compute_dtype, **kw):
        _, _, _, slots = L.route_tokens(params["wg"], x, moe_cfg)
        dropped.append(((slots >= C).sum() / slots.numel()).item())
        return apply_moe(params, x, moe_cfg, compute_dtype, **kw)

    L.apply_moe = counting
    try:
        with torch.no_grad():
            gpt2.forward(state.params, tokens[:, :-1], cfg)
    finally:
        L.apply_moe = apply_moe
    profile_step(torch, step, state, batch, dt / timed * 1e3,
                 tag="moe profile")
    del state, step
    torch.cuda.empty_cache()

    losses = [m["loss"] for m in metrics]
    auxes = [m["aux_loss"] for m in metrics]
    print(f"moe: losses {losses}; aux losses {auxes}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        bad.append("non-finite loss")
    if not all(math.isfinite(x) and x > 0 for x in auxes):
        bad.append("an aux loss that is not finite and positive")
    loss_rel = abs(metrics[0]["loss"] - ref["loss"]) / ref["loss"]
    gn_rel = abs(metrics[0]["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
    print(f"moe bf16: first step flash loss {metrics[0]['loss']:.6f} "
          f"grad_norm {metrics[0]['grad_norm']:.6f} aux "
          f"{metrics[0]['aux_loss']:.6f}; reference loss {ref['loss']:.6f} "
          f"grad_norm {ref['grad_norm']:.6f} aux {ref['aux_loss']:.6f}; "
          f"relative differences {loss_rel:.2e} and {gn_rel:.2e} (printed, "
          f"not gated)", flush=True)
    for name, n in launches.items():
        expected = 0 if family(name) else cfg.n_layer * (warmup + timed)
        if n != expected:
            bad.append(f"{name} launched {n} times, expected {expected}")
    step_ms = dt / timed * 1e3
    print(f"moe: {card}: GPT-2-small-MoE ({cfg.n_params / 1e6:.1f} M params, "
          f"{cfg.moe.n_experts} experts, top-{cfg.moe.top_k}, capacity factor "
          f"{cfg.moe.capacity_factor}, C {C}) batch {B} seq {S}: step "
          f"{step_ms:.1f} ms, {timed * B * S / dt:.0f} tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB ({warmup} warm-up and {timed} timed "
          f"steps); (token, k) pairs past capacity after the steps, by layer: "
          + ", ".join(f"{x:.4f}" for x in dropped)
          + f" (mean {statistics.fmean(dropped):.4f}); launches {launches}",
          flush=True)
    if bad:
        fail(f"moe: {'; '.join(bad)}")
    return launches


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


def profile_step(torch, step, state, batch, step_ms, tag="profile"):
    """One more step under torch.profiler, its lines prefixed by ``tag``:
    device time by kernel category and by operator. The profiler's own host cost stretches the
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
        print(f"{tag}: the profiler saw no device time (not measured)")
        return
    print(f"{tag}: one step, device busy {busy_us / 1e3:.1f} ms in "
          f"{sum(c for _, c, _ in rows)} kernels; idle share "
          f"{1 - busy_us / (step_ms * 1e3):.3f} of the unprofiled "
          f"{step_ms:.1f} ms step (wall {wall_us / 1e3:.1f} ms with the "
          f"profiler on)")
    shares = {}
    for key, _, t in rows:
        shares[category(key)] = shares.get(category(key), 0.0) + t
    for cat, t in sorted(shares.items(), key=lambda kv: -kv[1]):
        print(f"{tag}: {cat}: {t / 1e3:.2f} ms ({t / busy_us:.3f})")
    for key, count, t in sorted(rows, key=lambda r: -r[2])[:8]:
        print(f"{tag}:   {t / 1e3:8.2f} ms  x{count:<4d} {key[:100]}")
    # the operators that launched them, by input shapes
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"{tag}:   {e.self_device_time_total / 1e3:8.2f} ms  "
              f"x{e.count:<4d} {e.key} {str(e.input_shapes)[:90]}")

class RankProfile:
    """One more step of every rank thread under torch.profiler (``run``
    on each rank), which rank 0 starts before any rank's step and stops
    after every rank's. ``report`` prints the device time of the ranks'
    kernels, summed, against the unprofiled step: kernels of different
    ranks may overlap on the card, so the sum can only overstate its busy
    time, and the idle share printed is a lower bound."""

    def __init__(self, torch, world: int):
        self.torch = torch
        self.barrier = threading.Barrier(world, timeout=GANG_JOIN_S)
        self.prof = None

    def run(self, rank: int, step) -> None:
        from torch.profiler import ProfilerActivity, profile

        if rank == 0:
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.barrier.wait()
        step()
        self.torch.cuda.current_stream().synchronize()
        self.barrier.wait()
        if rank == 0:
            self.prof.__exit__(None, None, None)

    def device_names(self) -> list:
        """The name of every device event of the profiled step."""
        from torch.autograd import DeviceType

        return [e.name for e in self.prof.events()
                if e.device_type == DeviceType.CUDA]

    def report(self, tag: str, step_ms: float) -> None:
        from torch.autograd import DeviceType

        rows = [(e.key, e.count, e.self_device_time_total)
                for e in self.prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        busy_us = sum(t for _, _, t in rows)
        if busy_us == 0:
            print(f"{tag}: the profiler saw no device time (not measured)",
                  flush=True)
            return
        shares = {}
        for key, _, t in rows:
            shares[category(key)] = shares.get(category(key), 0.0) + t
        print(f"{tag}: one step of every rank, the ranks' kernels "
              f"{busy_us / 1e3:.1f} ms of device time in "
              f"{sum(c for _, c, _ in rows)} kernels against the unprofiled "
              f"{step_ms:.1f} ms step: the card idle at least "
              f"{max(0.0, 1 - busy_us / (step_ms * 1e3)):.3f} of it; "
              + ", ".join(f"{cat} {t / 1e3:.1f} ms" for cat, t in
                          sorted(shares.items(), key=lambda kv: -kv[1])),
              flush=True)


def _rank_threads(torch, world: int, join, fn, leave, groups):
    """On each of ``world`` threads of this process, each on a CUDA stream
    of its own: ``member = join(rank)``, ``fn(member)``, ``leave(member)``;
    a rank whose ``fn`` raises poisons its ``groups(member)`` first, so
    its peers fail at once. Returns the results in rank order; a rank's
    error is raised here, and a rank still running after GANG_JOIN_S
    fails the script."""
    from ray_tpu_torch.util import collective as col

    results, errors = [None] * world, [None] * world

    def run(rank):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                member = join(rank)
                try:
                    with col.poison_on_error(*groups(member)):
                        results[rank] = fn(member)
                finally:
                    leave(member)
                torch.cuda.current_stream().synchronize()
        except BaseException as e:  # raised on the main thread below
            errors[rank] = e

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + GANG_JOIN_S
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    if any(t.is_alive() for t in threads):
        fail(f"rank threads still running after {GANG_JOIN_S} s")
    for e in errors:
        if e is not None:
            raise e
    return results


def run_ranks(torch, world: int, fn, backend=COLLECTIVE_BACKEND):
    """``fn(rank, group)`` on ``world`` rank threads, each holding its own
    group (``train_dp_r<rank>``) on ``backend`` over one in-memory store,
    so no port is bound."""
    import torch.distributed as dist
    from ray_tpu_torch.util import collective as col

    store = dist.HashStore()

    def join(rank):
        group = f"train_dp_r{rank}"
        col.init_collective_group(world, rank, backend, group_name=group,
                                  store=store, timeout_s=GANG_OP_TIMEOUT_S)
        return rank, group

    return _rank_threads(torch, world, join, lambda m: fn(*m),
                         lambda m: col.destroy_collective_group(m[1]),
                         lambda m: [m[1]])


def run_mesh(torch, config, fn, backend=COLLECTIVE_BACKEND):
    """``fn(layout)`` on one rank thread for each rank of ``config`` (a
    ``parallel.mesh.MeshConfig``), each holding its axis groups on
    ``backend`` over one in-memory store."""
    import torch.distributed as dist
    from ray_tpu_torch.parallel import mesh

    store = dist.HashStore()
    return _rank_threads(
        torch, config.world_size,
        lambda rank: mesh.init_rank_layout(
            config, rank, store=store, name="pipe",
            timeout_s=GANG_OP_TIMEOUT_S, backend=backend),
        fn, mesh.destroy_rank_layout, mesh.layout_groups)


def run_entry(torch, the_mesh, fn, backend=COLLECTIVE_BACKEND):
    """``fn(layout)`` on one rank thread for each rank of ``the_mesh`` (a
    ``parallel.mesh.Mesh``), each joined by ``Mesh.join`` on ``backend``
    over one in-memory store."""
    import torch.distributed as dist
    from ray_tpu_torch.parallel import mesh

    store = dist.HashStore()
    return _rank_threads(
        torch, the_mesh.size,
        lambda rank: the_mesh.join(rank, store=store, name="entry",
                                   timeout_s=GANG_OP_TIMEOUT_S,
                                   backend=backend),
        fn, mesh.destroy_rank_layout, mesh.layout_groups)


class CommTimer:
    """Seconds a rank thread spends inside each collective op of ``ops``
    (name -> (module, attribute)) while a measurement is on (``start`` to
    ``stop``), waits for its peers included; an op called inside another
    counts in the outer one only. An op whose name holds ``{axis}`` counts
    under the axis of the group it is given as its second argument, on
    the rank's layout (``"{axis} sums"`` is ``"tp sums"`` over the tp
    group, ``"ep sums"`` over the ep group). ``with`` the timer the ops
    are wrapped and restored after."""

    def __init__(self, ops):
        self.ops = ops
        self.originals = {op: getattr(*where) for op, where in ops.items()}
        self.parts = threading.local()

    def _timed(self, op, fn):
        def run(*args, **kw):
            parts = self.parts
            if getattr(parts, "inside", False):
                return fn(*args, **kw)
            parts.inside = True
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                parts.inside = False
                acc = getattr(parts, "acc", None)
                if acc is not None:
                    key = (op.format(axis=parts.axes[args[1]])
                           if "{axis}" in op else op)
                    acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
        return run

    def __enter__(self):
        for op, (module, attr) in self.ops.items():
            setattr(module, attr, self._timed(op, self.originals[op]))
        return self

    def __exit__(self, *exc):
        for op, (module, attr) in self.ops.items():
            setattr(module, attr, self.originals[op])

    def start(self, layout):
        """Start this rank thread's measurement, on its ``layout``."""
        self.parts.axes = {getattr(layout, f"{axis}_group"): axis
                           for axis in ("dp", "pp", "ep", "sp", "tp")}
        self.parts.acc = {op: 0.0 for op in self.ops if "{axis}" not in op}

    def stop(self) -> dict:
        """Seconds in each op since ``start`` on this rank thread."""
        acc, self.parts.acc = self.parts.acc, None
        return acc


def same_bits(torch, a_leaves, b_leaves) -> bool:
    return all(torch.equal(a.contiguous().view(torch.uint8),
                           b.contiguous().view(torch.uint8))
               for a, b in zip(a_leaves, b_leaves, strict=True))


def gang(torch, fa, card: str):
    """The data-parallel Train gang at world 2 on one card: two rank
    threads, each GPT-2-small at full width on batch 8 (the main path's
    16 between them), bucketed DDP and then ZeRO; returns the launch
    counts of each run."""
    from ray_tpu_torch._private.tree import (tree_leaves, tree_map,
                                             tree_unflatten)
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import sharding as sh
    from ray_tpu_torch.parallel.train_step import (default_optimizer,
                                                   global_norm,
                                                   make_train_state,
                                                   make_train_step,
                                                   make_zero_train_state)
    from ray_tpu_torch.train import ddp

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(gpt2.gpt2_small(), remat=False)
    S, warmup, timed = 1024, 2, 3
    tokens = torch.randint(0, cfg.vocab_size, (2 * GANG_BATCH, S + 1),
                           device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))

    def batch_of(rank):
        return {"tokens": tokens[rank * GANG_BATCH:(rank + 1) * GANG_BATCH]}

    def loss(p, b):
        return gpt2.loss_fn(p, b, cfg)

    def init(g):
        return gpt2.init(g, cfg)

    def seeded():
        return torch.Generator(device="cuda").manual_seed(0)

    def grads_of(params, batch):
        value, _ = loss(params, batch)
        return value.detach(), tree_unflatten(
            params, torch.autograd.grad(value, tree_leaves(params)))

    # the yardstick: the one-card step's loss and grads on the whole batch,
    # with reference attention, so that it sees the kernels as phase 3 does
    ref_cfg = dataclasses.replace(cfg, attention="reference")
    params = tree_map(lambda p: p.requires_grad_(True), init(seeded()))
    ref_loss, _ = gpt2.loss_fn(params, {"tokens": tokens}, ref_cfg)
    ref_grads = tree_unflatten(params, torch.autograd.grad(
        ref_loss, tree_leaves(params)))
    ref_loss, ref_norm = float(ref_loss.detach()), float(global_norm(ref_grads))
    del params
    torch.cuda.empty_cache()

    def ddp_rank(rank, group):
        opt = default_optimizer(1e-4, warmup_steps=10, total_steps=1000)
        state = make_train_state(init, seeded(), opt)
        rec = {"wait_s": [], "sync_s": [], "buckets": 0, "raw": None,
               "synced": None}

        def hook(grads):
            t0 = time.perf_counter()
            pending = ddp.sync_gradients_async(grads, group, average=True,
                                               bucket_bytes=GANG_BUCKET_BYTES)
            rec["buckets"] = pending.num_buckets
            synced = pending.result()
            rec["sync_s"].append(time.perf_counter() - t0)
            rec["wait_s"].append(pending.wait_s)
            if rec["raw"] is None:
                rec["raw"] = tree_map(lambda g: g.detach().clone(), grads)
                rec["synced"] = tree_map(torch.clone, synced)
            return synced

        step = make_train_step(loss, opt, host_grad_sync=hook)
        state, m = step(state, batch_of(rank))
        first = (float(m["loss"]), float(m["grad_norm"]))
        for _ in range(warmup - 1):
            state, _ = step(state, batch_of(rank))
        torch.cuda.current_stream().synchronize()
        t0 = time.perf_counter()
        for _ in range(timed):
            state, _ = step(state, batch_of(rank))
        torch.cuda.current_stream().synchronize()
        return {**rec, "first": first, "params": tree_leaves(state.params),
                "step_ms": (time.perf_counter() - t0) / timed * 1e3,
                "wait_ms": sum(rec["wait_s"][-timed:]) / timed * 1e3,
                "host_ms": sum(rec["sync_s"][-timed:]) / timed * 1e3}

    fa.reset_launch_counts()
    ranks = run_ranks(torch, 2, ddp_rank)
    launches = {"ddp": dict(fa.LAUNCHES)}
    # 8b: the same steps with the ranks' groups on gloo
    on_gloo = run_ranks(torch, 2, ddp_rank, backend="gloo")
    times = {"ddp": ranks, "buckets": ranks[0]["buckets"],
             "ddp gloo": on_gloo}
    attn, attn_ref = ranks[0]["synced"]["blocks"]["attn"], ref_grads["blocks"]["attn"]
    attn_rel = {n: float((attn[n] - attn_ref[n]).norm() / attn_ref[n].norm())
                for n in sorted(attn)}
    synced = [tree_leaves(r["synced"]) for r in ranks]
    checks = {
        "the ranks' synced grads are bit-identical":
            same_bits(torch, *synced),
        "the ranks' params after the steps are bit-identical":
            same_bits(torch, ranks[0]["params"], ranks[1]["params"]),
    }
    # the kill switch: the same grads as one synchronous whole-tree sync
    os.environ["RAY_TPU_TORCH_TRAIN_BUCKET_DDP"] = "0"
    try:
        whole = run_ranks(torch, 2, lambda rank, group: tree_leaves(
            ddp.sync_gradients(ranks[rank]["raw"], group, average=True)))
    finally:
        del os.environ["RAY_TPU_TORCH_TRAIN_BUCKET_DDP"]
    checks["bucketed sync is bit-identical to the whole-tree sync"] = all(
        same_bits(torch, w, s) for w, s in zip(whole, synced))
    checks["8b: the synced grads on gloo are the device backend's, bit for "
           "bit"] = all(same_bits(torch, tree_leaves(g["synced"]), s)
                        for g, s in zip(on_gloo, synced))
    checks["8b: the params after the steps on gloo are the device "
           "backend's, bit for bit"] = all(
        same_bits(torch, g["params"], r["params"])
        for g, r in zip(on_gloo, ranks))
    loss_rel = abs((ranks[0]["first"][0] + ranks[1]["first"][0]) / 2
                   - ref_loss) / ref_loss
    gn_rel = abs(ranks[0]["first"][1] - ref_norm) / ref_norm
    print(f"gang ddp: first step against the one-card step on batch "
          f"{2 * GANG_BATCH} with reference attention: loss {ref_loss:.6f}, "
          f"relative difference {loss_rel:.2e} (limit {LOSS_RTOL:.0e}); grad "
          f"norm {ref_norm:.6f}, {gn_rel:.2e} (limit {GRAD_NORM_RTOL:.0e}); "
          f"||g_gang - g_one|| / ||g_one|| of the attention leaves "
          + ", ".join(f"{n} {r:.3e}" for n, r in attn_rel.items())
          + f" (limit {ATTN_GRAD_RTOL:.1e})", flush=True)
    checks["the gang's loss is the one-card step's"] = loss_rel <= LOSS_RTOL
    checks["the gang's grad norm is the one-card step's"] = gn_rel <= GRAD_NORM_RTOL
    for n, r in attn_rel.items():
        checks[f"the gang's grad of {n} is the one-card step's"] = (
            r <= ATTN_GRAD_RTOL)
    for r in ranks + on_gloo:  # keep only the times
        del r["raw"], r["synced"], r["params"]
    del synced, whole, ref_grads, attn, attn_ref
    torch.cuda.empty_cache()

    # seconds a rank thread spends in each part of the ZeRO step, summed
    # over the timed steps: the grad buckets' packing to the host, the
    # param spans' packing, the host Adam, and PendingParams.result (the
    # allgathers' waits and the copies back to the card, the warm-up's
    # last step's included, which the first timed step waits for)
    SPLIT = ("grad_pack", "param_pack", "adam", "gathers")
    parts = threading.local()

    def timed_part(fn, key):
        def timed_fn(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                acc = getattr(parts, "acc", None)
                if acc is not None:
                    acc[key] += time.perf_counter() - t0
        return timed_fn

    pack_bucket, pack_span = sh.pack_bucket, sh.pack_span
    sh.pack_bucket = timed_part(pack_bucket, "grad_pack")
    sh.pack_span = timed_part(pack_span, "param_pack")

    def zero_rank(rank, group):
        # one step by hand, held to an allreduce then the full apply
        params = tree_map(lambda p: p.requires_grad_(True), init(seeded()))
        _, grads = grads_of(params, batch_of(rank))
        zopt = ddp.ZeroOptimizer(ddp.zero_adam(1e-4), group,
                                 bucket_bytes=GANG_BUCKET_BYTES, average=True)
        new = tree_leaves(zopt.step(params, grads))
        synced = tree_leaves(ddp.sync_gradients(grads, group, average=True,
                                                bucket_bytes=GANG_BUCKET_BYTES))
        leaves = tree_leaves(params)
        oracle, shards = ddp.zero_adam(1e-4), zopt.shard_state_dict()["buckets"]
        applied = states = True
        for b, entry in enumerate(zopt.shard_map):
            indices = entry["indices"]
            pflat = sh.pack_bucket(leaves, indices)
            state = oracle.init(pflat.numel(), pflat.dtype)
            oracle.apply(pflat, sh.pack_bucket(synced, indices), state, 1)
            applied &= same_bits(torch, [sh.pack_bucket(new, indices)], [pflat])
            lo, hi = entry["bounds"][rank]
            states &= same_bits(torch, [state[k][lo:hi] for k in sorted(state)],
                                [shards[b][k] for k in sorted(state)])
        out = {"new": new, "applied": applied, "states": states,
               "state_bytes": zopt.state_bytes(),
               "replicated": zopt.replicated_state_bytes(),
               "buckets": len(zopt.shard_map)}
        del params, grads, synced, zopt, shards

        # the ZeRO regime of make_train_step, timed, with step_async's host
        # work split into its parts (SPLIT)
        adam = ddp.zero_adam(1e-4)
        adam.apply = timed_part(adam.apply, "adam")
        zopt = ddp.ZeroOptimizer(adam, group, bucket_bytes=GANG_BUCKET_BYTES,
                                 average=True)
        pendings, host_s = [], []

        class Recording:  # times each step_async, keeps its pending gathers
            @staticmethod
            def step_async(p, g):
                t0 = time.perf_counter()
                pending = zopt.step_async(p, g)
                host_s.append(time.perf_counter() - t0)
                pending.result = timed_part(pending.result, "gathers")
                pendings.append(pending)
                return pending

        state = make_zero_train_state(init, seeded())
        step = make_train_step(loss, None, host_optimizer=Recording())
        for _ in range(warmup):
            state, _ = step(state, batch_of(rank))
        torch.cuda.current_stream().synchronize()
        parts.acc = dict.fromkeys(SPLIT, 0.0)
        t0 = time.perf_counter()
        for _ in range(timed):
            state, _ = step(state, batch_of(rank))
        state = step.finalize(state)
        torch.cuda.current_stream().synchronize()
        dt = time.perf_counter() - t0
        split, parts.acc = parts.acc, None
        return {**out, "step_ms": dt / timed * 1e3,
                "wait_ms": sum(p.wait_s for p in pendings[-timed:])
                / timed * 1e3,
                "host_ms": sum(host_s[-timed:]) / timed * 1e3,
                **{f"{k}_ms": v / timed * 1e3 for k, v in split.items()}}


    fa.reset_launch_counts()
    try:
        ranks = run_ranks(torch, 2, zero_rank)
        launches["zero"] = dict(fa.LAUNCHES)
        on_gloo = run_ranks(torch, 2, zero_rank, backend="gloo")  # 8b
    finally:
        sh.pack_bucket, sh.pack_span = pack_bucket, pack_span
    times["zero"], times["zero gloo"] = ranks, on_gloo
    checks["8b: ZeRO's params after one step on gloo are the device "
           "backend's, bit for bit"] = all(
        same_bits(torch, g["new"], r["new"]) for g, r in zip(on_gloo, ranks))
    slack = ranks[0]["buckets"] * 2 * 4  # an element a bucket, 2 f32 slots
    checks.update({
        "ZeRO params are bit-identical to an allreduce then the full apply":
            all(r["applied"] for r in ranks),
        "ZeRO params are bit-identical across the ranks":
            same_bits(torch, ranks[0]["new"], ranks[1]["new"]),
        "each ZeRO shard state is its slice of the replicated state":
            all(r["states"] for r in ranks),
        "each rank holds half the replicated state":
            all(abs(2 * r["state_bytes"] - r["replicated"]) <= slack
                for r in ranks),
        "the two shard states make up the replicated state":
            ranks[0]["state_bytes"] + ranks[1]["state_bytes"]
            == ranks[0]["replicated"],
    })
    print(f"gang zero: state {ranks[0]['state_bytes'] / 1e6:.1f} / "
          f"{ranks[1]['state_bytes'] / 1e6:.1f} MB a rank against "
          f"{ranks[0]['replicated'] / 1e6:.1f} MB replicated, "
          f"{ranks[0]['buckets']} buckets", flush=True)
    expected = {"ddp": 2 * (warmup + timed) * cfg.n_layer,
                "zero": 2 * (1 + warmup + timed) * cfg.n_layer}
    for run, counts in launches.items():
        for name, n in counts.items():
            want = 0 if family(name) else expected[run]
            checks[f"{name} launched {n} times in the {run} run (expected "
                   f"{want})"] = n == want
    for what, ok in checks.items():
        print(f"gang check: {what}: {'ok' if ok else 'FAIL'}", flush=True)
    host = {"ddp": "the sync hook", "zero": "step_async"}
    for run in ("ddp", "zero"):
        for backend, key in ((COLLECTIVE_BACKEND, run), ("gloo", f"{run} gloo")):
            r0, r1 = times[key]
            print(f"gang {run} on {backend}: {card}: world 2, batch "
                  f"{GANG_BATCH} a rank, {times['buckets']} buckets of at "
                  f"most {GANG_BUCKET_BYTES >> 20} MiB: step "
                  f"{r0['step_ms']:.1f} / {r1['step_ms']:.1f} ms (rank 0 / "
                  f"1), in {host[run]} {r0['host_ms']:.1f} / "
                  f"{r1['host_ms']:.1f} ms, blocked in the bucket waits "
                  f"{r0['wait_ms']:.1f} / {r1['wait_ms']:.1f} ms a step "
                  f"({warmup} warm-up and {timed} timed steps; gloo in "
                  f"PERF.md: {GLOO_STEP_MS['gang ' + run]} ms)", flush=True)
    for backend, key in ((COLLECTIVE_BACKEND, "zero"), ("gloo", "zero gloo")):
        r0, r1 = times[key]
        print(f"gang zero on {backend}: {card}: a timed step's host work, "
              f"rank 0 / 1: "
              + ", ".join(f"{k} {r0[k + '_ms']:.1f} / {r1[k + '_ms']:.1f} ms"
                          for k in SPLIT)
              + f"; torch CPU threads {torch.get_num_threads()} a rank, "
              f"{os.cpu_count()} cores", flush=True)
    bad = [what for what, ok in checks.items() if not ok]
    if bad:
        fail(f"gang: {'; '.join(bad)}")
    return launches


class ThreadWorker:
    """A rank of a gang whose ranks are threads of this process, shaped
    like ``ray_tpu``'s ``TrainWorker`` for the Train backend: it runs
    ``run_setup`` and hands out a free loopback address."""

    def __init__(self, world_rank, world_size):
        self.world_rank, self.world_size = world_rank, world_size
        self.address = None

    def run_setup(self, setup_fn_and_args):
        fn, args, kwargs = setup_fn_and_args
        return fn(self.world_rank, self.world_size, *args, **kwargs)

    def free_coordinator_address(self):
        import socket

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            self.address = f"127.0.0.1:{sock.getsockname()[1]}"
        return self.address


class ThreadWorkerGroup:
    """The worker group the Train backend drives: ``execute`` runs one
    method on every rank at once, each on a thread of its own, and fails
    the script if a rank is still running after ``timeout``."""

    def __init__(self, world):
        self.workers = [ThreadWorker(r, world) for r in range(world)]

    def __len__(self):
        return len(self.workers)

    def execute(self, method_name, *args, timeout=None):
        results, errors = [None] * len(self), [None] * len(self)

        def body(rank):
            try:
                results[rank] = getattr(self.workers[rank], method_name)(*args)
            except BaseException as e:  # raised on the main thread below
                errors[rank] = e

        threads = [threading.Thread(target=body, args=(r,), daemon=True)
                   for r in range(len(self))]
        for t in threads:
            t.start()
        deadline = time.monotonic() + (GANG_JOIN_S if timeout is None
                                       else timeout)
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        if any(t.is_alive() for t in threads):
            fail(f"{method_name}: rank threads still running after "
                 f"{timeout} s")
        for e in errors:
            if e is not None:
                raise e
        return results

    def execute_single(self, rank, method_name, *args):
        return getattr(self.workers[rank], method_name)(*args)


def checkpoints(torch, card: str):
    """Phase 5: the gang at world 2, brought up by the Train backend over
    a loopback TCP store, takes ZeRO steps of GPT-2-small at full width
    and saves sharded checkpoints asynchronously after steps 1 and 2;
    then restores at world 2 and at world 1, and falls back past a
    corrupt generation. Every check is bit equality."""
    import shutil

    import torch.distributed as dist
    from ray_tpu_torch._private.tree import tree_leaves, tree_map
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel.train_step import (TrainState,
                                                   make_train_step,
                                                   make_zero_train_state)
    from ray_tpu_torch.train import TorchConfig, ddp
    from ray_tpu_torch.train import sharded_checkpoint as sc
    from ray_tpu_torch.util import collective as col

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), CKPT_DIR)
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(gpt2.gpt2_small(), remat=False)
    S = 1024
    tokens = torch.randint(0, cfg.vocab_size, (2 * GANG_BATCH, S + 1),
                           device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(3))

    def loss(p, b):
        return gpt2.loss_fn(p, b, cfg)

    def init(g):
        return gpt2.init(g, cfg)

    def host(params):
        return [p.detach().cpu() for p in tree_leaves(params)]

    def slot_leaves(buckets):
        return [st[k] for st in buckets for k in sorted(st)]

    group = ThreadWorkerGroup(2)
    backend = TorchConfig(group_name="ckpt_dp", rank_threads=True,
                          collective_backend=COLLECTIVE_BACKEND,
                          timeout_s=GANG_OP_TIMEOUT_S).backend_cls()

    def fresh(name):
        zopt = ddp.ZeroOptimizer(ddp.zero_adam(1e-4), name,
                                 bucket_bytes=GANG_BUCKET_BYTES, average=True)
        return zopt, make_train_step(loss, None, host_optimizer=zopt)

    def rank_run(rank, world):
        name = backend.group_name_of(rank)
        batch = {"tokens": tokens[rank * GANG_BATCH:(rank + 1) * GANG_BATCH]}
        rec = {"saves": [], "saved": {}, "checks": {}}
        with torch.cuda.stream(torch.cuda.Stream()):
            zopt, step = fresh(name)
            state = make_zero_train_state(
                init, torch.Generator(device="cuda").manual_seed(0))
            pending = None
            for i in (1, 2, 3):
                state, _ = step(state, batch)
                state = step.finalize(state)
                torch.cuda.current_stream().synchronize()
                if pending is not None:  # its write overlapped this step
                    res = pending.result(timeout=GANG_JOIN_S)
                    rec["checks"][f"the save after step {i - 1} committed"] = (
                        res["committed"])
                    rec["saves"].append({k: getattr(pending, k) for k in (
                        "snapshot_s", "write_s", "wait_s", "nbytes")})
                    pending = None
                if i < 3:
                    rec["saved"][i] = (host(state.params),
                                       zopt.shard_state_dict()["buckets"])
                    pending = sc.save_sharded(state.params, zopt, root=root,
                                              asynchronous=True)
            straight = host(state.params)

            # restore at world 2 into a fresh optimizer and other params,
            # then take step 3 again
            zopt2, step2 = fresh(name)
            template = make_zero_train_state(
                init, torch.Generator(device="cuda").manual_seed(7))
            torch.cuda.current_stream().synchronize()
            t0 = time.perf_counter()
            params, meta = sc.restore_sharded(template.params, zopt2,
                                              root=root)
            torch.cuda.current_stream().synchronize()
            rec["restore_s"] = time.perf_counter() - t0
            zopt2._ensure_plan(tree_leaves(params))  # installs the slots
            params2, slots2 = rec["saved"][2]
            rec["checks"].update({
                "the restore at world 2 found step 2, not resharded":
                    meta["step"] == 2 and not meta["resharded"],
                "params restored at world 2 are bit-identical to the saved":
                    same_bits(torch, host(params), params2),
                "slots restored at world 2 are bit-identical to the saved":
                    same_bits(torch, slot_leaves(
                        zopt2.shard_state_dict()["buckets"]),
                        slot_leaves(slots2)),
            })
            resumed = TrainState(step=2, opt_state=(), params=tree_map(
                lambda p: p.requires_grad_(True), params))
            resumed, _ = step2(resumed, batch)
            resumed = step2.finalize(resumed)
            rec["checks"]["step 3 from the restored state is the "
                          "uninterrupted step 3, bit for bit"] = same_bits(
                torch, host(resumed.params), straight)
            torch.cuda.current_stream().synchronize()
        return rec

    checks = {}
    try:
        t0 = time.perf_counter()
        backend.on_start(group, None)
        print(f"checkpoints: world 2 up through TorchBackend.on_start over "
              f"a TCP store at {group.workers[0].address} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        try:
            ranks = group.execute("run_setup", (rank_run, (), {}),
                                  timeout=GANG_JOIN_S)
        finally:
            backend.on_shutdown(group)
        checks["on_shutdown destroyed both ranks' groups"] = not any(
            col.is_group_initialized(backend.group_name_of(r))
            for r in range(2))
        for r, rec in enumerate(ranks):
            checks.update({f"rank {r}: {k}": v for k, v in rec["checks"].items()})

        # elastic: world 1 restores both ranks' state
        col.init_collective_group(1, 0, COLLECTIVE_BACKEND,
                                  group_name="ckpt_w1",
                                  store=dist.HashStore(),
                                  timeout_s=GANG_OP_TIMEOUT_S)
        try:
            zopt1, _ = fresh("ckpt_w1")
            template = make_zero_train_state(
                init, torch.Generator(device="cuda").manual_seed(7))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, meta = sc.restore_sharded(template.params, zopt1,
                                              root=root)
            torch.cuda.synchronize()
            restore1_s = time.perf_counter() - t0
            zopt1._ensure_plan(tree_leaves(params))
            slots1 = zopt1.shard_state_dict()["buckets"]
        finally:
            col.destroy_collective_group("ckpt_w1")
        (p2, s0), (_, s1) = ranks[0]["saved"][2], ranks[1]["saved"][2]
        joined = [{k: torch.cat([a[k], b[k]]) for k in a}
                  for a, b in zip(s0, s1)]
        checks.update({
            "the restore at world 1 found step 2, resharded from world 2":
                meta["step"] == 2 and meta["resharded"]
                and meta["world_saved"] == 2,
            "params restored at world 1 are bit-identical to the saved":
                same_bits(torch, host(params), p2),
            "slots restored at world 1 are the ranks' slots concatenated":
                same_bits(torch, slot_leaves(slots1), slot_leaves(joined)),
        })
        del zopt1, slots1, joined, params

        # one flipped byte in the newest generation: restore falls back
        gen2 = sc.generation_dir(root, 2)
        shard = os.path.join(gen2, sc.shard_filename(1, 2))
        with open(shard, "r+b") as f:
            f.seek(os.path.getsize(shard) // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0xFF]))
        t0 = time.perf_counter()
        params, meta = sc.restore_sharded(template.params, root=root,
                                          world=1, rank=0,
                                          bucket_bytes=GANG_BUCKET_BYTES)
        torch.cuda.synchronize()
        fallback_s = time.perf_counter() - t0
        checks.update({
            "with a byte of step 2's shard flipped, restore falls back to "
            "step 1": meta["step"] == 1,
            "the corrupt generation is renamed .quarantined":
                os.path.isdir(gen2 + sc.QUARANTINE_SUFFIX)
                and not os.path.exists(gen2),
            "params restored from step 1 are bit-identical to the saved":
                same_bits(torch, host(params), ranks[0]["saved"][1][0]),
        })
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for what, ok in checks.items():
        print(f"checkpoint check: {what}: {'ok' if ok else 'FAIL'}",
              flush=True)
    for r, rec in enumerate(ranks):
        for i, save in enumerate(rec["saves"], 1):
            print(f"checkpoints: {card}: rank {r}, save after step {i}: "
                  f"{save['nbytes'] / 1e6:.1f} MB a shard, snapshot "
                  f"{save['snapshot_s'] * 1e3:.1f} ms on the caller, "
                  f"background write {save['write_s'] * 1e3:.1f} ms, "
                  f"harvest wait {save['wait_s'] * 1e3:.1f} ms after the "
                  f"next step", flush=True)
    print(f"checkpoints: {card}: restore at world 2 "
          + " / ".join(f"{rec['restore_s'] * 1e3:.1f}" for rec in ranks)
          + f" ms (rank 0 / 1), at world 1 {restore1_s * 1e3:.1f} ms, past "
          f"the corrupt generation {fallback_s * 1e3:.1f} ms", flush=True)
    bad = [what for what, ok in checks.items() if not ok]
    if bad:
        fail(f"checkpoints: {'; '.join(bad)}")


def pipeline(torch, fa, card: str):
    """Phase 6: GPT-2-small's pipelined step on rank threads, at pp 2, at
    pp 2 x sp 2, at dp 2 x pp 2, at tp 2 and at pp 2 x tp 2 (PIPE_RUNS).
    Each run's first step (loss, global grad norm, the attention leaves'
    grads reassembled from the stages and tp blocks of replica 0) is held
    to the one-card step on the same weights and batch with reference
    attention; then its warm-up and timed steps run with the launch
    counters set to 0 just before and read just after, and each rank's
    seconds inside each collective op summed; at dp 2 the replicas' stage
    params must end bit-equal, and at tp 2 the leaves the tp ranks hold
    whole. Returns each run's counts."""
    from ray_tpu_torch import convert
    from ray_tpu_torch._private.tree import (tree_leaves, tree_map,
                                             tree_unflatten)
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import sharding
    from ray_tpu_torch.parallel import tensor_parallel
    from ray_tpu_torch.parallel import train_step as ts
    from ray_tpu_torch.parallel.mesh import MeshConfig
    from ray_tpu_torch.parallel.train_step import (default_optimizer,
                                                   global_norm,
                                                   make_pipelined_train_step,
                                                   make_train_state,
                                                   pipelined_global_norm)
    from ray_tpu_torch.train import ddp
    from ray_tpu_torch.util import collective as col

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(gpt2.gpt2_small(), remat=False)
    S = cfg.max_seq
    specs = gpt2.partition_specs(cfg)
    # the leaves every tp rank holds whole: LayerNorms, b2, wpe, ln_f
    whole_leaf = [not any("tp" in sharding.spec_axes(e) for e in spec)
                  for spec in tree_leaves(specs)]
    tokens = torch.randint(0, cfg.vocab_size, (PIPE_BATCH, S + 1),
                           device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    batch = {"tokens": tokens}
    params = gpt2.init(torch.Generator(device="cuda").manual_seed(0), cfg)

    # the yardstick: the one-card step with reference attention
    ref_cfg = dataclasses.replace(cfg, attention="reference")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    ref_loss, _ = gpt2.loss_fn(params, batch, ref_cfg)
    ref_grads = tree_unflatten(params, torch.autograd.grad(ref_loss, leaves))
    ref_loss, ref_norm = float(ref_loss.detach()), float(global_norm(ref_grads))
    ref_attn = ref_grads["blocks"]["attn"]
    del ref_grads, leaves
    params = tree_map(lambda p: p.detach(), params)
    torch.cuda.empty_cache()

    def optimizer():
        return default_optimizer(1e-4, warmup_steps=10, total_steps=1000)

    def rank_state(lay):
        stage = convert.stage_params(params, lay.pp_rank, lay.pp)
        if lay.tp > 1:
            stage = sharding.tree_shard(stage, lay, specs)
        return make_train_state(lambda g: stage, None, optimizer())

    # seconds a rank thread spends inside each collective op over the
    # timed steps (a recv's wait for its peer's compute included): the
    # stages' hops, the ring's, the loss's broadcast, the norm's and the
    # loss's scalar allreduces (the vocab-parallel cross-entropy's two
    # among them), the shared and block grads' sums over pp and sp, the
    # average over dp of the grads and metrics, the tp sums of the
    # forward's partials (embedding, attention, MLP) and the tp copies'
    # backward sums (an op called inside another counts in the outer one
    # only)
    timer = CommTimer({"send": (col, "send"), "recv": (col, "recv"),
                       "ring hops": (col, "sendrecv"),
                       "broadcast": (col, "broadcast"),
                       "allreduce": (col, "allreduce"),
                       "grad sums": (ddp, "sync_gradients"),
                       "dp sync": (ts, "sync_over_dp"),
                       "{axis} sums": (tensor_parallel, "_sum_over"),
                       "{axis} copies": (tensor_parallel,
                                         "_copy_backward")})

    launches, bad = {}, []
    for name, dp, pp, sp, tp, M, warmup, timed in PIPE_RUNS:
        config = MeshConfig(dp=dp, pp=pp, sp=sp, tp=tp)

        def first_step(lay):
            state = rank_state(lay)
            m, grads = ts.pipelined_grads(state.params, batch, cfg, lay,
                                          n_microbatches=M)
            attn = None
            if lay.sp_rank == 0 and lay.dp_rank == 0:
                attn = grads["blocks"]["attn"]
                if lay.tp > 1:
                    # every tp rank of the coordinate joins the gather
                    attn = sharding.tree_unshard(
                        attn, lay, specs["blocks"]["attn"])
                if lay.tp_rank != 0:
                    attn = None
            return (lay, float(m["loss"]),
                    float(pipelined_global_norm(grads, lay, specs)), attn)

        ranks = run_mesh(torch, config, first_step)
        losses = {r[1] for r in ranks}
        norms = {r[2] for r in ranks}
        stages = sorted((r for r in ranks if r[3] is not None),
                        key=lambda r: r[0].pp_rank)
        attn_rel = {n: float((torch.cat([r[3][n] for r in stages])
                              - ref_attn[n]).norm() / ref_attn[n].norm())
                    for n in sorted(ref_attn)}
        loss, norm = ranks[0][1], ranks[0][2]
        loss_rel = abs(loss - ref_loss) / ref_loss
        gn_rel = abs(norm - ref_norm) / ref_norm
        print(f"pipeline {name}: first step against the one-card step with "
              f"reference attention: loss {loss:.6f} / {ref_loss:.6f}, "
              f"relative {loss_rel:.2e} (limit {LOSS_RTOL:.0e}); grad norm "
              f"{norm:.6f} / {ref_norm:.6f}, {gn_rel:.2e} (limit "
              f"{GRAD_NORM_RTOL:.0e}); ||g_pipe - g_one|| / ||g_one|| of the "
              f"attention leaves "
              + ", ".join(f"{n} {r:.3e}" for n, r in attn_rel.items())
              + f" (limit {ATTN_GRAD_RTOL:.1e})", flush=True)
        if len(losses) != 1 or len(norms) != 1:
            bad.append(f"{name}: the ranks disagree on the loss or the norm: "
                       f"{sorted(losses)}, {sorted(norms)}")
        if not loss_rel <= LOSS_RTOL:
            bad.append(f"{name}: first-step loss")
        if not gn_rel <= GRAD_NORM_RTOL:
            bad.append(f"{name}: first-step grad norm")
        bad += [f"{name}: grad of {n}" for n, r in attn_rel.items()
                if not r <= ATTN_GRAD_RTOL]
        del ranks, stages
        torch.cuda.empty_cache()

        def steps(lay):
            state = rank_state(lay)
            step = make_pipelined_train_step(cfg, optimizer(), lay,
                                             n_microbatches=M)
            out = []
            for i in range(warmup + timed):
                if i == warmup:
                    torch.cuda.current_stream().synchronize()
                    timer.start(lay)
                    t0 = time.perf_counter()
                state, m = step(state, batch)
                out.append(float(m["loss"]))
            torch.cuda.current_stream().synchronize()
            dt, comm = time.perf_counter() - t0, timer.stop()
            resident = sum(t.numel() * t.element_size() for t in
                           tree_leaves(state.params)
                           + tree_leaves(state.opt_state["mu"])
                           + tree_leaves(state.opt_state["nu"]))
            return lay, out, dt / timed, resident, {
                op: v / timed for op, v in comm.items()}, (
                    tree_leaves(state.params) if dp > 1 or tp > 1
                    else None)

        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        with timer:
            ranks = run_mesh(torch, config, steps)
        launches[name] = dict(fa.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        if dp > 1:
            # the replicas of each (stage, shard, tp block) hold the same
            # params
            for lay, *_, leaves in ranks:
                twin = next(r for r in ranks if r[0].dp_rank == 0
                            and r[0].pp_rank == lay.pp_rank
                            and r[0].sp_rank == lay.sp_rank
                            and r[0].tp_rank == lay.tp_rank)
                same = same_bits(torch, leaves, twin[-1])
                print(f"pipeline {name}: rank {lay.rank}'s params after the "
                      f"timed steps {'bit-equal to' if same else 'DIFFER from'}"
                      f" replica 0's (rank {twin[0].rank})", flush=True)
                if not same:
                    bad.append(f"{name}: rank {lay.rank}'s params differ from "
                               f"replica 0's")
        if tp > 1:
            # the tp ranks of each (replica, stage, shard) hold the same
            # whole leaves
            for lay, *_, leaves in ranks:
                twin = next(r for r in ranks if r[0].tp_rank == 0
                            and r[0].dp_rank == lay.dp_rank
                            and r[0].pp_rank == lay.pp_rank
                            and r[0].sp_rank == lay.sp_rank)
                same = same_bits(
                    torch, [x for x, w in zip(leaves, whole_leaf) if w],
                    [x for x, w in zip(twin[-1], whole_leaf) if w])
                print(f"pipeline {name}: rank {lay.rank}'s whole leaves "
                      f"(LayerNorms, b2, wpe) after the timed steps "
                      f"{'bit-equal to' if same else 'DIFFER from'} tp "
                      f"rank 0's (rank {twin[0].rank})", flush=True)
                if not same:
                    bad.append(f"{name}: rank {lay.rank}'s whole leaves "
                               f"differ from tp rank 0's")
        for lay, losses, dt, resident, comm, _ in ranks:
            print(f"pipeline {name}: rank {lay.rank} (replica {lay.dp_rank}, "
                  f"stage {lay.pp_rank}, shard {lay.sp_rank}, tp block "
                  f"{lay.tp_rank}): losses "
                  f"{losses}, step "
                  f"{dt * 1e3:.1f} ms, of which in "
                  + ", ".join(f"{op} {v * 1e3:.1f}" for op, v in comm.items())
                  + f" ms (waits for peers included), the rest "
                  f"{(dt - sum(comm.values())) * 1e3:.1f} ms; its params and "
                  f"Adam moments {resident / 2**30:.2f} GiB", flush=True)
            if not all(math.isfinite(x) for x in losses):
                bad.append(f"{name}: non-finite loss on rank {lay.rank}")
        step_s = max(r[2] for r in ranks)
        print(f"pipeline {name}: {card}: GPT-2-small, batch {PIPE_BATCH} in "
              f"{M} microbatches a replica, seq {S}, dp {dp} x pp {pp} x sp "
              f"{sp} x tp {tp} rank threads on one card, {COLLECTIVE_BACKEND}"
              f" groups: step {step_s * 1e3:.1f} ms (the slowest rank; on "
              f"gloo in PERF.md {GLOO_STEP_MS['pipeline ' + name]} ms), "
              f"{PIPE_BATCH * S / step_s:.0f} tokens/s, peak memory of the "
              f"card {peak / 2**30:.2f} GiB for all {config.world_size} ranks "
              f"together (they share one allocator: a rank's own peak is "
              f"not separable) ({warmup} warm-up and {timed} timed steps)",
              flush=True)
        # each replica's stages launch each bf16 kernel once a layer and
        # microbatch on each tp rank (its heads); ring attention (sp > 1)
        # none
        per_step = dp * tp * cfg.n_layer * M if sp == 1 else 0
        for kernel, n in launches[name].items():
            want = 0 if family(kernel) else per_step * (warmup + timed)
            print(f"pipeline {name}: {kernel} launched {n} times "
                  f"(expected {want})")
            if n != want:
                bad.append(f"{name}: {kernel} launched {n} times, "
                           f"expected {want}")
        del ranks
        torch.cuda.empty_cache()
        if name in PROFILED_RUNS:
            rp = RankProfile(torch, config.world_size)

            def profiled(lay):
                state = rank_state(lay)
                step = make_pipelined_train_step(cfg, optimizer(), lay,
                                                 n_microbatches=M)
                state, _ = step(state, batch)  # warm-up
                rp.run(lay.rank, lambda: step(state, batch))

            run_mesh(torch, config, profiled)
            rp.report(f"pipeline {name} profile", step_s * 1e3)
            del rp
            torch.cuda.empty_cache()
    del params, ref_attn
    torch.cuda.empty_cache()
    if bad:
        fail(f"pipeline: {'; '.join(bad)}")
    return launches


def expert_parallel(torch, fa, card: str, runs=EP_RUNS):
    """Phases 6f-6h: GPT-2-small-MoE's step on rank threads at dp x ep x sp
    x tp (``runs``, EP_RUNS by default). Each run's first step in f32
    (loss, aux loss, global grad norm, the router's grad norm) is held to
    the one-card f32 step on the same weights and batch; then its bf16
    warm-up and timed steps run with the launch counters set to 0 just
    before and read just after, and each rank's seconds inside the
    routing counts (the slot prefix), the ep and tp sums and copies, the
    ring hops, the sp grad sums and the dp sync summed, and one more
    forward counts the pairs past capacity from the state after the
    steps; on each axis the leaves its ranks hold whole must end
    bit-equal across its groups. Returns each run's counts."""
    from ray_tpu_torch._private.tree import (tree_leaves, tree_map,
                                             tree_unflatten)
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models import layers as L
    from ray_tpu_torch.parallel import expert_parallel as ep_
    from ray_tpu_torch.parallel import sharding, tensor_parallel
    from ray_tpu_torch.parallel import train_step as ts
    from ray_tpu_torch.parallel.mesh import MeshConfig
    from ray_tpu_torch.train import ddp
    from ray_tpu_torch.util import collective as col

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(gpt2.gpt2_small(), remat=False,
                              moe=L.MoEConfig())
    f32_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    B, S = MOE_BATCH, cfg.max_seq
    C = L.moe_capacity(cfg.moe, B * S)
    specs = gpt2.partition_specs(cfg)
    axes = ("dp", "ep", "sp", "tp")
    # on each axis, the leaves its ranks hold whole: over ep all but the
    # experts, over tp all but the heads, hidden and vocab, over dp and sp
    # every leaf
    whole_leaf = {axis: [not any(axis in sharding.spec_axes(e) for e in spec)
                         for spec in tree_leaves(specs)] for axis in axes}
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(4))
    batch = {"tokens": tokens}
    # phase 3c's weights (the param dtype is f32 whatever the compute's)
    params = tree_map(lambda p: p.requires_grad_(True), gpt2.init(
        torch.Generator(device="cuda").manual_seed(0), f32_cfg))

    def router_norm(grads) -> float:
        # the gates' copy's backward sums wg's gradient over ep: without
        # it a rank's holds only its own experts' share
        return float(ts.global_norm(grads["blocks"]["moe"]["wg"]))

    # the yardstick: the one-card f32 step
    total, m = gpt2.loss_fn(params, batch, f32_cfg)
    grads = tree_unflatten(params, torch.autograd.grad(total,
                                                       tree_leaves(params)))
    want = (float(m["loss"].detach()), float(m["aux_loss"].detach()),
            float(ts.global_norm(grads)), router_norm(grads))
    del total, m, grads
    params = tree_map(lambda p: p.detach(), params)
    torch.cuda.empty_cache()

    def optimizer():
        return ts.default_optimizer(1e-4, warmup_steps=10, total_steps=1000)

    timer = CommTimer({"slot prefix": (ep_, "route_counts"),
                       "{axis} sums": (tensor_parallel, "_sum_over"),
                       "{axis} copies": (tensor_parallel,
                                         "_copy_backward"),
                       "ring hops": (col, "sendrecv"),
                       "grad sums": (ddp, "sync_gradients"),
                       "dp sync": (ts, "sync_over_dp"),
                       "allreduce": (col, "allreduce")})
    # the share of (token, k) pairs past capacity, layer by layer, counted
    # in one more forward after the timed steps
    route, drops = L._route, threading.local()

    def counting_route(probs, moe_cfg, *groups_and_tape):
        out = route(probs, moe_cfg, *groups_and_tape)
        shares = getattr(drops, "shares", None)
        if shares is not None:
            shares.append(((out[2] >= C).sum() / out[2].numel()).item())
        return out

    launches, bad = {}, []
    for name, dp, ep, sp, tp, warmup, timed in runs:
        config = MeshConfig(dp=dp, ep=ep, sp=sp, tp=tp)
        sizes = config.axis_sizes()

        def first_step(lay):
            mine = tree_map(lambda t: t.requires_grad_(True),
                            sharding.tree_shard(params, lay, specs))
            m, grads = ts.pipelined_grads(mine, batch, f32_cfg, lay,
                                          n_microbatches=1)
            return (float(m["loss"]), float(m["aux_loss"]),
                    float(ts.pipelined_global_norm(grads, lay, specs)),
                    router_norm(grads))

        got = run_mesh(torch, config, first_step)
        rel = [abs(g - w) / abs(w) for g, w in zip(got[0], want)]
        limits = (TINY_F32_LIMITS[0], TINY_F32_LIMITS[0], TINY_F32_LIMITS[1],
                  TINY_F32_LIMITS[1])
        print(f"experts {name}: f32 first step against the one-card f32 "
              f"step: loss {got[0][0]:.6f} / {want[0]:.6f}, relative "
              f"{rel[0]:.2e} (limit {limits[0]:.0e}); aux loss "
              f"{got[0][1]:.6f} / {want[1]:.6f}, {rel[1]:.2e} (limit "
              f"{limits[1]:.0e}); grad norm {got[0][2]:.6f} / {want[2]:.6f}, "
              f"{rel[2]:.2e} (limit {limits[2]:.0e}); the router's (wg, "
              f"whole on every rank) grad norm {got[0][3]:.6f} / "
              f"{want[3]:.6f}, {rel[3]:.2e} (limit {limits[3]:.0e})",
              flush=True)
        if len(set(got)) != 1:
            bad.append(f"{name}: the ranks disagree on the first step: "
                       f"{got}")
        bad += [f"{name}: f32 first-step {what}" for what, r, lim in zip(
            ("loss", "aux loss", "grad norm", "router grad norm"), rel,
            limits) if not r <= lim]
        torch.cuda.empty_cache()

        def steps(lay):
            state = ts.make_train_state(
                lambda g: sharding.tree_shard(params, lay, specs), None,
                optimizer())
            step = ts.make_pipelined_train_step(cfg, optimizer(), lay,
                                                n_microbatches=1)
            out = []
            for i in range(warmup + timed):
                if i == warmup:
                    torch.cuda.current_stream().synchronize()
                    timer.start(lay)
                    t0 = time.perf_counter()
                state, m = step(state, batch)
                out.append((float(m["loss"]), float(m["aux_loss"])))
            torch.cuda.current_stream().synchronize()
            dt, comm = time.perf_counter() - t0, timer.stop()
            resident = sum(t.numel() * t.element_size() for t in
                           tree_leaves(state.params)
                           + tree_leaves(state.opt_state["mu"])
                           + tree_leaves(state.opt_state["nu"]))
            return (lay, out, dt / timed, resident,
                    {op: v / timed for op, v in comm.items()}, state.params)

        def count_drops(lay):
            drops.shares = []
            rows = ts.dp_rows(batch, lay, 1)["tokens"]
            with torch.no_grad():
                gpt2.forward_pipelined(finals[lay.rank], rows[:, :-1], cfg,
                                       lay, n_microbatches=1)
            shares, drops.shares = drops.shares, None
            return shares

        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        with timer:
            ranks = run_mesh(torch, config, steps)
        launches[name] = dict(fa.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        finals = {r[0].rank: r[-1] for r in ranks}
        L._route = counting_route
        try:
            shares = run_mesh(torch, config, count_drops)
        finally:
            L._route = route
        del finals
        ranks = [(*r[:-1], shares[i], tree_leaves(r[-1]))
                 for i, r in enumerate(ranks)]
        for axis in (a for a in axes if sizes[a] > 1):
            # each rank against the rank of its group at coordinate 0
            whole = whole_leaf[axis]
            for lay, *_, leaves in ranks:
                twin = next(r for r in ranks if all(
                    getattr(r[0], f"{a}_rank") == (
                        0 if a == axis else getattr(lay, f"{a}_rank"))
                    for a in axes))
                same = same_bits(
                    torch, [x for x, w in zip(leaves, whole) if w],
                    [x for x, w in zip(twin[-1], whole) if w])
                print(f"experts {name}: rank {lay.rank}'s {sum(whole)} "
                      f"leaves held whole over {axis} (of {len(whole)}) "
                      f"after the timed steps "
                      f"{'bit-equal to' if same else 'DIFFER from'} {axis} "
                      f"rank 0's (rank {twin[0].rank})", flush=True)
                if not same:
                    bad.append(f"{name}: rank {lay.rank}'s leaves held "
                               f"whole over {axis} differ from {axis} rank "
                               f"0's")
        E_l = cfg.moe.n_experts // ep
        for lay, out, dt, resident, comm, shares, _ in ranks:
            print(f"experts {name}: rank {lay.rank} (replica {lay.dp_rank}, "
                  f"experts {lay.ep_rank * E_l}-{(lay.ep_rank + 1) * E_l - 1}"
                  f", shard {lay.sp_rank}, tp block {lay.tp_rank}): "
                  f"(loss, aux loss) {out}, step {dt * 1e3:.1f} ms, of which "
                  f"in " + ", ".join(f"{op} {v * 1e3:.1f}"
                                     for op, v in comm.items())
                  + f" ms (waits for peers included), the rest "
                  f"{(dt - sum(comm.values())) * 1e3:.1f} ms; its params and "
                  f"Adam moments {resident / 2**30:.2f} GiB; (token, k) pairs "
                  f"past capacity (C {C}) in its block of the batch by layer: "
                  + ", ".join(f"{x:.4f}" for x in shares), flush=True)
            if not all(math.isfinite(x) for x, _ in out):
                bad.append(f"{name}: non-finite loss on rank {lay.rank}")
            if not all(math.isfinite(a) and a > 0 for _, a in out):
                bad.append(f"{name}: an aux loss on rank {lay.rank} that is "
                           f"not finite and positive")
        step_s = max(r[2] for r in ranks)
        dropped = statistics.fmean(x for r in ranks for x in r[5])
        print(f"experts {name}: {card}: GPT-2-small-MoE "
              f"({cfg.n_params / 1e6:.1f} M params, {cfg.moe.n_experts} "
              f"experts, top-{cfg.moe.top_k}, capacity factor "
              f"{cfg.moe.capacity_factor}, C {C}), batch {B} ({B // dp} rows "
              f"a replica, {S // sp} positions a shard, one microbatch), seq "
              f"{S}, dp {dp} x ep {ep} x sp {sp} x tp {tp} rank threads on "
              f"one card, {COLLECTIVE_BACKEND} groups: step "
              f"{step_s * 1e3:.1f} ms (the slowest rank; on gloo in PERF.md "
              f"{GLOO_STEP_MS['experts ' + name]} ms), "
              f"{B * S / step_s:.0f} tokens/s, peak memory of the card "
              f"{peak / 2**30:.2f} GiB for all {config.world_size} ranks "
              f"together; (token, k) pairs past capacity {dropped:.4f} of "
              f"the batch ({warmup} warm-up and {timed} timed steps)",
              flush=True)
        # each rank launches each bf16 kernel once a layer (its heads);
        # ring attention (sp > 1) none
        per_step = config.world_size * cfg.n_layer if sp == 1 else 0
        for kernel, n in launches[name].items():
            want_n = 0 if family(kernel) else per_step * (warmup + timed)
            print(f"experts {name}: {kernel} launched {n} times (expected "
                  f"{want_n})")
            if n != want_n:
                bad.append(f"{name}: {kernel} launched {n} times, expected "
                           f"{want_n}")
        del ranks
        torch.cuda.empty_cache()
        if name in PROFILED_RUNS:
            rp = RankProfile(torch, config.world_size)

            def profiled(lay):
                state = ts.make_train_state(
                    lambda g: sharding.tree_shard(params, lay, specs), None,
                    optimizer())
                step = ts.make_pipelined_train_step(cfg, optimizer(), lay,
                                                    n_microbatches=1)
                state, _ = step(state, batch)  # warm-up
                rp.run(lay.rank, lambda: step(state, batch))

            run_mesh(torch, config, profiled)
            rp.report(f"experts {name} profile", step_s * 1e3)
            del rp
            torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    if bad:
        fail(f"experts: {'; '.join(bad)}")
    return launches


def mesh_entry(torch, fa, card: str, runs=MESH_RUNS):
    """Phase 7: the mesh entry point (``runs``, MESH_RUNS by default) on
    four rank threads
    sharing the card, remat on. Each run's f32 first step (loss, aux
    loss, grad norm) is held to the one-card f32 step on the same weights
    and batch; then its bf16 warm-up and timed steps run with the launch
    counters set to 0 just before and read just after; on each axis the
    leaves its ranks hold whole must end bit-equal across its groups. 7a
    also takes one bf16 step with remat off for its peak memory. Returns
    each run's counts."""
    from ray_tpu_torch._private.tree import (tree_leaves, tree_map,
                                             tree_unflatten)
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models import layers as L
    from ray_tpu_torch.parallel import sharding
    from ray_tpu_torch.parallel import train_step as ts
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    def optimizer():
        return ts.default_optimizer(1e-4, warmup_steps=10, total_steps=1000)

    devices = [torch.device("cuda", 0)] * MESH_DEVICES
    axes = ("dp", "pp", "ep", "sp", "tp")
    launches, bad = {}, []
    for (name, sizes, moe, pipelined, M, batch_spec, B, warmup,
         timed) in runs:
        torch.cuda.empty_cache()
        cfg = gpt2.gpt2_small()
        if moe:
            cfg = dataclasses.replace(cfg, moe=L.MoEConfig(),
                                      attention="ring")
        f32_cfg = dataclasses.replace(cfg, dtype=torch.float32)
        S = cfg.max_seq
        mesh = create_mesh(MeshConfig(**sizes), devices=devices)
        shape = dict(mesh.shape)
        specs = gpt2.partition_specs(cfg)
        # on each axis, the leaves its ranks hold whole: over pp those
        # outside the stage's blocks, over ep and tp those no spec cuts
        # over it, over dp and sp every leaf
        whole_leaf = {axis: tree_leaves({
            k: tree_map(lambda spec, k=k: (
                k != "blocks" if axis == "pp" else
                not any(axis in sharding.spec_axes(e) for e in spec)), v)
            for k, v in specs.items()}) for axis in axes}
        seed = 4 if moe else 1
        tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), device="cuda",
                               generator=torch.Generator(
                                   device="cuda").manual_seed(seed))
        batch = {"tokens": tokens}
        params = tree_map(lambda p: p.requires_grad_(True), gpt2.init(
            torch.Generator(device="cuda").manual_seed(0), f32_cfg))

        # the yardstick: the one-card f32 step
        total, m = gpt2.loss_fn(params, batch, f32_cfg)
        grads = tree_unflatten(params, torch.autograd.grad(
            total, tree_leaves(params)))
        want = (float(m["loss"].detach()), float(m["aux_loss"].detach()),
                float(ts.global_norm(grads)))
        del total, m, grads
        params = tree_map(lambda p: p.detach(), params)
        torch.cuda.empty_cache()

        def entry_step(lay, run_cfg):
            state = ts.make_train_state(lambda g: params, None, optimizer(),
                                        lay, specs)
            step = ts.make_train_step(
                lambda p, b: gpt2.loss_fn(p, b, run_cfg, lay,
                                          pipelined=pipelined,
                                          n_microbatches=M),
                optimizer(), lay, batch_spec=batch_spec)
            return state, step

        def first_step(lay):
            state, step = entry_step(lay, f32_cfg)
            _, m = step(state, batch)
            return (float(m["loss"]), float(m["aux_loss"]),
                    float(m["grad_norm"]))

        got = run_entry(torch, mesh, first_step)
        rel = [abs(g - w) / abs(w) if w else abs(g)
               for g, w in zip(got[0], want)]
        limits = (TINY_F32_LIMITS[0], TINY_F32_LIMITS[0], TINY_F32_LIMITS[1])
        print(f"entry {name}: f32 first step through make_train_step on "
              f"the rank layouts against the one-card f32 step: loss "
              f"{got[0][0]:.6f} / {want[0]:.6f}, relative {rel[0]:.2e} "
              f"(limit {limits[0]:.0e}); aux loss {got[0][1]:.6f} / "
              f"{want[1]:.6f}, {rel[1]:.2e} (limit {limits[1]:.0e}); grad "
              f"norm {got[0][2]:.6f} / {want[2]:.6f}, {rel[2]:.2e} (limit "
              f"{limits[2]:.0e})", flush=True)
        if len(set(got)) != 1:
            bad.append(f"{name}: the ranks disagree on the first step: "
                       f"{got}")
        bad += [f"{name}: f32 first-step {what}" for what, r, lim in zip(
            ("loss", "aux loss", "grad norm"), rel, limits) if not r <= lim]
        torch.cuda.empty_cache()

        def steps(lay):
            state, step = entry_step(lay, cfg)
            out = []
            for i in range(warmup + timed):
                if i == warmup:
                    torch.cuda.current_stream().synchronize()
                    t0 = time.perf_counter()
                state, m = step(state, batch)
                out.append((float(m["loss"]), float(m["aux_loss"])))
            torch.cuda.current_stream().synchronize()
            dt = time.perf_counter() - t0
            resident = sum(t.numel() * t.element_size() for t in
                           tree_leaves(state.params)
                           + tree_leaves(state.opt_state["mu"])
                           + tree_leaves(state.opt_state["nu"]))
            return lay, out, dt / timed, resident, tree_leaves(state.params)

        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        ranks = run_entry(torch, mesh, steps)
        launches[name] = dict(fa.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        for axis in (a for a in axes if shape[a] > 1):
            whole = whole_leaf[axis]
            for lay, *_, leaves in ranks:
                twin = next(r for r in ranks if all(
                    getattr(r[0], f"{a}_rank") == (
                        0 if a == axis else getattr(lay, f"{a}_rank"))
                    for a in axes))
                same = same_bits(
                    torch, [x for x, w in zip(leaves, whole) if w],
                    [x for x, w in zip(twin[-1], whole) if w])
                print(f"entry {name}: rank {lay.rank}'s {sum(whole)} leaves "
                      f"held whole over {axis} (of {len(whole)}) after the "
                      f"timed steps {'bit-equal to' if same else 'DIFFER from'}"
                      f" {axis} rank 0's (rank {twin[0].rank})", flush=True)
                if not same:
                    bad.append(f"{name}: rank {lay.rank}'s leaves held whole "
                               f"over {axis} differ from {axis} rank 0's")
        for lay, out, dt, resident, _ in ranks:
            print(f"entry {name}: rank {lay.rank} (dp {lay.dp_rank}, pp "
                  f"{lay.pp_rank}, ep {lay.ep_rank}, sp {lay.sp_rank}, tp "
                  f"{lay.tp_rank}) on {lay.device}: (loss, aux loss) {out}, "
                  f"step {dt * 1e3:.1f} ms; its params and Adam moments "
                  f"{resident / 2**30:.2f} GiB", flush=True)
            if not all(math.isfinite(x) for x, _ in out):
                bad.append(f"{name}: non-finite loss on rank {lay.rank}")
            if moe and not all(math.isfinite(a) and a > 0 for _, a in out):
                bad.append(f"{name}: an aux loss on rank {lay.rank} that is "
                           f"not finite and positive")
        step_s = max(r[2] for r in ranks)
        del ranks
        off_peak = None
        if name == "dp2tp2":
            # one bf16 step with remat off, for its peak
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launch_counts()

            def one_step(lay):
                state, step = entry_step(
                    lay, dataclasses.replace(cfg, remat=False))
                step(state, batch)

            run_entry(torch, mesh, one_step)
            off_peak = torch.cuda.max_memory_allocated()
            launches[name + " remat off"] = dict(fa.LAUNCHES)
        model = "GPT-2-small-MoE" if moe else "GPT-2-small"
        print(f"entry {name}: {card}: {model}"
              f" ({cfg.n_params / 1e6:.1f} M params, remat on, attention "
              f"{cfg.attention}), batch {B} (global, batch_spec "
              f"{batch_spec}), seq {S}, "
              + " x ".join(f"{a} {n}" for a, n in shape.items() if n > 1)
              + f" rank threads on one card from create_mesh, "
              f"{COLLECTIVE_BACKEND} groups, "
              f"{M} microbatch{'es' if M > 1 else ''} a replica: step "
              f"{step_s * 1e3:.1f} ms (the slowest rank; on gloo in PERF.md "
              f"{GLOO_STEP_MS['entry ' + name]} ms), "
              f"{B * S / step_s:.0f} tokens/s, peak memory of the card "
              f"{peak / 2**30:.2f} GiB for all {mesh.size} ranks together"
              + (f"; one step with remat off peaks at "
                 f"{off_peak / 2**30:.2f} GiB" if off_peak else "")
              + f" ({warmup} warm-up and {timed} timed steps)", flush=True)
        # each rank launches each bf16 kernel once a layer and microbatch
        # of its stage (its heads), the forward twice with remat (the
        # layer's recompute); the ring (sp > 1) none
        per_step = mesh.size * (cfg.n_layer // shape["pp"]) * M * (
            shape["sp"] == 1)
        for run, n_steps, forwards in (
                (name, warmup + timed, 2), (name + " remat off", 1, 1)):
            for kernel, n in launches.get(run, {}).items():
                want_n = 0 if family(kernel) else per_step * n_steps * (
                    forwards if kernel == "flash_fwd" else 1)
                print(f"entry {run}: {kernel} launched {n} times (expected "
                      f"{want_n})")
                if n != want_n:
                    bad.append(f"{run}: {kernel} launched {n} times, "
                               f"expected {want_n}")
        del params, tokens, batch
        torch.cuda.empty_cache()
    if bad:
        fail(f"entry: {'; '.join(bad)}")
    return launches


def _rank_order(torch, xs, op: str):
    """r0 op r1 op ... on the host, in the inputs' dtype, one rounding a
    step (bf16 through f32, where the exact f32 result rounds once)."""
    fn = {"sum": torch.add, "product": torch.mul, "min": torch.minimum,
          "max": torch.maximum}[op]
    host = [x.cpu() for x in xs]
    wide = host[0].dtype == torch.bfloat16
    out = host[0].float() if wide else host[0].clone()
    for x in host[1:]:
        out = fn(out, x.float() if wide else x)
        if wide:
            out = out.to(torch.bfloat16).float()
    return out.to(host[0].dtype)


def profile_collectives(torch) -> list:
    """The names of the device events of a profile of a 16 MiB f32
    allreduce and sendrecv on a device group of two rank threads."""
    from ray_tpu_torch.util import collective as col

    xs = [torch.randn(1 << 22, device="cuda") for _ in range(2)]
    torch.cuda.synchronize()
    rp = RankProfile(torch, 2)
    run_ranks(torch, 2, lambda r, g: rp.run(r, lambda: (
        col.allreduce(xs[r], g), col.sendrecv(xs[r], 1 - r, 1 - r, g))))
    return rp.device_names()


def collectives(torch, card: str):
    """Phase 8, the collective backends on the card: (a) every op of a
    device group at DEVICE_WORLDS rank threads on CUDA tensors, held to
    the host's rank-order reduction, with a profile that must show no
    copy between host and card; (c) an NCCL group at world 1, and two NCCL
    ranks on one card refused; (d) a rank that raises poisons its peers.
    (b), the gang on gloo and on the device, runs inside phase 4."""
    import torch.distributed as dist

    from ray_tpu_torch.exceptions import CollectiveGroupError
    from ray_tpu_torch.util import collective as col

    torch.cuda.empty_cache()
    bad = []
    dtypes = (torch.float32, torch.bfloat16, torch.int64)
    ops = ("sum", "product", "min", "max")
    # (a) every op, dtype and reduction at each world
    for world in DEVICE_WORLDS:
        gen = torch.Generator(device="cuda").manual_seed(world)
        xs = {dt: [torch.randint(-9, 10, DEVICE_OP_SHAPE, device="cuda",
                                 generator=gen) if dt == torch.int64 else
                   (torch.rand(DEVICE_OP_SHAPE, device="cuda", generator=gen)
                    + 0.5).to(dt) for _ in range(world)] for dt in dtypes}
        torch.cuda.synchronize()

        def rank(r, group, world=world, xs=xs):
            out = {}
            for dt in dtypes:
                for op in ops:
                    out[dt, op] = col.allreduce(xs[dt][r], group, op)
                    out[dt, op, "rs"] = col.reducescatter(xs[dt][r], group,
                                                          op)
                out[dt, "bcast"] = [col.broadcast(xs[dt][r].clone(), s, group)
                                    for s in range(world)]
                out[dt, "ring"] = col.sendrecv(xs[dt][r], (r + 1) % world,
                                               (r - 1) % world, group)
                out[dt, "gather"] = col.allgather(xs[dt][r], group)
            return out

        t0 = time.perf_counter()
        outs = run_ranks(torch, world, rank)
        dt_s = time.perf_counter() - t0
        exact, within, worst = True, True, 0.0
        for r, out in enumerate(outs):
            flat = [t for v in out.values()
                    for t in (v if isinstance(v, list) else [v])]
            if not all(t.is_cuda for t in flat):
                bad.append(f"world {world}: a result is not on the card")
            for dt in dtypes:
                for op in ops:
                    want = _rank_order(torch, xs[dt], op)
                    for got, ref in ((out[dt, op].cpu(), want),
                                     (out[dt, op, "rs"].cpu(),
                                      torch.tensor_split(want, world)[r])):
                        if torch.equal(got, ref):
                            continue
                        exact = False
                        if dt == torch.int64 or world == 2 or op in ("min",
                                                                     "max"):
                            bad.append(f"world {world}: {dt} {op} differs "
                                       f"from the rank-order reduction")
                            continue
                        u = 2.0 ** -24 if dt == torch.float32 else 2.0 ** -8
                        mags = torch.stack([x.cpu().float().abs()
                                            for x in xs[dt]])
                        size = (mags.sum(0) if op == "sum"
                                else mags.prod(0))
                        if got.shape != ref.shape:
                            size = torch.tensor_split(size, world)[r]
                        err = (got.float() - ref.float()).abs()
                        worst = max(worst, float((err / size).max()))
                        within &= bool((err <= REASSOC_ULPS * u * size).all())
                same = [torch.equal(b, x) for b, x in zip(out[dt, "bcast"],
                                                          xs[dt])]
                same += [torch.equal(out[dt, "ring"], xs[dt][(r - 1) % world])]
                same += [torch.equal(g, x) for g, x in zip(out[dt, "gather"],
                                                           xs[dt])]
                if not all(same):
                    bad.append(f"world {world}: {dt} broadcast, ring or "
                               f"allgather moved other bits")
        if not within:
            bad.append(f"world {world}: a float result past "
                       f"{REASSOC_ULPS} roundings of the rank-order "
                       f"reduction")
        print(f"collectives (a): {card}: device group at world {world}, "
              f"{DEVICE_OP_SHAPE} in f32, bf16 and int64, sum, product, min "
              f"and max, uneven reducescatter, broadcast from every rank, a "
              f"sendrecv ring, allgather: every result on the card, "
              f"{'bit-equal to' if exact else 'within reassociation of'} "
              f"the host's rank-order reduction (worst relative error "
              f"{worst:.2e}), {dt_s:.2f} s", flush=True)
        del xs, outs

    # (a) a profile of a CUDA-input allreduce and sendrecv: no memcpy
    # between host and card
    child = subprocess.run([sys.executable, os.path.abspath(__file__),
                            PROFILE_COLLECTIVES], capture_output=True,
                           text=True, timeout=GANG_JOIN_S)
    try:
        device_events = json.loads(
            child.stdout.strip().splitlines()[-1])["device_events"]
    except (IndexError, ValueError, KeyError):
        print(child.stdout[-2000:] + child.stderr[-4000:], flush=True)
        device_events = []
    host_copies = sorted({n for n in device_events if "Memcpy" in n
                          and ("HtoD" in n or "DtoH" in n)})
    print(f"collectives (a): profile of a 16 MiB f32 allreduce and "
          f"sendrecv at world 2: {len(device_events)} device events ("
          + ", ".join(sorted(set(device_events)))[:400]
          + f"); host<->card copies: {host_copies or 'none'}", flush=True)
    if not any("add" in n for n in device_events):
        bad.append("the profile holds no allreduce kernel: it cannot show "
                   "the copies")
    if host_copies:
        bad.append(f"a CUDA-input allreduce or sendrecv copied between "
                   f"host and card: {host_copies}")

    # (c) NCCL at world 1, and two NCCL ranks on one card refused
    if not dist.is_nccl_available():
        try:
            col.init_collective_group(1, 0, "nccl", "nccl_w1",
                                      store=dist.HashStore(), timeout_s=10)
            bad.append("nccl: a group joined without NCCL in torch")
        except RuntimeError as e:
            print(f"collectives (c): torch {torch.__version__} has no NCCL; "
                  f"backend 'nccl' refuses: {e}", flush=True)
    else:
        cuda0 = torch.device("cuda", 0)
        col.init_collective_group(1, 0, "nccl", "nccl_w1",
                                  store=dist.HashStore(),
                                  timeout_s=GANG_OP_TIMEOUT_S, device=cuda0)
        try:
            x = torch.arange(14.0, device="cuda").reshape(7, 2)
            got = {op: col.allreduce(x.clone(), "nccl_w1", op) for op in ops}
            got["reducescatter"] = col.reducescatter(x.clone(), "nccl_w1")
            got["allgather"] = col.allgather(x, "nccl_w1")[0]
            got["broadcast"] = col.broadcast(x.clone(), 0, "nccl_w1")
            got["sendrecv"] = col.sendrecv(x, 0, 0, "nccl_w1")
            col.send_device(x, 0, "nccl_w1")
            got["recv_device"] = col.recv_device((7, 2), x.dtype, 0,
                                                 "nccl_w1")
            col.barrier("nccl_w1")
            objs = col.allgather_object({"rank": 0}, "nccl_w1")
            torch.cuda.synchronize()
            wrong = [k for k, v in got.items()
                     if not (v.is_cuda and torch.equal(v, x))]
            if wrong or objs != [{"rank": 0}]:
                bad.append(f"nccl at world 1: {wrong or 'allgather_object'}"
                           f" wrong or off the card")
            print(f"collectives (c): NCCL {torch.cuda.nccl.version()} at "
                  f"world 1: allreduce (sum, product, min, max), "
                  f"reducescatter, allgather, broadcast, sendrecv, "
                  f"send_device / recv_device, barrier, allgather_object: "
                  f"{'ok' if not wrong else 'FAIL ' + str(wrong)}, every "
                  f"result on the card", flush=True)
        finally:
            col.destroy_collective_group("nccl_w1")
        store, errors, took = dist.HashStore(), [None, None], [None, None]

        def join_twice(r):
            t0 = time.monotonic()
            try:
                col.init_collective_group(2, r, "nccl", f"nccl_two_r{r}",
                                          store=store, timeout_s=30,
                                          device=cuda0)
                col.destroy_collective_group(f"nccl_two_r{r}")
            except BaseException as e:  # the refusal is the point
                errors[r] = e
            took[r] = time.monotonic() - t0

        threads = [threading.Thread(target=join_twice, args=(r,),
                                    daemon=True) for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        refused = all(isinstance(e, ValueError) and "one device" in str(e)
                      for e in errors)
        print(f"collectives (c): two NCCL ranks on {cuda0}: "
              f"{'refused' if refused else 'NOT refused'} in "
              + " / ".join(f"{t:.2f}" if t is not None else "-"
                           for t in took)
              + f" s: {errors[0]}", flush=True)
        if not refused or any(t is None or t > 30 for t in took):
            bad.append("two NCCL ranks on one card were not refused within "
                       "seconds")

    # (d) a rank that raises mid-allreduce poisons its peers
    outcome = {}

    def poisoned(r, group):
        x = torch.ones(1 << 20, device="cuda")
        if r == 1:
            time.sleep(0.2)
            raise RuntimeError("rank 1 raised mid-allreduce")
        t0 = time.monotonic()
        try:
            col.allreduce(x, group)
        except CollectiveGroupError as e:
            outcome[r] = (time.monotonic() - t0, e.dead_ranks, str(e))
        return None

    try:
        run_ranks(torch, 3, poisoned)
        bad.append("poison: the raising rank's error was lost")
    except RuntimeError as e:
        if "mid-allreduce" not in str(e):
            raise
    for r in (0, 2):
        waited, dead, msg = outcome.get(r, (None, None, "no error"))
        print(f"collectives (d): rank {r} of 3 (group timeout "
              f"{GANG_OP_TIMEOUT_S:.0f} s): "
              + (f"CollectiveGroupError after {waited:.3f} s: {msg}"
                 if waited is not None else "no CollectiveGroupError"),
              flush=True)
        if waited is None or dead != (1,) or waited > POISON_S:
            bad.append(f"poison: rank {r} did not raise CollectiveGroupError"
                       f" naming rank 1 within {POISON_S} s")
    if bad:
        fail(f"collectives: {'; '.join(bad)}")


def probe_gpus() -> dict:
    """Phase 9a's child process: the probe's records, and whether this
    process initialized CUDA (it must not have)."""
    import torch

    from ray_tpu_torch._private import gpu_probe

    return {"chips": gpu_probe.probe_chips(),
            "devices": gpu_probe.probe_devices(),
            "resources": gpu_probe.detect_resources(),
            "topology": gpu_probe.detect_gpu_topology(),
            "cuda_initialized": torch.cuda.is_initialized()}


def _child(flag: str, env=None) -> dict:
    """The last line of ``python chip_smoke.py <flag>``, as JSON; the
    child's output is printed when it has none."""
    child = subprocess.run([sys.executable, os.path.abspath(__file__), flag],
                           capture_output=True, text=True, timeout=GANG_JOIN_S,
                           env={**os.environ, **(env or {})})
    try:
        return json.loads(child.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        print(child.stdout[-2000:] + child.stderr[-4000:], flush=True)
        fail(f"the child process {flag} printed no result "
             f"(exit {child.returncode})")


def check_probe(torch, card: str) -> None:
    """Phase 9a: the probe in a child process (no CUDA context there),
    against what torch reads here; the in-process gauges after phase 8."""
    from ray_tpu_torch._private import gpu_probe
    from ray_tpu_torch._private import telemetry as tm

    got = _child(PROBE_GPUS, {"RAY_TPU_TORCH_DETECT_GPUS": "1"})
    chips, devices = got["chips"] or {}, got["devices"] or []
    print(f"serve probe: {card}: probe_chips {json.dumps(chips)}", flush=True)
    for d in devices:
        print(f"serve probe: {card}: device {json.dumps(d)}", flush=True)
    print(f"serve probe: detect_resources {json.dumps(got['resources'])}; "
          f"detect_gpu_topology {json.dumps(got['topology'])}; CUDA "
          f"initialized in the probing process: {got['cuda_initialized']}",
          flush=True)
    bad = []
    if got["cuda_initialized"]:
        bad.append("the probe initialized CUDA in its process")
    if chips.get("chips") != torch.cuda.device_count() \
            or len(devices) != torch.cuda.device_count():
        bad.append(f"probe counts {chips.get('chips')} / {len(devices)} "
                   f"cards, torch {torch.cuda.device_count()}")
    for d in devices:
        total = torch.cuda.mem_get_info(d["id"])[1]
        # nvidia-smi reports whole MiB
        if abs(d["memory_bytes_limit"] - total) >= 1 << 20:
            bad.append(f"device {d['id']}: memory_bytes_limit "
                       f"{d['memory_bytes_limit']} against torch's {total}")
        print(f"serve probe: device {d['id']}: memory_bytes_limit "
              f"{d['memory_bytes_limit']}, torch.cuda.mem_get_info total "
              f"{total}", flush=True)
    if got["resources"].get("GPU") != 1.0:
        bad.append(f"detect_resources GPU {got['resources'].get('GPU')}")
    n = gpu_probe.publish_local_device_gauges()
    rows = tm.snapshot().get("ray_tpu_torch_device_memory_bytes", [])
    stats = {r["tags"]["stat"]: r["value"] for r in rows
             if r["tags"]["device"] == "0"}
    print(f"serve probe: {card}: publish_local_device_gauges here: {n} "
          f"device(s), device 0 {stats}", flush=True)
    if set(stats) != {"in_use", "limit"}:
        bad.append(f"local gauges published {sorted(stats)}")
    if bad:
        fail(f"probe: {'; '.join(bad)}")


def serve_model(torch):
    """GPT-2-small as ``gpt2_small()`` ships it (bf16 compute, remat on),
    and phase 3's weights (seed 0)."""
    from ray_tpu_torch.models import gpt2

    cfg = gpt2.gpt2_small()
    params = gpt2.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    return cfg, params


def check_checkpoint(torch, params, card: str):
    """Phase 9b: the weights through Checkpoint.from_torch / to_torch,
    every leaf back bit for bit. Returns the checkpoint."""
    from ray_tpu_torch._private.tree import tree_leaves
    from ray_tpu_torch.air.checkpoint import TORCH_STATE, Checkpoint

    path = os.path.join(SERVE_DIR, "ckpt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt = Checkpoint.from_torch({"params": params}, path=path)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = ckpt.to_torch("cuda")
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(path, TORCH_STATE, f))
                 for f in os.listdir(os.path.join(path, TORCH_STATE)))
    a, b = tree_leaves(params), tree_leaves(back["params"])
    same = len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and y.device.type == "cuda"
        and torch.equal(x.view(torch.int32), y.view(torch.int32))
        for x, y in zip(a, b))
    print(f"serve checkpoint: {card}: from_torch of {len(a)} leaves, "
          f"{nbytes} bytes, write {write_s * 1e3:.1f} ms, to_torch('cuda') "
          f"{read_s * 1e3:.1f} ms (the file read warm), every leaf "
          f"{'bit-equal' if same else 'NOT bit-equal'}", flush=True)
    if not same:
        fail("checkpoint: a leaf came back with other bits")
    return ckpt


def serve(torch, fa, cfg, ckpt, card: str):
    """Phase 9c: TorchPredictor behind @batch, SERVE_CLIENTS client threads
    sending SERVE_REQUESTS requests; every answer held to the request run
    alone through reference attention. Returns the launch counts of the
    traffic's batch calls."""
    import numpy as np

    from ray_tpu_torch._private import telemetry as tm
    from ray_tpu_torch.data import iter_device_batches
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve import batch
    from ray_tpu_torch.serve.batching import default_bucket_sizes
    from ray_tpu_torch.train.predictor import TorchPredictor

    def last_token(p, tokens):
        logits = gpt2.next_token_logits(p, tokens, cfg)
        return logits, logits.argmax(-1)

    class Model:
        def __init__(self):
            self.predictor = TorchPredictor.from_checkpoint(
                ckpt, apply_fn=last_token)
            self.calls = []  # padded batch sizes, one a batch call
            # one device-batch stream for every batch call: the batcher
            # runs one call at a time, each putting its stacked requests
            # and taking them back on the card
            self.host = queue.Queue()
            self.device = iter_device_batches(self.stacked())

        def stacked(self):
            while (requests := self.host.get()) is not None:
                yield requests

        @batch(max_batch_size=SERVE_MAX_BATCH, batch_wait_timeout_s=SERVE_WAIT_S)
        def predict(self, requests: list):
            self.host.put(np.stack(requests))
            logits, top = self.predictor.predict(next(self.device))
            self.calls.append(len(requests))
            return list(zip(logits, top))

    model = Model()
    fn = "predict"
    batcher = model.predict._serve_batcher
    buckets = default_bucket_sizes(SERVE_MAX_BATCH)
    requests = np.random.default_rng(SERVE_SEED).integers(
        0, cfg.vocab_size, (SERVE_REQUESTS, cfg.max_seq), dtype=np.int64)

    def misses():
        return sum(r["value"] for r in tm.snapshot().get(
            "ray_tpu_torch_serve_batch_signature_total", [])
            if r["tags"] == {"fn": fn, "result": "miss"})

    # warm-up: one batch call of each bucket, through the batcher's
    # classified call as its loop makes it
    for b in buckets:
        batcher._fn(list(requests[:b]))
    warm_misses = misses()
    first = {r["tags"]["fn"]: r for r in tm.snapshot().get(
        "ray_tpu_torch_serve_batch_first_call_seconds", [])}.get(fn)
    model.calls.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    answers, latency = [None] * SERVE_REQUESTS, [None] * SERVE_REQUESTS
    start = threading.Barrier(SERVE_CLIENTS)

    def client(c):
        start.wait()
        for i in range(c, SERVE_REQUESTS, SERVE_CLIENTS):
            time.sleep(c * SERVE_STAGGER_S)
            t0 = time.perf_counter()
            answers[i] = model.predict(requests[i])
            latency[i] = time.perf_counter() - t0

    fa.reset_launch_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(GANG_JOIN_S)
    wall = time.perf_counter() - t0
    model.host.put(None)
    model.device.close()
    launches = dict(fa.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if any(t.is_alive() for t in threads) or any(a is None for a in answers):
        fail("serve: a client got no answer")
    calls = list(model.calls)
    bad = []
    for name, n in launches.items():
        expected = cfg.n_layer * len(calls) if name == "flash_fwd" else 0
        print(f"serve: {name} launched {n} times (expected {expected})")
        if n != expected:
            bad.append(f"{name} launched {n} times, expected {expected}")
    pads = sum(calls) - SERVE_REQUESTS
    if pads <= 0:
        bad.append(f"no batch call was padded ({calls}): the traffic never "
                   f"ran the pad slots")
    if misses() != warm_misses or warm_misses != len(buckets):
        bad.append(f"signature misses {misses()} after the traffic, "
                   f"{warm_misses} after warm-up of {len(buckets)} buckets")

    # each request alone through the plain path: reference attention
    ref_cfg = dataclasses.replace(cfg, attention="reference")
    worst_el, worst_norm, checked, flips = 0.0, 0.0, 0, 0
    with torch.inference_mode():
        for i, (logits, top) in enumerate(answers):
            ref = gpt2.next_token_logits(
                model.predictor.params,
                torch.from_numpy(requests[i:i + 1]).cuda(), ref_cfg)[0]
            got = torch.from_numpy(logits).cuda()
            rms = ref.pow(2).mean().sqrt()
            err = (got - ref).abs()
            worst_el = max(worst_el, float(err.max() / rms))
            worst_norm = max(worst_norm,
                             float((got - ref).norm() / ref.norm()))
            top2 = ref.topk(2).values
            if float(top2[0] - top2[1]) > 2 * LOGITS_ATOL_RMS * float(rms):
                checked += 1
                flips += int(int(top) != int(ref.argmax()))
    print(f"serve: {card}: {SERVE_REQUESTS} answers against each request "
          f"alone with reference attention: worst |l - r| / rms(r) "
          f"{worst_el:.3e} (limit {LOGITS_ATOL_RMS:.3e}), worst "
          f"||l - r|| / ||r|| {worst_norm:.3e} (limit {LOGITS_RTOL:.3e}); "
          f"greedy token checked on {checked} with a margin past twice the "
          f"bound, {flips} differ", flush=True)
    if worst_el > LOGITS_ATOL_RMS or worst_norm > LOGITS_RTOL:
        bad.append("an answer's logits are outside the forward limits")
    if flips:
        bad.append(f"{flips} greedy tokens differ where the margin is clear")

    lat = sorted(latency)
    by_bucket = {b: calls.count(b) for b in buckets if calls.count(b)}
    print(f"serve: {card}: GPT-2-small (12 layers, d 768, 12 heads of 64, "
          f"vocab {cfg.vocab_size}, S {cfg.max_seq}, bf16) behind @batch "
          f"(max {SERVE_MAX_BATCH}, buckets {list(buckets)}, wait "
          f"{SERVE_WAIT_S * 1e3:.0f} ms), {SERVE_CLIENTS} clients, "
          f"{SERVE_REQUESTS} requests in {wall:.3f} s: "
          f"{SERVE_REQUESTS / wall:.1f} requests/s, "
          f"{SERVE_REQUESTS * cfg.max_seq / wall:.0f} tokens/s, latency p50 "
          f"{float(np.percentile(lat, 50)) * 1e3:.1f} ms p99 "
          f"{float(np.percentile(lat, 99)) * 1e3:.1f} ms; {len(calls)} batch "
          f"calls by bucket {by_bucket}; pad waste {pads} of {sum(calls)} "
          f"slots; peak memory {peak_gib:.2f} GiB; signature misses "
          f"{warm_misses:.0f} (warm-up), {misses():.0f} (after); first "
          f"calls {first['sum'] if first else 0:.3f} s in all, longest "
          f"{first['max'] if first else 0:.3f} s", flush=True)
    if bad:
        fail(f"serve: {'; '.join(bad)}")
    return launches


def device_batch_source(cfg):
    """Phase 9d's host batches: token ids and an f32 block, from a seed."""
    import numpy as np

    rng = np.random.default_rng(SERVE_SEED + 1)
    shape = (DEVICE_BATCH_ROWS, cfg.max_seq)
    return [{"tokens": rng.integers(0, cfg.vocab_size, shape),
             "block": rng.random(shape + (DEVICE_BATCH_COLS,),
                                 dtype=np.float32)}
            for _ in range(DEVICE_BATCHES)]


def device_batches(torch, cfg, params, card: str) -> None:
    """Phase 9d: DEVICE_BATCHES batches through iter_device_batches under a
    consumer running the forward; each batch as the consumer's stream saw
    it, after its forward (a copy taken on that stream), equal to its host
    source bit for bit, checked two batches later; and the copies in a
    child process's profile pinned and on another stream than the
    forward's."""
    from ray_tpu_torch.data import iter_device_batches
    from ray_tpu_torch.models import gpt2

    host = device_batch_source(cfg)
    seen, bad = [], []

    def check(k):
        for key, t in seen[k].items():
            if not torch.equal(t.cpu(), torch.from_numpy(host[k][key])):
                bad.append(f"batch {k} {key}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for k, b in enumerate(iter_device_batches(host)):
            gpt2.next_token_logits(params, b["tokens"], cfg)
            # what the consumer's stream reads after the forward; the batch
            # itself is dropped here, as a consumer drops it
            seen.append({key: t.clone() for key, t in b.items()})
            del b
            if k >= 2:
                check(k - 2)
                seen[k - 2] = None
        for k in range(len(host) - 2, len(host)):
            check(k)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    nbytes = sum(a.nbytes for a in host[0].values())
    print(f"serve device batches: {card}: {len(host)} batches of {nbytes} "
          f"bytes under GPT-2-small's forward at batch {DEVICE_BATCH_ROWS} "
          f"in {dt:.3f} s ({dt / len(host) * 1e3:.1f} ms a batch): "
          f"{'every batch bit-equal to its source' if not bad else bad}",
          flush=True)
    if bad:
        fail(f"device batches: {bad[:4]} differ from the host")

    got = _child(PROFILE_DEVICE_BATCHES)
    copies = got["copies"]
    ours = [c for c in copies if c["bytes"] in got["batch_bytes"]]
    others = [c for c in copies if c not in ours]
    print(f"serve device batches: profile of {PROFILED_DEVICE_BATCHES} "
          f"batches: {len(ours)} host-to-card copies of the batches ("
          + ", ".join(sorted({f"{c['name']} on stream {c['stream']}"
                              for c in ours}))
          + f"); forward kernels on streams {got['forward_streams']}; other "
          f"host-to-card copies {others[:4] or 'none'}", flush=True)
    if len(ours) != PROFILED_DEVICE_BATCHES * len(got["batch_bytes"]):
        bad.append(f"{len(ours)} batch copies in the profile")
    if not got["forward_streams"]:
        bad.append("no forward kernel in the profile")
    for c in ours:
        if "Pinned" not in c["name"] or c["stream"] in got["forward_streams"]:
            bad.append(f"copy {c}")
    if bad:
        fail(f"device batches: {bad[:4]}: a batch copy was not pinned or "
             f"ran on the forward's stream")


def profile_device_batches(torch) -> dict:
    """Phase 9d's child process: a profile of PROFILED_DEVICE_BATCHES
    batches through iter_device_batches under the forward; its host-to-card
    copies (name, stream, bytes) and the forward kernels' streams."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.data import iter_device_batches

    from ray_tpu_torch.models import gpt2

    cfg, params = serve_model(torch)
    host = device_batch_source(cfg)[:PROFILED_DEVICE_BATCHES]
    torch.cuda.synchronize()
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in iter_device_batches(host):
            gpt2.next_token_logits(params, b["tokens"], cfg)
        torch.cuda.synchronize()
    path = os.path.join(SERVE_DIR, "device_batches_trace.json")
    os.makedirs(SERVE_DIR, exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    copies = [{"name": e["name"], "stream": e["args"].get("stream"),
               "bytes": e["args"].get("bytes")} for e in events
              if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]]
    forward = sorted({e["args"].get("stream") for e in events
                      if e.get("cat") == "kernel"
                      and "flash_fwd" in e["name"]})
    return {"copies": copies, "forward_streams": forward,
            "batch_bytes": sorted({a.nbytes for a in host[0].values()})}


def serving(torch, card: str) -> dict:
    """Phase 9: the probe, the checkpoint, serving and device batches.
    Returns the launch counts of 9c's traffic."""
    import shutil

    from ray_tpu_torch.ops import flash_attention as fa

    torch.cuda.empty_cache()
    check_probe(torch, card)
    cfg, params = serve_model(torch)
    try:
        ckpt = check_checkpoint(torch, params, card)
        launches = serve(torch, fa, cfg, ckpt, card)
        device_batches(torch, cfg, params, card)
    finally:
        shutil.rmtree(SERVE_DIR, ignore_errors=True)
    return launches


def main() -> int:
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ray_tpu_torch.ops import flash_attention as fa

    if sys.argv[1:] == [PROBE_GPUS]:  # phase 9a's child, before any CUDA call
        print(json.dumps(probe_gpus()))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        return 1

    if sys.argv[1:] == [PROFILE_COLLECTIVES]:  # phase 8's child process
        print(json.dumps({"device_events": profile_collectives(torch)}))
        return 0
    if sys.argv[1:] == [PROFILE_DEVICE_BATCHES]:  # phase 9d's child process
        print(json.dumps(profile_device_batches(torch)))
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = header(torch)
    build_kernels()
    results = check_kernels(torch, F, fa)
    launches = train(torch, fa)
    tiny_launches = tiny_configs(torch, fa)
    moe_launches = moe(torch, fa, card)
    gang_launches = gang(torch, fa, card)
    checkpoints(torch, card)
    pipeline_launches = pipeline(torch, fa, card)
    pipeline_launches.update(expert_parallel(torch, fa, card))
    entry_launches = mesh_entry(torch, fa, card)
    collectives(torch, card)
    serve_launches = serving(torch, card)

    kernels = []
    # each kernel's count on the path that runs it: the main path for the
    # bf16 kernels, the f32 tiny config for the f32 ones, the wide tiny
    # config for the bf16_wide ones, the bf16 tiny config with a head of
    # 256 for the bf16_d256 ones, the f32 tiny config with a head of 256
    # for the f32 kernels' head-dim-256 instances, the tiny configs with a
    # head of 320 for the split-head-dim ones
    rows = [(spec, spec["name"], {
        "": launches, "_f32": tiny_launches["tiny float32"],
        "_bf16w": tiny_launches["tiny bfloat16 wide"],
        "_bf16d256": tiny_launches["tiny bfloat16 d256"],
        "_bf16ds": tiny_launches["tiny bfloat16 d320"],
        "_f32ds": tiny_launches["tiny float32 d320"],
    }[family(spec["name"])]) for spec in KERNELS]
    rows += [(spec, spec["name"] + D256, tiny_launches["tiny float32 d256"])
             for spec in KERNELS if family(spec["name"]) == "_f32"]
    for spec, name, path in rows:
        counter = spec["name"]
        extra = {"head_dim": 256} if name.endswith(D256) else {}
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCE_OF[counter],
                        "replaces": spec["replaces"],
                        "launches": path[counter],
                        "tiny_launches": {run: counts[counter] for run, counts
                                          in tiny_launches.items()},
                        "moe_launches": moe_launches[counter],
                        "gang_launches": {run: counts[counter] for run, counts
                                          in gang_launches.items()},
                        "pipeline_launches": {
                            run: counts[counter] for run, counts
                            in pipeline_launches.items()},
                        "entry_launches": {
                            run: counts[counter] for run, counts
                            in entry_launches.items()},
                        "serve_launches": serve_launches[counter],
                        **results[name], **extra})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
