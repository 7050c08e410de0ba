#!/usr/bin/env python3
"""How far GPT-2 with routed MoE blocks moves when only attention's
rounding changes: one loss_fn call with reference attention and one with
flash attention on the same weights and tokens, for a dense model and an
MoE model in bf16 and in f32.

    python scripts/moe_routing_sensitivity.py --device cpu   # plain versions
    python scripts/moe_routing_sensitivity.py                # the card's kernels

On the CPU "flash" runs the kernels' plain versions, which round p to the
compute dtype before p.v where reference attention keeps it f32: no
kernel is involved. For each model it prints, layer by layer, the tokens
whose set of experts differs between the two runs and how far apart the
layers' inputs are, then the relative differences of the loss, of the
global grad norm and of each attention leaf's gradient. The config is
GPT-2's vocab with d 256, 4 layers, 4 heads, batch 4, seq 256, and
MoEConfig() (8 experts, top-2, capacity factor 1.25), weights from a
seeded generator.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ray_tpu_torch._private.tree import tree_leaves, tree_map  # noqa: E402
from ray_tpu_torch.models import gpt2  # noqa: E402
from ray_tpu_torch.models import layers as L  # noqa: E402


def compare(cfg, device, tokens):
    params = tree_map(lambda p: p.requires_grad_(True), gpt2.init(
        torch.Generator(device=device).manual_seed(0), cfg, device=device))
    leaves = tree_leaves(params)
    attn = params["blocks"]["attn"]
    where = {n: next(i for i, leaf in enumerate(leaves) if leaf is attn[n])
             for n in sorted(attn)}
    routed = {"reference": [], "flash": []}
    runs, out = [], {}
    apply_moe = L.apply_moe

    def recording(p, x, moe_cfg, compute_dtype):
        _, _, experts, _ = L.route_tokens(p["wg"], x.detach(), moe_cfg)
        routed[runs[-1]].append((experts.sort(-1).values, x.detach().float()))
        return apply_moe(p, x, moe_cfg, compute_dtype)

    L.apply_moe = recording
    try:
        for run in routed:
            runs.append(run)
            total, m = gpt2.loss_fn(params, {"tokens": tokens},
                                    dataclasses.replace(cfg, attention=run))
            grads = torch.autograd.grad(total, leaves)
            out[run] = (float(m["loss"].detach()),
                        float(torch.sqrt(sum(g.float().square().sum()
                                             for g in grads))),
                        {n: grads[i] for n, i in where.items()})
    finally:
        L.apply_moe = apply_moe
    tag = (f"{'moe' if cfg.moe else 'dense'} "
           f"{str(cfg.dtype).removeprefix('torch.')}")
    for i, ((e_ref, x_ref), (e_fl, x_fl)) in enumerate(
            zip(routed["reference"], routed["flash"])):
        changed = int((e_ref != e_fl).any(-1).sum())
        drift = float((x_fl - x_ref).norm() / x_ref.norm())
        print(f"{tag}: layer {i}: {changed} of "
              f"{e_ref.shape[0] * e_ref.shape[1]} tokens with another set of "
              f"experts; the layer's inputs {drift:.3e} apart")
    (loss_r, gn_r, g_r), (loss_f, gn_f, g_f) = out["reference"], out["flash"]
    rel = ", ".join(f"{n} {float((g_f[n] - g_r[n]).norm() / g_r[n].norm()):.3e}"
                    for n in where)
    print(f"{tag}: flash against reference: loss "
          f"{abs(loss_f - loss_r) / loss_r:.3e}, grad norm "
          f"{abs(gn_f - gn_r) / gn_r:.3e}, attention leaves {rel}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (the plain versions)")
    args = parser.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    base = gpt2.GPT2Config(max_seq=256, n_layer=4, n_head=4, d_model=256,
                           remat=False)
    tokens = torch.randint(0, base.vocab_size, (4, 257),
                           generator=torch.Generator().manual_seed(1)).to(device)
    for moe, dtype in ((None, torch.bfloat16), (L.MoEConfig(), torch.bfloat16),
                       (L.MoEConfig(), torch.float32)):
        compare(dataclasses.replace(base, moe=moe, dtype=dtype), device, tokens)
    return 0


if __name__ == "__main__":
    sys.exit(main())
