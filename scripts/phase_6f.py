#!/usr/bin/env python3
"""chip_smoke.py's expert-parallel phases alone (6f-6h: GPT-2-small-MoE at
dp 2 x ep 2, ep 2 x tp 2 and sp 2 x ep 2 on rank threads, their gates and
their timings), from the checkout at ROOT (this repository by default):

    python scripts/phase_6f.py [ROOT] [--runs NAME,NAME]

It builds the kernels of ROOT's package, prints the card's name and power
limit, then runs ROOT's ``expert_parallel`` phase over the runs of its
EP_RUNS named by ``--runs`` (all of them by default) and exits 1 if one
of its gates fails. To compare two trees on one card, unpack each into a
directory of its own and run them in turns in one call (a, b, b, a).
Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import os
import sys


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("root", nargs="?",
                        default=os.path.join(os.path.dirname(__file__), ".."))
    parser.add_argument("--runs", default="",
                        help="comma-separated EP_RUNS names (default: all)")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from ray_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("phase_6f: CUDA is not available", file=sys.stderr)
        return 1
    names = [n for n in args.runs.split(",") if n]
    runs = [r for r in cs.EP_RUNS if not names or r[0] in names]
    if len(runs) != len(names or runs):
        print(f"phase_6f: unknown runs in {names}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.header(torch)
    cs.build_kernels()
    cs.expert_parallel(torch, fa, card, runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
