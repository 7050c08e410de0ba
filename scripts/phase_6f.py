#!/usr/bin/env python3
"""chip_smoke.py's phase 6f alone (GPT-2-small-MoE at dp 2 x ep 2 on rank
threads, its gates and its timings), from the checkout at ROOT (this
repository by default):

    python scripts/phase_6f.py [ROOT]

It builds the kernels of ROOT's package, prints the card's name and power
limit, then runs ROOT's ``expert_parallel`` phase and exits 1 if one of
its gates fails. To compare two trees on one card, unpack each into a
directory of its own and run them in turns in one call (a, b, b, a).
Needs one CUDA device.
"""
from __future__ import annotations

import os
import sys


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.join(os.path.dirname(__file__), ".."))
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from ray_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("phase_6f: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.header(torch)
    cs.build_kernels()
    cs.expert_parallel(torch, fa, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
