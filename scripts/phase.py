#!/usr/bin/env python3
"""One of chip_smoke.py's multi-rank phases alone, with its gates and
its timings, from the checkout at ROOT (this repository by default):

    python scripts/phase.py --phase 6f|7|8 [ROOT] [--runs NAME,NAME]

``6f`` is the expert-parallel phase (6f-6h: GPT-2-small-MoE at dp 2 x
ep 2, ep 2 x tp 2 and sp 2 x ep 2 on rank threads, ROOT's
``expert_parallel`` over its ``EP_RUNS``); ``7`` is the mesh-entry phase
(7a-7c: GPT-2-small and GPT-2-small-MoE through create_mesh, Mesh.join,
make_train_state and make_train_step on four rank threads, remat on,
ROOT's ``mesh_entry`` over its ``MESH_RUNS``); ``8`` is the collective
backends' phase (ROOT's ``collectives``, which has no runs). It builds
the kernels of
ROOT's package, prints the card's name and power limit, runs the runs
named by ``--runs`` (all of them by default) and exits 1 if one of its
gates fails. To compare two trees on one card, unpack each into a
directory of its own and run them in turns in one call (a, b, b, a).
Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import os
import sys

# phase -> (chip_smoke's table of runs, the function that runs them)
PHASES = {"6f": ("EP_RUNS", "expert_parallel"),
          "7": ("MESH_RUNS", "mesh_entry"),
          "8": (None, "collectives")}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("root", nargs="?",
                        default=os.path.join(os.path.dirname(__file__), ".."))
    parser.add_argument("--phase", required=True, choices=sorted(PHASES))
    parser.add_argument("--runs", default="",
                        help="comma-separated names of the phase's runs "
                             "(default: all)")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from ray_tpu_torch.ops import flash_attention as fa

    table, phase = PHASES[args.phase]
    if not torch.cuda.is_available():
        print(f"phase {args.phase}: CUDA is not available", file=sys.stderr)
        return 1
    names = [n for n in args.runs.split(",") if n]
    runs = [r for r in (getattr(cs, table) if table else ())
            if not names or r[0] in names]
    if len(runs) != len(names or runs):
        print(f"phase {args.phase}: unknown runs in {names}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.header(torch)
    cs.build_kernels()
    if table is None:
        getattr(cs, phase)(torch, card)
    else:
        getattr(cs, phase)(torch, fa, card, runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
