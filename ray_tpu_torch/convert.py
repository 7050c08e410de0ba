"""Weights carried across between the JAX package and the port.

Both packages hold GPT-2's parameters as the same nested dict: the same
keys, shapes and dtypes as ``ray_tpu.models.gpt2.init`` (stacked
``[L, ...]`` block leaves, ``wq [d, h, k]``, ``wo [h, k, d]``, f32), so a
leaf crosses as it is, with no transpose. ``stage_params`` cuts such a
tree into one pipeline stage's, as the JAX package's pipelined forward
splits the block leaves as ``[pp, L / pp, ...]``; ``join_stages`` puts the
stages back together.
"""
from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch._private.tree import tree_map


def _to_tensor(leaf, device) -> torch.Tensor:
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        # torch.from_numpy rejects ml_dtypes' bfloat16: cross as its bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree, device: DeviceLike = None):
    """A tree of numpy arrays (or anything ``np.asarray`` takes, such as
    JAX arrays) -> the same tree of tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda leaf: _to_tensor(leaf, dev), tree)


def params_to_numpy(tree):
    """A tree of tensors -> the same tree of numpy arrays on the host.
    bf16 leaves come back as float32, which holds every bf16 value."""
    def leaf_to_numpy(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(leaf_to_numpy, tree)


def stage_params(params, pp_rank: int, pp: int):
    """Stage ``pp_rank`` of ``pp``'s tree: its ``[L / pp, ...]`` slice of
    every block leaf and the embedding and final LayerNorm whole, each a
    copy of its own (the ranks update their trees in place)."""
    L = params["blocks"]["ln1"]["scale"].shape[0]
    if L % pp:
        raise ValueError(f"n_layer={L} not divisible by pp={pp}")
    per = L // pp
    out = {k: tree_map(lambda t: t.detach().clone(), v)
           for k, v in params.items() if k != "blocks"}
    out["blocks"] = tree_map(
        lambda t: t[pp_rank * per:(pp_rank + 1) * per].detach().clone(),
        params["blocks"])
    return out


def join_stages(stages):
    """The whole model's tree from the stages' trees in stage order: the
    block leaves concatenated, the other leaves from stage 0."""
    def cat(parts):
        if isinstance(parts[0], dict):
            return {k: cat([p[k] for p in parts]) for k in sorted(parts[0])}
        return torch.cat(parts)

    out = dict(stages[0])
    out["blocks"] = cat([s["blocks"] for s in stages])
    return out
