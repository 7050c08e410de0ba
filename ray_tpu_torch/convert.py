"""Weights carried across between the JAX package and the port.

Both packages hold GPT-2's parameters as the same nested dict: the same
keys, shapes and dtypes as ``ray_tpu.models.gpt2.init`` (stacked
``[L, ...]`` block leaves, ``wq [d, h, k]``, ``wo [h, k, d]``, f32), so a
leaf crosses as it is, with no transpose.
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
