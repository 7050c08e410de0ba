"""Attention oracles. Port of ``ray_tpu/parallel/ring_attention.py``:
``reference_attention`` only; ring attention over a sequence-parallel
group comes with the mesh-parallel slice."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def reference_attention(q, k, v, *, causal=True, scale=None):
    """Plain full attention over [B, S, H, D], softmax in f32: the
    correctness oracle, and the ``reference`` attention impl."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        S_q, S_k = q.shape[1], k.shape[1]
        keep = torch.ones(S_q, S_k, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)
