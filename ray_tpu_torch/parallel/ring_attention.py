"""Ring attention: context parallelism over the ``sp`` axis, and the
attention oracle. Port of ``ray_tpu/parallel/ring_attention.py``.

The sequence is split into contiguous shards over the ``sp`` ranks: rank
i holds tokens [i * S_local, (i + 1) * S_local). Each rank keeps its Q
shard and passes K and V around the ring, rank i to rank i + 1, over its
``sp`` group (``util.collective.sendrecv``, the twin of the JAX
package's ``ppermute``; on the device backend the hop stays on the
card), combining the blocks' attention by online
softmax. Under a causal mask a block from an earlier rank is attended
whole, the rank's own block under the triangle, and a later rank's block
not at all.

The block op is plain tensor ops, as the JAX package's is plain einsums:
the scores, exponentials and products run in f32 on upcast inputs (the
JAX twin rounds the scores and exponentials of a bf16 input to bf16;
f32 is the same function rounded less). The forward returns the row
log-sum-exp beside the output.

The backward is an explicit ring function, ``ring_attention_local_backward``,
not an autograd rule: it communicates, and a collective must never run
inside autograd's backward (``parallel/pipeline.py``). K and V go around
the ring once more, and each block's dk and dv travel with it, to arrive
home after the last hop. Inside a pipeline stage ``ring_attention_stage``
records the pair on the stage's ``StageTape``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.util import collective as col

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


def _block_kind(kv_idx: int, my_idx: int, causal: bool) -> str:
    """"full", "same" (the causal triangle) or "none" (fully masked)."""
    if not causal or kv_idx < my_idx:
        return "full"
    return "same" if kv_idx == my_idx else "none"


def _scores(q, k, *, scale, kind):
    """f32 scores [B, H, Sq, Sk] of one (Q-block, KV-block) tile."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if kind == "same":
        S_q, S_k = q.shape[1], k.shape[1]
        keep = torch.ones(S_q, S_k, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def _block_attend(q, k, v, *, scale, kind):
    """One tile, f32: (scores max [B, H, Sq], exp scores [B, H, Sq, Sk],
    exp scores . v [B, H, Sq, D])."""
    s = _scores(q, k, scale=scale, kind=kind)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    return m, e, torch.einsum("bhqk,bkhd->bhqd", e, v)


def _ring(group: str):
    rank = col.get_rank(group)
    n = col.get_collective_group_size(group)
    return rank, n, (rank + 1) % n, (rank - 1) % n


def ring_attention_local(q, k, v, *, group: str, causal: bool = True,
                         scale: Optional[float] = None):
    """Per-shard ring attention: q, k, v ``[B, S_local, H, D]``, this
    rank's shard. Returns (o ``[B, S_local, H, D]`` in q's dtype, the row
    log-sum-exp ``[B, H, S_local]`` f32). Runs outside autograd."""
    o, lse = _ring_forward(q, k, v, group=group, causal=causal, scale=scale)
    return o.to(q.dtype), lse


def _ring_forward(q, k, v, *, group, causal, scale):
    """``ring_attention_local`` with its output in f32."""
    B, S, H, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    me, n, nxt, prv = _ring(group)
    q32 = q.float()
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, H, S, D, dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for r in range(n):
        # the block arriving at step r started on rank (me - r) mod n
        kind = _block_kind((me - r) % n, me, causal)
        if kind != "none":
            bm, be, bpv = _block_attend(q32, kv[0].float(), kv[1].float(),
                                        scale=scale, kind=kind)
            m_new = torch.maximum(m, bm)
            c_old = torch.exp(m - m_new)
            c_new = torch.exp(bm - m_new)
            l = l * c_old + be.sum(dim=-1) * c_new
            acc = acc * c_old[..., None] + bpv * c_new[..., None]
            m = m_new
        if r < n - 1:
            kv = col.sendrecv(kv, nxt, prv, group).to(q.device)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    lse = m + torch.log(l)
    return out.transpose(1, 2), lse


def ring_attention_local_backward(q, k, v, o, lse, do, *, group: str,
                                  causal: bool = True,
                                  scale: Optional[float] = None):
    """dq, dk, dv of ``ring_attention_local`` for this rank's shard, given
    its output ``o`` (best in f32, as rounding it moves delta = sum(do *
    o)), its lse and the output's gradient ``do``, in f32 from the
    probabilities recomputed from lse; returned in the inputs' dtypes.
    Runs outside autograd: K and V take the ring once more, with their dk
    and dv."""
    B, S, H, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    me, n, nxt, prv = _ring(group)
    q32, do32 = q.float(), do.float()
    delta = (do32 * o.float()).sum(dim=-1).transpose(1, 2)  # [B, H, S]
    dq = torch.zeros_like(q32)
    kv = torch.stack([k, v])
    dkv = torch.zeros((2,) + tuple(k.shape), dtype=torch.float32,
                      device=q.device)
    for r in range(n):
        kind = _block_kind((me - r) % n, me, causal)
        if kind != "none":
            k32, v32 = kv[0].float(), kv[1].float()
            p = torch.exp(_scores(q32, k32, scale=scale, kind=kind)
                          - lse[..., None])
            dp = torch.einsum("bqhd,bkhd->bhqk", do32, v32)
            ds = p * (dp - delta[..., None])
            dq += torch.einsum("bhqk,bkhd->bqhd", ds, k32) * scale
            dkv[0] += torch.einsum("bhqk,bqhd->bkhd", ds, q32) * scale
            dkv[1] += torch.einsum("bhqk,bqhd->bkhd", p, do32)
        # dk and dv move with their block; after the n-th hop they are home
        if r < n - 1:
            kv = col.sendrecv(kv, nxt, prv, group).to(q.device)
        if n > 1:
            dkv = col.sendrecv(dkv, nxt, prv, group).to(q.device)
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


def ring_attention_stage(q, k, v, *, group: str, tape, causal: bool = True):
    """``ring_local`` attention inside a pipeline stage: the ring forward
    runs outside autograd and its output comes back as a leaf of ``tape``
    (a ``parallel.pipeline.StageTape``), whose backward runs the ring
    backward between two autograd segments. Without a tape only a forward
    that needs no gradient runs; one that would need the backward
    raises."""
    if tape is None:
        if torch.is_grad_enabled() and any(x.requires_grad
                                           for x in (q, k, v)):
            raise ValueError(
                "ring_local attention's backward communicates, so it runs "
                "only on a pipeline StageTape (gpt2.forward_pipelined), or "
                "under torch.no_grad")
        return ring_attention_local(q, k, v, group=group, causal=causal)[0]

    def forward(q, k, v):
        o, lse = _ring_forward(q, k, v, group=group, causal=causal,
                               scale=None)
        return (o.to(q.dtype),), (q, k, v, o, lse)

    def backward(saved, grads):
        (do,) = grads
        q, k, v, o, lse = saved
        return ring_attention_local_backward(q, k, v, o, lse, do,
                                             group=group, causal=causal)

    (o,) = tape.boundary((q, k, v), forward, backward)
    return o


def shard_bounds(S: int, n: int, i: int):
    """[lo, hi) of shard i of a sequence of S split contiguously over n."""
    if S % n:
        raise ValueError(f"sequence {S} not divisible by sp={n}")
    step = S // n
    return i * step, (i + 1) * step


def ring_attention(q, k, v, *, group: str, causal: bool = True):
    """Context-parallel attention over global ``[B, S, H, D]`` tensors, on
    every ``sp`` rank: each takes its contiguous shard of the sequence,
    runs ``ring_attention_local`` and allgathers the shards' outputs.
    Forward only: the gradient is ``ring_attention_local_backward``."""
    lo, hi = shard_bounds(q.shape[1], col.get_collective_group_size(group),
                          col.get_rank(group))
    o, _ = ring_attention_local(q[:, lo:hi], k[:, lo:hi], v[:, lo:hi],
                                group=group, causal=causal)
    return torch.cat([t.to(q.device) for t in col.allgather(o, group)], dim=1)
