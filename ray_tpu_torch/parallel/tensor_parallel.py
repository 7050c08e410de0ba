"""Tensor parallelism over the ``tp`` axis, Megatron-style: the
collectives that XLA inserts for the JAX package's ``heads``, ``mlp`` and
``vocab`` shardings (``parallel/sharding.py``'s ``DEFAULT_RULES``),
placed by hand.

A rank holds its block of the heads, of the MLP hidden and of the vocab
(``sharding.tree_shard`` with ``gpt2.partition_specs``). Two boundaries
carry the activations between the whole and the sharded parts:

* ``copy_to_group``: the identity forward; the backward sums each
  gradient over the group, since each rank's sharded part differentiates
  only its own share of the whole inputs' uses;
* ``reduce_over_group``: the forward sums the ranks' partial outputs
  over the group; the backward is the identity.

Nothing in them depends on the axis: the MoE layer's experts over ``ep``
(``layers.apply_moe``) cross the same two boundaries over the ep group.
Both are ``StageTape`` boundaries (``parallel/pipeline.py``): the
collective runs on the rank's thread between two autograd segments,
never inside autograd's backward. Sums run in f32 and are rounded once
to the input's dtype, so a tp result is within one rounding of the one
rank's, whatever the order of the sum (XLA's may differ).

``vocab_parallel_embedding`` and ``vocab_parallel_token_losses`` are the
embedding lookup and the cross-entropy over a vocab cut into contiguous
blocks, a rank's block ``[tp_rank * V_local, (tp_rank + 1) * V_local)``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.util import collective as col


def _sum_over(x: torch.Tensor, group: str) -> torch.Tensor:
    """x summed over ``group`` in f32, rounded once to x's dtype."""
    total = col.allreduce(x.detach().float(), group)
    return total.to(device=x.device, dtype=x.dtype)


def _need_tape(tape, what: str):
    if tape is None:
        raise ValueError(f"{what} communicates, so it runs on a pipeline "
                         f"StageTape (gpt2.forward_pipelined)")


def copy_to_group(xs: Sequence[torch.Tensor], group: str,
                  tape) -> Tuple[torch.Tensor, ...]:
    """``xs``, each whole on every rank of ``group``, entering the sharded
    part: the identity, whose backward sums each gradient over the
    group."""
    _need_tape(tape, "copy_to_group")
    return tape.boundary(tuple(xs), lambda *t: (t, None),
                         lambda _, grads: _copy_backward(grads, group))


def _copy_backward(grads, group: str):
    """The copy's backward: each gradient summed over the group."""
    return tuple(None if g is None else _sum_over(g, group) for g in grads)


def reduce_over_group(partial: torch.Tensor, group: str,
                      tape) -> torch.Tensor:
    """The sum over ``group`` of the ranks' ``partial`` outputs (f32 in
    f32), on every rank; the backward hands the gradient on unchanged."""
    _need_tape(tape, "reduce_over_group")
    (out,) = tape.boundary((partial,),
                           lambda t: ((_sum_over(t, group),), None),
                           lambda _, grads: grads)
    return out


def vocab_parallel_embedding(tokens: torch.Tensor, wte: torch.Tensor,
                             group: str, tape) -> torch.Tensor:
    """The rows of the whole ``[V, d]`` embedding for ``tokens`` from this
    rank's block ``wte`` ``[V / tp, d]``: each rank looks up the tokens in
    its range (zero rows for the others) and the rows are summed over the
    group, exactly, since one rank holds each token."""
    n = wte.shape[0]
    local = tokens.long() - col.get_rank(group) * n
    mine = (local >= 0) & (local < n)
    rows = F.embedding(local.clamp(0, n - 1), wte)
    return reduce_over_group(torch.where(mine.unsqueeze(-1), rows, 0.0),
                             group, tape)


class _VocabParallelTokenLosses(torch.autograd.Function):
    """-log p(target) per token from this rank's block of the logits: the
    row max over the group (allreduce max), then Σexp and the target's
    logit (from the rank whose block holds it) summed over the group in
    one allreduce; the loss is lse - target logit, the same on every rank.
    The backward is local: (softmax - onehot) on the rank's columns,
    times the cotangent."""

    @staticmethod
    def forward(ctx, logits, targets, group):
        n = logits.shape[-1]
        local = targets.long() - col.get_rank(group) * n
        mine = (local >= 0) & (local < n)
        index = local.clamp(0, n - 1).unsqueeze(-1)
        m = col.allreduce(logits.amax(dim=-1), group, op="max").to(
            logits.device)
        sums = torch.stack([
            torch.exp(logits - m.unsqueeze(-1)).sum(dim=-1),
            torch.where(mine, logits.gather(-1, index).squeeze(-1), 0.0)])
        sums = col.allreduce(sums, group).to(logits.device)
        lse = m + torch.log(sums[0])
        ctx.save_for_backward(logits, lse, index, mine)
        return lse - sums[1]

    @staticmethod
    def backward(ctx, g):
        logits, lse, index, mine = ctx.saved_tensors
        grad = torch.exp(logits - lse.unsqueeze(-1))
        grad.scatter_add_(-1, index, -mine.to(grad.dtype).unsqueeze(-1))
        return grad.mul_(g.unsqueeze(-1)), None, None


def vocab_parallel_token_losses(logits: torch.Tensor, targets: torch.Tensor,
                                group: str) -> torch.Tensor:
    """``logits`` ``[..., V / tp]`` f32, this rank's block of the vocab;
    ``targets`` ``[...]`` whole-vocab ids. Returns the per-token losses
    ``[...]``, the same on every rank of ``group``; their gradient reaches
    the rank's own logits only."""
    return _VocabParallelTokenLosses.apply(logits, targets, group)
