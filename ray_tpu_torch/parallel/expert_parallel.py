"""Expert parallelism over the ``ep`` axis, with the MoE router counted
over the whole batch, cut over ``dp`` and ``sp``: the collectives that
XLA inserts for the JAX package's ``experts`` sharding
(``DEFAULT_RULES["experts"] = "ep"``) and for its routing over the global
batch (``ray_tpu/models/layers.py`` ``apply_moe``), placed by hand.

A rank of a ``dp`` x ``ep`` x ``sp`` x ``tp`` layout holds its replica's
rows, its shard of the sequence, and its block of ``E / ep`` experts, cut
at tp > 1 to its block of each expert's hidden (``sharding.tree_shard``
with ``gpt2.partition_specs``); the router and everything outside the
MoE layer are whole on every ep rank. Its ``dp`` group is the ranks that
hold the same experts for the other replicas' rows, its ``sp`` group
those that hold them for the row's other shards; its ``ep`` group the
ranks that hold the other experts for the same tokens, its ``tp`` group
the other blocks of the same experts' hidden.

``route_counts`` (forward only, no gradient) counts each row's (token,
k) pairs per expert over the whole batch: one allreduce over sp and one
over dp of a table of every (replica, row, shard)'s counts, from which a
rank's slots in a row continue the count of every pair before them in
the (b, s, k) stream, and of the tokens whose top-1 expert each is, the
aux loss's whole-batch fractions. Nothing else of the layer crosses dp
or sp: a slot holds one token, so an expert computes the slots of a
rank's tokens from that rank's tokens alone, and only those tokens read
them.

The MoE input and the gates enter the rank's experts, and the output
leaves them, over the ep group, and the input enters and the experts'
output leaves each expert's hidden over the tp group, by
``tensor_parallel``'s boundaries: Megatron's pattern
(``layers.apply_moe``).
"""
from __future__ import annotations

import torch

from ray_tpu_torch.util import collective as col


def group_place(group):
    """(size, rank) of a group, (1, 0) for None."""
    if group is None:
        return 1, 0
    return col.get_collective_group_size(group), col.get_rank(group)


def route_counts(pairs: torch.Tensor, top1: torch.Tensor, dp_group=None,
                 sp_group=None):
    """(each expert's pairs before each of this rank's rows' pairs in the
    whole batch's (b, s, k) stream, ``[B, E]`` int64; each expert's top-1
    tokens over the whole batch, ``[E]`` int64), from this rank's counts
    ``pairs`` (``[B, E]``, per row of its shard) and ``top1`` (``[E]``).
    The stream runs over the replicas' rows in order, and within a row
    over its sp shards in order: one allreduce over the ``sp_group`` and
    one over the ``dp_group`` (either may be None) of a ``[dp * B * sp +
    1, E]`` f64 table on the counts' device, the rank's counts in its own
    rows (every count below 2^53 is exact)."""
    n_dp, dp_rank = group_place(dp_group)
    n_sp, sp_rank = group_place(sp_group)
    B, E = pairs.shape
    table = torch.zeros(n_dp * B * n_sp + 1, E, dtype=torch.float64,
                        device=pairs.device)
    table[:-1].view(n_dp, B, n_sp, E)[dp_rank, :, sp_rank] = (
        pairs.detach().double())
    table[-1] = top1.detach().double()
    for group in (sp_group, dp_group):
        if group is not None:
            table = col.allreduce(table, group)
    counts = table[:-1]
    before = (counts.cumsum(dim=0) - counts).view(n_dp, B, n_sp, E)
    return (before[dp_rank, :, sp_rank].long().to(pairs.device),
            table[-1].long().to(top1.device))
