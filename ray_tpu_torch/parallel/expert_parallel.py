"""Expert parallelism over the ``ep`` axis, with the MoE router counted
over the whole ``dp`` batch: the collectives that XLA inserts for the JAX
package's ``experts`` sharding (``DEFAULT_RULES["experts"] = "ep"``) and
for its routing over the global batch (``ray_tpu/models/layers.py``
``apply_moe``), placed by hand.

A rank of a ``dp`` x ``ep`` layout holds its replica's rows and its block
of ``E / ep`` experts (``sharding.tree_shard`` with
``gpt2.partition_specs``); the router and everything outside the MoE
layer are replicated over ``ep``. Its ``dp`` group is the ranks that
hold the same experts for the other replicas' rows; its ``ep`` group the
ranks that hold the other experts for the same rows.

``route_counts`` (forward only, no gradient) is one allreduce over dp of
each replica's (token, k) pairs per expert, from which a rank's slots
continue the count of the replicas before it, and of the tokens whose
top-1 expert each is, the aux loss's whole-batch fractions. Nothing else
of the layer crosses dp: a slot holds one token, so an expert computes a
replica's slots from that replica's rows alone, and only that replica's
rows read them.

The MoE input and the gates enter the rank's experts, and the output
leaves them, over the ep group by ``tensor_parallel``'s boundaries:
Megatron's pattern, as over tp (``layers.apply_moe``).
"""
from __future__ import annotations

import torch

from ray_tpu_torch.util import collective as col


def route_counts(pairs: torch.Tensor, top1: torch.Tensor, group: str):
    """(each expert's pairs on the replicas before this one, ``[E]`` int64;
    each expert's top-1 tokens over the whole batch, ``[E]`` int64), from
    this replica's counts ``pairs`` and ``top1`` (``[E]`` integers): one
    allreduce over the dp ``group`` of a ``[dp + 1, E]`` f64 table, the
    replica's pairs in its own row (every count below 2^53 is exact)."""
    n, r = col.get_collective_group_size(group), col.get_rank(group)
    table = torch.zeros(n + 1, pairs.shape[0], dtype=torch.float64)
    table[r] = pairs.detach().cpu().double()
    table[n] = top1.detach().cpu().double()
    table = col.allreduce(table, group)
    return (table[:r].sum(dim=0).long().to(pairs.device),
            table[n].long().to(top1.device))
