"""Logical-axis sharding over the port's rank layouts, and gradient-bucket
plumbing for the data-parallel gang. Port of ``ray_tpu/parallel/sharding.py``:
its mesh half (``:16-72``), its bucket half (``:86-264``) and its
``axis_size`` (``:267``).

**The mesh half.** Model code names a leaf's dimensions by logical axes
(``models.layers.ATTENTION_LOGICAL``, ``gpt2.logical_axes``) and
``DEFAULT_RULES`` maps them to mesh axes, as in the JAX package. There
a ``NamedSharding`` lays an array out over the mesh's devices and XLA
inserts the collectives; here each rank is a program of its own, so a
spec is a plain tuple (``spec``), ``tree_shard`` cuts the rank's block
out of a whole tree and ``tree_unshard`` puts one back together over the
axis groups, and the model places each collective itself
(``parallel.tensor_parallel``). ``named_sharding`` and ``constrain``
have no twin: in an eager per-rank program there is no compiler to hand
a layout to, and a tensor's layout is the block a rank holds, decided
once by ``tree_shard``; a constraint between two ops would be a no-op.

**The bucket half.** A grad tree is flattened in sorted-key order (jax's
dict order), its leaves are planned into size-targeted buckets, and each
bucket is packed into one contiguous 1-D host tensor that the collective
group moves. Planning depends only on leaf shapes and dtypes, so every
rank derives the same buckets, and the same buckets as ``ray_tpu`` for
the same tree.

Dtypes are spelled the numpy way (``float32``, not ``torch.float32``) in
the plan and the fingerprint, so both equal ``ray_tpu``'s.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Optional, Tuple, Union

import torch

from ray_tpu_torch._private.tree import tree_leaves, tree_map, tree_unflatten
from ray_tpu_torch.util import collective as col

AxisVal = Union[None, str, Tuple[str, ...]]

# Default logical -> mesh rules for transformer LMs, the JAX package's:
# "seq" rides the sp axis; "heads", "mlp" and "vocab" ride tp; "experts"
# ride ep; "stage" rides pp; "batch" rides dp.
DEFAULT_RULES: Dict[str, AxisVal] = {
    "batch": "dp",
    "seq": "sp",
    "embed": None,
    "heads": "tp",
    "kv": None,
    "head_dim": None,
    "mlp": "tp",
    "experts": "ep",
    "expert_mlp": "tp",
    "vocab": "tp",
    "stage": "pp",
    "layers": None,
}


def spec(*logical_axes: Optional[str],
         rules: Optional[Dict[str, AxisVal]] = None) -> tuple:
    """The partition spec of a leaf whose dimensions carry
    ``logical_axes``: one mesh axis (a name, a tuple of names, or None) a
    dimension, as a plain tuple equal to the JAX package's
    ``PartitionSpec``'s. A dimension past the spec's end is whole."""
    rules = rules or DEFAULT_RULES
    out = []
    for ax in logical_axes:
        if ax is None:
            out.append(None)
        else:
            if ax not in rules:
                raise KeyError(f"No sharding rule for logical axis {ax!r}")
            out.append(rules[ax])
    return tuple(out)


def replicated() -> tuple:
    """The spec of a leaf every rank holds whole."""
    return ()


def spec_axes(entry: AxisVal) -> Tuple[str, ...]:
    """The mesh axes one dimension's spec entry names, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_coord(layout, axis: str) -> int:
    return 0 if axis_size(layout, axis) == 1 else getattr(layout,
                                                         f"{axis}_rank")


def _shard_leaf(leaf: torch.Tensor, layout, leaf_spec) -> torch.Tensor:
    """This rank's block of a whole ``leaf``, a copy: each dimension whose
    spec names mesh axes is cut into as many contiguous blocks as they
    make together, and the block at the rank's coordinates (the first
    axis named the slowest) is kept, as ``NamedSharding`` lays out a
    device's shard. Raises ``ValueError`` where the axes do not divide a
    dimension."""
    out = leaf.detach()
    for dim, entry in enumerate(leaf_spec):
        axes = spec_axes(entry)
        n = math.prod(axis_size(layout, a) for a in axes)
        if n == 1:
            continue
        if out.shape[dim] % n:
            raise ValueError(
                f"dimension {dim} of a leaf of shape {tuple(leaf.shape)} "
                f"(spec {tuple(leaf_spec)}) is not divisible by "
                f"{'x'.join(axes)}={n}")
        index = 0
        for a in axes:
            index = index * axis_size(layout, a) + _axis_coord(layout, a)
        step = out.shape[dim] // n
        out = out.narrow(dim, index * step, step)
    return out.clone()


def tree_shard(tree, layout, spec_tree):
    """The eager twin of ``tree_shard`` with ``NamedSharding``: this
    rank's block (``_shard_leaf``) of every leaf of the whole ``tree``,
    each a copy of its own (the ranks update their trees in place), by
    the matching tree of specs."""
    specs = tree_leaves(spec_tree)
    return tree_unflatten(tree, [_shard_leaf(leaf, layout, s) for leaf, s
                                 in zip(tree_leaves(tree), specs,
                                        strict=True)])


def tree_unshard(tree, layout, spec_tree):
    """The whole tree back from every rank's blocks (``tree_shard``'s): on
    each sharded dimension the blocks are allgathered over the axis
    groups, the last axis named first, and concatenated in rank order.
    Every rank of each group calls it; each gets the whole tree."""
    def gather(leaf, leaf_spec):
        out = leaf.detach()
        for dim, entry in enumerate(leaf_spec):
            for a in reversed(spec_axes(entry)):
                if axis_size(layout, a) > 1:
                    parts = col.allgather(out, getattr(layout, f"{a}_group"))
                    out = torch.cat([p.to(out.device) for p in parts],
                                    dim=dim)
        return out

    specs = tree_leaves(spec_tree)
    return tree_unflatten(tree, [gather(leaf, s) for leaf, s
                                 in zip(tree_leaves(tree), specs,
                                        strict=True)])


def dtype_name(leaf) -> str:
    """The numpy spelling of a leaf's dtype: ``float32``, ``bfloat16``."""
    dt = getattr(leaf, "dtype", None)
    if dt is None:
        return "object"
    return str(dt).removeprefix("torch.")


def _numel(leaf) -> int:
    return math.prod(int(d) for d in getattr(leaf, "shape", ()))


def flatten_tree(tree):
    """(leaves, treedef) in sorted-key order. ``treedef`` is the tree's
    skeleton; it holds no leaf."""
    return tree_leaves(tree), tree_map(lambda _: None, tree)


def unflatten_tree(treedef, leaves):
    return tree_unflatten(treedef, leaves)


def plan_buckets(leaves, bucket_bytes: int) -> list[list[int]]:
    """Partition leaf indices into size-targeted buckets.

    Leaves are grouped by dtype (first-appearance order: a bucket packs
    into one contiguous tensor, so its members share a dtype) and, within
    each dtype, kept in flatten order and greedily filled up to
    ``bucket_bytes``. A leaf larger than the target gets a bucket of its
    own and is never split."""
    bucket_bytes = max(1, int(bucket_bytes))
    by_dtype: dict = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(dtype_name(leaf), []).append(i)
    plan: list[list[int]] = []
    for members in by_dtype.values():
        cur: list[int] = []
        cur_bytes = 0
        for i in members:
            nbytes = int(getattr(leaves[i], "nbytes", 0))
            if cur and cur_bytes + nbytes > bucket_bytes:
                plan.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += nbytes
        if cur:
            plan.append(cur)
    return plan


def _pack_buffer(first, n: int, on_device: bool):
    """(an empty 1-D buffer of ``n`` elements for a bucket whose first
    leaf is ``first``, whether it is staged to the host): on the leaf's
    device with ``on_device``, else on the host, pinned for a CUDA
    leaf."""
    if on_device:
        return torch.empty(n, dtype=first.dtype, device=first.device), False
    staged = first.device.type == "cuda"
    return torch.empty(n, dtype=first.dtype, pin_memory=staged), staged


def pack_bucket(leaves, indices, on_device: bool = False) -> torch.Tensor:
    """One contiguous 1-D tensor holding the raveled members of a bucket,
    in order. On the host by default: CUDA leaves are copied into a pinned
    buffer without blocking, and the current stream is synchronised once,
    so the buffer is complete when this returns. With ``on_device`` (for a
    group that keeps device tensors, ``collective.keeps_device``) the
    buffer is on the leaves' device and nothing crosses to the host."""
    first = leaves[indices[0]]
    out, staged = _pack_buffer(
        first, sum(_numel(leaves[i]) for i in indices), on_device)
    pos = 0
    for i in indices:
        flat = leaves[i].detach().reshape(-1)
        out[pos:pos + flat.numel()].copy_(flat, non_blocking=staged)
        pos += flat.numel()
    if staged:
        torch.cuda.current_stream(first.device).synchronize()
    return out


def pack_span(leaves, indices, lo: int, hi: int,
              on_device: bool = False) -> torch.Tensor:
    """Elements ``[lo, hi)`` of what ``pack_bucket(leaves, indices)``
    packs, copying only the pieces of the leaves that fall in the span (a
    rank's shard of the bucket). Placed as ``pack_bucket`` places it."""
    first = leaves[indices[0]]
    out, staged = _pack_buffer(first, hi - lo, on_device)
    pos = 0
    for i in indices:
        n = _numel(leaves[i])
        a, b = max(lo, pos), min(hi, pos + n)
        if a < b:
            out[a - lo:b - lo].copy_(
                leaves[i].detach().reshape(-1)[a - pos:b - pos],
                non_blocking=staged)
        pos += n
    if staged:
        torch.cuda.current_stream(first.device).synchronize()
    return out


def unpack_bucket(flat, leaves, indices, out_leaves) -> None:
    """Scatter one reduced bucket back into per-leaf tensors, shaped like
    the original leaves and on their devices; writes into ``out_leaves``
    at the bucket's indices. Where ``flat`` lies on a leaf's device (the
    host, or the card for a device group) that output is a view of
    ``flat``."""
    pos = 0
    for i in indices:
        leaf = leaves[i]
        n = _numel(leaf)
        out_leaves[i] = flat[pos:pos + n].view(leaf.shape).to(
            leaf.device, non_blocking=True)
        pos += n


def shard_bounds(total: int, parts: int) -> list:
    """Split ``total`` elements into ``parts`` contiguous ``[lo, hi)``
    chunks; the first ``total % parts`` are one element longer. This is
    the split the collective group's reducescatter hands out
    (``torch.tensor_split``), so the shard map below and the wire agree on
    where each rank's shard of a bucket lives."""
    total = int(total)
    parts = max(1, int(parts))
    base, extra = divmod(total, parts)
    bounds = []
    lo = 0
    for r in range(parts):
        hi = lo + base + (1 if r < extra else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def plan_shard_map(leaves, plan, world: int) -> list:
    """Per-bucket shard map for ZeRO: one dict per bucket of ``plan``
    with its packed element count, its dtype and every rank's ``[lo, hi)``
    bounds. Depends only on leaf shapes and dtypes, the plan and the
    world size, so every rank derives the same map."""
    out = []
    for indices in plan:
        elems = sum(_numel(leaves[i]) for i in indices)
        out.append({
            "indices": list(indices),
            "elems": elems,
            "dtype": leaves[indices[0]].dtype,
            "bounds": shard_bounds(elems, world),
        })
    return out


def plan_fingerprint(leaves, plan) -> str:
    """sha256 hex digest of the plan's identity: each leaf's (shape,
    dtype) in flatten order, then the plan's bucket membership. It does
    not depend on the world size, so a gang restarting at another size
    derives the same fingerprint from the same model. Equal to
    ``ray_tpu``'s for the same tree."""
    h = hashlib.sha256()
    for leaf in leaves:
        shape = tuple(int(d) for d in getattr(leaf, "shape", ()))
        h.update(repr((shape, dtype_name(leaf))).encode())
    for indices in plan:
        h.update(repr(tuple(indices)).encode())
    return h.hexdigest()


def reslice_spans(elems: int, old_world: int, new_world: int,
                  new_rank: int) -> list:
    """Which spans of which old ranks' shards of one packed bucket
    concatenate into new rank ``new_rank``'s shard:
    ``[(old_rank, old_lo, old_hi), ...]`` in order, each indexing into
    that old rank's shard."""
    new_lo, new_hi = shard_bounds(elems, new_world)[int(new_rank)]
    spans = []
    for old_rank, (old_lo, old_hi) in enumerate(
            shard_bounds(elems, old_world)):
        lo = max(new_lo, old_lo)
        hi = min(new_hi, old_hi)
        if lo < hi:
            spans.append((old_rank, lo - old_lo, hi - old_lo))
    return spans


def axis_size(mesh, axis: Optional[str]) -> int:
    """How many ways ``axis`` splits the work on ``mesh``, a
    ``parallel.mesh.MeshConfig`` or ``RankLayout``: 1 for None or an axis
    of size 1."""
    if axis is None:
        return 1
    return getattr(mesh, "config", mesh).axis_sizes().get(axis, 1)
