"""Transformer building blocks. Port of ``ray_tpu/models/layers.py``.

Parameters are plain nested dicts of tensors with the JAX package's keys,
shapes and dtypes; layers are functions over them. Compute is bf16 by
default with f32 params and accumulators. The memory-lean custom VJPs
(``layer_norm``, the MLP) are ``torch.autograd.Function``s that save the
same residuals as the JAX rules. The routed MoE layer (``apply_moe``)
mirrors the JAX package's dense-dispatch einsums; given a rank layout's
dp, ep, sp and tp groups it routes the whole batch and runs the rank's
block of the experts and of their hidden (``parallel/expert_parallel.py``,
and the boundaries of ``parallel/tensor_parallel.py`` over ep and tp). ``apply_attention``'s
``"ring_local"`` runs the per-shard ring over a rank's ``sp`` group
inside a pipeline stage, and its ``"ring"`` the ring over global arrays
(plain attention at sp 1).
Given a ``tp_group``, attention and the MLP run on a rank's block of the
heads or of the hidden (``parallel/tensor_parallel.py``): the input is
copied to the group, the output projection's f32 partials are summed
over it, and the MLP's ``b2`` is added once, after the sum.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.parallel import expert_parallel as ep_
from ray_tpu_torch.parallel.ring_attention import (reference_attention,
                                                   ring_attention,
                                                   ring_attention_stage)
from ray_tpu_torch.parallel.tensor_parallel import (copy_to_group,
                                                     reduce_over_group)

Params = Dict[str, Any]


def _init_dense(generator: torch.Generator, shape, device, scale=0.02,
                dtype=torch.float32):
    x = torch.randn(shape, generator=generator, device=generator.device)
    return (x * scale).to(device=device, dtype=dtype)


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (2-D, or 3-D batched) with an f32 result accumulated in f32
    from operands in their own dtype: ``preferred_element_type=float32``.
    On the card a bf16 product takes ``torch.mm``'s (``torch.bmm``'s)
    ``out_dtype`` overload; that overload has no CPU kernel, so on the CPU
    the operands, already rounded to their dtype, are upcast (the same
    products, exactly)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        mm = torch.mm if a.dim() == 2 else torch.bmm
        return mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _MatmulF32Out(torch.autograd.Function):
    """a [..., N, d] . b[..., V, d]^T -> [..., N, V] f32 from
    compute-dtype operands (2-D, or 3-D batched). The backward rounds the
    cotangent to the operands' dtype and multiplies in that dtype with
    f32 accumulation."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return mm_f32(a, b.transpose(-1, -2))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        gc = g.to(a.dtype)
        return gc @ b, gc.transpose(-1, -2) @ a


def matmul_nt_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., N, d] . b [..., V, d]^T -> [..., N, V] f32, differentiable
    (``_MatmulF32Out``)."""
    return _MatmulF32Out.apply(a, b)


# --------------------------------------------------------------- layer norm
class _LayerNorm(torch.autograd.Function):
    """Saves (x, mu, rstd, scale) and recomputes x-hat in the backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        x32 = x.float()
        mu = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, correction=0)
        rstd = torch.rsqrt(var + eps)
        y = (x32 - mu) * rstd
        ctx.save_for_backward(x, mu, rstd, scale)
        return (y * scale + bias).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, mu, rstd, scale = ctx.saved_tensors
        dy32 = dy.float()
        xhat = (x.float() - mu) * rstd
        reduce_dims = tuple(range(x.dim() - 1))
        dscale = (dy32 * xhat).sum(dim=reduce_dims)
        dbias = dy32.sum(dim=reduce_dims)
        t = dy32 * scale
        dx = rstd * (t - t.mean(dim=-1, keepdim=True)
                     - xhat * (t * xhat).mean(dim=-1, keepdim=True))
        return (dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype),
                None)


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm in f32 (population variance) returning x's dtype."""
    return _LayerNorm.apply(x, scale, bias, eps)


# ---------------------------------------------------------------- attention
def init_attention(generator, d_model, n_head, dtype=torch.float32, *,
                   device: DeviceLike = None, lead: Tuple[int, ...] = ()):
    """``lead`` prepends dims to every leaf (``(n_layer,)`` for a stack)."""
    dev = resolve_device(device)
    head_dim = d_model // n_head
    qkv = (*lead, d_model, n_head, head_dim)
    return {
        "wq": _init_dense(generator, qkv, dev, dtype=dtype),
        "wk": _init_dense(generator, qkv, dev, dtype=dtype),
        "wv": _init_dense(generator, qkv, dev, dtype=dtype),
        "wo": _init_dense(generator, (*lead, n_head, head_dim, d_model), dev,
                          dtype=dtype),
    }


# The JAX package's logical axes of each leaf, as plain data.
ATTENTION_LOGICAL = {
    "wq": ("embed", "heads", "head_dim"),
    "wk": ("embed", "heads", "head_dim"),
    "wv": ("embed", "heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed"),
}


def apply_attention(params: Params, x: torch.Tensor, *, causal: bool = True,
                    impl: str = "reference",
                    compute_dtype=torch.bfloat16, sp_group: str = None,
                    tp_group: str = None, tape=None) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]. impl: "reference" (plain PyTorch),
    "flash" (the Hopper kernels on CUDA tensors), "ring_local" (x is
    this rank's shard of the sequence and attention runs around the ring
    of ``sp_group``; with gradients, only inside a pipeline stage, on its
    ``tape``: see ``parallel.ring_attention.ring_attention_stage``) or
    "ring" (x is the whole sequence, as the JAX package's "ring" takes
    global arrays: over an ``sp_group`` of more than one rank each rank
    runs its shard around the ring and the shards' outputs are gathered,
    without gradients, since a stage runs "ring_local" on its tape for
    them; at sp 1, or without a group, the one shard's attention, which
    is plain attention, "reference"'s). The
    q/k/v/o projections are plain matmuls in the compute dtype. With
    ``tp_group`` the leaves hold this rank's block of the heads, and x
    enters and the output leaves through the group's boundaries on
    ``tape``: the o-projection's f32 partials are summed over the group,
    then rounded to x's dtype."""
    cd = compute_dtype
    B, S, D = x.shape
    _, H, K = params["wq"].shape
    out_dtype = x.dtype
    if tp_group is not None:
        (x,) = copy_to_group((x,), tp_group, tape)
    xc = x.to(cd)

    def project(w):
        return (xc @ w.to(cd).reshape(D, H * K)).view(B, S, H, K)

    q, k, v = project(params["wq"]), project(params["wk"]), project(params["wv"])
    if impl == "flash":
        o = flash_attention(q, k, v, causal=causal)
    elif impl == "reference":
        o = reference_attention(q, k, v, causal=causal)
    elif impl == "ring_local":
        o = ring_attention_stage(q, k, v, group=sp_group, tape=tape,
                                 causal=causal)
    elif impl == "ring":
        if ep_.group_place(sp_group)[0] == 1:
            o = reference_attention(q, k, v, causal=causal)
        elif torch.is_grad_enabled() and q.requires_grad:
            raise ValueError(
                "ring attention over global arrays runs without gradients; "
                "with them a stage runs 'ring_local' on its shard and tape "
                "(gpt2.forward_pipelined)")
        else:
            o = ring_attention(q, k, v, group=sp_group, causal=causal)
    else:
        raise ValueError(f"attention impl {impl!r} is not ported; use "
                         f"'flash', 'reference', 'ring' or 'ring_local'")
    o = o.to(cd).reshape(B, S, H * K)
    wo = params["wo"].to(cd).reshape(H * K, D)
    if tp_group is None:
        return (o @ wo).to(out_dtype)
    partial = matmul_nt_f32(o.reshape(B * S, H * K), wo.t()).view(B, S, D)
    return reduce_over_group(partial, tp_group, tape).to(out_dtype)


# ---------------------------------------------------------------- dense MLP
def init_mlp(generator, d_model, d_ff, dtype=torch.float32, *,
             device: DeviceLike = None, lead: Tuple[int, ...] = ()):
    dev = resolve_device(device)
    return {
        "w1": _init_dense(generator, (*lead, d_model, d_ff), dev, dtype=dtype),
        "b1": torch.zeros((*lead, d_ff), dtype=dtype, device=dev),
        "w2": _init_dense(generator, (*lead, d_ff, d_model), dev, dtype=dtype),
        "b2": torch.zeros((*lead, d_model), dtype=dtype, device=dev),
    }


MLP_LOGICAL = {
    "w1": ("embed", "mlp"),
    "b1": ("mlp",),
    "w2": ("mlp", "embed"),
    "b2": ("embed",),
}


def _gelu(u):
    return F.gelu(u, approximate="tanh")  # jax.nn.gelu's default


def _mlp_compute(x, w1, b1, w2, b2, cd):
    """Matmul outputs and bias adds stay in the compute dtype. Without
    ``b2`` (a rank's block of the hidden under tp) the output is the
    second matmul's f32 partial, with no bias."""
    u = x.to(cd) @ w1.to(cd) + b1.to(cd)
    if b2 is None:
        g = _gelu(u)
        o = mm_f32(g.reshape(-1, g.shape[-1]), w2.to(cd))
        return o.view(*g.shape[:-1], -1), u
    o = _gelu(u) @ w2.to(cd) + b2.to(cd)
    return o, u


class _LeanMLP(torch.autograd.Function):
    """2-layer GELU MLP that saves only (x, w1, w2, u), u the
    pre-activation, and recomputes gelu and its derivative in the
    backward. dw1 and dw2 accumulate in f32; the bias grads sum in f32.
    ``b2`` None: the f32 partial of ``_mlp_compute``."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, cd):
        o, u = _mlp_compute(x, w1, b1, w2, b2, cd)
        ctx.save_for_backward(x, w1, w2, u)
        ctx.cd = cd
        return o

    @staticmethod
    def backward(ctx, do):
        x, w1, w2, u = ctx.saved_tensors
        cd = ctx.cd
        do = do.to(cd)
        g = _gelu(u)
        x2 = x.reshape(-1, x.shape[-1])
        do2 = do.reshape(-1, do.shape[-1])
        g2 = g.reshape(-1, g.shape[-1])
        dg = do @ w2.to(cd).t()
        dw2 = mm_f32(g2.t(), do2)
        du = torch.ops.aten.gelu_backward(dg, u, approximate="tanh")
        du2 = du.reshape(-1, du.shape[-1])
        dw1 = mm_f32(x2.to(cd).t(), du2)
        dx = du @ w1.to(cd).t()
        db1 = du2.float().sum(dim=0)
        db2 = do2.float().sum(dim=0) if ctx.needs_input_grad[4] else None
        return (dx.to(x.dtype), dw1.to(w1.dtype), db1.to(w1.dtype),
                dw2.to(w2.dtype), None if db2 is None else db2.to(w2.dtype),
                None)


def apply_mlp(params: Params, x, compute_dtype=torch.bfloat16, *,
              tp_group: str = None, tape=None):
    """x: [B, S, D] -> [B, S, D]. With ``tp_group`` the leaves hold this
    rank's block of the hidden (``w1``, ``b1``, ``w2``; ``b2`` whole): x
    enters through the group's copy on ``tape``, the f32 partials are
    summed over the group and rounded to the compute dtype, and ``b2`` is
    added once, after the sum, so that every rank adds it and its grad is
    the same on every rank."""
    if tp_group is None:
        out = _LeanMLP.apply(x, params["w1"], params["b1"], params["w2"],
                             params["b2"], compute_dtype)
        return out.to(x.dtype)
    (h,) = copy_to_group((x,), tp_group, tape)
    partial = _LeanMLP.apply(h, params["w1"], params["b1"], params["w2"],
                             None, compute_dtype)
    cd = compute_dtype
    out = (reduce_over_group(partial, tp_group, tape).to(cd)
           + params["b2"].to(cd))
    return out.to(x.dtype)


# ---------------------------------------------------------------- MoE
@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25


def init_moe(generator, d_model, d_ff, cfg: MoEConfig, dtype=torch.float32,
             *, device: DeviceLike = None, lead: Tuple[int, ...] = ()):
    """The router ``wg [d, E]`` and the experts' ``w1 [E, d, f]`` and
    ``w2 [E, f, d]``, with ``lead`` prepended (``(n_layer,)`` for a
    stack)."""
    dev = resolve_device(device)
    E = cfg.n_experts
    return {
        "wg": _init_dense(generator, (*lead, d_model, E), dev, dtype=dtype),
        "w1": _init_dense(generator, (*lead, E, d_model, d_ff), dev,
                          dtype=dtype),
        "w2": _init_dense(generator, (*lead, E, d_ff, d_model), dev,
                          dtype=dtype),
    }


# The JAX package's logical axes of each leaf, as plain data: the experts'
# leading dim is what expert parallelism shards.
MOE_LOGICAL = {
    "wg": ("embed", None),
    "w1": ("experts", "embed", "expert_mlp"),
    "w2": ("experts", "expert_mlp", "embed"),
}


def moe_capacity(cfg: MoEConfig, n_tokens: int) -> int:
    """Slots an expert holds for ``n_tokens`` (B*S) tokens, with the JAX
    package's factors in its order."""
    return max(1, int(cfg.capacity_factor * cfg.top_k * n_tokens
                      / cfg.n_experts))


def router_probs(wg: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The router's softmax over the experts, in f32: x [B, S, D] ->
    probs [B, S, E]."""
    return torch.softmax(x.float() @ wg.float(), dim=-1)


def _route(probs: torch.Tensor, cfg: MoEConfig, dp_group=None,
           sp_group=None, tape=None):
    """(gates, experts, slots, the top-1 fractions ``ce`` [E]) from
    ``probs``; at dp > 1 or sp > 1 the slots and ``ce`` are the whole
    batch's (``route_tokens``), counted once on ``tape``
    (``StageTape.once``: a remat's recompute reuses the counts)."""
    B, S, E = probs.shape
    K = cfg.top_k
    gates, experts = torch.topk(probs, K, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # the count runs along the inner dim of [E, B*S*K]: on the card a scan
    # down the 8 columns of [B*S*K, E] took 3 ms a layer at B*S 8192
    onehot = F.one_hot(experts.reshape(-1), E).t().contiguous()
    top1 = F.one_hot(experts[..., 0], E)
    n_dp, _ = ep_.group_place(dp_group)
    n_sp, _ = ep_.group_place(sp_group)
    if n_dp * n_sp == 1:
        pos = onehot.cumsum(dim=1) - 1
        ce = (top1.float().sum(dim=1) / S).mean(dim=0)
    else:
        # each row counted apart, then re-based on the pairs before it in
        # the whole stream: the rows before it on every replica and shard,
        # and its own pairs on the shards before this one
        pos = onehot.view(E, B, S * K).cumsum(dim=2) - 1
        args = (pos[:, :, -1].t() + 1, top1.sum(dim=(0, 1)), dp_group,
                sp_group)
        before, top1 = (ep_.route_counts(*args) if tape is None
                        else tape.once(ep_.route_counts, *args))
        pos = (pos + before.t().unsqueeze(-1)).view(E, B * S * K)
        ce = top1.float() / (n_dp * B * n_sp * S)
    slots = pos.gather(0, experts.reshape(1, -1)).view(B, S, K)
    return gates, experts, slots, ce


def route_tokens(wg: torch.Tensor, x: torch.Tensor, cfg: MoEConfig, *,
                 dp_group: str = None, sp_group: str = None):
    """The router, in f32: x [B, S, D] -> (probs [B, S, E], gates [B, S, K]
    renormalized with max(sum, 1e-9), experts [B, S, K], slots [B, S, K]).
    A (token, k) pair's slot is its place in its expert's buffer, counted
    over the whole flattened token stream in (b, s, k) order; a slot at or
    past ``moe_capacity`` of the whole batch is dropped. With ``dp_group``
    or ``sp_group`` (of size > 1), x is one rank's block of a batch cut as
    ``P("dp", "sp")`` cuts it, its replica's rows and its shard of the
    sequence, and a slot also counts the pairs before it in the whole
    stream: the rows of the replicas before it, and in each row the
    shards before this one (``expert_parallel.route_counts``, forward
    only)."""
    probs = router_probs(wg, x)
    return (probs, *_route(probs, cfg, dp_group, sp_group)[:3])


def apply_moe(params: Params, x: torch.Tensor, cfg: MoEConfig,
              compute_dtype=torch.bfloat16, *, dp_group: str = None,
              ep_group: str = None, sp_group: str = None,
              tp_group: str = None,
              tape=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard-style top-k routed MoE with capacity, over dense-dispatch
    einsums: x [B, S, D] -> (out [B, S, D] in x's dtype, the Switch aux
    loss, an f32 scalar).

    ``disp [B, S, E, C]`` is 1 where token (b, s) holds slot c of expert
    e. It is written by a scatter-add into zeros where the JAX package
    sums one-hots: a token's experts are distinct, so the two agree, and a
    dropped pair adds JAX's zero row. ``gates_per_e`` is scattered the
    same way from the gates rounded to the compute dtype (JAX's sum over
    k of gate times one-hot, which adds exact zeros). The products are
    plain einsums in the compute dtype, with the casts where the JAX
    package makes them; ``combine`` carries the gradient to the router.

    On a rank of a layout, any of ``dp_group``, ``ep_group``, ``sp_group``
    and ``tp_group`` (of size > 1): x is the rank's replica's rows and its
    shard of the sequence (the same on its ep and tp groups), ``w1`` and
    ``w2`` its block of E / ep experts, cut at tp > 1 to its block of each
    expert's hidden. The router counts slots, the capacity and the aux
    loss's top-1 fractions ``ce`` over the whole batch (``_route``), so
    the same pairs are dropped as on one device. A slot holds one token of
    the whole batch, so an expert's input at a rank's slots is that rank's
    tokens alone and its output there reaches those tokens alone: the rank
    runs its experts on its own tokens, and nothing of the experts is
    summed over dp or sp. The aux loss ``E * sum(me * ce)`` takes ``me``
    from the rank's tokens: its mean over dp, as the train step averages
    it, and its sum over sp, as the pipelined backward sums the block
    leaves' grads over sp, are the whole batch's, and so is its gradient,
    so each sp rank returns its share, divided by sp.

    At ep > 1 or tp > 1 the layer runs on ``tape``. x and the gates enter
    the rank's experts by a copy whose backward sums over ep, and x then
    by one whose backward sums over tp; the gates need none over tp, whose
    ranks combine the same whole ``expert_out``. At tp > 1 ``expert_out``
    is the sum over tp of each rank's f32 product over its block of the
    hidden, rounded once after the sum, as the one-device einsum rounds
    it. The output is, at ep > 1, the sum over ep of each rank's combine
    over its own experts, an f32 product rounded once after the sum
    (``tensor_parallel``'s boundaries). The router reads x before the
    copies, each tp and ep rank the whole router: its gradient is whole
    on every rank, summed over neither group. Given a ``tape``, at any
    layout, the tape cuts x and the router's probs, so that the aux loss
    (the caller's term of the tape, differentiated with the stage's
    output), the gates' copy and x's copies reach them by separate
    autograd segments, and no segment runs through a graph another has
    run through."""
    cd = compute_dtype
    B, S, D = x.shape
    E = cfg.n_experts
    n_dp, _ = ep_.group_place(dp_group)
    n_ep, ep_rank = ep_.group_place(ep_group)
    n_sp, _ = ep_.group_place(sp_group)
    n_tp, _ = ep_.group_place(tp_group)
    E_l = params["w1"].shape[0]
    if E_l * n_ep != E:
        raise ValueError(
            f"params hold {E_l} experts; a rank of ep={n_ep} holds "
            f"{E // n_ep} of {E} (sharding.tree_shard with "
            f"gpt2.partition_specs)")
    if (n_ep > 1 or n_tp > 1) and tape is None:
        raise ValueError("apply_moe over an ep or a tp group communicates, "
                         "so it runs on a pipeline StageTape "
                         "(gpt2.forward_pipelined)")
    C = moe_capacity(cfg, n_dp * B * n_sp * S)
    out_dtype = x.dtype
    if tape is not None:
        x = tape.cut(x)
    probs = router_probs(params["wg"], x)
    if tape is not None:
        probs = tape.cut(probs)
    gates, experts, slots, ce = _route(probs, cfg, dp_group, sp_group, tape)

    # Switch load balancing: mean router prob per expert times the
    # fraction of tokens whose top-1 expert it is
    aux_loss = E * torch.sum(probs.mean(dim=(0, 1)) * ce) / n_sp
    if n_ep > 1:
        x, gates = copy_to_group((x, gates), ep_group, tape)
    if n_tp > 1:
        (x,) = copy_to_group((x,), tp_group, tape)

    # this rank's experts [lo, lo + E_l): a pair of another rank's
    # expert, or a dropped one, adds 0 (a token's experts are distinct, so
    # no slot of a token's row gets two 1s)
    lo = ep_rank * E_l
    mine = (experts >= lo) & (experts < lo + E_l)
    local = (experts - lo).clamp(0, E_l - 1)
    disp = torch.zeros(B, S, E_l * C, dtype=cd, device=x.device)
    disp.scatter_add_(-1, local * C + slots.clamp(max=C - 1),
                      (mine & (slots < C)).to(cd))
    disp = disp.view(B, S, E_l, C)
    gates_per_e = torch.zeros(B, S, E_l, dtype=cd, device=x.device
                              ).scatter_add(-1, local,
                                            torch.where(mine, gates.to(cd), 0))
    combine = disp * gates_per_e.unsqueeze(-1)

    expert_in = torch.einsum("bsec,bsd->ecd", disp, x.to(cd))
    h = _gelu(torch.einsum("ecd,edf->ecf", expert_in, params["w1"].to(cd)))
    if n_tp == 1:
        expert_out = torch.einsum("ecf,efd->ecd", h, params["w2"].to(cd))
    else:
        partial = matmul_nt_f32(h, params["w2"].to(cd).transpose(1, 2))
        expert_out = reduce_over_group(partial, tp_group, tape).to(cd)
    if n_ep == 1:
        out = torch.einsum("bsec,ecd->bsd", combine, expert_out)
    else:
        partial = matmul_nt_f32(combine.view(B * S, E_l * C),
                                expert_out.reshape(E_l * C, D).t())
        out = reduce_over_group(partial.view(B, S, D), ep_group,
                                tape).to(cd)
    return out.to(out_dtype), aux_loss
