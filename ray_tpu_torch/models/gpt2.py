"""GPT-2 family. Port of ``ray_tpu/models/gpt2.py``.

Parameters are the JAX package's tree: stacked ``[n_layer, ...]`` block
leaves, f32, with bf16 compute. The forward loops over the stacked
leaves; ``remat`` maps to ``torch.utils.checkpoint`` on one device and to
``StageTape.checkpoint`` on a rank layout. Architecture: learned
positional embeddings, pre-LN blocks, GELU MLP, tied LM head; with
``moe`` set, every block's MLP is the routed MoE layer and the forward
returns its aux loss, averaged over the layers.

The pipelined forward (``forward_pipelined``) runs on every rank of a
``dp`` x ``pp`` x ``ep`` x ``sp`` x ``tp`` layout (``parallel/mesh.py``),
each holding its stage's ``[n_layer / pp, ...]`` slice of the block
leaves and the embedding and final LayerNorm (``convert.stage_params``),
cut at tp > 1 to the rank's block of the heads, the MLP hidden and the
vocab, and at ep > 1 to its block of the experts
(``parallel.sharding.tree_shard`` with ``partition_specs``). Stage 0
embeds, the block stack runs under GPipe (``parallel/pipeline.py``) and
the last stage unembeds; at ``sp`` > 1 each rank holds a contiguous shard
of the sequence and attention is ``"ring_local"``, whatever
``cfg.attention`` names; at ``tp`` > 1 the
collectives of ``parallel/tensor_parallel.py`` join the blocks; with MoE
(pp 1 only) the router counts over the whole batch (over dp and sp) and
the experts run over ep and their hidden over tp
(``parallel/expert_parallel.py`` and ``parallel/tensor_parallel.py``'s
boundaries over the ep and tp groups). Its
gradient is a schedule, not autograd through the collectives:
``value_and_grad_pipelined``, or ``PipelinedForward.backward``; with
``remat`` each layer is a checkpointed region of the stage's tape, rerun
in that schedule.

``loss_fn(..., layout)`` and ``forward(..., layout)`` are the JAX
package's ``loss_fn(..., mesh)`` and ``forward(..., mesh)``: on a rank
layout of more than one rank they run ``forward_pipelined`` (at one
microbatch unless ``pipelined``), and inside a train step that asks for
the gradient (``pipeline.scheduled_gradients``) ``loss_fn`` computes it by
``value_and_grad_pipelined`` and hands it over; on a mesh of one rank
they are the one-device functions.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch._private.tree import tree_leaves, tree_map, tree_unflatten
from ray_tpu_torch.models import layers as L
from ray_tpu_torch.parallel import pipeline
from ray_tpu_torch.parallel import sharding as sh
from ray_tpu_torch.parallel import tensor_parallel
from ray_tpu_torch.parallel.mesh import rank_layout
from ray_tpu_torch.parallel.pipeline import (StageTape, gpipe_local,
                                             microbatch, stack_stage_params,
                                             unmicrobatch)
from ray_tpu_torch.parallel.ring_attention import shard_bounds
from ray_tpu_torch.train import ddp
from ray_tpu_torch.util import collective as col


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50304  # 50257 rounded up to a 128 multiple
    max_seq: int = 1024
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_ff: int = 0  # 0 -> 4 * d_model
    moe: Optional[L.MoEConfig] = None  # if set, every block's MLP is routed
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    attention: str = "auto"  # auto | flash | reference | ring
    aux_loss_weight: float = 0.01

    @property
    def ff(self) -> int:
        return self.d_ff or 4 * self.d_model

    @property
    def n_params(self) -> int:
        """Parameter count (for MFU math)."""
        d, f, l, v = self.d_model, self.ff, self.n_layer, self.vocab_size
        per_block = 4 * d * d + (2 * d * f + d + f) + 4 * d  # attn + mlp + lns
        if self.moe:
            per_block += self.moe.n_experts * 2 * d * f - (2 * d * f + d + f)
        return v * d + self.max_seq * d + l * per_block + 2 * d


# Presets (public GPT-2 sizes).
def gpt2_small():
    return GPT2Config(n_layer=12, n_head=12, d_model=768)


def gpt2_medium():
    return GPT2Config(n_layer=24, n_head=16, d_model=1024)


def gpt2_large():
    return GPT2Config(n_layer=36, n_head=20, d_model=1280)


def gpt2_xl():
    return GPT2Config(n_layer=48, n_head=25, d_model=1600)


def gpt2_tiny():
    """Test-sized config."""
    return GPT2Config(
        vocab_size=256, max_seq=128, n_layer=2, n_head=4, d_model=64, remat=False
    )


# ------------------------------------------------------------------ params
def init(generator: torch.Generator, cfg: GPT2Config, device: DeviceLike = None):
    """Random parameters from ``generator``, on ``device`` (CUDA by
    default). The draws are made on the generator's device."""
    dev = resolve_device(device)
    pd = cfg.param_dtype
    lead = (cfg.n_layer,)

    def ln():
        return {"scale": torch.ones(lead + (cfg.d_model,), dtype=pd, device=dev),
                "bias": torch.zeros(lead + (cfg.d_model,), dtype=pd, device=dev)}

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (x * std).to(device=dev, dtype=pd)

    wte = normal((cfg.vocab_size, cfg.d_model), 0.02)
    wpe = normal((cfg.max_seq, cfg.d_model), 0.01)
    blocks = {
        "ln1": ln(),
        "attn": L.init_attention(generator, cfg.d_model, cfg.n_head, pd,
                                 device=dev, lead=lead),
        "ln2": ln(),
    }
    if cfg.moe:
        blocks["moe"] = L.init_moe(generator, cfg.d_model, cfg.ff, cfg.moe,
                                   pd, device=dev, lead=lead)
    else:
        blocks["mlp"] = L.init_mlp(generator, cfg.d_model, cfg.ff, pd,
                                   device=dev, lead=lead)
    final_ln = {"scale": torch.ones(cfg.d_model, dtype=pd, device=dev),
                "bias": torch.zeros(cfg.d_model, dtype=pd, device=dev)}
    return {"wte": wte, "wpe": wpe, "blocks": blocks, "ln_f": final_ln}


def logical_axes(cfg: GPT2Config):
    """Tree of logical-axis names matching ``init``'s. Stacked block leaves
    get a leading ``"layers"`` axis, whole on every rank (the pipeline cuts
    the stages itself, ``convert.stage_params``)."""
    ln = {"scale": ("embed",), "bias": ("embed",)}
    block = {"ln1": ln, "attn": dict(L.ATTENTION_LOGICAL), "ln2": ln}
    if cfg.moe:
        block["moe"] = dict(L.MOE_LOGICAL)
    else:
        block["mlp"] = dict(L.MLP_LOGICAL)
    return {
        "wte": ("vocab", "embed"),
        "wpe": (None, "embed"),
        "blocks": tree_map(lambda names: ("layers",) + tuple(names), block),
        "ln_f": ln,
    }


def partition_specs(cfg: GPT2Config, rules=None):
    """One spec a leaf (``parallel.sharding.spec``): under the default
    rules ``wq``/``wk``/``wv`` on heads, ``wo`` on its first non-layer
    axis, ``w1``/``b1``/``w2`` on the MLP hidden and ``wte`` on the vocab
    ride tp; the LayerNorms, ``b2`` and ``wpe`` are whole."""
    return tree_map(lambda names: sh.spec(*names, rules=rules),
                    logical_axes(cfg))


# ----------------------------------------------------------------- forward
def _resolve_attention(cfg: GPT2Config, device: torch.device) -> str:
    """``"auto"`` is ``"flash"`` on a CUDA device and ``"reference"``
    elsewhere, as ``ray_tpu``'s is ``"flash"`` on a TPU. The hand-written
    kernels take bf16, f32 and float16 at any head dim (padded up to the
    head dim a kernel is built for, ``gpt2_tiny``'s 16 among them; above
    256 the split-head-dim kernels); their wrappers refuse anything else
    before a launch."""
    if cfg.attention != "auto":
        return cfg.attention
    return "flash" if device.type == "cuda" else "reference"


def _block_apply(block, x, cfg: GPT2Config, impl: str, sp_group=None,
                 tp_group=None, tape=None, dp_group=None, ep_group=None):
    """(the block's output, its MoE aux loss, or None without MoE).
    ``sp_group`` and ``tape``: ``"ring_local"``'s (``apply_attention``);
    ``tp_group`` and ``tape``: the block's leaves hold this rank's block
    of the heads and the hidden (the experts' hidden with MoE);
    ``dp_group`` and ``sp_group``: the MoE router counts the whole batch;
    ``ep_group`` and ``tape``: the MoE layer runs the rank's block of the
    experts (``apply_moe``). With ``tp_group``, ``ep_group`` or MoE on a
    ``tape``, the residual after attention is cut on the tape, so that the
    MLP's or the MoE's segments (the aux loss's among them) and the
    output's reach it apart."""
    cd = cfg.dtype
    h = L.layer_norm(x, block["ln1"]["scale"], block["ln1"]["bias"])
    x = x + L.apply_attention(block["attn"], h, causal=True, impl=impl,
                              compute_dtype=cd, sp_group=sp_group,
                              tp_group=tp_group, tape=tape)
    if tape is not None and (tp_group is not None or ep_group is not None
                             or cfg.moe is not None):
        x = tape.cut(x)
    h = L.layer_norm(x, block["ln2"]["scale"], block["ln2"]["bias"])
    if cfg.moe:
        m, aux = L.apply_moe(block["moe"], h, cfg.moe, compute_dtype=cd,
                             dp_group=dp_group, ep_group=ep_group,
                             sp_group=sp_group, tp_group=tp_group, tape=tape)
        return x + m, aux
    return x + L.apply_mlp(block["mlp"], h, compute_dtype=cd,
                           tp_group=tp_group, tape=tape), None


def embed(params, tokens, cfg: GPT2Config, position_offset: int = 0, *,
          tp_group=None, tape=None):
    """Token + position embedding, cast to the compute dtype: the residual
    stream is bf16 by default. ``tokens`` sit at positions
    ``position_offset`` on (a shard of the sequence). With ``tp_group``
    ``wte`` is this rank's block of the vocab: the rows are summed over
    the group on ``tape``, then ``wpe`` is added once."""
    S = tokens.shape[1]
    wpe = params["wpe"][position_offset:position_offset + S]
    if tp_group is None:
        rows = F.embedding(tokens.long(), params["wte"])
    else:
        rows = tensor_parallel.vocab_parallel_embedding(
            tokens, params["wte"], tp_group, tape)
    return (rows + wpe).to(cfg.dtype)


def unembed(params, x, cfg: GPT2Config, *, tp_group=None, tape=None):
    """Final LayerNorm, then the tied vocab projection: bf16 operands, f32
    logits. With ``tp_group`` the normed x enters the group's copy on
    ``tape`` and the logits are this rank's block of the vocab's."""
    x = L.layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])
    if tp_group is not None:
        (x,) = tensor_parallel.copy_to_group((x,), tp_group, tape)
    B, S, D = x.shape
    cd = cfg.dtype
    logits = L.matmul_nt_f32(x.to(cd).reshape(B * S, D),
                             params["wte"].to(cd))
    return logits.view(B, S, -1)


def forward(params, tokens, cfg: GPT2Config, layout=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V] f32, the MoE aux loss summed over
    the layers over n_layer: an f32 scalar, 0 without MoE).

    On a rank ``layout`` of several ranks (the JAX package's ``forward(...,
    mesh)``), at pp 1, values only: ``tokens`` are the rows of the rank's
    dp replica and ``params`` its tree (``train_step.make_train_state``
    with the layout); the logits of the replica's rows, put back together
    over sp and tp, come back on every rank of the replica, with the
    replica's aux loss. Its gradient is ``value_and_grad_pipelined``'s."""
    layout = rank_layout(layout)[0]
    if layout is not None:
        return _forward_on_layout(params, tokens, cfg, layout)
    impl = _resolve_attention(cfg, tokens.device)
    x = embed(params, tokens, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    # One unbind per stacked leaf: its backward stacks the layers' grads in
    # one pass, where indexing leaf[i] per layer would zero-fill and add a
    # full [n_layer, ...] gradient for every layer.
    layers = tree_map(lambda leaf: leaf.unbind(0), params["blocks"])
    for i in range(cfg.n_layer):
        block = tree_map(lambda per_layer: per_layer[i], layers)
        if cfg.remat:
            x, a = checkpoint(_block_apply, block, x, cfg, impl,
                              use_reentrant=False)
        else:
            x, a = _block_apply(block, x, cfg, impl)
        if a is not None:
            aux = aux + a
    logits = unembed(params, x, cfg)
    return logits, aux / cfg.n_layer


def _forward_on_layout(params, tokens, cfg: GPT2Config, layout):
    if layout.pp > 1:
        raise ValueError("forward(..., layout) runs at pp 1; at pp > 1 the "
                         "logits are the last stage's: forward_pipelined")
    with torch.no_grad():
        fwd = forward_pipelined(params, tokens, cfg, layout,
                                n_microbatches=1)
        logits = fwd.logits
        for axis, dim in (("tp", -1), ("sp", 1)):
            if getattr(layout, axis) > 1:
                parts = col.allgather(logits, getattr(layout,
                                                      f"{axis}_group"))
                logits = torch.cat([t.to(logits.device) for t in parts],
                                   dim=dim)
    return logits, fwd.aux


def _token_losses(logits, targets):
    """-log p(target) = logsumexp(logits) - logits[target], without
    materializing log_softmax."""
    lse = torch.logsumexp(logits, dim=-1)
    tl = logits.gather(-1, targets.long().unsqueeze(-1)).squeeze(-1)
    return lse - tl


def _metrics(loss, aux, cfg: GPT2Config):
    total = loss + cfg.aux_loss_weight * aux
    return total, {"loss": loss, "aux_loss": aux, "total_loss": total}


def loss_fn(params, batch, cfg: GPT2Config, layout=None, *,
            pipelined: bool = False, n_microbatches: int = 4):
    """batch: {"tokens" [B, S+1] integer}. Next-token cross-entropy, plus
    the MoE aux loss weighted by ``aux_loss_weight``.

    On a rank ``layout`` of several ranks (the JAX package's
    ``loss_fn(..., mesh)``), the loss of ``forward_pipelined``, in
    ``n_microbatches`` microbatches when ``pipelined``, else in one:
    every rank of a ``dp`` replica is given the replica's rows (the whole
    batch at dp 1; the train step cuts them by its ``batch_spec``) and
    returns the replica's values, whose mean over dp is the whole
    batch's. Inside a train step that asks for the gradient
    (``pipeline.scheduled_gradients``) it computes it by
    ``value_and_grad_pipelined``, a schedule rather than autograd, and
    hands it over with the parameters; elsewhere it runs without
    gradients. On a mesh or a layout of one rank it is the one-device
    loss."""
    tokens = batch["tokens"][:, :-1]
    targets = batch["tokens"][:, 1:]
    layout = rank_layout(layout)[0]
    if layout is not None:
        m = n_microbatches if pipelined else 1
        if pipeline.gradients_requested():
            (total, metrics), grads = value_and_grad_pipelined(
                params, batch, cfg, layout, n_microbatches=m)
            pipeline.hand_over_gradients(params, grads, total)
            return total, metrics
        with torch.no_grad():
            fwd = forward_pipelined(params, tokens, cfg, layout,
                                    n_microbatches=m)
            loss = _pipelined_loss(fwd, targets, layout)[0]
        return _metrics(loss, fwd.aux, cfg)
    logits, aux = forward(params, tokens, cfg)
    return _metrics(_token_losses(logits, targets).mean(), aux, cfg)


# --------------------------------------------------------------- pipelined
@dataclasses.dataclass
class PipelinedForward:
    """One rank's part of ``forward_pipelined``. ``logits``: ``[B,
    S_local, V / tp]`` f32 for this rank's shard of the sequence and block
    of the vocab on the last stage, attached to the graph of the unembed;
    None on the other stages. ``aux``: the MoE aux loss averaged over the
    layers, this replica's (``apply_moe``'s shares summed over sp: its
    mean over dp is the whole batch's), the same on every rank of the
    replica; 0 without MoE (which runs at pp 1 only).
    ``backward(value)``, called once on every rank with, on the last
    stage, the scalar this rank differentiates (its part of the loss,
    computed from ``logits``, the same on every rank of its tp group) and
    None elsewhere, returns the gradient of the sum over the last stage's
    sequence shards of their values, with respect to this rank's
    parameters: a tree like them, already summed over the ``pp`` and
    ``sp`` groups where JAX's ``psum`` transposes sum it (the embedding
    and final LayerNorm over both, the block leaves over ``sp``)."""

    logits: Optional[torch.Tensor]
    aux: torch.Tensor
    backward: Callable


def forward_pipelined(params, tokens, cfg: GPT2Config, layout, *,
                      n_microbatches: int = 4) -> PipelinedForward:
    """Pipeline-parallel forward on one rank of ``layout`` (a
    ``parallel.mesh.RankLayout``). ``params``: this rank's stage tree
    (``convert.stage_params``), at tp > 1 cut to its block
    (``sharding.tree_shard`` with ``partition_specs``). ``tokens`` ``[B,
    S]``: the rows of the rank's ``dp`` replica (the whole batch at dp 1;
    ``train_step.dp_rows``), the same on every rank of the replica; the
    rank takes its shard of the sequence. The groups it runs over (``pp``,
    ``sp``, ``tp``) are its replica's.

    Embed runs on stage 0 (``wpe`` at the shard's global positions), the
    blocks as GPipe over ``n_microbatches`` and the ``pp`` group, and the
    unembed on the last stage. Attention in the stages is
    ``"ring_local"`` at sp > 1 (each rank holds its shard of the
    sequence, whatever ``cfg.attention`` names), else
    ``_resolve_attention``'s (flash on a CUDA device), on the rank's
    heads.

    With MoE (pp 1 only) the whole replica is one microbatch, as the
    router counts its slots, capacity and top-1 fractions over the whole
    batch (over every replica and sequence shard), the experts ride ep
    and their hidden tp: the twin of the JAX package's ``forward(...,
    mesh)`` at pp 1. The aux loss of each layer is a term of the stage's
    tape (the rank's share of it at sp > 1), weighted as ``_metrics``
    weighs it. A dense model at ep > 1 runs as at ep 1 on every ep rank,
    as no leaf rides ep.

    With ``cfg.remat`` each layer is a checkpointed region of its stage's
    tape (``StageTape.checkpoint``, the twin of the JAX package's
    ``jax.checkpoint`` around the layer body): the stage keeps each
    layer's input and what its boundaries saved (the ring's q, k, v, o and
    lse; the tp and ep sums' outputs; the router's slot counts, which the
    recompute reuses rather than count again), and its backward reruns
    the layer's forward just before it differentiates it, on the rank's
    thread. The MoE aux loss leaves the region as an output.

    Refuses what the JAX twin refuses (``n_layer`` not divisible by pp,
    MoE at pp > 1) and MoE over more than one microbatch."""
    n_pp = layout.pp
    if cfg.n_layer % n_pp:
        raise ValueError(f"n_layer={cfg.n_layer} not divisible by pp={n_pp}")
    if cfg.moe is not None and n_pp > 1:
        # the GPipe carry is activations only: the MoE aux loss would be
        # dropped without a signal, as the JAX twin says
        raise NotImplementedError(
            "pipelined forward does not yet propagate the MoE aux loss; "
            "use pp=1 with MoE or a dense (non-MoE) config with pp>1")
    if cfg.moe is not None and n_microbatches != 1:
        raise ValueError(
            f"n_microbatches={n_microbatches}: MoE routes a replica's rows "
            f"as one batch (its slots and capacity are the whole batch's); "
            f"pass n_microbatches=1")
    impl = ("ring_local" if layout.sp > 1
            else _resolve_attention(cfg, tokens.device))
    tp_group = layout.tp_group if layout.tp > 1 else None
    dp_group = layout.dp_group if layout.dp > 1 else None
    ep_group = layout.ep_group if layout.ep > 1 else None
    per_stage = cfg.n_layer // n_pp
    lead = params["blocks"]["ln1"]["scale"].shape[0]
    if lead != per_stage:
        raise ValueError(f"params hold {lead} blocks; a stage of pp={n_pp} "
                         f"holds {per_stage} (convert.stage_params)")
    if params["wte"].shape[0] * layout.tp != cfg.vocab_size:
        raise ValueError(
            f"params hold {params['wte'].shape[0]} vocab rows; a rank of "
            f"tp={layout.tp} holds {cfg.vocab_size // layout.tp} "
            f"(sharding.tree_shard with gpt2.partition_specs)")
    grad = torch.is_grad_enabled()
    # each layer's leaves apart, so that each autograd segment of a stage
    # ends at its own layer's leaves
    layers = {f"{i:04d}": tree_map(
        lambda leaf: leaf[i].detach().requires_grad_(grad),
        params["blocks"]) for i in range(per_stage)}
    auxes = []

    def stage_fn(stage_layers, x, tape):
        for key in sorted(stage_layers):
            x = tape.cut(x)
            block = stage_layers[key]

            def layer(t, x, block=block):
                y, aux = _block_apply(block, x, cfg, impl, layout.sp_group,
                                      tp_group, t, dp_group, ep_group)
                return (y,) if aux is None else (y, aux)

            if cfg.remat:
                out = tape.checkpoint(layer, (x,), tree_leaves(block))
            else:
                out = layer(tape, x)
            x = out[0]
            auxes.extend(out[1:])
        if auxes:
            tape.add_term(sum(auxes) * (cfg.aux_loss_weight / cfg.n_layer))
        return x

    lo, hi = shard_bounds(tokens.shape[1], layout.sp, layout.sp_rank)
    # the embedding's and the unembedding's tp boundaries (none at tp 1)
    embed_tape, unembed_tape = StageTape(), StageTape()
    x = mb = None
    if layout.is_first_stage:
        x = embed(params, tokens[:, lo:hi], cfg, position_offset=lo,
                  tp_group=tp_group, tape=embed_tape)
        mb = microbatch(x, n_microbatches)
    run = gpipe_local(stage_fn, layers, mb, group=layout.pp_group,
                      n_microbatches=n_microbatches, replicate=False)
    y = logits = None
    if layout.is_last_stage:
        y = unmicrobatch(run.outputs).requires_grad_(grad)
        logits = unembed(params, y, cfg, tp_group=tp_group,
                         tape=unembed_tape)

    def backward(value):
        shared = {k: params[k] for k in ("ln_f", "wpe", "wte")}
        leaves = tree_leaves(shared)
        totals = [torch.zeros_like(p) for p in leaves]

        def add(got):
            for i, g in enumerate(got):
                if g is not None:
                    totals[i] += g

        g_mb = None
        if layout.is_last_stage:
            (g_y,), got = unembed_tape.backward(
                value, torch.ones_like(value), [y], leaves)
            add(got)
            g_mb = microbatch(g_y, n_microbatches)
        g_mb, layer_grads = run.backward(g_mb)
        if layout.is_first_stage:
            add(embed_tape.backward(x, unmicrobatch(g_mb), [], leaves)[1])
        # the embedding's and the unembedding's parts live on different
        # stages and the sequence's shards on different sp ranks: sum
        # them, as the transposes of JAX's psums do; the block leaves are
        # replicated over sp, their grads partial sums over its shards.
        # Each tp rank sums its own block.
        out = tree_unflatten(shared, totals)
        for group in (layout.pp_group, layout.sp_group):
            out = ddp.sync_gradients(out, group, mode="allreduce")
        out["blocks"] = ddp.sync_gradients(
            stack_stage_params([layer_grads[k] for k in sorted(layer_grads)]),
            layout.sp_group, mode="allreduce")
        return out

    aux = torch.zeros((), device=tokens.device)
    if auxes:
        # each sp rank's layers hold its share of the replica's aux loss
        aux = sum(a.detach() for a in auxes) / cfg.n_layer
        if layout.sp > 1:
            aux = col.allreduce(aux, layout.sp_group).to(aux.device)
    return PipelinedForward(logits, aux, backward)


def _pipelined_loss(fwd: PipelinedForward, targets, layout):
    """(the mean token loss over the whole batch and sequence, on every
    rank; this rank's part of it, attached to the logits, on the last
    stage, else None). At tp > 1 the token losses come from the ranks'
    blocks of the vocab (``tensor_parallel.vocab_parallel_token_losses``),
    the same on every rank of the group. The shards' parts are summed
    over ``sp`` and the sum broadcast from the last stage over ``pp``."""
    B, S = targets.shape
    part = None
    value = torch.zeros((), dtype=torch.float32, device=targets.device)
    if layout.is_last_stage:
        lo, hi = shard_bounds(S, layout.sp, layout.sp_rank)
        if layout.tp > 1:
            losses = tensor_parallel.vocab_parallel_token_losses(
                fwd.logits, targets[:, lo:hi], layout.tp_group)
        else:
            losses = _token_losses(fwd.logits, targets[:, lo:hi])
        part = losses.sum() / (B * S)
        value = part.detach()
        if layout.sp > 1:
            value = col.allreduce(value, layout.sp_group)
    if layout.pp > 1:
        value = col.broadcast(value, layout.pp - 1, layout.pp_group)
    return value.to(targets.device), part


def value_and_grad_pipelined(params, batch, cfg: GPT2Config, layout, *,
                             n_microbatches: int = 4):
    """The pipelined twin of ``jax.value_and_grad(loss_fn, has_aux=True)``
    with ``pipelined=True``: ((total, metrics), grads) on every rank of
    ``layout`` for ``batch``, the rows of its ``dp`` replica; the values
    the same on every rank of the replica and ``grads`` a tree like this
    rank's ``params`` (``PipelinedForward.backward``). Averaging over
    ``dp`` is ``train_step.layout_grads``'s."""
    tokens = batch["tokens"][:, :-1]
    targets = batch["tokens"][:, 1:]
    fwd = forward_pipelined(params, tokens, cfg, layout,
                            n_microbatches=n_microbatches)
    loss, part = _pipelined_loss(fwd, targets, layout)
    grads = fwd.backward(part)
    return _metrics(loss, fwd.aux, cfg), grads
