"""GPT-2 family. Port of ``ray_tpu/models/gpt2.py`` (non-pipelined).

Parameters are the JAX package's tree: stacked ``[n_layer, ...]`` block
leaves, f32, with bf16 compute. The forward loops over the stacked
leaves; ``remat`` maps to ``torch.utils.checkpoint``. Architecture: learned
positional embeddings, pre-LN blocks, GELU MLP, tied LM head; with
``moe`` set, every block's MLP is the routed MoE layer and the forward
returns its aux loss, averaged over the layers. The pipelined forward
and the sharding specs come in later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch._private.tree import tree_map
from ray_tpu_torch.models import layers as L


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
    attention: str = "auto"  # auto | flash | reference
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


# ----------------------------------------------------------------- forward
def _resolve_attention(cfg: GPT2Config, device: torch.device) -> str:
    """``"auto"`` is ``"flash"`` on a CUDA device and ``"reference"``
    elsewhere, as ``ray_tpu``'s is ``"flash"`` on a TPU. The hand-written
    kernels take bf16 and f32 up to head dim 256 (smaller head dims
    padded, ``gpt2_tiny``'s 16 among them; bf16 above 128 cast to f32);
    their wrappers refuse anything else before a launch."""
    if cfg.attention != "auto":
        return cfg.attention
    return "flash" if device.type == "cuda" else "reference"


def _block_apply(block, x, cfg: GPT2Config, impl: str):
    """(the block's output, its MoE aux loss, or None without MoE)."""
    cd = cfg.dtype
    h = L.layer_norm(x, block["ln1"]["scale"], block["ln1"]["bias"])
    x = x + L.apply_attention(block["attn"], h, causal=True, impl=impl,
                              compute_dtype=cd)
    h = L.layer_norm(x, block["ln2"]["scale"], block["ln2"]["bias"])
    if cfg.moe:
        m, aux = L.apply_moe(block["moe"], h, cfg.moe, compute_dtype=cd)
        return x + m, aux
    return x + L.apply_mlp(block["mlp"], h, compute_dtype=cd), None


def embed(params, tokens, cfg: GPT2Config):
    """Token + position embedding, cast to the compute dtype: the residual
    stream is bf16 by default."""
    S = tokens.shape[1]
    x = F.embedding(tokens.long(), params["wte"]) + params["wpe"][:S]
    return x.to(cfg.dtype)


class _MatmulF32Out(torch.autograd.Function):
    """a [N, d] . b[V, d]^T -> [N, V] f32 from compute-dtype operands. The
    backward rounds the cotangent to the operands' dtype and multiplies in
    that dtype with f32 accumulation."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return L.mm_f32(a, b.t())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        gc = g.to(a.dtype)
        return gc @ b, gc.t() @ a


def unembed(params, x, cfg: GPT2Config):
    """Final LayerNorm, then the tied vocab projection: bf16 operands, f32
    logits."""
    x = L.layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])
    B, S, D = x.shape
    cd = cfg.dtype
    logits = _MatmulF32Out.apply(x.to(cd).reshape(B * S, D),
                                 params["wte"].to(cd))
    return logits.view(B, S, -1)


def forward(params, tokens, cfg: GPT2Config) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V] f32, the MoE aux loss summed over
    the layers over n_layer: an f32 scalar, 0 without MoE)."""
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


def loss_fn(params, batch, cfg: GPT2Config):
    """batch: {"tokens" [B, S+1] integer}. Next-token cross-entropy,
    computed as logsumexp(logits) - logits[target] without materializing
    log_softmax."""
    tokens = batch["tokens"][:, :-1]
    targets = batch["tokens"][:, 1:]
    logits, aux = forward(params, tokens, cfg)
    lse = torch.logsumexp(logits, dim=-1)
    tl = logits.gather(-1, targets.long().unsqueeze(-1)).squeeze(-1)
    loss = (lse - tl).mean()
    total = loss + cfg.aux_loss_weight * aux
    return total, {"loss": loss, "aux_loss": aux, "total_loss": total}
