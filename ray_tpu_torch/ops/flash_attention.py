"""Flash attention, forward and backward, over hand-written Hopper kernels.

Port of ``ray_tpu/ops/flash_attention.py``. The three Pallas TPU kernels
there become CUDA kernels, in families chosen per kernel
(``kernel_plan``): "bf16" for bf16 head dims up to 64 (padded to 64), the
wgmma kernels of ``csrc/flash_attention.cu`` at head dim 64; "bf16_wide"
for bf16 head dims 65 to 128 (padded to 128), the same file's kernels at
head dim 128; "bf16_d256" for bf16 head dims 129 to 256 (padded to 256),
the same file's head-dim-256 kernels; "f32", the 3xTF32 tensor-core
kernels of ``csrc/flash_attention_f32.cu`` (head dims 16, 32, 64, 128 and
256; others padded up to the next); "f16_f32", float16 through the same
f32 kernels on f32 copies, the outputs cast back to float16. Head dims
above 256 (padded to a multiple of 64) run the kernels of
``csrc/flash_attention_dsplit.cu``, in which each block computes one
256-column chunk of the output's columns and the scores over the whole
head dim: "bf16_dsplit" and "f32_dsplit", and "f16_f32_dsplit" (float16
on f32 copies). Every bf16 kernel rounds p and ds to bf16 before the products
that take them, as the bf16 Pallas kernels do. The forward uses online
softmax and writes ``o`` and the row logsumexp; dq and dk/dv recompute
the probabilities from the saved logsumexp, so that no S x S tensor
reaches device memory.

Each kernel has a wrapper and a plain PyTorch version of the same
function with the same cast points (``flash_fwd_plain``,
``flash_bwd_dq_plain``, ``flash_bwd_dkv_plain``; in f32 the casts keep
f32, as the Pallas kernels' do). A wrapper given CPU tensors computes
the plain version; given CUDA tensors it launches the kernel of their
dtype and head dim or raises. ``LAUNCHES`` counts kernel launches, one
per launch.

Internal layout is [B*H, S, D]; the TPU's [BH, 8, S] logsumexp layout
existed only for its (8, 128) tiling and is dropped.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30
# What each kernel of csrc/flash_attention.cu (bf16, bf16_wide, bf16_d256)
# tiles by, in rows of the [BH, S, D] tensors: the forward and dq take 128
# Q rows per block and stream K/V in 64-row tiles; dk/dv takes 128 KV rows
# per block (64 at head dim 256) and streams Q/dO in 64-row tiles. The
# kernels of csrc/flash_attention_f32.cu (f32) take 64 rows of their own
# axis a block and stream the other in tiles of 32 rows (16 at head dim
# 128, 8 at 256).
FWD_BLOCK_Q, FWD_BLOCK_K = 128, 64
DQ_BLOCK_Q, DQ_BLOCK_K = 128, 64
DKV_BLOCK_K, DKV_BLOCK_Q = 128, 64
# The head dims each kernel family is built for. A smaller head dim is
# padded with zero columns up to the next one, which is exact: zero
# columns add exact zeros to q.k^T and do.v^T, the scale stays the
# caller's, and the padded columns of the outputs are dropped.
BF16_HEAD_DIMS = (64, 128, 256)
_BF16_FAMILIES = dict(zip(BF16_HEAD_DIMS, ("bf16", "bf16_wide", "bf16_d256")))
F32_HEAD_DIMS = (16, 32, 64, 128, 256)
# Above 256 every dtype runs the split-head-dim kernels, at the head dim
# padded up to a multiple of DSPLIT_CHUNK (the columns of a step of the
# scores)
DSPLIT_CHUNK = 64
_DSPLIT_FAMILIES = {torch.bfloat16: "bf16_dsplit",
                    torch.float32: "f32_dsplit",
                    torch.float16: "f16_f32_dsplit"}
# family -> the suffix of its kernels' entry points and launch counters
# (float16 runs the f32 kernels)
_SUFFIXES = {"bf16": "", "bf16_wide": "_bf16w", "bf16_d256": "_bf16d256",
             "f32": "_f32", "f16_f32": "_f32", "bf16_dsplit": "_bf16ds",
             "f32_dsplit": "_f32ds", "f16_f32_dsplit": "_f32ds"}
# the families that run on f32 copies of float16 inputs
_ON_F32_COPIES = ("f16_f32", "f16_f32_dsplit")
# each family has all three
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

LAUNCHES = {f"{kernel}{suffix}": 0 for suffix in _SUFFIXES.values()
            for kernel in KERNELS}
# rank threads of one gang launch at once: the counts stay exact under it
_launches_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _launches_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


# ------------------------------------------------------------ plain versions
def _masked_scores(q, k, *, scale, causal):
    """s = q.k^T * scale in f32, with the causal mask at NEG_INF."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        S = q.shape[1]
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def flash_fwd_plain(q, k, v, *, scale, causal) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v [BH, S, D] -> (o [BH, S, D] in q's dtype, lse [BH, S] f32).
    p is cast to v's dtype before p.v, as in the kernel."""
    s = _masked_scores(q, k, scale=scale, causal=causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    o = (acc / l).to(q.dtype)
    lse = (m + torch.log(l)).squeeze(-1)
    return o, lse


def _probs_and_ds(q, k, v, do, lse, delta, *, scale, causal):
    s = _masked_scores(q, k, scale=scale, causal=causal)
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return p, ds


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, scale, causal) -> torch.Tensor:
    """dq = ds.k with ds cast to k's dtype, accumulated in f32."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, scale=scale, causal=causal)
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, scale, causal
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk = ds^T.q (ds cast to q's dtype), dv = p^T.do (p cast to do's
    dtype), both accumulated in f32."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, scale=scale, causal=causal)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------- kernel wrappers
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# the entries' arguments: the bf16 ones (head dim 64) take no head dim, the
# others take it after S
_FWD = [_P, _P, _P, _P, _P, _I, _I, _F, _I, _P]
_DQ = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P]
_DKV = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P]
_FWD_D, _DQ_D, _DKV_D = ([*a[:-3], _I, *a[-3:]] for a in (_FWD, _DQ, _DKV))
_ATTRIBUTES = [_I, _I, ctypes.POINTER(_I)]
# library (csrc/<name>.cu) -> its entries and their arguments
_ENTRIES = {
    "flash_attention": {
        "flash_fwd_bf16": _FWD, "flash_bwd_dq_bf16": _DQ,
        "flash_bwd_dkv_bf16": _DKV, "flash_fwd_bf16w": _FWD_D,
        "flash_bwd_dq_bf16w": _DQ_D, "flash_bwd_dkv_bf16w": _DKV_D,
        "flash_fwd_bf16d256": _FWD_D, "flash_bwd_dq_bf16d256": _DQ_D,
        "flash_bwd_dkv_bf16d256": _DKV_D,
        "flash_dynamic_smem_bytes": [_I, _I],
        "flash_kernel_attributes": _ATTRIBUTES,
    },
    "flash_attention_f32": {
        "flash_fwd_f32": _FWD_D, "flash_bwd_dq_f32": _DQ_D,
        "flash_bwd_dkv_f32": _DKV_D,
        "flash_f32_kernel_attributes": _ATTRIBUTES,
    },
    "flash_attention_dsplit": {
        "flash_fwd_bf16ds": _FWD_D, "flash_bwd_dq_bf16ds": _DQ_D,
        "flash_bwd_dkv_bf16ds": _DKV_D, "flash_fwd_f32ds": _FWD_D,
        "flash_bwd_dq_f32ds": _DQ_D, "flash_bwd_dkv_f32ds": _DKV_D,
        "flash_dsplit_kernel_attributes": _ATTRIBUTES,
    },
}
_LIBRARY_OF = {entry: lib for lib, entries in _ENTRIES.items()
               for entry in entries}
_KERNEL_IDS = {"flash_fwd": 0, "flash_bwd_dkv": 1, "flash_bwd_dq": 2}
_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32",
                torch.float16: "f16"}


def _entry(counter: str) -> str:
    """The C entry that launches the kernel of a name of ``LAUNCHES``."""
    return counter + "_bf16" if counter in _KERNEL_IDS else counter


def _kernel(name: str):
    lib = _LIBRARY_OF[name]
    fn = getattr(_build.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = _ENTRIES[lib][name]
        fn.restype = ctypes.c_int
    return fn


def kernel_plan(dtype: torch.dtype, head_dim: int,
                kernel: str = "flash_fwd") -> Tuple[str, int]:
    """Which kernel family runs ``kernel`` (one of ``KERNELS``, the
    forward by default) on [BH, S, head_dim] tensors of ``dtype``, and the
    head dim it runs them at: ``("bf16", 64)`` for bf16 with head dim up to
    64, ``("bf16_wide", 128)`` for bf16 with head dim 65 to 128,
    ``("bf16_d256", 256)`` for bf16 with head dim 129 to 256, ``("f32",
    d)`` for f32 with head dim up to 256, ``d`` the next of
    ``F32_HEAD_DIMS``, and ``("f16_f32", d)`` for float16 likewise (the
    f32 kernels on f32 copies); above 256, ``("bf16_dsplit", d)``,
    ``("f32_dsplit", d)`` or ``("f16_f32_dsplit", d)``, ``d`` the head dim
    rounded up to a multiple of ``DSPLIT_CHUNK``, with no upper limit: the
    same for each kernel. Raises on what no kernel takes: another dtype,
    or a head dim below 1."""
    if kernel not in KERNELS:
        raise ValueError(f"no kernel {kernel!r}; the kernels are {KERNELS}")
    dims = {torch.bfloat16: BF16_HEAD_DIMS, torch.float32: F32_HEAD_DIMS,
            torch.float16: F32_HEAD_DIMS}.get(dtype)
    if dims is None:
        raise ValueError(f"the CUDA kernels take bf16 or f32 tensors (f16 "
                         f"through the f32 kernels), got {dtype}")
    if head_dim < 1:
        raise ValueError(f"the CUDA kernels take {_DTYPE_NAMES[dtype]} head "
                         f"dims of 1 and more, got {head_dim}")
    if head_dim > dims[-1]:
        return (_DSPLIT_FAMILIES[dtype],
                -(-head_dim // DSPLIT_CHUNK) * DSPLIT_CHUNK)
    padded = next(d for d in dims if head_dim <= d)
    if dtype == torch.bfloat16:
        return _BF16_FAMILIES[padded], padded
    return ("f16_f32" if dtype == torch.float16 else "f32"), padded


def pad_head_dim(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """[..., D] -> [..., head_dim] with zero columns after the D given;
    ``x`` itself when D is already ``head_dim``."""
    D = x.shape[-1]
    if D == head_dim:
        return x
    return torch.nn.functional.pad(x, (0, head_dim - D))


def unpad_head_dim(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """The first ``head_dim`` columns of ``x``, contiguous."""
    if x.shape[-1] == head_dim:
        return x
    return x[..., :head_dim].contiguous()


def _suffix(kernel: str) -> str:
    return next((s for s in _SUFFIXES.values() if s and kernel.endswith(s)),
                "")


def _head_dim_of(kernel: str, head_dim: Optional[int]) -> int:
    """The head dim a kernel is asked about at: the one given, else 64 for
    the bf16 family, 128 for bf16_wide and 256 for bf16_d256 (f32 kernels
    need one)."""
    if head_dim is None:
        head_dim = dict(zip(("", "_bf16w", "_bf16d256"),
                            BF16_HEAD_DIMS)).get(_suffix(kernel))
    if head_dim is None:
        raise ValueError(f"{kernel}: give the head dim, one of "
                         f"{F32_HEAD_DIMS}")
    return int(head_dim)


def dynamic_smem_bytes(kernel: str, head_dim: Optional[int] = None) -> int:
    """Dynamic shared memory of one block of a kernel of
    ``csrc/flash_attention.cu``, by its name in ``LAUNCHES`` (``flash_fwd``,
    ``flash_bwd_dq``, ``flash_bwd_dkv`` at head dim 64, the ``_bf16w``
    ones at 128, the ``_bf16d256`` ones at 256); builds the kernels if
    needed."""
    smem = _kernel("flash_dynamic_smem_bytes")(
        _KERNEL_IDS[kernel.removesuffix(_suffix(kernel))],
        _head_dim_of(kernel, head_dim))
    if smem < 0:
        raise ValueError(f"{kernel} is not a kernel of flash_attention.cu")
    return smem


def kernel_attributes(kernel: str, head_dim: Optional[int] = None) -> dict:
    """What the CUDA runtime reports of one kernel: ``registers`` a thread,
    ``max_dynamic_smem``, ``blocks_per_sm`` (blocks one SM holds at once at
    the shared memory it launches with) and ``local_bytes`` (local memory
    a thread: ptxas's spills). ``kernel`` is a name of ``LAUNCHES``; an f32
    kernel is asked for at one of ``F32_HEAD_DIMS`` (``head_dim``), a
    split-head-dim one at any (one kernel serves them all). For a
    kernel of ``csrc/flash_attention.cu`` ``max_dynamic_smem`` is what its
    last launch allowed itself, for the others the dynamic shared memory of
    their launches. Needs a CUDA device."""
    out = (_I * 4)()
    suffix = _suffix(kernel)
    lib = _LIBRARY_OF[_entry(kernel)]
    kernel_id = _KERNEL_IDS[kernel.removesuffix(suffix)]
    if lib == "flash_attention_dsplit":
        # one kernel a dtype serves every head dim
        err = _kernel("flash_dsplit_kernel_attributes")(
            kernel_id, int(suffix == "_bf16ds"), out)
    else:
        attributes = ("flash_kernel_attributes" if lib == "flash_attention"
                      else "flash_f32_kernel_attributes")
        err = _kernel(attributes)(kernel_id, _head_dim_of(kernel, head_dim),
                                  out)
    if err != 0:
        raise RuntimeError(f"kernel attributes of {kernel} failed: "
                           f"{_why(err)}")
    return {"registers": out[0], "max_dynamic_smem": out[1],
            "blocks_per_sm": out[2], "local_bytes": out[3]}


def _on_cpu(*tensors) -> bool:
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    if devices != {"cuda"}:
        raise ValueError(f"flash attention takes cpu or cuda tensors on one "
                         f"device type, got {sorted(devices)}")
    return False


def _check_cuda(matrices, f32_rows=()):
    """Checks what the kernels take: [BH, S, D] matrices of one dtype and
    shape that ``kernel_plan`` accepts, [BH, S] f32 rows, all contiguous,
    on one device and the matrices 16-byte aligned. Returns (BH, S)."""
    q = matrices[0]
    if q.dim() != 3:
        raise ValueError(f"expected [BH, S, D] tensors, got shape {tuple(q.shape)}")
    BH, S, D = q.shape
    kernel_plan(q.dtype, D)
    if not 0 < BH <= 65535 or S <= 0:
        raise ValueError(f"unsupported B*H={BH}, S={S}")
    for t in matrices:
        if t.dtype != q.dtype or tuple(t.shape) != (BH, S, D):
            raise ValueError(f"expected {_DTYPE_NAMES[q.dtype]} [{BH}, {S}, "
                             f"{D}], got {t.dtype} {tuple(t.shape)}")
    for t in f32_rows:
        if t.dtype != torch.float32 or tuple(t.shape) != (BH, S):
            raise ValueError(f"expected f32 [{BH}, {S}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (*matrices, *f32_rows):
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
        if t.device != q.device:
            raise ValueError("all tensors must be on one device")
    for t in matrices:
        if t.data_ptr() % 16:
            raise ValueError("the CUDA kernels take 16-byte aligned [BH, S, "
                             "D] tensors (they read rows 16 bytes at a time)")
    return BH, S


def _why(err: int) -> str:
    return {-1: "the driver has no cuTensorMapEncodeTiled",
            -2: "the driver refused a tensor map",
            -3: "no kernel for this head dim"}.get(err, f"cudaError {err}")


def _launch(name: str, counter: str, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernel(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {_why(err)}")
    _count_launch(counter)


def _count_launch(counter: str) -> None:
    with _launches_lock:
        LAUNCHES[counter] += 1


def _kernel_inputs(family: str, tensors, head_dim: int):
    """The tensors as ``family``'s kernels take them: f32 copies for
    the float16 families, padded to ``head_dim``."""
    if family in _ON_F32_COPIES:
        tensors = [t.float() for t in tensors]
    return [pad_head_dim(t, head_dim) for t in tensors]


def _kernel_output(x: torch.Tensor, head_dim: int, dtype: torch.dtype):
    """A kernel's output unpadded to ``head_dim``, in the caller's
    ``dtype`` (float16 from the f32 kernels)."""
    return unpad_head_dim(x, head_dim).to(dtype)


def _run(kernel: str, family: str, head_dim: int, device, ptrs, scale,
         causal) -> None:
    """Launches ``kernel`` (one of ``KERNELS``) of ``family``; every
    entry but the bf16 family's also takes the head dim it runs at."""
    counter = kernel + _SUFFIXES[family]
    dims = () if family == "bf16" else (head_dim,)
    _launch(_entry(counter), counter, device, *ptrs, *dims, float(scale),
            int(causal))


def flash_fwd(q, k, v, *, scale: float, causal: bool):
    """(o, lse) of q, k, v [BH, S, D]: the plain version on CPU tensors,
    the forward kernel of q's dtype on CUDA tensors."""
    if _on_cpu(q, k, v):
        return flash_fwd_plain(q, k, v, scale=scale, causal=causal)
    BH, S = _check_cuda((q, k, v))
    D = q.shape[-1]
    dtype = q.dtype
    family, Dk = kernel_plan(dtype, D, "flash_fwd")
    q, k, v = _kernel_inputs(family, (q, k, v), Dk)
    o = torch.empty_like(q)
    lse = torch.empty(BH, S, dtype=torch.float32, device=q.device)
    _run("flash_fwd", family, Dk, q.device,
         (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
          lse.data_ptr(), BH, S), scale, causal)
    return _kernel_output(o, D, dtype), lse


def flash_bwd_dq(q, k, v, do, lse, delta, *, scale: float, causal: bool):
    """dq: the plain version on CPU tensors, the dq kernel of q's dtype on
    CUDA tensors."""
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, scale=scale,
                                  causal=causal)
    BH, S = _check_cuda((q, k, v, do), (lse, delta))
    D = q.shape[-1]
    dtype = q.dtype
    family, Dk = kernel_plan(dtype, D, "flash_bwd_dq")
    q, k, v, do = _kernel_inputs(family, (q, k, v, do), Dk)
    dq = torch.empty_like(q)
    _run("flash_bwd_dq", family, Dk, q.device,
         (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
          lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), BH, S),
         scale, causal)
    return _kernel_output(dq, D, dtype)


def flash_bwd_dkv(q, k, v, do, lse, delta, *, scale: float, causal: bool):
    """(dk, dv): the plain version on CPU tensors, the dk/dv kernel of q's
    dtype on CUDA tensors."""
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale=scale,
                                   causal=causal)
    BH, S = _check_cuda((q, k, v, do), (lse, delta))
    D = q.shape[-1]
    dtype = q.dtype
    family, Dk = kernel_plan(dtype, D, "flash_bwd_dkv")
    q, k, v, do = _kernel_inputs(family, (q, k, v, do), Dk)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _run("flash_bwd_dkv", family, Dk, q.device,
         (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
          lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
          BH, S), scale, causal)
    return _kernel_output(dk, D, dtype), _kernel_output(dv, D, dtype)


# --------------------------------------------------------------- autograd
class _FlashAttention(torch.autograd.Function):
    """custom_vjp twin: saves (q, k, v, o, lse); the backward computes
    delta = sum(do * o) in f32 outside the kernels, then dq and dk/dv."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        o, lse = flash_fwd(q, k, v, scale=scale, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        kw = dict(scale=ctx.scale, causal=ctx.causal)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention over [B, S, H, D] (the heads layout of
    models/layers.apply_attention). Differentiable. ``block_q`` and
    ``block_k`` stand for parity with ``ray_tpu``'s signature: each kernel
    tiles by its own fixed sizes (``FWD_BLOCK_*``, ``DQ_BLOCK_*``,
    ``DKV_BLOCK_*``), so only None is taken."""
    if block_q is not None or block_k is not None:
        raise ValueError(
            f"the kernels tile by their own sizes (forward {FWD_BLOCK_Q}x"
            f"{FWD_BLOCK_K}, dq {DQ_BLOCK_Q}x{DQ_BLOCK_K}, dk/dv "
            f"{DKV_BLOCK_K}x{DKV_BLOCK_Q}); got block_q={block_q}, "
            f"block_k={block_k}")
    B, S, H, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)

    def to_bh(x):
        # at B 1 the reshape is a view with the heads' stride, not a copy
        return x.transpose(1, 2).reshape(B * H, S, D).contiguous()

    o = _FlashAttention.apply(to_bh(q), to_bh(k), to_bh(v), float(scale),
                              bool(causal))
    return o.reshape(B, H, S, D).transpose(1, 2)
