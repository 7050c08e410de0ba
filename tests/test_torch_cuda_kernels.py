"""The Hopper kernels of ray_tpu_torch against their plain PyTorch versions
on the card. These need an NVIDIA GPU (the kernels have no interpret
mode) and skip without one. On a GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest imports jax, which the port and
these tests do not need.)
"""
import dataclasses

import pytest
import torch

from ray_tpu_torch.models import gpt2
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.parallel import train_step as ts

pytestmark = pytest.mark.cuda
D = 64
# chip_smoke.py's bound, element by element (see the reasons there).
BF16_RTOL = 2.0 ** -6
ATOL_RMS = 2.0 ** -3
ABS_FLOOR = 1e-5
LSE_ABS_TOL = 2e-5
# chip_smoke.py's bound for the f32 kernels (see the reasons there).
F32_RTOL = 2.0 ** -14
F32_ATOL_RMS = 2.0 ** -14
F32_FLOOR = 1e-6
NO_LAUNCH = dict.fromkeys(fa.LAUNCHES, 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(a, b, what):
    if b.dtype == torch.float32:
        rtol, atol_rms, floor = F32_RTOL, F32_ATOL_RMS, F32_FLOOR
    else:
        rtol, atol_rms, floor = BF16_RTOL, ATOL_RMS, ABS_FLOOR
    a, b = a.float(), b.float()
    bound = rtol * b.abs() + atol_rms * b.square().mean().sqrt() + floor
    worst = ((a - b).abs() / bound).max().item()
    assert worst <= 1.0, (what, worst, (a - b).abs().max().item())


def _check_all_three(cuda, BH, S, D, causal, dtype, seed):
    """Each kernel of ``dtype`` against its plain version on the same
    inputs; returns the launches the three wrappers made."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v, do = (torch.randn(BH, S, D, generator=gen, device=cuda)
                   .to(dtype) for _ in range(4))
    kw = dict(scale=D ** -0.5, causal=causal)
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, **kw)
    delta = (do.float() * o_ref.float()).sum(dim=-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, **kw)
    torch.cuda.synchronize()
    assert o.shape == dq.shape == dk.shape == dv.shape == (BH, S, D)
    _assert_close(o, o_ref, "o")
    assert (lse - lse_ref).abs().max().item() <= LSE_ABS_TOL
    _assert_close(dq, fa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, **kw), "dq")
    dk_ref, dv_ref = fa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, **kw)
    _assert_close(dk, dk_ref, "dk")
    _assert_close(dv, dv_ref, "dv")
    return {n: fa.LAUNCHES[n] - before[n] for n in before if
            fa.LAUNCHES[n] != before[n]}


@pytest.mark.parametrize("BH,S,causal", [
    (4, 256, True), (4, 200, True), (3, 130, False), (2, 64, True), (2, 1, True),
    # the edges of the 128-row tiles of all three kernels
    (2, 127, True), (2, 128, True), (2, 129, True), (2, 255, True),
    (2, 1000, True), (2, 384, False), (1, 256, True),
    # S < 64: one 128-row tile holds a single, partial KV tile
    (2, 40, True), (2, 40, False),
])
def test_kernels_match_plain(cuda, BH, S, causal):
    launched = _check_all_three(cuda, BH, S, D, causal, torch.bfloat16, S)
    assert launched == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


@pytest.mark.parametrize("BH,S,Dh,causal", [
    (2, 129, 16, True), (2, 129, 16, False), (4, 256, 32, True),
    (2, 200, 48, True), (2, 1, 16, True), (3, 40, 8, False),
])
def test_bf16_kernels_pad_smaller_head_dims(cuda, BH, S, Dh, causal):
    """gpt2_tiny's head dim 16, and 32 and 48: zero-padded to 64 for the
    bf16 kernels and sliced back."""
    launched = _check_all_three(cuda, BH, S, Dh, causal, torch.bfloat16,
                                S + Dh)
    assert launched == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


@pytest.mark.parametrize("BH,S,Dh,causal", [
    (4, 256, 64, True), (3, 130, 64, False), (2, 1, 16, True),
    (8, 129, 16, True), (8, 129, 16, False), (2, 200, 32, True),
    (2, 100, 128, True), (2, 64, 128, False), (2, 77, 48, True),
    (2, 65, 20, False), (1, 1000, 64, True), (2, 63, 96, True),
])
def test_f32_kernels_match_plain(cuda, BH, S, Dh, causal):
    """The f32 kernels at each head dim they are built for (16, 32, 64,
    128) and at others padded up to the next, ragged S and both masks."""
    launched = _check_all_three(cuda, BH, S, Dh, causal, torch.float32,
                                S + Dh)
    assert launched == {"flash_fwd_f32": 1, "flash_bwd_dq_f32": 1,
                        "flash_bwd_dkv_f32": 1}


@pytest.mark.parametrize("BH,S,Dh,causal", [
    (2, 129, 96, True), (2, 129, 96, False), (2, 200, 128, True),
    (2, 129, 128, False), (3, 64, 65, True), (2, 1, 128, True),
    (1, 1000, 128, True), (2, 40, 100, False),
    # one row past a 128-row tile, and GPT-2-small's width in heads of 128
    (2, 129, 128, True), (96, 1024, 128, True),
])
def test_bf16_wide_kernels_match_plain(cuda, BH, S, Dh, causal):
    """bf16 at head dims 65 to 128, padded to head dim 128: the bf16_wide
    kernels (the wgmma forward, dq and dk/dv of flash_attention.cu at head
    dim 128), held to the plain versions under the bf16 bound."""
    launched = _check_all_three(cuda, BH, S, Dh, causal, torch.bfloat16,
                                S + Dh)
    assert launched == {"flash_fwd_bf16w": 1, "flash_bwd_dq_bf16w": 1,
                        "flash_bwd_dkv_bf16w": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,S,Dh,causal", [
    (2, 129, 129, True), (2, 129, 192, False), (2, 200, 256, True),
    (2, 129, 256, False), (1, 1000, 256, True), (2, 1, 256, True),
    (2, 40, 160, True), (3, 1024, 192, True),
])
def test_head_dims_129_to_256_run_their_dtype_kernels_at_256(
        cuda, BH, S, Dh, causal, dtype):
    """Head dims 129 to 256 in both dtypes, padded to 256, held to the plain
    versions of the caller's dtype under its bound: f32 runs the f32
    kernels' head-dim-256 instances, bf16 the three bf16_d256 kernels, and
    no bf16 input reaches an f32 kernel."""
    launched = _check_all_three(cuda, BH, S, Dh, causal, dtype, S + Dh)
    suffix = "_f32" if dtype == torch.float32 else "_bf16d256"
    assert launched == {"flash_fwd" + suffix: 1, "flash_bwd_dq" + suffix: 1,
                        "flash_bwd_dkv" + suffix: 1}


@pytest.mark.parametrize("Dh", [129, 192, 256])
@pytest.mark.parametrize("S", [129, 1000])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_d256_kernels_match_plain(cuda, Dh, S, causal):
    """The wgmma forward, dq and dk/dv at head dim 256
    (flash_fwd_d256_kernel, flash_bwd_dq_d256_kernel,
    flash_bwd_dkv_d256_kernel) on bf16 head dims 129, 192 and 256, a
    ragged S one row past a 128-row tile and one inside a 64-row tile,
    both masks, under the bf16 bound."""
    launched = _check_all_three(cuda, 3, S, Dh, causal, torch.bfloat16,
                                S + Dh + causal)
    assert launched == {"flash_fwd_bf16d256": 1, "flash_bwd_dq_bf16d256": 1,
                        "flash_bwd_dkv_bf16d256": 1}


@pytest.mark.parametrize("kernel,smem", [("flash_fwd_bf16d256", 230488),
                                         ("flash_bwd_dkv_bf16d256", 231496),
                                         ("flash_bwd_dq_bf16d256", 230456)])
def test_bf16_d256_kernel_attributes(cuda, kernel, smem):
    """The head-dim-256 kernels ask for the shared memory their layout
    needs, within the 232,448 bytes a block may take, hold one block an
    SM, and spill nothing."""
    assert fa.dynamic_smem_bytes(kernel) == smem <= 232448
    _check_all_three(cuda, 2, 200, 256, True, torch.bfloat16, 3)
    attrs = fa.kernel_attributes(kernel)
    assert attrs["max_dynamic_smem"] == smem
    assert attrs["local_bytes"] == 0
    assert attrs["blocks_per_sm"] == 1 and attrs["registers"] <= 255


def test_dq_grid_larger_than_the_card(cuda):
    """More dq blocks than the card holds at once, twice over (two blocks
    an SM): every block's tile is computed, and the launch asks for the
    dynamic shared memory that flash_dynamic_smem_bytes(2) reports."""
    BH, S = 640, 200
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    blocks = BH * -(-S // fa.DQ_BLOCK_Q)
    assert blocks > 2 * 2 * sms
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, do = (torch.randn(BH, S, D, generator=gen, device=cuda)
                   .to(torch.bfloat16) for _ in range(4))
    kw = dict(scale=D ** -0.5, causal=True)
    o, lse = fa.flash_fwd_plain(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(dim=-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    _assert_close(dq, fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw), "dq")
    smem = fa.dynamic_smem_bytes("flash_bwd_dq")
    assert smem > 48 * 1024  # past the default: the launch must raise its limit
    assert fa.kernel_attributes("flash_bwd_dq")["max_dynamic_smem"] == smem


@pytest.mark.parametrize("kernel,head_dim,want", [
    # (registers a thread, dynamic shared memory, blocks per SM, local
    # memory a thread): the head-dim-64 kernels as they were before head dim
    # 128 was added to their templates, and the head-dim-128 ones, unspilled
    ("flash_fwd", 64, (110, 83016, 2, 0)),
    ("flash_bwd_dq", 64, (126, 99400, 2, 0)),
    ("flash_bwd_dkv", 64, (210, 101448, 1, 0)),
    ("flash_fwd_bf16w", 128, (156, 164936, 1, 0)),
    ("flash_bwd_dq_bf16w", 128, (160, 197704, 1, 0)),
    ("flash_bwd_dkv_bf16w", 128, (255, 199752, 1, 0)),
])
def test_wgmma_kernel_attributes(cuda, kernel, head_dim, want):
    """What the CUDA runtime reports of each kernel of flash_attention.cu
    at the head dim it is built for."""
    attrs = fa.kernel_attributes(kernel, head_dim)
    got = (attrs["registers"], fa.dynamic_smem_bytes(kernel, head_dim),
           attrs["blocks_per_sm"], attrs["local_bytes"])
    assert got == want


@pytest.mark.parametrize("head_dim,smem", [
    (16, 12288), (32, 24576), (64, 49152), (128, 65536), (256, 214048)])
def test_f32_forward_attributes(cuda, head_dim, smem):
    """The tensor-core f32 forward at each head dim it is built for: its
    dynamic shared memory (up to 128 the Q tile and a 2-stage ring of K and
    V tiles; at 256, flash_fwd_d256_tc_kernel's split Q tile, split K and V
    stages, split p tile and rescale rows), no local memory (no spills),
    and at least the blocks an SM it is built for (3 up to head dim 64, 2
    at 128, 1 at 256)."""
    attrs = fa.kernel_attributes("flash_fwd_f32", head_dim)
    assert attrs["max_dynamic_smem"] == smem
    assert attrs["local_bytes"] == 0
    assert attrs["blocks_per_sm"] >= {128: 2, 256: 1}.get(head_dim, 3)


def test_f32_backward_attributes_at_head_dim_256(cuda):
    """At head dim 256 dq (flash_bwd_dq_d256_tc_kernel: raw Q and dO, split
    K, V and ds, a stash of the consumer's values) takes 220,192 bytes of
    shared memory and dk/dv, one kernel of 8 warps (4 hold dv, 4 dk),
    166,016 bytes: one block an SM each, and neither spills."""
    for kernel, smem in (("flash_bwd_dq_f32", 220192),
                         ("flash_bwd_dkv_f32", 166016)):
        attrs = fa.kernel_attributes(kernel, 256)
        assert attrs["max_dynamic_smem"] == smem <= 232448, kernel
        assert attrs["blocks_per_sm"] == 1 and attrs["registers"] <= 255
        assert attrs["local_bytes"] == 0, kernel


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    """A head dim of 0 in bf16, f32 or f16, and other dtypes, are refused
    before any launch."""
    before = dict(fa.LAUNCHES)
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        q = torch.zeros(2, 64, 0, dtype=dtype, device=cuda)
        with pytest.raises(ValueError, match="head dims of 1 and more"):
            fa.flash_fwd(q, q, q, scale=1.0, causal=True)
    q = torch.zeros(2, 64, D, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="bf16 or f32"):
        fa.flash_fwd(q, q, q, scale=1.0, causal=True)
    assert fa.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
@pytest.mark.parametrize("BH,S,Dh,causal", [
    (2, 129, 320, True), (2, 1000, 300, False), (1, 200, 512, True),
    (1, 129, 1000, False),
    # f32's dq and dk/dv take 256-column chunks: a narrow last one (384),
    # and a head dim padded to 576 (520)
    (2, 1024, 384, True), (2, 1024, 384, False), (2, 129, 520, True),
    (2, 129, 520, False),
    # bf16's forward keeps Q resident up to head dim 512 and streams it
    # above (576, 1000), with more K boxes a tile than ring stages; under
    # causal masking its first warpgroup skips the block's last KV tile
    (1, 1000, 1000, True), (2, 200, 576, True), (2, 1024, 576, False),
    # bf16's dq and dk/dv: a last 256-column chunk of three 64-column
    # boxes (448; 320 and 384 give one and two), and whole chunks with a
    # one-row last tile (512 at S 129)
    (2, 200, 448, True), (2, 129, 512, True),
])
def test_head_dims_above_256_run_the_dsplit_kernels(cuda, dtype, BH, S, Dh,
                                                   causal):
    """Above head dim 256 each dtype runs its split-head-dim kernels at the
    head dim padded to a multiple of 64, within the plain versions' bound
    of its dtype (float16 on the f32 kernels, under the bf16 bound)."""
    launched = _check_all_three(cuda, BH, S, Dh, causal, dtype, seed=Dh)
    suffix = "_bf16ds" if dtype == torch.bfloat16 else "_f32ds"
    assert launched == {k + suffix: 1 for k in fa.KERNELS}


# f32's forward, dq and dk/dv above 256 are two warpgroups (a producer
# and a consumer) with their operands split in shared memory; bf16's are
# two warpgroups fed by TMA, the forward with Q resident up to head dim
# 512, dq and dk/dv streaming every box through a 4-stage ring: one block
# an SM
WGMMA_DSPLIT = {"flash_fwd_f32ds": 230720, "flash_bwd_dq_f32ds": 230720,
                "flash_bwd_dkv_f32ds": 230720, "flash_fwd_bf16ds": 230516,
                "flash_bwd_dq_bf16ds": 230460,
                "flash_bwd_dkv_bf16ds": 214092}


@pytest.mark.parametrize("kernel", [k + s for s in ("_bf16ds", "_f32ds")
                                    for k in fa.KERNELS])
def test_dsplit_kernel_attributes(cuda, kernel):
    """One kernel a dtype serves every head dim above 256, whatever head
    dim it is asked at; none spills. Every one is a wgmma kernel that
    takes one block an SM, with the shared memory it launches with."""
    attrs = fa.kernel_attributes(kernel)
    assert attrs == fa.kernel_attributes(kernel, 1024)
    assert attrs["local_bytes"] == 0
    assert attrs["blocks_per_sm"] == 1
    assert attrs["max_dynamic_smem"] == WGMMA_DSPLIT[kernel] <= 232448


@pytest.mark.parametrize("BH,S,Dh,causal", [
    (2, 129, 64, True), (2, 1000, 16, False), (3, 200, 100, True),
    (2, 129, 192, False), (1, 1000, 256, True),
])
def test_float16_runs_the_f32_kernels(cuda, BH, S, Dh, causal):
    """float16 once refused on the card; now it runs the f32 kernels on f32
    copies (kernel_plan's "f16_f32"), counted as *_f32 launches, and its
    float16 outputs match the plain versions in float16 under the bf16
    bound."""
    launched = _check_all_three(cuda, BH, S, Dh, causal, torch.float16,
                                S + Dh)
    assert launched == {"flash_fwd_f32": 1, "flash_bwd_dq_f32": 1,
                        "flash_bwd_dkv_f32": 1}


def test_flash_attention_autograd_matches_cpu(cuda):
    """The same bf16 inputs through the kernels and through the plain
    versions (CPU tensors)."""
    gen = torch.Generator().manual_seed(0)
    q, k, v, ct = (torch.randn(2, 128, 2, D, generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    outs = {}
    for dev in ("cpu", cuda):
        args = [x.to(dev).requires_grad_(True) for x in (q, k, v)]
        o = fa.flash_attention(*args, causal=True)
        grads = torch.autograd.grad(o, args, ct.to(dev))
        outs[str(dev)] = [o.detach().cpu()] + [g.cpu() for g in grads]
    for a, b, what in zip(outs["cuda"], outs["cpu"], ("o", "dq", "dk", "dv")):
        _assert_close(a, b, what)


def test_gpt2_step_runs_the_kernels(cuda):
    """One bf16 step with head dim 64: flash attention launches each
    kernel once per layer, and its loss, grad norm and attention-leaf
    gradients match reference attention's within chip_smoke.py's limits."""
    cfg = gpt2.GPT2Config(vocab_size=512, max_seq=128, n_layer=2, n_head=2,
                          d_model=128, remat=False)
    tokens = torch.randint(0, 512, (4, 129), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    metrics, attn_grads = {}, {}
    for attention in ("reference", "flash"):
        run_cfg = dataclasses.replace(cfg, attention=attention)
        opt = ts.default_optimizer(1e-3, warmup_steps=1, total_steps=4)
        state = ts.make_train_state(
            lambda g: gpt2.init(g, run_cfg),
            torch.Generator(device=cuda).manual_seed(0), opt)
        attn = state.params["blocks"]["attn"]
        loss, _ = gpt2.loss_fn(state.params, {"tokens": tokens}, run_cfg)
        attn_grads[attention] = torch.autograd.grad(
            loss, [attn[n] for n in sorted(attn)])
        step = ts.make_train_step(lambda p, b: gpt2.loss_fn(p, b, run_cfg), opt)
        fa.reset_launch_counts()
        state, m = step(state, {"tokens": tokens})
        metrics[attention] = {k: float(m[k]) for k in ("loss", "grad_norm")}
    assert fa.LAUNCHES == {**NO_LAUNCH, "flash_fwd": 2, "flash_bwd_dq": 2,
                           "flash_bwd_dkv": 2}
    # chip_smoke.py's first-step limits: at init the loss is ~ln(V) whatever
    # attention computes, so the attention leaves' gradients carry the test.
    ref, flash = metrics["reference"], metrics["flash"]
    assert abs(flash["loss"] - ref["loss"]) <= 1e-4 * ref["loss"]
    assert abs(flash["grad_norm"] - ref["grad_norm"]) <= 2e-3 * ref["grad_norm"]
    for g, g_ref in zip(attn_grads["flash"], attn_grads["reference"]):
        assert ((g - g_ref).norm() / g_ref.norm()).item() <= 2.5e-2


@pytest.mark.parametrize("dtype,limits", [
    # chip_smoke.py's first-step limits (loss, grad norm, attention
    # leaves); in f32 an order tighter
    (torch.bfloat16, (1e-4, 2e-3, 2.5e-2)),
    (torch.float32, (1e-5, 2e-4, 2.5e-3)),
])
def test_gpt2_tiny_trains_with_auto_through_the_kernels(cuda, dtype, limits):
    """gpt2_tiny (head dim 16) under attention="auto" runs the kernels of
    its dtype: the bf16 ones padded to head dim 64, or the f32 ones. Its
    first step matches reference attention's, and each kernel launches
    once a layer a step."""
    tokens = torch.randint(0, 256, (2, 65), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    suffix = "" if dtype == torch.bfloat16 else "_f32"
    metrics, attn_grads = {}, {}
    for attention in ("reference", "auto"):
        cfg = dataclasses.replace(gpt2.gpt2_tiny(), attention=attention,
                                  dtype=dtype)
        opt = ts.default_optimizer(1e-3, warmup_steps=1, total_steps=4)
        state = ts.make_train_state(
            lambda g: gpt2.init(g, cfg),
            torch.Generator(device=cuda).manual_seed(0), opt)
        attn = state.params["blocks"]["attn"]
        loss, _ = gpt2.loss_fn(state.params, {"tokens": tokens}, cfg)
        attn_grads[attention] = torch.autograd.grad(
            loss, [attn[n] for n in sorted(attn)])
        step = ts.make_train_step(lambda p, b: gpt2.loss_fn(p, b, cfg), opt)
        fa.reset_launch_counts()
        for i in range(3):
            state, m = step(state, {"tokens": tokens})
            assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
            if i == 0:
                metrics[attention] = {k: float(m[k]) for k in ("loss", "grad_norm")}
    n = 3 * gpt2.gpt2_tiny().n_layer
    assert fa.LAUNCHES == {**NO_LAUNCH, "flash_fwd" + suffix: n,
                           "flash_bwd_dq" + suffix: n,
                           "flash_bwd_dkv" + suffix: n}
    loss_rtol, gn_rtol, attn_rtol = limits
    ref, flash = metrics["reference"], metrics["auto"]
    assert abs(flash["loss"] - ref["loss"]) <= loss_rtol * ref["loss"]
    assert abs(flash["grad_norm"] - ref["grad_norm"]) <= gn_rtol * ref["grad_norm"]
    for g, g_ref in zip(attn_grads["auto"], attn_grads["reference"]):
        assert ((g - g_ref).norm() / g_ref.norm()).item() <= attn_rtol


def test_gpt2_wide_heads_train_with_auto_through_the_bf16_wide_kernels(cuda):
    """gpt2_tiny with two heads of 128 (chip_smoke.py's phase 3b config)
    under attention="auto" in bf16 runs the bf16_wide kernels once a layer
    a step, and its first step matches reference attention's within
    chip_smoke.py's bf16 limits."""
    tokens = torch.randint(0, 256, (2, 65), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    base = dataclasses.replace(gpt2.gpt2_tiny(), d_model=256, n_head=2)
    metrics, attn_grads = {}, {}
    for attention in ("reference", "auto"):
        cfg = dataclasses.replace(base, attention=attention)
        opt = ts.default_optimizer(1e-3, warmup_steps=1, total_steps=4)
        state = ts.make_train_state(
            lambda g: gpt2.init(g, cfg),
            torch.Generator(device=cuda).manual_seed(0), opt)
        attn = state.params["blocks"]["attn"]
        loss, _ = gpt2.loss_fn(state.params, {"tokens": tokens}, cfg)
        attn_grads[attention] = torch.autograd.grad(
            loss, [attn[n] for n in sorted(attn)])
        step = ts.make_train_step(lambda p, b: gpt2.loss_fn(p, b, cfg), opt)
        fa.reset_launch_counts()
        for i in range(3):
            state, m = step(state, {"tokens": tokens})
            assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
            if i == 0:
                metrics[attention] = {k: float(m[k]) for k in ("loss", "grad_norm")}
    n = 3 * base.n_layer
    assert fa.LAUNCHES == {**NO_LAUNCH, "flash_fwd_bf16w": n,
                           "flash_bwd_dq_bf16w": n, "flash_bwd_dkv_bf16w": n}
    ref, flash = metrics["reference"], metrics["auto"]
    assert abs(flash["loss"] - ref["loss"]) <= 1e-4 * ref["loss"]
    assert abs(flash["grad_norm"] - ref["grad_norm"]) <= 2e-3 * ref["grad_norm"]
    for g, g_ref in zip(attn_grads["auto"], attn_grads["reference"]):
        assert ((g - g_ref).norm() / g_ref.norm()).item() <= 2.5e-2


def test_world2_thread_ddp_step_on_the_card(cuda):
    """Two rank threads share the card, each a bf16 GPT-2 with head dim 64
    on half the batch, synced by bucketed averaged DDP: the kernels run on
    both ranks, counted exactly, and the ranks' params stay bit-identical."""
    from functools import partial

    from ray_tpu_torch._private.tree import tree_leaves
    from ray_tpu_torch.train import ddp
    from tests.torch_gang import run_gang

    cfg = gpt2.GPT2Config(vocab_size=512, max_seq=128, n_layer=2, n_head=2,
                          d_model=128, remat=False)
    tokens = torch.randint(0, 512, (4, 129), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))

    def rank(r, group):
        opt = ts.default_optimizer(1e-3, warmup_steps=1, total_steps=4)
        state = ts.make_train_state(
            lambda g: gpt2.init(g, cfg),
            torch.Generator(device=cuda).manual_seed(0), opt)
        sync = partial(ddp.sync_gradients, group_name=group, average=True,
                       bucket_bytes=64 << 10)
        step = ts.make_train_step(lambda p, b: gpt2.loss_fn(p, b, cfg), opt,
                                  host_grad_sync=sync)
        for _ in range(2):
            state, m = step(state, {"tokens": tokens[2 * r:2 * r + 2]})
            assert torch.isfinite(m["loss"])
        torch.cuda.synchronize()
        return [p.detach().cpu() for p in tree_leaves(state.params)]

    fa.reset_launch_counts()
    p0, p1 = run_gang(2, rank)
    assert fa.LAUNCHES == {**NO_LAUNCH, "flash_fwd": 8, "flash_bwd_dq": 8,
                           "flash_bwd_dkv": 8}
    for a, b in zip(p0, p1):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_moe_layer_and_gpt2_moe_step_on_the_card(cuda):
    """apply_moe in f32 on the card equals the CPU's on the same inputs,
    at a capacity factor that drops pairs; a bf16 GPT-2 with MoE blocks
    under attention="auto" runs the flash kernels once a layer, reports
    a finite positive aux loss, and its first step matches reference
    attention's within chip_smoke.py's limits."""
    from ray_tpu_torch.models import layers as L

    gen = torch.Generator().manual_seed(3)
    moe_cfg = L.MoEConfig(n_experts=4, top_k=2, capacity_factor=0.5)
    params = {"wg": torch.randn(64, 4, generator=gen),
              "w1": torch.randn(4, 64, 128, generator=gen) / 8,
              "w2": torch.randn(4, 128, 64, generator=gen) / 128 ** 0.5}
    x = torch.randn(2, 32, 64, generator=gen)
    out_cpu, aux_cpu = L.apply_moe(params, x, moe_cfg, torch.float32)
    out, aux = L.apply_moe({k: v.to(cuda) for k, v in params.items()},
                           x.to(cuda), moe_cfg, torch.float32)
    torch.testing.assert_close(out.cpu(), out_cpu, atol=1e-5, rtol=0)
    torch.testing.assert_close(aux.cpu(), aux_cpu, atol=0, rtol=1e-6)

    cfg = gpt2.GPT2Config(vocab_size=512, max_seq=128, n_layer=2, n_head=2,
                          d_model=128, remat=False, moe=L.MoEConfig(
                              n_experts=4, top_k=2, capacity_factor=1.25))
    tokens = torch.randint(0, 512, (4, 129), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    metrics = {}
    for attention in ("reference", "auto"):
        run_cfg = dataclasses.replace(cfg, attention=attention)
        opt = ts.default_optimizer(1e-3, warmup_steps=1, total_steps=4)
        state = ts.make_train_state(
            lambda g: gpt2.init(g, run_cfg),
            torch.Generator(device=cuda).manual_seed(0), opt)
        step = ts.make_train_step(lambda p, b: gpt2.loss_fn(p, b, run_cfg), opt)
        fa.reset_launch_counts()
        state, m = step(state, {"tokens": tokens})
        metrics[attention] = {k: float(m[k]) for k in
                              ("loss", "grad_norm", "aux_loss")}
    assert fa.LAUNCHES == {**NO_LAUNCH, "flash_fwd": 2, "flash_bwd_dq": 2,
                           "flash_bwd_dkv": 2}
    ref, flash = metrics["reference"], metrics["auto"]
    assert 0 < flash["aux_loss"] < float("inf")
    assert abs(flash["loss"] - ref["loss"]) <= 1e-4 * ref["loss"]
    assert abs(flash["grad_norm"] - ref["grad_norm"]) <= 2e-3 * ref["grad_norm"]
