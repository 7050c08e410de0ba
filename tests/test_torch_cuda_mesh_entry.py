"""The port's mesh entry point on the card, with remat on: GPT-2-tiny at
dp 2 x tp 2, four rank threads sharing one GPU, each joined from
create_mesh(..., devices=[cuda:0] * 4), its state from
make_train_state(..., layout, gpt2.partition_specs(cfg)) and its step
from make_train_step(lambda p, b: gpt2.loss_fn(p, b, cfg, layout), opt,
layout). These need an NVIDIA GPU (the kernels have no interpret mode)
and skip without one. On a GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_mesh_entry.py
"""
import dataclasses

import pytest
import torch

from ray_tpu_torch._private.tree import tree_leaves, tree_map, tree_unflatten
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.parallel import mesh as M
from ray_tpu_torch.parallel import train_step as ts
from tests.torch_gang import run_on_mesh

pytestmark = pytest.mark.cuda
B = 8
# chip_smoke.py's phase 3b f32 limits: loss, grad norm (relative)
F32_LIMITS = (1e-5, 2e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dp2_tp2_remat_step_through_the_mesh_entry_point(cuda, dtype):
    """Two remat steps at dp 2 x tp 2: every rank reports the same
    metrics, finite; in f32 the first step's loss and grad norm are the
    one-card step's within phase 3b's f32 limits; each rank launches its
    family's forward kernel twice a layer and step (the forward and the
    layer's recompute) and dq and dk/dv once, and no other kernel."""
    cfg = dataclasses.replace(gpt2.gpt2_tiny(), dtype=dtype, remat=True)
    params = gpt2.init(torch.Generator(device=cuda).manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (B, cfg.max_seq + 1),
                           device=cuda, generator=torch.Generator(
                               device=cuda).manual_seed(1))
    batch = {"tokens": tokens}
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    total, m = gpt2.loss_fn(params, batch, cfg)
    grads = tree_unflatten(params, torch.autograd.grad(total, leaves))
    want = (float(m["loss"].detach()), float(ts.global_norm(grads)))
    params = tree_map(lambda p: p.detach(), params)
    mesh = M.create_mesh(M.MeshConfig(dp=2, tp=2), devices=[cuda] * 4)
    specs = gpt2.partition_specs(cfg)

    def rank(lay):
        opt = ts.default_optimizer(1e-3, warmup_steps=1, total_steps=10)
        state = ts.make_train_state(lambda g: params, None, opt, lay, specs)
        assert all(p.device == cuda for p in tree_leaves(state.params))
        step = ts.make_train_step(lambda p, b: gpt2.loss_fn(p, b, cfg, lay),
                                  opt, lay)
        out = []
        for _ in range(2):
            state, metrics = step(state, batch)
            out.append((float(metrics["loss"]),
                        float(metrics["grad_norm"])))
        torch.cuda.current_stream().synchronize()
        return out

    fa.reset_launch_counts()
    ranks = run_on_mesh(mesh, rank, name="cudaentry")
    counts = dict(fa.LAUNCHES)
    assert all(r == ranks[0] for r in ranks)
    assert all(torch.isfinite(torch.tensor(r)).all() for r in ranks)
    if dtype == torch.float32:
        got = ranks[0][0]
        assert abs(got[0] - want[0]) / want[0] <= F32_LIMITS[0]
        assert abs(got[1] - want[1]) / want[1] <= F32_LIMITS[1]
    family, _ = fa.kernel_plan(dtype, cfg.d_model // cfg.n_head)
    per = 4 * cfg.n_layer * 2  # ranks x layers x steps
    want_counts = dict.fromkeys(fa.LAUNCHES, 0)
    for kernel, n in (("flash_fwd", 2 * per), ("flash_bwd_dq", per),
                      ("flash_bwd_dkv", per)):
        want_counts[kernel + fa._SUFFIXES[family]] = n
    assert counts == want_counts
