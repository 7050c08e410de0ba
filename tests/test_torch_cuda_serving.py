"""The serving path on the card: the GPU probe leaves its process without
a CUDA context; device batches copied on a side stream reach a consumer
whose kernels outlast the copies with every byte of their source;
TorchPredictor runs the forward kernel only. These need an NVIDIA GPU and
skip without one. On a GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_serving.py
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ray_tpu_torch.data import iter_device_batches
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.train.predictor import TorchPredictor

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r'''
import json, torch
from ray_tpu_torch._private import gpu_probe
print(json.dumps({"chips": gpu_probe.probe_chips(),
                  "devices": gpu_probe.probe_devices(),
                  "resources": gpu_probe.detect_resources(),
                  "cuda_initialized": torch.cuda.is_initialized()}))
'''


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_probe_leaves_its_process_without_cuda(cuda):
    res = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO,
             "RAY_TPU_TORCH_DETECT_GPUS": "1"})
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["cuda_initialized"] is False
    n = torch.cuda.device_count()
    assert got["chips"]["chips"] == n and len(got["devices"]) == n
    assert got["resources"]["GPU"] == float(n)
    for d in got["devices"]:
        assert d["platform"] == "gpu"
        # nvidia-smi reports whole MiB
        total = torch.cuda.mem_get_info(d["id"])[1]
        assert abs(d["memory_bytes_limit"] - total) < 1 << 20


def test_device_batches_survive_a_consumer_slower_than_the_copies(cuda):
    """Each batch as the consumer's stream reads it after a long kernel,
    with the batch dropped right after: its bytes are the source's (a
    device block handed to the next copy, or a pinned buffer refilled,
    too early would show here)."""
    rng = np.random.default_rng(0)
    host = [{"x": rng.random((256, 4096), dtype=np.float32),
             "ids": rng.integers(0, 1 << 30, (256,))} for _ in range(24)]
    seen = []
    for b in iter_device_batches(host, device=cuda):
        assert b["x"].is_cuda and b["ids"].is_cuda
        torch.cuda._sleep(2_000_000)  # ~1 ms: the copies run ahead
        seen.append({k: v.clone() for k, v in b.items()})
        del b
    torch.cuda.synchronize()
    for src, got in zip(host, seen, strict=True):
        for k in src:
            assert torch.equal(got[k].cpu(), torch.from_numpy(src[k])), k


def test_predictor_launches_the_forward_kernel_only(cuda):
    cfg = dataclasses.replace(gpt2.gpt2_tiny(), remat=True,
                              attention="flash")
    params = gpt2.init(torch.Generator(device=cuda).manual_seed(0), cfg)
    pred = TorchPredictor(
        params, lambda p, t: gpt2.next_token_logits(p, t, cfg), device=cuda)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 128))
    fa.reset_launch_counts()
    out = pred.predict(tokens)
    launches = dict(fa.LAUNCHES)
    assert out.shape == (4, cfg.vocab_size) and np.isfinite(out).all()
    assert launches.pop("flash_fwd") == cfg.n_layer
    assert not any(launches.values()), launches
    with torch.no_grad():
        logits, _ = gpt2.forward(params, torch.from_numpy(tokens).to(cuda),
                                 dataclasses.replace(cfg,
                                                     attention="reference"))
    np.testing.assert_allclose(out, logits[:, -1].cpu().numpy(),
                               atol=2 ** -3 * float(logits.pow(2).mean()
                                                    .sqrt()))
