"""The port (ray_tpu_torch, chip_smoke.py) stands alone: it imports
neither jax nor the JAX package ray_tpu, and its entry points refuse to
run without a GPU unless asked for the CPU."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "ray_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "ray_tpu")  # exact names and their submodules

_BLOCKED_RUN = r'''
import importlib, importlib.abc, pkgutil, sys

FORBIDDEN = ("jax", "jaxlib", "ray_tpu")

def forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if forbidden(name):
            raise ImportError(f"blocked import of {name}")
        return None

for name in [m for m in sys.modules if forbidden(m)]:
    del sys.modules[name]
for name in FORBIDDEN:
    sys.modules[name] = None
sys.meta_path.insert(0, Block())

for name in ("jax", "ray_tpu", "ray_tpu.models"):
    try:
        importlib.import_module(name)
    except ImportError:
        pass
    else:
        raise SystemExit(f"the blocker let {name} through")

import ray_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(ray_tpu_torch.__path__, "ray_tpu_torch.")]
for m in mods:
    importlib.import_module(m)

import torch
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.parallel import train_step as ts

cfg = gpt2.GPT2Config(vocab_size=64, max_seq=16, n_layer=1, n_head=2, d_model=32,
                      remat=True, dtype=torch.float32)
opt = ts.default_optimizer(1e-3, warmup_steps=1, total_steps=4)
state = ts.make_train_state(lambda g: gpt2.init(g, cfg, device="cpu"),
                            torch.Generator().manual_seed(0), opt, device="cpu")
tokens = torch.randint(0, 64, (2, 17), generator=torch.Generator().manual_seed(1))
logits, _ = gpt2.forward(state.params, tokens[:, :-1], cfg)
assert logits.shape == (2, 16, 64)
step = ts.make_train_step(lambda p, b: gpt2.loss_fn(p, b, cfg), opt)
state, metrics = step(state, {"tokens": tokens})
assert torch.isfinite(metrics["loss"]) and state.step == 1
leaked = sorted(m for m, v in sys.modules.items() if forbidden(m) and v is not None)
assert not leaked, leaked
print("PORT-OK", len(mods))
'''


def test_port_runs_with_jax_and_ray_tpu_blocked():
    res = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stdout + res.stderr
    assert "PORT-OK" in res.stdout
    assert int(res.stdout.split("PORT-OK")[1]) >= 10  # every module imported


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_ray_tpu():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 12
    bad = [(str(f.relative_to(REPO)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    # the prefix pitfall: ray_tpu_torch is not ray_tpu
    assert "ray_tpu_torch".split(".")[0] not in FORBIDDEN


def test_entry_points_refuse_without_a_gpu(monkeypatch):
    from ray_tpu_torch._private.device import resolve_device
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import train_step as ts

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gpt2.gpt2_tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt2.init(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.make_train_state(lambda g: gpt2.init(g, cfg, device="cpu"),
                            torch.Generator(), ts.default_optimizer())
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def _run_chip_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env={**env, "CUDA_VISIBLE_DEVICES": ""})


def test_chip_smoke_fails_without_a_gpu():
    res = _run_chip_smoke(REPO)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "CUDA is not available" in res.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """Without the package beside it, the script stops at the import of
    ray_tpu_torch, before it looks for a GPU."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_chip_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "No module named 'ray_tpu_torch'" in res.stderr
    assert "CUDA is not available" not in res.stderr
