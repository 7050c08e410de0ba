"""Predictors: checkpoint -> batch inference callable. The twin of
``ray_tpu/train/predictor.py`` (``Predictor``, ``JaxPredictor``).

``TorchPredictor`` runs an ``apply_fn`` over params held on the device,
numpy in and numpy out, under ``torch.inference_mode()``: no autograd
tape, nothing saved for a backward. It takes the port's
``air.checkpoint.Checkpoint`` or any object with ``to_dict()``, so
``ray_tpu``'s ``BatchPredictor`` can be handed it as its
``predictor_cls``. ``BatchPredictor`` itself (an actor pool over a
Dataset) needs the runtime, which the port does not have.
"""
from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch._private.device import DeviceLike, resolve_device


class Predictor:
    """Base predictor (the twin's ``Predictor``)."""

    @classmethod
    def from_checkpoint(cls, checkpoint, **kwargs) -> "Predictor":
        raise NotImplementedError

    def predict(self, batch):
        """batch: np.ndarray or {col: np.ndarray} -> same-shaped output."""
        raise NotImplementedError


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device)
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: cross as its bits
        return (torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
                .view(torch.bfloat16).to(device))
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(out):
    if isinstance(out, torch.Tensor):
        out = out.detach().cpu()
        return (out.float() if out.dtype == torch.bfloat16 else out).numpy()
    if isinstance(out, dict):
        return {k: _to_numpy(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_to_numpy(v) for v in out)
    return np.asarray(out)


class TorchPredictor(Predictor):
    """Runs ``apply_fn(params, batch_tensor) -> prediction`` over params
    on ``device`` (CUDA by default).

    Checkpoints made by ``Checkpoint.from_dict({"params": ...})`` or
    ``Checkpoint.from_torch({"params": ...})`` carry the params under
    ``params_key``; a ``torch_state`` one is read straight onto the
    device. The port runs eager: there is no
    ``jax.jit`` twin, so ``jit`` is accepted for the twin's signature and
    ignored. A batch is a numpy array (or a tensor, used where it lies if
    it is on the device) or a dict of them, run key by key; the output
    comes back as numpy (tensors, and tuples, lists and dicts of them;
    bf16 as float32)."""

    def __init__(self, params, apply_fn, device: DeviceLike = None,
                 jit: bool = True):
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self._apply = apply_fn

    @classmethod
    def from_checkpoint(cls, checkpoint, *, apply_fn,
                        params_key: str = "params",
                        device: DeviceLike = None,
                        jit: bool = True) -> "TorchPredictor":
        has_state = getattr(checkpoint, "has_torch_state", None)
        data = (checkpoint.to_torch(resolve_device(device))
                if has_state is not None and has_state()
                else checkpoint.to_dict())
        if params_key not in data:
            raise KeyError(
                f"checkpoint has no {params_key!r} entry "
                f"(keys: {sorted(data)})")
        return cls(data[params_key], apply_fn, device=device)

    def _run(self, x):
        with torch.inference_mode():
            return _to_numpy(self._apply(self.params,
                                         _to_device(x, self.device)))

    def predict(self, batch):
        if isinstance(batch, dict):
            return {k: self._run(v) for k, v in batch.items()}
        return self._run(batch)
