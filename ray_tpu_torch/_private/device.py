"""Device choice for the port's entry points (replaces jax.default_backend()).

Entry points run on the CUDA device. They run on the CPU only when the
caller asks for it with ``device="cpu"``; nothing falls back to the CPU
when no GPU is found.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` by default; raises if CUDA is asked for and absent."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU")
    return dev

