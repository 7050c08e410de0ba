"""The knobs the port reads, with env-var overrides. The twin of the Train
entries of ``ray_tpu/_private/config.py`` (``:116-134``), same defaults:
the bucketed DDP switch and bucket size, the DDP mode that
``train.ddp.sync_gradients`` reads when its ``mode`` is None, and the
sharded checkpoint's root, async write and fsync switches.

Each entry is overridable as ``RAY_TPU_TORCH_<NAME>``, read at call time,
so a test or an operator can set it after import. The port keeps its own
prefix: ``ray_tpu``'s ``RAY_TPU_*`` names belong to its knob catalog.
"""
from __future__ import annotations

import os
from typing import Any, Dict

_CONFIG_DEFS: Dict[str, Any] = {
    # Bucketed data-parallel gradient sync (train/ddp.py): launch each
    # size-targeted bucket's collective asynchronously. 0 = one
    # synchronous allreduce over the whole flattened tree (one per dtype),
    # bit-identical at world 2.
    "train_bucket_ddp": True,
    "train_grad_bucket_bytes": 4 * 1024 * 1024,  # target bucket size
    # The DDP sync's shape when sync_gradients is given no mode:
    # "allreduce" (every rank gets the full synced tree) or
    # "reducescatter" (ZeRO-style: each rank gets its shard of every
    # bucket).
    "train_ddp_mode": "allreduce",
    # Sharded checkpoints (train/sharded_checkpoint.py): the generation
    # root when save/restore get no root; whether the shard's disk write
    # runs on a background thread (the commit still runs at the caller's
    # harvest); and the fsyncs of _private/atomic_write.py (0 only for
    # tests on tmpfs).
    "checkpoint_dir": "",
    "checkpoint_async": True,
    "checkpoint_fsync": True,
}


def _parse(env: str, default: Any):
    if isinstance(default, bool):
        return env.lower() in ("1", "true", "yes")
    if isinstance(default, int):
        return int(env)
    return env


def get_config(name: str):
    """``RAY_TPU_TORCH_<NAME>`` from the environment if set, else the
    default."""
    env = os.environ.get("RAY_TPU_TORCH_" + name.upper())
    if env is not None:
        return _parse(env, _CONFIG_DEFS[name])
    return _CONFIG_DEFS[name]
