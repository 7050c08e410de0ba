"""Framework-agnostic checkpoint, interconvertible between dict, directory,
bytes and URI forms: the port's copy of ``ray_tpu/air/checkpoint.py``.

``to_bytes`` writes the same ``pickle`` of ``(kind, payload)`` as the
twin, so bytes written by either package load in the other. In place of
the twin's orbax form (``from_jax`` / ``to_jax``) the port has its own:
``from_torch`` / ``to_torch`` write and read a ``torch_state/`` directory
of one npz (a member a leaf) and a manifest of the tree (each leaf's
path, member, shape and dtype). bf16 leaves cross as a ``uint16`` view,
as ``convert.py`` carries them; both files are written atomically
(``_private/atomic_write.py``), the manifest last.
"""
from __future__ import annotations

import io
import json
import os
import pickle
import shutil
import tarfile
import tempfile
import uuid
import weakref

import numpy as np
import torch

from ray_tpu_torch._private.atomic_write import atomic_write
from ray_tpu_torch._private.device import DeviceLike, resolve_device

TORCH_STATE = "torch_state"
_LEAVES = "leaves.npz"
_MANIFEST = "manifest.json"
_FORMAT = "ray_tpu_torch.torch_state/1"


def _own_tmpdir(owner, path: str) -> str:
    """Tie a mkdtemp'd scratch directory's lifetime to ``owner``: the
    finalizer removes it when the owner is collected (and at interpreter
    exit)."""
    weakref.finalize(owner, shutil.rmtree, path, ignore_errors=True)
    return path


class Checkpoint:
    def __init__(self, data: dict | None = None,
                 directory: str | None = None):
        if (data is None) == (directory is None):
            raise ValueError("exactly one of data/directory required")
        self._data = data
        self._directory = directory
        self._materialized: str | None = None  # cached to_directory(None)
        self.id = uuid.uuid4().hex[:8]

    # ---- constructors -------------------------------------------------------

    @classmethod
    def from_dict(cls, data: dict) -> "Checkpoint":
        return cls(data=_tree_to_host(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        if not os.path.isdir(path):
            raise ValueError(f"not a directory: {path}")
        return cls(directory=path)

    @classmethod
    def from_bytes(cls, blob: bytes) -> "Checkpoint":
        kind, payload = pickle.loads(blob)
        if kind == "dict":
            return cls(data=payload)
        tmp = tempfile.mkdtemp(prefix="rtpu_ckpt_")
        with tarfile.open(fileobj=io.BytesIO(payload), mode="r") as tar:
            tar.extractall(tmp, filter="data")
        ckpt = cls(directory=tmp)
        _own_tmpdir(ckpt, tmp)
        return ckpt

    @classmethod
    def from_torch(cls, tree, path: str | None = None) -> "Checkpoint":
        """Write a tree (nested dicts with string keys; tensor, numpy or
        scalar leaves) as a ``torch_state/`` directory checkpoint under
        ``path`` (a scratch directory tied to the checkpoint by
        default)."""
        base = path or tempfile.mkdtemp(prefix="rtpu_ckpt_")
        target = os.path.join(base, TORCH_STATE)
        if os.path.exists(target):
            shutil.rmtree(target)
        os.makedirs(target)
        members, leaves = {}, []
        for i, (keys, leaf) in enumerate(_leaves_with_paths(tree)):
            t = torch.as_tensor(leaf).detach().cpu().contiguous()
            member = f"leaf_{i:05d}"
            if t.dtype == torch.bfloat16:
                arr = t.view(torch.int16).numpy().view(np.uint16)
            else:
                arr = t.numpy()
            members[member] = arr
            leaves.append({"path": keys, "member": member,
                           "shape": list(t.shape),
                           "dtype": str(t.dtype).removeprefix("torch.")})
        buf = io.BytesIO()
        np.savez(buf, **members)
        atomic_write(os.path.join(target, _LEAVES), buf.getbuffer())
        atomic_write(os.path.join(target, _MANIFEST), json.dumps(
            {"format": _FORMAT, "leaves": leaves}, indent=1).encode())
        ckpt = cls(directory=base)
        if path is None:
            _own_tmpdir(ckpt, base)
        return ckpt

    def has_torch_state(self) -> bool:
        """Whether this is a ``from_torch`` checkpoint."""
        return self._directory is not None and os.path.isfile(
            os.path.join(self._directory, TORCH_STATE, _MANIFEST))

    def to_torch(self, device: DeviceLike = None):
        """The tree of a ``torch_state`` checkpoint, its leaves on
        ``device`` (CUDA by default), each the dtype and bits it was
        written with."""
        dev = resolve_device(device)
        target = os.path.join(self._directory or self.to_directory(),
                              TORCH_STATE)
        try:
            with open(os.path.join(target, _MANIFEST)) as f:
                manifest = json.load(f)
        except FileNotFoundError:
            raise ValueError("not a torch_state checkpoint (no "
                             f"{TORCH_STATE}/{_MANIFEST})") from None
        if manifest.get("format") != _FORMAT:
            raise ValueError(f"unknown torch_state format "
                             f"{manifest.get('format')!r}")
        tree: dict = {}
        with np.load(os.path.join(target, _LEAVES)) as npz:
            for spec in manifest["leaves"]:
                dtype = getattr(torch, spec["dtype"])
                arr = npz[spec["member"]]
                if dtype == torch.bfloat16:
                    t = torch.from_numpy(arr.view(np.int16)).view(dtype)
                else:
                    t = torch.from_numpy(arr)
                if t.dtype != dtype or list(t.shape) != spec["shape"]:
                    raise ValueError(f"leaf {spec['path']} does not match "
                                     f"its manifest entry")
                node = tree
                for key in spec["path"][:-1]:
                    node = node.setdefault(key, {})
                node[spec["path"][-1]] = t.to(dev)
        return tree

    # ---- conversions --------------------------------------------------------

    def to_dict(self) -> dict:
        if self._data is not None:
            return self._data
        meta_path = os.path.join(self._directory, "_ckpt_dict.pkl")
        if os.path.exists(meta_path):
            with open(meta_path, "rb") as f:
                return pickle.loads(f.read())
        raise ValueError(
            "directory checkpoint has no dict form (no _ckpt_dict.pkl)")

    def to_directory(self, path: str | None = None) -> str:
        if path is None:
            if self._materialized is not None \
                    and os.path.isdir(self._materialized):
                return self._materialized
            path = _own_tmpdir(self, tempfile.mkdtemp(prefix="rtpu_ckpt_"))
            self._materialized = path
        os.makedirs(path, exist_ok=True)
        if self._directory is not None:
            if os.path.abspath(self._directory) != os.path.abspath(path):
                shutil.copytree(self._directory, path, dirs_exist_ok=True)
        else:
            atomic_write(os.path.join(path, "_ckpt_dict.pkl"),
                         pickle.dumps(self._data))
        return path

    def to_bytes(self) -> bytes:
        if self._data is not None:
            return pickle.dumps(("dict", self._data))
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as tar:
            tar.add(self._directory, arcname=".")
        return pickle.dumps(("dir", buf.getvalue()))

    def to_uri(self, uri: str) -> str:
        """file:// URIs only."""
        if not uri.startswith("file://"):
            raise ValueError("only file:// URIs supported")
        return "file://" + self.to_directory(uri[len("file://"):])

    @classmethod
    def from_uri(cls, uri: str) -> "Checkpoint":
        if not uri.startswith("file://"):
            raise ValueError("only file:// URIs supported")
        return cls.from_directory(uri[len("file://"):])

    def __repr__(self):
        kind = "dict" if self._data is not None else f"dir:{self._directory}"
        return f"Checkpoint({kind})"


def _leaves_with_paths(tree, prefix=()):
    """(path, leaf) in sorted-key order, the order of ``_private/tree``."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            if not isinstance(key, str):
                raise TypeError(f"torch_state keys are strings; got "
                                f"{key!r} at {list(prefix)}")
            yield from _leaves_with_paths(tree[key], prefix + (key,))
    else:
        yield list(prefix), tree


def _tree_to_host(obj):
    """Tensor leaves to host numpy, so that checkpoints pickle without
    device memory; bf16 leaves (numpy has no bf16) stay torch tensors, on
    the host."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(obj, dict):
        return {k: _tree_to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_to_host(v) for v in obj)
    return obj
