"""Crash-consistent sharded checkpoints with world-elastic restore. Port of
``ray_tpu/train/sharded_checkpoint.py``, on the same on-disk format, so a
generation written by either package restores in the other.

- **Per-rank shard writes.** Each rank writes only its ZeRO shard: its
  ``[lo, hi)`` span of every packed param bucket and the optimizer slots
  of that span, keyed by the bucket plan (``parallel/sharding``), as one
  ``shard_RRRRR_of_WWWWW.npz`` (members ``param_{b}``, ``opt_{b}_{slot}``
  and ``meta``, JSON as uint8) through ``_private/atomic_write``, with its
  sha256 recorded. Params come from the torch leaves, wherever they
  live; optimizer slots from ``train.ddp.ZeroOptimizer.shard_state_dict``.
- **Two-phase commit.** The ranks ack their shard's digest over the
  collective group (``allgather_object``, on any backend); then rank 0 alone writes the
  generation's ``MANIFEST.json`` (world, plan fingerprint, buckets,
  slots, every shard's file, digest and size) the same way. A generation
  without a manifest is torn and invisible to restore. Without a group,
  rank 0's harvest acks by scanning the other ranks' files.
- **Corruption detection and fallback.** Restore checks the plan
  fingerprint and every shard's size and digest; a bad or torn
  generation is renamed ``*.quarantined`` and restore falls back to the
  newest good one. ``prune_generations`` never deletes the newest
  generation that verifies complete.
- **World-elastic restore.** A gang restarting at another world size
  reslices the saved shards onto its own shard map
  (``parallel/sharding.reslice_spans``); ``meta["resharded"]`` says so.
- **Async save.** ``save_sharded(..., asynchronous=True)`` (the
  ``checkpoint_async`` knob's default) serializes the shard on the
  caller's thread, so the state saved is the state at call time, and
  writes it on a background thread; the commit runs when every rank
  harvests the returned :class:`PendingSnapshot` at the same point of
  its collective sequence.

Not ported (ROADMAP): the twin's step-anatomy stamps, telemetry,
``CHECKPOINT_*`` events and fault-plane hooks; ``summarize_checkpoints``
is here, the CLI that prints it is not.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from ray_tpu_torch._private.atomic_write import atomic_write, fsync_dir
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch.parallel import sharding as sh
from ray_tpu_torch.util import collective as col

GEN_PREFIX = "gen_"
MANIFEST = "MANIFEST.json"
QUARANTINE_SUFFIX = ".quarantined"
_DIGEST_CHUNK = 1 << 20


class CheckpointError(RuntimeError):
    pass


def default_root() -> str | None:
    """The ``checkpoint_dir`` knob (``RAY_TPU_TORCH_CHECKPOINT_DIR``), or
    None when it is empty."""
    return get_config("checkpoint_dir") or None


def shard_filename(rank: int, world: int) -> str:
    return f"shard_{int(rank):05d}_of_{int(world):05d}.npz"


def generation_dir(root: str, step: int) -> str:
    return os.path.join(root, f"{GEN_PREFIX}{int(step):08d}")


def _gen_step(dirname: str) -> int | None:
    base = os.path.basename(dirname.rstrip(os.sep))
    if not base.startswith(GEN_PREFIX) or base.endswith(QUARANTINE_SUFFIX):
        return None
    try:
        return int(base[len(GEN_PREFIX):])
    except ValueError:
        return None


def _list_generations(root: str) -> list:
    """[(step, path)] of the live (not quarantined) generations, newest
    first."""
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for name in names:
        path = os.path.join(root, name)
        step = _gen_step(path)
        if step is not None and os.path.isdir(path):
            out.append((step, path))
    out.sort(reverse=True)
    return out


def _file_sha256(path: str) -> str:
    """Digest of a file, read in chunks: a shard is never held whole."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_DIGEST_CHUNK)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as a numpy array of its dtype."""
    try:
        return t.detach().cpu().numpy()
    except TypeError as e:
        raise CheckpointError(
            f"sharded checkpoints store numpy dtypes; a {t.dtype} leaf or "
            f"slot has none") from e


# ----------------------------------------------------------------- save


def _build_shard_payload(params, optimizer, bucket_bytes, world, rank,
                         step, extra):
    """This rank's shard as (npz bytes, the meta the manifest reads).
    Param spans are packed from the leaves (``pack_span``: only this
    rank's ``[lo, hi)`` of each bucket is copied); optimizer slots come
    from ``ZeroOptimizer.shard_state_dict()``, already this rank's."""
    leaves, _ = sh.flatten_tree(params)
    if optimizer is not None:
        optimizer._ensure_plan(leaves)
        plan = optimizer._plan
        shard_map = optimizer._shard_map
        fingerprint = optimizer.plan_fingerprint
        opt_state = optimizer.shard_state_dict()
        step = int(step if step is not None else opt_state["step"])
        slots = sorted({k for st in opt_state["buckets"] for k in st})
    else:
        if bucket_bytes is None:
            bucket_bytes = int(get_config("train_grad_bucket_bytes"))
        plan = sh.plan_buckets(leaves, bucket_bytes)
        shard_map = sh.plan_shard_map(leaves, plan, world)
        fingerprint = sh.plan_fingerprint(leaves, plan)
        opt_state = None
        step = int(step or 0)
        slots = []
    arrays = {}
    for b, indices in enumerate(plan):
        lo, hi = shard_map[b]["bounds"][rank]
        arrays[f"param_{b}"] = _to_numpy(sh.pack_span(leaves, indices, lo, hi))
        if opt_state is not None:
            for slot, arr in opt_state["buckets"][b].items():
                arrays[f"opt_{b}_{slot}"] = (
                    _to_numpy(arr) if isinstance(arr, torch.Tensor)
                    else np.asarray(arr))
    meta = {"rank": int(rank), "world": int(world), "step": step,
            "plan_fingerprint": fingerprint, "buckets": len(plan),
            "slots": slots, "extra": extra if extra is not None else {}}
    arrays["meta"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8).copy()
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue(), meta


class PendingSnapshot:
    """One sharded checkpoint save in flight. ``result(timeout)`` joins the
    shard's write (if it runs in the background), runs the two-phase
    commit, and returns::

        {"committed": bool, "path": generation dir, "step": int,
         "manifest": dict | None, "error": str | None}

    With a group, every rank must harvest at the same point of its
    collective sequence: the commit's ack is an ``allgather_object``.
    ``snapshot_s`` (serializing on the caller's thread), ``write_s`` (the
    disk write) and ``wait_s`` (time ``result`` blocked on the write)
    say where a save's time went; ``nbytes`` is the shard's size."""

    def __init__(self, root, gen_dir, step, world, rank, group_name,
                 keep, data, meta, asynchronous, snapshot_s=0.0):
        self._root = root
        self._gen = gen_dir
        self._step = step
        self._world = world
        self._rank = rank
        self._group = group_name
        self._keep = keep
        self._data = data
        self._meta = meta
        self._write_error: str | None = None
        self._digest: str | None = None
        self._result: dict | None = None
        self._thread: threading.Thread | None = None
        self.nbytes = len(data)
        self.snapshot_s = snapshot_s
        self.write_s = 0.0
        self.wait_s = 0.0
        if asynchronous:
            self._thread = threading.Thread(
                target=self._write, name="ckpt-write", daemon=True)
            self._thread.start()
        else:
            self._write()

    # ------------------------------------------------------------ write
    def _write(self):
        path = os.path.join(self._gen, shard_filename(self._rank,
                                                      self._world))
        t0 = time.perf_counter()
        try:
            os.makedirs(self._gen, exist_ok=True)
            # the digest of the bytes meant to be on disk, not a re-read:
            # a flip between write and read-back must fail restore's check
            self._digest = hashlib.sha256(self._data).hexdigest()
            atomic_write(path, self._data)
        except BaseException as e:
            self._write_error = f"{type(e).__name__}: {e}"
        finally:
            self._data = b""
            self.write_s = time.perf_counter() - t0

    def done_writing(self) -> bool:
        return self._thread is None or not self._thread.is_alive()

    def _scan_acks(self, own_ack):
        acks = [own_ack]
        for r in range(self._world):
            if r == self._rank:
                continue
            path = os.path.join(self._gen, shard_filename(r, self._world))
            try:
                acks.append((r, _file_sha256(path),
                             os.path.getsize(path), None))
            except OSError as e:
                acks.append((r, None, 0,
                             f"shard not on disk: {type(e).__name__}"))
        return acks

    # ----------------------------------------------------------- commit
    def result(self, timeout: float | None = None) -> dict:
        if self._result is not None:
            return self._result
        if self._thread is not None:
            t0 = time.perf_counter()
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"sharded checkpoint shard write still in flight "
                    f"after {timeout}s ({self._gen})")
            self.wait_s = time.perf_counter() - t0
        ack = (self._rank, self._digest, self.nbytes, self._write_error)
        if self._world > 1 and self._group:
            acks = col.allgather_object(ack, self._group)
        elif self._world > 1:
            # a groupless multi-rank save (ranks that share no collective
            # group): the ack is a scan of the directory, so rank 0's
            # result() must run after every rank's write
            acks = self._scan_acks(ack)
        else:
            acks = [ack]
        acks = sorted(acks, key=lambda a: a[0])
        errors = {r: err for r, _, _, err in acks if err}
        manifest = None
        if not errors and self._rank == 0:
            manifest = {
                "step": self._step, "world": self._world,
                "plan_fingerprint": self._meta["plan_fingerprint"],
                "buckets": self._meta["buckets"],
                "slots": self._meta["slots"],
                "shards": {str(r): {"file": shard_filename(r, self._world),
                                    "sha256": digest, "bytes": n}
                           for r, digest, n, _ in acks},
            }
            try:
                atomic_write(os.path.join(self._gen, MANIFEST),
                             json.dumps(manifest, indent=1).encode())
            except BaseException as e:
                errors[0] = f"{type(e).__name__}: {e}"
                manifest = None
        if not errors:
            if self._rank == 0 and self._keep:
                prune_generations(self._root, self._keep)
            self._result = {"committed": True, "path": self._gen,
                            "step": self._step, "manifest": manifest,
                            "error": None}
        else:
            # torn by definition: no manifest was, or ever will be,
            # written for this generation, so restore cannot see it
            err = "; ".join(f"rank {r}: {m}" for r, m in
                            sorted(errors.items()))
            self._result = {"committed": False, "path": self._gen,
                            "step": self._step, "manifest": None,
                            "error": err}
        return self._result


def _world_and_rank(group_name, world, rank):
    if world is None and group_name:
        world = col.get_collective_group_size(group_name)
        rank = col.get_rank(group_name) if rank is None else rank
    return (1 if world is None else int(world),
            0 if rank is None else int(rank))


def save_sharded(params, optimizer=None, *, root: str | None = None,
                 step: int | None = None, group_name: str | None = None,
                 world: int | None = None, rank: int | None = None,
                 bucket_bytes: int | None = None, extra: dict | None = None,
                 asynchronous: bool | None = None,
                 keep: int | None = None) -> PendingSnapshot:
    """Cut one sharded checkpoint generation; returns a
    :class:`PendingSnapshot` (already written when synchronous: harvest
    ``result()`` either way for the commit's verdict).

    ``params`` is the full (replicated) param tree, its leaves on any
    device; ``optimizer`` a ``train.ddp.ZeroOptimizer`` whose shard state
    (step count included) is saved with it. Without an optimizer the
    same sharded layout holds the params alone. ``world`` and ``rank``
    default to the optimizer's gang, else to ``group_name``'s, else to
    1 and 0; ``extra`` is a small JSON-able dict kept in every shard's
    meta; ``keep`` prunes to that many committed generations after the
    commit."""
    if optimizer is not None:
        leaves, _ = sh.flatten_tree(params)
        optimizer._ensure_plan(leaves)
        world = optimizer._world if world is None else world
        rank = optimizer._rank if rank is None else rank
        group_name = group_name or optimizer._group
    world, rank = _world_and_rank(group_name, world, rank)
    root = root or default_root()
    if not root:
        raise CheckpointError(
            "save_sharded: no checkpoint root: pass root= or set "
            "RAY_TPU_TORCH_CHECKPOINT_DIR")
    if asynchronous is None:
        asynchronous = bool(get_config("checkpoint_async"))
    t0 = time.perf_counter()
    data, meta = _build_shard_payload(params, optimizer, bucket_bytes,
                                      world, rank, step, extra)
    return PendingSnapshot(root, generation_dir(root, meta["step"]),
                           meta["step"], world, rank, group_name, keep, data,
                           meta, asynchronous, time.perf_counter() - t0)


# -------------------------------------------------------------- verify


def _load_manifest(gen_dir: str) -> dict | None:
    try:
        with open(os.path.join(gen_dir, MANIFEST), "rb") as f:
            return json.loads(f.read().decode())
    except (OSError, ValueError):
        return None


def verify_generation(gen_dir: str, fingerprint: str | None = None,
                      digests: bool = True) -> dict:
    """Checks one generation and changes nothing. Returns ``{"ok": bool,
    "reason": str | None, "shard": str | None, "manifest": dict | None}``;
    the reason is one of ``torn`` (no or unreadable manifest),
    ``plan_mismatch``, ``shard_missing``, ``size_mismatch`` and
    ``digest_mismatch``."""
    manifest = _load_manifest(gen_dir)
    if manifest is None:
        return {"ok": False, "reason": "torn", "shard": None,
                "manifest": None}
    if fingerprint is not None and \
            manifest.get("plan_fingerprint") != fingerprint:
        return {"ok": False, "reason": "plan_mismatch", "shard": None,
                "manifest": manifest}
    for r in sorted(manifest.get("shards", {}), key=int):
        spec = manifest["shards"][r]
        path = os.path.join(gen_dir, spec["file"])
        if not os.path.isfile(path):
            return {"ok": False, "reason": "shard_missing",
                    "shard": spec["file"], "manifest": manifest}
        if os.path.getsize(path) != int(spec["bytes"]):
            return {"ok": False, "reason": "size_mismatch",
                    "shard": spec["file"], "manifest": manifest}
        if digests and _file_sha256(path) != spec["sha256"]:
            return {"ok": False, "reason": "digest_mismatch",
                    "shard": spec["file"], "manifest": manifest}
    return {"ok": True, "reason": None, "shard": None,
            "manifest": manifest}


def _quarantine(gen_dir: str) -> str:
    """Renames a bad or torn generation out of restore's sight; the
    wreckage is kept as evidence. Every rank restores at once and may
    find the same generation: a rank whose rename fails because a peer
    already moved it leaves it there."""
    target = gen_dir + QUARANTINE_SUFFIX
    try:
        os.rename(gen_dir, target)
        fsync_dir(os.path.dirname(gen_dir) or ".")
    except OSError:
        # the source is still there: older wreckage of the same step
        # holds the name, so replace it and try again
        if os.path.isdir(gen_dir):
            shutil.rmtree(target, ignore_errors=True)
            try:
                os.rename(gen_dir, target)
                fsync_dir(os.path.dirname(gen_dir) or ".")
            except OSError:
                target = gen_dir
    return target


# ------------------------------------------------------------- restore


def restore_sharded(params_template, optimizer=None, *,
                    root: str | None = None,
                    group_name: str | None = None,
                    world: int | None = None, rank: int | None = None,
                    bucket_bytes: int | None = None,
                    quarantine: bool = True):
    """Restore from the newest generation under ``root`` that verifies,
    reslicing the saved shards onto this world size when it differs from
    the saved one. Bad or torn generations on the way are quarantined
    (unless ``quarantine`` is False) and restore falls back to the next
    older one.

    Returns ``(params, meta)``: ``params`` shaped like
    ``params_template``, each leaf on its template leaf's device, and
    ``meta`` with ``step``, ``path``, ``world_saved``, ``resharded`` and
    ``extra``; or None when no generation restores. With ``optimizer``,
    this rank's slots (its span only) and the step count are installed
    through ``load_shard_state_dict``."""
    if optimizer is not None and world is None:
        # a fresh optimizer has no plan yet; its group names the world
        group_name = group_name or optimizer._group
    world, rank = _world_and_rank(group_name, world, rank)
    root = root or default_root()
    if not root or not os.path.isdir(root):
        return None
    leaves, treedef = sh.flatten_tree(params_template)
    if bucket_bytes is None and optimizer is not None:
        bucket_bytes = optimizer._bucket_bytes
    if bucket_bytes is None:
        bucket_bytes = int(get_config("train_grad_bucket_bytes"))
    plan = sh.plan_buckets(leaves, bucket_bytes)
    shard_map = sh.plan_shard_map(leaves, plan, world)
    fingerprint = sh.plan_fingerprint(leaves, plan)
    chosen = None
    for step, gen_dir in _list_generations(root):
        verdict = verify_generation(gen_dir, fingerprint)
        if verdict["ok"]:
            chosen = (step, gen_dir, verdict["manifest"])
            break
        if quarantine:
            _quarantine(gen_dir)
    if chosen is None:
        return None
    step, gen_dir, manifest = chosen
    old_world = int(manifest["world"])
    slots = list(manifest.get("slots", ()))
    payloads: dict = {}  # old rank -> lazy npz handle

    def payload(r: int):
        z = payloads.get(r)
        if z is None:
            z = np.load(os.path.join(gen_dir,
                                     manifest["shards"][str(r)]["file"]))
            payloads[r] = z
        return z

    out_leaves: list = [None] * len(leaves)
    opt_buckets: list = []
    try:
        meta0 = json.loads(bytes(payload(0)["meta"]).decode())
        for b, indices in enumerate(plan):
            # every rank gets the full params: the old ranks' spans of a
            # bucket, in rank order, are the packed bucket
            flat = np.concatenate([payload(r)[f"param_{b}"]
                                   for r in range(old_world)])
            sh.unpack_bucket(torch.from_numpy(flat), leaves, indices,
                             out_leaves)
            # optimizer slots: this rank's [lo, hi) only, read from the
            # old shards whose spans overlap it
            if optimizer is not None:
                spans = sh.reslice_spans(shard_map[b]["elems"], old_world,
                                         world, rank)
                opt_buckets.append({slot: torch.from_numpy(np.concatenate(
                    [payload(r)[f"opt_{b}_{slot}"][lo:hi]
                     for r, lo, hi in spans])) if spans else
                    torch.zeros(0, dtype=shard_map[b]["dtype"])
                    for slot in slots})
    finally:
        for z in payloads.values():
            z.close()
    for i, leaf in enumerate(leaves):
        if out_leaves[i] is None:
            out_leaves[i] = leaf
    params = sh.unflatten_tree(treedef, out_leaves)
    if optimizer is not None:
        optimizer.load_shard_state_dict({
            "step": int(manifest["step"]),
            "plan_fingerprint": manifest["plan_fingerprint"],
            "buckets": opt_buckets})
    return params, {"step": int(manifest["step"]), "path": gen_dir,
                    "world_saved": old_world,
                    "resharded": old_world != world,
                    "extra": meta0.get("extra", {})}


# ------------------------------------------------------------- pruning


def prune_generations(root: str, keep: int) -> list:
    """Keeps the newest ``keep`` committed generations and, whatever
    ``keep`` says, the newest one that verifies complete (manifest, and
    every shard at its manifested size: digests are restore's job). Torn
    generations older than the newest committed one are removed, and so
    is quarantined wreckage older than the oldest kept generation.
    Returns the removed paths."""
    keep = max(1, int(keep))
    gens = _list_generations(root)  # newest first
    committed = [(s, p) for s, p in gens if _load_manifest(p) is not None]
    keep_paths = {p for _, p in committed[:keep]}
    for _, p in committed:
        if verify_generation(p, digests=False)["ok"]:
            keep_paths.add(p)
            break
    newest_committed = committed[0][0] if committed else None
    removed = []
    for s, p in gens:
        if p in keep_paths:
            continue
        if _load_manifest(p) is None and (newest_committed is None
                                          or s >= newest_committed):
            continue  # maybe a save in flight: not ours to judge
        shutil.rmtree(p, ignore_errors=True)
        removed.append(p)
    oldest_kept = min((_gen_step(p) for p in keep_paths
                       if _gen_step(p) is not None), default=None)
    try:
        names = os.listdir(root)
    except OSError:
        names = []
    for name in names:
        if not name.endswith(QUARANTINE_SUFFIX):
            continue
        step = _gen_step(os.path.join(root, name[:-len(QUARANTINE_SUFFIX)]))
        if step is None or oldest_kept is None or step < oldest_kept:
            path = os.path.join(root, name)
            shutil.rmtree(path, ignore_errors=True)
            removed.append(path)
    return removed


# ------------------------------------------------------------- summary


def summarize_checkpoints(root: str, digests: bool = True) -> list:
    """Every generation under ``root``, newest first: ``{"step", "path",
    "status", "world", "shards", "bytes", "reason", "shard"}``, with
    status ``committed``, ``torn``, ``corrupt`` or ``quarantined``."""
    out = []
    for step, gen_dir in _list_generations(root):
        verdict = verify_generation(gen_dir, digests=digests)
        manifest = verdict["manifest"]
        status = "committed" if verdict["ok"] else (
            "torn" if verdict["reason"] == "torn" else "corrupt")
        out.append({
            "step": step, "path": gen_dir, "status": status,
            "world": manifest["world"] if manifest else None,
            "shards": len(manifest["shards"]) if manifest else
            sum(1 for n in os.listdir(gen_dir) if n.startswith("shard_")),
            "bytes": sum(int(s["bytes"]) for s in manifest["shards"].values())
            if manifest else None,
            "reason": verdict["reason"], "shard": verdict["shard"],
        })
    try:
        names = os.listdir(root)
    except OSError:
        names = []
    for name in sorted(names, reverse=True):
        if name.endswith(QUARANTINE_SUFFIX):
            path = os.path.join(root, name)
            out.append({"step": _gen_step(path[:-len(QUARANTINE_SUFFIX)]),
                        "path": path, "status": "quarantined",
                        "world": None, "shards": None, "bytes": None,
                        "reason": None, "shard": None})
    out.sort(key=lambda e: (e["step"] is None, -(e["step"] or 0)))
    return out
