"""Bucketed data-parallel gradient sync and the ZeRO-style sharded
optimizer, over the port's collective groups. Port of
``ray_tpu/train/ddp.py``.

- The grad tree is flattened in sorted-key order and planned into
  size-targeted buckets (``RAY_TPU_TORCH_TRAIN_GRAD_BUCKET_BYTES``, 4 MiB
  by default; ``parallel/sharding.plan_buckets``). Every rank derives the
  same buckets.
- Each bucket is packed into one tensor and its allreduce starts as
  soon as it is packed. On a gloo group the tensor is on the host
  (pinned, for CUDA grads) and the allreduce runs asynchronously, so
  bucket k's comm overlaps the packing of bucket k+1 and whatever the
  caller runs before ``result()``. On a group that keeps device tensors
  (``"device"``, ``"nccl"``) the bucket is packed on the grads' device
  and its reduction is kernels on the caller's stream: nothing crosses
  to the host.
- ``result()`` waits the buckets in launch order, unpacks each onto its
  leaves' device, and adds the time it was blocked to ``wait_s``.

Determinism contract (the twin's, ``ray_tpu/train/ddp.py:32-43``): all
ranks return byte-identical synced grads. At world 2 every element is one
two-operand IEEE add, which commutes, so bucketed sync is bit-identical
to the ``RAY_TPU_TORCH_TRAIN_BUCKET_DDP=0`` kill switch (one synchronous
allreduce over the whole tree, one per dtype), and the device group's
sync is gloo's. At larger worlds the reduction order follows the
backend (gloo's chunking, the device group's rank order) and the two
agree within float reassociation.

Not ported yet (ROADMAP Queue 1, "left out of the gang slice"): the
quantized wire, and the telemetry, memory-anatomy and profiler spans the
twin stamps. A poisoned group (``collective.abort_collective_group``)
fails the pending handles with ``CollectiveGroupError``.
"""
from __future__ import annotations

import time

import torch

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch.parallel import sharding as sh
from ray_tpu_torch.util import collective as col

_NO_WIRE = ("the quantized wire (wire_dtype) is not ported yet: see "
            "ROADMAP Queue 1, 'left out of the gang slice'")


class PendingGradSync:
    """In-flight bucketed gradient sync: every bucket's allreduce has been
    launched; ``result(timeout)`` waits them in launch order, unpacks, and
    returns the synced tree."""

    def __init__(self, treedef, leaves, launched, world: int,
                 average: bool):
        self._treedef = treedef
        self._leaves = leaves
        self._launched = launched    # [(indices, handle)]
        self._world = world
        self._average = average
        self._result = None
        self._out_leaves: list = [None] * len(leaves)
        self._next = 0               # harvest progress (retry-safe)
        self.num_buckets = len(launched)
        self.wait_s = 0.0            # time blocked in the bucket waits

    def poll(self) -> bool:
        """True once every bucket's allreduce completed."""
        return all(h.poll() for _, h in self._launched)

    def result(self, timeout: float | None = None):
        """Wait every bucket and return the synced tree. Raises
        ``TimeoutError`` on a stall (default: the group's timeout per
        bucket); a retry resumes at the first bucket not yet harvested."""
        if self._result is not None:
            return self._result
        while self._next < len(self._launched):
            b = self._next
            indices, handle = self._launched[b]
            t0 = time.perf_counter()
            flat = handle.result(timeout)
            self.wait_s += time.perf_counter() - t0
            if self._average:
                flat.div_(self._world)
            sh.unpack_bucket(flat, self._leaves, indices, self._out_leaves)
            self._next = b + 1
        self._result = sh.unflatten_tree(self._treedef, self._out_leaves)
        self._launched = []
        self._leaves = []
        return self._result


class _DoneSync:
    """Kill-switch or world-1 result: the sync already happened."""

    num_buckets = 0
    wait_s = 0.0

    def __init__(self, result):
        self._result = result

    def poll(self) -> bool:
        return True

    def result(self, timeout: float | None = None):
        return self._result


class PendingShardSync:
    """In-flight sharded (ZeRO-style) gradient sync: every bucket's
    reducescatter has been launched, and each handle resolves to this
    rank's ``[lo, hi)`` shard of the bucket's reduction (``shard_map``).
    ``wait_bucket(b)`` harvests one bucket; ``result()`` harvests all and
    returns the list of shards."""

    mode = "reducescatter"

    def __init__(self, shard_map, launched, world: int, average: bool):
        self._shard_map = shard_map
        self._launched = launched    # [handle]
        self._world = world
        self._average = average
        self._shards: list = [None] * len(launched)
        self._next = 0
        self.num_buckets = len(launched)
        self.wait_s = 0.0

    @property
    def shard_map(self):
        return self._shard_map

    def poll(self) -> bool:
        return all(h.poll() for h in self._launched)

    def _harvest_next(self, timeout: float | None):
        b = self._next
        t0 = time.perf_counter()
        flat = self._launched[b].result(timeout)
        self.wait_s += time.perf_counter() - t0
        if self._average:
            flat.div_(self._world)
        self._shards[b] = flat
        self._next = b + 1

    def wait_bucket(self, b: int, timeout: float | None = None):
        """This rank's reduced (or averaged) shard of bucket ``b``;
        harvests in launch order."""
        while self._next <= b:
            self._harvest_next(timeout)
        return self._shards[b]

    def result(self, timeout: float | None = None) -> list:
        while self._next < len(self._launched):
            self._harvest_next(timeout)
        self._launched = []
        return self._shards


class _DoneShardSync:
    """Kill-switch sharded result: the reducescatters already ran
    synchronously; same surface as ``PendingShardSync``."""

    mode = "reducescatter"
    wait_s = 0.0

    def __init__(self, shards, shard_map):
        self._shards = shards
        self._shard_map = shard_map

    @property
    def num_buckets(self) -> int:
        return len(self._shards)

    @property
    def shard_map(self):
        return self._shard_map

    def poll(self) -> bool:
        return True

    def wait_bucket(self, b: int, timeout: float | None = None):
        return self._shards[b]

    def result(self, timeout: float | None = None) -> list:
        return self._shards


def _resolve_mode(mode) -> str:
    """``mode``, or the ``train_ddp_mode`` knob (``RAY_TPU_TORCH_TRAIN_DDP_MODE``)
    when it is None, as ``ray_tpu``'s ``sync_gradients`` reads it."""
    m = mode if mode is not None else get_config("train_ddp_mode")
    m = str(m).strip().lower()
    if m not in ("allreduce", "reducescatter"):
        raise ValueError(
            f"train DDP mode {mode!r}: expected 'allreduce' (every rank "
            f"gets the full synced tree) or 'reducescatter' (ZeRO-style, "
            f"each rank gets its shard of every bucket)")
    return m


def _bucketed(group_name: str) -> bool:
    """Async per-bucket collectives, unless the kill switch is thrown or
    the group cannot run them."""
    return bool(get_config("train_bucket_ddp")) and col.supports_async(
        group_name)


def _launch_shards(flats, group_name: str, shard_map, *, average: bool):
    """One reducescatter per packed bucket of ``flats`` (an iterable, so a
    bucket goes on the wire before the next one is packed); each rank
    gets its ``shard_map`` shard. With the kill switch the same buckets
    go through synchronous reducescatters, so the shard map does not
    change with it."""
    world = col.get_collective_group_size(group_name)
    if not _bucketed(group_name):
        shards = []
        for flat in flats:
            shard = col.reducescatter(flat, group_name)
            if average:
                shard.div_(world)
            shards.append(shard)
        return _DoneShardSync(shards, shard_map)
    launched = [col.reducescatter_async(flat, group_name) for flat in flats]
    return PendingShardSync(shard_map, launched, world, average)


def _sync_shards_async(grads, group_name: str, *, average: bool,
                       bucket_bytes: int | None):
    """``mode="reducescatter"``: the grad tree's buckets, each
    reducescattered (``_launch_shards``)."""
    leaves, _ = sh.flatten_tree(grads)
    if bucket_bytes is None:
        bucket_bytes = int(get_config("train_grad_bucket_bytes"))
    plan = sh.plan_buckets(leaves, bucket_bytes)
    shard_map = sh.plan_shard_map(
        leaves, plan, col.get_collective_group_size(group_name))
    on_device = col.keeps_device(group_name)
    return _launch_shards((sh.pack_bucket(leaves, indices, on_device)
                           for indices in plan),
                          group_name, shard_map, average=average)


def sync_gradients_async(grads, group_name: str = "train_dp", *,
                         average: bool = False,
                         bucket_bytes: int | None = None,
                         mode: str | None = None,
                         wire_dtype=None):
    """Launch the bucketed gradient sync and return a pending sync at
    once; call ``.result()`` at the optimizer boundary.

    ``mode`` (the ``train_ddp_mode`` knob when None): ``allreduce``
    returns the full synced tree on every rank; ``reducescatter`` returns
    a ``PendingShardSync`` whose result is this rank's shard of each
    packed bucket. With
    ``RAY_TPU_TORCH_TRAIN_BUCKET_DDP=0`` the whole tree goes as one
    synchronous allreduce per dtype, done before this returns, and the
    sharded mode runs synchronous reducescatters over the same shard map.
    """
    mode = _resolve_mode(mode)
    if mode == "reducescatter":
        if wire_dtype is not None:
            raise NotImplementedError(_NO_WIRE)
        return _sync_shards_async(grads, group_name, average=average,
                                  bucket_bytes=bucket_bytes)
    if wire_dtype is not None:
        raise ValueError(
            "wire_dtype is a per-bucket opt-in on the reducescatter path; "
            "the allreduce mode has no wire option")
    leaves, treedef = sh.flatten_tree(grads)
    world = col.get_collective_group_size(group_name)
    if not leaves or world == 1:
        return _DoneSync(grads)
    if bucket_bytes is None:
        bucket_bytes = int(get_config("train_grad_bucket_bytes"))
    on_device = col.keeps_device(group_name)
    if not _bucketed(group_name):
        # the whole tree as one synchronous allreduce per dtype (a bucket
        # is contiguous in one dtype): what the kill switch promises
        out_leaves: list = [None] * len(leaves)
        for indices in sh.plan_buckets(leaves, 1 << 62):
            flat = col.allreduce(sh.pack_bucket(leaves, indices, on_device),
                                 group_name)
            if average:
                flat.div_(world)
            sh.unpack_bucket(flat, leaves, indices, out_leaves)
        return _DoneSync(sh.unflatten_tree(treedef, out_leaves))
    # pack on the caller's thread: bucket b's device-to-host copy runs
    # while buckets < b are already on the wire
    launched = [(indices,
                 col.allreduce_async(
                     sh.pack_bucket(leaves, indices, on_device), group_name))
                for indices in sh.plan_buckets(leaves, bucket_bytes)]
    return PendingGradSync(treedef, leaves, launched, world, average)


def sync_gradients(grads, group_name: str = "train_dp", *,
                   average: bool = False,
                   bucket_bytes: int | None = None,
                   mode: str | None = None,
                   wire_dtype=None):
    """Synchronize one grad tree across the gang and return the summed
    (or averaged) grads, or, in ``mode="reducescatter"``, the list of
    this rank's per-bucket shards. Blocks until the sync is done."""
    return sync_gradients_async(
        grads, group_name, average=average, bucket_bytes=bucket_bytes,
        mode=mode, wire_dtype=wire_dtype).result(timeout=None)


# ------------------------------------------------- sharded optimizer (ZeRO)
#
# Grads arrive per bucket by reducescatter, so each rank holds only its
# [lo, hi) shard of every bucket; the optimizer state for that shard lives
# only on its owner rank, on the host; the updated param shards return by
# async allgathers, waited at first use of the new params. On a group that
# keeps device tensors the grads are packed, reducescattered and the param
# shards allgathered on the card; only this rank's shard of each bucket
# crosses to the host for the optimizer and back.
#
# The shard optimizers are elementwise, so applying them per shard and
# gathering is the computation the legacy path runs on the full vector,
# element for element. At world 2 the reducescatter's shard is
# bit-identical to the same slice of the allreduce, so the params are
# bit-identical to allreduce + full apply. Each apply mirrors the twin's
# numpy arithmetic op by op, in place on host tensors: one rounding per
# op, no fused multiply-add (addcmul_, addcdiv_, lerp_, alpha=, foreach).


class _SgdShard:
    """Elementwise SGD (+momentum) on one shard; state: momentum only."""

    name = "sgd"

    def __init__(self, lr: float, momentum: float = 0.0):
        self.lr = float(lr)
        self.momentum = float(momentum)
        self.slots = 1 if momentum else 0

    def init(self, nelems: int, dtype):
        if not self.momentum:
            return {}
        return {"m": torch.zeros(nelems, dtype=dtype)}

    def apply(self, p, g, state, step: int):
        if self.momentum:
            m = state["m"]
            m.mul_(self.momentum)
            m.add_(g)
            p.sub_(m * self.lr)
        else:
            p.sub_(g * self.lr)
        return p


class _AdamShard:
    """Elementwise Adam on one shard; state: first and second moments."""

    name = "adam"
    slots = 2

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr = float(lr)
        self.b1 = float(b1)
        self.b2 = float(b2)
        self.eps = float(eps)

    def init(self, nelems: int, dtype):
        return {"m": torch.zeros(nelems, dtype=dtype),
                "v": torch.zeros(nelems, dtype=dtype)}

    def apply(self, p, g, state, step: int):
        m, v = state["m"], state["v"]
        m.mul_(self.b1)
        m.add_(g * (1.0 - self.b1))
        v.mul_(self.b2)
        v.add_((g * g) * (1.0 - self.b2))
        mhat = m / (1.0 - self.b1 ** step)
        vhat = v / (1.0 - self.b2 ** step)
        p.sub_((mhat * self.lr) / (_sqrt(vhat) + self.eps))
        return p


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as numpy's. torch's f32 sqrt on
    the CPU is not (one ulp off on ~0.6% of elements, AVX-512 build); the
    f64 square root rounded to f32 is, since 53 >= 2 * 24 + 2 bits."""
    return torch.sqrt(x.double()).to(x.dtype)


def zero_sgd(lr: float, momentum: float = 0.0) -> _SgdShard:
    """Shard optimizer for :class:`ZeroOptimizer`: elementwise SGD."""
    return _SgdShard(lr, momentum)


def zero_adam(lr: float, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8) -> _AdamShard:
    """Shard optimizer for :class:`ZeroOptimizer`: elementwise Adam."""
    return _AdamShard(lr, b1, b2, eps)


class PendingParams:
    """In-flight sharded apply: every bucket's updated param shard has an
    allgather in flight. ``result()`` waits them, trims each rank's padded
    shard to its bounds, reassembles the packed buckets and returns the
    new params tree, on the devices of the params it was given."""

    def __init__(self, treedef, leaves, plan, shard_map, gathers,
                 wait_s: float = 0.0):
        self._treedef = treedef
        self._leaves = leaves
        self._plan = plan
        self._shard_map = shard_map
        self._gathers = gathers      # [(b, handle)]
        self._result = None
        # time blocked in the step's bucket waits: its reducescatters, then
        # the gathers that result() waits for
        self.wait_s = wait_s
        self.num_buckets = len(gathers)

    def poll(self) -> bool:
        return all(h.poll() for _, h in self._gathers)

    def result(self, timeout: float | None = None):
        """The updated params tree; blocks on any allgather in flight."""
        if self._result is not None:
            return self._result
        out_leaves: list = [None] * len(self._leaves)
        for b, handle in self._gathers:
            t0 = time.perf_counter()
            parts = handle.result(timeout)
            self.wait_s += time.perf_counter() - t0
            # shards are contiguous in rank order: the packed bucket is
            # their concatenation, each trimmed of its padding
            done = torch.cat([part[:hi - lo] for part, (lo, hi) in
                              zip(parts, self._shard_map[b]["bounds"])])
            sh.unpack_bucket(done, self._leaves, self._plan[b], out_leaves)
        # leaves no bucket covered (an empty tree) stay as they were
        for i, leaf in enumerate(self._leaves):
            if out_leaves[i] is None:
                out_leaves[i] = leaf
        self._result = sh.unflatten_tree(self._treedef, out_leaves)
        self._gathers = []
        self._leaves = []
        return self._result


class _DoneHandle:
    """A completed handle for the kill-switch path: the op already ran."""

    def __init__(self, value):
        self._value = value

    def poll(self) -> bool:
        return True

    def result(self, timeout: float | None = None):
        return self._value


class ZeroOptimizer:
    """ZeRO-style sharded optimizer over the DDP bucket plan.

    Each rank owns the ``[lo, hi)`` shard of every packed bucket that the
    shard map (``parallel/sharding.plan_shard_map``) gives it, holds
    optimizer state, on the host, for that shard only, and updates only
    those elements: ``state_bytes()`` is about
    ``replicated_state_bytes() / world``. On a group that keeps device
    tensors the grads, their accumulators and the gathered params stay
    on the card, and the shard's optimizer runs on the host.

    ``step_async`` folds the grads bucket by bucket and launches each
    bucket's reducescatter; then, bucket by bucket, it waits this rank's
    shard, applies the optimizer to it and launches the allgather of the
    updated param shard. The returned :class:`PendingParams` waits the
    gathers at first use. ``accumulate(grads)`` folds earlier microbatches
    into accumulators with no comm. ``state_budget_bytes`` caps this
    rank's shard state: materializing more raises.
    """

    def __init__(self, opt, group_name: str = "train_dp", *,
                 bucket_bytes: int | None = None, wire_dtype=None,
                 state_budget_bytes: int | None = None,
                 average: bool = False):
        if wire_dtype is not None:
            raise NotImplementedError(_NO_WIRE)
        self._opt = opt
        self._group = group_name
        self._bucket_bytes = bucket_bytes
        self._budget = state_budget_bytes
        self._average = average
        self._plan = None
        self._shard_map = None
        self._sig = None             # (shape, dtype) leaf signature
        self._state: dict = {}       # bucket -> this rank's state dict
        self._acc: list | None = None
        self._step = 0
        self._world = None
        self._rank = None
        self._fingerprint = None
        self._pending_state = None   # load_shard_state_dict before plan

    # ------------------------------------------------------------ plan
    def _ensure_plan(self, leaves):
        sig = tuple((tuple(leaf.shape), sh.dtype_name(leaf))
                    for leaf in leaves)
        if sig == self._sig:
            return
        if self._sig is not None:
            raise ValueError(
                "ZeroOptimizer: param/grad tree structure changed; the "
                "bucket shard map (and the optimizer state sharded over "
                "it) is derived from leaf shapes and cannot be remapped "
                "in place")
        bucket_bytes = self._bucket_bytes
        if bucket_bytes is None:
            bucket_bytes = int(get_config("train_grad_bucket_bytes"))
        self._world = col.get_collective_group_size(self._group)
        self._rank = col.get_rank(self._group)
        self._plan = sh.plan_buckets(leaves, bucket_bytes)
        self._shard_map = sh.plan_shard_map(leaves, self._plan, self._world)
        self._sig = sig
        self._fingerprint = sh.plan_fingerprint(leaves, self._plan)
        if self._pending_state is not None:
            self._install_pending_state()

    def _my_bounds(self, b: int):
        return self._shard_map[b]["bounds"][self._rank]

    # ----------------------------------------------------------- state
    def _shard_state(self, b: int) -> dict:
        st = self._state.get(b)
        if st is None:
            lo, hi = self._my_bounds(b)
            st = self._opt.init(hi - lo, self._shard_map[b]["dtype"])
            self._state[b] = st
            self._check_budget()
        return st

    def _check_budget(self):
        total = self.state_bytes()
        if self._budget is not None and total > self._budget:
            raise RuntimeError(
                f"ZeroOptimizer: this rank's optimizer-state shard "
                f"({int(total)} bytes) exceeds the per-rank budget "
                f"({int(self._budget)} bytes): raise the budget, grow the "
                f"gang, or use a lighter optimizer")

    def state_bytes(self) -> float:
        """Bytes of this rank's materialized shard state."""
        return float(sum(t.nbytes for st in self._state.values()
                         for t in st.values()))

    def replicated_state_bytes(self) -> float:
        """What one rank would hold if the state were replicated: slots x
        elements x itemsize over the whole plan."""
        if self._shard_map is None:
            raise ValueError("ZeroOptimizer: no plan yet (run a step or "
                             "accumulate first)")
        slots = int(getattr(self._opt, "slots", 0))
        return float(sum(e["elems"] * e["dtype"].itemsize * slots
                         for e in self._shard_map))

    @property
    def shard_map(self):
        return self._shard_map

    @property
    def step_count(self) -> int:
        return self._step

    @property
    def plan_fingerprint(self) -> str | None:
        """World-independent identity of the bucket plan; None before the
        first step or accumulate."""
        return self._fingerprint

    # ------------------------------------------- sharded checkpoint I/O
    def shard_state_dict(self) -> dict:
        """This rank's optimizer-state shard: per-bucket slot tensors
        (copies) covering only this rank's ``[lo, hi)`` of each bucket,
        the step count and the plan fingerprint."""
        if self._plan is None:
            raise ValueError("ZeroOptimizer: no plan yet (run a step or "
                             "accumulate first)")
        buckets = [{k: v.clone() for k, v in self._shard_state(b).items()}
                   for b in range(len(self._plan))]
        return {"step": self._step, "plan_fingerprint": self._fingerprint,
                "world": self._world, "rank": self._rank,
                "buckets": buckets}

    def load_shard_state_dict(self, state: dict):
        """Install a shard-state dict (from :meth:`shard_state_dict`).
        Before the first step the plan is unknown, so the state waits and
        is installed, and verified, when the plan is established."""
        self._pending_state = dict(state)
        if self._plan is not None:
            self._install_pending_state()

    def _install_pending_state(self):
        pend, self._pending_state = self._pending_state, None
        fp = pend.get("plan_fingerprint")
        if fp is not None and fp != self._fingerprint:
            raise ValueError(
                f"ZeroOptimizer: checkpointed plan fingerprint {fp[:12]}... "
                f"does not match this model's {self._fingerprint[:12]}...: "
                f"the saved shards were cut over another leaf signature or "
                f"bucket plan")
        buckets = pend.get("buckets", [])
        if len(buckets) != len(self._plan):
            raise ValueError(
                f"ZeroOptimizer: checkpoint has {len(buckets)} bucket "
                f"states, plan has {len(self._plan)} buckets")
        states = []
        for b, st in enumerate(buckets):
            lo, hi = self._my_bounds(b)
            st = {slot: torch.as_tensor(arr) for slot, arr in st.items()}
            for slot, t in st.items():
                if t.numel() != hi - lo:
                    raise ValueError(
                        f"ZeroOptimizer: bucket {b} slot {slot!r} has "
                        f"{t.numel()} elements, this rank's shard is "
                        f"{hi - lo}")
            states.append(st)
        self._state = dict(enumerate(states))
        self._step = int(pend.get("step", 0))
        self._check_budget()

    # ------------------------------------------------------------ step
    def accumulate(self, grads):
        """Fold one microbatch's grads into the accumulators, packed as
        the sync packs them (pack and add, no comm). Pass the last
        microbatch to ``step_async``."""
        leaves, _ = sh.flatten_tree(grads)
        self._ensure_plan(leaves)
        if self._acc is None:
            self._acc = [None] * len(self._plan)
        on_device = col.keeps_device(self._group)
        for b, indices in enumerate(self._plan):
            flat = sh.pack_bucket(leaves, indices, on_device)
            if self._acc[b] is None:
                self._acc[b] = flat   # pack allocates: safe to own
            else:
                self._acc[b] += flat

    def step_async(self, params, grads=None,
                   timeout: float | None = None) -> PendingParams:
        """One sharded optimizer step; returns a :class:`PendingParams`
        with the allgathers in flight. ``grads`` is the last (or only)
        microbatch, optional when ``accumulate`` folded everything."""
        leaves, treedef = sh.flatten_tree(params)
        self._ensure_plan(leaves)
        if grads is None and self._acc is None:
            raise ValueError("ZeroOptimizer.step_async: no grads: pass "
                             "grads= or call accumulate() first")
        gleaves = None if grads is None else sh.flatten_tree(grads)[0]
        self._step += 1
        acc, self._acc = self._acc, None
        on_device = col.keeps_device(self._group)

        def folded():  # bucket b's grads, packed and folded
            for b, indices in enumerate(self._plan):
                if gleaves is None:
                    yield acc[b]
                    continue
                flat = sh.pack_bucket(gleaves, indices, on_device)
                if acc is not None and acc[b] is not None:
                    flat += acc[b]
                yield flat

        # launch: each bucket's reducescatter goes on the wire as soon as
        # it is folded
        shards = _launch_shards(folded(), self._group, self._shard_map,
                                average=self._average)
        bucketed = isinstance(shards, PendingShardSync)
        # harvest: wait shard b, apply, launch its allgather, while bucket
        # b+1's reducescatter and buckets < b's allgathers are in flight
        gathers = []
        for b, indices in enumerate(self._plan):
            lo, hi = self._my_bounds(b)
            pshard = sh.pack_span(leaves, indices, lo, hi)
            # the shard's optimizer runs on the host
            gshard = shards.wait_bucket(b, timeout).cpu()
            pshard = self._opt.apply(pshard, gshard, self._shard_state(b),
                                     self._step)
            # gloo and NCCL gather equal sizes only: pad to the bucket's
            # widest shard, and PendingParams trims to the bounds
            width = max(h - l for l, h in self._shard_map[b]["bounds"])
            if pshard.numel() < width:
                pshard = torch.cat(
                    [pshard, pshard.new_zeros(width - pshard.numel())])
            if on_device:
                pshard = pshard.to(leaves[indices[0]].device)
            if bucketed:
                gathers.append((b, col.allgather_async(pshard, self._group)))
            else:
                gathers.append(
                    (b, _DoneHandle(col.allgather(pshard, self._group))))
        return PendingParams(treedef, leaves, self._plan, self._shard_map,
                             gathers, shards.wait_s)

    def step(self, params, grads=None, timeout: float | None = None):
        """Blocking convenience: ``step_async(...).result()``."""
        return self.step_async(params, grads, timeout).result(timeout)
