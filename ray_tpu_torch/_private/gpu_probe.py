"""GPU discovery, per-device memory gauges and a node's GPU resources: the
twin of ``ray_tpu/_private/tpu_probe.py`` and of the chip detection in
``ray_tpu/_private/raylet.py`` (``detect_resources``,
``detect_tpu_topology``).

Every probe here runs ``nvidia-smi`` in a SUBPROCESS with a timeout and
never touches CUDA in the calling process: a CUDA context made in a
raylet-like parent breaks the workers it forks later, and binds the
process to the devices visible at that moment, so a later
``CUDA_VISIBLE_DEVICES`` meant for it would have no effect. So no
``torch.cuda`` call that initializes CUDA runs here. ``nvidia-smi``
ignores ``CUDA_VISIBLE_DEVICES``; the probe applies it itself (indices or
UUIDs, in the listed order, up to the first entry that names no device,
as the CUDA runtime reads it), and numbers the devices as torch will.

- ``probe_chips()``        count, names, UUIDs, total memory (CUDA's:
                           nvidia-smi's less the driver's reserve), power
                           limit and compute capability; memoized per
                           process.
- ``probe_devices()``      one record a device: ``id``, ``platform``
                           (``"gpu"``), ``kind``, ``memory_bytes_in_use``,
                           ``memory_bytes_limit``; not memoized.
- ``publish_device_gauges()`` folds records into
                           ``ray_tpu_torch_device_memory_bytes``.
- ``start_device_gauge_poller()`` a one-shot publisher thread by default.
- ``publish_local_device_gauges()`` / ``local_device_identity()``: IN
                           process, and only once this process has
                           initialized CUDA itself.
- ``detect_resources()`` / ``detect_gpu_topology()``: what a node
                           advertises (``{"CPU", "GPU", "memory"}``) and
                           its accelerator identity.
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading

from ray_tpu_torch._private import telemetry as _tm
from ray_tpu_torch._private.config import get_config

# memory.total less memory.reserved (the driver's own) is the total the
# CUDA runtime reports (cudaMemGetInfo, torch.cuda.mem_get_info)
_SMI_FIELDS = ("index", "name", "uuid", "memory.total", "memory.reserved",
               "memory.used", "power.limit", "compute_cap")
SMI_QUERY = ["nvidia-smi", "--query-gpu=" + ",".join(_SMI_FIELDS),
             "--format=csv,noheader,nounits"]
_MIB = 1 << 20


def _timeout(timeout_s: float | None) -> float:
    return (float(get_config("gpu_probe_timeout_s")) if timeout_s is None
            else timeout_s)


def _number(text: str):
    """nvidia-smi's number, or None for ``[N/A]`` and the like."""
    try:
        return float(text)
    except ValueError:
        return None


def _visible(rows: list) -> list:
    """``rows`` (nvidia-smi's, by physical index) as the CUDA runtime
    shows them under ``CUDA_VISIBLE_DEVICES``: the listed devices in the
    listed order, up to the first entry that names none."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is None:
        return rows
    out = []
    for entry in (e.strip() for e in env.split(",")):
        match = [r for r in rows
                 if (entry.isdigit() and r["index"] == int(entry))
                 or (entry.startswith(("GPU-", "MIG-")) and
                     r["uuid"].startswith(entry))]
        if len(match) != 1 or match[0] in out:
            break
        out.append(match[0])
    return out


def _smi(timeout_s: float) -> list | None:
    """The visible devices' rows, renumbered as torch numbers them; None
    when nvidia-smi is absent, fails, times out or prints no device."""
    try:
        res = subprocess.run(SMI_QUERY, timeout=timeout_s,
                             capture_output=True, text=True)
    except (subprocess.TimeoutExpired, OSError):
        return None
    if res.returncode != 0:
        return None
    rows = []
    for line in res.stdout.strip().splitlines():
        cols = [c.strip() for c in line.split(",")]
        if len(cols) != len(_SMI_FIELDS) or not cols[0].isdigit():
            return None
        total, reserved, used = (_number(c) for c in cols[3:6])
        if total is not None and reserved is not None:
            total -= reserved
        rows.append({"index": int(cols[0]), "name": cols[1], "uuid": cols[2],
                     "memory_bytes": None if total is None
                     else int(total) * _MIB,
                     "memory_bytes_used": None if used is None
                     else int(used) * _MIB,
                     "power_limit_w": _number(cols[6]),
                     "compute_capability": cols[7]})
    rows = _visible(rows)
    return [dict(r, id=i) for i, r in enumerate(rows)] or None


def gpu_reachable_once(timeout_s: float = 120.0) -> bool:
    """True when the probe sees at least one visible GPU within
    ``timeout_s``."""
    return _smi(timeout_s) is not None


_chip_probe_cache: list = []  # [] = never probed; [result] = cached


def probe_chips(timeout_s: float | None = None) -> dict | None:
    """``{"chips", "names", "uuids", "memory_bytes", "power_limit_w",
    "compute_capability"}`` (one list entry a visible device), or None
    when there is none or the probe failed. Memoized per process:
    ``detect_resources`` and ``detect_gpu_topology`` both call it, and a
    hung driver should cost one timeout, not two."""
    if _chip_probe_cache:
        return _chip_probe_cache[0]
    rows = _smi(_timeout(timeout_s))
    result = None if rows is None else {
        "chips": len(rows),
        "names": [r["name"] for r in rows],
        "uuids": [r["uuid"] for r in rows],
        "memory_bytes": [r["memory_bytes"] for r in rows],
        "power_limit_w": [r["power_limit_w"] for r in rows],
        "compute_capability": [r["compute_capability"] for r in rows]}
    _chip_probe_cache.append(result)
    return result


def probe_devices(timeout_s: float | None = None) -> list | None:
    """One record a visible device: ``id`` (torch's index), ``platform``
    ``"gpu"``, ``kind`` (the name), ``memory_bytes_in_use`` (the whole
    card's, every process's), ``memory_bytes_limit``, ``uuid``. None when
    the probe failed. NOT memoized: memory is the point of polling."""
    rows = _smi(_timeout(timeout_s))
    if rows is None:
        return None
    return [{"id": r["id"], "platform": "gpu", "kind": r["name"],
             "memory_bytes_in_use": r["memory_bytes_used"],
             "memory_bytes_limit": r["memory_bytes"], "uuid": r["uuid"]}
            for r in rows]


def publish_device_gauges(devices: list | None = None,
                          timeout_s: float | None = None) -> int:
    """Fold device records (probed here unless given) into
    ``ray_tpu_torch_device_memory_bytes``, one (node, device, platform,
    stat) series a reported stat. Returns the devices seen; 0 when
    telemetry is off or the probe failed.

    When it PROBES, only ``stat=limit`` is published: the card's memory in
    use is every process's, not the owning workload's, and a probed value
    under the same tags would race that process's own publishes
    last-write-wins. Given records carry what the caller vouches for."""
    if not _tm.ENABLED:
        return 0
    probed = devices is None
    if probed:
        devices = probe_devices(timeout_s)
    if not devices:
        return 0
    node = os.uname().nodename
    for d in devices:
        tags = {"node": node, "device": str(d.get("id")),
                "platform": str(d.get("platform", "?"))}
        if not probed and d.get("memory_bytes_in_use") is not None:
            _tm.gauge_set("ray_tpu_torch_device_memory_bytes",
                          float(d["memory_bytes_in_use"]),
                          tags={**tags, "stat": "in_use"})
        if d.get("memory_bytes_limit") is not None:
            _tm.gauge_set("ray_tpu_torch_device_memory_bytes",
                          float(d["memory_bytes_limit"]),
                          tags={**tags, "stat": "limit"})
    return len(devices)


_poller_lock = threading.Lock()
_poller_thread: threading.Thread | None = None


def start_device_gauge_poller(interval_s: float | None = None) -> bool:
    """A daemon thread (one a process) that publishes the probed gauges
    ONCE by default; ``RAY_TPU_TORCH_DEVICE_GAUGE_POLL_S`` > 0 (or
    ``interval_s``) makes it poll. Live memory in use comes from the
    owning process (``publish_local_device_gauges``). Returns True if the
    thread is (now) running."""
    global _poller_thread
    if not _tm.ENABLED:
        return False
    with _poller_lock:
        if _poller_thread is not None and _poller_thread.is_alive():
            return True

        def _loop():
            import time as _time

            while True:
                try:
                    publish_device_gauges()
                except Exception:
                    pass  # telemetry must never take its host down
                iv = (interval_s if interval_s is not None
                      else float(get_config("device_gauge_poll_s")))
                if iv <= 0:
                    return  # one-shot (the safe default)
                _time.sleep(iv)

        _poller_thread = threading.Thread(
            target=_loop, daemon=True, name="device-gauge-poller")
        _poller_thread.start()
    return True


def _cuda_in_process():
    """torch's CUDA module if this process has already initialized CUDA
    itself, else None: nothing here may be the first to."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return torch.cuda


def publish_local_device_gauges() -> int:
    """IN-process publish from a process that already initialized CUDA:
    for each visible device, ``in_use`` (the bytes this process's caching
    allocator has allocated there, ``torch.cuda.memory_stats``; 0 where
    it has none) and ``limit`` (the card's total as CUDA reports it).
    Neither reading makes a context on a device. Returns the devices
    published."""
    if not _tm.ENABLED:
        return 0
    cuda = _cuda_in_process()
    if cuda is None:
        return 0
    records = [{"id": i, "platform": "gpu",
                "memory_bytes_in_use": cuda.memory_stats(i).get(
                    "allocated_bytes.all.current", 0),
                "memory_bytes_limit":
                    cuda.get_device_properties(i).total_memory}
               for i in range(cuda.device_count())]
    return publish_device_gauges(devices=records) if records else 0


def local_device_identity() -> dict:
    """host and pid always; platform, device count, kind and ids only
    when this process has already initialized CUDA."""
    info: dict = {"host": os.uname().nodename, "pid": os.getpid(),
                  "platform": None, "device_count": 0}
    cuda = _cuda_in_process()
    if cuda is None or not cuda.device_count():
        return info
    n = cuda.device_count()
    info.update(platform="gpu", device_count=n,
                device_kind=cuda.get_device_name(0),
                device_ids=list(range(n)))
    return info


# ------------------------------------------------------- node resources
def _chip_detection_enabled() -> bool:
    # On by default; off under tests (every in-process virtual node would
    # claim the same cards).
    default = "0" if os.environ.get("RAY_TPU_TESTING") == "1" else "1"
    return os.environ.get("RAY_TPU_TORCH_DETECT_GPUS", default) == "1"


def detect_gpu_topology() -> dict | None:
    """This host's accelerator identity: ``accelerator_type`` (the first
    visible card's name), ``chips``, ``worker_id`` and ``slice_id``.

    The environment names it first (``RAY_TPU_TORCH_ACCELERATOR_TYPE``,
    ``RAY_TPU_TORCH_TOPOLOGY``, ``RAY_TPU_TORCH_WORKER_ID``,
    ``RAY_TPU_TORCH_SLICE_ID``) and wins over the probe; the probe fills
    what it leaves. None when neither says anything."""
    env = os.environ
    info: dict = {}
    if env.get("RAY_TPU_TORCH_ACCELERATOR_TYPE"):
        info["accelerator_type"] = env["RAY_TPU_TORCH_ACCELERATOR_TYPE"]
    if env.get("RAY_TPU_TORCH_TOPOLOGY"):
        info["topology"] = env["RAY_TPU_TORCH_TOPOLOGY"]
    if env.get("RAY_TPU_TORCH_WORKER_ID"):
        try:
            info["worker_id"] = int(env["RAY_TPU_TORCH_WORKER_ID"])
        except ValueError:
            pass
    if env.get("RAY_TPU_TORCH_SLICE_ID"):
        info["slice_id"] = env["RAY_TPU_TORCH_SLICE_ID"]
    if _chip_detection_enabled():
        chips = probe_chips()
        if chips:
            info.setdefault("accelerator_type", chips["names"][0])
            info.setdefault("chips", chips["chips"])
    if not info:
        return None
    info.setdefault("slice_id", "slice-0")
    info.setdefault("worker_id", 0)
    return info


def detect_resources(num_cpus=None, num_gpus=None, memory=None,
                     resources=None) -> dict:
    """``{"CPU", "GPU" (when there is one), "memory", **resources}``: GPUs
    from the probe unless ``num_gpus`` is given (and detection is on)."""
    out = dict(resources or {})
    out["CPU"] = float(num_cpus if num_cpus is not None
                       else os.cpu_count() or 1)
    if num_gpus is None:
        num_gpus = 0
        if _chip_detection_enabled():
            num_gpus = (probe_chips() or {}).get("chips", 0)
    if num_gpus:
        out["GPU"] = float(num_gpus)
    if memory is None:
        try:
            memory = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        except (ValueError, OSError):
            memory = 8 << 30
    out["memory"] = float(memory)
    return out
