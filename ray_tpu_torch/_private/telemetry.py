"""The port's internal metrics: the part of ``ray_tpu/_private/telemetry.py``
that its device probe, Serve batcher and data path use.

One in-process registry of gauges, counters and histograms, keyed by
metric name and tag set. Every name is declared in ``CATALOG``; an
undeclared one raises ``KeyError`` at the call site, as the twin's catalog
does. ``RAY_TPU_TORCH_INTERNAL_TELEMETRY=0`` (read at import) turns the
plane off: every call returns at once and ``snapshot()`` is empty. The
twin's export plane (the metrics agent, the dashboard) is not ported;
``snapshot()`` is how a caller or a test reads the values.
"""
from __future__ import annotations

import os
import threading

ENABLED = os.environ.get("RAY_TPU_TORCH_INTERNAL_TELEMETRY", "1") != "0"

# name -> (kind, tag keys, description)
CATALOG = {
    "ray_tpu_torch_device_memory_bytes": (
        "gauge", ("node", "device", "platform", "stat"),
        "A GPU's memory: stat=in_use (bytes this process's allocator "
        "holds) or stat=limit (the card's total)."),
    "ray_tpu_torch_serve_batch_signature_total": (
        "counter", ("fn", "result"),
        "Serve batch calls by signature (batch size, item shape, dtype): "
        "result=miss for a signature's first call, hit after."),
    "ray_tpu_torch_serve_batch_first_call_seconds": (
        "histogram", ("fn",),
        "Wall time of each signature's first batch call (on the card: the "
        "kernels' first use and the BLAS library's first plan)."),
    "ray_tpu_torch_serve_batch_size_tasks": (
        "histogram", ("fn",),
        "Requests in a batch call, padded slots included."),
    "ray_tpu_torch_serve_batch_pad_waste_tasks": (
        "histogram", ("fn",),
        "Padded slots in a batch call (outputs dropped before fan-out)."),
}

_lock = threading.Lock()
_values: dict = {}  # (name, sorted tag items) -> float, or a histogram dict


def _key(name: str, tags: dict | None):
    kind, keys, _ = CATALOG[name]
    tags = tags or {}
    extra = set(tags) - set(keys)
    if extra:
        raise KeyError(f"{name}: undeclared tags {sorted(extra)}")
    return kind, (name, tuple(sorted((k, str(v)) for k, v in tags.items())))


def _check(name: str, kind: str, want: str):
    if kind != want:
        raise KeyError(f"{name} is a {kind}, not a {want}")


def counter_inc(name: str, value: float = 1.0, tags: dict | None = None):
    if not ENABLED:
        return
    kind, key = _key(name, tags)
    _check(name, kind, "counter")
    with _lock:
        _values[key] = _values.get(key, 0.0) + float(value)


def gauge_set(name: str, value: float, tags: dict | None = None):
    if not ENABLED:
        return
    kind, key = _key(name, tags)
    _check(name, kind, "gauge")
    with _lock:
        _values[key] = float(value)


def observe(name: str, value: float, tags: dict | None = None):
    if not ENABLED:
        return
    kind, key = _key(name, tags)
    _check(name, kind, "histogram")
    value = float(value)
    with _lock:
        h = _values.setdefault(key, {"count": 0, "sum": 0.0, "max": value})
        h["count"] += 1
        h["sum"] += value
        h["max"] = max(h["max"], value)


def snapshot() -> dict:
    """``{name: [{"tags": {...}, "value": v}, ...]}`` for gauges and
    counters, ``{"tags", "count", "sum", "max"}`` rows for histograms;
    empty when the plane is off."""
    out: dict = {}
    with _lock:
        for (name, tags), v in _values.items():
            row = dict(v) if isinstance(v, dict) else {"value": v}
            out.setdefault(name, []).append({"tags": dict(tags), **row})
    return out
