"""The port's GPU probe (ray_tpu_torch._private.gpu_probe) and its
telemetry, held to ray_tpu's TPU probe and raylet detection.

A fake ``nvidia-smi`` on a monkeypatched ``PATH`` stands for the driver:
good CSV, a non-zero exit, one that sleeps past the timeout, and none at
all. The JAX package's probes (subprocess ``import jax``) are replaced by
fakes that return the same device records; the gauges both packages
publish from the same records must be the same series with the same
values, under each package's metric name."""
import os
import stat
import time

import pytest

from ray_tpu._private import raylet as JR
from ray_tpu._private import tpu_probe as JP
from ray_tpu.util.metrics import registry_snapshot
from ray_tpu_torch._private import gpu_probe as gp
from ray_tpu_torch._private import telemetry as tm

GIB = 1 << 30
# two cards as nvidia-smi prints them: index, name, uuid, memory.total,
# memory.reserved, memory.used (MiB), power.limit (W), compute_cap
CSV = ("0, NVIDIA H100 80GB HBM3, GPU-aaaa-1111, 81559, 480, 554, 700.00, 9.0\n"
       "1, NVIDIA H100 80GB HBM3, GPU-bbbb-2222, 81559, 480, 3, [N/A], 9.0\n")


def _fake_smi(tmp_path, monkeypatch, body: str):
    """A fake nvidia-smi first on PATH; ``body`` is its shell script."""
    bindir = tmp_path / "bin"
    bindir.mkdir(exist_ok=True)
    smi = bindir / "nvidia-smi"
    smi.write_text("#!/bin/sh\n" + body)
    smi.chmod(smi.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(gp, "_chip_probe_cache", [])
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    return smi


def _good(tmp_path, monkeypatch):
    calls = tmp_path / "calls"
    _fake_smi(tmp_path, monkeypatch,
              f'echo x >> "{calls}"\n'
              f'case "$*" in *--query-gpu=index,name,uuid,memory.total,'
              f'memory.reserved,memory.used,power.limit,compute_cap*'
              f'--format=csv,noheader,nounits*) ;; *) exit 9;; esac\n'
              f"cat <<'EOF'\n{CSV}EOF\n")
    return calls


def test_probe_reads_the_fake_driver(tmp_path, monkeypatch):
    calls = _good(tmp_path, monkeypatch)
    chips = gp.probe_chips(timeout_s=10)
    assert chips == {
        "chips": 2, "names": ["NVIDIA H100 80GB HBM3"] * 2,
        "uuids": ["GPU-aaaa-1111", "GPU-bbbb-2222"],
        # CUDA's total: nvidia-smi's less the driver's reserve
        "memory_bytes": [(81559 - 480) << 20] * 2,
        "power_limit_w": [700.0, None], "compute_capability": ["9.0"] * 2}
    assert gp.probe_chips(timeout_s=10) is chips  # memoized
    devices = gp.probe_devices(timeout_s=10)
    assert devices == [
        {"id": 0, "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
         "memory_bytes_in_use": 554 << 20,
         "memory_bytes_limit": 81079 << 20, "uuid": "GPU-aaaa-1111"},
        {"id": 1, "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
         "memory_bytes_in_use": 3 << 20,
         "memory_bytes_limit": 81079 << 20, "uuid": "GPU-bbbb-2222"}]
    gp.probe_devices(timeout_s=10)  # not memoized
    assert calls.read_text().count("x") == 3
    assert gp.gpu_reachable_once(timeout_s=10)


@pytest.mark.parametrize("visible, uuids", [
    ("1", ["GPU-bbbb-2222"]),
    ("1,0", ["GPU-bbbb-2222", "GPU-aaaa-1111"]),
    ("GPU-bbbb", ["GPU-bbbb-2222"]),
    ("0,7,1", ["GPU-aaaa-1111"]),  # the runtime stops at a bad entry
    ("", None),
])
def test_cuda_visible_devices_is_honoured(tmp_path, monkeypatch, visible,
                                          uuids):
    _good(tmp_path, monkeypatch)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    devices = gp.probe_devices(timeout_s=10)
    if uuids is None:
        assert devices is None and gp.probe_chips(timeout_s=10) is None
        return
    assert [d["uuid"] for d in devices] == uuids
    assert [d["id"] for d in devices] == list(range(len(uuids)))  # torch's
    assert gp.probe_chips(timeout_s=10)["uuids"] == uuids


@pytest.mark.parametrize("case", ["nonzero", "timeout", "absent",
                                  "garbage"])
def test_a_failed_probe_is_none_within_its_timeout(tmp_path, monkeypatch,
                                                   case):
    body = {"nonzero": "echo 'NVIDIA-SMI has failed' >&2\nexit 9\n",
            "timeout": "exec sleep 30\n",
            "garbage": "echo 'not, a, device'\n"}.get(case)
    if case == "absent":
        empty = tmp_path / "empty"
        empty.mkdir()
        monkeypatch.setenv("PATH", str(empty))
        monkeypatch.setattr(gp, "_chip_probe_cache", [])
    else:
        _fake_smi(tmp_path, monkeypatch, body)
    t0 = time.monotonic()
    assert gp.probe_chips(timeout_s=0.5) is None
    assert gp.probe_devices(timeout_s=0.5) is None
    assert not gp.gpu_reachable_once(timeout_s=0.5)
    assert time.monotonic() - t0 < 10
    assert gp.publish_device_gauges(timeout_s=0.5) == 0


def _jax_series(ids):
    fam = next((m for m in registry_snapshot()
                if m["name"] == "ray_tpu_device_hbm_bytes"), None)
    rows = [] if fam is None else fam["values"]
    return sorted((tuple(sorted(r["tags"].items())), r["value"])
                  for r in rows if r["tags"]["device"] in ids)


def _port_series(ids):
    rows = tm.snapshot().get("ray_tpu_torch_device_memory_bytes", [])
    return sorted((tuple(sorted(r["tags"].items())), r["value"])
                  for r in rows if r["tags"]["device"] in ids)


def _as_jax(records):
    """The same records under the TPU probe's field names."""
    names = {"memory_bytes_in_use": "hbm_bytes_in_use",
             "memory_bytes_limit": "hbm_bytes_limit"}
    return [{names.get(k, k): v for k, v in r.items()} for r in records]


def test_injected_records_publish_the_twins_series():
    records = [{"id": 907, "platform": "gpu", "kind": "NVIDIA H100",
                "memory_bytes_in_use": 1 * GIB,
                "memory_bytes_limit": 79 * GIB},
               {"id": 908, "platform": "cpu"}]  # no memory stats
    assert gp.publish_device_gauges(devices=records) == 2
    assert JP.publish_device_gauges(devices=_as_jax(records)) == 2
    ids = {"907", "908"}
    port = _port_series(ids)
    assert port == _jax_series(ids)
    assert len(port) == 2 and {dict(t)["stat"] for t, _ in port} == {
        "in_use", "limit"}
    assert all(dict(t)["node"] == os.uname().nodename for t, _ in port)


def test_a_probing_publish_writes_the_limit_only(tmp_path, monkeypatch):
    _fake_smi(tmp_path, monkeypatch, "echo '0, NVIDIA H100 80GB HBM3, "
              "GPU-cccc, 81559, 480, 911, 700.00, 9.0'\n")
    # the twin probes through its own subprocess: the same record, faked
    monkeypatch.setattr(JP, "probe_devices", lambda timeout_s=60.0: [
        {"id": 0, "platform": "gpu", "hbm_bytes_in_use": 911 << 20,
         "hbm_bytes_limit": 81079 << 20}])
    assert gp.publish_device_gauges(timeout_s=10) == 1
    assert JP.publish_device_gauges() == 1
    port = [s for s in _port_series({"0"})
            if dict(s[0])["platform"] == "gpu"]
    jax = [s for s in _jax_series({"0"}) if dict(s[0])["platform"] == "gpu"]
    assert port == jax == [(tuple(sorted({
        "node": os.uname().nodename, "device": "0", "platform": "gpu",
        "stat": "limit"}.items())), float(81079 << 20))]


def test_telemetry_off_publishes_nothing(monkeypatch):
    monkeypatch.setattr(tm, "ENABLED", False)
    assert gp.publish_device_gauges(devices=[
        {"id": 909, "platform": "gpu", "memory_bytes_limit": 1}]) == 0
    assert not gp.start_device_gauge_poller()
    assert not _port_series({"909"})


def test_the_catalog_refuses_undeclared_names_and_tags():
    with pytest.raises(KeyError):
        tm.gauge_set("ray_tpu_torch_no_such_metric", 1.0)
    with pytest.raises(KeyError):
        tm.counter_inc("ray_tpu_torch_serve_batch_signature_total",
                       tags={"fn": "x", "oops": 1})
    with pytest.raises(KeyError):  # a gauge is not a counter
        tm.counter_inc("ray_tpu_torch_device_memory_bytes")


@pytest.mark.parametrize("module", [gp, JP], ids=["port", "ray_tpu"])
def test_the_poller_is_one_shot_by_default(monkeypatch, module):
    calls = []
    monkeypatch.setattr(module, "publish_device_gauges",
                        lambda *a, **k: calls.append(1))
    monkeypatch.setattr(module, "_poller_thread", None)
    assert module.start_device_gauge_poller() is True
    deadline = time.time() + 5
    while module._poller_thread.is_alive() and time.time() < deadline:
        time.sleep(0.02)
    assert not module._poller_thread.is_alive(), "poller should be one-shot"
    assert calls == [1]


def test_the_poller_polls_when_asked(monkeypatch):
    calls = []
    monkeypatch.setattr(gp, "publish_device_gauges",
                        lambda *a, **k: calls.append(1))
    monkeypatch.setattr(gp, "_poller_thread", None)
    monkeypatch.setenv("RAY_TPU_TORCH_DEVICE_GAUGE_POLL_S", "0.01")
    assert gp.start_device_gauge_poller() is True
    deadline = time.time() + 5
    while len(calls) < 3 and time.time() < deadline:
        time.sleep(0.01)
    assert len(calls) >= 3 and gp._poller_thread.is_alive()
    monkeypatch.setenv("RAY_TPU_TORCH_DEVICE_GAUGE_POLL_S", "0")
    gp._poller_thread.join(5)
    assert not gp._poller_thread.is_alive()


def test_in_process_readings_need_cuda_initialized_here():
    """On this host CUDA is never initialized, so nothing is read and
    nothing initializes it."""
    import torch

    assert not torch.cuda.is_initialized()
    assert gp.publish_local_device_gauges() == 0
    info = gp.local_device_identity()
    assert info == {"host": os.uname().nodename, "pid": os.getpid(),
                    "platform": None, "device_count": 0}
    assert not torch.cuda.is_initialized()


def _jax_probe_env(monkeypatch, detect, env):
    for k in ("RAY_TPU_TESTING", "RAY_TPU_DETECT_CHIPS",
              "RAY_TPU_TORCH_DETECT_GPUS", "TPU_ACCELERATOR_TYPE",
              "TPU_TOPOLOGY", "TPU_WORKER_ID", "TPU_NAME", "TPU_SLICE_ID",
              "RAY_TPU_TORCH_ACCELERATOR_TYPE", "RAY_TPU_TORCH_TOPOLOGY",
              "RAY_TPU_TORCH_WORKER_ID", "RAY_TPU_TORCH_SLICE_ID"):
        monkeypatch.delenv(k, raising=False)
    if detect == "testing":
        monkeypatch.setenv("RAY_TPU_TESTING", "1")
    else:
        monkeypatch.setenv("RAY_TPU_DETECT_CHIPS", detect)
        monkeypatch.setenv("RAY_TPU_TORCH_DETECT_GPUS", detect)
    for jax_key, port_key, value in env:
        monkeypatch.setenv(jax_key, value)
        monkeypatch.setenv(port_key, value)
    # the twin's chip probe (a subprocess `import jax`), faked: two chips
    monkeypatch.setattr(JP, "probe_chips", lambda timeout_s=60.0: {"chips": 2})


@pytest.mark.parametrize("detect", ["1", "0", "testing"])
@pytest.mark.parametrize("env", [
    (),
    (("TPU_ACCELERATOR_TYPE", "RAY_TPU_TORCH_ACCELERATOR_TYPE", "v5e-8"),
     ("TPU_WORKER_ID", "RAY_TPU_TORCH_WORKER_ID", "3"),
     ("TPU_NAME", "RAY_TPU_TORCH_SLICE_ID", "slice-7"),
     ("TPU_TOPOLOGY", "RAY_TPU_TORCH_TOPOLOGY", "2x4")),
], ids=["no-env", "env"])
def test_resources_and_topology_match_the_raylets(tmp_path, monkeypatch,
                                                  detect, env):
    _good(tmp_path, monkeypatch)
    _jax_probe_env(monkeypatch, detect, env)
    for kw in ({}, {"num_cpus": 3, "memory": 5 * GIB,
                    "resources": {"custom": 2.0}}):
        jax = JR.detect_resources(**kw)
        port = gp.detect_resources(**kw)
        if "TPU" in jax:
            jax["GPU"] = jax.pop("TPU")
        assert port == jax
    assert gp.detect_resources(num_gpus=0) == {
        k: v for k, v in JR.detect_resources(num_tpus=0).items()}
    assert gp.detect_resources(num_gpus=4)["GPU"] == 4.0
    jax, port = JR.detect_tpu_topology(), gp.detect_gpu_topology()
    probing = detect == "1"
    assert (gp.detect_resources().get("GPU") == 2.0) == probing
    if jax is None:
        assert port is None
        return
    if probing and not env:  # the probe names the card; the TPU's cannot
        assert port.pop("accelerator_type") == "NVIDIA H100 80GB HBM3"
    assert port == jax
