"""The port's device batches (ray_tpu_torch.data.iterator) held to
ray_tpu's streaming iterator: over the batch blocks of
``iter_batch_blocks``, ``iter_device_batches(device="cpu")`` yields the
batches ``make_to_batch("numpy", False)`` yields, bit for bit and in
order; the double buffer re-raises a producer's error in the consumer and
leaves no thread behind when closed. The CUDA half (pinned staging, the
side stream) runs in tests/test_torch_cuda_serving.py and chip_smoke.py."""
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu.data._internal.streaming import iterator as JI
from ray_tpu_torch.data import iterator as TI
from ray_tpu_torch.data import iter_device_batches


def _blocks(kind, seed=0):
    rng = np.random.default_rng(seed)
    sizes = [7, 30, 1, 64, 13]
    if kind == "array":
        return [rng.standard_normal((n, 3)).astype(np.float32) for n in sizes]
    if kind == "columns":
        return [{"x": rng.integers(0, 1000, (n, 4)),
                 "y": rng.standard_normal(n)} for n in sizes]
    return [[{"a": int(v), "b": float(v) / 3} for v in rng.integers(0, 9, n)]
            for n in sizes]  # rows


def _same(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
        return
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.numpy().dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint8),
                                  np.ascontiguousarray(want).view(np.uint8))


@pytest.mark.parametrize("kind", ["array", "columns", "rows"])
@pytest.mark.parametrize("batch_size, drop_last", [(16, False), (16, True),
                                                   (100, False)])
def test_device_batches_are_ray_tpus_batches(kind, batch_size, drop_last):
    blocks = _blocks(kind)
    want = [JI.make_to_batch("numpy", False)(bb) for bb in
            JI.iter_batch_blocks(blocks, batch_size, drop_last)]
    got = list(iter_device_batches(
        JI.iter_batch_blocks(blocks, batch_size, drop_last), device="cpu"))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _same(g, w)


def test_the_double_buffer_keeps_ray_tpus_order_and_depth():
    """The twin's _double_buffered and the port's over the same converter:
    the same items in the same order, the producer at most a queue (2)
    and one in hand ahead of the consumer."""
    made = []

    def to_batch(i):
        made.append(i)
        return TI.Transfer(i)

    consumed, ahead = [], []
    for x in TI.double_buffered(iter(range(20)), to_batch):
        time.sleep(0.01)
        ahead.append(len(made) - len(consumed))
        consumed.append(x)
    assert consumed == list(JI._double_buffered(iter(range(20)),
                                                lambda i: i))
    assert max(ahead) <= 4


def test_a_producer_error_reaches_the_consumer():
    def source():
        yield np.zeros(3)
        yield np.ones(3)
        raise ValueError("block fetch failed")

    got = []
    with pytest.raises(ValueError, match="block fetch failed"):
        for b in iter_device_batches(source(), device="cpu"):
            got.append(b)
    assert [float(b.sum()) for b in got] == [0.0, 3.0]


def _producers():
    return [t for t in threading.enumerate() if t.name == "device-batches"
            and t.is_alive()]


def test_closing_leaves_no_thread():
    assert not _producers()
    gen = iter_device_batches((np.full(4, i) for i in range(100)),
                              device="cpu")
    assert float(next(gen)[0]) == 0.0
    assert len(_producers()) == 1
    gen.close()
    assert not _producers()
    list(iter_device_batches([np.zeros(2)] * 3, device="cpu"))
    assert not _producers()


def test_formats_and_devices_that_are_refused(monkeypatch):
    with pytest.raises(ValueError, match="numpy"):
        TI.make_to_batch("default", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(iter_device_batches([np.zeros(2)]))  # CUDA by default
