"""The port's request batcher (ray_tpu_torch.serve.batching) held to
ray_tpu.serve.batching on the same arrival sequences (adapted from
tests/test_zz_serve.py): bucket sizes and pads, per-caller exception
clones, call-shape rejection and pickling, and the signature counter
converging after warm-up as ray_tpu's compile-cache counter does; and
GPT-2-tiny served through it answering each request as JaxPredictor
answers it alone (f32, flash attention, atol 1e-5, rtol 1e-5)."""
import threading

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as JG
from ray_tpu.serve import batching as JB
from ray_tpu.train.predictor import JaxPredictor
from ray_tpu.util.metrics import registry_snapshot
from ray_tpu_torch._private import telemetry as tm
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.serve import batching as TB
from ray_tpu_torch.train.predictor import TorchPredictor

TRAFFIC = [3, 1, 5, 2, 7, 4, 8, 6, 3, 5, 7, 1, 6, 2, 8, 4]


@pytest.fixture
def both_switches(monkeypatch):
    """Set each package's shape-bucket kill switch to the same value."""
    def set_to(value):
        monkeypatch.setenv("RAY_TPU_SERVE_SHAPE_BUCKETS", value)
        monkeypatch.setenv("RAY_TPU_TORCH_SERVE_SHAPE_BUCKETS", value)
    return set_to


@pytest.mark.parametrize("buckets_on", ["1", "0"])
def test_bucket_sizes_and_pads_match(both_switches, buckets_on):
    both_switches(buckets_on)
    for m in range(1, 18):
        assert TB.default_bucket_sizes(m) == JB.default_bucket_sizes(m)
    for max_size, buckets in ((6, None), (8, (3, 5)), (16, None)):
        t = TB._Batcher(lambda xs: xs, max_size, 0.01, bucket_sizes=buckets)
        j = JB._Batcher(lambda xs: xs, max_size, 0.01, bucket_sizes=buckets)
        assert t.bucket_sizes == j.bucket_sizes
        for n in range(1, max_size + 1):
            items = list(range(10, 10 + n))
            assert t._pad_to_bucket(items) == j._pad_to_bucket(items)
    if buckets_on == "1":
        assert TB._Batcher(lambda xs: xs, 6, 0.01)._pad_to_bucket(
            [10, 20, 30]) == ([10, 20, 30, 30], 1)  # the last item, again


@pytest.mark.parametrize("kwargs", [
    dict(max_batch_size=8, batch_size_buckets=[16]),
    dict(max_batch_size=8, batch_size_buckets=[0, 4]),
    dict(max_batch_size=0),
    dict(max_batch_size=4, batch_wait_timeout_s=-1),
])
def test_bad_decorations_raise_the_twins_errors(kwargs):
    with pytest.raises(ValueError) as terr:
        TB.batch(**kwargs)(lambda xs: xs)
    with pytest.raises(ValueError) as jerr:
        JB.batch(**kwargs)(lambda xs: xs)
    assert str(terr.value) == str(jerr.value)


def _exception_scenario(mod):
    @mod.batch(max_batch_size=4, batch_wait_timeout_s=0.1)
    def boom(items):
        raise ValueError("batch exploded")

    errs = [None] * 3
    barrier = threading.Barrier(3)

    def call(i):
        barrier.wait()
        try:
            boom(i)
        except ValueError as e:
            errs[i] = e

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    cause = RuntimeError("caller 0's local context")
    errs[0].__cause__ = cause
    return {"types": [type(e).__name__ for e in errs],
            "distinct": len({id(e) for e in errs}),
            "others_untouched": all(e.__cause__ is not cause
                                    for e in errs[1:]),
            "messages": sorted({str(e) for e in errs})}


def test_each_caller_gets_its_own_exception_as_in_ray_tpu():
    got = _exception_scenario(TB)
    assert got == _exception_scenario(JB)
    assert got == {"types": ["ValueError"] * 3, "distinct": 3,
                   "others_untouched": True, "messages": ["batch exploded"]}


def _shape_scenario(mod):
    @mod.batch
    def f(items):
        return items

    class M:
        @mod.batch
        def g(self, items):
            return [x + 1 for x in items]

    out = []
    m = M()
    for call in (lambda: f(1, mode="fast"), lambda: f(1, 2), lambda: f(),
                 lambda: m.g(1, extra=2), lambda: m.g()):
        with pytest.raises(TypeError) as e:
            call()
        out.append(str(e.value))
    out.append(m.g(41))  # the good path still works after rejections
    wrapped = mod.batch(max_batch_size=4, batch_wait_timeout_s=0.01)(
        lambda items: [x * 2 for x in items])
    out.append(wrapped(21))  # a live batcher thread now exists
    w2 = cloudpickle.loads(cloudpickle.dumps(wrapped))
    out += [w2(5), w2._batch_size_buckets == wrapped._batch_size_buckets]
    return out


def test_call_shape_rejection_and_pickling_match():
    got = _shape_scenario(TB)
    assert got == _shape_scenario(JB)
    assert got[-4:] == [42, 42, 10, True]


def _port_misses(name):
    return sum(r["value"] for r in tm.snapshot().get(
        "ray_tpu_torch_serve_batch_signature_total", [])
        if r["tags"] == {"fn": name, "result": "miss"})


def _jax_misses(name):
    fam = next((m for m in registry_snapshot()
                if m["name"] == "ray_tpu_pjit_cache_total"), None)
    if fam is None:
        return 0.0
    return sum(v["value"] for v in fam["values"]
               if v["tags"].get("fn") == f"serve_batch::{name}"
               and v["tags"].get("result") == "miss")


def _replay(mod, misses, name):
    """The twin's oracle: each traffic size padded as the loop pads it,
    then classified by the batcher's instrumented call."""
    b = mod._Batcher(lambda xs: [x.sum() for x in xs], 8, 0.01, name=name)
    history = []
    for n in TRAFFIC:
        items, _ = b._pad_to_bucket([np.zeros((4, 2))] * n)
        b._fn(items)
        history.append(misses(name))
    return history


@pytest.mark.parametrize("buckets_on", ["1", "0"])
def test_signature_counter_converges_as_ray_tpus_does(both_switches,
                                                      buckets_on):
    both_switches(buckets_on)
    name = f"torch_oracle_{buckets_on}"
    port = _replay(TB, _port_misses, name)
    assert port == _replay(JB, _jax_misses, name)
    if buckets_on == "1":
        # warm-up (3, 1, 5, 2) touches buckets 4, 1, 8, 2; flat after
        assert port[3] == 4.0 and port[-1] == 4.0
        first = next(r for r in tm.snapshot()[
            "ray_tpu_torch_serve_batch_first_call_seconds"]
            if r["tags"] == {"fn": name})
        assert first["count"] == 4
    else:
        assert port[-1] == 8.0  # one signature a raw size


def test_a_failed_first_call_counts_as_a_miss_again():
    fails = [True]

    def flaky(items):
        if fails.pop():
            raise RuntimeError("first use failed")
        return items

    b = TB._Batcher(flaky, 4, 0.01, name="torch_flaky")
    with pytest.raises(RuntimeError):
        b._fn([1])
    fails.append(False)
    assert b._fn([1]) == [1]
    assert _port_misses("torch_flaky") == 2.0


S = 32


@pytest.fixture(scope="module")
def tiny():
    common = dict(vocab_size=256, max_seq=S, n_layer=2, n_head=4, d_model=64,
                  remat=False, attention="flash")
    jcfg = JG.GPT2Config(dtype=jnp.float32, **common)
    tcfg = TG.GPT2Config(dtype=torch.float32, **common)
    params = jax.tree.map(np.asarray, JG.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, params


def test_gpt2_tiny_served_answers_as_jax_alone(tiny):
    jcfg, tcfg, params = tiny
    requests = np.random.default_rng(7).integers(0, 256, (24, S)).astype(
        np.int32)
    predictor = TorchPredictor(
        params, lambda p, t: TG.next_token_logits(p, t, tcfg), device="cpu")
    calls = []

    @TB.batch(max_batch_size=8, batch_wait_timeout_s=0.02)
    def serve(items):
        calls.append(len(items))
        return list(predictor.predict(np.stack(items)))

    answers = [None] * len(requests)

    def client(c):
        for i in range(c, len(requests), 6):
            answers[i] = serve(requests[i])

    threads = [threading.Thread(target=client, args=(c,)) for c in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert all(c in (1, 2, 4, 8) for c in calls)
    assert sum(calls) >= len(requests)
    alone = JaxPredictor(params, lambda p, t: JG.forward(p, t, jcfg)[0][:, -1])
    for i, got in enumerate(answers):
        # a pad slot's output would be another request's answer
        np.testing.assert_allclose(got, alone.predict(requests[i:i + 1])[0],
                                   atol=1e-5, rtol=1e-5)
