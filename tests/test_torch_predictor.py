"""The port's TorchPredictor (ray_tpu_torch.train.predictor) against
ray_tpu's JaxPredictor on the same GPT-2-tiny weights (made by the JAX
``gpt2.init``, carried across by ``convert.params_from_jax``) and the
same numpy batches: f32 compute, flash attention on both sides (Pallas
in interpret mode against the port's plain kernel versions), the last
position's logits within the tolerance tests/test_torch_gpt2.py uses for
logits (atol 1e-5, rtol 1e-5). It runs under inference_mode: remat
recomputes nothing and flash attention runs its forward alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.air.checkpoint import Checkpoint as JC
from ray_tpu.models import gpt2 as JG
from ray_tpu.train.predictor import JaxPredictor
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.convert import params_from_jax
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.train.predictor import Predictor, TorchPredictor

S = 64
TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(remat=False):
    common = dict(vocab_size=256, max_seq=S, n_layer=2, n_head=4, d_model=64,
                  attention="flash")
    return (JG.GPT2Config(dtype=jnp.float32, remat=False, **common),
            TG.GPT2Config(dtype=torch.float32, remat=remat, **common))


JCFG, TCFG = _cfgs()


def jax_last(params, tokens):
    return JG.forward(params, tokens, JCFG)[0][:, -1]


def torch_last(params, tokens):
    return TG.next_token_logits(params, tokens, TCFG)


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, JG.init(jax.random.PRNGKey(0), JCFG))


def _tokens(seed, rows=3):
    return np.random.default_rng(seed).integers(0, 256, (rows, S)).astype(
        np.int32)


def test_predict_matches_jax_predictor(params):
    jp = JaxPredictor(params, jax_last)
    tp = TorchPredictor(params, torch_last, device="cpu", jit=True)
    tok = _tokens(1)
    got, want = tp.predict(tok), jp.predict(tok)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    # dict batches, key by key
    batch = {"a": tok, "b": _tokens(2, rows=1)}
    got, want = tp.predict(batch), jp.predict(batch)
    assert sorted(got) == ["a", "b"]
    for k in batch:
        np.testing.assert_allclose(got[k], want[k], **TOL)
    # next_token_logits is forward's last position
    full, _ = TG.forward(params_from_jax(params, "cpu"),
                         torch.from_numpy(tok), TCFG)
    np.testing.assert_allclose(got["a"], full[:, -1].numpy(), **TOL)


def test_from_checkpoint_matches_jax_and_reads_torch_state(params, tmp_path):
    tok = _tokens(3)
    want = JaxPredictor.from_checkpoint(
        JC.from_dict({"params": params}), apply_fn=jax_last).predict(tok)
    from_dict = TorchPredictor.from_checkpoint(
        Checkpoint.from_dict({"params": params}), apply_fn=torch_last,
        device="cpu")
    state = Checkpoint.from_torch({"params": params_from_jax(params, "cpu")},
                                  path=str(tmp_path / "ck"))
    from_state = TorchPredictor.from_checkpoint(state, apply_fn=torch_last,
                                                device="cpu")
    # ray_tpu's own checkpoint object, through its to_dict()
    from_jax_ckpt = TorchPredictor.from_checkpoint(
        JC.from_dict({"params": params}), apply_fn=torch_last, device="cpu")
    for p in (from_dict, from_state, from_jax_ckpt):
        np.testing.assert_allclose(p.predict(tok), want, **TOL)


def test_missing_params_key_raises_the_twins_error(params):
    """The twin of tests/test_train.py's checkpoint -> predictor path,
    without the runtime's BatchPredictor: the same KeyError."""
    with pytest.raises(KeyError) as jerr:
        JaxPredictor.from_checkpoint(JC.from_dict({"weights": params}),
                                     apply_fn=jax_last)
    with pytest.raises(KeyError) as terr:
        TorchPredictor.from_checkpoint(Checkpoint.from_dict(
            {"weights": params}), apply_fn=torch_last, device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "checkpoint has no 'params' entry" in str(terr.value)
    with pytest.raises(KeyError, match="'w'"):
        TorchPredictor.from_checkpoint(
            Checkpoint.from_dict({"params": params}), apply_fn=torch_last,
            params_key="w", device="cpu")


def test_inference_runs_no_remat_and_no_backward(params, monkeypatch):
    """gpt2_small() ships remat=True: under inference_mode
    torch.utils.checkpoint runs each layer once and recomputes nothing, and
    flash attention runs its forward alone, on contiguous [B*H, S, D]
    operands (at batch 1 too), leaving no tape behind."""
    _, remat_cfg = _cfgs(remat=True)
    layers, shapes, tapes = [], [], []
    block_apply = TG._block_apply
    fwd = fa.flash_fwd
    apply = fa._FlashAttention.apply

    def counted(*a, **k):
        layers.append(1)
        return block_apply(*a, **k)

    def contiguous_fwd(q, k, v, **kw):
        assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
        shapes.append(tuple(q.shape))
        return fwd(q, k, v, **kw)

    def applied(*a):
        o = apply(*a)
        tapes.append(o.grad_fn)
        return o

    def refuse(*a, **k):
        raise AssertionError("a backward-only path ran under inference")

    monkeypatch.setattr(TG, "_block_apply", counted)
    monkeypatch.setattr(fa, "flash_fwd", contiguous_fwd)
    monkeypatch.setattr(fa._FlashAttention, "apply", applied)
    monkeypatch.setattr(fa, "flash_bwd_dq", refuse)
    monkeypatch.setattr(fa, "flash_bwd_dkv", refuse)
    pred = TorchPredictor(params, lambda p, t: TG.next_token_logits(
        p, t, remat_cfg), device="cpu")
    for rows in (1, 3):
        layers.clear()
        got = pred.predict(_tokens(4, rows))
        assert len(layers) == remat_cfg.n_layer
        np.testing.assert_allclose(
            got, JaxPredictor(params, jax_last).predict(_tokens(4, rows)),
            **TOL)
    assert shapes == [(4, S, 16)] * 2 + [(12, S, 16)] * 2
    assert tapes == [None] * 4


def test_training_still_takes_the_autograd_path(params, monkeypatch):
    """With grad on, flash attention is the differentiable Function."""
    calls = []
    apply = fa._FlashAttention.apply
    monkeypatch.setattr(fa._FlashAttention, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    p = params_from_jax(params, "cpu")
    leaf = p["blocks"]["attn"]["wq"].requires_grad_(True)
    loss = TG.next_token_logits(p, torch.from_numpy(_tokens(5)), TCFG).sum()
    (g,) = torch.autograd.grad(loss, [leaf])
    assert len(calls) == TCFG.n_layer and g.abs().sum() > 0


def test_device_defaults_to_cuda_and_base_is_abstract(params, monkeypatch):
    with pytest.raises(NotImplementedError):
        Predictor.from_checkpoint(Checkpoint.from_dict({}))
    with pytest.raises(NotImplementedError):
        Predictor().predict(np.zeros(1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchPredictor(params, torch_last)


def test_outputs_come_back_as_numpy_trees(params):
    """tuples, dicts and bf16 tensors of an apply_fn's output, as numpy."""
    def both(p, t):
        logits = TG.next_token_logits(p, t, TCFG)
        return logits.to(torch.bfloat16), {"top": logits.argmax(-1)}

    half, extra = TorchPredictor(params, both, device="cpu").predict(
        _tokens(6))
    assert half.dtype == np.float32 and half.shape == (3, 256)
    assert extra["top"].dtype == np.int64 and extra["top"].shape == (3,)
