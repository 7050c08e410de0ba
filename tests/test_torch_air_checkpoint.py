"""The port's Checkpoint (ray_tpu_torch.air.checkpoint) against ray_tpu's
(ray_tpu.air.checkpoint): the torch_state form round-trips every leaf's
bits, gives back the numpy that ray_tpu's orbax form gives for the same
tree, and the dict, directory and bytes forms cross between the two
packages. Exact throughout: a checkpoint moves bits, it computes nothing."""
import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.air.checkpoint import Checkpoint as JC
from ray_tpu_torch._private.tree import tree_leaves
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.convert import params_from_jax


def _numpy_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "blocks": {"attn": {"wq": rng.standard_normal((2, 8, 4, 3),
                                                      dtype=np.float32)},
                   "ln": {"scale": rng.standard_normal(8).astype(
                       ml_dtypes.bfloat16)}},
        "wte": rng.standard_normal((16, 8)).astype(ml_dtypes.bfloat16),
        "count": np.asarray(7, np.int32),
        "ids": rng.integers(-2 ** 40, 2 ** 40, (5,)),
        "f16": rng.standard_normal((3, 2)).astype(np.float16),
    }


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.reshape(-1).numpy().view(np.uint8)


def test_torch_state_round_trip_is_bit_equal(tmp_path):
    tree = params_from_jax(_numpy_tree(), "cpu")
    tree["blocks"]["attn"]["wq"][0, 0, 0, 0] = -0.0  # signs survive too
    ckpt = Checkpoint.from_torch(tree, path=str(tmp_path / "ck"))
    assert ckpt.has_torch_state()
    back = ckpt.to_torch("cpu")
    a, b = tree_leaves(tree), tree_leaves(back)
    assert len(a) == len(b) == 6
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(_bits(x), _bits(y))
    assert sorted(back) == sorted(tree)
    assert sorted(back["blocks"]) == ["attn", "ln"]
    # bytes carry the directory form whole
    again = Checkpoint.from_bytes(ckpt.to_bytes()).to_torch("cpu")
    for x, y in zip(a, tree_leaves(again)):
        np.testing.assert_array_equal(_bits(x), _bits(y))


def test_torch_state_gives_the_numpy_orbax_gives(tmp_path):
    """The twin of tests/test_tune_resume.py's orbax round trip: the same
    tree through ray_tpu's from_jax / to_jax and through the port's
    from_torch / to_torch (carried across by convert.params_from_jax)."""
    tree = _numpy_tree(1)
    jback = JC.from_jax(tree, path=str(tmp_path / "jax")).to_jax()
    tback = Checkpoint.from_torch(params_from_jax(tree, "cpu"),
                                  path=str(tmp_path / "torch")).to_torch("cpu")
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jback)]
    tl = tree_leaves(tback)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert j.shape == tuple(t.shape)
        if j.dtype == ml_dtypes.bfloat16:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(j.view(np.int16),
                                          t.view(torch.int16).numpy())
        else:
            assert t.numpy().dtype == j.dtype
            np.testing.assert_array_equal(j, t.numpy())


def test_dict_bytes_cross_between_the_packages():
    data = {"w": np.arange(6.0).reshape(2, 3), "meta": {"lr": 0.1},
            "step": 3}
    from_port = JC.from_bytes(Checkpoint.from_dict(data).to_bytes()).to_dict()
    from_jax = Checkpoint.from_bytes(JC.from_dict(data).to_bytes()).to_dict()
    for got in (from_port, from_jax):
        np.testing.assert_array_equal(got["w"], data["w"])
        assert got["meta"] == {"lr": 0.1} and got["step"] == 3


def test_directory_bytes_cross_between_the_packages(tmp_path):
    tree = params_from_jax(_numpy_tree(2), "cpu")
    blob = Checkpoint.from_torch(tree, path=str(tmp_path / "ck")).to_bytes()
    jdir = JC.from_bytes(blob).to_directory(str(tmp_path / "via_jax"))
    back = Checkpoint.from_bytes(JC.from_directory(jdir).to_bytes())
    for x, y in zip(tree_leaves(tree), tree_leaves(back.to_torch("cpu"))):
        np.testing.assert_array_equal(_bits(x), _bits(y))


def test_dict_directory_and_uri_forms(tmp_path):
    """The twin's conversions (tests/test_train.py): dict -> dir -> dict,
    uri round trip; tensor leaves come to the host as numpy (bf16 stays a
    host tensor: numpy has no bf16)."""
    data = {"w": torch.arange(6.0).reshape(2, 3),
            "h": torch.ones(2, dtype=torch.bfloat16),
            "meta": {"lr": 0.1}, "seq": [torch.zeros(1), 2]}
    ckpt = Checkpoint.from_dict(data)
    got = ckpt.to_dict()
    assert isinstance(got["w"], np.ndarray)
    assert isinstance(got["seq"][0], np.ndarray) and got["seq"][1] == 2
    assert got["h"].dtype == torch.bfloat16 and got["h"].device.type == "cpu"
    d = ckpt.to_directory(str(tmp_path / "c1"))
    np.testing.assert_array_equal(Checkpoint.from_directory(d).to_dict()["w"],
                                  got["w"])
    uri = ckpt.to_uri(f"file://{tmp_path}/c2")
    assert Checkpoint.from_uri(uri).to_dict()["meta"] == {"lr": 0.1}
    assert ckpt.to_directory() == ckpt.to_directory()  # one scratch copy


def test_wrong_forms_are_refused(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="exactly one"):
        Checkpoint()
    with pytest.raises(ValueError, match="torch_state"):
        Checkpoint.from_dict({"w": 1}).to_torch("cpu")
    assert not Checkpoint.from_dict({"w": 1}).has_torch_state()
    with pytest.raises(ValueError, match="file://"):
        Checkpoint.from_dict({"w": 1}).to_uri("s3://bucket/x")
    with pytest.raises(TypeError, match="strings"):
        Checkpoint.from_torch({1: torch.zeros(1)}, path=str(tmp_path / "k"))
    ckpt = Checkpoint.from_torch({"w": torch.zeros(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ckpt.to_torch()  # CUDA by default
