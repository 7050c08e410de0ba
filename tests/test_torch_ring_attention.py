"""The port's ring attention (ray_tpu_torch.parallel.ring_attention)
against the JAX package's ring over the conftest's 8-device CPU mesh, on
the same numpy-seeded inputs. The port's sp ranks are threads of this
process (tests/torch_gang.run_mesh); each JAX oracle is computed once a
module."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import layers as JL
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig, create_mesh
from ray_tpu.parallel.ring_attention import ring_attention as jax_ring
from ray_tpu_torch.models import layers as TL
from ray_tpu_torch.parallel import ring_attention as R
from ray_tpu_torch.parallel.mesh import MeshConfig
from ray_tpu_torch.parallel.pipeline import StageTape
from tests.torch_gang import run_mesh

FWD_SHAPE = (4, 32, 4, 16)  # tests/test_parallel.py:44
GRAD_SHAPE = (2, 32, 2, 8)  # tests/test_parallel.py:58
JAX_MESH = {2: JMeshConfig(dp=2, sp=2, tp=2), 4: JMeshConfig(sp=4, tp=2)}
CASES = [(sp, causal) for sp in (2, 4) for causal in (True, False)]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Rank threads share the box with other test workers: two intra-op
    threads each while this file runs."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.fixture(scope="module")
def oracles():
    """JAX's ring outputs (the shapes of test_parallel.py:41) and the
    grads of sum(ring ** 2) with respect to q, k and v (:55), per (sp,
    causal)."""
    fwd_in, grad_in = _qkv(FWD_SHAPE, 0), _qkv(GRAD_SHAPE, 1)
    outs, grads = {}, {}
    for sp, causal in CASES:
        mesh = create_mesh(JAX_MESH[sp])
        with jax.set_mesh(mesh):
            ring = jax.jit(lambda q, k, v, c=causal, m=mesh:
                           jax_ring(q, k, v, m, causal=c))
            outs[sp, causal] = np.asarray(ring(*fwd_in))
            g = jax.jit(jax.grad(lambda q, k, v: jnp.sum(ring(q, k, v) ** 2),
                                 argnums=(0, 1, 2)))(*grad_in)
            grads[sp, causal] = [np.asarray(x) for x in g]
    return fwd_in, grad_in, outs, grads


@pytest.mark.parametrize("sp,causal", CASES)
def test_ring_attention_matches_jax(oracles, sp, causal):
    """Every sp rank's global output (its shard's, allgathered) is JAX's."""
    (q, k, v), _, outs, _ = oracles
    t = [torch.from_numpy(x) for x in (q, k, v)]
    got = run_mesh(MeshConfig(sp=sp), lambda lay: R.ring_attention(
        *t, group=lay.sp_group, causal=causal).numpy())
    for out in got:
        np.testing.assert_allclose(out, outs[sp, causal], atol=2e-5)


@pytest.mark.parametrize("sp,causal", CASES)
def test_ring_backward_matches_jax_grad(oracles, sp, causal):
    """The explicit ring backward's dq, dk and dv of sum(o ** 2), from each
    rank's shard, against jax.grad through the JAX ring."""
    _, (q, k, v), _, grads = oracles
    S = q.shape[1]

    def rank(lay):
        lo, hi = R.shard_bounds(S, sp, lay.sp_rank)
        ql, kl, vl = (torch.from_numpy(x[:, lo:hi]) for x in (q, k, v))
        o, lse = R.ring_attention_local(ql, kl, vl, group=lay.sp_group,
                                        causal=causal)
        assert lse.shape == (q.shape[0], q.shape[2], hi - lo)
        return R.ring_attention_local_backward(
            ql, kl, vl, o, lse, 2 * o, group=lay.sp_group, causal=causal)

    shards = run_mesh(MeshConfig(sp=sp), rank)
    for i, name in enumerate(("dq", "dk", "dv")):
        got = torch.cat([s[i] for s in shards], dim=1).numpy()
        np.testing.assert_allclose(got, grads[sp, causal][i], atol=5e-5,
                                   err_msg=name)


def test_apply_attention_ring_local_matches_jax():
    """``apply_attention(impl="ring_local")`` on each rank's shard of x
    (f32 compute, sp 2) is the JAX layer's global ring ("ring") on the
    whole sequence, the shards concatenated."""
    rng = np.random.default_rng(2)
    B, S, D, H = 2, 32, 32, 4
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    params = JL.init_attention(jax.random.PRNGKey(3), D, H)
    mesh = create_mesh(JAX_MESH[2])
    with jax.set_mesh(mesh):
        want = np.asarray(jax.jit(lambda p, x: JL.apply_attention(
            p, x, impl="ring", compute_dtype=jnp.float32))(params, x))
    tparams = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}

    def rank(lay):
        lo, hi = R.shard_bounds(S, 2, lay.sp_rank)
        with torch.no_grad():
            return TL.apply_attention(
                tparams, torch.from_numpy(x[:, lo:hi]), impl="ring_local",
                compute_dtype=torch.float32, sp_group=lay.sp_group).numpy()

    got = np.concatenate(run_mesh(MeshConfig(sp=2), rank), axis=1)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_ring_local_needs_a_tape_for_gradients():
    """Without a stage tape, a ring whose inputs require grad is refused:
    its backward would communicate inside autograd."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(
        GRAD_SHAPE, 4))

    def rank(lay):
        with pytest.raises(ValueError, match="StageTape"):
            R.ring_attention_stage(q, k, v, group=lay.sp_group, tape=None)
        return True

    assert all(run_mesh(MeshConfig(sp=2), rank))


def test_ring_on_a_stage_tape_matches_autograd_of_reference():
    """The ring as a tape boundary between two autograd segments (a
    projection before it, a sum of squares after it): the tape's backward
    gives the grads of autograd through reference attention on the whole
    sequence, in f32."""
    (q, k, v), S = _qkv(GRAD_SHAPE, 5), GRAD_SHAPE[1]
    w = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (GRAD_SHAPE[-1],) * 2).astype(np.float32))
    full = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    wr = w.clone().requires_grad_()
    out = R.reference_attention(*(t @ wr for t in full), causal=True)
    want = torch.autograd.grad((out ** 2).sum(), full + [wr])

    def rank(lay):
        lo, hi = R.shard_bounds(S, 2, lay.sp_rank)
        ins = [torch.from_numpy(t[:, lo:hi]).requires_grad_()
               for t in (q, k, v)]
        wl = w.clone().requires_grad_()
        tape = StageTape()
        o = R.ring_attention_stage(*(t @ wl for t in ins),
                                   group=lay.sp_group, tape=tape)
        y = (o ** 2).sum()
        got, (gw,) = tape.backward(y, torch.ones(()), ins, [wl])
        return [g.numpy() for g in got], gw

    def close(got, want):
        """f32 sums in other orders: within 1e-5 of the largest grad"""
        want = want.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())

    shards = run_mesh(MeshConfig(sp=2), rank)
    for i in range(3):
        close(np.concatenate([s[0][i] for s in shards], axis=1), want[i])
    # w is replicated: its grad is the sum of the shards' parts
    close(sum(s[1] for s in shards).numpy(), want[3])
