"""The MoE router and layer on the mesh's sp axis in the port
(models.layers.route_tokens and apply_moe with a layout's sp group: each
rank holds its replica's rows and its shard of the sequence, the slots
counted over the whole batch's (b, s, k) stream, row by row across the
shards, by parallel.expert_parallel.route_counts) against the JAX
package's apply_moe on the whole batch, at sp 2, dp 2 x sp 2 and sp 2 x
ep 2, in f32: the experts and slots of every (b, s, k) pair against the
JAX package's positions over the flattened stream, the pairs dropped in
a capacity-tight case, the aux loss (the ranks' shares summed over sp)
on every rank, and the layer's output and gradients, with
test_parallel.py's test_moe_ep_sharded tolerance
(test_torch_mesh_moe_tp.py's checks). The port's ranks are threads of
this process over one HashStore (tests/torch_gang.run_mesh), torch at
two intra-op threads, and every group and join has a timeout; each JAX
oracle is computed once a module."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.models import layers as TL
from ray_tpu_torch.parallel.mesh import MeshConfig
from tests.test_torch_gpt2_pipelined import two_threads  # noqa: F401
from tests.test_torch_mesh_ep import EP_CFG, _moe_cfgs
from tests.test_torch_mesh_moe_tp import (X_SHAPE, block, check_layer,
                                          check_tight, jax_layer_case,
                                          tight_case)
from tests.torch_gang import run_mesh

LAYOUTS = {"sp2": MeshConfig(sp=2), "dp2sp2": MeshConfig(dp=2, sp=2),
           "sp2ep2": MeshConfig(sp=2, ep=2)}


@pytest.fixture(scope="module")
def ep_case():
    """test_moe_ep_sharded's weights and input (key 4) and JAX's layer."""
    return jax_layer_case(4, EP_CFG, X_SHAPE)


def _jax_slots(params, x, jcfg):
    """(the experts [B, S, K], each pair's position in its expert's
    buffer [B, S, K]) by the JAX package's own lines
    (ray_tpu/models/layers.py:249-274) over the whole batch."""
    B, S, _ = x.shape
    E, K = jcfg.n_experts, jcfg.top_k
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, params["wg"]), -1)
    _, gate_idx = jax.lax.top_k(probs, K)
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.int32)
    pos = (jnp.cumsum(onehot.reshape(B * S * K, E), axis=0) - 1).reshape(
        B, S, K, E)
    slots = jnp.take_along_axis(pos, gate_idx[..., None], axis=-1)[..., 0]
    return np.asarray(gate_idx), np.asarray(slots)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_slots_are_the_jax_positions_over_the_stream(ep_case, name):
    """Every rank's experts and slots for its rows and shard are the JAX
    package's for the same pairs, counted over the whole flattened (b, s,
    k) stream: within a row the shards before this one come first, then
    the next row starts on shard 0; slots run past a shard's own pairs."""
    params, x, *_ = ep_case
    jcfg, cfg = _moe_cfgs(*EP_CFG)
    experts_w, slots_w = _jax_slots(params, jnp.asarray(x), jcfg)
    assert slots_w.max() >= x.shape[0] * x.shape[1] // cfg.n_experts

    def rank(lay):
        xs = torch.from_numpy(np.ascontiguousarray(block(x, lay)))
        _, _, experts, slots = TL.route_tokens(
            torch.tensor(params["wg"]), xs, cfg, dp_group=lay.dp_group,
            sp_group=lay.sp_group)
        return lay, experts.numpy(), slots.numpy()

    for lay, experts, slots in run_mesh(LAYOUTS[name], rank):
        np.testing.assert_array_equal(experts, block(experts_w, lay))
        np.testing.assert_array_equal(slots, block(slots_w, lay))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_capacity_tight_drops_at_sp_are_the_jax_packages(name):
    """At capacity factor 0.5 the dropped (token, k) pairs are exactly
    the JAX package's (the capacity the whole batch's, not a shard's),
    and the outputs are its apply_moe's."""
    check_tight(tight_case(7, X_SHAPE), LAYOUTS[name])


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_apply_moe_at_sp_matches_jax(ep_case, name):
    """The output, the aux loss (the ranks' shares summed over sp and
    averaged over dp: the same on every rank) and the grads of x, wg, w1
    and w2 against JAX's apply_moe on the whole batch."""
    check_layer(ep_case, LAYOUTS[name])
