"""GPT-2-tiny-MoE at ep 1 on the mesh in the port against the JAX
package's mesh loss_fn on the same mesh, in f32: at sp 2 (the sequence
halved, a layout whose refusal this port once pinned) and at dp 2, where
the aux loss's tape term once ran through a graph the stage's output had
already run through: the loss, the aux loss and every leaf's gradient,
and the whole leaves' grads bit-equal across each axis's groups, by
test_torch_mesh_moe_jax.py's fixtures and checks (a file of its own to
keep each file's time short; test_torch_mesh_moe_jax_ep1.py runs tp 2
and one rank)."""
import pytest

from tests.test_torch_gpt2_pipelined import two_threads  # noqa: F401
from tests.test_torch_mesh_moe_jax import (  # noqa: F401
    check_grads, check_loss_and_aux_loss,
    check_whole_leaf_grads_are_bit_equal, oracle, runs, setup)

CASES = [("float32", "sp2"), ("float32", "dp2")]


@pytest.mark.parametrize("dtype,name", CASES)
def test_moe_loss_and_aux_loss_match_jax(oracle, runs, dtype, name):
    check_loss_and_aux_loss(oracle, runs, dtype, name)


@pytest.mark.parametrize("dtype,name", CASES)
def test_moe_grads_match_jax(oracle, runs, dtype, name):
    check_grads(oracle, runs, dtype, name)


@pytest.mark.parametrize("dtype,name", CASES)
def test_moe_whole_leaf_grads_are_bit_equal_across_groups(runs, dtype, name):
    check_whole_leaf_grads_are_bit_equal(runs, dtype, name)
