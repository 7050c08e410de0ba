"""GPT-2-tiny-MoE at ep 1 on the mesh in the port against the JAX
package's mesh loss_fn on the same mesh, in f32: at tp 2 (all 8 experts
on every rank, each one's hidden halved, a layout whose refusal this
port once pinned) and on a layout of one rank, where the aux loss's tape
term once ran through a graph the stage's output had already run
through: the loss, the aux loss and every leaf's gradient, and the whole
leaves' grads bit-equal across each axis's groups, by
test_torch_mesh_moe_jax.py's fixtures and checks (a file of its own to
keep each file's time short; test_torch_mesh_moe_jax_ep1_sp.py runs sp 2
and dp 2)."""
import pytest

from tests.test_torch_gpt2_pipelined import two_threads  # noqa: F401
from tests.test_torch_mesh_moe_jax import (  # noqa: F401
    check_grads, check_loss_and_aux_loss,
    check_whole_leaf_grads_are_bit_equal, oracle, runs, setup)

CASES = [("float32", "tp2"), ("float32", "one")]


@pytest.mark.parametrize("dtype,name", CASES)
def test_moe_loss_and_aux_loss_match_jax(oracle, runs, dtype, name):
    check_loss_and_aux_loss(oracle, runs, dtype, name)


@pytest.mark.parametrize("dtype,name", CASES)
def test_moe_grads_match_jax(oracle, runs, dtype, name):
    check_grads(oracle, runs, dtype, name)


@pytest.mark.parametrize("dtype,name", CASES)
def test_moe_whole_leaf_grads_are_bit_equal_across_groups(runs, dtype, name):
    check_whole_leaf_grads_are_bit_equal(runs, dtype, name)
