"""GPT-2 at dp 2 x pp 2 x tp 2 in the port against the JAX package's
forward_pipelined on the same mesh (test_parallel.py's
test_gpt2_pipelined_matches_dense): test_torch_mesh_tp_jax.py's checks
(each last-stage rank's block of the logits, the grads of mean(logits **
2) put back together over tp and the stages, the value and the
next-token loss, in f32 and bf16 with test_torch_gpt2_pipelined.py's
TOL, and the whole leaves' grads bit-equal across tp ranks) on that
layout, a file of its own to keep each under ~30 s. The port's ranks are
threads of this process over one HashStore, torch at two intra-op
threads, and every group and join has a timeout."""
import pytest

from tests.test_torch_mesh_tp_jax import (  # noqa: F401 (fixtures)
    TOL, check_grads, check_logits, check_value_and_next_token_loss,
    check_whole_leaf_grads_are_bit_equal_across_tp, oracles, runs, setup,
    two_threads)

CASES = [(dt, "dp2pp2tp2") for dt in TOL]


@pytest.mark.parametrize("dtype,name", CASES)
def test_tp_pp_logits_match_jax(oracles, runs, dtype, name):
    check_logits(oracles, runs, dtype, name)


@pytest.mark.parametrize("dtype,name", CASES)
def test_tp_pp_grads_match_jax(oracles, runs, dtype, name):
    check_grads(oracles, runs, dtype, name)


@pytest.mark.parametrize("dtype,name", CASES)
def test_tp_pp_value_and_next_token_loss_match_jax(oracles, runs, dtype,
                                                   name):
    check_value_and_next_token_loss(oracles, runs, dtype, name)


@pytest.mark.parametrize("dtype,name", CASES)
def test_tp_pp_whole_leaf_grads_are_bit_equal_across_tp(runs, dtype, name):
    check_whole_leaf_grads_are_bit_equal_across_tp(runs, dtype, name)
