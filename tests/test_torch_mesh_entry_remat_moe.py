"""remat on the tape through the port's mesh entry point against the JAX
package's remat: GPT-2-tiny-MoE at ep 2 x tp 2, in f32 and bf16, by
test_torch_mesh_entry_remat.py's fixtures and checks (a file of its own
to keep each file's time short)."""
import pytest

from tests.test_torch_gpt2_pipelined import TOL, two_threads  # noqa: F401
from tests.test_torch_mesh_entry_remat import (  # noqa: F401
    check_grads, check_metrics, check_remat_is_remat_off, oracle, runs,
    weights)

CASES = [(dt, "ep2tp2") for dt in TOL]


@pytest.mark.parametrize("dtype,name", CASES)
def test_remat_metrics_match_jax(oracle, runs, dtype, name):
    check_metrics(oracle, runs, dtype, name)


@pytest.mark.parametrize("dtype,name", CASES)
def test_remat_grads_match_jax(oracle, runs, dtype, name):
    check_grads(oracle, runs, dtype, name)


@pytest.mark.parametrize("name", ["ep2tp2"])
def test_remat_is_remat_off_in_f32(runs, name):
    check_remat_is_remat_off(runs, "float32", name)
