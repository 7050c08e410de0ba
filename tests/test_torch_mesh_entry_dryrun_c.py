"""The JAX package's dry run's config C on the port at n 8: dp 2 x pp 2 x
sp 2, GPT-2 with 4 layers, pipelined in 2 microbatches with ring
attention in the stages, batch_spec (("dp",), None); the first step's
loss within TOL of the JAX package's, by
test_torch_mesh_entry_dryrun_a.py's fixtures (a file of its own to keep
each file's time short)."""
from tests.test_torch_gpt2_pipelined import two_threads  # noqa: F401
from tests.test_torch_mesh_entry_dryrun_a import (check_dryrun_config,
                                                  dryrun_config)


def test_dryrun_config_c_first_step_matches_jax():
    sizes, _, _, pipelined, _, _ = dryrun_config("C")
    assert sizes == dict(dp=2, pp=2, sp=2) and pipelined
    check_dryrun_config("C")
