"""The JAX package's dry run's config B on the port at n 8: dp 2 x sp 2 x
ep 2, GPT-2 with MoE (4 experts, top-2, capacity factor 2) and
attention="ring", not pipelined, batch_spec (("dp",), "sp"); the first
step's loss within TOL of the JAX package's, by
test_torch_mesh_entry_dryrun_a.py's fixtures (a file of its own to keep
each file's time short)."""
from tests.test_torch_gpt2_pipelined import two_threads  # noqa: F401
from tests.test_torch_mesh_entry_dryrun_a import (check_dryrun_config,
                                                  dryrun_config)


def test_dryrun_config_b_first_step_matches_jax():
    sizes, _, cfg, pipelined, _, _ = dryrun_config("B")
    assert sizes == dict(dp=2, sp=2, ep=2)
    assert cfg.attention == "ring" and cfg.moe and not pipelined
    check_dryrun_config("B")
