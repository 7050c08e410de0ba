"""The JAX package's multi-chip dry run (__graft_entry__._dryrun_impl) on
the port at n 8: its config A (dp 2 x pp 2 x tp 2, pipelined), built as
_dryrun_impl builds it: create_mesh of balanced_factorization's sizes,
make_train_state(..., mesh, gpt2.partition_specs(cfg)), make_train_step
of gpt2.loss_fn(p, b, cfg, mesh, pipelined=..., n_microbatches=2) with
its batch_spec, one step on the global batch. The first step's loss on
every rank is within test_torch_gpt2_pipelined.py's TOL (the configs'
bf16) of the JAX package's step on the same weights (its
make_train_state's, carried across with convert.params_from_jax) and
tokens. The fixtures serve test_torch_mesh_entry_dryrun_b.py (config B:
dp x sp x ep, MoE, ring attention) and _c.py (config C: dp x pp x sp,
pipelined), a config a file. The port's ranks are threads of this
process over one HashStore (tests/torch_gang.run_on_mesh), torch at two
intra-op threads, and every group and join has a timeout."""
import jax
import numpy as np
import torch
from jax.sharding import PartitionSpec as P

from ray_tpu.models import gpt2 as JG
from ray_tpu.models.layers import MoEConfig as JMoEConfig
from ray_tpu.parallel import mesh as JM
from ray_tpu.parallel import train_step as JT
from ray_tpu_torch import convert
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.models.layers import MoEConfig
from ray_tpu_torch.parallel import mesh as M
from ray_tpu_torch.parallel import train_step as TT
from tests.test_torch_gpt2_pipelined import TOL, two_threads  # noqa: F401
from tests.torch_gang import run_on_mesh

N = 8


def dryrun_config(name):
    """_dryrun_impl's config ``name`` at n 8, for both packages: (mesh
    sizes, JAX config, the port's config, pipelined, batch, seq)."""
    if name == "A":
        f = JM.balanced_factorization(N, ["dp", "pp", "tp"])
        kw = dict(vocab_size=256, max_seq=64, n_layer=2 * f["pp"],
                  n_head=2 * f["tp"], d_model=16 * f["tp"], remat=False,
                  attention="reference")
        return (f, JG.GPT2Config(**kw), TG.GPT2Config(**kw), f["pp"] > 1,
                4 * f["dp"], 32)
    if name == "B":
        f = JM.balanced_factorization(N, ["dp", "sp", "ep"])
        kw = dict(vocab_size=256, max_seq=64, n_layer=2, n_head=4,
                  d_model=32, remat=False,
                  attention="ring" if f["sp"] > 1 else "reference")
        moe = dict(n_experts=2 * f["ep"], top_k=2, capacity_factor=2.0)
        return (dict(dp=f["dp"], sp=f["sp"], ep=f["ep"]),
                JG.GPT2Config(**kw, moe=JMoEConfig(**moe)),
                TG.GPT2Config(**kw, moe=MoEConfig(**moe)), False,
                2 * f["dp"], 2 * f["sp"] * 8)
    f = JM.balanced_factorization(N, ["dp", "pp", "sp"])
    kw = dict(vocab_size=256, max_seq=64, n_layer=2 * max(f["pp"], 1),
              n_head=4, d_model=32, remat=False, attention="reference")
    return (dict(dp=f["dp"], pp=f["pp"], sp=f["sp"]), JG.GPT2Config(**kw),
            TG.GPT2Config(**kw), f["pp"] > 1, 4 * f["dp"], 2 * f["sp"] * 8)


def jax_first_step(name):
    """(the first step's loss, the weights it started from, the tokens),
    as _dryrun_impl's run makes them."""
    sizes, jcfg, _, pipelined, batch, seq = dryrun_config(name)
    mesh = JM.create_mesh(JM.MeshConfig(**sizes), devices=jax.devices()[:N])
    opt = JT.default_optimizer(1e-3, warmup_steps=1, total_steps=10)
    with jax.set_mesh(mesh):
        state = JT.make_train_state(
            lambda rng: JG.init(rng, jcfg), jax.random.PRNGKey(0), opt, mesh,
            JG.partition_specs(jcfg))
        params = jax.tree.map(np.asarray, state.params)
        step = JT.make_train_step(
            lambda p, b: JG.loss_fn(p, b, jcfg, mesh, pipelined=pipelined,
                                    n_microbatches=2),
            opt, mesh,
            batch_spec=P(("dp",), None) if pipelined else P(("dp",), "sp"))
        tokens = jax.random.randint(jax.random.PRNGKey(1), (batch, seq + 1),
                                    0, jcfg.vocab_size)
        state, metrics = step(state, {"tokens": tokens})
        return float(metrics["loss"]), params, np.array(tokens, np.int32)


def port_first_step(name, params, tokens):
    """Every rank's first-step metrics through the port's entry point."""
    sizes, _, cfg, pipelined, _, _ = dryrun_config(name)
    mesh = M.create_mesh(M.MeshConfig(**sizes),
                         devices=[torch.device("cpu")] * N)
    batch = {"tokens": torch.from_numpy(tokens)}

    def rank(lay):
        opt = TT.default_optimizer(1e-3, warmup_steps=1, total_steps=10)
        state = TT.make_train_state(
            lambda g: convert.params_from_jax(params, "cpu"), None, opt, lay,
            TG.partition_specs(cfg))
        step = TT.make_train_step(
            lambda p, b: TG.loss_fn(p, b, cfg, lay, pipelined=pipelined,
                                    n_microbatches=2),
            opt, lay,
            batch_spec=(("dp",), None) if pipelined else (("dp",), "sp"))
        state, metrics = step(state, batch)
        assert state.step == 1
        return {k: float(v) for k, v in metrics.items()}

    return run_on_mesh(mesh, rank, name=f"dryrun{name}")


def check_dryrun_config(name):
    want, params, tokens = jax_first_step(name)
    assert np.isfinite(want)
    ranks = port_first_step(name, params, tokens)
    for metrics in ranks:
        assert metrics == ranks[0]
        np.testing.assert_allclose(metrics["loss"], want,
                                   atol=TOL["bfloat16"][1], rtol=0)


def test_dryrun_config_a_first_step_matches_jax():
    """Config A: dp 2 x pp 2 x tp 2, gpt2 with 4 layers of 4 heads at d
    32, pipelined in 2 microbatches, batch_spec (("dp",), None)."""
    assert dryrun_config("A")[0] == dict(dp=2, pp=2, tp=2)
    check_dryrun_config("A")
