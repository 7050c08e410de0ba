"""Five train steps of GPT-2-tiny-MoE on the mesh's ep, sp and tp axes at
once in the port against the JAX package's own run of them on the same
ep 2 x sp 2 x tp 2 mesh (make_train_step over gpt2.loss_fn(..., mesh),
as test_parallel.py's test_train_step_loss_decreases runs its mesh), in
f32, on the weights JAX's make_train_state makes, carried across with
convert.params_from_jax and cut by sharding.tree_shard with
gpt2.partition_specs. The port's ranks are threads of this process over
one HashStore (tests/torch_gang.run_mesh), torch at two intra-op
threads, and every group and join has a timeout."""
import jax
import numpy as np
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ray_tpu.models import gpt2 as JG
from ray_tpu.parallel import train_step as JT
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig, create_mesh
from ray_tpu_torch._private.tree import tree_leaves
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.parallel import sharding as TS
from ray_tpu_torch.parallel import train_step as TT
from ray_tpu_torch.parallel.mesh import MeshConfig
from tests.test_torch_gpt2_pipelined import two_threads  # noqa: F401
from tests.test_torch_mesh_ep_jax import B, S, _cfgs, rank_params
from tests.test_torch_mesh_ep_train import TRAIN_RTOL
from tests.test_torch_mesh_moe_jax import cuts
from tests.torch_gang import run_mesh

SIZES = dict(ep=2, sp=2, tp=2)


def test_moe_train_steps_at_ep2sp2tp2_match_jax():
    """Five steps of make_pipelined_train_step at ep 2 x sp 2 x tp 2 with
    default_optimizer(1e-2, warmup_steps=1, total_steps=50) against JAX's
    make_train_step on the same mesh, in f32: each step's loss, aux loss
    and grad norm within TRAIN_RTOL; the loss falls; the aux loss is
    positive at every step. After the steps the leaves the ranks of an
    ep, an sp or a tp group hold whole are the same bits on every rank of
    it, and the params put back together are the same on every rank."""
    jcfg, tcfg = _cfgs("float32")
    tokens = jax.random.randint(jax.random.PRNGKey(1), (B, S + 1), 0,
                                jcfg.vocab_size)
    mesh = create_mesh(JMeshConfig(**SIZES), devices=jax.devices()[:8])
    opt = JT.default_optimizer(1e-2, warmup_steps=1, total_steps=50)
    with jax.set_mesh(mesh):
        state = JT.make_train_state(lambda rng: JG.init(rng, jcfg),
                                    jax.random.PRNGKey(0), opt, mesh,
                                    JG.partition_specs(jcfg))
        init = jax.tree.map(np.asarray, state.params)
        step = JT.make_train_step(
            lambda p, b: JG.loss_fn(p, b, jcfg, mesh), opt, mesh)
        batch = {"tokens": jax.device_put(tokens, NamedSharding(mesh,
                                                                P("dp")))}
        want = []
        for _ in range(5):
            state, metrics = step(state, batch)
            want.append([float(metrics[k]) for k in ("loss", "aux_loss",
                                                     "grad_norm")])
    batch = {"tokens": torch.from_numpy(np.array(tokens, np.int32))}
    specs = TG.partition_specs(tcfg)

    def rank(lay):
        o = TT.default_optimizer(1e-2, warmup_steps=1, total_steps=50)
        st = TT.make_train_state(lambda g: rank_params(init, lay, tcfg),
                                 torch.Generator(), o, device="cpu")
        pstep = TT.make_pipelined_train_step(tcfg, o, lay, n_microbatches=1)
        got = []
        for _ in range(5):
            st, m = pstep(st, batch)
            got.append([float(m[k]) for k in ("loss", "aux_loss",
                                              "grad_norm")])
        return (lay, got, st.step, tree_leaves(st.params),
                TS.tree_unshard(st.params, lay, specs))

    ranks = run_mesh(MeshConfig(**SIZES), rank)
    coords = ("ep", "sp", "tp")
    for lay, got, n_steps, leaves, full in ranks:
        np.testing.assert_allclose(got, want, rtol=TRAIN_RTOL)
        assert got[-1][0] < got[0][0] and n_steps == 5
        assert all(aux > 0 for _, aux, _ in got)
        for axis in coords:
            twin = next(r for r in ranks if all(
                getattr(r[0], f"{a}_rank") == (
                    0 if a == axis else getattr(lay, f"{a}_rank"))
                for a in coords))
            assert all(torch.equal(a, b) for a, b, s in zip(
                leaves, twin[3], tree_leaves(specs)) if not cuts(s, axis)), \
                (axis, lay.rank)
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(full), tree_leaves(ranks[0][4])))
