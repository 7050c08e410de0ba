"""Five train steps of GPT-2 at the mesh's tp axis in the port against
the JAX package's own run of them (test_parallel.py's
test_train_step_loss_decreases) on the same dp 2 x sp 2 x tp 2 mesh, in
f32, on the weights JAX's make_train_state makes, carried across with
convert.params_from_jax and cut by convert.stage_params and
sharding.tree_shard with gpt2.partition_specs. The port's ranks are
threads of this process over one HashStore (tests/torch_gang.run_mesh),
torch at two intra-op threads, and every group and join has a
timeout."""
import jax
import numpy as np
import torch

from ray_tpu.models import gpt2 as JG
from ray_tpu.parallel import train_step as JT
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig, create_mesh
from ray_tpu_torch._private.tree import tree_leaves
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.parallel import sharding as TS
from ray_tpu_torch.parallel import train_step as TT
from ray_tpu_torch.parallel.mesh import MeshConfig
from tests.test_torch_gpt2_pipelined import _cfgs, two_threads  # noqa: F401
from tests.test_torch_mesh_tp_jax import B, S, _is_tp, _rank_params
from tests.torch_gang import run_mesh

# five steps at lr 1e-2 in f32: the port's and JAX's losses and norms
# agree to f32 reassociation, grown by the steps
TRAIN_RTOL = 1e-4


def test_tp_train_steps_match_jax_losses():
    """Five steps of make_pipelined_train_step at dp 2 x sp 2 x tp 2 with
    default_optimizer(1e-2, warmup_steps=1, total_steps=50) against
    test_train_step_loss_decreases's run of the JAX package on the same
    mesh, in f32: the loss and grad norm of each step within TRAIN_RTOL;
    the loss falls; and after the steps each tp rank's whole leaves are
    the same bits as its twin's, its blocks put back together the same
    params on every rank."""
    jcfg, tcfg = _cfgs("float32")
    tokens = jax.random.randint(jax.random.PRNGKey(1), (B, S + 1), 0,
                                jcfg.vocab_size)
    mesh = create_mesh(JMeshConfig(dp=2, sp=2, tp=2))
    opt = JT.default_optimizer(1e-2, warmup_steps=1, total_steps=50)
    with jax.set_mesh(mesh):
        state = JT.make_train_state(lambda rng: JG.init(rng, jcfg),
                                    jax.random.PRNGKey(0), opt, mesh,
                                    JG.partition_specs(jcfg))
        step = JT.make_train_step(
            lambda p, b: JG.loss_fn(p, b, jcfg, mesh), opt, mesh)
        want = []
        for _ in range(5):
            state, metrics = step(state, {"tokens": tokens})
            want.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    init = jax.tree.map(np.asarray, JG.init(jax.random.PRNGKey(0), jcfg))
    batch = {"tokens": torch.from_numpy(np.array(tokens, np.int32))}
    specs = TG.partition_specs(tcfg)

    def rank(lay):
        o = TT.default_optimizer(1e-2, warmup_steps=1, total_steps=50)
        st = TT.make_train_state(lambda g: _rank_params(init, lay, tcfg),
                                 torch.Generator(), o, device="cpu")
        pstep = TT.make_pipelined_train_step(tcfg, o, lay, n_microbatches=1)
        got = []
        for _ in range(5):
            st, m = pstep(st, batch)
            got.append((float(m["loss"]), float(m["grad_norm"])))
        return (lay, got, st.step, tree_leaves(st.params),
                TS.tree_unshard(st.params, lay, specs))

    ranks = run_mesh(MeshConfig(dp=2, sp=2, tp=2), rank)
    whole = [not _is_tp(s) for s in tree_leaves(specs)]
    for lay, got, n_steps, leaves, full in ranks:
        np.testing.assert_allclose(got, want, rtol=TRAIN_RTOL)
        assert got[-1][0] < got[0][0] and n_steps == 5
        twin = next(r for r in ranks if r[0].tp_rank == 0 and (
            r[0].dp_rank, r[0].sp_rank) == (lay.dp_rank, lay.sp_rank))
        assert all(torch.equal(a, b) for a, b, w in zip(leaves, twin[3],
                                                        whole) if w)
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(full), tree_leaves(ranks[0][4])))
