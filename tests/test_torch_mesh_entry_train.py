"""Five train steps of GPT-2 through the port's mesh entry point against
the JAX package's own (test_parallel.py's test_train_step_loss_decreases,
the stronger twin): create_mesh(MeshConfig(dp=2, sp=2, tp=2)) over eight
devices, each rank's Mesh.join, make_train_state(..., layout,
gpt2.partition_specs(cfg)) and make_train_step(lambda p, b:
gpt2.loss_fn(p, b, cfg, layout), opt, layout), every rank given the
global batch, against JAX's make_train_state and make_train_step on
create_mesh of the same sizes, in f32, on the weights JAX's
make_train_state makes, carried across with convert.params_from_jax.
The port's ranks are threads of this process over one HashStore
(tests/torch_gang.run_on_mesh), torch at two intra-op threads, and every
group and join has a timeout."""
import jax
import numpy as np
import torch

from ray_tpu.models import gpt2 as JG
from ray_tpu.parallel import train_step as JT
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig, create_mesh
from ray_tpu_torch import convert
from ray_tpu_torch._private.tree import tree_leaves
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.parallel import mesh as M
from ray_tpu_torch.parallel import sharding as TS
from ray_tpu_torch.parallel import train_step as TT
from tests.test_torch_gpt2_pipelined import TOL, _cfgs, two_threads  # noqa: F401
from tests.torch_gang import run_on_mesh

B, S = 8, 32
SIZES = dict(dp=2, sp=2, tp=2)
STEPS = 5


def test_mesh_train_steps_match_jax():
    """Each step's loss within TOL's f32 loss bound of JAX's, and its grad
    norm within TOL's f32 grad bound; the loss falls; every rank reports
    the same metrics; and after the steps the leaves each tp rank holds
    whole are the same bits across the tp ranks, and the blocks put back
    together the same params on every rank."""
    jcfg, tcfg = _cfgs("float32")
    tokens = jax.random.randint(jax.random.PRNGKey(1), (B, S + 1), 0,
                                jcfg.vocab_size)
    jmesh = create_mesh(JMeshConfig(**SIZES))
    opt = JT.default_optimizer(1e-2, warmup_steps=1, total_steps=50)
    with jax.set_mesh(jmesh):
        state = JT.make_train_state(lambda rng: JG.init(rng, jcfg),
                                    jax.random.PRNGKey(0), opt, jmesh,
                                    JG.partition_specs(jcfg))
        init = jax.tree.map(np.asarray, state.params)
        step = JT.make_train_step(
            lambda p, b: JG.loss_fn(p, b, jcfg, jmesh), opt, jmesh)
        want = []
        for _ in range(STEPS):
            state, metrics = step(state, {"tokens": tokens})
            want.append((float(metrics["loss"]),
                         float(metrics["grad_norm"])))
    batch = {"tokens": torch.from_numpy(np.array(tokens, np.int32))}
    specs = TG.partition_specs(tcfg)
    mesh = M.create_mesh(M.MeshConfig(**SIZES),
                         devices=[torch.device("cpu")] * 8)

    def rank(lay):
        o = TT.default_optimizer(1e-2, warmup_steps=1, total_steps=50)
        st = TT.make_train_state(
            lambda g: convert.params_from_jax(init, "cpu"), None, o, lay,
            specs)
        assert all(p.device == lay.device for p in tree_leaves(st.params))
        step = TT.make_train_step(lambda p, b: TG.loss_fn(p, b, tcfg, lay),
                                  o, lay)
        got = []
        for _ in range(STEPS):
            st, m = step(st, batch)
            got.append((float(m["loss"]), float(m["grad_norm"])))
        return (lay, got, st.step, tree_leaves(st.params),
                TS.tree_unshard(st.params, lay, specs))

    ranks = run_on_mesh(mesh, rank, name="entry")
    _, atol_loss, tol_grads = TOL["float32"]
    whole = [not any("tp" in TS.spec_axes(e) for e in s)
             for s in tree_leaves(specs)]
    for lay, got, n_steps, leaves, full in ranks:
        assert got == ranks[0][1] and n_steps == STEPS
        np.testing.assert_allclose([g[0] for g in got],
                                   [w[0] for w in want], atol=atol_loss,
                                   rtol=0)
        np.testing.assert_allclose([g[1] for g in got],
                                   [w[1] for w in want], atol=tol_grads,
                                   rtol=tol_grads)
        assert got[-1][0] < got[0][0]
        twin = next(r for r in ranks if r[0].tp_rank == 0 and (
            r[0].dp_rank, r[0].sp_rank) == (lay.dp_rank, lay.sp_rank))
        assert all(torch.equal(a, b) for a, b, w in zip(leaves, twin[3],
                                                        whole) if w)
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(full), tree_leaves(ranks[0][4])))
