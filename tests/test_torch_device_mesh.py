"""The mesh on the device collective backend against the same mesh on
gloo: GPT-2-tiny at dp 2 x tp 2, pp 2 (two microbatches) and sp 2 (ring
attention), and GPT-2-tiny-MoE at dp 2 x ep 2, each rank's params cut
from one seeded init (tree_shard with partition_specs, stage_params at
pp 2), through pipelined_grads on the global batch. Every collective of
these layouts sums two operands (or moves a tensor), so the losses,
metrics and every leaf's gradient are the same bits on both backends, in
f32 and bf16. The ranks are threads of this process over one HashStore
(tests/torch_gang.run_mesh), torch at two intra-op threads, and every
group and join has a timeout."""
import dataclasses
import inspect

import pytest
import torch

from ray_tpu_torch import convert
from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.models import layers as TL
from ray_tpu_torch.parallel import sharding as TS
from ray_tpu_torch.parallel import train_step as TT
from ray_tpu_torch.parallel.mesh import Mesh, MeshConfig, init_rank_layout
from ray_tpu_torch.util import collective as col
from tests.test_torch_gpt2_pipelined import two_threads  # noqa: F401
from tests.torch_gang import run_mesh

B, S = 8, 32
# name: (mesh sizes, MoE in every block, microbatches)
LAYOUTS = {"dp2tp2": (dict(dp=2, tp=2), False, 1),
           "pp2": (dict(pp=2), False, 2),
           "sp2": (dict(sp=2), False, 1),
           "dp2ep2_moe": (dict(dp=2, ep=2), True, 1)}


def _cfg(dtype, moe):
    return dataclasses.replace(
        TG.gpt2_tiny(), max_seq=S, dtype=dtype, remat=False,
        moe=TL.MoEConfig() if moe else None)


def _run(name, dtype, backend):
    """Every rank's (metrics' bits, grads' bits, the backend its groups
    ran on) for one layout on ``backend``."""
    sizes, moe, n_mb = LAYOUTS[name]
    cfg = _cfg(dtype, moe)
    params = TG.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1),
                           generator=torch.Generator().manual_seed(1))
    specs = TG.partition_specs(cfg)

    def rank(lay):
        mine = TS.tree_shard(convert.stage_params(params, lay.pp_rank,
                                                  lay.pp), lay, specs)
        mine = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                        mine)
        metrics, grads = TT.pipelined_grads(mine, {"tokens": tokens}, cfg,
                                            lay, n_mb)
        return ({k: v.detach().float().item() for k, v in metrics.items()},
                [g.detach().contiguous().view(torch.uint8).numpy().tobytes()
                 for g in tree_leaves(grads)],
                {col.get_backend(g) for g in (lay.dp_group, lay.pp_group,
                                              lay.sp_group, lay.tp_group,
                                              lay.ep_group)})

    return run_mesh(MeshConfig(**sizes), rank, name=f"dm_{backend}",
                    backend=backend)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_device_and_gloo_meshes_agree_to_the_bit(name, dtype):
    device = _run(name, dtype, "device")
    gloo = _run(name, dtype, "gloo")
    for r, (d, g) in enumerate(zip(device, gloo)):
        assert d[2] == {"device"} and g[2] == {"gloo"}
        assert d[0] == g[0], f"rank {r}'s metrics differ"
        assert all(torch.isfinite(torch.tensor(v)) for v in d[0].values())
        assert len(d[1]) == len(g[1])
        bad = [i for i, (a, b) in enumerate(zip(d[1], g[1])) if a != b]
        assert not bad, f"rank {r}'s grads differ at leaves {bad}"


@pytest.mark.parametrize("join", [init_rank_layout, Mesh.join],
                         ids=["init_rank_layout", "Mesh.join"])
def test_the_mesh_joins_the_device_backend_by_default(join):
    """The JAX mesh's collectives are device collectives: a rank layout's
    groups are device groups unless another backend is asked for."""
    assert inspect.signature(join).parameters["backend"].default == "device"
