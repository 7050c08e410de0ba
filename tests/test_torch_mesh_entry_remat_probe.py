"""What remat on the tape (StageTape.checkpoint) keeps and what it runs,
through the port's mesh entry point on GPT-2-tiny (and GPT-2-tiny-MoE),
in f32: the bytes autograd saves during a stage's forward
(torch.autograd.graph.saved_tensors_hooks) are fewer with remat than
without, at pp 2, tp 2 and sp 2 x ep 2; and a train step with remat at
tp 2, sp 2 and sp 2 x ep 2 runs every collective outside any autograd
backward (graph task id -1, as
test_torch_gpt2_pipelined.py::test_no_collective_runs_inside_autograd_backward
checks without remat), and runs each collective as many times as remat
off does: the recompute replays the boundaries and the router's slot
counts instead of running them again. The port's ranks are threads of
this process over one HashStore (tests/torch_gang.run_on_mesh), torch at
two intra-op threads, and every group and join has a timeout."""
import collections
import dataclasses
import threading

import numpy as np
import pytest
import torch

from ray_tpu_torch._private.tree import tree_leaves
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.models import layers as TL
from ray_tpu_torch.parallel import mesh as M
from ray_tpu_torch.parallel import train_step as TT
from ray_tpu_torch.util import collective as col
from tests.test_torch_gpt2_pipelined import two_threads  # noqa: F401
from tests.torch_gang import run_on_mesh

B, S = 8, 32
# name: (mesh sizes, MoE, microbatches)
LAYOUTS = {"pp2": (dict(pp=2), False, 4), "tp2": (dict(tp=2), False, 1),
           "sp2": (dict(sp=2), False, 1),
           "sp2ep2": (dict(sp=2, ep=2), True, 1)}
OPS = ("allgather", "allgather_async", "allreduce", "allreduce_async",
       "barrier", "broadcast", "recv", "reducescatter",
       "reducescatter_async", "send", "sendrecv")


def _setup(name, remat):
    sizes, moe, m = LAYOUTS[name]
    cfg = dataclasses.replace(TG.gpt2_tiny(), dtype=torch.float32,
                              remat=remat,
                              moe=TL.MoEConfig() if moe else None)
    params = TG.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32))
    mesh = M.create_mesh(M.MeshConfig(**sizes), devices=[
        torch.device("cpu")] * int(np.prod(list(sizes.values()))))
    return cfg, params, {"tokens": tokens}, mesh, m


@pytest.mark.parametrize("name", ["pp2", "tp2", "sp2ep2"])
def test_remat_saves_fewer_bytes_per_stage(name):
    """The bytes of the tensors autograd saves during each rank's forward
    (its stage's, on its shard and blocks) with remat on are under half
    of those with remat off; the backward after each runs to its end."""
    saved = {}
    for remat in (False, True):
        cfg, params, batch, mesh, m = _setup(name, remat)

        def rank(lay):
            state = TT.make_train_state(lambda g: params, None,
                                        TT.default_optimizer(), lay,
                                        TG.partition_specs(cfg))
            tokens = TT.dp_rows(batch, lay, m)["tokens"]
            n = [0]

            def pack(t):
                n[0] += t.numel() * t.element_size()
                return t

            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                fwd = TG.forward_pipelined(state.params, tokens[:, :-1], cfg,
                                           lay, n_microbatches=m)
            bytes_forward = n[0]
            part = None
            if lay.is_last_stage:
                part = fwd.logits.float().square().mean()
            fwd.backward(part)
            return bytes_forward

        saved[remat] = run_on_mesh(mesh, rank, name=f"mem{name}")
    for on, off in zip(saved[True], saved[False]):
        assert 0 < off and on < off / 2, (saved, name)


@pytest.mark.parametrize("name", ["tp2", "sp2", "sp2ep2"])
def test_no_collective_runs_inside_autograd_backward_with_remat(
        name, monkeypatch):
    """Every collective call of a remat train step (make_train_step on
    the rank's layout) runs outside any autograd backward, and each op
    is called as many times on each rank as without remat."""
    calls, lock = {}, threading.Lock()
    for op in OPS:
        def probed(*a, _op=op, _fn=getattr(col, op), **kw):
            with lock:
                calls[threading.current_thread().name].append(
                    (_op, torch._C._current_graph_task_id()))
            return _fn(*a, **kw)
        monkeypatch.setattr(col, op, probed)

    counts = {}
    for remat in (False, True):
        cfg, params, batch, mesh, _ = _setup(name, remat)

        def rank(lay):
            with lock:
                calls[threading.current_thread().name] = []
            opt = TT.default_optimizer()
            state = TT.make_train_state(lambda g: params, None, opt, lay,
                                        TG.partition_specs(cfg))
            step = TT.make_train_step(lambda p, b: TG.loss_fn(p, b, cfg, lay),
                                      opt, lay)
            state, metrics = step(state, batch)
            assert np.isfinite(float(metrics["loss"]))
            return list(calls[threading.current_thread().name])

        counts[remat] = run_on_mesh(mesh, rank, name=f"probe{name}")
    for on, off in zip(counts[True], counts[False]):
        assert [c for c in on if c[1] != -1] == []
        assert collections.Counter(op for op, _ in on) == collections.Counter(
            op for op, _ in off)
    assert {op for op, _ in counts[True][0]} >= {"allreduce"}
