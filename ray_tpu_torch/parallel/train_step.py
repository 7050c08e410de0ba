"""The training step. Port of ``ray_tpu/parallel/train_step.py``: its plain
regime (one device, gradients and update in one call) and its mesh
regime (``mesh=``, ``param_specs=``, ``batch_spec=``).

``default_optimizer`` reproduces the JAX package's optax chain,
``clip_by_global_norm(grad_clip)`` then ``adamw(warmup-cosine schedule,
b2, weight_decay)``, step for step, including the schedule being read at
the step count before its increment (so the first step has lr 0).

Unlike JAX, the update happens in place: ``update`` writes the new
parameters and moments into the tensors it is given, and a step returns a
``TrainState`` holding those same tensors.

``make_train_step`` also runs the data-parallel gang's two host regimes:
``host_grad_sync`` (a grad step, the hook, then the update on the synced
grads) and ``host_optimizer`` (a ``train.ddp.ZeroOptimizer`` owns the
sync and the update). The state-bytes gauges are not ported.

**The mesh regime.** Where the JAX package runs one program over a
``Mesh``, each rank of the port runs the step on its own
``parallel.mesh.RankLayout`` (``Mesh.join``), passed as ``mesh``:
``make_train_state(..., layout, param_specs)`` holds the rank's pp stage
(``convert.stage_params``) cut to its tp and ep blocks
(``sharding.tree_shard``); ``make_train_step(loss_fn, opt, layout,
batch_spec=...)`` is given the global batch on every rank, cuts the
rank's replica's rows by ``batch_spec`` (``batch_rows``), takes the
gradient, averages it and the metrics over the ``dp`` group, takes the
global norm over every stage, tp block and expert block and updates the
rank's own leaves, which is the whole model's update restricted to them:
AdamW works element by element and clips by the global norm. A mesh (or
a layout) of one rank is the plain regime.

The gradient on a layout of several ranks is a schedule, never autograd
through a collective (``parallel/pipeline.py``): the step asks for it
(``pipeline.scheduled_gradients``) around its call of ``loss_fn``, and
``gpt2.loss_fn(p, b, cfg, layout, ...)`` computes it by
``gpt2.value_and_grad_pipelined`` and hands it over with the params it
was given, which must be the state's, and the loss it returns, which
the closure must return unchanged (one that adds a term or scales it is
refused, as its gradient would be GPT-2's alone). A loss function that hands
nothing over is differentiated by autograd on its replica's rows at dp
alone (no other axis above 1), where no collective runs in its graph,
and its gradient averaged over dp; on a layout with pp, ep, sp or tp
above 1 it is refused after its forward, before any backward.
``make_pipelined_train_step`` is that step for GPT-2's pipelined loss.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ray_tpu_torch import convert
from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch._private.tree import tree_leaves, tree_map, tree_unflatten
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.parallel import pipeline
from ray_tpu_torch.parallel import sharding as sh
from ray_tpu_torch.parallel.mesh import rank_layout
from ray_tpu_torch.train import ddp
from ray_tpu_torch.util import collective as col

# the JAX package's default batch spec, P(("dp",), "sp"), as a tuple
DEFAULT_BATCH_SPEC = (("dp",), "sp")


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    opt_state: Any
    # on a layout, the specs ``params`` were cut by (``make_train_state``'s
    # ``param_specs``): which leaves are blocks over tp and ep, for the norm
    param_specs: Any = None


def _sum_of_squares(tree) -> torch.Tensor:
    return sum(torch.sum(x.float() * x.float()) for x in tree_leaves(tree))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    return torch.sqrt(_sum_of_squares(tree))


def warmup_cosine_decay_schedule(peak_value: float, warmup_steps: int,
                                 decay_steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, peak_value, warmup_steps,
    decay_steps): linear from 0 to the peak over ``warmup_steps``, then
    cosine down to 0 at ``decay_steps``."""
    cos_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return peak_value * max(count, 0) / warmup_steps
        t = min(count - warmup_steps, cos_steps)
        return peak_value * 0.5 * (1 + math.cos(math.pi * t / cos_steps))

    return schedule


class ClipAdamW:
    """clip_by_global_norm then adamw, as optax computes them:

    * clip: ``g`` if ``norm < max_norm`` else ``g / norm * max_norm``
      (not ``clip_grad_norm_``'s ``max_norm / (norm + 1e-6)``);
    * adam (b1 0.9, eps 1e-8, eps_root 0): ``mu = (1-b1) g + b1 mu``,
      ``nu = (1-b2) g^2 + b2 nu``, bias corrected at count+1,
      ``u = mu_hat / (sqrt(nu_hat) + eps)``;
    * decoupled weight decay on every leaf, no mask: ``u + wd * p``;
    * ``p += -lr(count) * u``.

    ``init`` returns ``{"count", "mu", "nu"}``. ``update`` applies the step
    to ``params`` and to the moments in place and returns the new state.
    """

    b1 = 0.9
    eps = 1e-8

    def __init__(self, schedule: Callable[[int], float], *, max_norm: float,
                 b2: float, weight_decay: float):
        self.schedule = schedule
        self.max_norm = max_norm
        self.b2 = b2
        self.weight_decay = weight_decay

    def init(self, params):
        def zeros(p):
            return torch.zeros_like(p, memory_format=torch.contiguous_format)

        return {"count": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update(self, grads, opt_state, params, g_norm):
        """``g_norm`` is ``global_norm(grads)``, which the step reports too."""
        b1, b2 = self.b1, self.b2
        # optax's where(norm < max, g, g / norm * max) as one factor
        clip = torch.clamp(self.max_norm / g_norm, max=1.0)
        count = opt_state["count"] + 1
        bc1 = 1 - b1 ** count
        bc2 = 1 - b2 ** count
        step = -self.schedule(opt_state["count"])
        for g, mu, nu, p in zip(tree_leaves(grads), tree_leaves(opt_state["mu"]),
                                tree_leaves(opt_state["nu"]),
                                tree_leaves(params)):
            g = g * clip
            mu.mul_(b1).add_(g, alpha=1 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1 - b2)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * p
            p.add_(step * u)
        return {"count": count, "mu": opt_state["mu"], "nu": opt_state["nu"]}


def default_optimizer(
    learning_rate: float = 3e-4,
    *,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    weight_decay: float = 0.1,
    b2: float = 0.95,
    grad_clip: float = 1.0,
) -> ClipAdamW:
    sched = warmup_cosine_decay_schedule(
        learning_rate, warmup_steps, max(total_steps, warmup_steps + 1))
    return ClipAdamW(sched, max_norm=grad_clip, b2=b2,
                     weight_decay=weight_decay)


def _init_params(init_params_fn, generator, mesh, param_specs, device):
    layout, mesh_device = rank_layout(mesh)
    dev = resolve_device(device if device is not None else mesh_device)
    params = init_params_fn(generator)
    if layout is not None:
        if layout.pp > 1:
            params = convert.stage_params(params, layout.pp_rank, layout.pp)
        if param_specs is not None:
            params = sh.tree_shard(params, layout, param_specs)
    return tree_map(lambda p: p.to(dev).requires_grad_(True), params)


def make_train_state(
    init_params_fn: Callable[[torch.Generator], Any],
    generator: torch.Generator,
    optimizer: ClipAdamW,
    mesh=None,
    param_specs: Any = None,
    *,
    device: DeviceLike = None,
) -> TrainState:
    """Params from ``init_params_fn(generator)``, moved to ``device`` (the
    mesh's device for this rank, else CUDA, by default) and marked as
    requiring grad, plus the optimizer state. On a rank layout (``mesh``,
    from ``Mesh.join``) of several ranks the whole tree is cut to the
    rank's: its pp stage, then its blocks by ``param_specs`` (the leaves
    of ``gpt2.partition_specs``; whole without them), which the state
    keeps for the step's norm."""
    params = _init_params(init_params_fn, generator, mesh, param_specs,
                          device)
    return TrainState(step=0, params=params, opt_state=optimizer.init(params),
                      param_specs=param_specs)


def make_zero_train_state(
    init_params_fn: Callable[[torch.Generator], Any],
    generator: torch.Generator,
    mesh=None,
    param_specs: Any = None,
    *,
    device: DeviceLike = None,
) -> TrainState:
    """``make_train_state`` for the ZeRO regime: the optimizer state lives
    in a ``train.ddp.ZeroOptimizer``, sharded over the gang, so
    ``opt_state`` is the empty tuple."""
    return TrainState(step=0, opt_state=(), param_specs=param_specs,
                      params=_init_params(init_params_fn, generator, mesh,
                                          param_specs, device))


def _grads(loss_fn, params, batch):
    """(detached metrics, grads tree) of one loss_fn call."""
    loss, metrics = loss_fn(params, batch)
    grads = tree_unflatten(params, torch.autograd.grad(loss,
                                                       tree_leaves(params)))
    return {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(loss_fn: Callable[[Any, Any], tuple],
                    optimizer: ClipAdamW | None, mesh=None, *,
                    batch_spec: tuple = DEFAULT_BATCH_SPEC,
                    host_grad_sync: Callable[[Any], Any] | None = None,
                    host_optimizer: Any = None):
    """loss_fn(params, batch) -> (scalar_loss, metrics_dict).

    Returns step(state, batch) -> (state, metrics); metrics are detached
    scalars and carry ``grad_norm``, the global norm before clipping.

    ``host_grad_sync`` is the host data-parallel hook, a callable
    ``grads -> synced grads`` (canonically ``train.ddp.sync_gradients``)
    run between the grad step and the update; ``grad_norm`` is then the
    synced grads' norm, the one the update clips by.

    ``host_optimizer`` (a ``train.ddp.ZeroOptimizer``; ``optimizer`` is
    not used) selects the ZeRO regime: the step computes grads, and the
    sharded optimizer reducescatters them, applies this rank's shards and
    allgathers the updated params asynchronously. The next call waits for
    those gathers first; ``step.finalize(state)`` folds the last step's
    params into the state after the loop. ``grad_norm`` is this rank's
    norm before the sync. The two hooks are mutually exclusive.

    On a rank layout (``mesh``) of several ranks, step(state, batch) is
    given the global batch on every rank and runs the mesh regime (the
    module's docstring): ``loss_fn`` sees the rows ``batch_rows`` cuts by
    ``batch_spec``, and the metrics come back the same on every rank. The
    host hooks are the data-parallel gang's, without a mesh: on a layout
    the step averages over dp itself, and refuses them.
    """
    layout, _ = rank_layout(mesh)
    if layout is not None:
        if host_grad_sync is not None or host_optimizer is not None:
            raise ValueError(
                "on a rank layout the step averages its gradients over dp "
                "itself; host_grad_sync and host_optimizer are the gang's, "
                "without a mesh")
        _check_batch_spec(batch_spec, layout)
        return _layout_step(
            loss_fn, optimizer, layout,
            lambda batch: batch_rows(batch, layout, batch_spec))
    if host_optimizer is not None:
        if host_grad_sync is not None:
            raise ValueError("host_optimizer and host_grad_sync are "
                             "mutually exclusive: the sharded optimizer "
                             "owns the gradient sync")
        pending = [None]

        def resolve(state: TrainState) -> TrainState:
            if pending[0] is None:
                return state
            params = pending[0].result(timeout=None)
            pending[0] = None
            return dataclasses.replace(
                state, params=tree_map(lambda p: p.requires_grad_(True),
                                       params))

        def zero_step(state: TrainState, batch):
            state = resolve(state)
            metrics, grads = _grads(loss_fn, state.params, batch)
            metrics["grad_norm"] = global_norm(grads)
            pending[0] = host_optimizer.step_async(state.params, grads)
            return dataclasses.replace(state, step=state.step + 1), metrics

        zero_step.finalize = resolve
        return zero_step

    def step(state: TrainState, batch):
        metrics, grads = _grads(loss_fn, state.params, batch)
        if host_grad_sync is not None:
            grads = host_grad_sync(grads)
        metrics["grad_norm"] = global_norm(grads)
        opt_state = optimizer.update(grads, state.opt_state, state.params,
                                     metrics["grad_norm"])
        return (TrainState(step=state.step + 1, params=state.params,
                           opt_state=opt_state), metrics)

    return step


def _squares_over_shards(tree, specs, layout) -> torch.Tensor:
    """The sum of squares of the whole model's leaves of which ``tree``
    holds this rank's blocks: each leaf's squares summed over the groups
    of the axes its spec cuts it over (tp for the heads, hidden and vocab,
    ep for the experts), the whole ones (the same on every rank) counted
    once."""
    cut = [a for a in ("ep", "tp") if sh.axis_size(layout, a) > 1]
    if not cut:
        return _sum_of_squares(tree)
    leaves = tree_leaves(tree)
    totals = {}
    for g, spec in zip(leaves, tree_leaves(specs), strict=True):
        axes = tuple(a for a in cut
                     if any(a in sh.spec_axes(entry) for entry in spec))
        square = torch.sum(g.float() * g.float())
        totals[axes] = totals[axes] + square if axes in totals else square
    out = torch.zeros((), device=leaves[0].device)
    for axes in sorted(totals):
        total = totals[axes]
        for a in axes:
            total = col.allreduce(total, getattr(layout, f"{a}_group")).to(
                total.device)
        out = out + total
    return out


def pipelined_global_norm(grads, layout, specs=None) -> torch.Tensor:
    """The whole model's gradient norm from one rank's grads on a pipeline
    ``layout``: the squares of the stage's block grads summed over the
    ``pp`` group, plus the shared leaves' (the same on every stage) once.
    At tp > 1 or ep > 1 ``specs`` (``gpt2.partition_specs``) names the
    leaves cut over those axes, whose squares are summed over their
    groups; the leaves every rank holds whole count once. A tree without
    ``blocks`` (not a stage tree) runs at pp 1 only."""
    if (layout.tp > 1 or layout.ep > 1) and specs is None:
        raise ValueError("at tp > 1 or ep > 1 the norm needs the grads' "
                         "partition specs (gpt2.partition_specs)")
    if "blocks" not in grads:
        # a tree that is not a stage tree: whole on every stage
        if layout.pp > 1:
            raise ValueError("at pp > 1 the norm sums a stage tree's "
                             "'blocks' over pp (convert.stage_params)")
        return torch.sqrt(_squares_over_shards(grads, specs, layout))
    specs = specs or {}
    blocks = _squares_over_shards(grads["blocks"], specs.get("blocks"),
                                  layout)
    if layout.pp > 1:
        blocks = col.allreduce(blocks, layout.pp_group).to(blocks.device)
    shared = {k: v for k, v in grads.items() if k != "blocks"}
    shared = _squares_over_shards(
        shared, {k: specs.get(k) for k in shared}, layout)
    return torch.sqrt(blocks + shared)


def batch_rows(batch, layout, batch_spec: tuple = DEFAULT_BATCH_SPEC):
    """This rank's part of the global ``batch`` under ``batch_spec``, the
    JAX package's ``PartitionSpec`` as a tuple (``sharding.spec``'s
    form): the rows are cut over ``dp`` (``dp_rows``); the sequence may
    be named ``"sp"`` or None alike, since the model takes the rank's
    shard of the sequence itself, as a shard's targets reach one token
    past its end. Raises ``ValueError`` for a spec the port does not
    cut: the rows on another axis, or whole at dp > 1 (each replica
    takes its own rows: the router and the dp average count them once),
    the sequence on another axis than sp, or a dimension past it named."""
    _check_batch_spec(batch_spec, layout)
    return dp_rows(batch, layout, 1)


def _check_batch_spec(batch_spec: tuple, layout) -> None:
    spec = tuple(batch_spec)
    rows = sh.spec_axes(spec[0]) if spec else ()
    seq = sh.spec_axes(spec[1]) if len(spec) > 1 else ()
    if (rows not in ((), ("dp",)) or (layout.dp > 1 and rows != ("dp",))
            or seq not in ((), ("sp",)) or any(e is not None
                                               for e in spec[2:])):
        raise ValueError(
            f"batch_spec {batch_spec!r}: the port cuts the rows over dp "
            f"(each replica its own) and takes the sequence's shards over "
            f"sp itself: pass (('dp',), 'sp') or (('dp',), None)")


def dp_rows(batch, layout, n_microbatches: int):
    """This rank's replica's rows of the global ``batch`` (a dict of
    tensors of B rows): the ``dp_rank``-th of ``dp`` contiguous blocks of
    B / dp rows of each, as ``P("dp")`` cuts the
    batch on the JAX mesh; its microbatches are cut from them. Raises
    unless B divides into dp x ``n_microbatches``."""
    B = next(iter(batch.values())).shape[0]
    if B % (layout.dp * n_microbatches):
        raise ValueError(
            f"batch {B} does not divide into dp={layout.dp} replicas of "
            f"{n_microbatches} microbatches each")
    if layout.dp == 1:
        return batch
    rows = B // layout.dp
    lo = layout.dp_rank * rows
    return {k: v[lo:lo + rows] for k, v in batch.items()}


def mean_over_dp(metrics, layout):
    """The scalar ``metrics`` averaged over the ``dp`` group, as one
    allreduce; at dp 1, as given."""
    if layout.dp == 1:
        return metrics
    names = sorted(metrics)
    values = torch.stack([metrics[k].detach().float() for k in names])
    values = col.allreduce(values, layout.dp_group).to(values.device)
    values = values / layout.dp
    return {k: values[i] for i, k in enumerate(names)}


def sync_over_dp(grads, metrics, layout):
    """(grads, metrics) averaged over the ``dp`` group: every leaf by
    ``ddp.sync_gradients``, the rank's experts among them (its dp group
    holds the same ones), the metrics as one allreduce
    (``mean_over_dp``). At dp 1, as given. Runs on the rank's thread,
    outside autograd."""
    if layout.dp == 1:
        return grads, metrics
    grads = ddp.sync_gradients(grads, layout.dp_group, average=True,
                               mode="allreduce")
    return grads, mean_over_dp(metrics, layout)


def pipelined_grads(params, batch, cfg, layout, n_microbatches: int = 4):
    """(metrics, grads) of GPT-2's pipelined loss on the global ``batch``
    at one rank of ``layout``: ``layout_grads`` on the replica's rows
    (``dp_rows``), the path ``make_pipelined_train_step`` takes."""
    return layout_grads(
        lambda p, b: gpt2.loss_fn(p, b, cfg, layout, pipelined=True,
                                  n_microbatches=n_microbatches),
        params, dp_rows(batch, layout, n_microbatches), layout)


def layout_grads(loss_fn, params, rows, layout):
    """(metrics, grads) of ``loss_fn(params, rows)`` on one rank of
    ``layout``, averaged over dp (``sync_over_dp``): the gradient the
    loss function hands over (``pipeline.scheduled_gradients``), or, from
    a loss function that hands none over, autograd's on the replica's
    rows at dp alone (see the module's docstring). A handed-over gradient
    is that of the loss the schedule computed, so the loss function must
    return that loss unchanged (``gpt2.loss_fn``'s total, the same
    object): a closure that adds a term to it or scales it is refused,
    as its gradient would not be the closure's."""
    with pipeline.scheduled_gradients() as handed:
        loss, metrics = loss_fn(params, rows)
    metrics = {k: v.detach() for k, v in metrics.items()}
    if handed.grads is not None:
        mine, theirs = tree_leaves(params), tree_leaves(handed.params)
        if len(mine) != len(theirs) or any(a is not b for a, b
                                           in zip(mine, theirs)):
            raise ValueError("the loss function differentiated other "
                             "parameters than the state's: pass the step's "
                             "params through to gpt2.loss_fn")
        if loss is not handed.total:
            raise ValueError(
                "the loss function changed the loss whose gradient "
                "gpt2.loss_fn handed over: on a layout, return "
                "gpt2.loss_fn's total unchanged (the gradient is its "
                "schedule's, not autograd's through the closure)")
        grads = handed.grads
    elif all(getattr(layout, a) == 1 for a in ("pp", "ep", "sp", "tp")):
        grads = tree_unflatten(params, torch.autograd.grad(
            loss, tree_leaves(params)))
    else:
        raise ValueError(
            "on a layout with pp, ep, sp or tp above 1 the gradient is a "
            "schedule that the loss function computes and hands over "
            "(gpt2.loss_fn(p, b, cfg, layout)); this loss function handed "
            "none over, and autograd through its collectives would run "
            "them inside autograd's backward")
    grads, metrics = sync_over_dp(grads, metrics, layout)
    return metrics, grads


def _layout_step(loss_fn, optimizer: ClipAdamW, layout, rows, specs=None):
    """The mesh regime's step on one rank of ``layout``: ``rows(batch)``
    cuts its replica's rows; ``specs`` (else the state's
    ``param_specs``) name the leaves cut over tp and ep for the norm."""

    def step(state: TrainState, batch):
        metrics, grads = layout_grads(loss_fn, state.params, rows(batch),
                                      layout)
        metrics["grad_norm"] = pipelined_global_norm(
            grads, layout, specs if specs is not None else state.param_specs)
        opt_state = optimizer.update(grads, state.opt_state, state.params,
                                     metrics["grad_norm"])
        return (dataclasses.replace(state, step=state.step + 1,
                                    opt_state=opt_state), metrics)

    return step


def make_pipelined_train_step(cfg, optimizer: ClipAdamW, layout,
                              n_microbatches: int = 4):
    """GPT-2's pipelined train step on one rank of ``layout`` (a
    ``parallel.mesh.RankLayout``), whose state holds this rank's stage
    tree (``convert.stage_params``), at tp > 1 or ep > 1 its blocks of it
    (``sharding.tree_shard`` with ``gpt2.partition_specs``): the mesh
    regime's step over ``gpt2.loss_fn(..., pipelined=True,
    n_microbatches)``, the norm by ``gpt2.partition_specs(cfg)``. Returns
    step(state, batch) -> (state, metrics) with ``make_train_step``'s
    metrics, the same on every rank; ``grad_norm`` is the whole model's,
    which the update clips by. Every rank is given the whole batch and
    takes its replica's rows (``dp_rows``); the ranks of a tp or an ep
    group take the same rows. With MoE (pp 1) ``n_microbatches`` is 1:
    the router counts over the whole batch."""
    return _layout_step(
        lambda p, b: gpt2.loss_fn(p, b, cfg, layout, pipelined=True,
                                  n_microbatches=n_microbatches),
        optimizer, layout,
        lambda batch: dp_rows(batch, layout, n_microbatches),
        gpt2.partition_specs(cfg))


def eval_step(loss_fn: Callable[[Any, Any], tuple], mesh=None,
              batch_spec: tuple = DEFAULT_BATCH_SPEC):
    """step(params, batch) -> metrics, without gradients. On a rank
    layout (``mesh``) of several ranks, ``loss_fn`` sees the rank's rows
    of the global batch (``batch_rows``) and its metrics are averaged
    over dp, the same on every rank."""
    layout, _ = rank_layout(mesh)

    @torch.no_grad()
    def step(params, batch):
        if layout is None:
            _, metrics = loss_fn(params, batch)
            return metrics
        _, metrics = loss_fn(params, batch_rows(batch, layout, batch_spec))
        return mean_over_dp(metrics, layout)

    return step
