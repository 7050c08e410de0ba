"""Pipeline parallelism over the ``pp`` axis: GPipe with an explicit
backward. Port of ``ray_tpu/parallel/pipeline.py``.

Each stage is a rank (a thread or a process) holding its stage's
parameters and its ``pp`` group (``parallel/mesh.py``). Activations hop
from stage s to stage s + 1 by ``send``/``recv`` over that group, in
place of the JAX package's ``ppermute``, and the last stage's outputs are
broadcast to every stage in place of its ``psum``. Schedule: GPipe with M
microbatches over P stages, T = M + P - 1 ticks, stage s working on
microbatch t - s at tick t; bubble fraction (P - 1) / T.

The backward is a schedule too, never autograd through a collective. A
forward tick keeps its microbatch's stage input, as a leaf that requires
grad, its output and its ``StageTape``. The backward ticks run in
reverse: a stage receives its output's gradient from stage s + 1 outside
autograd, runs autograd over that microbatch's stage (``StageTape``) and
sends its input's gradient to stage s - 1. So no ``send``, ``recv`` or
ring hop ever runs inside an autograd backward. On a CUDA device that
matters: autograd runs the backward of every graph on one worker thread
per device, shared by all the ranks of a process, and a rank that blocked
there waiting for a peer would hold the thread the peer's backward needs.

The JAX package carries f32 between stages off the TPU (a workaround for
XLA:CPU); the port carries the compute dtype, which bf16 values survive
exactly there.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, List, Optional

import torch

from ray_tpu_torch._private.tree import tree_leaves, tree_map, tree_unflatten
from ray_tpu_torch.util import collective as col


class StageTape:
    """The autograd segments of one stage's forward on one microbatch.

    A stage whose forward communicates (ring attention) cannot be
    differentiated by one autograd call: the communication has to run
    between autograd calls, on the rank's own thread. The forward cuts
    the graph there: ``boundary`` runs a function outside autograd and
    returns its outputs as fresh leaves; ``cut`` is the boundary of the
    identity, used to keep each segment's graph apart. ``backward`` runs
    the segments in reverse, from the stage output to its input, each by
    one ``torch.autograd.grad`` call, and between two segments the
    boundary's own backward (which may communicate) maps the gradients of
    its output leaves to those of its inputs. ``add_term`` adds a scalar
    to what the stage differentiates (an MoE layer's aux loss, which
    leaves the stage beside its output).

    ``checkpoint`` is remat on the tape, the twin of ``jax.checkpoint``: a
    region (a layer) runs without autograd, its boundaries' outputs and
    what they save and the results of its forward-only computations
    (``once``) recorded; the tape keeps only that record and the region's
    inputs and outputs. When ``backward`` reaches the region it reruns the
    region's forward with autograd on a tape that replays the record, so
    that no boundary's forward and no ``once`` runs again (a collective
    among them would run a second time, in an order the peers do not
    share), then differentiates the region's segments as above. The
    recompute runs on the rank's thread in the tape's schedule, never
    inside autograd's backward.

    Under ``torch.no_grad`` nothing is recorded."""

    def __init__(self):
        # each: (inputs attached to the graph, output leaves, backward)
        self._cuts: List[tuple] = []
        self._terms: List[torch.Tensor] = []
        # a checkpointed region's forward appends to _record; its
        # recompute reads the same entries back from _replay
        self._record: Optional[list] = None
        self._replay = None

    def _replayed(self, kind: str):
        entry = next(self._replay, None)
        if entry is None or entry[0] != kind:
            raise RuntimeError("a checkpointed region's recompute diverged "
                               "from its forward: the region must take the "
                               "same boundaries and once calls in the same "
                               "order")
        return entry[1:]

    def boundary(self, inputs, forward: Callable, backward: Callable):
        """``forward(*inputs detached) -> (outputs, saved)``, run outside
        autograd; returns the outputs as leaves that require grad.
        ``backward(saved, output grads) -> input grads`` runs when the
        tape's backward reaches this point (a grad of None is zero)."""
        if self._replay is not None:
            outputs, saved = self._replayed("boundary")
        else:
            with torch.no_grad():
                outputs, saved = forward(*[x.detach() for x in inputs])
            if self._record is not None:
                self._record.append(("boundary", outputs, saved))
                return outputs
        if not torch.is_grad_enabled():
            return outputs
        leaves = tuple(o.detach().requires_grad_(True) for o in outputs)
        self._cuts.append((tuple(inputs), leaves,
                           lambda grads: backward(saved, grads)))
        return leaves

    def cut(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as a leaf: the segments before and after it are
        differentiated apart. A leaf already is one (but in a checkpointed
        region, whose record and recompute must meet the same cuts)."""
        if (self._record is None and self._replay is None
                and not (torch.is_grad_enabled() and x.requires_grad
                         and x.grad_fn is not None)):
            return x
        (leaf,) = self.boundary((x,), lambda t: ((t,), None),
                                lambda _, grads: grads)
        return leaf

    def once(self, fn: Callable, *args):
        """``fn(*args)``, a computation outside autograd (a forward-only
        collective, such as the MoE router's slot counts), run once: in a
        checkpointed region its result is recorded, and the recompute
        takes it from the record instead of calling ``fn`` again."""
        if self._replay is not None:
            return self._replayed("once")[0]
        out = fn(*args)
        if self._record is not None:
            self._record.append(("once", out))
        return out

    def checkpoint(self, fn: Callable, inputs, params):
        """``fn(tape, *inputs) -> tuple of tensors``, a region of the
        stage whose autograd state is not kept: its outputs come back as
        leaves, and ``backward`` recomputes the region just before it
        differentiates it (see the class). ``params`` are the leaves
        ``fn`` reads besides ``inputs`` (a layer's weights), whose
        gradients the region's backward returns. Without gradients
        ``fn`` runs on this tape as it is."""
        if self._record is not None or self._replay is not None:
            raise RuntimeError("checkpointed regions do not nest")
        if not torch.is_grad_enabled():
            return tuple(fn(self, *inputs))
        n = len(inputs)
        params = tuple(params)

        def forward(*args):
            tape = StageTape()
            tape._record = []
            return tuple(fn(tape, *args[:n])), tape._record

        def backward(record, grads):
            tape = StageTape()
            tape._replay = iter(record)
            xs = [x.detach().requires_grad_(x.requires_grad)
                  for x in inputs]
            with torch.enable_grad():
                outputs = tuple(fn(tape, *xs))
            if next(tape._replay, None) is not None:
                raise RuntimeError("a checkpointed region's recompute "
                                   "stopped short of its forward's record")
            tape._replay = None
            dxs, dparams = tape.backward(outputs, grads, xs, params)
            return (*dxs, *dparams)

        return self.boundary((*inputs, *params), forward, backward)

    def add_term(self, term: torch.Tensor) -> None:
        """``backward`` differentiates ``term``, a scalar of this stage's
        graph, with a cotangent of 1 beside the output, as if it were added
        to the stage's objective. Nothing is recorded under no_grad; a
        checkpointed region returns its terms as outputs instead."""
        if self._record is not None or self._replay is not None:
            raise RuntimeError("a checkpointed region returns its terms "
                               "among its outputs")
        if torch.is_grad_enabled() and term.requires_grad:
            self._terms.append(term)

    def backward(self, output, grad_output, inputs, params):
        """Gradients of ``output`` (given ``grad_output``; or of a tuple of
        outputs, given a tuple of grads, None for zero), plus those of the
        terms (``add_term``), with respect to ``inputs`` and ``params``
        (lists of tensors): (input grads, param grads), None where no path
        reaches."""
        if isinstance(output, torch.Tensor):
            output, grad_output = (output,), (grad_output,)
        slots = list(inputs) + [leaf for _, leaves, _ in self._cuts
                                for leaf in leaves]
        n_in = len(inputs)
        grads = [None] * len(slots)
        param_grads = [None] * len(params)
        first_leaf = [n_in]
        for _, leaves, _ in self._cuts:
            first_leaf.append(first_leaf[-1] + len(leaves))

        trainable = [i for i, p in enumerate(params) if p.requires_grad]

        def segment(outs, gouts, n_slots):
            pairs = [(o, g) for o, g in zip(outs, gouts)
                     if g is not None and o.requires_grad]
            if not pairs:
                return
            targets = slots[:n_slots] + [params[i] for i in trainable]
            got = torch.autograd.grad([o for o, _ in pairs], targets,
                                      [g for _, g in pairs],
                                      allow_unused=True)
            for i, g in enumerate(got[:n_slots]):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
            for i, g in zip(trainable, got[n_slots:]):
                if g is not None:
                    param_grads[i] = (g if param_grads[i] is None
                                      else param_grads[i] + g)

        segment((*output, *self._terms),
                (*grad_output, *[torch.ones_like(t) for t in self._terms]),
                len(slots))
        for c in reversed(range(len(self._cuts))):
            cut_inputs, leaves, cut_backward = self._cuts[c]
            lo = first_leaf[c]
            leaf_grads = grads[lo:lo + len(leaves)]
            grads[lo:lo + len(leaves)] = [None] * len(leaves)
            if all(g is None for g in leaf_grads):
                continue
            segment(cut_inputs, cut_backward(leaf_grads), lo)
        self._cuts.clear()
        self._terms.clear()
        return grads[:n_in], param_grads


class ScheduledGradients:
    """What a loss function whose gradient is a schedule hands the train
    step that asked for it (``scheduled_gradients``): the parameters it
    was given, their gradients (a tree like them) and the loss they are
    the gradients of, the object the loss function returned."""

    def __init__(self):
        self.params = None
        self.grads = None
        self.total = None


_SCHEDULE = threading.local()


@contextlib.contextmanager
def scheduled_gradients():
    """Asks, on this thread, for the gradient of the loss computed inside:
    a loss function that differentiates by a schedule (``gpt2.loss_fn``
    on a rank layout) computes its gradient with its value and hands both
    over (``hand_over_gradients``) to the yielded ``ScheduledGradients``.
    A loss function that hands nothing over leaves it empty."""
    box, saved = ScheduledGradients(), getattr(_SCHEDULE, "box", None)
    _SCHEDULE.box = box
    try:
        yield box
    finally:
        _SCHEDULE.box = saved


def gradients_requested() -> bool:
    """Whether a ``scheduled_gradients`` is open on this thread."""
    return getattr(_SCHEDULE, "box", None) is not None


def hand_over_gradients(params, grads, total) -> None:
    """Hands ``params``' ``grads``, the gradients of the loss ``total``, to
    the open ``scheduled_gradients``, once."""
    box = _SCHEDULE.box
    if box.grads is not None:
        raise RuntimeError("a loss function handed its gradients over "
                           "twice in one step")
    box.params, box.grads, box.total = params, grads, total


class GPipeRun:
    """One stage's forward over every microbatch. ``outputs`` is the last
    stage's outputs, ``[M, ...]``, on every stage when the run replicates
    them, else on the last stage only (None elsewhere). ``backward`` runs
    the backward schedule once."""

    def __init__(self, stage_params, group: str, saved, outputs):
        self._params = stage_params
        self._group = group
        self._saved = saved  # per microbatch: (input leaf, output, tape)
        self.outputs = outputs

    def backward(self, grad_outputs: Optional[torch.Tensor]):
        """``grad_outputs`` ``[M, ...]``: the gradient of the outputs,
        read on the last stage only (other stages may pass None).
        Returns (the gradient of the microbatches on stage 0, else None;
        the gradients of this stage's parameters, a tree like them,
        summed over the microbatches)."""
        if not self._saved or self._saved[-1] is None:
            raise RuntimeError("nothing to differentiate: the forward ran "
                               "under no_grad, or its backward has run")
        stage = col.get_rank(self._group)
        n_stages = col.get_collective_group_size(self._group)
        M = len(self._saved)
        params = tree_leaves(self._params)
        totals = [None] * len(params)
        grad_mb = [None] * M
        T = M + n_stages - 1
        for t in reversed(range(T)):
            m = t - stage
            if not 0 <= m < M:
                continue
            x, y, tape = self._saved[m]
            if stage == n_stages - 1:
                dy = grad_outputs[m]
            else:
                dy = col.recv(stage + 1, self._group).to(y.device)
            (dx,), dparams = tape.backward(y, dy, [x], params)
            self._saved[m] = None
            if dx is None:
                dx = torch.zeros_like(x)
            if stage > 0:
                col.send(dx, stage - 1, self._group)
            else:
                grad_mb[m] = dx
            for i, g in enumerate(dparams):
                if g is not None:
                    totals[i] = g if totals[i] is None else totals[i] + g
        totals = [torch.zeros_like(p) if g is None else g
                  for g, p in zip(totals, params)]
        grads = tree_unflatten(self._params, totals)
        return (torch.stack(grad_mb) if stage == 0 else None), grads


def gpipe_local(stage_fn: Callable, stage_params: Any,
                microbatches: Optional[torch.Tensor], *, group: str,
                n_microbatches: Optional[int] = None,
                replicate: bool = True) -> GPipeRun:
    """One stage's GPipe forward. ``group`` is the rank's ``pp`` group,
    whose rank is the stage.

    ``stage_fn(params, x, tape) -> y`` applies this stage; y has x's
    shape and dtype (the transformer-block invariant), and a stage that
    communicates records its boundaries on ``tape`` (``StageTape``).
    ``stage_params``: this stage's parameter tree. ``microbatches``:
    ``[M, B_mb, ...]``, read on stage 0; the other stages may pass None
    with ``n_microbatches`` set, unless ``replicate``, which broadcasts
    the last stage's outputs to every stage and needs their shape.

    Under ``torch.no_grad`` the run keeps nothing for a backward."""
    stage = col.get_rank(group)
    n_stages = col.get_collective_group_size(group)
    M = microbatches.shape[0] if microbatches is not None else n_microbatches
    if M is None:
        raise ValueError("pass microbatches, or n_microbatches on a stage "
                         "that does not read them")
    if stage == 0 and microbatches is None:
        raise ValueError("stage 0 reads the microbatches; got None")
    grad = torch.is_grad_enabled()
    device = (microbatches.device if microbatches is not None
              else next(iter(tree_leaves(stage_params))).device)
    saved = [None] * M
    outs = [None] * M
    T = M + n_stages - 1
    for t in range(T):
        m = t - stage
        if not 0 <= m < M:
            continue
        if stage == 0:
            x = microbatches[m].detach()
        else:
            x = col.recv(stage - 1, group).to(device)
        x = x.requires_grad_(grad)
        tape = StageTape()
        y = stage_fn(stage_params, x, tape)
        if grad:
            saved[m] = (x, y, tape)
        if stage < n_stages - 1:
            col.send(y.detach(), stage + 1, group)
        else:
            outs[m] = y.detach()
    outputs = torch.stack(outs) if stage == n_stages - 1 else None
    if replicate:
        if outputs is None:
            outputs = torch.empty_like(microbatches)
        outputs = col.broadcast(outputs, n_stages - 1, group).to(device)
    return GPipeRun(stage_params, group, saved if grad else [], outputs)


def gpipe(stage_fn: Callable, stacked_params: Any,
          microbatches: torch.Tensor, layout, **kw) -> GPipeRun:
    """Global entry: ``stacked_params`` have a leading ``[n_stages]`` dim;
    this rank runs stage ``layout.pp_rank`` on its slice over its ``pp``
    group. Returns ``gpipe_local``'s run, whose outputs are replicated over
    the stages."""
    stage_params = tree_map(lambda p: p[layout.pp_rank], stacked_params)
    return gpipe_local(stage_fn, stage_params, microbatches,
                       group=layout.pp_group, **kw)


def microbatch(x: torch.Tensor, n_microbatches: int) -> torch.Tensor:
    """[B, ...] -> [M, B/M, ...]."""
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(f"batch {B} not divisible by {n_microbatches} "
                         f"microbatches")
    return x.reshape((n_microbatches, B // n_microbatches) + x.shape[1:])


def unmicrobatch(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])


def stack_stage_params(per_stage_params: list) -> Any:
    """List of per-stage trees -> one tree with a leading stage dim."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([t[k] for t in per_stage_params])
                for k in sorted(first)}
    return torch.stack(per_stage_params)
