"""Pipeline parallelism (GPipe) over the ``pipe`` mesh axis.

Counterpart of ``elastic_gpu_scheduler_tpu/parallel/pipeline.py``.  The
layers are stacked on a leading L; sharding L over ``pipe``
(``sharding.param_specs(pipeline=True)``) gives each stage its contiguous
block of L/PP layers.  Microbatches march through the stages in the
reference's schedule: T = M + PP - 1 steps; at step t stage 0 takes in
microbatch t, every stage runs its layers on the microbatch it holds
(t - stage), the last stage keeps microbatch t - (PP - 1), and one hop
(``collectives.ring_shift``) moves every stage's state to stage + 1.  A
stage's aux counts only where it held a real microbatch, and the total
is the reference's ``psum(aux) / (M · seq_n)``.

The schedule is one ``autograd.Function`` with its own backward: the
reverse schedule, T steps from the last, each stage receiving the
cotangent of its output from stage + 1 (one hop the other way), running
its layers' backward for the microbatch it held and keeping its
parameters' gradients.  Every stage makes the same T - 1 hops in each
direction, in the same order, whatever it computes: the hops are
exchanges every rank of the axis joins, and autograd's own order of a
graph that differs from stage to stage would not pair them.  A stage
skips its layers at a step that holds no real microbatch; the reference
computes them and throws them away, which changes no result.

The collectives inside a stage's layers (``tensor``, ``fsdp``, ``seq``,
``expert``) run in groups whose ranks are all on that stage, and each
stage runs its microbatches in the same order on all of them.  With the
ring on (``seq_axis``, the reference's sp × pp) the layers call
``ring_attention`` over ``seq`` inside the stage, and the aux is the mean
of the seq shards'.

The reference's microbatch m is the global batch's rows [m·B/M,
(m+1)·B/M), and a MoE layer routes each microbatch on its own (capacity
from its token count, queue order over its rows).  Where the batch is cut
over ``data`` and ``fsdp``, a MoE model's ranks therefore pipeline their
share of every global microbatch (``microbatch_shares``), not their own
contiguous rows, and route each microbatch over (``data``, ``fsdp``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .collectives import all_gather, copy_to, group_size, reduce_from, ring_shift, sum_shares

# the axes a batch is cut over by rows (``sharding.local_batch``)
ROW_AXES = ("data", "fsdp")


def microbatch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """(B, ...) → (M, B/M, ...)."""
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by {n_micro} microbatches")
    return x.reshape((n_micro, B // n_micro) + tuple(x.shape[1:]))


def unmicrobatch(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[2:]))


def share_rows(batch: int, n_micro: int, n: int, i: int) -> list[int]:
    """The global rows rank ``i`` of ``n`` row ranks holds so that its
    microbatch m is its share of the global microbatch m: rows
    m·B/M + i·B/(M·n) up to m·B/M + (i+1)·B/(M·n), for each m in order."""
    if batch % n_micro:
        raise ValueError(f"batch {batch} not divisible by {n_micro} microbatches")
    mb = batch // n_micro
    if mb % n:
        raise ValueError(f"global microbatch of {mb} rows (batch {batch} over {n_micro} "
                         f"microbatches) not divisible by data*fsdp={n}")
    share = mb // n
    return [m * mb + i * share + j for m in range(n_micro) for j in range(share)]


def microbatch_shares(rows: torch.Tensor, n_micro: int, mesh) -> torch.Tensor:
    """A rank's contiguous rows of the global batch (``local_batch``) →
    its share of every global microbatch (``share_rows``), by one
    all-gather of the rows over (``data``, ``fsdp``); the rows themselves
    where those axes span one rank."""
    n = group_size(mesh, ROW_AXES)
    if n == 1:
        return rows
    whole = all_gather(rows, mesh, ROW_AXES, 0)
    pick = share_rows(whole.shape[0], n_micro, n, mesh.axes_index(ROW_AXES))
    return whole[torch.tensor(pick, device=whole.device)]


def _flatten(tree: dict, path=()) -> list:
    """[(path, leaf)] of a nested dict, in its key order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend(_flatten(v, path + (k,)))
        else:
            out.append((path + (k,), v))
    return out


def _unflatten(paths: list, leaves) -> dict:
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


class _Pipeline(torch.autograd.Function):
    """x (M, mb, ...) and a stage's layer leaves → (outputs (M, mb, ...),
    zero off the last stage; this stage's aux over its real microbatches)."""

    @staticmethod
    def forward(ctx, stage_fn, paths, mesh, x, *leaves):
        pp, stage = mesh.shape["pipe"], mesh.axis_index("pipe")
        M = x.shape[0]
        T = M + pp - 1
        want = any(ctx.needs_input_grad[3:])
        params = [p.detach().requires_grad_(need)
                  for p, need in zip(leaves, ctx.needs_input_grad[4:])]
        layers = _unflatten(paths, params)
        outputs = torch.zeros_like(x)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        graphs = []  # (h, y, aux) of each microbatch this stage held, in order
        state = torch.zeros_like(x[0])
        for t in range(T):
            if stage == 0 and t < M:
                state = x[t]
            m = t - stage
            if 0 <= m < M:
                h = state.detach().requires_grad_(want)
                with torch.set_grad_enabled(want):
                    y, a = stage_fn(h, layers)
                if want:
                    graphs.append((h, y, a))
                if a is not None:
                    aux_total += a.detach()
                state = y.detach()
                if stage == pp - 1:
                    outputs[m] = state
            if t < T - 1:
                state = ring_shift(state, mesh, "pipe")
        ctx.mesh, ctx.graphs, ctx.params = mesh, graphs, params
        ctx.mb_shape = x.shape[1:]
        return outputs, aux_total

    @staticmethod
    def backward(ctx, g_out, g_aux):
        mesh, graphs, params = ctx.mesh, ctx.graphs, ctx.params
        pp, stage = mesh.shape["pipe"], mesh.axis_index("pipe")
        M = g_out.shape[0]
        T = M + pp - 1
        wanted = [p for p in params if p.requires_grad]
        grads = [None] * len(wanted)
        dx = torch.zeros_like(g_out) if ctx.needs_input_grad[3] else None
        d_state = torch.zeros(ctx.mb_shape, dtype=g_out.dtype, device=g_out.device)
        for t in reversed(range(T)):
            if t < T - 1:  # the cotangent of this step's output, from stage + 1
                d_state = ring_shift(d_state, mesh, "pipe", step=-1)
            m = t - stage
            if not 0 <= m < M:
                d_state = torch.zeros_like(d_state)
                continue
            h, y, a = graphs.pop()
            d_y = g_out[m] if stage == pp - 1 else d_state
            outs, cots = [y], [d_y]
            if a is not None and g_aux is not None:
                outs.append(a)
                cots.append(g_aux)
            got = torch.autograd.grad(outs, [h] + wanted, cots, allow_unused=True)
            d_state = got[0] if got[0] is not None else torch.zeros_like(d_state)
            if dx is not None and stage == 0:
                dx[m] = d_state
            for i, g in enumerate(got[1:]):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
        it = iter(grads)
        out = [next(it) if p.requires_grad else None for p in params]
        return (None, None, None, dx, *out)


def pipeline_apply(stage_fn: Callable, stage_layers: dict, x: torch.Tensor, mesh,
                   seq_axis: Optional[str] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Every layer over every microbatch, on a mesh with a ``pipe`` axis.
    ``stage_fn(h, layers) → (h, aux or None)`` runs a stage's layers in
    order; ``stage_layers``: this stage's leaves, stacked on a leading
    L/PP; ``x`` (M, mb, ...) the microbatched activations, alike on every
    pipe rank.  Returns (y (M, mb, ...) on every pipe rank, aux scalar).

    The input enters through ``copy_to(pipe)``, so stage 0's gradient of it
    reaches every pipe rank's embedding; the last stage's outputs reach
    every stage through ``reduce_from(pipe)`` (forward sum of the outputs,
    zero off the last stage; backward identity).  ``seq_axis`` names the
    sequence axis when the ring runs inside the stages: the aux is then
    each seq shard's, and its mean is taken over them."""
    M = x.shape[0]
    x = copy_to(x, mesh, "pipe")
    flat = _flatten(stage_layers)
    outputs, aux = _Pipeline.apply(stage_fn, [p for p, _ in flat], mesh, x,
                                   *[v for _, v in flat])
    outputs = reduce_from(outputs, mesh, "pipe")
    seq_n = 1
    if seq_axis is not None:
        seq_n = group_size(mesh, seq_axis)
        aux = sum_shares(aux, mesh, seq_axis)
    return outputs, reduce_from(aux, mesh, "pipe") / (M * seq_n)
