"""The collectives of a mesh, explicit, over the process group of one mesh
axis (or of a tuple of axes).

The reference lets XLA insert its collectives (``psum``, ``all_gather``,
``psum_scatter``, ``ppermute``); the port calls them here.  Each function
takes the mesh and the axes; axes that span one rank make it a no-op that
returns its input, so a one-rank mesh runs exactly the single-device
arithmetic.

A group's ranks are ordered along its axes (``Mesh.group_ranks``), and a
dimension sharded over the axes is cut in that order; torch numbers a
group's members by ascending global rank, so gathers and scatters map one
order onto the other.

Under gloo, CUDA tensors are staged through the host for each collective
(gloo takes CPU tensors; its send/recv takes no CUDA tensor).  That blocks
the host, and must not sit inside a CUDA graph; no training path captures
one.

The autograd functions are the parallel operators of the model:

- ``copy_to`` (Megatron's f): identity forward, all-reduce backward — the
  input of a column-parallel product;
- ``reduce_from`` (g): all-reduce forward, identity backward — the output
  of a row-parallel product;
- ``gather_from`` : all-gather forward along a dimension, reduce-scatter
  (the sum of each rank's gradient of the whole) backward — an
  ``fsdp``-sharded weight before use, or sequence-sharded keys;
- ``gather_replicated``: all-gather forward, own slice backward — logits
  every rank then uses alike;
- ``sum_shares``: all-reduce forward and backward — a sum of the ranks'
  shares that every rank then adds, as its share, to a loss summed over
  the same ranks (the MoE router's mean probability over the batch).

The pipeline's stage-to-stage hops (``parallel/pipeline.py``) are
``ring_shift`` forward and ``ring_shift(step=-1)`` in its own backward.

Serving builds no autograd graph: its layers call ``all_reduce`` and
``all_gather`` directly under ``torch.inference_mode()``, and the engine's
tickets travel by ``broadcast_object`` over the mesh's gloo object group.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def _group(mesh, axes):
    if mesh is None:
        return None
    return mesh.group(axes)


def _staged(t: torch.Tensor, mesh) -> bool:
    return t.is_cuda and mesh.backend == "gloo"


def _order(g) -> list[int]:
    """For each position along the axes, the member's index in torch's
    group numbering (ascending global rank)."""
    _pg, ranks = g
    sorted_ranks = sorted(ranks)
    return [sorted_ranks.index(r) for r in ranks]


def all_reduce(t: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """The sum (or ``op="max"``) of ``t`` over the ranks of ``axes``; a new
    tensor (``t`` itself when the axes span one rank)."""
    g = _group(mesh, axes)
    if g is None:
        return t
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if mesh.backend == "gloo":
        # on the host, bfloat16 summed in float32 and rounded once
        wide = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
        h = t.detach().to("cpu", wide, copy=True)
        dist.all_reduce(h, rop, group=g[0])
        return h.to(t.device, t.dtype)
    out = t.detach().clone().contiguous()
    dist.all_reduce(out, rop, group=g[0])
    return out


def all_gather(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in the axes' order."""
    g = _group(mesh, axes)
    if g is None:
        return t
    src = t.detach().contiguous()
    if _staged(t, mesh):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in g[1]]
    dist.all_gather(parts, src, group=g[0])
    out = torch.cat([parts[i] for i in _order(g)], dim=dim)
    return out.to(t.device)


def reduce_scatter(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The sum over the ranks of ``t``, cut along ``dim`` into the axes'
    shards; this rank's shard."""
    g = _group(mesh, axes)
    if g is None:
        return t
    n = len(g[1])
    pos = g[1].index(mesh.rank)
    if mesh.backend == "gloo":
        # gloo has no reduce-scatter: the whole sum, then this rank's shard
        return all_reduce(t, mesh, axes).chunk(n, dim=dim)[pos].contiguous()
    chunks = t.detach().chunk(n, dim=dim)
    order = _order(g)
    by_member = [None] * n
    for p, m in enumerate(order):
        by_member[m] = chunks[p]
    src = torch.cat([c.contiguous().reshape(-1) for c in by_member])
    out = torch.empty_like(chunks[pos]).contiguous()
    dist.reduce_scatter_tensor(out.reshape(-1), src, group=g[0])
    return out


def ring_shift(t: torch.Tensor, mesh, axis: str, step: int = 1) -> torch.Tensor:
    """Send ``t`` to the rank ``step`` further along ``axis`` (index + 1 by
    default, wrapping) and return what the rank ``step`` before sent: one
    hop of a ring (``step=-1`` runs it the other way)."""
    g = _group(mesh, axis)
    if g is None:
        return t
    ranks = g[1]
    i = ranks.index(mesh.rank)
    nxt, prv = ranks[(i + step) % len(ranks)], ranks[(i - step) % len(ranks)]
    src = t.detach().contiguous()
    if _staged(t, mesh):
        src = src.cpu()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, nxt, g[0]), dist.P2POp(dist.irecv, out, prv, g[0])]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(t.device)


def broadcast_object(obj, mesh, src: int = 0):
    """``obj`` as the mesh's rank at position ``src`` (in the mesh's rank
    order) holds it, on every rank of the mesh: a pickled host object over
    the mesh's gloo object group (``Mesh.object_group``), whatever the
    mesh's backend.  ``obj`` itself on a mesh of one rank."""
    pg = None if mesh is None else mesh.object_group()
    if pg is None:
        return obj
    root = int(mesh.ranks.flat[src])
    box = [obj if mesh.rank == root else None]
    dist.broadcast_object_list(box, src=root, group=pg)
    return box[0]


def all_gather_object(obj, mesh) -> list:
    """``obj`` of every rank of the mesh (pickled host objects over the
    mesh's gloo object group), in the group's rank order; ``[obj]`` on a
    mesh of one rank."""
    pg = None if mesh is None else mesh.object_group()
    if pg is None:
        return [obj]
    out = [None] * dist.get_world_size(pg)
    dist.all_gather_object(out, obj, group=pg)
    return out


def barrier(mesh) -> None:
    """Wait for every rank of ``mesh`` (a real collective whenever a
    process group exists, a one-rank world's included)."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    from .mesh import AXES

    g = mesh.group(AXES)
    pg = g[0] if g is not None else dist.group.WORLD
    if g is None and dist.get_world_size() > 1:
        return  # a one-rank mesh inside a larger world: nothing to wait for
    if mesh.backend == "nccl":
        dist.barrier(group=pg, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=pg)


# -- autograd operators --------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        n, pos = m.axes_size(ctx.axes), m.axes_index(ctx.axes)
        return g.chunk(n, dim=ctx.dim)[pos].contiguous(), None, None, None


class _SumShares(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


def _trivial(mesh, axes) -> bool:
    return mesh is None or mesh.axes_size(axes) == 1


def copy_to(x, mesh, axes):
    return x if _trivial(mesh, axes) else _CopyTo.apply(x, mesh, axes)


def reduce_from(x, mesh, axes):
    return x if _trivial(mesh, axes) else _ReduceFrom.apply(x, mesh, axes)


def gather_from(x, mesh, axes, dim: int):
    return x if _trivial(mesh, axes) else _GatherFrom.apply(x, mesh, axes, dim)


def gather_replicated(x, mesh, axes, dim: int):
    return x if _trivial(mesh, axes) else _GatherReplicated.apply(x, mesh, axes, dim)


def sum_shares(x, mesh, axes):
    return x if _trivial(mesh, axes) else _SumShares.apply(x, mesh, axes)


def all_reduce_flat(tensors: Sequence[torch.Tensor], mesh, axes) -> list[torch.Tensor]:
    """One all-reduce for a list of tensors of one dtype: packed flat, summed,
    cut back to their shapes."""
    if _trivial(mesh, axes) or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = all_reduce(flat, mesh, axes)
    out, o = [], 0
    for t in tensors:
        out.append(flat[o:o + t.numel()].view_as(t))
        o += t.numel()
    return out


def group_size(mesh, axes) -> int:
    return 1 if mesh is None else mesh.axes_size(axes)


def axes_of(spec_dim) -> tuple:
    """The axes one entry of a spec names: () for None, a 1-tuple for a name."""
    if spec_dim is None:
        return ()
    return tuple(spec_dim) if isinstance(spec_dim, (tuple, list)) else (spec_dim,)

