"""Mixture-of-Experts FFN (Switch-style top-1) for training and ``generate``.

Counterpart of ``elastic_gpu_scheduler_tpu/models/moe.py``: routing as
dense one-hot dispatch / combine products with a capacity per expert, so
every shape is static, tokens past an expert's capacity are dropped (their
FFN output is zero), and the Switch load-balancing auxiliary loss comes
back beside the output.  Plain PyTorch with autograd: the dispatch and
combine einsums are large dense matrix products, which the reference too
leaves to its compiler.

On a mesh the experts are split over ``expert`` (each rank keeps E/ep of
them, their F columns over ``tensor``), and the routing is the
single-device routing over the whole batch, as the reference's GSPMD
routing sees the logical global batch: the capacity comes from the global
token count, each token's queue position is counted in global (b, s)
order (an exclusive prefix of the per-expert counts of every rank that
cuts the batch over ``route_axes``), and the aux's means are over the
global tokens.  Each rank fills only its own tokens' slots of its own
experts; a slot holds at most one token and the expert FFN works row by
row, so no all-to-all is needed, and the outputs are summed over
``expert`` and ``tensor``.  The router probability and the tokens feed
only the local experts' slots: they enter the dispatch and combine through
``copy_to``, whose backward sums their gradients over ``expert`` (and
``tensor``, whose column slices each give a partial one).

The serving engine routes drop-free instead (``serving._moe_ffn_serve``,
kernel KE on CUDA).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.collectives import (
    all_gather,
    all_reduce,
    copy_to,
    group_size,
    reduce_from,
    sum_shares,
)
from ..parallel.sharding import BATCH_AXES
from .quantize import wmat


def _queue_offsets(onehot: torch.Tensor, mesh, route_axes) -> torch.Tensor:
    """(B, S, E) this rank's one-hot routing → (B, E): for each of its rows,
    the tokens routed to each expert ahead of the row's first local token
    in global (b, s) order: every token of the earlier global rows, and
    the row's tokens on the earlier seq shards."""
    B, _, E = onehot.shape
    rows = onehot.sum(dim=1)  # (B, E)
    seq_axes = tuple(a for a in route_axes if a == "seq")
    batch_axes = tuple(a for a in route_axes if a != "seq")
    n_b, n_s = group_size(mesh, batch_axes), group_size(mesh, seq_axes)
    # every rank's rows, in the route axes' order (the batch axes major)
    every = all_gather(rows[None], mesh, route_axes, 0).reshape(n_b, n_s, B, E)
    whole = every.sum(dim=1).reshape(n_b * B, E)  # each global row's count
    before_row = torch.cumsum(whole, dim=0) - whole
    i_b = mesh.axes_index(batch_axes) if batch_axes else 0
    i_s = mesh.axes_index(seq_axes) if seq_axes else 0
    return before_row[i_b * B:(i_b + 1) * B] + every[i_b, :i_s].sum(dim=0)


def moe_ffn(
    x: torch.Tensor,
    gate_w,
    w_in,
    w_gate,
    w_out,
    capacity_factor: float = 1.25,
    dtype: torch.dtype = torch.bfloat16,
    mesh=None,
    route_axes=BATCH_AXES,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Switch-style MoE feed-forward.

    x: (B, S, D) tokens; gate_w: (D, E) router; w_in / w_gate: (E, D, F);
    w_out: (E, F, D), the expert-stacked SwiGLU FFN.  Returns (output
    (B, S, D), aux scalar): aux is the load-balancing loss
    sum(fraction routed · mean probability) · E.  Capacity is
    ``max(1, int(capacity_factor * tokens / E))``; a token's queue position
    is the running count of earlier tokens routed to its expert.

    On a mesh: x is this rank's tokens, the expert leaves its E/ep experts
    (F/T columns of ``w_in`` / ``w_gate``, rows of ``w_out``), ``tokens``
    the count over ``route_axes``.  The output is this rank's tokens', and
    aux the whole batch's on every rank, its gradient that of a loss to
    which each rank adds its share (``collectives.sum_shares``)."""
    B, S, D = x.shape
    E = gate_w.shape[-1]
    n_route = group_size(mesh, route_axes)
    tokens = B * S * n_route
    capacity = max(1, int(capacity_factor * tokens / E))

    xf = x.reshape(B * S, D)
    logits = (xf @ wmat(gate_w, x.dtype)).float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    expert_idx = torch.argmax(probs, dim=-1)  # (T,) first max
    expert_prob = probs.gather(-1, expert_idx[:, None])[:, 0]  # (T,)

    onehot = F.one_hot(expert_idx, E).to(torch.int32)  # (T, E)
    if n_route == 1:
        position = torch.cumsum(onehot, dim=0) * onehot  # 1-based where assigned
    else:
        oh = onehot.reshape(B, S, E)
        ahead = _queue_offsets(oh, mesh, route_axes)
        position = ((torch.cumsum(oh, dim=1) + ahead[:, None, :]) * oh).reshape(B * S, E)
    pos_in_expert = position.sum(dim=-1) - 1  # (T,)
    kept = (pos_in_expert >= 0) & (pos_in_expert < capacity)

    # dispatch / combine (T, E_local, C) over this rank's experts
    n_local = w_in.shape[-3]
    e0 = mesh.axis_index("expert") * n_local if group_size(mesh, "expert") > 1 else 0
    dispatch = (
        F.one_hot(expert_idx, E)[:, e0:e0 + n_local].to(x.dtype)[:, :, None]
        * F.one_hot(torch.clamp(pos_in_expert, 0, capacity - 1).long(), capacity)
        .to(x.dtype)[:, None, :]
        * kept[:, None, None].to(x.dtype)
    )
    shards = ("expert", "tensor")
    combine = dispatch * copy_to(expert_prob, mesh, shards)[:, None, None].to(x.dtype)

    # each (e, c) slot holds at most one token, so these sums are exact in
    # any dtype: the reference's fp32 accumulation changes nothing
    expert_in = torch.einsum("tec,td->ecd", dispatch, copy_to(xf, mesh, shards)).to(dtype)
    gate = F.silu(torch.einsum("ecd,edf->ecf", expert_in, wmat(w_gate, dtype)))
    up = torch.einsum("ecd,edf->ecf", expert_in, wmat(w_in, dtype))
    expert_out = torch.einsum("ecf,efd->ecd", gate * up, wmat(w_out, dtype))
    out = torch.einsum("tec,ecd->td", combine, expert_out.to(x.dtype))
    out = reduce_from(out, mesh, shards)

    density = all_reduce(onehot.float().sum(dim=0), mesh, route_axes) / tokens  # routed
    density_proxy = sum_shares(probs.sum(dim=0), mesh, route_axes) / tokens
    aux = (density * density_proxy).sum() * E
    return out.reshape(B, S, D), aux
