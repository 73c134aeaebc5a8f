"""Mixture-of-Experts FFN (Switch-style top-1) for training and ``generate``.

Counterpart of ``elastic_gpu_scheduler_tpu/models/moe.py``: routing as
dense one-hot dispatch / combine products with a capacity per expert, so
every shape is static, tokens past an expert's capacity are dropped (their
FFN output is zero), and the Switch load-balancing auxiliary loss comes
back beside the output.  Plain PyTorch with autograd: the dispatch and
combine einsums are large dense matrix products, which the reference too
leaves to its compiler.  The reference's expert-parallel mesh waits for
``parallel/``.

The serving engine routes drop-free instead (``serving._moe_ffn_serve``,
kernel KE on CUDA).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .quantize import wmat


def moe_ffn(
    x: torch.Tensor,
    gate_w,
    w_in,
    w_gate,
    w_out,
    capacity_factor: float = 1.25,
    dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Switch-style MoE feed-forward.

    x: (B, S, D) tokens; gate_w: (D, E) router; w_in / w_gate: (E, D, F);
    w_out: (E, F, D), the expert-stacked SwiGLU FFN.  Returns (output
    (B, S, D), aux scalar): aux is the load-balancing loss
    sum(fraction routed · mean probability) · E.  Capacity is
    ``max(1, int(capacity_factor * tokens / E))``; a token's queue position
    is the running count of earlier tokens routed to its expert."""
    B, S, D = x.shape
    E = gate_w.shape[-1]
    tokens = B * S
    capacity = max(1, int(capacity_factor * tokens / E))

    xf = x.reshape(tokens, D)
    logits = (xf @ wmat(gate_w, x.dtype)).float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    expert_idx = torch.argmax(probs, dim=-1)  # (T,) first max
    expert_prob = probs.gather(-1, expert_idx[:, None])[:, 0]  # (T,)

    onehot = F.one_hot(expert_idx, E).to(torch.int32)  # (T, E)
    position = torch.cumsum(onehot, dim=0) * onehot  # 1-based where assigned
    pos_in_expert = position.sum(dim=-1) - 1  # (T,)
    kept = (pos_in_expert >= 0) & (pos_in_expert < capacity)

    # dispatch / combine (T, E, C)
    dispatch = (
        F.one_hot(expert_idx, E).to(x.dtype)[:, :, None]
        * F.one_hot(torch.clamp(pos_in_expert, 0, capacity - 1).long(), capacity)
        .to(x.dtype)[:, None, :]
        * kept[:, None, None].to(x.dtype)
    )
    combine = dispatch * expert_prob[:, None, None].to(x.dtype)

    # each (e, c) slot holds at most one token, so these sums are exact in
    # any dtype: the reference's fp32 accumulation changes nothing
    expert_in = torch.einsum("tec,td->ecd", dispatch, xf).to(dtype)  # (E, C, D)
    gate = F.silu(torch.einsum("ecd,edf->ecf", expert_in, wmat(w_gate, dtype)))
    up = torch.einsum("ecd,edf->ecf", expert_in, wmat(w_in, dtype))
    expert_out = torch.einsum("ecf,efd->ecd", gate * up, wmat(w_out, dtype))
    out = torch.einsum("tec,ecd->td", combine, expert_out.to(x.dtype))

    density = onehot.float().mean(dim=0)  # fraction routed
    density_proxy = probs.mean(dim=0)
    aux = (density * density_proxy).sum() * E
    return out.reshape(B, S, D), aux
