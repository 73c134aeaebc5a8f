"""Ring attention: sequence parallelism over the ``seq`` mesh axis.

Counterpart of ``elastic_gpu_scheduler_tpu/parallel/ring.py``.  q, k and v
are cut along the sequence across the ``seq`` ranks; K/V shards travel
round the ring one hop at a time (``collectives.ring_shift``) while each
rank folds its queries' attention over the shard in hand with the
reference's running (acc, max, sum) merge.

- Forward: ``n`` hops, each ``flash_block_stats`` (kernel K3 on CUDA, its
  plain version on the CPU) on the K/V shard in hand, at the shards' global
  offsets.  As in the reference the ring runs in float32 (q, k and v cast
  on entry, the output cast back), and the last hop's rotation is skipped.
  A causal hop on a later shard keeps no key: its (pv, m, l) would merge
  with weight exactly 0 (exp(NEG_INF - m) = 0), so the port skips its call.
- Backward: K3 has no backward in the JAX package, whose ring is
  differentiated through its plain einsum path.  Here each hop is one
  ``flash_backward`` call (kernel K4) with the global ``out`` and ``lse``
  (lse = m + log l): with equal shards a hop is the diagonal (causal,
  aligned), an earlier shard (not causal) or a later shard (skipped).  dq
  accumulates in place; each shard's dk / dv travel with it round the ring
  and reach its owner with one more hop.

Sliding windows under the ring stay refused, as the reference asserts.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import NEG_INF, flash_backward, flash_block_stats
from . import collectives as C


def _hop_kind(my_idx: int, src: int, causal: bool) -> str:
    """"diag", "full" (every key kept) or "skip" (no key kept)."""
    if not causal:
        return "full"
    if src == my_idx:
        return "diag"
    return "full" if src < my_idx else "skip"


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, scale):
        n = C.group_size(mesh, axis)
        my_idx = mesh.axis_index(axis) if n > 1 else 0
        s_local = q.shape[2]
        qf = q.float()
        acc = torch.zeros_like(qf)
        m_i = torch.full(qf.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device)
        l_i = torch.zeros_like(m_i)
        kv = torch.stack([k.float(), v.float()])
        for j in range(n):
            src = (my_idx - j) % n
            if _hop_kind(my_idx, src, causal) != "skip":
                # K3 on CUDA tensors, its plain version on the CPU
                pv, m_blk, l_blk = flash_block_stats(qf, kv[0], kv[1], my_idx * s_local,
                                                     src * s_local, causal=causal,
                                                     sm_scale=scale)
                m_new = torch.maximum(m_i, m_blk)
                alpha = torch.exp(m_i - m_new)
                beta = torch.exp(m_blk - m_new)
                acc = acc * alpha[..., None] + pv * beta[..., None]
                l_i = l_i * alpha + l_blk * beta
                m_i = m_new
            if j < n - 1:  # the last hop's rotation would be discarded
                kv = C.ring_shift(kv, mesh, axis)
        l_safe = torch.where(l_i == 0.0, 1.0, l_i)
        out = acc / l_safe[..., None]
        lse = m_i + torch.log(l_safe)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mesh, ctx.axis, ctx.causal, ctx.scale = mesh, axis, causal, scale
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis, causal, scale = ctx.mesh, ctx.axis, ctx.causal, ctx.scale
        n = C.group_size(mesh, axis)
        my_idx = mesh.axis_index(axis) if n > 1 else 0
        qf, dof = q.float(), do.float()
        dq = torch.zeros_like(qf)
        # (k, v, dk, dv) of the shard in hand travel together
        zeros = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        ring = torch.stack([k.float(), v.float(), zeros, zeros])
        for j in range(n):
            src = (my_idx - j) % n
            kind = _hop_kind(my_idx, src, causal)
            if kind != "skip":
                dq_h, dk_h, dv_h = flash_backward(qf, ring[0], ring[1], out, lse, dof,
                                                  causal=kind == "diag", sm_scale=scale)
                dq += dq_h
                ring[2] += dk_h
                ring[3] += dv_h
            if j < n - 1:
                ring = C.ring_shift(ring, mesh, axis)
        # the shard in hand is (my_idx + 1)'s: one more hop takes its dk / dv home
        dkv = C.ring_shift(ring[2:], mesh, axis)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, axis_name: str = "seq",
                   causal: bool = True, sm_scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v (B, H, S_local, D), this rank's shard of the sequence along
    ``axis_name`` → (B, H, S_local, D), differentiable in q, k, v.  One
    local block when the axis has one rank."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"ring_attention needs equal q/k/v shards, got q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    return _RingAttention.apply(q, k, v, mesh, axis_name, bool(causal), scale)


def ring_attention_sharded(q, k, v, mesh, causal: bool = True,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """The reference's shard_map wrapper takes the global (B, H, S, D) with
    batch on data+fsdp, heads on tensor and sequence on seq; a port rank
    holds its shard already, so this is ``ring_attention`` over ``seq``."""
    return ring_attention(q, k, v, mesh, "seq", causal, sm_scale)
