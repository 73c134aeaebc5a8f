"""Vocab-chunked softmax cross-entropy: the (B·S, V) logits tensor never
materializes.

Counterpart of ``elastic_gpu_scheduler_tpu/ops/xent.py`` (a ``lax.scan``
under a ``custom_vjp`` there, not a Pallas kernel, so plain PyTorch here):

- forward: for each chunk c of C = V / n_chunks columns, logits_c = x @ W_c
  in fp32, folded into an online logsumexp (running max m, scaled sum s)
  plus the gold logit picked up where the target id lands in the chunk;
- backward: recompute logits_c per chunk, form d_logits_c = (softmax_c −
  onehot_c)·ḡ/N in fp32, cast to x's dtype, and contract at once: dx +=
  d_logits_c @ W_cᵀ (fp32 sum), dW_c = xᵀ @ d_logits_c.  Peak extra memory
  is one (N, C) chunk.  Residuals: x, W, targets, their validity mask and
  the (N,) logsumexp.

Targets outside [0, V) are ignored (torch ``ignore_index`` convention):
zero loss, zero gradient, out of the mean's denominator — as the dense
``models/train.cross_entropy_loss``.

Products.  The reference asks XLA for fp32 products of bf16 operands
(``preferred_element_type=float32``): exact bf16 products summed in fp32,
never rounded to bf16.  A bf16 ``torch.matmul`` rounds its output to bf16,
so the port does not use it here.  ``mm_f32`` computes the reference's
product: on CUDA one cuBLAS bf16 GEMM with an fp32 output
(``torch.mm(..., out_dtype=torch.float32)``: tensor cores, fp32
accumulation, no TF32 anywhere); on the CPU, which has no such op, the
operands are widened to fp32 first (bf16 × bf16 is exact in fp32), the
same function.  So the port and the reference differ only in fp32
summation order: the loss agrees to ~1e-6 relative and the gradients to
one bf16 rounding of d_logits and dx (tests/test_torch_xent.py).
"""

from __future__ import annotations

import torch


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D) as fp32: exact products of the operands as they
    are, summed in fp32 (the reference's ``preferred_element_type``)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _check_chunks(V: int, n_chunks: int) -> int:
    if n_chunks <= 0 or V % n_chunks:
        raise ValueError(f"vocab {V} not divisible by n_chunks {n_chunks}")
    return V // n_chunks


def _scan_parts(x2d, w, t, n_chunks):
    """Online logsumexp pieces and the gold logit over vocab chunks: (m
    running max, s scaled sum, gold), each (N,) fp32.  Ids outside [0, V)
    of ``w``'s columns pick up no gold, so a tensor rank passes ids shifted
    into its column space straight in."""
    C = w.shape[1] // n_chunks
    N = x2d.shape[0]
    m = torch.full((N,), float("-inf"), dtype=torch.float32, device=x2d.device)
    s = torch.zeros((N,), dtype=torch.float32, device=x2d.device)
    gold = torch.zeros((N,), dtype=torch.float32, device=x2d.device)
    for c in range(n_chunks):
        logits = mm_f32(x2d, w[:, c * C:(c + 1) * C])  # (N, C) fp32
        m_new = torch.maximum(m, logits.max(dim=-1).values)
        s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
        m = m_new
        local = t - c * C
        in_chunk = (local >= 0) & (local < C)
        picked = logits.gather(1, torch.clamp(local, 0, C - 1)[:, None])[:, 0]
        gold = gold + torch.where(in_chunk, picked, 0.0)
    return m, s, gold


def _bwd_scan(x2d, w, t, logz, scale, n_chunks):
    """Recompute each chunk's logits, form d_logits = (softmax − onehot)·scale
    against ``logz`` (global under tensor parallelism), contract at once.
    Returns (dx fp32 (N, D), dw like w).  Ids outside a chunk get no onehot."""
    C = w.shape[1] // n_chunks
    dx = torch.zeros(x2d.shape, dtype=torch.float32, device=x2d.device)
    dw = torch.empty_like(w)
    cols = torch.arange(C, device=x2d.device)
    for c in range(n_chunks):
        w_c = w[:, c * C:(c + 1) * C]
        logits = mm_f32(x2d, w_c)
        p = torch.exp(logits - logz[:, None])
        local = t - c * C
        onehot = (cols[None, :] == local[:, None]).float()  # 0 off-chunk
        d_logits = ((p - onehot) * scale[:, None]).to(x2d.dtype)
        dx += mm_f32(d_logits, w_c.t())
        dw[:, c * C:(c + 1) * C] = mm_f32(x2d.t(), d_logits).to(w.dtype)
    return dx, dw


def _denominator(valid, n_valid):
    """The mean's denominator: this call's valid count, or ``n_valid`` (the
    count over every rank's tokens, for a loss summed across ranks)."""
    if n_valid is None:
        return torch.clamp(valid.sum(), min=1)
    return torch.clamp(torch.as_tensor(n_valid, device=valid.device), min=1)


class ChunkedSoftmaxXent(torch.autograd.Function):
    """Mean CE of ``(x @ w, targets)`` over vocab chunks; gradients for x
    and w."""

    @staticmethod
    def forward(ctx, x, w, targets, n_chunks, n_valid=None):
        D, V = w.shape
        _check_chunks(V, n_chunks)
        x2d = x.reshape(-1, x.shape[-1])
        t_raw = targets.reshape(-1).long()
        valid = (t_raw >= 0) & (t_raw < V)
        t = torch.clamp(t_raw, 0, V - 1)
        m, s, gold = _scan_parts(x2d, w, t, n_chunks)
        logz = m + torch.log(s)
        denom = _denominator(valid, n_valid)
        loss = torch.where(valid, logz - gold, 0.0).sum() / denom
        ctx.save_for_backward(x, w, t, valid, logz, denom)
        ctx.n_chunks = n_chunks
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, t, valid, logz, denom = ctx.saved_tensors
        x2d = x.reshape(-1, x.shape[-1])
        # per-token cotangent: masked positions get exactly zero gradient
        scale = (g / denom) * valid.float()  # (N,)
        dx, dw = _bwd_scan(x2d, w, t, logz, scale, ctx.n_chunks)
        return dx.to(x.dtype).reshape(x.shape), dw, None, None, None


def chunked_softmax_xent(
    x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor, n_chunks: int, n_valid=None
) -> torch.Tensor:
    """Mean next-token CE of ``(x @ w, targets)`` without materializing
    the logits.  x: (..., D) hidden states; w: (D, V); targets: (...) int.
    V must divide evenly by ``n_chunks``.  ``n_valid``: the mean's
    denominator when it is not this call's own count of valid targets."""
    return ChunkedSoftmaxXent.apply(x, w, targets, int(n_chunks), n_valid)


# -- tensor-parallel variant -------------------------------------------------


class ChunkedSoftmaxXentTP(torch.autograd.Function):
    """One tensor rank's part of the TP loss: ``w_local`` is its (D, V/T)
    unembed columns, x and targets are alike on every tensor rank."""

    @staticmethod
    def forward(ctx, x, w_local, targets, n_chunks_local, mesh, axis, v_global, n_valid):
        from ..parallel.collectives import all_reduce

        v_local = w_local.shape[1]
        x2d = x.reshape(-1, x.shape[-1])
        t_raw = targets.reshape(-1).long()
        valid = (t_raw >= 0) & (t_raw < v_global)
        # ids shifted into this rank's column space: off-rank ids fall
        # outside [0, v_local) and pick up no gold, so the sum over ranks
        # holds each token's gold logit once
        t_local = torch.clamp(t_raw, 0, v_global - 1) - mesh.axis_index(axis) * v_local
        m, s, gold = _scan_parts(x2d, w_local, t_local, n_chunks_local)
        m_g = all_reduce(m, mesh, axis, op="max")
        s_g = all_reduce(s * torch.exp(m - m_g), mesh, axis)
        logz = m_g + torch.log(s_g)
        gold_g = all_reduce(gold, mesh, axis)
        denom = _denominator(valid, n_valid)
        loss = torch.where(valid, logz - gold_g, 0.0).sum() / denom
        ctx.save_for_backward(x, w_local, t_local, valid, logz, denom)
        ctx.n_chunks, ctx.mesh, ctx.axis = n_chunks_local, mesh, axis
        return loss

    @staticmethod
    def backward(ctx, g):
        from ..parallel.collectives import all_reduce

        x, w_local, t_local, valid, logz, denom = ctx.saved_tensors
        x2d = x.reshape(-1, x.shape[-1])
        scale = (g / denom) * valid.float()
        # logz is global and t_local rank-shifted: this rank's slice of the
        # global softmax gradient (an off-rank gold gets only the softmax term)
        dx, dw = _bwd_scan(x2d, w_local, t_local, logz, scale, ctx.n_chunks)
        # x is alike on every tensor rank: its cotangent sums their parts
        dx = all_reduce(dx, ctx.mesh, ctx.axis)
        return dx.to(x.dtype).reshape(x.shape), dw, None, None, None, None, None, None


def chunked_softmax_xent_tp(x: torch.Tensor, w_local: torch.Tensor, targets: torch.Tensor,
                            n_chunks: int, mesh, axis: str = "tensor", n_valid=None
                            ) -> torch.Tensor:
    """Tensor-parallel ``chunked_softmax_xent`` (reference
    ``ops/xent.py chunked_softmax_xent_tp``): the V-sharded unembed stays
    sharded and the (N, V) logits never exist.  ``w_local`` is this rank's
    (D, V/T) slice; ``n_chunks`` counts chunks over the whole vocab, so each
    rank scans its columns in ``n_chunks``/T chunks, and one max and two
    sums over ``axis`` merge the logsumexp and the gold logit.  The
    backward sums dx over ``axis`` and keeps dW on its rank.  The
    combinations the reference rejects raise the same way."""
    T = mesh.shape[axis]
    V = w_local.shape[1] * T
    if n_chunks % T or (V // T) % (n_chunks // T):
        raise ValueError(
            f"xent_chunks={n_chunks} must be a multiple of {axis}={T} with "
            f"V/{axis} = {V // T} divisible by chunks/{axis} = "
            f"{n_chunks // T} (each rank scans its shard in that many chunks)")
    return ChunkedSoftmaxXentTP.apply(x, w_local, targets, n_chunks // T, mesh, axis, V, n_valid)
