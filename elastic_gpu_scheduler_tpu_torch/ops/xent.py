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


class ChunkedSoftmaxXent(torch.autograd.Function):
    """Mean CE of ``(x @ w, targets)`` over vocab chunks; gradients for x
    and w."""

    @staticmethod
    def forward(ctx, x, w, targets, n_chunks):
        D, V = w.shape
        if n_chunks <= 0 or V % n_chunks:
            raise ValueError(f"vocab {V} not divisible by n_chunks {n_chunks}")
        C = V // n_chunks
        x2d = x.reshape(-1, x.shape[-1])
        t_raw = targets.reshape(-1).long()
        valid = (t_raw >= 0) & (t_raw < V)
        t = torch.clamp(t_raw, 0, V - 1)
        N = x2d.shape[0]
        m = torch.full((N,), float("-inf"), dtype=torch.float32, device=x.device)
        s = torch.zeros((N,), dtype=torch.float32, device=x.device)
        gold = torch.zeros((N,), dtype=torch.float32, device=x.device)
        for c in range(n_chunks):
            logits = mm_f32(x2d, w[:, c * C:(c + 1) * C])  # (N, C) fp32
            m_new = torch.maximum(m, logits.max(dim=-1).values)
            s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            local = t - c * C
            in_chunk = (local >= 0) & (local < C)
            picked = logits.gather(1, torch.clamp(local, 0, C - 1)[:, None])[:, 0]
            gold = gold + torch.where(in_chunk, picked, 0.0)
        logz = m + torch.log(s)
        n_valid = torch.clamp(valid.sum(), min=1)
        loss = torch.where(valid, logz - gold, 0.0).sum() / n_valid
        ctx.save_for_backward(x, w, t, valid, logz)
        ctx.n_chunks = n_chunks
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, t, valid, logz = ctx.saved_tensors
        n_chunks = ctx.n_chunks
        D, V = w.shape
        C = V // n_chunks
        x2d = x.reshape(-1, x.shape[-1])
        n_valid = torch.clamp(valid.sum(), min=1)
        # per-token cotangent: masked positions get exactly zero gradient
        scale = (g / n_valid) * valid.float()  # (N,)
        dx = torch.zeros(x2d.shape, dtype=torch.float32, device=x.device)
        dw = torch.empty_like(w)
        cols = torch.arange(C, device=x.device)
        for c in range(n_chunks):
            w_c = w[:, c * C:(c + 1) * C]
            logits = mm_f32(x2d, w_c)
            p = torch.exp(logits - logz[:, None])
            local = t - c * C
            onehot = (cols[None, :] == local[:, None]).float()  # 0 off-chunk
            d_logits = ((p - onehot) * scale[:, None]).to(x2d.dtype)
            dx += mm_f32(d_logits, w_c.t())
            dw[:, c * C:(c + 1) * C] = mm_f32(x2d.t(), d_logits).to(w.dtype)
        return dx.to(x.dtype).reshape(x.shape), dw, None, None


def chunked_softmax_xent(
    x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor, n_chunks: int
) -> torch.Tensor:
    """Mean next-token CE of ``(x @ w, targets)`` without materializing
    the logits.  x: (..., D) hidden states; w: (D, V); targets: (...) int.
    V must divide evenly by ``n_chunks``."""
    return ChunkedSoftmaxXent.apply(x, w, targets, int(n_chunks))


def chunked_softmax_xent_tp(*args, **kwargs):
    raise NotImplementedError(
        "chunked_softmax_xent_tp (a tensor-sharded unembed) needs the mesh "
        "and collectives of parallel/, which is a later slice of the port"
    )
