"""Flash attention forward: the hand-written Hopper kernel K1 and its
plain PyTorch version.

Counterpart of ``elastic_gpu_scheduler_tpu/ops/attention.py``.  On a CUDA
tensor ``flash_attention`` launches ``csrc/flash_fwd.cu`` (one block per
64-row query tile, K/V streamed through shared memory, online softmax in
fp32, bf16 products on the tensor cores); on a CPU tensor it computes
``mha_reference``, the same function in plain tensor code.  Nothing else
chooses between the two: a CUDA tensor the kernel does not take makes the
wrapper raise.

Only the forward is ported.  The backward (kernel K4,
``_flash_backward_pallas`` in the reference) is a later slice, so calling
``flash_attention`` under autograd raises instead of differentiating the
plain version.

Layouts are the reference's: q (B, H, Sq, D), k/v (B, H, Sk, D), queries
aligned to the LAST Sq key positions.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

NEG_INF = -1e30  # finite, as in the reference (masked rows stay NaN-free)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (out, lse): out like q, lse (B, H, Sq) fp32 logsumexp of the
    scaled scores.  ``window`` > 0 keeps keys in (q - window, q]."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal or window > 0:
        sq, sk = q.shape[2], k.shape[2]
        q_ids = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        k_ids = torch.arange(sk, device=q.device)[None, :]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_ids >= k_ids
        if window > 0:
            mask &= (q_ids - k_ids) < window
        logits = torch.where(mask, logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    # P in V's dtype before the product, fp32 accumulation
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype), lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    window: int = 0,
    return_lse: bool = False,
):
    """Flash attention forward.  q (B, H, Sq, D), k/v (B, H, Sk, D) →
    out like q (and lse (B, H, Sq) fp32 with ``return_lse``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward yet: the flash backward "
            "(kernel K4, reference ops/attention.py _flash_backward_pallas) "
            "is a later slice of the port"
        )
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"q, k, v on different devices: {sorted(map(str, devs))}")
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    if q.device.type == "cpu":
        out, lse = mha_reference(q, k, v, causal, scale, window=window)
    elif q.device.type == "cuda":
        out, lse = _flash_fwd_cuda(q, k, v, causal, scale, window)
    else:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return (out, lse) if return_lse else out


def _flash_fwd_cuda(q, k, v, causal, scale, window):
    """Launch K1 (csrc/flash_fwd.cu); raises on anything it does not take."""
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} k{tuple(k.shape)}")
    B, H, Sq, D = q.shape
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != D:
        raise ValueError(
            f"flash_attention: q{tuple(q.shape)} and k{tuple(k.shape)} disagree"
        )
    Sk = k.shape[2]
    if Sq > Sk:
        raise ValueError(f"flash_attention kernel needs Sq <= Sk, got {Sq} > {Sk}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention kernel takes float32 or bfloat16 q/k/v of one "
            f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {HEAD_DIMS}, got {D}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("flash_attention kernel needs 16-byte aligned tensors")
    lib = _build.lib()
    err = lib.egs_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, H, Sq, Sk, D, _DTYPE_CODES[q.dtype], int(bool(causal)), int(window),
        scale, _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_fwd launch")
    _build.LAUNCHES["flash_fwd"] += 1
    return out, lse
