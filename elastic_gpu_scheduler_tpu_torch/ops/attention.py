"""Flash attention: the hand-written Hopper kernels K1 (forward), K4
(backward) and K3 (blockwise attention with softmax statistics), their
plain PyTorch versions, and the autograd function that joins K1 and K4.

Counterpart of ``elastic_gpu_scheduler_tpu/ops/attention.py``.  On CUDA
tensors ``flash_attention`` launches ``csrc/flash_fwd.cu`` (one block per
64-row query tile, K/V streamed through shared memory by cp.async, online
softmax in fp32; in bf16 the scores, softmax and output accumulator stay
in registers and the products run on mma.sync, or, at head_dim 128 on a
grid large enough for 128-row tiles, on wgmma fed by TMA) and, when a gradient
is asked for, ``csrc/flash_bwd.cu`` (the FlashAttention-2 backward from
the saved logsumexp: a dq kernel over query tiles and a dk/dv kernel over
key tiles, no atomics, so bitwise repeatable).  Float32 takes the first,
plain-FMA versions of both.  On CPU tensors it computes ``mha_reference``
and ``flash_backward_reference``, the same functions in plain tensor code.
Nothing else chooses between the two: a CUDA tensor a kernel does not
take makes the wrapper raise.

``FlashAttention`` is the counterpart of the reference's ``custom_vjp``:
the forward saves (q, k, v, out, lse) and the backward recomputes the
probabilities block by block, so no (Sq, Sk) tensor is kept for it.

Layouts are the reference's: q (B, H, Sq, D), k/v (B, H, Sk, D), queries
aligned to the LAST Sq key positions.

``flash_block_stats`` launches ``csrc/flash_stats.cu`` (K3) on CUDA
tensors and computes ``flash_block_stats_reference`` on CPU tensors: the
unnormalised (pv, m, l) of queries and keys at explicit global offsets,
what a prefix-cached or chunked prefill needs (``generate.
cached_attention_multi``).  Its k/v may have fewer heads than q (GQA).
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
    mask = _mask(q.shape[2], k.shape[2], causal, window, q.device)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    # P in V's dtype before the product, fp32 accumulation
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype), lse


def _mask(sq: int, sk: int, causal: bool, window: int, device) -> Optional[torch.Tensor]:
    """(Sq, Sk) keep-mask with queries at the last Sq keys, or None."""
    if not (causal or window > 0):
        return None
    q_ids = torch.arange(sq, device=device)[:, None] + (sk - sq)
    k_ids = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= q_ids >= k_ids
    if window > 0:
        mask &= (q_ids - k_ids) < window
    return mask


def flash_backward_reference(q, k, v, out, lse, do, causal=True, sm_scale=None, window=0,
                             round_like_kernel=False):
    """Plain version of K4: the reference's non-Pallas backward (fp32
    einsums over the whole (Sq, Sk) score matrix, masked logits at
    ``NEG_INF``, delta from dO * out).  Returns (dq, dk, dv) in the
    dtypes of q, k, v.

    With ``round_like_kernel`` it also rounds where K4 and the TPU kernels
    do: P to dO's dtype before dV = P^T dO, and dS to q's dtype before
    dQ = dS K and dK = dS^T Q (nothing changes in float32).  A bfloat16
    kernel result then differs from it only by the order of its fp32 sums
    and the final rounding, which ``grad_close`` holds to a few bfloat16
    steps."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    mask = _mask(q.shape[2], k.shape[2], causal, window, q.device)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    p = torch.exp(logits - lse[..., None])
    pv = p.to(do.dtype).float() if round_like_kernel else p
    dv = torch.einsum("bhqk,bhqd->bhkd", pv, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    delta = torch.sum(dof * out.float(), dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    if round_like_kernel:
        ds = ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def grad_close(got, ref, rounded=True) -> bool:
    """K4's tolerance for one gradient against its plain version: finite,
    and everywhere |got - ref| <= ``grad_limit(ref, got.dtype, rounded)``."""
    d = (got.float() - ref.float()).abs()
    return bool((d <= grad_limit(ref, got.dtype, rounded)).all()) and bool(
        torch.isfinite(got).all()
    )


def grad_limit(ref, dtype, rounded=True) -> torch.Tensor:
    """Elementwise limit rtol |ref| + atol rms(ref) on a K4 gradient.

    - float32: rtol 1e-5, atol 1e-4 (sums of up to Sk terms in another
      order);
    - bfloat16 against ``flash_backward_reference(round_like_kernel=True)``
      (``rounded``): rtol 2^-6 (two to four bfloat16 steps: both round
      the same fp32 sums, taken in another order) and atol 2^-5.  The
      absolute term is for a dS that lies near a rounding edge and
      rounds the other way: it moves each element of its dq row and dk
      row by one bfloat16 step of dS times |k| or |q|;
    - bfloat16 against a plain version that rounds neither P nor dS
      (autograd of ``mha_reference``): rtol 2^-5 and atol 2^-3, since
      every one of up to Sk terms then carries its own rounding.

    The absolute term scales with rms(ref), not max(ref): at S 1024 a
    few early rows hold gradients 50x the typical one."""
    r = ref.float()
    if dtype == torch.float32:
        rtol, atol = 1e-5, 1e-4
    elif rounded:
        rtol, atol = 2.0 ** -6, 2.0 ** -5
    else:
        rtol, atol = 2.0 ** -5, 2.0 ** -3
    return rtol * r.abs() + atol * r.pow(2).mean().sqrt()


class FlashAttention(torch.autograd.Function):
    """K1 forward and K4 backward (their plain versions on CPU tensors).
    Returns (out, lse); lse is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, window):
        devs = {t.device for t in (q, k, v)}
        if len(devs) != 1:
            raise ValueError(f"q, k, v on different devices: {sorted(map(str, devs))}")
        if q.device.type == "cpu":
            out, lse = mha_reference(q, k, v, causal, sm_scale, window=window)
        elif q.device.type == "cuda":
            out, lse = _flash_fwd_cuda(q, k, v, causal, sm_scale, window)
        else:
            raise ValueError(f"flash_attention: unsupported device {q.device}")
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale, ctx.window = causal, sm_scale, window
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(
            q, k, v, out, lse, do, ctx.causal, ctx.sm_scale, ctx.window
        )
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    window: int = 0,
    return_lse: bool = False,
):
    """Flash attention, differentiable in q, k, v.  q (B, H, Sq, D), k/v
    (B, H, Sk, D) → out like q (and lse (B, H, Sq) fp32 with
    ``return_lse``)."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    out, lse = FlashAttention.apply(q, k, v, bool(causal), scale, int(window))
    return (out, lse) if return_lse else out


def flash_backward(q, k, v, out, lse, do, causal=True, sm_scale=None, window=0):
    """Gradients (dq, dk, dv) of flash attention from the forward's out and
    lse: K4 on CUDA tensors (two launches, ``flash_bwd_dq`` and
    ``flash_bwd_dkv``), ``flash_backward_reference`` on CPU tensors."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    devs = {t.device for t in (q, k, v, out, lse, do)}
    if len(devs) != 1:
        raise ValueError(f"flash_backward: tensors on different devices: {sorted(map(str, devs))}")
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, out, lse, do, causal, scale, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_backward: unsupported device {q.device}")
    B, H, Sq, Sk, D = _check_kernel_inputs(q, k, v, window, "flash_backward")
    if out.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, Sq):
        raise ValueError(
            f"flash_backward: out{tuple(out.shape)} do{tuple(do.shape)} "
            f"lse{tuple(lse.shape)} do not fit q{tuple(q.shape)}"
        )
    # delta = rowsum(dO * O) in fp32, outside the kernels as in the reference
    delta = torch.sum(do.float() * out.float(), dim=-1).contiguous()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    dof = do.to(q.dtype).contiguous()
    lse = lse.float().contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    _check_aligned((q, k, v, dof, lse, delta, dq, dk, dv), "flash_backward")
    lib = _build.lib()
    common = (B, H, Sq, Sk, D, _DTYPE_CODES[q.dtype], int(bool(causal)), int(window),
              scale, _build.stream_ptr(q.device))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dof.data_ptr(), lse.data_ptr(),
            delta.data_ptr())
    err = lib.egs_flash_bwd_dq(*ptrs, dq.data_ptr(), *common)
    _build.check(err, "flash_bwd_dq launch")
    _build.LAUNCHES["flash_bwd_dq"] += 1
    err = lib.egs_flash_bwd_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(), *common)
    _build.check(err, "flash_bwd_dkv launch")
    _build.LAUNCHES["flash_bwd_dkv"] += 1
    return dq, dk, dv


def _check_kernel_inputs(q, k, v, window, what):
    """Raise on what K1 and K4 do not take; returns (B, H, Sq, Sk, D)."""
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"{what}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)}")
    B, H, Sq, D = q.shape
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != D:
        raise ValueError(f"{what}: q{tuple(q.shape)} and k{tuple(k.shape)} disagree")
    Sk = k.shape[2]
    if Sq > Sk:
        raise ValueError(f"{what} kernel needs Sq <= Sk, got {Sq} > {Sk}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"{what} kernel takes float32 or bfloat16 q/k/v of one "
            f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if D not in HEAD_DIMS:
        raise ValueError(f"{what} kernel takes head_dim in {HEAD_DIMS}, got {D}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    return B, H, Sq, Sk, D


def _check_aligned(tensors, what):
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what} kernel needs 16-byte aligned tensors")


def flash_block_stats_reference(q, k, v, q_offset, k_offset, causal=True, sm_scale=None,
                                round_like_kernel=True):
    """Plain version of K3: (pv (B, H, Sq, D) fp32 unnormalised, m and l
    (B, H, Sq) fp32) over the whole (Sq, Sk) score matrix at once.

    q (B, H, Sq, D); k, v (B, Hkv, Sk, D) with Hkv dividing H (query head
    h reads kv-head h // (H / Hkv)).  Causal keeps (i, j) iff
    ``q_offset + i >= k_offset + j``; a masked logit is ``NEG_INF`` and
    takes part in the max and the sums, so a row that keeps no key gives
    m = NEG_INF, l = Sk and pv = the sum of v, as the TPU kernel does.

    ``round_like_kernel`` (the default) rounds p to v's dtype before the
    P V product, as K3 and the TPU kernel do, while l sums the unrounded
    p; nothing changes in float32.  K3 computes the same sums online, one
    key tile at a time, so in bfloat16 a term p_j v_j may round at
    another scale of its row's running max."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    n_rep = H // Hkv
    scale = D ** -0.5 if sm_scale is None else float(sm_scale)
    if Sk == 0:
        zeros = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
        return (torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device),
                zeros + NEG_INF, zeros)
    qg = q.float().reshape(B, Hkv, n_rep, Sq, D)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.float()) * scale
    if causal:
        qpos = int(q_offset) + torch.arange(Sq, device=q.device)
        kpos = int(k_offset) + torch.arange(Sk, device=q.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    if round_like_kernel:
        p = p.to(v.dtype).float()
    pv = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float())
    return pv.reshape(B, H, Sq, D), m.reshape(B, H, Sq), l.reshape(B, H, Sq)


def block_stats_tolerance_used(got, ref, dtype) -> dict:
    """K3's tolerance against ``flash_block_stats_reference(...,
    round_like_kernel=True)`` on q/k/v of ``dtype``, as the largest share
    of it any element takes, for pv, m and l (each <= 1 passes;
    non-finite values fail):

    - pv, held in units of its row's l (pv / l is an attention output):
      |d| <= atol l + rtol |ref|, float32 atol 2e-5 and rtol 0 (sums of up
      to Sk terms in another order), bfloat16 atol 2^-6 and rtol 2^-8 (p
      rounds to bfloat16 at its tile's running max in the kernel and at
      the row's final max in the plain version: up to two bfloat16 steps
      a term);
    - m: |d| <= 1e-4 + 1e-6 |ref| (fp32 dot products summed in another
      order; NEG_INF rows must match it);
    - l: |d| <= 1e-4 |ref|."""
    pv, m, l = (t.float() for t in got)
    rpv, rm, rl = (t.float() for t in ref)
    atol, rtol = (2e-5, 0.0) if dtype == torch.float32 else (2.0 ** -6, 2.0 ** -8)

    def share(d, lim, x):
        if not bool(torch.isfinite(x).all()):
            return float("inf")
        return float(torch.where(d == 0, 0.0, d / lim).max()) if d.numel() else 0.0

    return {
        "pv": share((pv - rpv).abs(), atol * rl[..., None] + rtol * rpv.abs(), pv),
        "m": share((m - rm).abs(), 1e-4 + 1e-6 * rm.abs(), m),
        "l": share((l - rl).abs(), 1e-4 * rl.abs(), l),
    }


def flash_block_stats(q, k, v, q_offset, k_offset, causal: bool = True,
                      sm_scale: Optional[float] = None):
    """Blockwise attention with softmax statistics: (pv, m, l) as
    ``flash_block_stats_reference`` defines them.  K3 on CUDA tensors
    (counted as ``flash_block_stats``), the plain version on CPU tensors.
    ``q_offset`` / ``k_offset`` are the global positions of the first
    query and key (ints, or 0-d tensors read on the host)."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    q_offset, k_offset = int(q_offset), int(k_offset)
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"flash_block_stats: q, k, v on different devices: "
                         f"{sorted(map(str, devs))}")
    if q.device.type == "cpu":
        return flash_block_stats_reference(q, k, v, q_offset, k_offset, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_block_stats: unsupported device {q.device}")
    return _flash_stats_cuda(q, k, v, q_offset, k_offset, bool(causal), scale)


def _flash_stats_cuda(q, k, v, q_offset, k_offset, causal, scale):
    """Launch K3 (csrc/flash_stats.cu); raises on anything it does not take."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_block_stats: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_block_stats: q{tuple(q.shape)} and k{tuple(k.shape)} "
                         "disagree (k/v need q's batch and head_dim, and heads "
                         "dividing q's)")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_block_stats kernel takes float32 or bfloat16 q/k/v of one "
            f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_block_stats kernel takes head_dim in {HEAD_DIMS}, got {D}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    pv = torch.empty((B, H, Sq, D), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if pv.numel() == 0:
        return pv, m, l
    _check_aligned((q, k, v), "flash_block_stats")
    err = _build.lib().egs_flash_block_stats(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pv.data_ptr(), m.data_ptr(), l.data_ptr(),
        B, H, Hkv, Sq, Sk, D, _DTYPE_CODES[q.dtype], int(causal), q_offset, k_offset,
        scale, _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_block_stats launch")
    _build.LAUNCHES["flash_block_stats"] += 1
    return pv, m, l


def _flash_fwd_cuda(q, k, v, causal, scale, window):
    """Launch K1 (csrc/flash_fwd.cu); raises on anything it does not take."""
    B, H, Sq, Sk, D = _check_kernel_inputs(q, k, v, window, "flash_attention")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    _check_aligned((q, k, v), "flash_attention")
    lib = _build.lib()
    err = lib.egs_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, H, Sq, Sk, D, _DTYPE_CODES[q.dtype], int(bool(causal)), int(window),
        scale, _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_fwd launch")
    _build.LAUNCHES["flash_fwd"] += 1
    return out, lse
