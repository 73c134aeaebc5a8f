"""Paged decode / verify attention: the hand-written Hopper kernel K2 and
its plain PyTorch version.

Counterpart of ``elastic_gpu_scheduler_tpu/ops/paged_attention.py``.  On a
CUDA tensor ``paged_attention`` launches ``csrc/paged_attention.cu``, which
reads the serving engine's page pool in place (the pages split across
blocks, each warp on its own 16-key chunks, GQA grouped, never expanded;
a second kernel folds the splits' partials in order); on a CPU tensor it
computes ``paged_attention_reference``, the gather-then-attend version.
``paged_attention_split_reference`` is the plain version of the split and
the fold.

An int8 pool comes with per-(token, kv-head) fp32 scales
(``scales_k``/``scales_v``, shape (n_pages, page_size, Hkv)).  Both
versions dequantise as the reference's ``_dequant`` does: int8 to fp32,
times the scale, rounded to the compute ``dtype``, back to fp32, so the
kernel and the engine's gather path see the same K/V values.  The int8
kernel's launches count as ``paged_attention_int8``.
"""

from __future__ import annotations

import torch

from . import _build
from .attention import HEAD_DIMS, NEG_INF, _DTYPE_CODES, merge_block_stats

# dynamic shared memory one block may take on an H100 (227 KB)
MAX_SMEM_BYTES = 232448


def dequant(x, scales, dtype):
    """int8 rows times per-(token, head) scales, through ``dtype`` (the
    reference's ``_dequant``; the serving gather path uses it too)."""
    return (x.float() * scales[..., None]).to(dtype)


def paged_attention_reference(
    q, pool_k, pool_v, tables, lengths, *, scales_k=None, scales_v=None,
    window: int = 0, dtype=None,
):
    """Gather-then-attend oracle.

    q: (B, Hn, Dh) — one query per row at position lengths[b] — or
    (B, W, Hn, Dh) — W queries at lengths[b]..lengths[b]+W-1; pool_k/v:
    (n_pages, page_size, Hkv, Dh); tables: (B, NB) int32; lengths: (B,)
    int32.  Query w of row b attends to positions 0..lengths[b]+w, minus
    anything outside the sliding ``window`` when > 0.  Returns q's rank.
    ``scales_k/v``: (n_pages, page_size, Hkv) scales of an int8 pool,
    dequantised through ``dtype`` (q's dtype when None)."""
    qg, k, v, keep = _gathered(q, pool_k, pool_v, tables, lengths, scales_k, scales_v,
                               window, dtype)
    s = torch.einsum("bwhrd,bthd->bwhrt", qg, k) * (q.shape[-1] ** -0.5)
    s = torch.where(keep[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bwhrt,bthd->bwhrd", p, v)
    return _out_like(o, q)


def paged_attention_split_reference(
    q, pool_k, pool_v, tables, lengths, pages_per_split: int, *, scales_k=None,
    scales_v=None, window: int = 0, dtype=None,
):
    """The plain version of K2's split and fold, with the semantics of
    ``paged_attention_reference``: each run of ``pages_per_split`` table
    pages gives (acc, m, l) over the keys the queries keep in it (a run
    that keeps none gives acc 0, m NEG_INF, l 0), ``merge_block_stats``
    folds the runs in order, and out = acc / max(l, 1e-30)."""
    qg, k, v, keep = _gathered(q, pool_k, pool_v, tables, lengths, scales_k, scales_v,
                               window, dtype)
    run = pages_per_split * pool_k.shape[1]
    parts = []
    for t0 in range(0, k.shape[1], run):
        kk = keep[:, :, None, None, t0:t0 + run]
        s = torch.einsum("bwhrd,bthd->bwhrt", qg, k[:, t0:t0 + run]) * (q.shape[-1] ** -0.5)
        m = torch.where(kk, s, -torch.inf).amax(dim=-1).clamp(min=NEG_INF)
        p = torch.where(kk, torch.exp(s - m[..., None]), 0.0)
        parts.append((torch.einsum("bwhrt,bthd->bwhrd", p, v[:, t0:t0 + run]), m,
                      p.sum(dim=-1)))
    acc, _, l = merge_block_stats(parts)
    return _out_like(acc / l.clamp(min=1e-30)[..., None], q)


def _gathered(q, pool_k, pool_v, tables, lengths, scales_k, scales_v, window, dtype):
    """q grouped by kv-head (B, W, Hkv, n_rep, Dh) fp32, the rows' keys and
    values (B, NB * ps, Hkv, Dh) fp32 (dequantised through ``dtype`` from
    an int8 pool) and the keep mask (B, W, NB * ps)."""
    if q.ndim == 3:
        q = q[:, None]
    B, W, Hn, Dh = q.shape
    NB = tables.shape[1]
    ps, Hkv = pool_k.shape[1], pool_k.shape[2]
    dtype = dtype or q.dtype
    tl = tables.long()
    k = pool_k[tl].reshape(B, NB * ps, Hkv, Dh)
    v = pool_v[tl].reshape(B, NB * ps, Hkv, Dh)
    if scales_k is not None:
        k = dequant(k, scales_k[tl].reshape(B, NB * ps, Hkv), dtype)
        v = dequant(v, scales_v[tl].reshape(B, NB * ps, Hkv), dtype)
    qg = q.reshape(B, W, Hkv, Hn // Hkv, Dh).float()
    kpos = torch.arange(NB * ps, device=q.device)[None, None, :]
    qpos = lengths.long()[:, None, None] + torch.arange(W, device=q.device)[None, :, None]
    keep = kpos <= qpos
    if window > 0:
        keep = keep & ((qpos - kpos) < window)
    return qg, k.float(), v.float(), keep


def _out_like(o, q):
    """(B, W, Hkv, n_rep, Dh) fp32 attention output in q's dtype and rank."""
    o = o.reshape(o.shape[0], o.shape[1], -1, o.shape[-1]).to(q.dtype)
    return o[:, 0] if q.ndim == 3 else o


def paged_attention(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scales_k=None,
    scales_v=None,
    window: int = 0,
    dtype=None,
) -> torch.Tensor:
    """Decode attention straight off the page pool; semantics identical to
    ``paged_attention_reference``.  q is rank 3 (plain decode, W = 1) or
    rank 4 (the W-query verify window).  An int8 pool passes both
    ``scales_k`` and ``scales_v``."""
    if (scales_k is None) != (scales_v is None):
        raise ValueError("paged_attention: pass both scales_k and scales_v, or neither")
    scales = () if scales_k is None else (scales_k, scales_v)
    devs = {t.device for t in (q, pool_k, pool_v, tables, lengths, *scales)}
    if len(devs) != 1:
        raise ValueError(
            f"paged_attention inputs on different devices: {sorted(map(str, devs))}"
        )
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, pool_k, pool_v, tables, lengths, scales_k=scales_k, scales_v=scales_v,
            window=window, dtype=dtype,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return _paged_cuda(q, pool_k, pool_v, tables, lengths, window, scales, dtype)


def _paged_cuda(q, pool_k, pool_v, tables, lengths, window, scales=(), dtype=None):
    """Launch K2 (csrc/paged_attention.cu), its int8-pool variant when
    ``scales`` holds (scales_k, scales_v); raises on anything it does not
    take."""
    squeeze = q.ndim == 3
    q4 = q[:, None] if squeeze else q
    if q4.ndim != 4 or pool_k.ndim != 4 or pool_k.shape != pool_v.shape:
        raise ValueError(
            f"paged_attention: bad shapes q{tuple(q.shape)} pool{tuple(pool_k.shape)}"
        )
    B, W, Hn, Dh = q4.shape
    _, ps, Hkv, Dk = pool_k.shape
    if Dk != Dh or Hn % Hkv:
        raise ValueError(
            f"paged_attention: q{tuple(q.shape)} does not fit pool{tuple(pool_k.shape)}"
        )
    int8 = bool(scales)
    pool_dtype = torch.int8 if int8 else q.dtype
    if q.dtype not in _DTYPE_CODES or pool_k.dtype != pool_dtype or pool_v.dtype != pool_dtype:
        raise TypeError(
            f"paged_attention kernel takes float32 or bfloat16 q with pools of "
            f"q's dtype (int8 with scales), got {q.dtype}/{pool_k.dtype}/{pool_v.dtype}"
        )
    if int8:
        if (dtype or q.dtype) != q.dtype:
            raise TypeError(
                f"paged_attention kernel dequantises through q's dtype {q.dtype}, "
                f"not {dtype}"
            )
        for sc in scales:
            if sc.dtype != torch.float32 or sc.shape != pool_k.shape[:3]:
                raise ValueError(
                    f"paged_attention: scales must be float32 of shape "
                    f"{tuple(pool_k.shape[:3])}, got {sc.dtype} {tuple(sc.shape)}"
                )
    if Dh not in HEAD_DIMS:
        raise ValueError(f"paged_attention kernel takes head_dim in {HEAD_DIMS}, got {Dh}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention kernel takes int32 tables and lengths")
    if tables.ndim != 2 or tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError(
            f"paged_attention: tables{tuple(tables.shape)} / "
            f"lengths{tuple(lengths.shape)} do not fit batch {B}"
        )
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    lib = _build.lib()
    smem = lib.egs_paged_attention_smem(Dh, pool_k.element_size())
    if not 0 < smem <= MAX_SMEM_BYTES:
        raise ValueError(
            f"paged_attention kernel: head_dim {Dh} over a {pool_k.dtype} pool needs "
            f"{smem} bytes of shared memory (> {MAX_SMEM_BYTES})"
        )
    q4 = q4.contiguous()
    pool_k, pool_v = pool_k.contiguous(), pool_v.contiguous()
    tables, lengths = tables.contiguous(), lengths.contiguous()
    out = torch.empty_like(q4)
    if out.numel() == 0:
        return out[:, 0] if squeeze else out
    NB = tables.shape[1]
    # the splits' partials: their count comes from the shapes, never from
    # the lengths, which stay on the device
    n_part = lib.egs_paged_attention_workspace(B, W, Hn, Hkv, Dh, NB)
    part = torch.empty(n_part, dtype=torch.float32, device=q.device) if n_part else None
    tail = (out.data_ptr(), part.data_ptr() if n_part else None, B, W, Hn, Hkv, Dh, ps, NB,
            _DTYPE_CODES[q.dtype], int(window), Dh ** -0.5, _build.stream_ptr(q.device))
    if int8:
        sk, sv = (sc.contiguous() for sc in scales)
        err = lib.egs_paged_attention_int8(
            q4.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), sk.data_ptr(), sv.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), *tail,
        )
        name = "paged_attention_int8"
    else:
        err = lib.egs_paged_attention(
            q4.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), tables.data_ptr(),
            lengths.data_ptr(), *tail,
        )
        name = "paged_attention"
    _build.check(err, f"{name} launch")
    _build.LAUNCHES[name] += 1
    return out[:, 0] if squeeze else out
