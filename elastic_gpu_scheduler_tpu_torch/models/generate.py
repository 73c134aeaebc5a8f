"""Decode-time attention against a contiguous KV cache.

Counterpart of ``cached_attention`` in
``elastic_gpu_scheduler_tpu/models/generate.py``: the serving engine's
gather path (``paged_kernel=False``) attends with it over the pages it
gathered.  Plain PyTorch, as it is plain XLA in the reference.  The rest
of that module (``KVCache``, ``decode_loop``, ``generate``) is a later
slice of the port.
"""

from __future__ import annotations

import torch

from ..ops.attention import NEG_INF


def cached_attention(q, cache_k, cache_v, lengths, window: int = 0):
    """Single-position attention against a (possibly grouped) KV cache.

    q: (B, 1, H, Dh); cache: (B, M, Hkv, Dh) with Hkv dividing H — GQA is
    a grouped einsum, the cache is never expanded.  ``lengths``: (B,)
    per-slot positions (or a scalar); ``window`` > 0 applies
    sliding-window masking."""
    B, _, Hn, Dh = q.shape
    M, Hkv = cache_k.shape[1], cache_k.shape[2]
    n_rep = Hn // Hkv
    qg = q.transpose(1, 2).reshape(B, Hkv, n_rep, Dh).float()
    kT = cache_k.transpose(1, 2).float()  # (B, Hkv, M, Dh)
    vT = cache_v.transpose(1, 2).float()
    s = torch.einsum("bgrd,bgkd->bgrk", qg, kT) * (Dh ** -0.5)
    lengths = torch.as_tensor(lengths, device=q.device)
    if lengths.ndim == 0:
        lengths = lengths[None]
    lb = lengths.long()[:, None, None, None]
    positions = torch.arange(M, device=q.device)[None, None, None, :]
    keep = positions <= lb
    if window > 0:
        keep = keep & (lb - positions < window)
    s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrk,bgkd->bgrd", p, vT)  # (B, Hkv, n_rep, Dh)
    return o.reshape(B, Hn, 1, Dh).transpose(1, 2).to(q.dtype)
