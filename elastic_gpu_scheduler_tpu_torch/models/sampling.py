"""Token sampling: temperature, top-k, and top-p (nucleus) filtering.

Counterpart of ``elastic_gpu_scheduler_tpu/models/sampling.py``, in the
HF order: temperature scales the logits, top-k keeps the k most probable
tokens, then top-p keeps the smallest prefix of the top-k-renormalised
sorted distribution whose mass reaches p.  The top-1 token always stays.
temperature 0 is greedy; top_k 0 and top_p >= 1 switch a filter off.

Draws come from an explicit ``torch.Generator`` (Gumbel-max over the
filtered logits), so the bits differ from ``jax.random``'s; the keep-masks
(``filter_static`` / ``filter_batched``) are the reference's exactly.
"""

from __future__ import annotations

import torch


def categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logits); -inf entries never win."""
    u = torch.rand(
        logits.shape, generator=generator, device=logits.device, dtype=torch.float32
    )
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits.float() + gumbel, dim=-1)


def _topp_mask_from_sorted(sorted_scaled: torch.Tensor, top_p) -> torch.Tensor:
    """Keep mask IN SORTED ORDER: smallest prefix with cumulative mass
    reaching top_p; the exclusive-cumsum comparison always keeps the top-1."""
    probs = torch.softmax(sorted_scaled, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    if isinstance(top_p, torch.Tensor):
        top_p = top_p.reshape(-1, 1) if top_p.ndim else top_p
    keep = (cum - probs) < top_p
    keep[..., 0] = True
    return keep


def filter_static(logits, temperature: float, top_k: int = 0, top_p: float = 1.0):
    """(B, V) logits → temperature-scaled logits with filtered entries at
    -inf (temperature > 0)."""
    scaled = logits.float() / max(temperature, 1e-6)
    V = logits.shape[-1]
    if 0 < top_k < V:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled >= kth, scaled, -torch.inf)
    if top_p < 1.0:
        sorted_scaled = torch.sort(scaled, dim=-1, descending=True).values
        keep_sorted = _topp_mask_from_sorted(sorted_scaled, top_p)
        thresh = torch.where(keep_sorted, sorted_scaled, torch.inf).amin(
            dim=-1, keepdim=True
        )
        scaled = torch.where(scaled >= thresh, scaled, -torch.inf)
    return scaled


def sample_static(
    logits: torch.Tensor,
    generator: torch.Generator,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """(B, V) logits → (B,) tokens; one sampling config for the batch."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    return categorical(filter_static(logits, temperature, top_k, top_p), generator)


def filter_batched(logits, temps, top_ks, top_ps):
    """(B, V) logits and PER-ROW params → scaled logits with filtered
    entries at -inf.  One descending argsort serves both filters."""
    logits = logits.float()
    V = logits.shape[-1]
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    order = torch.argsort(-scaled, dim=-1, stable=True)  # descending
    ranks = torch.argsort(order, dim=-1, stable=True)  # rank of each entry
    sorted_scaled = torch.gather(scaled, -1, order)
    tk = top_ks[:, None]
    keep_k = (tk <= 0) | (ranks < tk)
    # top-p sees the top-k-filtered, renormalised distribution
    pos = torch.arange(V, device=logits.device)[None, :]
    sorted_k = torch.where((tk <= 0) | (pos < tk), sorted_scaled, -torch.inf)
    keep_sorted_p = _topp_mask_from_sorted(sorted_k, top_ps)
    keep_p = torch.gather(keep_sorted_p, -1, ranks)
    keep = keep_k & (keep_p | (top_ps[:, None] >= 1.0))
    return torch.where(keep, scaled, -torch.inf)


def sample_batched(
    logits: torch.Tensor,
    generator: torch.Generator,
    temps: torch.Tensor,  # (B,) float32; 0 → greedy for that row
    top_ks: torch.Tensor,  # (B,) int32; 0 → no top-k for that row
    top_ps: torch.Tensor,  # (B,) float32; >= 1 → no top-p for that row
) -> torch.Tensor:
    """(B, V) logits → (B,) int32 tokens with per-row sampling params."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    sampled = categorical(filter_batched(logits, temps, top_ks, top_ps), generator)
    return torch.where(temps > 0, sampled.to(torch.int32), greedy)
