"""Token sampling: temperature, top-k, and top-p (nucleus) filtering.

Counterpart of ``elastic_gpu_scheduler_tpu/models/sampling.py``, in the
HF order: temperature scales the logits, top-k keeps the k most probable
tokens, then top-p keeps the smallest prefix of the top-k-renormalised
sorted distribution whose mass reaches p.  The top-1 token always stays.
temperature 0 is greedy; top_k 0 and top_p >= 1 switch a filter off.

Draws come from an explicit ``torch.Generator`` (Gumbel-max over the
filtered logits), so the bits differ from ``jax.random``'s; the keep-masks
(``filter_static`` / ``filter_batched``) are the reference's exactly.

Per-request seeds (``row_seeds``): a seeded row's uniforms come from a
counter-based hash of (seed, position, vocab index) in exact int64
integer arithmetic (``seeded_uniforms``), the counterpart of the
reference's ``fold_in(key(seed), position)``.  A seeded row therefore
draws the same tokens whatever its batch, slot or engine mode, on the CPU
and on the card alike, and inside a CUDA graph replay (seeds and
positions are device tensors).  The bits are not ``jax.random``'s.
Unseeded rows keep the generator's stream, which advances the same
whether or not some row is seeded.
"""

from __future__ import annotations

from typing import Optional

import torch


_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit mixing finaliser (xor-shift-multiply) on int64 tensors
    holding values below 2^32.  Every product is such a value times a
    constant below 2^31, so no intermediate leaves int64, and each step
    masks back to 32 bits: the result is exact on any device."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x1B873593) & _M32
    return x ^ (x >> 16)


def seeded_bits(seeds: torch.Tensor, positions: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B, vocab) int64 hashes in [0, 2^32) of (seed, position, vocab
    index): seeds (B,) in [0, 2^32), positions (B,) in [0, 2^31).  Each
    counter enters offset by one, so (0, 0, 0) is not the mixer's fixed
    point 0."""
    row = _mix32((seeds.long() + 1) & _M32)
    row = _mix32(row ^ (((positions.long() + 1) * 0x5BD1E995) & _M32))
    v = torch.arange(1, vocab + 1, device=seeds.device, dtype=torch.int64)
    return _mix32((row[:, None] + v[None, :] * 0x61C88647) & _M32)


def seeded_uniforms(seeds: torch.Tensor, positions: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B, vocab) float32 uniforms in (0, 1) from ``seeded_bits``: the top
    23 bits b give (2b + 1) / 2^24, an integer below 2^24 over a power of
    two, so every value is exact in float32 and never 0 or 1."""
    odd = (seeded_bits(seeds, positions, vocab) >> 9) * 2 + 1
    return odd.to(torch.float32) * (2.0 ** -24)


def categorical(logits: torch.Tensor, generator: torch.Generator,
                row_seeds: Optional[tuple] = None) -> torch.Tensor:
    """One draw per row from softmax(logits); -inf entries never win.

    ``row_seeds``: (seeds (B,), seeded (B,) bool, positions (B,)); rows
    with ``seeded`` draw from ``seeded_uniforms`` at their position
    instead of the generator (which advances the same either way)."""
    u = torch.rand(
        logits.shape, generator=generator, device=logits.device, dtype=torch.float32
    )
    if row_seeds is not None:
        seeds, seeded, positions = row_seeds
        u = torch.where(seeded[:, None], seeded_uniforms(seeds, positions, logits.shape[-1]), u)
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
    row_seeds: Optional[tuple] = None,
) -> torch.Tensor:
    """(B, V) logits → (B,) tokens; one sampling config for the batch
    (``row_seeds`` as in ``categorical``)."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    return categorical(filter_static(logits, temperature, top_k, top_p), generator, row_seeds)


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
    row_seeds: Optional[tuple] = None,  # as in ``categorical``
) -> torch.Tensor:
    """(B, V) logits → (B,) int32 tokens with per-row sampling params."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    sampled = categorical(filter_batched(logits, temps, top_ks, top_ps), generator, row_seeds)
    return torch.where(temps > 0, sampled.to(torch.int32), greedy)
