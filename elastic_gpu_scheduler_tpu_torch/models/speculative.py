"""Speculative decoding via prompt-lookup (n-gram) drafting.

Counterpart of ``elastic_gpu_scheduler_tpu/models/speculative.py``.
Draft-model-free speculation: propose the tokens that followed the most
recent earlier occurrence of the context's trailing n-gram, verify all k
proposals in ONE multi-token cached forward (``generate.forward_cached``,
a single wide pass over the k + 1 window), and keep the longest prefix
the model itself would have produced: the output is exactly greedy
decoding, in fewer passes when the drafts land.

The verify window has a fixed width (k + 1, short drafts padded).  Cache
rollback is free: entries beyond the cache's ``length`` are masked out
(``generate.cached_attention_multi``), so rejecting drafts is rewinding
the length; the next write at those positions overwrites them.  The
serving engine's in-batch form of the same idea is
``serving.InferenceEngine(spec_k=...)``, which uses ``propose_ngram``.
"""

from __future__ import annotations

import torch

from .generate import KVCache, decode_step, forward_cached, prefill
from .transformer import TransformerConfig


def propose_ngram(context: list[int], n: int, k: int) -> list[int]:
    """Last-match prompt lookup: find the trailing n-gram earlier in the
    context and propose the (at most) k tokens that followed it."""
    if len(context) < n + 1:
        return []
    tail = context[-n:]
    # scan right to left for the most recent earlier occurrence
    for start in range(len(context) - n - 1, -1, -1):
        if context[start:start + n] == tail:
            return list(context[start + n:start + n + k])
    return []


@torch.inference_mode()
def speculative_generate(
    params: dict,
    prompt: torch.Tensor,  # (1, S) int: a single sequence
    cfg: TransformerConfig,
    max_new_tokens: int,
    ngram: int = 3,
    k: int = 5,
    max_len: int = 0,
) -> tuple[torch.Tensor, dict]:
    """Greedy-equivalent speculative decoding.

    Returns (tokens (1, S + new), stats {"model_passes",
    "accepted_drafts"})."""
    if prompt.shape[0] != 1:
        raise ValueError("speculative decoding is per-sequence (batch 1)")
    S = prompt.shape[1]
    need = S + max_new_tokens + k + 1
    max_len = max_len or need
    # the fixed-width window writes up to k padded rows past the accepted
    # prefix: the cache must hold them
    if max_len < need:
        raise ValueError(
            f"max_len {max_len} < {need} (prompt + max_new_tokens + k + 1; the "
            "padded verify window needs the headroom)"
        )
    cache = KVCache.empty(cfg, 1, max_len, device=prompt.device)
    logits, cache = prefill(params, prompt, cache, cfg)
    context = [int(t) for t in prompt[0].tolist()]
    produced: list[int] = []
    passes = 0
    accepted_total = 0

    next_token = int(torch.argmax(logits, dim=-1)[0])
    produced.append(next_token)
    context.append(next_token)

    while len(produced) < max_new_tokens:
        budget = max_new_tokens - len(produced)
        drafts = propose_ngram(context, ngram, min(k, budget - 1))
        if drafts:
            # ONE wide pass over [last accepted, d1..dn] (+ padding): each
            # position's logits give the model's own choice for the next
            feed = [context[-1]] + drafts + [0] * (k - len(drafts))
            confirmed_len = int(cache.length)
            toks = torch.tensor([feed], dtype=torch.int32, device=prompt.device)
            logits_seq, cache2 = forward_cached(params, toks, cache, cfg)
            passes += 1
            choices = torch.argmax(logits_seq[0], dim=-1).tolist()  # (k + 1,)
            n_accept = 0
            for i, d in enumerate(drafts):
                if int(choices[i]) != d:
                    break
                n_accept += 1
            # the model's own token after the last accepted draft
            own = int(choices[n_accept])
            produced.extend(drafts[:n_accept] + [own])
            context.extend(drafts[:n_accept] + [own])
            accepted_total += n_accept
            # rewind: confirmed prefix + accepted drafts + the fed token
            cache = KVCache(cache2.k, cache2.v, confirmed_len + n_accept + 1)
        else:
            logits, cache = decode_step(
                params, torch.tensor([context[-1]], dtype=torch.int32, device=prompt.device),
                cache, cfg,
            )
            passes += 1
            tok = int(torch.argmax(logits, dim=-1)[0])
            produced.append(tok)
            context.append(tok)

    produced = produced[:max_new_tokens]
    out = torch.cat(
        [prompt, torch.tensor([produced], dtype=prompt.dtype, device=prompt.device)], dim=1
    )
    return out, {"model_passes": passes, "accepted_drafts": accepted_total}
