"""Autoregressive generation with a KV cache.

Counterpart of ``elastic_gpu_scheduler_tpu/models/generate.py``: prefill
the cache from the prompt with the multi-token cached forward, then one
token at a time.  Differences from the reference, all of form:

- the cache is written IN PLACE (the reference returns a new one from
  ``lax.dynamic_update_slice``): ``forward_cached`` returns a ``KVCache``
  over the same tensors, so the cache it was given has the new rows too;
- ``lax.scan`` loops are Python loops, ``jax.random`` keys are
  ``torch.Generator``s (greedy decoding is identical; sampled tokens are
  drawn from other bits);
- ``cached_attention_multi`` sends ``window == 0`` on a CUDA tensor to
  kernel K3 (``ops/attention.flash_block_stats``) for any kv-head count
  dividing the query heads.  The reference's other gates (MHA only, T
  tiling, M % 128, a VMEM budget) are limits of the TPU kernel with no
  counterpart on the H100; the function computed is the same either way.
  On the CPU, as in the reference off a TPU, it takes the einsum path.

A MoE layer runs training's ``moe_ffn`` with the config's capacity
factor (drops included), as the reference's does; int8 weights go
through ``quantize.wmatmul`` (kernel KE on CUDA).

``cached_attention`` is the serving engine's gather-path decode attention
and ``cached_attention_multi`` its prefix-cached prefill's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..ops.attention import NEG_INF, flash_block_stats
from .moe import moe_ffn
from .quantize import wmatmul
from .sampling import sample_static
from .transformer import (
    TransformerConfig,
    _embed_lookup,
    layer_slice,
    rms_norm,
    rope,
    torch_dtype,
)


class KVCache(NamedTuple):
    k: torch.Tensor  # (L, B, max_len, Hkv, Dh)
    v: torch.Tensor  # (L, B, max_len, Hkv, Dh)
    length: int  # valid prefix length

    @classmethod
    def empty(cls, cfg: TransformerConfig, batch: int, max_len: int, device=None) -> "KVCache":
        shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
        dtype = torch_dtype(cfg.dtype)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            length=0,
        )


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


def cached_attention_multi(q, cache_k, cache_v, start, window: int = 0):
    """T-position attention against the cache.

    q: (B, T, H, Dh), queries at positions start..start+T-1; cache:
    (B, M, Hkv, Dh) with Hkv dividing H and the T new rows already written
    at those positions.  Causal: query i sees key j iff j <= start + i
    (and start + i - j < window when window > 0).  Kernel K3 on a CUDA
    tensor when window == 0; the einsum path otherwise."""
    if window == 0 and q.device.type == "cuda":
        return _cached_attention_multi_flash(q, cache_k, cache_v, start)
    B, T, Hn, Dh = q.shape
    M, Hkv = cache_k.shape[1], cache_k.shape[2]
    n_rep = Hn // Hkv
    qg = q.reshape(B, T, Hkv, n_rep, Dh).permute(0, 2, 3, 1, 4).float()  # (B,Hkv,r,T,Dh)
    kT = cache_k.transpose(1, 2).float()  # (B, Hkv, M, Dh)
    vT = cache_v.transpose(1, 2).float()
    s = torch.einsum("bgrtd,bgkd->bgrtk", qg, kT) * (Dh ** -0.5)
    qpos = int(start) + torch.arange(T, device=q.device)
    kpos = torch.arange(M, device=q.device)
    keep = kpos[None, :] <= qpos[:, None]
    if window > 0:
        keep = keep & ((qpos[:, None] - kpos[None, :]) < window)
    s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrtk,bgkd->bgrtd", p, vT)  # (B, Hkv, n_rep, T, Dh)
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, Hn, Dh).to(q.dtype)


def _cached_attention_multi_flash(q, cache_k, cache_v, start):
    """``cached_attention_multi`` through the blockwise-stats kernel (K3):
    queries at global positions start.., keys at 0.., the cache read by
    kv-head (never expanded), then pv / l."""
    qT = q.transpose(1, 2)  # (B, H, T, Dh)
    kT = cache_k.transpose(1, 2)  # (B, Hkv, M, Dh)
    vT = cache_v.transpose(1, 2)
    pv, _, l = flash_block_stats(qT, kT, vT, start, 0, causal=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (pv / l_safe[..., None]).to(q.dtype)  # (B, H, T, Dh)
    return out.transpose(1, 2)


@torch.inference_mode()
def forward_cached(params: dict, tokens: torch.Tensor, cache: KVCache, cfg: TransformerConfig):
    """Multi-token cached forward: T tokens from position ``cache.length``
    in one pass.  tokens: (B, T) → (logits (B, T, V) float32, cache at
    length + T).  The new K/V rows are written into ``cache`` in place."""
    dtype = torch_dtype(cfg.dtype)
    B, T = tokens.shape
    Hn, Dh, Hkv = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    pos0 = int(cache.length)
    M = cache.k.shape[2]
    if pos0 + T > M:
        raise ValueError(f"forward_cached: {T} tokens at position {pos0} overflow the "
                         f"cache's max_len {M}")
    x = _embed_lookup(params["embed"], tokens, dtype)  # (B, T, D)
    positions = pos0 + torch.arange(T, device=tokens.device)
    for i in range(cfg.n_layers):
        p = layer_slice(params["layers"], i)
        ck, cv = cache.k[i], cache.v[i]  # (B, M, Hkv, Dh) views
        h = rms_norm(x, p["attn_norm"])
        q = wmatmul(h, p["wq"], dtype).reshape(B, T, Hn, Dh)
        k = wmatmul(h, p["wk"], dtype).reshape(B, T, Hkv, Dh)
        v = wmatmul(h, p["wv"], dtype).reshape(B, T, Hkv, Dh)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        ck[:, pos0:pos0 + T] = k.to(ck.dtype)
        cv[:, pos0:pos0 + T] = v.to(cv.dtype)
        o = cached_attention_multi(q, ck, cv, pos0, window=cfg.window_size)
        x = x + wmatmul(o.reshape(B, T, Hn * Dh), p["wo"], dtype)
        h = rms_norm(x, p["mlp_norm"])
        if cfg.n_experts > 0:
            # training's capacity-factor MoE, drops included, as the reference
            ffn, _ = moe_ffn(h, p["moe_gate"], p["w_in"], p["w_gate"], p["w_out"],
                             capacity_factor=cfg.capacity_factor, dtype=dtype)
            x = x + ffn
        else:
            gate = F.silu(wmatmul(h, p["w_gate"], dtype))
            up = wmatmul(h, p["w_in"], dtype)
            x = x + wmatmul(gate * up, p["w_out"], dtype)
    x = rms_norm(x, params["final_norm"])
    logits = wmatmul(x, params["unembed"], dtype)  # (B, T, V)
    return logits.float(), KVCache(cache.k, cache.v, pos0 + T)


def decode_step(params: dict, token: torch.Tensor, cache: KVCache, cfg: TransformerConfig):
    """token: (B,) at position cache.length → (logits (B, V), cache'): the
    T = 1 case of ``forward_cached``."""
    logits, cache = forward_cached(params, token[:, None], cache, cfg)
    return logits[:, 0, :], cache


def sample_token(logits, temperature: float, generator: torch.Generator, top_k: int = 0,
                 top_p: float = 1.0) -> torch.Tensor:
    """(B, V) logits → (B,) tokens; greedy when temperature == 0."""
    return sample_static(logits, generator, temperature=temperature, top_k=top_k, top_p=top_p)


def _generator(generator, device) -> torch.Generator:
    if generator is not None:
        return generator
    g = torch.Generator(device=device)
    g.manual_seed(0)
    return g


def decode_loop(
    params: dict,
    logits: torch.Tensor,  # (B, V) logits for the NEXT position
    cache: KVCache,
    cfg: TransformerConfig,
    n_steps: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    top_k: int = 0,
    top_p: float = 1.0,
):
    """``n_steps`` decode steps, sampling each token from the previous
    step's logits.  Returns (tokens (B, n_steps), final logits (B, V),
    cache')."""
    generator = _generator(generator, logits.device)
    tokens = []
    for _ in range(n_steps):
        token = sample_token(logits, temperature, generator, top_k=top_k, top_p=top_p)
        logits, cache = decode_step(params, token, cache, cfg)
        tokens.append(token)
    out = torch.stack(tokens, dim=1) if tokens else logits.new_zeros(
        (logits.shape[0], 0), dtype=torch.long)
    return out, logits, cache


def prefill(params: dict, tokens: torch.Tensor, cache: KVCache, cfg: TransformerConfig,
            chunk: int = 512):
    """The prompt in ceil(S / chunk) multi-token passes.  tokens: (B, S) →
    (last-position logits (B, V), cache at length S)."""
    logits = None
    for s0 in range(0, tokens.shape[1], chunk):
        logits, cache = forward_cached(params, tokens[:, s0:s0 + chunk], cache, cfg)
    return logits[:, -1, :], cache


def prefill_sequential(params: dict, tokens: torch.Tensor, cache: KVCache,
                       cfg: TransformerConfig):
    """Token-at-a-time prefill (the ``decode_step`` path), the equivalence
    oracle for ``prefill``."""
    logits = None
    for t in range(tokens.shape[1]):
        logits, cache = decode_step(params, tokens[:, t], cache, cfg)
    return logits, cache


def generate(
    params: dict,
    prompt: torch.Tensor,  # (B, S) int
    cfg: TransformerConfig,
    max_new_tokens: int,
    max_len: int = 0,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    top_k: int = 0,
    top_p: float = 1.0,
    eos_id: Optional[int] = None,
) -> torch.Tensor:
    """Greedy (temperature 0) or sampled generation; returns (B, S + new).
    With ``eos_id``, every position after a row's first EOS becomes
    ``eos_id`` (every step still runs)."""
    B, S = prompt.shape
    max_len = max_len or S + max_new_tokens
    cache = KVCache.empty(cfg, B, max_len, device=prompt.device)
    logits, cache = prefill(params, prompt, cache, cfg)
    tokens, _, _ = decode_loop(params, logits, cache, cfg, max_new_tokens, temperature,
                               generator, top_k, top_p)
    tokens = tokens.to(prompt.dtype)
    if eos_id is not None:
        is_eos = (tokens == eos_id).long()
        after_eos = (torch.cumsum(is_eos, dim=1) - is_eos) > 0
        tokens = torch.where(after_eos, torch.full_like(tokens, eos_id), tokens)
    return torch.cat([prompt, tokens], dim=1)
