"""Continuous-batching inference engine: paged KV cache + fused decode.

Counterpart of ``elastic_gpu_scheduler_tpu/models/serving.py``, the
sequential engine (the reference's ``overlap=False``).  Requests join and
leave a fixed-shape batch between fused decode chunks:

- **Paged KV cache**: one pool (L, P, page_size, Hkv, Dh) shared by all
  slots plus a host block table (B, max_pages) of page ids per slot.
  Pages are allocated as sequences grow and freed on completion.  Page 0
  is a scratch page: inactive rows and prompt padding write there and
  nobody reads it.  Rows are written in place (``index_put_``), where the
  reference returns a new pool.
- **int8 KV** (``kv_int8``): the pool stores K/V as int8 with one fp32
  scale per (token, kv-head) (``_quantize_rows``); every read
  dequantises through the compute dtype, in the gather path and inside
  kernel K2 alike, so the two stay token-identical.
- **Prefill**: an admitted prompt is ingested in one pass
  (``_paged_prefill``, flash attention: kernel K1 on CUDA), padded to a
  power of two; only the last real row is unembedded.  A pass behind
  pages already written (a prefix-cache hit, or a later chunk of a
  chunked prefill) attends over the slot's gathered pages instead
  (``_paged_prefill_prefixed``, ``generate.cached_attention_multi``:
  kernel K3 on CUDA).
- **Prefix cache** (``prefix_cache``): full prompt pages of a finished
  request stay in the pool under a BLAKE2b digest chain of their tokens
  (``utils/prefixdigest``); a new prompt attaches matching pages
  read-only (refcounted) and prefills only the rest.  Unreferenced
  cached pages are evicted least recently used when the free list runs
  dry.
- **Chunked prefill** (``prefill_chunk`` > 0): a long prompt is ingested
  at most that many tokens per engine step, between other slots' decode
  chunks.
- **Fused decode**: each engine step runs ``fused_steps`` decode
  iterations (``_fused_serve_chunk``) with prompt feeding and sampling on
  the device; the host drains the sampled tokens afterwards.  With
  ``paged_kernel=True`` decode attention reads the pool in place
  (kernel K2 on CUDA); otherwise it gathers each slot's pages into a
  contiguous view and attends with ``cached_attention``.

The step functions run under ``torch.inference_mode()``: serving
parameters that require grad (a model fresh from ``models/train.py``)
builds no autograd graph.

A slot that cannot get pages stalls (state intact) until completions free
some; a higher-priority stalled slot spills a lower-priority one (its
request requeues and resumes exactly); if every slot is stalled the engine
raises "page pool exhausted".

Not ported yet, and rejected by name: LoRA adapters, speculative
decoding, a mesh, the overlapped pipeline, the bounded queue and the
compile cache (engine options), the per-request logprobs, penalties,
logit bias, allowed tokens, min_tokens and seeds (``Request`` has no
such fields), and the disaggregated KV export / import / migration
verbs.
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import flash_attention
from ..ops.paged_attention import dequant, paged_attention
from ..utils import prefixdigest
from .generate import cached_attention, cached_attention_multi
from .quantize import wmat
from .sampling import categorical, sample_batched, sample_static
from .transformer import (
    TransformerConfig,
    _embed_lookup,
    _rope_tables,
    check_dense,
    layer_slice,
    repeat_kv,
    resolve_device,
    rms_norm,
    torch_dtype,
)

# structured rejection sentinel: the HTTP layer maps it to a 503
DRAINING_ERROR = "server draining"

log = logging.getLogger("tpu-scheduler")

SCRATCH_PAGE = 0  # reserved; inactive slots write here, nobody reads it

# reference engine options this slice does not serve (a truthy value raises)
_UNPORTED_OPTIONS = (
    "adapters", "spec_k", "draft", "mesh", "max_queue", "overlap", "compile_cache",
)


# -- paged KV pool -----------------------------------------------------------


def make_kv_pool(cfg: TransformerConfig, n_pages: int, page_size: int, device,
                 int8: bool = False) -> dict:
    """Pool {"k", "v"} of shape (L, P, page_size, Hkv, Dh) in the compute
    dtype, or int8 with {"ks", "vs"} (L, P, page_size, Hkv) fp32 scales."""
    shape = (cfg.n_layers, n_pages, page_size, cfg.kv_heads, cfg.head_dim)
    if int8:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "ks": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "vs": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        }
    dtype = torch_dtype(cfg.dtype)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _quantize_rows(x):
    """(N, Hkv, Dh) → int8 rows and per-(token, head) fp32 scales:
    symmetric, max |x| / 127, round half to even (as ``jnp.round``),
    the scale floored at 1e-8 for the division."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    safe = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(xf / safe[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _layer_kv(kv: dict, i: int) -> dict:
    """Layer ``i``'s pool slice (K, V and, for int8, their scales): views,
    so writes land in the pool."""
    return {name: t[i] for name, t in kv.items()}


def _kv_write_rows(lkv: dict, pidx, off, k_rows, v_rows) -> dict:
    """Scatter new K/V rows into one layer's pool slice at (pidx, off), IN
    PLACE (``index_put_``), quantised when the pool is int8: the
    reference returns a new pool, the port updates the one it has and
    saves the copy."""
    idx = (pidx.long(), off.long())
    if "ks" in lkv:
        qk, sk = _quantize_rows(k_rows)
        qv, sv = _quantize_rows(v_rows)
        lkv["k"].index_put_(idx, qk)
        lkv["v"].index_put_(idx, qv)
        lkv["ks"].index_put_(idx, sk)
        lkv["vs"].index_put_(idx, sv)
    else:
        lkv["k"].index_put_(idx, k_rows.to(lkv["k"].dtype))
        lkv["v"].index_put_(idx, v_rows.to(lkv["v"].dtype))
    return lkv


def _kv_gather(lkv: dict, tables, page_size: int, dtype):
    """One layer's pages → virtually-contiguous (B, M, Hkv, Dh) K and V
    (dequantised through ``dtype`` when the pool is int8)."""
    B, maxp = tables.shape
    Hkv, Dh = lkv["k"].shape[-2], lkv["k"].shape[-1]
    t = tables.long()
    k = lkv["k"][t].reshape(B, maxp * page_size, Hkv, Dh)
    v = lkv["v"][t].reshape(B, maxp * page_size, Hkv, Dh)
    if "ks" in lkv:
        k = dequant(k, lkv["ks"][t].reshape(B, maxp * page_size, Hkv), dtype)
        v = dequant(v, lkv["vs"][t].reshape(B, maxp * page_size, Hkv), dtype)
    return k.to(dtype), v.to(dtype)


@dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0  # 0 → disabled
    top_p: float = 1.0  # >= 1 → disabled
    # generation stops when any of these ids is emitted (the stop token IS
    # included in the output); () → run to max_new_tokens
    stop_tokens: tuple = ()
    # streaming: called from the engine thread with each emitted token id
    on_token: Optional[object] = None
    # admission class (higher first, FIFO within a class); under page
    # pressure a stalled slot spills a strictly lower-priority one
    priority: int = 0
    # internal: times the serving loop evicted this request because every
    # slot stalled (a second eviction fails it)
    pool_spills: int = 0
    done: threading.Event = field(default_factory=threading.Event)
    output: list[int] = field(default_factory=list)
    error: str = ""
    # the engine thread owns output/error/done; other threads read output
    # after done, and may only set ``cancelled`` (checked every chunk)
    cancelled: bool = False
    t_submit: float = 0.0  # first enqueue (monotonic)
    t_admit: float = 0.0  # first slot admission (monotonic)

    def cancel(self) -> None:
        """Stop generation at the next chunk boundary; any thread."""
        self.cancelled = True


# -- step functions ------------------------------------------------------------


def _rope_rows(x, positions, theta):
    """rope with PER-ROW positions: x (B, T, H, Dh), positions (B, T)."""
    half = x.shape[-1] // 2
    cos, sin = _rope_tables(positions, half, theta)  # (B, T, half)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x.float().split(half, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _sproj(x, p, name, dtype):
    """``x @ p[name]`` (LoRA deltas are a later slice)."""
    return x @ wmat(p[name], dtype)


def _paged_layer(x, p, lkv, positions, pidx, off, attn, cfg, dtype):
    """ONE transformer layer shared by the paged paths (decode step and
    prefill); they differ only in positions (B, T), the scatter targets
    (B·T,) and ``attn(q, k, v, lkv)`` → (B, T, Hn·Dh)."""
    B, T, _ = x.shape
    Hn, Dh, Hkv = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    h = rms_norm(x, p["attn_norm"])
    q = _sproj(h, p, "wq", dtype).reshape(B, T, Hn, Dh)
    k = _sproj(h, p, "wk", dtype).reshape(B, T, Hkv, Dh)
    v = _sproj(h, p, "wv", dtype).reshape(B, T, Hkv, Dh)
    q = _rope_rows(q, positions, cfg.rope_theta)
    k = _rope_rows(k, positions, cfg.rope_theta)
    # inactive/padding rows target the scratch page
    _kv_write_rows(lkv, pidx, off, k.reshape(B * T, Hkv, Dh), v.reshape(B * T, Hkv, Dh))
    o = attn(q, k, v, lkv)
    x = x + _sproj(o, p, "wo", dtype)
    h = rms_norm(x, p["mlp_norm"])
    gate = F.silu(_sproj(h, p, "w_gate", dtype))
    up = _sproj(h, p, "w_in", dtype)
    return x + _sproj(gate * up, p, "w_out", dtype)


def _paged_attn_call(q, lkv, tables, lengths, cfg, dtype):
    """Attend straight off one layer's page pool (kernel K2 on CUDA, its
    int8 variant with in-kernel dequantisation for an int8 pool).
    q: (B, Hn, Dh) decode or (B, W, Hn, Dh) verify."""
    return paged_attention(
        q, lkv["k"], lkv["v"], tables, lengths, scales_k=lkv.get("ks"),
        scales_v=lkv.get("vs"), window=cfg.window_size, dtype=dtype,
    )


@torch.inference_mode()
def _paged_decode_step(params, tokens, kv, tables, lengths, cfg, page_size,
                       paged_kernel=False):
    """One decode step for every slot at its own position.

    tokens: (B,) int32; kv: pool (``make_kv_pool``), updated in place;
    tables: (B, NB) int32 page ids; lengths: (B,) int32 write positions.
    Returns (logits (B, V) float32, kv)."""
    dtype = torch_dtype(cfg.dtype)
    B = tokens.shape[0]
    Hn, Dh = cfg.n_heads, cfg.head_dim
    x = _embed_lookup(params["embed"], tokens, dtype)[:, None, :]  # (B, 1, D)
    ln = lengths.long()
    bidx = torch.arange(B, device=tokens.device)
    # a finished slot's overshoot may step past its table view: clamp the
    # column, as the reference's gather does
    col = torch.clamp(ln // page_size, max=tables.shape[1] - 1)
    page_idx = tables[bidx, col]
    offset = ln % page_size

    def attn(q, k, v, lkv):
        if paged_kernel:
            o = _paged_attn_call(q[:, 0], lkv, tables, lengths, cfg, dtype)
            return o.reshape(B, 1, Hn * Dh)
        # position j of the gathered view IS token position j
        k_all, v_all = _kv_gather(lkv, tables, page_size, dtype)
        return cached_attention(
            q, k_all, v_all, lengths, window=cfg.window_size
        ).reshape(B, 1, Hn * Dh)

    for i in range(cfg.n_layers):
        x = _paged_layer(
            x, layer_slice(params["layers"], i), _layer_kv(kv, i), ln[:, None],
            page_idx, offset, attn, cfg, dtype,
        )
    x = rms_norm(x, params["final_norm"])
    logits = (x @ wmat(params["unembed"], dtype))[:, 0, :]
    return logits.float(), kv


@torch.inference_mode()
def _paged_prefill(params, tokens, kv, pages, t_real: int, *, cfg, page_size):
    """One-pass prompt ingestion for ONE slot: causal self-attention over
    the whole (padded) prompt block, K/V scattered into the slot's pages.

    tokens: (1, Tpad); pages: (n,) the slot's table row; t_real: count of
    real tokens (padding K/V goes to the scratch page).  Returns (logits
    (V,) of the last real position, kv) — only that row is unembedded."""
    dtype = torch_dtype(cfg.dtype)
    Tpad = tokens.shape[1]
    Hn, Dh = cfg.n_heads, cfg.head_dim
    dev = tokens.device
    x = _embed_lookup(params["embed"], tokens, dtype)  # (1, Tpad, D)
    positions = torch.arange(Tpad, device=dev)
    col = torch.clamp(positions // page_size, max=pages.shape[0] - 1)
    pidx = torch.where(
        positions < t_real, pages.long()[col], torch.full_like(positions, SCRATCH_PAGE)
    )
    off = positions % page_size
    n_rep = Hn // cfg.kv_heads

    def attn(q, k, v, lkv):
        # the prompt is the whole valid prefix: plain causal attention
        # within the block (padding sits after every real position)
        return flash_attention(
            q.transpose(1, 2),
            repeat_kv(k, n_rep).transpose(1, 2),
            repeat_kv(v, n_rep).transpose(1, 2),
            True, None, cfg.window_size,
        ).transpose(1, 2).reshape(1, Tpad, Hn * Dh)

    for i in range(cfg.n_layers):
        x = _paged_layer(
            x, layer_slice(params["layers"], i), _layer_kv(kv, i), positions[None, :],
            pidx, off, attn, cfg, dtype,
        )
    x = x[:, t_real - 1:t_real]  # (1, 1, D)
    x = rms_norm(x, params["final_norm"])
    logits = (x @ wmat(params["unembed"], dtype))[0, 0]
    return logits.float(), kv


@torch.inference_mode()
def _paged_prefill_prefixed(params, tokens, kv, pages, t0: int, t_real: int, *, cfg,
                            page_size):
    """One-pass prompt ingestion BEHIND pages already written (a
    prefix-cache hit, or a later chunk of a chunked prefill).

    Same contract as ``_paged_prefill`` except the slot's pages already
    hold K/V for positions < t0: the new tokens sit at positions
    t0..t0+t_real-1, and attention gathers the slot's pages (dequantised
    when int8) so the queries see the cached prefix
    (``generate.cached_attention_multi``: kernel K3 on CUDA).  Padding
    rows write to the scratch page; their outputs are never consumed."""
    dtype = torch_dtype(cfg.dtype)
    Tpad = tokens.shape[1]
    Hn, Dh = cfg.n_heads, cfg.head_dim
    dev = tokens.device
    x = _embed_lookup(params["embed"], tokens, dtype)  # (1, Tpad, D)
    rel = torch.arange(Tpad, device=dev)
    positions = t0 + rel
    # padding positions may index past the table row: clamp, as the
    # reference's gather does, then route them to scratch
    col = torch.clamp(positions // page_size, max=pages.shape[0] - 1)
    pidx = torch.where(
        rel < t_real, pages.long()[col], torch.full_like(positions, SCRATCH_PAGE)
    )
    off = positions % page_size

    def attn(q, k, v, lkv):
        k_all, v_all = _kv_gather(lkv, pages[None, :], page_size, dtype)
        return cached_attention_multi(
            q, k_all, v_all, t0, window=cfg.window_size
        ).reshape(1, Tpad, Hn * Dh)

    for i in range(cfg.n_layers):
        x = _paged_layer(
            x, layer_slice(params["layers"], i), _layer_kv(kv, i), positions[None, :],
            pidx, off, attn, cfg, dtype,
        )
    x = x[:, t_real - 1:t_real]  # (1, 1, D)
    x = rms_norm(x, params["final_norm"])
    logits = (x @ wmat(params["unembed"], dtype))[0, 0]
    return logits.float(), kv


@torch.inference_mode()
def _fused_serve_chunk(
    params, kv, tables, tokens, lengths, active, prompts, prompt_lens,
    temps, top_ks, top_ps, generator,
    *, cfg, page_size, n_steps, use_filters, use_temp, paged_kernel=False,
):
    """``n_steps`` decode iterations with sampling and prompt feeding on
    the device.  Returns (sampled (B, n_steps), kv, next_tokens (B,),
    new_lengths (B,)).

    Step s feeds the token at position lengths+s and samples from its
    logits; the host decides afterwards which samples are real emissions
    (position >= prompt_len-1).  ``use_filters``: some row asks for
    top-k/top-p; ``use_temp``: some row samples (temperature > 0)."""
    outs = []
    for _ in range(n_steps):
        logits, kv = _paged_decode_step(
            params, tokens, kv, tables, lengths, cfg, page_size, paged_kernel
        )
        if use_filters:
            sampled = sample_batched(logits, generator, temps, top_ks, top_ps)
        else:
            sampled = torch.argmax(logits, dim=-1).to(torch.int32)
            if use_temp:
                scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
                temped = categorical(scaled, generator).to(torch.int32)
                sampled = torch.where(temps > 0, temped, sampled)
        new_len = lengths + active.to(torch.int32)
        in_prompt = new_len < prompt_lens
        nxt = torch.clamp(new_len, max=prompts.shape[1] - 1).long()
        prompt_next = torch.gather(prompts, 1, nxt[:, None])[:, 0]
        next_tok = torch.where(in_prompt, prompt_next, sampled)
        tokens = torch.where(active, next_tok, tokens)
        lengths = new_len
        outs.append(sampled)
    return torch.stack(outs, dim=1), kv, tokens, lengths


def default_n_pages(max_batch: int, max_len: int, page_size: int) -> int:
    """Capacity-equivalent to a slot-contiguous layout, plus scratch."""
    return max_batch * (-(-max_len // page_size)) + 1


def estimate_hbm_bytes(
    cfg,
    max_batch: int,
    max_len: int,
    page_size: int,
    n_pages: int = 0,
    kv_int8: bool = False,
) -> dict:
    """Static device-memory accounting for an engine configuration (no
    allocation), as the reference counts it by default: the KV pool (int8
    K/V plus fp32 scales when ``kv_int8``) and the weights at 2 bytes a
    parameter (the norm scales, kept in fp32, take 2 bytes more each).
    Returns byte counts plus ``total``."""
    n_pages = n_pages or default_n_pages(max_batch, max_len, page_size)
    page_elems = page_size * cfg.kv_heads * cfg.head_dim
    per_tensor = cfg.n_layers * n_pages * page_elems
    if kv_int8:
        pool = 2 * per_tensor  # int8 k + v
        pool += 2 * cfg.n_layers * n_pages * page_size * cfg.kv_heads * 4
    else:
        pool = 2 * per_tensor * torch_dtype(cfg.dtype).itemsize
    out = {
        "kv_pool_bytes": int(pool),
        "target_param_bytes": int(_cfg_param_count(cfg) * 2),
    }
    out["total"] = sum(out.values())
    return out


def _cfg_param_count(cfg) -> int:
    """Parameter count from config shapes alone (embed, per-layer
    attention and FFN, norms, unembed; MoE experts included)."""
    D, F_, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
    H = cfg.n_heads * cfg.head_dim
    KV = cfg.kv_heads * cfg.head_dim
    attn = D * (H + 2 * KV) + H * D
    ffn = 3 * D * F_
    if cfg.n_experts > 0:
        ffn = cfg.n_experts * ffn + D * cfg.n_experts  # experts + router
    per_layer = attn + ffn + 2 * D  # + the two norms
    return V * D + L * per_layer + D + D * V


def _prefix_page_key(prev: bytes, toks: np.ndarray) -> bytes:
    """One link of the prefix-cache key chain: a 16-byte BLAKE2b digest
    over (previous link, this page's int32 token bytes), the chain
    ``utils/prefixdigest`` defines (byte-identical to the reference's)."""
    return prefixdigest.prefix_page_key(prev, toks.tobytes())


def _prefix_seed(adapter_id: int) -> bytes:
    """Chain seed: cached K/V depends on the adapter, so pages cached
    under one must never match another's prompts (the port serves the
    base model only: adapter id 0)."""
    return prefixdigest.prefix_seed(adapter_id)


@dataclass
class _PendingChunk:
    """A dispatched fused chunk and the host snapshot needed to drain it;
    ``pairs`` pins the (slot, request) identity at dispatch time."""

    out: torch.Tensor  # sampled (B, n_steps)
    n_steps: int
    pos0: np.ndarray  # per-slot lengths BEFORE the chunk ran
    pairs: list


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


class InferenceEngine:
    """Paged-cache continuous batching with fused K-step decode chunks."""

    def __init__(
        self,
        params: dict,
        cfg: TransformerConfig,
        max_batch: int = 8,
        max_len: int = 512,
        page_size: int = 16,
        n_pages: int = 0,
        fused_steps: int = 8,
        kv_int8: bool = False,
        prefix_cache: bool = False,
        paged_kernel: bool = False,
        prefill_chunk: int = 0,
        device=None,
        **unported,
    ):
        """``paged_kernel``: decode attention reads the page pool in place
        (kernel K2 on CUDA) instead of gathering a contiguous copy per
        step.  ``kv_int8``: the pool holds int8 K/V with per-(token,
        kv-head) scales.  ``prefix_cache``: full prompt pages stay cached
        after a request and later prompts with the same leading pages
        attach them.  ``prefill_chunk`` > 0: prompts longer than that
        ingest that many tokens per engine step.  ``device``: ``cuda``
        unless asked otherwise; the weights move there."""
        unknown = sorted(set(unported) - set(_UNPORTED_OPTIONS))
        if unknown:
            raise TypeError(f"unknown engine options {unknown}")
        asked = sorted(k for k, v in unported.items() if v)
        if asked:
            raise NotImplementedError(
                f"engine options {asked} are not ported yet (later slices "
                "of the port serve them)"
            )
        check_dense(cfg, params)
        self.device = resolve_device(device)
        self.params = _tree_to(params, self.device)
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.page_size = page_size
        self.max_pages_per_slot = -(-max_len // page_size)
        self.n_pages = n_pages or default_n_pages(max_batch, max_len, page_size)
        if self.n_pages < 2:
            raise ValueError("need at least the scratch page and one real page")
        self.fused_steps = max(1, fused_steps)
        self.kv_int8 = kv_int8
        self.paged_kernel = paged_kernel
        self.kv = make_kv_pool(cfg, self.n_pages, page_size, self.device, int8=kv_int8)
        self.free_pages = list(range(self.n_pages - 1, SCRATCH_PAGE, -1))
        self.tables = np.zeros((max_batch, self.max_pages_per_slot), np.int32)
        self.slot_pages: list[list[int]] = [[] for _ in range(max_batch)]
        self.lengths = np.zeros(max_batch, np.int32)
        self.slots: list[Optional[Request]] = [None] * max_batch
        self.prompts = np.zeros((max_batch, max_len), np.int32)
        self.prompt_lens = np.zeros(max_batch, np.int32)
        self.temps = np.zeros(max_batch, np.float32)
        self.top_ks = np.zeros(max_batch, np.int32)
        self.top_ps = np.ones(max_batch, np.float32)
        # chunked prefill: a slot mid-way through its prompt ingests one
        # chunk per engine step (``_continue_prefills``) and stays out of
        # the decode chunks until its last pass emits
        self.prefill_chunk = max(0, prefill_chunk)
        self.prefilling = np.zeros(max_batch, bool)
        self.next_token = np.zeros(max_batch, np.int32)
        self.emitted = np.zeros(max_batch, np.int32)
        self.stalled = np.zeros(max_batch, bool)  # couldn't get pages
        # generated tokens already in the FED prompt (a spilled-and-resumed
        # request re-prefills prompt + output so far)
        self.gen_before = np.zeros(max_batch, np.int32)
        self.priorities = np.zeros(max_batch, np.int32)
        self.queue: "queue.PriorityQueue" = queue.PriorityQueue()
        self._submit_seq = itertools.count()
        self.spills = 0
        self.draining = False
        self._work = threading.Event()  # set on enqueue: wakes an idle loop
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(0)
        self.steps_run = 0  # fused decode chunks dispatched
        self.prefills_run = 0  # prompt-ingest dispatches
        self.tokens_emitted = 0
        # prefix cache: refcounts per page, the digest chain's entries,
        # and an LRU clock over cached pages
        self.prefix_cache = prefix_cache
        self.page_ref = np.zeros(self.n_pages, np.int32)
        self.prefix_entries: dict[bytes, int] = {}  # key → page id
        self.page_key: dict[int, bytes] = {}  # page id → key (for eviction)
        self.page_lru: dict[int, int] = {}
        self._lru_clock = 0
        self.prefix_hit_tokens = 0
        # admission outcomes (a hit attaches at least one full page)
        self.prefix_lookups = 0
        self.prefix_admission_hits = 0

    # -- public API ----------------------------------------------------------

    def submit(self, req: Request) -> Request:
        """Validate and enqueue; an invalid request is failed at once
        (req.error set, done signalled)."""
        if self.draining:
            req.error = DRAINING_ERROR
            req.done.set()
            return req
        err = self._invalid_reason(req)
        if err is not None:
            req.error = err
            req.done.set()
            return req
        if req.max_new_tokens <= 0:
            req.done.set()  # nothing to generate
            return req
        self._enqueue(req)
        return req

    def _invalid_reason(self, req: Request) -> Optional[str]:
        if len(req.prompt) < 1:
            return "empty prompt"
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            return (
                f"prompt {len(req.prompt)} + max_new_tokens "
                f"{req.max_new_tokens} exceeds max_len {self.max_len}"
            )
        if isinstance(req.priority, bool) or not isinstance(req.priority, int):
            return "priority must be an integer"
        return None

    def _enqueue(self, req: Request) -> None:
        """Priority-ordered admission (also the spill-requeue path)."""
        if req.t_submit == 0.0:
            req.t_submit = time.monotonic()
        self.queue.put((-req.priority, next(self._submit_seq), req))
        self._work.set()

    def queue_depths(self) -> dict[int, int]:
        with self.queue.mutex:
            snapshot = [item[2] for item in self.queue.queue]
        out: dict[int, int] = {}
        for r in snapshot:
            out[r.priority] = out.get(r.priority, 0) + 1
        return out

    def run_until_idle(self, max_steps: int = 10_000) -> None:
        """Drive fused chunks until no request is active or queued."""
        for _ in range(max_steps):
            self._admit()
            if not any(s is not None for s in self.slots):
                if self.queue.empty():
                    return
                continue
            self.step()
        raise RuntimeError("run_until_idle: step budget exhausted")

    def step(self) -> None:
        """One engine step: every mid-chunked-prefill slot ingests one
        chunk, then one fused decode chunk runs for every other runnable
        slot, dispatched and then drained (the sequential loop)."""
        self._continue_prefills()
        pending = self._dispatch_chunk()
        if pending is not None:
            self._drain_chunk(pending)

    # -- engine internals ----------------------------------------------------

    def _stops(self, req: Request, tok: int) -> bool:
        return tok in req.stop_tokens

    def _emit(self, req: Request, tok: int) -> None:
        """Deliver one token.  A raising user callback must never unwind
        into the engine loop: log it and stop streaming that request."""
        self.tokens_emitted += 1
        req.output.append(tok)
        if req.on_token is not None:
            try:
                req.on_token(tok)
            except Exception:
                log.warning(
                    "on_token callback raised; streaming disabled for this "
                    "request", exc_info=True,
                )
                req.on_token = None

    def _admit(self) -> None:
        # while a stalled slot outranks the queue's best, admitting lower
        # classes would re-trigger the spill they were evicted by
        stalled_pris = [
            int(self.priorities[i]) for i in range(self.max_batch)
            if self.slots[i] is not None and self.stalled[i]
        ]
        stall_floor = max(stalled_pris) if stalled_pris else None
        for i in range(self.max_batch):
            if self.slots[i] is not None:
                continue
            try:
                neg, seq, req = self.queue.get_nowait()
            except queue.Empty:
                return
            if stall_floor is not None and req.priority < stall_floor:
                self.queue.put((neg, seq, req))  # keeps its FIFO position
                return
            if req.cancelled:
                req.done.set()
                continue
            # fed prompt: the prompt plus, for a spilled request, its
            # output so far (positions unchanged: an exact resume)
            fed = list(req.prompt) + list(req.output)
            if req.t_admit == 0.0:
                req.t_admit = time.monotonic()
            self.slots[i] = req
            self.prompts[i, : len(fed)] = fed
            self.prompt_lens[i] = len(fed)
            self.next_token[i] = fed[0]
            self.gen_before[i] = len(req.output)
            self.priorities[i] = req.priority
            self.temps[i] = req.temperature
            self.top_ks[i] = req.top_k
            self.top_ps[i] = req.top_p
            self.emitted[i] = int(self.gen_before[i])
            self.stalled[i] = False
            # no page zeroing: the position mask only exposes positions
            # <= length, all of which the new tenant rewrites
            matched = self._match_prefix(i) if self.prefix_cache else 0
            if self.prefix_cache:
                self.prefix_lookups += 1
                if matched:
                    self.prefix_admission_hits += 1
            self.lengths[i] = matched
            if matched:
                self.next_token[i] = int(self.prompts[i, matched])
            self._try_prefill(i, req)

    def _match_prefix(self, i: int) -> int:
        """Attach cached pages matching the fed prompt's leading full pages
        (capped at plen - 1, so at least one prompt token runs through
        the model for the first logits).  Returns the tokens matched."""
        ps = self.page_size
        plen = int(self.prompt_lens[i])
        key = _prefix_seed(0)
        row = self.prompts[i]
        matched_pages = 0
        for j in range(self.max_pages_per_slot):
            end = (j + 1) * ps
            if end > plen - 1:
                break
            key = _prefix_page_key(key, row[j * ps:end])
            pg = self.prefix_entries.get(key)
            if pg is None:
                break
            self.tables[i, j] = pg
            self.slot_pages[i].append(pg)
            self.page_ref[pg] += 1
            self._touch(pg)
            matched_pages += 1
        self.prefix_hit_tokens += matched_pages * ps
        return matched_pages * ps

    def _touch(self, pg: int) -> None:
        self._lru_clock += 1
        self.page_lru[pg] = self._lru_clock

    def _register_prompt_pages(self, i: int, req: Request) -> None:
        """On release: publish the slot's pages fully covered by the
        prompt AND by the written length (a request cancelled mid-prompt
        never wrote the rest) into the prefix cache.  A page whose content
        is already cached under another page stays unregistered and is
        freed normally."""
        ps = self.page_size
        plen = min(len(req.prompt), int(self.lengths[i]))
        key = _prefix_seed(0)
        # the same int32 byte layout _match_prefix hashes
        ptoks = np.asarray(req.prompt[:plen], np.int32)
        for j, pg in enumerate(self.slot_pages[i]):
            end = (j + 1) * ps
            if end > plen:
                break
            key = _prefix_page_key(key, ptoks[j * ps:end])
            existing = self.prefix_entries.get(key)
            if existing is None:
                self.prefix_entries[key] = pg
                self.page_key[pg] = key
                self._touch(pg)
            elif existing == pg:
                self._touch(pg)  # a shared page matched at admission

    def _prefill_dispatch(self, i: int, t0: int, n: int) -> torch.Tensor:
        """One prefill pass over fed tokens t0..t0+n-1 (pages must cover
        them); returns the last real position's logits (V,).  t0 == 0 is
        the plain one-pass prefill (K1 on CUDA); t0 > 0 runs behind the
        pages already written (K3 on CUDA).  The length pads to a power of
        two (from 8), the table row to a power of two of pages covering
        t0 + n, so the prefixed pass's attention follows the live prompt
        length, not max_len."""
        tpad = 8
        while tpad < n:
            tpad *= 2
        tpad = min(tpad, self.max_len)
        need_pages = -(-(t0 + n) // self.page_size)
        pbucket = 1
        while pbucket < need_pages:
            pbucket *= 2
        pbucket = min(pbucket, self.max_pages_per_slot)
        row = torch.tensor(self.tables[i, :pbucket], device=self.device)
        toks = np.zeros((1, tpad), np.int32)
        toks[0, :n] = self.prompts[i, t0:t0 + n]
        toks = torch.tensor(toks, device=self.device)
        if t0 == 0:
            logits, self.kv = _paged_prefill(
                self.params, toks, self.kv, row, n, cfg=self.cfg, page_size=self.page_size,
            )
        else:
            logits, self.kv = _paged_prefill_prefixed(
                self.params, toks, self.kv, row, t0, n, cfg=self.cfg,
                page_size=self.page_size,
            )
        self.prefills_run += 1
        return logits

    def _try_prefill(self, i: int, req: Request) -> None:
        """Ingest the (rest of the) prompt in one pass when pages are
        available; otherwise (or for a one-token remainder) leave the slot
        to the fused chunks' incremental prompt feeding.  A prefix-cache
        hit skips the matched tokens.  With ``prefill_chunk`` C, a
        remainder longer than C + 1 ingests C tokens without emitting and
        the slot stays ``prefilling`` (``_continue_prefills`` goes on)."""
        plen = int(self.prompt_lens[i])
        t0 = int(self.lengths[i])  # prefix-cache hit or chunks ingested so far
        rem = plen - t0
        C = self.prefill_chunk
        if C > 0 and rem - 1 > C:
            self.prefilling[i] = True
            if not self._ensure_pages(i, t0 + C):
                return  # pool pressure: retried next engine step
            self._prefill_dispatch(i, t0, C)  # logits discarded
            self.lengths[i] = t0 + C
            return
        if rem < 2 or not self._ensure_pages(i, plen):
            return
        self.prefilling[i] = False  # the final (or only) pass emits below
        logits = self._prefill_dispatch(i, t0, rem)
        if req.temperature > 0:
            tok = int(sample_static(
                logits[None], self.generator, temperature=req.temperature,
                top_k=req.top_k, top_p=req.top_p,
            )[0])
        else:
            tok = int(torch.argmax(logits))
        self._emit(req, tok)
        self.emitted[i] = int(self.gen_before[i]) + 1
        self.lengths[i] = plen
        self.next_token[i] = tok
        if self._stops(req, tok) or self.emitted[i] >= req.max_new_tokens or req.cancelled:
            req.done.set()
            self._release_slot(i)

    def _alloc_page(self) -> Optional[int]:
        """A free page, else (prefix cache) the least recently used cached
        page nobody references, evicted from the cache; None when the
        pool is exhausted."""
        if self.free_pages:
            return self.free_pages.pop()
        if self.prefix_cache:
            candidates = [pg for pg in self.page_key if self.page_ref[pg] == 0]
            if candidates:
                pg = min(candidates, key=lambda p: self.page_lru.get(p, 0))
                key = self.page_key.pop(pg)
                self.prefix_entries.pop(key, None)
                self.page_lru.pop(pg, None)
                return pg
        return None

    def _ensure_pages(self, i: int, upto: int) -> bool:
        """Grow slot i's pages to cover positions < upto.  False (partial
        growth kept) on pool exhaustion — the slot stalls."""
        upto = min(upto, self.max_len)
        need = -(-upto // self.page_size)
        while len(self.slot_pages[i]) < need:
            pg = self._alloc_page()
            if pg is None:
                return False
            self.tables[i, len(self.slot_pages[i])] = pg
            self.slot_pages[i].append(pg)
            self.page_ref[pg] += 1
        return True

    def _free_slot_pages(self, i: int) -> None:
        """Drop slot i's references; a page nobody references goes back to
        the free list unless the prefix cache holds it."""
        for pg in reversed(self.slot_pages[i]):
            self.page_ref[pg] -= 1
            if self.page_ref[pg] <= 0 and pg not in self.page_key:
                self.free_pages.append(pg)

    def _clear_slot(self, i: int) -> None:
        self.slot_pages[i] = []
        self.tables[i, :] = SCRATCH_PAGE
        self.slots[i] = None
        self.stalled[i] = False
        self.prefilling[i] = False
        self.gen_before[i] = 0
        self.priorities[i] = 0

    def _release_slot(self, i: int) -> None:
        req = self.slots[i]
        if self.prefix_cache and req is not None and not req.error:
            self._register_prompt_pages(i, req)
        self._free_slot_pages(i)
        self._clear_slot(i)

    def _force_drop_slot(self, i: int) -> None:
        """Last-resort teardown for the serving loop's failure path: frees
        the slot's pages without prefix-cache registration and never
        raises (a half-released slot must not keep live pages attached)."""
        try:
            self._free_slot_pages(i)
        except Exception:
            log.exception("page cleanup for slot %d failed; pages leak", i)
        self._clear_slot(i)

    def _prepare_step(self, lookahead: int):
        """Release cancelled slots, grow live slots' pages to cover
        ``lookahead`` more positions, spill for a stalled higher class,
        raise when every live slot is stalled, and build the power-of-two
        table view with inactive rows on the scratch page.  Returns
        (active, view) or None when no slot is runnable."""
        B = self.max_batch
        while True:
            active = np.zeros(B, bool)
            for i, req in enumerate(self.slots):
                if req is None:
                    continue
                if req.cancelled:
                    req.done.set()
                    self._release_slot(i)
                    continue
                if self.prefilling[i]:
                    # mid-chunked-prefill: fed by _continue_prefills, never
                    # by a decode chunk.  A pool-pressure stall it recorded
                    # may be stale after a spill freed pages: clear it iff
                    # the FULL next-pass target is grantable, and never by
                    # taking pages a higher-priority stalled slot awaits
                    if self.stalled[i]:
                        hp = max(
                            (int(self.priorities[j]) for j, r in enumerate(self.slots)
                             if r is not None and self.stalled[j] and j != i),
                            default=None,
                        )
                        if hp is not None and hp > int(self.priorities[i]):
                            continue  # yield the freed pages upward
                        t0 = int(self.lengths[i])
                        plen = int(self.prompt_lens[i])
                        C = self.prefill_chunk
                        target = t0 + C if C > 0 and (plen - t0) - 1 > C else plen
                        if self._ensure_pages(i, target):
                            self.stalled[i] = False
                    continue
                if self._ensure_pages(i, int(self.lengths[i]) + lookahead):
                    active[i] = True
                    self.stalled[i] = False
                else:
                    self.stalled[i] = True
            if self.stalled.any() and self._maybe_spill():
                continue  # freed a lower-priority slot's pages; rescan
            if not active.any():
                if self.stalled.any():
                    raise RuntimeError(
                        f"page pool exhausted: {int(self.stalled.sum())} slots "
                        f"stalled, 0 runnable (pool {self.n_pages - 1} pages)"
                    )
                return None
            break
        need = max(len(self.slot_pages[i]) for i in range(B) if active[i])
        bucket = 1
        while bucket < need:
            bucket *= 2
        bucket = min(bucket, self.max_pages_per_slot)
        view = self.tables[:, :bucket].copy()
        view[~active] = SCRATCH_PAGE
        return active, view

    def _maybe_spill(self) -> bool:
        """Spill ONE slot of a class strictly below the neediest stalled
        slot's (ties: the one holding most pages); its request requeues
        and resumes exactly.  True if a slot was spilled."""
        stalled_pri = [
            int(self.priorities[i]) for i in range(self.max_batch)
            if self.stalled[i] and self.slots[i] is not None
        ]
        if not stalled_pri:
            return False
        need = max(stalled_pri)
        victims = [
            i for i, req in enumerate(self.slots)
            if req is not None and int(self.priorities[i]) < need
        ]
        if not victims:
            return False
        v = min(victims, key=lambda i: (int(self.priorities[i]), -len(self.slot_pages[i])))
        req = self.slots[v]
        log.info(
            "page pressure: spilling priority-%d slot %d (%d pages) for a "
            "priority-%d request", int(self.priorities[v]), v,
            len(self.slot_pages[v]), need,
        )
        self.spills += 1
        self._release_slot(v)
        self._enqueue(req)
        return True

    def _continue_prefills(self) -> bool:
        """Advance every mid-chunked-prefill slot by one chunk.  Returns
        True if any slot made progress."""
        progressed = False
        for i, req in enumerate(self.slots):
            if req is None or not self.prefilling[i]:
                continue
            if req.cancelled:
                req.done.set()
                self._release_slot(i)
                progressed = True
                continue
            before = int(self.lengths[i])
            self._try_prefill(i, req)
            if not self.prefilling[i] or int(self.lengths[i]) > before:
                progressed = True
                self.stalled[i] = False
            else:
                self.stalled[i] = True  # pool-pressure stall; retried
        return progressed

    def _dispatch_chunk(self) -> Optional[_PendingChunk]:
        """Prepare and run one fused decode chunk; returns the record to
        drain, or None when nothing is runnable.  Host ``lengths`` advance
        by K for active slots (data-independent)."""
        K = self.fused_steps
        prepared = self._prepare_step(K)
        if prepared is None:
            return None
        self.steps_run += 1
        active, view = prepared
        use_filters = bool(
            (self.top_ks[active] > 0).any() or (self.top_ps[active] < 1.0).any()
        )
        use_temp = bool((self.temps[active] > 0).any())

        def dev(a):
            return torch.tensor(a, device=self.device)

        sampled, self.kv, _, _ = _fused_serve_chunk(
            self.params, self.kv, dev(view), dev(self.next_token), dev(self.lengths),
            dev(active), dev(self.prompts), dev(self.prompt_lens), dev(self.temps),
            dev(self.top_ks), dev(self.top_ps), self.generator,
            cfg=self.cfg, page_size=self.page_size, n_steps=K,
            use_filters=use_filters, use_temp=use_temp, paged_kernel=self.paged_kernel,
        )
        pos0 = self.lengths.copy()
        idx = np.nonzero(active)[0]
        self.lengths[idx] += K
        pairs = [(int(i), self.slots[int(i)]) for i in idx]
        return _PendingChunk(out=sampled, n_steps=K, pos0=pos0, pairs=pairs)

    def _drain_chunk(self, pending: _PendingChunk) -> None:
        """Bring a chunk's sampled tokens to the host and emit them."""
        sampled = pending.out.cpu().numpy()  # (B, K)
        K = pending.n_steps
        for i, req in pending.pairs:
            if self.slots[i] is not req or req.done.is_set():
                continue  # released since dispatch
            pos = int(pending.pos0[i])
            plen = int(self.prompt_lens[i])
            stopped = False
            for s in range(K):
                # step s sampled at position pos+s: a real emission iff at
                # or past the last prompt token
                if pos + s >= plen - 1 and self.emitted[i] < req.max_new_tokens:
                    tok = int(sampled[i, s])
                    self._emit(req, tok)
                    self.emitted[i] += 1
                    if self._stops(req, tok):
                        stopped = True  # samples past the stop are dropped
                        break
            self.next_token[i] = (
                self.prompts[i, pos + K] if pos + K < plen else sampled[i, K - 1]
            )
            if stopped or self.emitted[i] >= req.max_new_tokens or req.cancelled:
                req.done.set()
                self._release_slot(i)
