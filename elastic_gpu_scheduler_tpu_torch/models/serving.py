"""Continuous-batching inference engine: paged KV cache + fused decode.

Counterpart of ``elastic_gpu_scheduler_tpu/models/serving.py``.  Requests
join and leave a fixed-shape batch between fused decode chunks:

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
- **Overlapped pipeline** (``overlap``, the default): chunk N+1 is
  dispatched off device-resident batch state (``_DeviceBatchState``) and
  the chunk-to-chunk carry before chunk N's tokens drain, so host
  bookkeeping runs while the device computes.  On CUDA each dispatch
  replays a CUDA graph of ``_fused_serve_chunk`` (the counterpart of the
  reference's one jitted executable per chunk), host-to-device refreshes
  go through pinned staging buffers, and a drain waits on its own
  chunk's event only.  Every pool write (prefill, chunks, verify passes,
  carry patches) goes on one stream, so a page that the drain of chunk N
  frees and a new prefill reuses is written after chunk N+1's overshoot.
  ``overlap=False`` is the exact sequential loop (eager on CUDA).
- **Speculative decoding** (``spec_k`` > 0): steps where some greedy
  slot generates run one wide verify pass (``_fused_verify_chunk``: the
  W = spec_k + 1 query form of kernel K2 on CUDA) over drafts from
  prompt lookup (``models/speculative.propose_ngram``) or from a small
  draft model (``draft``), accepting per slot the longest prefix the
  model itself would have produced plus its own next token: greedy
  output equals the non-speculative engine's.
- **Per-request controls**, applied as the reference applies them in
  every sampling distribution (the decode chunk, the verify pass and the
  admission prefill): ``logit_bias`` and ``allowed_tokens`` through
  per-slot device-resident bias rows (``_bias_row``), ``min_tokens``
  through a stop-id suppression row gated per step (``_stop_row``), the
  frequency and presence penalties through a count carry started from the
  host's counts (``_host_counts``; a batch holding a penalised request
  takes the sequential loop), per-request ``seed`` draws keyed by (seed,
  position) (``sampling.seeded_uniforms``), and ``logprobs``: the chosen
  token's log-probability and the top ``logprobs_k`` of every step's
  distribution.  ``max_queue`` bounds the admission queue
  (``QUEUE_FULL_ERROR``).
- **MoE** (``cfg.n_experts`` > 0): every paged path runs the drop-free
  top-1 expert FFN (``_moe_ffn_serve``), its three expert products
  through kernel KE on CUDA (``ops/expert_matmul``), which finds each
  expert's tokens on the device, so a captured decode chunk replays for
  any routing.
- **int8 weights** (a tree from ``quantize.quantize_params``): every
  product with an int8 weight goes through ``quantize.wmatmul`` (kernel
  KE on CUDA, the weight read as int8 and dequantised in registers); an
  int8 embedding table is gathered, then dequantised.
- **Multi-LoRA serving** (``adapters``): named adapters stacked into one
  bank per weight family (``build_lora_bank``, id 0 the all-zero base
  adapter); ``Request.adapter`` picks one, and every projection of every
  paged path adds its own row's delta (``_sproj``), so requests on
  different adapters share one batch and one graph.  Each chunk or pass
  gathers its rows' factors once (``adapter_rows``).  The prefix cache's
  digest chain is seeded with the adapter id, so pages cached under one
  adapter never match another's prompts.
- **Disaggregated serving data plane** (``utils/kvwire``): four
  engine-thread primitives, reached from other threads through
  ``run_verb`` (a task drained at the top of every ``_admit``):
  ``export_prefix_pages`` (cached prefix pages as a wire
  bundle: one ``index_select`` and one device-to-host copy per pool key,
  on the engine's stream, so behind any chunk in flight),
  ``import_pages`` (a bundle's pages into free pool pages, written in
  place with ``index_copy_`` from one host-to-device copy per pool key,
  so captured decode graphs keep reading the same storage; registered in
  the prefix cache under this engine's chain), ``migrate_out_bundle``
  (a live slot detached into a ``kind="session"`` bundle through
  ``evict_slot``) and ``resume_session`` (the shipped request requeued;
  admission matches the imported pages and re-prefills only the tail).
  The payload is the reference's: per page, each pool key's
  (L, page_size, Hkv, Dh) (scales: (L, page_size, Hkv)) bytes, keys in
  ``_pool_keys()`` order, so bundles cross between the two
  implementations.
- **Tracing** (``tracing``): a request carrying a span context
  (``Request.trace_ctx``, set by the HTTP front end) gets an
  ``engine.queued`` point at every enqueue (``resumed`` after a spill) and
  an ``engine.admitted`` point at every admission, from the engine
  thread; ``t_submit`` / ``t_admit`` keep the first enqueue and the first
  admission, so the queue wait a client saw survives a spill.

The step functions run under ``torch.inference_mode()``: serving
parameters that require grad (a model fresh from ``models/train.py``)
builds no autograd graph.

A slot that cannot get pages stalls (state intact) until completions free
some; a higher-priority stalled slot spills a lower-priority one (its
request requeues and resumes exactly); if every slot is stalled the engine
raises "page pool exhausted".

- **Serving on a mesh** (``mesh``: a connected ``parallel/mesh.Mesh``,
  one process a rank): every rank runs this engine whole, on its slice of
  the weights (``sharding.serving_specs``: cut over ``tensor`` and
  ``expert``, every other axis replicated, so each rank of those computes
  the whole batch; attention leaves cut only when ``tensor`` divides both
  head counts) and of the pool (its kv heads, pages whole, so tables stay
  host-side and unchanged).  Column-parallel ``wq`` / ``wk`` / ``wv`` /
  ``w_gate`` / ``w_in`` give a rank its heads or its F columns; ``wo`` and
  ``w_out`` are row-parallel, their partial outputs summed in fp32 by one
  ``all_reduce`` over ``tensor`` and rounded once before the residual add
  (a LoRA delta joins it: a column-parallel family takes B's columns, a
  row-parallel one A's rows).  The embedding is vocab-parallel (a masked local lookup, an
  ``all_reduce``), the unembed column-parallel (the local V/T columns,
  then an ``all_gather``), so every rank reads the same logits.  K1, K2,
  K3 and the int8 pool's scales work on the rank's heads; MoE runs the
  router whole, KE on the rank's E/expert experts (foreign ids are zero
  rows) and F/tensor columns, and one fp32 ``all_reduce`` over (``expert``,
  ``tensor``) before the probability.  The draft model and its cache are
  whole on every rank.

  One host decision point, mirrored host state: rank 0 takes the
  requests (``submit``) and the cancellations (``Request.cancel``), and
  at every round hands the ranks a ticket (``exchange_ticket``: the
  requests submitted since the last one with every field, the
  cancellations, the drain and stop flags, over the mesh's gloo object
  group); every rank applies it and runs the same admission and step.
  The device results host logic reads are the same bytes on every rank
  (the logits leave through a collective, every generator is seeded
  alike), so the mirrors never part.  Followers run ``follow()`` until the
  stop ticket (``stop_followers``).  After a fault on a mirrored engine
  the ranks' states may have parted: ``fail_mirrored`` fails every waiting
  request and every later submit (``ENGINE_FAILED_ERROR``), and sends no
  ticket.  A gloo collective cannot sit in a CUDA graph, and an NCCL
  collective over ranks of several cards is untried in one: wherever the
  ``tensor`` x ``expert`` group spans more than one rank, over either
  backend, the overlapped loop runs its chunks eagerly, decided at
  construction.

  The disaggregated verbs ride the tickets too: a verb is a task of plain
  data (``_Task``: the verb, its arguments, what rank 0 decided for it),
  which rank 0's handlers queue (``run_verb``; a direct call on rank 0
  sends a ticket of its own) and every rank runs at the top of its next
  ``_admit``, in ticket order.  A bundle holds whole heads whatever the
  mesh: where the pool holds a rank's heads, an export gathers each page's
  heads over ``tensor`` before rank 0 joins the bytes, and an import writes
  each rank's own heads of the whole-head pages the ticket carries.  A
  bundle's geometry and a session's fields are refused on rank 0 before
  the ticket, so a refusal lands nothing anywhere; a follower's own call
  of a verb is refused by name.

- **Warm start** (``compile_cache``: a ``compilecache.CompileCache``):
  the kernel library is built or loaded through it (``ops/_build``), and
  ``compilecache.warmup_engine`` walks ``aot_signatures`` (every prefill,
  decode and verify shape of the engine's lattice) before the replica
  reports ready, so no request captures a graph.  Each decode chunk's
  CUDA graph is found through the engine's own memory-only cache
  (``graph_cache``, through ``compilecache.aot``), with or without one.
  A mirrored engine warms the same lattice: each point is a task (verb
  ``warm``) that rank 0's ticket carries, every rank runs it in the same
  round, and the ranks then agree that it ran everywhere with their
  mirrors intact, or all raise (``_warm_task``).
"""

from __future__ import annotations

import functools
import gc
import hashlib
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

from ..compilecache import AotFunction, CompileCache
from ..ops import _build
from ..ops.attention import NEG_INF, flash_attention
from ..ops.expert_matmul import expert_matmul
from ..ops.paged_attention import dequant, paged_attention
from ..tracing import TRACER
from ..utils import kvwire, prefixdigest
from ..parallel.collectives import all_gather, all_gather_object, all_reduce, broadcast_object
from .generate import cached_attention, cached_attention_multi
from .quantize import is_qtensor, wmat, wmatmul
from .sampling import categorical, sample_batched, sample_static
from .transformer import (
    TransformerConfig,
    _embed_lookup,
    _rope_tables,
    layer_slice,
    repeat_kv,
    resolve_device,
    rms_norm,
    torch_dtype,
)

# structured rejection sentinels: the HTTP layer maps them to 503 / 429
DRAINING_ERROR = "server draining"
QUEUE_FULL_ERROR = "admission queue full"
ENGINE_FAILED_ERROR = "engine on a mesh failed: the replica is stopping"

log = logging.getLogger("tpu-scheduler")

SCRATCH_PAGE = 0  # reserved; inactive slots write here, nobody reads it

# -- paged KV pool -----------------------------------------------------------


def make_kv_pool(cfg: TransformerConfig, n_pages: int, page_size: int, device,
                 int8: bool = False, kv_heads: int = 0) -> dict:
    """Pool {"k", "v"} of shape (L, P, page_size, Hkv, Dh) in the compute
    dtype, or int8 with {"ks", "vs"} (L, P, page_size, Hkv) fp32 scales.
    ``kv_heads`` > 0: a rank's share of the heads (Hkv / tensor)."""
    shape = (cfg.n_layers, n_pages, page_size, kv_heads or cfg.kv_heads, cfg.head_dim)
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
    adapter: str = ""  # "" → base model; else a name registered at init
    # generation stops when any of these ids is emitted (the stop token IS
    # included in the output); () → run to max_new_tokens
    stop_tokens: tuple = ()
    # streaming: called from the engine thread with each emitted token id
    on_token: Optional[object] = None
    # > 0: per emitted token, its logprob in ``token_logprobs`` and this
    # many top alternatives (id, logprob) in ``top_logprobs``, from the
    # distribution sampled from (after bias and penalties); clamped to the
    # engine's ``logprobs_k``
    logprobs: int = 0
    # OpenAI repetition penalties: logits -= frequency_penalty x count +
    # presence_penalty x (count > 0), counting GENERATED tokens only
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    # stop ids cannot be sampled (their logits sit at -1e9) until this many
    # tokens have been emitted; max_new_tokens still caps the total
    min_tokens: int = 0
    # sampling seed: draws keyed by (seed, position), the same whatever
    # the batch, slot, engine mode, restart or spill; None → engine stream
    seed: Optional[int] = None
    # non-empty: only these ids can be sampled (every other id at -1e9)
    allowed_tokens: tuple = ()
    # admission class (higher first, FIFO within a class); under page
    # pressure a stalled slot spills a strictly lower-priority one
    priority: int = 0
    # internal: times the serving loop evicted this request because every
    # slot stalled (a second eviction fails it)
    pool_spills: int = 0
    # the request's span context (``tracing``), set by the HTTP front end
    # from the client's traceparent: the engine thread drops its
    # engine.queued / engine.admitted points into that trace
    trace_ctx: Optional[object] = None
    # token id → additive logit bias, in every sampling distribution
    logit_bias: dict = field(default_factory=dict)
    done: threading.Event = field(default_factory=threading.Event)
    output: list[int] = field(default_factory=list)
    token_logprobs: list = field(default_factory=list)
    top_logprobs: list = field(default_factory=list)
    error: str = ""
    # the engine thread owns output/error/done; other threads read output
    # after done, and may only set ``cancelled`` (checked every chunk)
    cancelled: bool = False
    t_submit: float = 0.0  # first enqueue (monotonic)
    t_admit: float = 0.0  # first slot admission (monotonic)
    # set by a mirrored engine's ``submit`` (serving on a mesh): a cancel
    # is then asked for, and the next ticket cancels it on every rank
    mirrored: bool = False
    cancel_asked: bool = False
    ticket: int = -1  # its ticket id on a mirrored engine (-1: none)

    def cancel(self) -> None:
        """Stop generation at the next chunk boundary; any thread."""
        if self.mirrored:
            self.cancel_asked = True
        else:
            self.cancelled = True


# the fields a ticket carries of a request submitted on a mirrored engine
_TICKET_FIELDS = (
    "prompt", "max_new_tokens", "temperature", "top_k", "top_p", "adapter", "stop_tokens",
    "logprobs", "frequency_penalty", "presence_penalty", "min_tokens", "seed",
    "allowed_tokens", "priority", "pool_spills", "logit_bias", "output", "cancelled",
)
# ... and of a session a disaggregated task moves onto every rank (a resume,
# the requeue of a refused migration)
_SESSION_FIELDS = _TICKET_FIELDS + ("token_logprobs", "top_logprobs")


class MeshWarmupError(RuntimeError):
    """A warm-up point that failed on some rank of a mirrored engine (or
    after which the ranks' mirrors parted), raised on every rank."""


class _Task:
    """A disaggregated verb (export, import, migrate out or in, resume,
    requeue) or a warm-up point (warm) as plain data, ``verb`` and
    ``args``, which a ticket carries to every rank of a mirrored engine,
    and rank 0's own side of it:
    ``local`` (what stays on rank 0: the session's live Request, the
    migrate-out victim chooser) and the caller's outcome.  ``state``:
    queued, ticketed (it runs on every rank) or abandoned (it runs on
    none)."""

    def __init__(self, verb: str, args: dict, local: Optional[dict] = None):
        self.verb, self.args, self.local = verb, args, local or {}
        self.state = "queued"
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None

    def wire(self) -> dict:
        return {"verb": self.verb, "args": self.args}

    def outcome(self):
        if self.error is not None:
            raise self.error
        return self.result


# -- step functions ------------------------------------------------------------


def _rope_cs(positions, cfg):
    """rope's (cos, sin) for PER-ROW positions (B, T), each (B, T, 1,
    Dh / 2): computed once a step and shared by every layer's q and k."""
    cos, sin = _rope_tables(positions, cfg.head_dim // 2, cfg.rope_theta)
    return cos[:, :, None, :], sin[:, :, None, :]


def _rope_rows(x, cs):
    """rope with per-row tables ``cs`` (``_rope_cs``): x (B, T, H, Dh)."""
    cos, sin = cs
    x1, x2 = x.float().split(x.shape[-1] // 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def build_lora_bank(adapters: dict, dtype: torch.dtype, base_layers: Optional[dict] = None,
                    device=None) -> tuple[dict, dict]:
    """Stack named adapters (``models/lora.lora_init`` trees) into one
    gatherable bank per weight family, as the reference does:

        {family: {"a": (L, n_ids, d_in, r_max), "b": (L, n_ids, r_max, d_out)}}

    in ``dtype`` on ``device``.  Id 0 is the all-zero adapter (the base
    model; "" requests), ids 1.. follow the dict order.  Ranks are
    zero-padded to the family's maximum (padded rank columns contribute
    exact zeros) and each adapter's alpha/rank is folded into its b, as
    ``lora.inject_lora`` does.  ``base_layers`` (the model's layer tree)
    checks the shapes here, so an adapter trained against another base
    fails by name.  Returns (bank, name → id)."""

    def _base_shape(t):
        W = base_layers.get(t)
        if W is None:
            raise ValueError(f"adapter target {t!r} not in model layers")
        return tuple((W["q8"] if isinstance(W, dict) else W).shape)

    index = {"": 0}
    targets: dict[str, tuple] = {}
    for name, lo in adapters.items():
        if name == "" or name in index:
            raise ValueError(f"bad/duplicate adapter name {name!r}")
        index[name] = len(index)
        for t, ab in lo["adapters"].items():
            L, d_in, r = ab["a"].shape
            d_out = ab["b"].shape[-1]
            if base_layers is not None and _base_shape(t) != (L, d_in, d_out):
                raise ValueError(
                    f"adapter {name!r} target {t!r} has dims "
                    f"(L={L}, d_in={d_in}, d_out={d_out}) but the model's "
                    f"{t!r} is {_base_shape(t)} — this adapter was "
                    "trained against a different base"
                )
            prev = targets.get(t)
            if prev is not None and prev[:3] != (L, d_in, d_out):
                raise ValueError(
                    f"adapter {name!r} target {t!r} has dims "
                    f"(L={L}, d_in={d_in}, d_out={d_out}) but another "
                    f"adapter uses (L={prev[0]}, d_in={prev[1]}, "
                    f"d_out={prev[2]}) — all adapters must share one base"
                )
            targets[t] = (L, d_in, d_out, max(r, prev[3] if prev else 0))
    n = len(index)
    bank: dict = {}
    for t, (L, d_in, d_out, rmax) in targets.items():
        a = torch.zeros((L, n, d_in, rmax), dtype=torch.float32)
        b = torch.zeros((L, n, rmax, d_out), dtype=torch.float32)
        for name, lo in adapters.items():
            ab = lo["adapters"].get(t)
            if ab is None:
                continue
            r = ab["a"].shape[-1]
            scale = lo["alpha"] / lo["rank"]
            a[:, index[name], :, :r] = ab["a"].detach().float().cpu()
            b[:, index[name], :r, :] = ab["b"].detach().float().cpu() * scale
        bank[t] = {"a": a.to(device=device, dtype=dtype), "b": b.to(device=device, dtype=dtype)}
    return bank, index


def adapter_rows(bank: Optional[dict], aids) -> Optional[dict]:
    """Each batch row's adapter factors, gathered from ``bank`` by the
    adapter ids ``aids`` (B,) and widened to fp32: {family: {"a": (L, B,
    d_in, r), "b": (L, B, r, d_out)}}.  The ids do not change within a
    chunk or a pass, so its step functions gather once, not once a step
    and a layer.  None without a bank."""
    if not bank:
        return None
    return {t: {n: f.index_select(1, aids).float() for n, f in ab.items()}
            for t, ab in bank.items()}


def _sproj(x, p, name, dtype, ad=None):
    """``x @ p[name]`` (``quantize.wmatmul``: kernel KE for an int8 weight
    on CUDA), plus the per-row LoRA delta when ``ad`` (this
    layer's ``adapter_rows``) carries the family (reference ``_sproj``):
    ``t = x·a`` and ``t·b`` in fp32 (the reference's fp32-output products
    of the same operands), cast to y's dtype and added.  Every row applies
    its own request's adapter, so the batch never splits; a zero row (id
    0) adds exact zeros."""
    y = wmatmul(x, p[name], dtype)
    if ad and name in ad:
        t = torch.bmm(x.float(), ad[name]["a"])  # (B, T, r)
        y = y + torch.bmm(t, ad[name]["b"]).to(y.dtype)
    return y


def _experts(w, dtype) -> tuple:
    """An expert stack (E, K, N), dense (cast to ``dtype`` if it rests in
    another) or int8, as ``expert_matmul``'s (w, scale)."""
    return (w["q8"], w["scale"]) if is_qtensor(w) else (w.to(dtype), None)


def _moe_ffn_serve(h, p, dtype, cfg=None, mesh=None):
    """Drop-free top-1 MoE FFN for every paged path (reference
    ``_moe_ffn_serve``): a token's output never depends on which other
    requests share the batch, so engine outputs equal solo runs.

    The router ``xf @ wmat(moe_gate)`` in h's dtype, an fp32 softmax, the
    first maximum's expert and its probability; then the three expert
    products through ``expert_matmul`` (kernel KE on CUDA: each expert's
    tokens found on the device, the chosen experts' weights read in place,
    int8 ones as int8), ``w_out``'s with an fp32 output as the reference
    asks, times the probability in fp32, cast to h's dtype.  One form for
    every T: the reference's gather (T <= E) and ``ragged_dot`` forms
    compute the same function, and KE reads no host value, so a captured
    decode chunk replays for any routing.  On the CPU the plain version.

    On a mesh (``cfg`` and ``mesh`` given) a rank holds E/expert experts
    and F/tensor columns of each: its KE products take the local id (id -
    e0), so tokens routed to another rank's experts are zero rows, and the
    fp32 ``w_out`` output is summed over the axes the experts are cut on
    before the probability; each token has one non-zero expert term."""
    B, T, D = h.shape
    xf = h.reshape(B * T, D)
    glog = (xf @ wmat(p["moe_gate"], h.dtype)).float()
    probs = torch.softmax(glog, dim=-1)  # (T, E)
    idx = torch.argmax(probs, dim=-1)  # first max
    prob = probs.gather(-1, idx[:, None])  # (T, 1) fp32
    ids = idx.to(torch.int32)
    wg, sg = _experts(p["w_gate"], dtype)
    wi, si = _experts(p["w_in"], dtype)
    wo, so = _experts(p["w_out"], dtype)
    cut = ()
    if mesh is not None:
        E_local = wg.shape[0]
        if E_local < glog.shape[-1]:  # this rank's experts e0 .. e0 + E_local - 1
            ids = ids - mesh.axis_index("expert") * E_local
            cut += ("expert",)
        if wg.shape[-1] < cfg.d_ff:
            cut += ("tensor",)
    gate = F.silu(expert_matmul(xf, wg, ids, scale=sg, out_dtype=dtype))
    up = expert_matmul(xf, wi, ids, scale=si, out_dtype=dtype)
    out = expert_matmul(gate * up, wo, ids, scale=so, out_dtype=torch.float32)
    if cut:
        out = all_reduce(out, mesh, cut)
    return (out * prob).to(h.dtype).reshape(B, T, D)


def _row_parallel(x, p, name, dtype, ad, cut: bool, mesh):
    """``_sproj`` of a row-parallel weight (``wo``, ``w_out``).  Where its
    contraction dimension is cut over ``tensor``, each rank's product
    leaves in fp32 (its LoRA delta beside it), one ``all_reduce`` sums
    both, and each is rounded to ``dtype`` once, as one device rounds its
    whole product (a bf16 product rounded on each rank, then summed, would
    round twice more)."""
    if not cut:
        return _sproj(x, p, name, dtype, ad)
    y = wmatmul(x, p[name], dtype, torch.float32)
    if ad and name in ad:
        t = torch.bmm(x.float(), ad[name]["a"])
        both = all_reduce(torch.stack([y, torch.bmm(t, ad[name]["b"])]), mesh, "tensor")
        return both[0].to(dtype) + both[1].to(dtype)
    return all_reduce(y, mesh, "tensor").to(dtype)


def _embed_serve(embed, tokens, dtype, cfg, mesh=None):
    """The embedding lookup; vocab-parallel when this rank holds V/tensor
    rows: tokens outside them give exact zero rows, summed over
    ``tensor`` (one rank holds each token's row)."""
    rows = (embed["q8"] if is_qtensor(embed) else embed).shape[0]
    if mesh is None or rows == cfg.vocab_size:
        return _embed_lookup(embed, tokens, dtype)
    t = tokens.long() - mesh.axis_index("tensor") * rows
    inside = (t >= 0) & (t < rows)
    x = _embed_lookup(embed, t.clamp(0, rows - 1), dtype)
    return all_reduce(torch.where(inside[..., None], x, torch.zeros((), dtype=dtype,
                                                                     device=x.device)),
                      mesh, "tensor")


def _unembed(x, params, dtype, cfg, mesh=None):
    """Logits over the whole vocabulary in ``dtype``; column-parallel when
    this rank holds V/tensor columns, gathered over ``tensor``."""
    logits = wmatmul(x, params["unembed"], dtype)
    if mesh is not None and logits.shape[-1] < cfg.vocab_size:
        logits = all_gather(logits, mesh, "tensor", -1)
    return logits


def _paged_layer(x, p, lkv, cs, pidx, off, attn, cfg, dtype, ad=None, mesh=None):
    """ONE transformer layer shared by the paged paths (decode step,
    prefill and verify); they differ only in the rope tables ``cs`` of
    their positions (B, T) (``_rope_cs``), the scatter targets (B·T,) and
    ``attn(q, k, v, lkv)`` → (B, T, Hn·Dh).  ``ad``: this layer's slice
    of ``adapter_rows`` (None: the plain computation).

    On a mesh the leaves are this rank's slices: the head counts come
    from the local ``wq`` / ``wk`` widths, and ``wo`` / ``w_out`` outputs
    are summed over ``tensor`` where their heads or F are cut."""
    B, T, _ = x.shape
    Dh = cfg.head_dim
    h = rms_norm(x, p["attn_norm"])
    q = _sproj(h, p, "wq", dtype, ad)
    k = _sproj(h, p, "wk", dtype, ad)
    v = _sproj(h, p, "wv", dtype, ad)
    Hn, Hkv = q.shape[-1] // Dh, k.shape[-1] // Dh  # this rank's heads
    q = _rope_rows(q.reshape(B, T, Hn, Dh), cs)
    k = _rope_rows(k.reshape(B, T, Hkv, Dh), cs)
    v = v.reshape(B, T, Hkv, Dh)
    # inactive/padding rows target the scratch page
    _kv_write_rows(lkv, pidx, off, k.reshape(B * T, Hkv, Dh), v.reshape(B * T, Hkv, Dh))
    o = attn(q, k, v, lkv)
    x = x + _row_parallel(o, p, "wo", dtype, ad, Hn < cfg.n_heads, mesh)
    h = rms_norm(x, p["mlp_norm"])
    if cfg.n_experts > 0:
        # expert-stacked FFN weights take no adapter (build_lora_bank
        # refuses adapters against (E, D, F) shapes)
        return x + _moe_ffn_serve(h, p, dtype, cfg, mesh)
    gate = F.silu(_sproj(h, p, "w_gate", dtype, ad))
    up = _sproj(h, p, "w_in", dtype, ad)
    return x + _row_parallel(gate * up, p, "w_out", dtype, ad, gate.shape[-1] < cfg.d_ff,
                             mesh)


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
                       paged_kernel=False, ad=None, mesh=None):
    """One decode step for every slot at its own position.

    tokens: (B,) int32; kv: pool (``make_kv_pool``), updated in place;
    tables: (B, NB) int32 page ids; lengths: (B,) int32 write positions;
    ad: the rows' gathered adapter factors (``adapter_rows``) or None;
    mesh: the serving mesh (``params`` and ``kv`` this rank's slices).
    Returns (logits (B, V) float32, kv)."""
    dtype = torch_dtype(cfg.dtype)
    B = tokens.shape[0]
    x = _embed_serve(params["embed"], tokens, dtype, cfg, mesh)[:, None, :]  # (B, 1, D)
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
            return o.reshape(B, 1, -1)
        # position j of the gathered view IS token position j
        k_all, v_all = _kv_gather(lkv, tables, page_size, dtype)
        return cached_attention(
            q, k_all, v_all, lengths, window=cfg.window_size
        ).reshape(B, 1, -1)

    cs = _rope_cs(ln[:, None], cfg)
    for i in range(cfg.n_layers):
        x = _paged_layer(
            x, layer_slice(params["layers"], i), _layer_kv(kv, i), cs, page_idx, offset,
            attn, cfg, dtype, ad and layer_slice(ad, i), mesh,
        )
    x = rms_norm(x, params["final_norm"])
    logits = _unembed(x, params, dtype, cfg, mesh)[:, 0, :]
    return logits.float(), kv


@torch.inference_mode()
def _paged_prefill(params, tokens, kv, pages, t_real: int, *, cfg, page_size, bank=None,
                   aids=None, mesh=None):
    """One-pass prompt ingestion for ONE slot: causal self-attention over
    the whole (padded) prompt block, K/V scattered into the slot's pages.

    tokens: (1, Tpad); pages: (n,) the slot's table row; t_real: count of
    real tokens (padding K/V goes to the scratch page); bank / aids: the
    engine's adapter bank and the slot's adapter id (1,).  Returns (logits
    (V,) of the last real position, kv) — only that row is unembedded."""
    dtype = torch_dtype(cfg.dtype)
    Tpad = tokens.shape[1]
    dev = tokens.device
    x = _embed_serve(params["embed"], tokens, dtype, cfg, mesh)  # (1, Tpad, D)
    positions = torch.arange(Tpad, device=dev)
    col = torch.clamp(positions // page_size, max=pages.shape[0] - 1)
    pidx = torch.where(
        positions < t_real, pages.long()[col], torch.full_like(positions, SCRATCH_PAGE)
    )
    off = positions % page_size
    n_rep = cfg.n_heads // cfg.kv_heads  # a rank's heads keep the ratio

    def attn(q, k, v, lkv):
        # the prompt is the whole valid prefix: plain causal attention
        # within the block (padding sits after every real position)
        return flash_attention(
            q.transpose(1, 2),
            repeat_kv(k, n_rep).transpose(1, 2),
            repeat_kv(v, n_rep).transpose(1, 2),
            True, None, cfg.window_size,
        ).transpose(1, 2).reshape(1, Tpad, -1)

    cs = _rope_cs(positions[None, :], cfg)
    ad = adapter_rows(bank, aids)
    for i in range(cfg.n_layers):
        x = _paged_layer(
            x, layer_slice(params["layers"], i), _layer_kv(kv, i), cs, pidx, off, attn,
            cfg, dtype, ad and layer_slice(ad, i), mesh,
        )
    x = x[:, t_real - 1:t_real]  # (1, 1, D)
    x = rms_norm(x, params["final_norm"])
    logits = _unembed(x, params, dtype, cfg, mesh)[0, 0]
    return logits.float(), kv


@torch.inference_mode()
def _paged_prefill_prefixed(params, tokens, kv, pages, t0: int, t_real: int, *, cfg,
                            page_size, bank=None, aids=None, mesh=None):
    """One-pass prompt ingestion BEHIND pages already written (a
    prefix-cache hit, or a later chunk of a chunked prefill).

    Same contract as ``_paged_prefill`` (the adapter too) except the
    slot's pages already hold K/V for positions < t0: the new tokens sit
    at positions t0..t0+t_real-1, and attention gathers the slot's pages
    (dequantised when int8) so the queries see the cached prefix
    (``generate.cached_attention_multi``: kernel K3 on CUDA).  Padding
    rows write to the scratch page; their outputs are never consumed."""
    dtype = torch_dtype(cfg.dtype)
    Tpad = tokens.shape[1]
    dev = tokens.device
    x = _embed_serve(params["embed"], tokens, dtype, cfg, mesh)  # (1, Tpad, D)
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
        ).reshape(1, Tpad, -1)

    cs = _rope_cs(positions[None, :], cfg)
    ad = adapter_rows(bank, aids)
    for i in range(cfg.n_layers):
        x = _paged_layer(
            x, layer_slice(params["layers"], i), _layer_kv(kv, i), cs, pidx, off, attn,
            cfg, dtype, ad and layer_slice(ad, i), mesh,
        )
    x = x[:, t_real - 1:t_real]  # (1, 1, D)
    x = rms_norm(x, params["final_norm"])
    logits = _unembed(x, params, dtype, cfg, mesh)[0, 0]
    return logits.float(), kv


def _bias_row(req: Request, vocab_size: int) -> np.ndarray:
    """The additive logit row of a request's allowed_tokens + logit_bias:
    ONE construction for the admission prefill (added on the host) and
    the device-resident per-slot rows, so the two cannot part."""
    row = np.zeros(vocab_size, np.float32)
    for t, b in req.logit_bias.items():
        row[t] += b
    if req.allowed_tokens:
        # the whitelist dominates both ways: banned ids sit at a flat -1e9
        # whatever their bias, and an allowed id's bias is clamped above
        # -1e8, so no bias can push it beneath the banned set
        allowed_idx = np.asarray(req.allowed_tokens, np.int64)
        row[allowed_idx] = np.maximum(row[allowed_idx], -1e8)
        banned = np.ones(vocab_size, bool)
        banned[allowed_idx] = False
        row[banned] = -1e9
    return row


def _stop_row(req: Request, vocab_size: int) -> np.ndarray:
    """The min_tokens suppression row: -1e9 at the request's stop ids,
    added while the emitted count is below the floor.  Out-of-range ids
    are skipped: they can never be sampled, and ``_stops`` still honours
    them."""
    row = np.zeros(vocab_size, np.float32)
    ids = [t for t in req.stop_tokens if 0 <= t < vocab_size]
    if ids:
        row[np.asarray(ids, np.int64)] = -1e9
    return row


def _bias_row_cached(req: Request, vocab_size: int) -> np.ndarray:
    """``_bias_row`` memoised on the request: admission needs it twice
    (the slot's device row and the prefill's host add), and a spilled
    request re-admits with the same row."""
    row = getattr(req, "_bias_row_memo", None)
    if row is None or row.shape[0] != vocab_size:
        row = _bias_row(req, vocab_size)
        req._bias_row_memo = row
    return row


def _stop_row_cached(req: Request, vocab_size: int) -> np.ndarray:
    """``_stop_row`` memoised on the request (the same double use)."""
    row = getattr(req, "_stop_row_memo", None)
    if row is None or row.shape[0] != vocab_size:
        row = _stop_row(req, vocab_size)
        req._stop_row_memo = row
    return row


def _logprob_rows(logits, chosen, k: int):
    """(chosen_lp, top_ids int32, top_lps) of one step's logits (..., V)
    float32 and chosen ids (...): the log-softmax through one logsumexp,
    the top-k alternatives sharing its normaliser."""
    lse = torch.logsumexp(logits, dim=-1)
    chosen_lp = torch.gather(logits, -1, chosen.long()[..., None])[..., 0] - lse
    top = torch.topk(logits, k, dim=-1)
    return chosen_lp, top.indices.to(torch.int32), top.values - lse[..., None]


def _penalise(logits, cnt, fpens, ppens):
    """logits - fpen·cnt - ppen·(cnt > 0), per row (B, V)."""
    return logits - fpens[:, None] * cnt - ppens[:, None] * (cnt > 0)


@torch.inference_mode()
def _fused_serve_chunk(
    params, kv, tables, tokens, lengths, active, prompts, prompt_lens,
    temps, top_ks, top_ps, generator, bias=None, fpens=None, ppens=None, counts=None,
    seeds=None, seeded=None, stop_rows=None, min_toks=None, bank=None, aids=None,
    *, cfg, page_size, n_steps, use_filters, use_temp, paged_kernel=False,
    logprobs_k=0, use_pen=False, use_seed=False, use_min=False, mesh=None,
):
    """``n_steps`` decode iterations with sampling and prompt feeding on
    the device.  Returns (out, kv, next_tokens (B,), new_lengths (B,)):
    ``out`` is the sampled (B, n_steps), or with ``logprobs_k`` > 0 the
    tuple (sampled, chosen_lp (B, n_steps), top_ids (B, n_steps, k),
    top_lps (B, n_steps, k)).

    Step s feeds the token at position lengths+s and samples from its
    logits; the host decides afterwards which samples are real emissions
    (position >= prompt_len-1).  ``use_filters``: some row asks for
    top-k/top-p; ``use_temp``: some row samples (temperature > 0).

    The per-request controls, in the reference's order: ``bias`` (B, V)
    is added to every step's logits (a zero row is a bitwise no-op);
    ``use_min`` adds ``stop_rows`` at the steps whose emitted index
    lengths+1-prompt_lens is below ``min_toks``; ``use_pen`` counts the
    fed token when it is a generated one (on top of the host's
    ``counts``) and subtracts the penalties; ``use_seed`` draws the rows
    with ``seeded`` from (``seeds``, position lengths).

    ``bank`` / ``aids`` (B,): the adapter bank and each slot's adapter id,
    gathered once for the chunk's steps."""
    outs = []
    ad = adapter_rows(bank, aids)
    if use_pen:
        bidx = torch.arange(tokens.shape[0], device=tokens.device)
        cnt = counts.float()
    for _ in range(n_steps):
        logits, kv = _paged_decode_step(
            params, tokens, kv, tables, lengths, cfg, page_size, paged_kernel, ad, mesh
        )
        if bias is not None:
            logits = logits + bias
        if use_min:
            pre = (lengths + 1 - prompt_lens) < min_toks
            logits = logits + torch.where(pre[:, None], stop_rows, 0.0)
        if use_pen:
            gen = active & (lengths >= prompt_lens)
            cnt = cnt.index_put((bidx, tokens.long()), gen.float(), accumulate=True)
            logits = _penalise(logits, cnt, fpens, ppens)
        row_seeds = (seeds, seeded, lengths) if use_seed else None
        if use_filters:
            sampled = sample_batched(logits, generator, temps, top_ks, top_ps, row_seeds)
        else:
            sampled = torch.argmax(logits, dim=-1).to(torch.int32)
            if use_temp:
                scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
                temped = categorical(scaled, generator, row_seeds).to(torch.int32)
                sampled = torch.where(temps > 0, temped, sampled)
        new_len = lengths + active.to(torch.int32)
        in_prompt = new_len < prompt_lens
        nxt = torch.clamp(new_len, max=prompts.shape[1] - 1).long()
        prompt_next = torch.gather(prompts, 1, nxt[:, None])[:, 0]
        next_tok = torch.where(in_prompt, prompt_next, sampled)
        tokens = torch.where(active, next_tok, tokens)
        lengths = new_len
        outs.append((sampled, *_logprob_rows(logits, sampled, logprobs_k))
                    if logprobs_k > 0 else (sampled,))
    out = tuple(torch.stack(col, dim=1) for col in zip(*outs))
    return (out if logprobs_k > 0 else out[0]), kv, tokens, lengths


@torch.inference_mode()
def _chunk_in_place(params, kv, tables, tokens, lengths, *args, **static):
    """``_fused_serve_chunk`` with the carry written back IN PLACE: the
    chunk's final (tokens, lengths) land in the tensors it read, so the
    next chunk (or the next replay of a CUDA graph captured around this
    call) starts from them.  Returns the chunk's ``out``."""
    out, _, new_tok, new_len = _fused_serve_chunk(
        params, kv, tables, tokens, lengths, *args, **static
    )
    tokens.copy_(new_tok)
    lengths.copy_(new_len)
    return out


def _cached_attention_rows(q, cache_k, cache_v, starts, window: int = 0):
    """W-position attention against gathered pages with PER-ROW start
    positions (the batched form of ``generate.cached_attention_multi``).

    q: (B, W, Hn, Dh), row b's queries at global positions
    starts[b]..starts[b]+W-1; cache: (B, M, Hkv, Dh) with the W new K/V
    rows already written at those positions.  Causal: query t of row b
    sees key m iff m <= starts[b] + t; ``window`` > 0 adds sliding-window
    masking.  GQA by a grouped einsum (the cache is never expanded)."""
    B, W, Hn, Dh = q.shape
    M, Hkv = cache_k.shape[1], cache_k.shape[2]
    n_rep = Hn // Hkv
    qg = q.reshape(B, W, Hkv, n_rep, Dh).permute(0, 2, 3, 1, 4).float()  # (B,Hkv,r,W,Dh)
    kT = cache_k.transpose(1, 2).float()  # (B, Hkv, M, Dh)
    vT = cache_v.transpose(1, 2).float()
    s = torch.einsum("bgrtd,bgkd->bgrtk", qg, kT) * (Dh ** -0.5)
    qpos = starts.long()[:, None] + torch.arange(W, device=q.device)  # (B, W)
    kpos = torch.arange(M, device=q.device)
    keep = kpos[None, None, :] <= qpos[:, :, None]  # (B, W, M)
    if window > 0:
        keep = keep & ((qpos[:, :, None] - kpos[None, None, :]) < window)
    s = torch.where(keep[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrtk,bgkd->bgrtd", p, vT)  # (B, Hkv, r, W, Dh)
    return o.permute(0, 3, 1, 2, 4).reshape(B, W, Hn, Dh).to(q.dtype)


@torch.inference_mode()
def _verify_logits(params, kv, tables, feed, lengths, active, bank=None, aids=None, *, cfg,
                   page_size, paged_kernel=False, mesh=None):
    """The verify pass's forward: every slot's W fed tokens at positions
    lengths..lengths+W-1 through the model (each row under its adapter,
    ``bank`` / ``aids``), their K/V rows written into the pool (IN PLACE).
    Returns logits (B, W, V) float32.

    Positions past the table view's end, and inactive rows, write to the
    scratch page (their outputs are never consumed: the host caps
    acceptance)."""
    dtype = torch_dtype(cfg.dtype)
    B, W = feed.shape
    max_len = tables.shape[1] * page_size
    x = _embed_serve(params["embed"], feed, dtype, cfg, mesh)  # (B, W, D)
    positions = lengths.long()[:, None] + torch.arange(W, device=feed.device)  # (B, W)
    in_range = (positions < max_len) & active[:, None]
    page_of = torch.clamp(positions // page_size, 0, tables.shape[1] - 1)
    pidx = torch.where(
        in_range, torch.gather(tables.long(), 1, page_of),
        torch.full_like(positions, SCRATCH_PAGE),
    ).reshape(B * W)
    off = (positions % page_size).reshape(B * W)

    def attn(q, k, v, lkv):
        if paged_kernel:
            # the W-query form of K2: verify and decode share one attention
            # implementation, so a mixed greedy batch never mixes two
            return _paged_attn_call(q, lkv, tables, lengths, cfg, dtype).reshape(B, W, -1)
        k_all, v_all = _kv_gather(lkv, tables, page_size, dtype)
        return _cached_attention_rows(
            q, k_all, v_all, lengths, window=cfg.window_size
        ).reshape(B, W, -1)

    cs = _rope_cs(positions, cfg)
    ad = adapter_rows(bank, aids)
    for i in range(cfg.n_layers):
        x = _paged_layer(
            x, layer_slice(params["layers"], i), _layer_kv(kv, i), cs, pidx, off, attn,
            cfg, dtype, ad and layer_slice(ad, i), mesh,
        )
    x = rms_norm(x, params["final_norm"])
    return _unembed(x, params, dtype, cfg, mesh).float()


@torch.inference_mode()
def _fused_verify_chunk(
    params, kv, tables, feed, lengths, active, temps, top_ks, top_ps, generator,
    bias=None, fpens=None, ppens=None, counts=None, plens=None, seeds=None, seeded=None,
    stop_rows=None, min_toks=None, bank=None, aids=None,
    *, cfg, page_size, use_filters, use_temp, paged_kernel=False,
    logprobs_k=0, use_pen=False, use_seed=False, use_min=False, mesh=None,
):
    """ONE wide pass over every slot's verify window (speculative decoding
    inside the paged engine).

    feed: (B, W), row b holding the tokens at global positions
    lengths[b]..lengths[b]+W-1: the confirmed next token, then prompt
    tokens (while a prompt is fed incrementally) and/or drafts.  Returns
    (picked (B, W), kv): position j's greedy argmax (or sample, for rows
    with temperature > 0) over the logits AT fed position j, the model's
    own choice for position lengths+j+1.  The host accepts the longest fed
    prefix the model would itself have produced; rejected rows are
    rewritten by a later pass before any query attends to them, so
    rollback is free.  ``use_filters``: some row asks for top-k / top-p;
    ``use_temp``: some row samples.

    The per-request controls follow the decode chunk's, by window
    position: window position j's pick is the token for global position
    lengths+j+1, so ``use_min`` suppresses stop ids where its emitted
    index lengths+j+1-plens is below ``min_toks``; ``use_pen`` carries
    one running (B, V) count across the window (the fed token j counts
    when generated), exact for every accepted position; ``use_seed``
    keys window position j by position lengths+j, the decode chunk's key
    for the same position.  With ``logprobs_k`` > 0 ``picked`` becomes
    (picked, chosen_lp, top_ids, top_lps), position j's rows those of
    the distribution at fed position j.  ``bank`` / ``aids``: the
    adapters, as in the decode chunk."""
    logits = _verify_logits(params, kv, tables, feed, lengths, active, bank, aids, cfg=cfg,
                            page_size=page_size, paged_kernel=paged_kernel, mesh=mesh)
    B, W = feed.shape
    positions = lengths[:, None] + torch.arange(W, device=feed.device, dtype=lengths.dtype)
    if bias is not None:
        logits = logits + bias[:, None, :]
    if use_min:
        pre = (positions + 1 - plens[:, None]) < min_toks[:, None]
        logits = logits + torch.where(pre[..., None], stop_rows[:, None, :], 0.0)
    if use_pen:
        bidx = torch.arange(B, device=feed.device)
        gen = (positions >= plens[:, None]).float()
        cnt = counts.float()
        cols = []
        for j in range(W):
            cnt = cnt.index_put((bidx, feed[:, j].long()), gen[:, j], accumulate=True)
            cols.append(_penalise(logits[:, j], cnt, fpens, ppens))
        logits = torch.stack(cols, dim=1)
    picked = torch.argmax(logits, dim=-1).to(torch.int32)  # (B, W)
    if use_filters or use_temp:
        cols = []
        for j in range(W):
            lg = logits[:, j]
            row_seeds = (seeds, seeded, positions[:, j]) if use_seed else None
            if use_filters:
                cols.append(sample_batched(lg, generator, temps, top_ks, top_ps, row_seeds))
            else:
                scaled = lg / torch.clamp(temps, min=1e-6)[:, None]
                cols.append(categorical(scaled, generator, row_seeds).to(torch.int32))
        picked = torch.where((temps > 0)[:, None], torch.stack(cols, dim=1), picked)
    if logprobs_k > 0:
        return (picked, *_logprob_rows(logits, picked, logprobs_k)), kv
    return picked, kv


@torch.inference_mode()
def _draft_forward(dparams, dkv, feed, starts, *, dcfg):
    """Contiguous-cache forward for the DRAFT model: W tokens per row at
    PER-ROW start positions against a dense (L, B, M, Hkv, Dh) cache (the
    draft is small, so it skips the paged pool and all page bookkeeping),
    written IN PLACE.  Rollback is free as in the verify window: rows past
    a row's valid count hold garbage only at positions a later call
    rewrites before they become valid.  Positions past M - 1 write to the
    last row, a scratch row.  Returns (logits (B, W, V) float32, dkv)."""
    dtype = torch_dtype(dcfg.dtype)
    B, W = feed.shape
    Hn, Dh, Hkv = dcfg.n_heads, dcfg.head_dim, dcfg.kv_heads
    M = dkv["k"].shape[2]  # max_len + 1: index M - 1 is the overflow scratch
    x = _embed_lookup(dparams["embed"], feed, dtype)  # (B, W, D)
    positions = starts.long()[:, None] + torch.arange(W, device=feed.device)  # (B, W)
    pos_w = torch.clamp(positions, max=M - 1)
    rows = torch.arange(B, device=feed.device)[:, None].expand(B, W)
    cs = _rope_cs(positions, dcfg)
    for i in range(dcfg.n_layers):
        p = layer_slice(dparams["layers"], i)
        lk, lv = dkv["k"][i], dkv["v"][i]
        h = rms_norm(x, p["attn_norm"])
        q = wmatmul(h, p["wq"], dtype).reshape(B, W, Hn, Dh)
        k = wmatmul(h, p["wk"], dtype).reshape(B, W, Hkv, Dh)
        v = wmatmul(h, p["wv"], dtype).reshape(B, W, Hkv, Dh)
        q = _rope_rows(q, cs)
        k = _rope_rows(k, cs)
        lk.index_put_((rows, pos_w), k.to(lk.dtype))
        lv.index_put_((rows, pos_w), v.to(lv.dtype))
        o = _cached_attention_rows(q, lk, lv, starts, window=dcfg.window_size)
        x = x + wmatmul(o.reshape(B, W, Hn * Dh), p["wo"], dtype)
        h2 = rms_norm(x, p["mlp_norm"])
        gate = F.silu(wmatmul(h2, p["w_gate"], dtype))
        up = wmatmul(h2, p["w_in"], dtype)
        x = x + wmatmul(gate * up, p["w_out"], dtype)
    x = rms_norm(x, dparams["final_norm"])
    return wmatmul(x, dparams["unembed"], dtype).float(), dkv


@torch.inference_mode()
def _draft_ingest_propose(dparams, dkv, feed, starts, counts, *, dcfg, k):
    """One fused draft pass: ingest each row's ``counts`` new context
    tokens (window-padded), then roll the draft model ``k`` greedy steps
    from the last real position.  Returns (drafts (B, k), dkv)."""
    logits, dkv = _draft_forward(dparams, dkv, feed, starts, dcfg=dcfg)
    idx = torch.clamp(counts.long() - 1, min=0)[:, None, None].expand(-1, 1, logits.shape[-1])
    tok = torch.argmax(torch.gather(logits, 1, idx)[:, 0], dim=-1).to(torch.int32)
    pos = starts + counts
    toks = []
    for _ in range(k):
        toks.append(tok)
        lg, dkv = _draft_forward(dparams, dkv, tok[:, None], pos, dcfg=dcfg)
        tok = torch.argmax(lg[:, 0], dim=-1).to(torch.int32)
        pos = pos + 1
    return torch.stack(toks, dim=1), dkv


class _DeviceBatchState:
    """Persistent device mirrors of the host batch-state arrays.

    The fused chunks read ~10 per-slot arrays (the table view, the active
    mask, temperatures, ...) that change only when admission, release or
    page growth touches the batch.  One persistent device tensor per
    (field, shape) is refreshed IN PLACE, and only when the host copy
    changed, so a captured CUDA graph keeps reading the same tensors.

    Dirtiness is detected by content (``np.array_equal`` against the
    snapshot the device copy was built from): a missed flag would serve
    stale state, a comparison is self-correcting and costs nanoseconds on
    (B,)-sized arrays.  The (B, max_len) prompt buffer uses an explicit
    version counter instead (``get_versioned``), bumped where it is
    written.  ``uploads`` counts refreshes (the transfer-count probe).

    On CUDA a refresh copies the host array into a pinned staging buffer
    of its own and from there to the device without blocking; the host
    writes that staging buffer again only after the event recorded behind
    the previous copy out of it has completed, so a later host mutation
    can never reach a copy still in flight."""

    def __init__(self, device):
        self.device = device
        self._dev: dict = {}
        self._src: dict = {}
        self._ver: dict = {}
        self._stage: dict = {}  # key → [pinned buffer, event of its last copy]
        self.uploads = 0

    def put(self, name: str, host_arr: np.ndarray) -> torch.Tensor:
        """Refresh (uncounted, unconditional) and return the persistent
        device tensor for ``name`` at ``host_arr``'s shape."""
        host = torch.from_numpy(np.ascontiguousarray(host_arr))
        key = (name, host_arr.shape)
        dev = self._dev.get(key)
        if dev is None:
            # a normal tensor even when first met inside inference mode, so
            # in-place refreshes work from any caller
            with torch.inference_mode(False):
                dev = torch.empty(host.shape, dtype=host.dtype, device=self.device)
            self._dev[key] = dev
        if self.device.type != "cuda":
            dev.copy_(host)
            return dev
        stage = self._stage.get(key)
        if stage is None:
            stage = self._stage[key] = [
                torch.empty(host.shape, dtype=host.dtype, pin_memory=True), None,
            ]
        elif stage[1] is not None:
            stage[1].synchronize()  # the previous copy out of it is done
        stage[0].copy_(host)
        dev.copy_(stage[0], non_blocking=True)
        stage[1] = torch.cuda.Event()
        stage[1].record()
        return dev

    def get(self, name: str, host_arr: np.ndarray) -> torch.Tensor:
        """Device tensor for ``host_arr``, refreshed only on change."""
        key = (name, host_arr.shape)
        src = self._src.get(key)
        if src is None or not np.array_equal(src, host_arr):
            self.put(name, host_arr)
            self._src[key] = host_arr.copy()
            self.uploads += 1
        return self._dev[key]

    def get_versioned(self, name: str, host_arr: np.ndarray, version: int) -> torch.Tensor:
        """Like ``get`` but keyed by an explicit version counter, for
        arrays too big to compare every dispatch."""
        key = (name, host_arr.shape)
        if self._ver.get(key) != version:
            self.put(name, host_arr)
            self._ver[key] = version
            self.uploads += 1
        return self._dev[key]


def _device_kind(device) -> tuple:
    """(name, capability) of a CUDA device; ("cpu",) otherwise."""
    if device.type != "cuda":
        return (device.type,)
    return torch.cuda.get_device_name(device), torch.cuda.get_device_capability(device)


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
    param_bytes_per: float = 2.0,
) -> dict:
    """Static device-memory accounting for an engine configuration (no
    allocation), as the reference counts it: the KV pool (int8 K/V plus
    fp32 scales when ``kv_int8``) and the weights at ``param_bytes_per``
    bytes a parameter (2 = bf16, 1 ≈ int8 weights with their fp32 scales
    amortised; MoE experts and the router included).  Returns byte counts
    plus ``total``."""
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
        "target_param_bytes": int(_cfg_param_count(cfg) * param_bytes_per),
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
    """Chain seed: cached K/V depends on the adapter (the wk / wv
    deltas), so pages cached under one must never match another's
    prompts."""
    return prefixdigest.prefix_seed(adapter_id)


@dataclass
class _PendingChunk:
    """A dispatched fused chunk and the host snapshot needed to drain it.
    ``pairs`` pins the (slot, request) identity at dispatch time: a slot
    released or re-tenanted before the drain is skipped, which is what
    makes the overlapped pipeline's one-chunk overshoot safe to discard.
    On CUDA the chunk's outputs travel to ``host`` (pinned buffers of one
    of the engine's two sets, which alternate) by copies queued right
    behind the chunk, and ``ready`` is the event recorded after them: the
    drain waits on it alone, never on work queued later."""

    out: object  # sampled (B, n_steps), + the logprob triplet when want_lp
    want_lp: bool
    n_steps: int
    pos0: np.ndarray  # per-slot lengths BEFORE the chunk ran
    pairs: list  # [(slot index, Request at dispatch time), ...]
    host: Optional[list] = None  # pinned copies of ``out``'s tensors
    ready: Optional[object] = None  # torch.cuda.Event

    def arrays(self) -> list:
        """``out``'s tensors as numpy arrays, once the chunk is done."""
        if self.ready is not None:
            self.ready.synchronize()  # this chunk's copies only
            return [h.numpy() for h in self.host]
        outs = self.out if self.want_lp else (self.out,)
        return [t.numpy() for t in outs]


def _slice_bank(bank: dict, layer_specs: dict, mesh) -> dict:
    """The adapter bank cut as its families' weights are cut: a
    column-parallel family's ``b`` over its output columns, a row-parallel
    family's ``a`` over its input rows."""
    from ..parallel.sharding import local_slice

    out = {}
    for t, ab in bank.items():
        sp = layer_specs[t]
        sp = tuple(sp["q8"] if isinstance(sp, dict) else sp) + (None,) * 3
        out[t] = {"a": local_slice(ab["a"], (None, None, sp[1], None), mesh),
                  "b": local_slice(ab["b"], (None, None, None, sp[2]), mesh)}
    return out


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
        overlap: bool = True,
        spec_k: int = 0,
        spec_ngram: int = 3,
        draft: Optional[tuple] = None,
        logprobs_k: int = 5,
        max_queue: int = 0,
        adapters: Optional[dict] = None,
        device=None,
        mesh=None,
        sliced: bool = False,
        compile_cache=None,
        **unknown,
    ):
        """``paged_kernel``: decode attention reads the page pool in place
        (kernel K2 on CUDA) instead of gathering a contiguous copy per
        step.  ``kv_int8``: the pool holds int8 K/V with per-(token,
        kv-head) scales.  ``prefix_cache``: full prompt pages stay cached
        after a request and later prompts with the same leading pages
        attach them.  ``prefill_chunk`` > 0: prompts longer than that
        ingest that many tokens per engine step.  ``device``: ``cuda``
        unless asked otherwise; the weights move there.

        ``overlap``: chunk N+1 is dispatched off device-resident state
        before chunk N's tokens drain; host stop / cancel / max-token
        detection lags one chunk, and the engine over-runs a finishing
        slot by at most one chunk, whose tokens the drain discards.  Greedy
        output is identical to ``overlap=False`` (the exact sequential
        loop); sampled requests may draw other numbers after another
        request completes, since overshoot chunks advance the generator.
        On CUDA each chunk replays a CUDA graph captured per static shape
        (table-view bucket, ``use_filters``, ``use_temp``); a capture that
        fails raises.

        ``spec_k`` > 0: steps where some slot still feeds its prompt or a
        greedy slot generates run one verify pass over a spec_k + 1 window
        per slot (drafts from prompt lookup over ``spec_ngram``-grams, or
        from ``draft``) instead of sequential decode steps; greedy output
        is exactly the non-speculative engine's.  Sampled slots advance one
        token a pass; steps where only sampled slots generate take the
        decode chunk.

        ``draft``: (draft_params, draft_cfg) in the port's types, a small
        dense model with the target's vocabulary that proposes the drafts
        (needs ``spec_k`` > 0).  It keeps a dense per-slot cache of its
        own.

        ``logprobs_k``: the top-k width of per-token logprobs (0 turns
        logprobs off; a request asking more is clamped to it).

        ``max_queue`` > 0: ``submit`` fails a request with
        ``QUEUE_FULL_ERROR`` (HTTP 429) while that many wait; spill
        requeues bypass the cap.

        ``adapters``: {name: ``lora_init`` tree} served on this base
        (``build_lora_bank``); a request names one in ``Request.adapter``
        ("" is the base model) and requests on different adapters share
        the batch, its graphs and the verify pass.  The draft model runs
        without them.

        ``mesh``: serve over a connected ``parallel/mesh.Mesh`` (every rank
        builds this engine with the same arguments, each on its own
        ``device``): ``params`` are cut to this rank's slice
        (``sharding.serving_specs``) before they move, or are that slice
        already with ``sliced`` (``serve --tensor`` sends each rank only its
        own); the pool keeps the rank's kv heads.  Rank 0 takes requests;
        the other ranks run ``follow()`` (see the module docstring).  A
        mesh without a ``tensor`` axis raises ``ValueError``, and so does
        ``paged_kernel`` when ``tensor`` does not divide both head
        counts.

        ``compile_cache``: a ``compilecache.CompileCache``.  On CUDA the
        kernel library goes through it when it has a directory (else
        through the default one), and the lattice warm-up
        (``compilecache.warmup_engine``) runs only on an engine that has
        one.  The decode graphs are in ``graph_cache`` either way.

        Every option of the reference's engine is served; any other name
        raises ``TypeError``."""
        if unknown:
            raise TypeError(f"unknown engine options {sorted(unknown)}")
        spec_k = max(0, spec_k)
        if draft is not None:
            dparams, dcfg = draft
            if spec_k <= 0:
                raise ValueError("draft model needs spec_k > 0")
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(f"draft vocab {dcfg.vocab_size} != target {cfg.vocab_size}")
            if dcfg.n_experts > 0:
                raise ValueError("draft model must be dense (n_experts=0)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        heads = self._check_mesh(mesh, cfg, paged_kernel, sliced, adapters)
        # multi-LoRA: the bank (fixed for the engine's life) and each slot's
        # adapter id (0 = the base model, an all-zero bank row)
        if adapters:
            self.lora_bank, self.adapter_index = build_lora_bank(
                adapters, torch_dtype(cfg.dtype), base_layers=params["layers"],
            )
        else:
            self.lora_bank, self.adapter_index = {}, {"": 0}
        if mesh is not None and not sliced:
            from ..parallel.sharding import serving_specs, slice_tree

            specs = serving_specs(params, cfg, mesh)
            self.lora_bank = _slice_bank(self.lora_bank, specs["layers"], mesh)
            params = slice_tree(params, specs, mesh)
        self.params = _tree_to(params, self.device)
        self.lora_bank = _tree_to(self.lora_bank, self.device)
        self.adapter_ids = np.zeros(max_batch, np.int32)
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
        self.kv = make_kv_pool(cfg, self.n_pages, page_size, self.device, int8=kv_int8,
                               kv_heads=heads)
        # the pool holds this rank's kv heads only (a page's bytes are then a
        # gather over tensor): tensor > 1 and it divides both head counts
        self._pool_cut = 0 < heads < cfg.kv_heads
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
        self.failed = False  # a mirrored engine after a fault (``fail_mirrored``)
        self._work = threading.Event()  # set on enqueue: wakes an idle loop
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(0)
        # bounded admission (0 = unbounded); the cap-check and the enqueue
        # are one step under the lock, against a burst of handler threads
        self.max_queue = max(0, max_queue)
        self._cap_lock = threading.Lock()
        # per-request controls: per-slot bias rows (allowed_tokens and
        # logit_bias) and min_tokens stop rows, DEVICE-resident and
        # persistent (captured graphs read them; zero rows change nothing),
        # cleared at release only where set; the stop rows are made at the
        # first request that needs them
        V = cfg.vocab_size
        with torch.inference_mode(False):
            self._bias_dev = torch.zeros((max_batch, V), dtype=torch.float32,
                                         device=self.device)
        self._bias_set = np.zeros(max_batch, bool)
        self._stop_dev: Optional[torch.Tensor] = None
        self._stop_set = np.zeros(max_batch, bool)
        self.min_toks = np.zeros(max_batch, np.int32)  # REMAINING floor
        self.freq_pens = np.zeros(max_batch, np.float32)
        self.pres_pens = np.zeros(max_batch, np.float32)
        self.seeds = np.zeros(max_batch, np.int64)  # uint32 values
        self._seeded = np.zeros(max_batch, bool)
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
        # tokens each live slot got from the prefix cache at admission: a
        # slot riding a large cached or adopted prefix is the cheapest to
        # evict or migrate (re-admission matches the pages again)
        self.matched_toks = np.zeros(max_batch, np.int32)
        # -- the disaggregated serving data plane -------------------------------
        # thunks other threads (the HTTP handlers) queue for the engine
        # thread, the sole owner of slot, page and pool state; drained at
        # the top of every _admit, and part of the loop's idle re-check
        self._tasks: "queue.Queue" = queue.Queue()
        # shipping counters (/v1/stats "kv"); a refused migrate-out handoff
        # rolls its bumps back, so fleet-wide sum(migrated_out) equals
        # sum(migrated_in)
        self.kv_pages_exported = 0
        self.kv_pages_imported = 0
        self.kv_exports = 0  # export bundles served
        self.kv_imports = 0  # import bundles applied
        self.sessions_migrated_out = 0
        self.sessions_migrated_in = 0
        # fleet identity and prefill/decode role, reported on /v1/stats
        # (``serve --replica-name / --fleet-role`` set them)
        self.replica_name = ""
        self.fleet_role = "both"
        self.logprobs_k = max(0, logprobs_k)
        # -- the overlapped pipeline ------------------------------------------
        self.overlap = overlap
        self._ds = _DeviceBatchState(self.device)
        self._prompts_version = 0  # bumped where admission writes prompts
        # the chunk-to-chunk carry: persistent (next tokens, lengths) device
        # tensors that every chunk reads and writes back in place.  None →
        # rebuilt from the host at the next dispatch (engine start, after a
        # verify pass); ``_carry_dirty`` lists slots whose host lengths /
        # next_token changed outside a chunk (admission, prefill), patched
        # at the next dispatch
        with torch.inference_mode(False):
            self._carry_bufs = (
                torch.zeros(max_batch, dtype=torch.int32, device=self.device),
                torch.zeros(max_batch, dtype=torch.int32, device=self.device),
            )
        self._carry = None
        self._carry_dirty: set[int] = set()
        self._pending: Optional[_PendingChunk] = None  # dispatched, not drained
        self.chunks_discarded = 0  # in-flight rows of released slots dropped
        # host-gap telemetry: wall time from a chunk's tokens reaching the
        # host to the next chunk's dispatch (zero when the next chunk was
        # queued before the drain: the device never waited)
        self.host_gap_ns = 0
        self.host_gap_chunks = 0
        self.last_host_gap_ms = 0.0
        self._last_drain_done: Optional[int] = None
        self._gap_buf: list[float] = []
        self._gap_buf_cap = 8192
        # CUDA: pinned landing buffers for the drains (two, alternating),
        # and the decode chunk as CUDA graphs, one per static shape, all in
        # one memory pool, captured on a stream of their own
        self._out_bufs: list = []  # two sets of {output index: pinned buffer}
        self._out_next = 0
        self.graphs_captured = 0
        self.graph_capture_s = 0.0
        self.graph_warmups = 0  # eager chunks run on scratch before a capture
        self.graph_warmup_s = 0.0
        self._warmed_variants: set = set()  # flag sets whose first capture ran one
        self.graph_replays = 0
        # decided once: a chunk holding a collective over more than one rank
        # runs eagerly, never in a graph, whatever the backend (gloo stages
        # through the host; NCCL capture across cards is untried)
        self._capture = (self.device.type == "cuda" and overlap
                         and (mesh is None or mesh.axes_size(("tensor", "expert")) == 1))
        # the graphs: a memory-only cache of the engine's own (a graph
        # replays this engine's tensors only), keyed by the reference's
        # fingerprint with the device's kind in place of the JAX version and
        # backend; a replay a hit, a capture a miss
        self.graph_cache = self._aot_chunk = None
        if self.device.type == "cuda":
            self._out_bufs = [{}, {}]
            if self._capture:
                self._graph_pool = torch.cuda.graph_pool_handle()
                self._capture_stream = torch.cuda.Stream(self.device)
                self.graph_cache = CompileCache(None)
                self._aot_chunk = AotFunction(self._capture_chunk, self.graph_cache, (
                    repr(cfg), max_batch, max_len, page_size, self.fused_steps, kv_int8,
                    paged_kernel, self.logprobs_k, tuple(sorted(self.adapter_index)),
                    tuple(sorted(mesh.shape.items())) if mesh is not None else None,
                    _device_kind(self.device)), "serve_chunk")
        # -- the warm-start plane (compilecache/) ------------------------------
        self.compile_cache = compile_cache
        self.library_s = 0.0  # seconds this rank took to load or build the kernel library
        if compile_cache is not None and self.device.type == "cuda":
            _build.use_cache(compile_cache)
        # -- serving on a mesh: one host decision point, mirrored state --------
        # rank 0 takes requests and cancels; every round starts with its
        # ticket (``exchange_ticket``), which every rank applies alike
        self.mirrored = mesh is not None and mesh.size > 1
        self.leader = not self.mirrored or mesh.rank == int(mesh.ranks.flat[0])
        self._unticketed: list[Request] = []  # rank 0: submitted since the last ticket
        self._ticketed: dict[int, Request] = {}  # ticket id → live request
        self._ticket_ids = itertools.count()
        self.tickets = 0
        # the disaggregated verbs (``run_verb``): rank 0's tasks waiting for
        # a ticket, and the last ticket's, which every rank runs at the top
        # of its next ``_admit`` (at once after a tasks-only ticket)
        self._verb_queue: list[_Task] = []
        self._round_tasks: list[_Task] = []
        self._ticket_draining = False
        # -- speculative decoding ---------------------------------------------
        self.spec_k = spec_k
        self.spec_ngram = spec_ngram
        self.spec_passes = 0  # verify passes run
        self.spec_accepted = 0  # accepted draft tokens (beyond the bonus)
        self.draft = draft
        if draft is not None:
            self.draft_cfg = dcfg
            self.draft_params = _tree_to(dparams, self.device)
            # max_len + 1: the last index is a scratch row for rollout
            # positions past max_len (the pool's scratch page, for the draft)
            dshape = (dcfg.n_layers, max_batch, max_len + 1, dcfg.kv_heads, dcfg.head_dim)
            ddtype = torch_dtype(dcfg.dtype)
            self.dkv = {
                "k": torch.zeros(dshape, dtype=ddtype, device=self.device),
                "v": torch.zeros(dshape, dtype=ddtype, device=self.device),
            }
            self.draft_len = np.zeros(max_batch, np.int32)
            self._draft_chunk = 64  # pre-ingest width for long prompts

    @staticmethod
    def _check_mesh(mesh, cfg, paged_kernel: bool, sliced: bool, adapters) -> int:
        """Refuse what a serving mesh cannot take; returns the pool's kv
        heads a rank (0: all of them)."""
        if mesh is None:
            if sliced:
                raise ValueError("sliced params need the mesh they were cut for")
            return 0
        if "tensor" not in mesh.axis_names:
            raise ValueError(f"serving mesh needs a 'tensor' axis, got {tuple(mesh.axis_names)}")
        if not mesh.connected:
            raise ValueError("connect the serving mesh (Mesh.connect() on every rank of the "
                             "world) before building the engine")
        t = mesh.shape["tensor"]
        if paged_kernel and (cfg.n_heads % t or cfg.kv_heads % t):
            raise ValueError(
                f"paged_kernel over a tensor={t} mesh needs n_heads ({cfg.n_heads}) and "
                f"kv_heads ({cfg.kv_heads}) divisible by the tensor axis")
        if sliced and adapters:
            raise ValueError("adapters need the whole params: the bank is checked against "
                             "the whole base and cut as its weights are")
        whole_heads = cfg.n_heads % t == 0 and cfg.kv_heads % t == 0
        return cfg.kv_heads // t if whole_heads else 0

    # -- public API ----------------------------------------------------------

    def submit(self, req: Request) -> Request:
        """Validate and enqueue; an invalid request is failed at once
        (req.error set, done signalled), and so is one that finds the
        bounded queue full (``QUEUE_FULL_ERROR``)."""
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
        if self.mirrored:
            # enqueued by the next ticket, on every rank in the same order
            if not self.leader:
                raise RuntimeError("a follower takes its requests from rank 0's tickets")
            with self._cap_lock:
                if self.failed:
                    req.error = ENGINE_FAILED_ERROR
                    req.done.set()
                    return req
                if self.max_queue and (self.queue.qsize() + len(self._unticketed)
                                       >= self.max_queue):
                    req.error = QUEUE_FULL_ERROR
                    req.done.set()
                    return req
                req.mirrored = True
                self._unticketed.append(req)
            self._work.set()
            return req
        if self.max_queue:
            # cancelled entries (clients gone) are purged before they can
            # count against live traffic
            with self._cap_lock:
                if self.queue.qsize() >= self.max_queue:
                    self._purge_cancelled_queued()
                    if self.queue.qsize() >= self.max_queue:
                        req.error = QUEUE_FULL_ERROR
                        req.done.set()
                        return req
                self._enqueue(req)
            return req
        self._enqueue(req)
        return req

    def _invalid_reason(self, req: Request) -> Optional[str]:
        """The reference's validation and normalisation: mutates ``req``
        (the seed dropped for greedy and masked to uint32, logprobs
        clamped to ``logprobs_k``), so call it once."""
        if len(req.prompt) < 1:
            return "empty prompt"
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            return (
                f"prompt {len(req.prompt)} + max_new_tokens "
                f"{req.max_new_tokens} exceeds max_len {self.max_len}"
            )
        if req.adapter not in self.adapter_index:
            return (
                f"unknown adapter {req.adapter!r} "
                f"(registered: {sorted(self.adapter_index)})"
            )
        if req.seed is not None:
            if isinstance(req.seed, bool) or not isinstance(req.seed, int):
                return "seed must be an integer"
            if req.temperature <= 0:
                req.seed = None  # greedy draws nothing
            else:
                req.seed &= 0xFFFFFFFF
        for pen in (req.frequency_penalty, req.presence_penalty):
            if not np.isfinite(pen):
                return "penalties must be finite"
        V = self.cfg.vocab_size
        if req.allowed_tokens and not all(
            isinstance(k, int) and not isinstance(k, bool) and 0 <= k < V
            for k in req.allowed_tokens
        ):
            return f"allowed_tokens must be token ids in [0, {V})"
        if req.logit_bias and not all(
            isinstance(k, int) and not isinstance(k, bool) and 0 <= k < V
            and isinstance(v, (int, float)) and np.isfinite(v)
            for k, v in req.logit_bias.items()
        ):
            return f"logit_bias keys must be token ids in [0, {V}) with finite values"
        if req.logprobs > 0 and self.logprobs_k <= 0:
            return "engine built with logprobs_k=0 (logprobs off)"
        if isinstance(req.priority, bool) or not isinstance(req.priority, int):
            return "priority must be an integer"
        req.logprobs = min(max(0, req.logprobs), self.logprobs_k)
        return None

    def _purge_cancelled_queued(self) -> None:
        """Drop queued requests cancelled while waiting, so the admission
        cap does not count them; the list surgery holds the queue's own
        mutex, safe against the engine thread.  A mirrored engine leaves
        them to admission, which every rank runs alike."""
        import heapq

        if self.mirrored:
            return
        with self.queue.mutex:
            q = self.queue.queue
            dead = [e for e in q if e[2].cancelled]
            for e in dead:
                q.remove(e)
            if dead:
                heapq.heapify(q)
        for e in dead:
            e[2].done.set()

    def _enqueue(self, req: Request) -> None:
        """Priority-ordered admission (also the spill-requeue path)."""
        if req.trace_ctx is not None:
            TRACER.point("engine.queued", parent=req.trace_ctx, priority=req.priority,
                         resumed=bool(req.output))
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

    @property
    def device_uploads(self) -> int:
        """Host→device refreshes of batch state (mirror refreshes plus
        carry rebuilds and patches), the transfer-count probe: flat across
        steady-state decode chunks."""
        return self._ds.uploads

    def _gap_sample(self, gap_ms: float) -> None:
        """Buffer one per-chunk host-gap sample (the newest half is kept
        when nothing reads them)."""
        buf = self._gap_buf
        buf.append(gap_ms)
        if len(buf) > self._gap_buf_cap:
            del buf[: self._gap_buf_cap // 2]

    def drain_host_gaps(self) -> list[float]:
        """Move the buffered per-chunk host-gap samples (ms) out; safe
        against the engine thread appending at the tail meanwhile."""
        buf = self._gap_buf
        n = len(buf)
        vals = buf[:n]
        del buf[:n]
        return vals

    def host_gap_stats(self) -> dict:
        """Host-gap telemetry: wall time between a decode chunk's tokens
        reaching the host and the next chunk's dispatch, the window in
        which the device can starve on host bookkeeping.  ``mean_ms`` is
        the running mean since the engine started."""
        n = self.host_gap_chunks
        return {
            "chunks": n,
            "mean_ms": (self.host_gap_ns / 1e6 / n) if n else 0.0,
            "last_ms": self.last_host_gap_ms,
            "overlap": self.overlap,
        }

    def run_until_idle(self, max_steps: int = 10_000) -> None:
        """Drive fused chunks until no request is active or queued, then
        drain the chunk still in flight (if any).  On a mirrored engine
        rank 0 calls it, each round behind a ticket (the followers run
        ``follow``), and ``stop_followers`` after it."""
        if self.mirrored:
            if not self.leader:
                raise RuntimeError("a follower runs follow(); rank 0 drives the engine")
            for _ in range(max_steps):
                self.exchange_ticket()
                if not self.round() and self.queue.empty():
                    return
            raise RuntimeError("run_until_idle: step budget exhausted")
        for _ in range(max_steps):
            self._admit()
            if not any(s is not None for s in self.slots):
                if self.queue.empty():
                    self._drain_pending()
                    return
                continue
            self.step()
        raise RuntimeError("run_until_idle: step budget exhausted")

    # -- the warm-start plane (compilecache/) ----------------------------------

    @staticmethod
    def _pow2_lattice(start: int, cap: int) -> list[int]:
        """The power-of-two bucket values the dispatch paths round up to,
        clamped at ``cap``: exactly the widths ``_prefill_dispatch`` and
        ``_prepare_step`` can produce."""
        out, w = [], start
        while True:
            out.append(min(w, cap))
            if w >= cap:
                break
            w *= 2
        return sorted(set(out))

    def aot_signatures(self, variants: str = "minimal") -> list:
        """The engine's shape lattice as warm-up points, ``[(label, build),
        ...]``: ``build()`` runs the point on the engine's thread.  The
        labels and lattice are the reference's:

        - ``prefill:t{tpad}:p{pbucket}``: a one-pass prefill (K1 on CUDA)
          at every pad length and the table width it needs; with
          ``prefill_chunk`` or ``prefix_cache``, ``prefill_prefixed:t{tpad}:
          p{width}`` (K3) at every width at least that (a chunk walks wider
          tables at one pad length).  Each runs once on tables of the
          scratch page;
        - ``serve_chunk:{flags}:p{pbucket}`` at every table-view bucket: the
          decode chunk's CUDA graph captured through the compile cache
          (the overlapped engine on CUDA), else one chunk run on the
          scratch page.  ``flags`` are ``_graph_key``'s six: ``minimal``
          covers default traffic (greedy, sampled, sampled with top-k /
          top-p: three sets), ``full`` all 64;
        - ``verify_chunk:p{pbucket}`` (``spec_k`` > 0): one greedy verify
          pass on the scratch page (the verify pass runs eagerly).

        No point touches a live slot, a length, a page but the scratch page,
        or the engine's generator.  ``build``'s keywords are the point as
        plain data (``kind``, ``tpad``, ``width``, ``flags``).  A mirrored
        engine's lattice is its config's one-device lattice; each ``build``
        there is ``warm_point``, which runs the point on every rank in one
        round (no graph is captured: its chunks run eagerly)."""
        warm = self.warm_point if self.mirrored else self._warm
        if variants == "full":
            flag_sets = list(itertools.product((False, True), repeat=6))
        else:
            flag_sets = [(False,) * 6, (False, True) + (False,) * 4,
                         (True, True) + (False,) * 4]
        sigs: list = []
        widths = self._pow2_lattice(1, self.max_pages_per_slot)
        for tpad in self._pow2_lattice(8, self.max_len):
            need = -(-tpad // self.page_size)
            pbucket = min(next((w for w in widths if w >= need), widths[-1]),
                          self.max_pages_per_slot)
            sigs.append((f"prefill:t{tpad}:p{pbucket}",
                         functools.partial(warm, kind="prefill", tpad=tpad, width=pbucket)))
            if self.prefill_chunk > 0 or self.prefix_cache:
                sigs += [(f"prefill_prefixed:t{tpad}:p{w}",
                          functools.partial(warm, kind="prefill_prefixed", tpad=tpad, width=w))
                         for w in widths if w >= need]
        for pbucket in widths:
            for flags in flag_sets:
                sigs.append((f"serve_chunk:{''.join(str(int(f)) for f in flags)}:p{pbucket}",
                             functools.partial(warm, kind="serve_chunk", width=pbucket,
                                               flags=flags)))
            if self.spec_k > 0:
                sigs.append((f"verify_chunk:p{pbucket}",
                             functools.partial(warm, kind="verify_chunk", width=pbucket)))
        return sigs

    def _warm(self, kind: str, tpad: int = 0, width: int = 0, flags: tuple = ()) -> None:
        """One lattice point on this rank (``aot_signatures``' kinds)."""
        if kind == "serve_chunk":
            self._warm_chunk(width, tuple(flags))
        elif kind == "verify_chunk":
            self._warm_verify(width)
        elif kind in ("prefill", "prefill_prefixed"):
            self._warm_prefill(tpad, width, kind == "prefill_prefixed")
        else:
            raise ValueError(f"unknown lattice point kind {kind!r}")

    def warm_point(self, kind: str, tpad: int = 0, width: int = 0, flags: tuple = ()) -> dict:
        """A lattice point called by the thread that drives the engine: on
        a mirrored engine rank 0 sends it in a tasks-only ticket and every
        rank runs it (``_warm_task``); from another thread it goes through
        ``run_verb("warm", ...)``.  Returns the task's result."""
        return self._call_verb("warm_point", "warm", kind=kind, tpad=tpad, width=width,
                               flags=flags)

    def _warm_task(self, task: _Task) -> dict:
        """One lattice point as a task.  On a mirrored engine every rank
        runs it in the same round, so the collectives inside its pass meet;
        then the ranks exchange how it went over the object group (each
        rank's error, seconds, kernel library seconds and mirror digest).
        A point that raised on ANY rank, or mirrors that parted, raise
        ``MeshWarmupError`` on every rank: the round's fault, which
        ``_run_tasks`` passes on (rank 0's loop stops serving, a follower
        leaves ``follow``).  A rank that raises before a collective its
        peers are inside leaves them there until the backend's timeout or
        this process's exit, as a round's fault does.  Returns when it
        started, its thread's CPU seconds and each rank's readings."""
        t, cpu = time.perf_counter(), time.thread_time()
        error = ""
        try:
            self._warm(**task.args)
        except Exception as e:  # noqa: BLE001 - exchanged, then raised on every rank
            if not self.mirrored:
                raise
            error = f"{type(e).__name__}: {e}"
        ran, cpu = time.perf_counter() - t, time.thread_time() - cpu
        rank = self.mesh.rank if self.mirrored else 0
        outcomes = all_gather_object((rank, error, ran, self.library_s,
                                      self._mirror_digest().hex()), self.mesh)
        failed = sorted((r, e) for r, e, *_ in outcomes if e)
        point = ":".join(str(task.args[k]) for k in ("kind", "tpad", "width"))
        if failed:
            raise MeshWarmupError(f"warm-up point {point} failed on rank(s) "
                                  + "; ".join(f"{r}: {e}" for r, e in failed))
        if len({d for *_, d in outcomes}) > 1:
            raise MeshWarmupError(f"warm-up point {point}: the ranks' host states parted")
        return {"started": t, "cpu_s": cpu,
                "ranks": {r: {"run_s": s, "library_s": lib} for r, _, s, lib, _ in outcomes}}

    def _warm_prefill(self, tpad: int, width: int, prefixed: bool) -> None:
        """One prefill pass of ``tpad`` tokens over a table row of ``width``
        scratch pages; the prefixed pass puts its tokens at the row's end
        (or ``max_len``'s), behind at least one cached position."""
        dev = self.device
        row = torch.full((width,), SCRATCH_PAGE, dtype=torch.int32, device=dev)
        toks = torch.zeros((1, tpad), dtype=torch.int32, device=dev)
        ad = {} if self.mesh is None else {"mesh": self.mesh}
        if self.lora_bank:
            ad.update(bank=self.lora_bank, aids=torch.zeros(1, dtype=torch.int32, device=dev))
        if prefixed:
            total = min(width * self.page_size, self.max_len)
            n = min(tpad, total - 1)
            _paged_prefill_prefixed(self.params, toks, self.kv, row, total - n, n, cfg=self.cfg,
                                    page_size=self.page_size, **ad)
        else:
            _paged_prefill(self.params, toks, self.kv, row, tpad, cfg=self.cfg,
                           page_size=self.page_size, **ad)

    def _warm_chunk(self, bucket: int, flags: tuple) -> None:
        """Capture the decode graph of (``bucket``, ``flags``) on the
        tensors a live dispatch of that key passes (the overlapped engine on
        CUDA), else run that chunk once on the scratch page.  The batch
        mirrors it refreshes hold what the next dispatch compares against,
        so that dispatch refreshes whatever differs."""
        v = dict(zip(("use_filters", "use_temp", "want_lp", "use_pen", "use_seed", "use_min"),
                     flags))
        if v["use_min"]:
            self._ensure_stop_rows()
        B = self.max_batch
        args = self._chunk_args(v, np.full((B, bucket), SCRATCH_PAGE, np.int32),
                                np.zeros(B, bool), self._carry_bufs)
        static = self._static(v, n_steps=self.fused_steps)
        if self._capture:
            self._aot_chunk.build(self._graph_key(v, bucket), args, static)
        else:
            self._scratch_chunk(args, static)

    def _warm_verify(self, bucket: int) -> None:
        """One greedy verify pass over a table view of ``bucket`` scratch
        pages, every row inactive, with a generator of its own."""
        B, W, dev = self.max_batch, self.spec_k + 1, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        v = dict(use_filters=False, use_temp=False, want_lp=False, use_pen=False,
                 use_seed=False, use_min=False)
        _fused_verify_chunk(
            self.params, self.kv, torch.full((B, bucket), SCRATCH_PAGE, **i32),
            torch.zeros((B, W), **i32), torch.zeros(B, **i32),
            torch.zeros(B, dtype=torch.bool, device=dev),
            torch.zeros(B, dtype=torch.float32, device=dev), torch.zeros(B, **i32),
            torch.ones(B, dtype=torch.float32, device=dev), torch.Generator(device=dev),
            *self._control_args(v, plens=True), *self._adapter_args(), **self._static(v),
        )

    # -- serving on a mesh -----------------------------------------------------

    def exchange_ticket(self, stop: bool = False, preempt: bool = False,
                        tasks_only: bool = False) -> dict:
        """One round's ticket, on every rank of a mirrored engine (a
        collective over the mesh's object group): rank 0 sends the requests
        submitted since the last ticket (the fields ``_TICKET_FIELDS``
        names, under ticket ids), the ids of those whose cancel was asked
        for, the disaggregated tasks queued since (``run_verb``, in order,
        each with what rank 0 decided for it: a migrate-out's slot, a
        session's ticket id), its drain flag, ``stop`` (the followers leave
        ``follow``), ``preempt`` (a round whose pool runs dry preempts a
        slot instead of raising) and ``tasks_only`` (the ranks run the
        tasks at once and no round follows); every rank then enqueues and
        cancels in the ticket's order, and runs the tasks at the top of its
        next ``_admit``.  The ticket also carries a digest of rank 0's host
        state after the last round (``_mirror_digest``): a follower whose
        own differs raises, naming the ticket, before it runs another
        round.  Returns the ticket."""
        digest = self._mirror_digest()
        if self.leader:
            with self._cap_lock:
                new, self._unticketed = self._unticketed, []
                tasks, self._verb_queue = self._verb_queue, []
                for t in tasks:
                    t.state = "ticketed"  # runs on every rank from here
            self._round_tasks += tasks
            chosen: set = set()
            for t in tasks:
                self._prepare_task(t, chosen)
            ids = [next(self._ticket_ids) for _ in new]
            for i, r in zip(ids, new):
                r.ticket = i
                self._ticketed[i] = r
            ticket = {
                "new": [(i, {f: getattr(r, f) for f in _TICKET_FIELDS})
                        for i, r in zip(ids, new)],
                "cancel": [i for i, r in self._ticketed.items()
                           if r.cancel_asked and not r.cancelled],
                "tasks": [t.wire() for t in tasks], "tasks_only": tasks_only,
                "draining": self.draining, "stop": stop, "preempt": preempt,
                "digest": digest,
            }
        else:
            ticket = None
        ticket = broadcast_object(ticket, self.mesh)
        if ticket["digest"] != digest:
            raise RuntimeError(f"rank {self.mesh.rank}'s engine parted from rank 0's before "
                               f"ticket {self.tickets}: its host state differs")
        self.tickets += 1
        for i, state in ticket["new"]:
            if not self.leader:
                self._ticketed[i] = Request(**state, ticket=i)
            self._enqueue(self._ticketed[i])
        for i in ticket["cancel"]:
            self._ticketed[i].cancelled = True
        if not self.leader:
            self.draining = ticket["draining"]
            self._round_tasks += [_Task(**w) for w in ticket.get("tasks", ())]
        self._ticket_draining = ticket["draining"]
        self._ticketed = {i: r for i, r in self._ticketed.items() if not r.done.is_set()}
        return ticket

    def _mirror_digest(self) -> bytes:
        """A digest of the host state the mirrors must share: the counters,
        each slot's length, next token and pages, the free list and the
        queue's length (every sampled token passes through them), the
        page refcounts, the prefix cache's size and the data plane's
        counters (every disaggregated task moves them)."""
        h = hashlib.blake2b(digest_size=16)
        for a in (self.lengths, self.next_token, self.emitted, self.tables, self.page_ref):
            h.update(a.tobytes())
        h.update(np.asarray([self.tokens_emitted, self.steps_run, self.prefills_run,
                             self.spec_accepted, self.spills, len(self.free_pages),
                             self.queue.qsize(), len(self.prefix_entries),
                             self.kv_pages_exported, self.kv_pages_imported, self.kv_exports,
                             self.kv_imports, self.sessions_migrated_out,
                             self.sessions_migrated_in], np.int64).tobytes())
        return h.digest()

    def round(self, preempt: bool = False, victim_fn=None, step=None) -> bool:
        """Admission, then one step (``step``, ``self.step`` when None: a
        caller may wrap it in its spans), or the drain of the chunk in
        flight when no slot is live: the one body ``EngineLoop`` and every
        follower run after each ticket.  With ``preempt`` a step that finds
        the pool dry preempts one slot (``preempt_for_pool(victim_fn)``)
        instead of raising.  True when some slot was live."""
        self._admit()
        if not any(s is not None for s in self.slots):
            self._drain_pending()
            return False
        try:
            (step or self.step)()
        except RuntimeError as e:
            if not preempt or "page pool exhausted" not in str(e):
                raise
            self.preempt_for_pool(victim_fn)
        return True

    def follow(self) -> None:
        """A follower's loop: each ticket from rank 0, then the round rank
        0 runs after it, until the stop ticket."""
        if self.leader:
            raise RuntimeError("rank 0 leads: it runs run_until_idle or an EngineLoop")
        with torch.inference_mode():
            while True:
                ticket = self.exchange_ticket()
                if ticket["stop"]:
                    return
                if ticket.get("tasks_only"):
                    self._run_tasks()
                    continue
                self.round(ticket["preempt"])

    def stop_followers(self) -> None:
        """Rank 0: the stop ticket, which ends every follower's ``follow``."""
        if self.mirrored:
            self.exchange_ticket(stop=True)

    def fail_mirrored(self) -> None:
        """Rank 0 of a mirrored engine after a fault: the ranks' host states
        may have parted, so it serves no more.  Every request not done yet
        (queued, ticketed or waiting for a ticket) fails at once, and so do
        every disaggregated task not run yet and every later ``submit`` or
        ``run_verb`` (``ENGINE_FAILED_ERROR``).  No ticket is
        sent: a follower may be inside a collective, and ends when this
        process does."""
        with self._cap_lock:
            self.failed = True
            waiting, self._unticketed = self._unticketed, []
            tasks, self._verb_queue = self._verb_queue, []
        for t in tasks + self._round_tasks:
            if not t.done.is_set():
                t.error = RuntimeError(ENGINE_FAILED_ERROR)
                t.done.set()
        self._round_tasks = []
        waiting += self._ticketed.values()
        self._ticketed = {}
        while True:
            try:
                waiting.append(self.queue.get_nowait()[2])
            except queue.Empty:
                break
        for r in waiting:
            if not r.done.is_set():
                r.error = ENGINE_FAILED_ERROR
                r.done.set()

    def preempt_for_pool(self, victim_fn=None) -> int:
        """Every slot stalled for pages: preempt ONE, rank 0's choice
        (``victim_fn(engine)``; a follower passes none and takes rank 0's),
        on every rank of a mirrored engine.  Its first eviction requeues it
        for an exact resume; a second means it cannot fit the pool and it
        fails.  Returns the slot."""
        victim = victim_fn(self) if self.leader else None
        if self.mirrored:
            victim = broadcast_object(victim, self.mesh)
        req = self.slots[victim]
        log.warning("KV page pool exhausted; preempting priority-%d slot %d (%d pages held)",
                    int(self.priorities[victim]), victim, len(self.slot_pages[victim]))
        if req.pool_spills < 1:
            req.pool_spills += 1
            self.spills += 1
            self.evict_slot(victim)
        else:
            req.error = "preempted: KV page pool exhausted"
            req.done.set()
            self._release_slot(victim)
        return victim

    def step(self) -> None:
        """One engine step: every mid-chunked-prefill slot ingests one
        chunk, then one fused decode chunk (or, speculative, one verify
        pass) runs for every other runnable slot.

        With ``overlap`` the decode chunk is double-buffered: this call
        dispatches chunk N+1 first and only then drains chunk N, so host
        bookkeeping runs while the device computes.  A verify pass drains
        first: its windows are built from current host state."""
        self._continue_prefills()
        if self.spec_k > 0 and self._spec_useful():
            self._drain_pending()
            self._step_verify()
            # acceptance is data-dependent and recomputed on the host: the
            # chunk carry is stale, rebuild it at the next decode dispatch
            self._carry = None
            return
        if self.overlap and not self._overlap_blocked():
            self._step_chunk_overlapped()
            return
        self._drain_pending()
        self._step_chunk()

    def _overlap_blocked(self) -> bool:
        """Penalised requests need counts rebuilt from the host's output
        lists (``_host_counts``), which lag while a chunk is in flight: a
        batch holding one takes the exact sequential loop."""
        return any(req is not None and (req.frequency_penalty or req.presence_penalty)
                   for req in self.slots)

    # -- engine internals ----------------------------------------------------

    def _stops(self, i: int, req: Request, tok: int) -> bool:
        """The stop check, honouring min_tokens (``emitted`` already
        counts ``tok`` at every call site)."""
        return tok in req.stop_tokens and self.emitted[i] >= req.min_tokens

    def _emit(self, req: Request, tok: int, lp=None, top=None) -> None:
        """Deliver one token.  A raising user callback must never unwind
        into the engine loop: log it and stop streaming that request.
        ``lp`` / ``top``: the token's logprob and its [(id, logprob), ...]
        alternatives, appended in step with ``output``."""
        self.tokens_emitted += 1
        req.output.append(tok)
        if req.logprobs > 0:
            req.token_logprobs.append(None if lp is None else float(lp))
            req.top_logprobs.append([] if top is None else top)
        if req.on_token is not None:
            try:
                req.on_token(tok)
            except Exception:
                log.warning(
                    "on_token callback raised; streaming disabled for this "
                    "request", exc_info=True,
                )
                req.on_token = None

    def _set_row(self, rows: torch.Tensor, i: int, row: np.ndarray) -> None:
        """Write one slot's (V,) row of a device-resident row set in place
        (on the engine's stream, so behind any chunk still reading it)."""
        with torch.inference_mode():
            rows[i].copy_(torch.from_numpy(row))

    def _ensure_stop_rows(self) -> None:
        """Make the device min_tokens stop rows (all zero) if not made yet."""
        if self._stop_dev is None:
            with torch.inference_mode(False):
                self._stop_dev = torch.zeros_like(self._bias_dev)

    def _clear_bias(self, i: int) -> None:
        """Zero a released slot's bias row, only if it was set."""
        if self._bias_set[i]:
            with torch.inference_mode():
                self._bias_dev[i].zero_()
            self._bias_set[i] = False

    def _clear_stop(self, i: int) -> None:
        """Zero a released slot's min_tokens row, only if it was set."""
        self.min_toks[i] = 0
        if self._stop_set[i]:
            with torch.inference_mode():
                self._stop_dev[i].zero_()
            self._stop_set[i] = False

    def _admit(self) -> None:
        # cross-thread engine tasks first (KV export / import, migration)
        self._run_tasks()
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
            # pop-or-put-back under the cap lock: a submit between the two
            # would see a queue one short and overshoot max_queue
            with self._cap_lock:
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
            if req.trace_ctx is not None:
                TRACER.point("engine.admitted", parent=req.trace_ctx, slot=i,
                             prefill_tokens=len(fed))
            if req.t_admit == 0.0:
                req.t_admit = time.monotonic()
            self.slots[i] = req
            # gap metric: only back-to-back decode chunks count
            self._last_drain_done = None
            self.prompts[i, : len(fed)] = fed
            self._prompts_version += 1  # the device prompt mirror refreshes
            self.prompt_lens[i] = len(fed)
            self.next_token[i] = fed[0]
            self._carry_dirty.add(i)  # the host rewrote this slot's feed row
            self.gen_before[i] = len(req.output)
            self.priorities[i] = req.priority
            self.temps[i] = req.temperature
            self.top_ks[i] = req.top_k
            self.top_ps[i] = req.top_p
            self.adapter_ids[i] = self.adapter_index[req.adapter]
            self.freq_pens[i] = req.frequency_penalty
            self.pres_pens[i] = req.presence_penalty
            if req.seed is not None:
                self.seeds[i] = req.seed
                self._seeded[i] = True
            if req.logit_bias or req.allowed_tokens:
                self._set_row(self._bias_dev, i, _bias_row_cached(req, self.cfg.vocab_size))
                self._bias_set[i] = True
            # the REMAINING floor: tokens generated before a spill count
            floor = max(0, req.min_tokens - int(self.gen_before[i]))
            self.min_toks[i] = floor
            if floor > 0 and req.stop_tokens:
                self._ensure_stop_rows()
                self._set_row(self._stop_dev, i, _stop_row_cached(req, self.cfg.vocab_size))
                self._stop_set[i] = True
            self.emitted[i] = int(self.gen_before[i])
            self.stalled[i] = False
            # no page zeroing: the position mask only exposes positions
            # <= length, all of which the new tenant rewrites
            matched = self._match_prefix(i) if self.prefix_cache else 0
            if self.prefix_cache:
                self.prefix_lookups += 1
                if matched:
                    self.prefix_admission_hits += 1
            self.matched_toks[i] = matched
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
        # the slot's adapter seeds the chain: its pages match only prompts
        # under the same adapter
        key = _prefix_seed(int(self.adapter_ids[i]))
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
        key = _prefix_seed(int(self.adapter_ids[i]))  # as in _match_prefix
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
        # the slot's adapter (1,), passed only by an engine with a bank; the
        # mesh only by an engine on one
        ad = {} if self.mesh is None else {"mesh": self.mesh}
        if self.lora_bank:
            ad.update(bank=self.lora_bank,
                      aids=torch.tensor(self.adapter_ids[i:i + 1], device=self.device))
        if t0 == 0:
            logits, self.kv = _paged_prefill(
                self.params, toks, self.kv, row, n, cfg=self.cfg, page_size=self.page_size,
                **ad,
            )
        else:
            logits, self.kv = _paged_prefill_prefixed(
                self.params, toks, self.kv, row, t0, n, cfg=self.cfg,
                page_size=self.page_size, **ad,
            )
        self.prefills_run += 1
        self._last_drain_done = None  # gap metric: decode chunks only
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
            self._carry_dirty.add(i)
            return
        if rem < 2 or not self._ensure_pages(i, plen):
            return
        self.prefilling[i] = False  # the final (or only) pass emits below
        logits = self._prefill_dispatch(i, t0, rem)
        V = self.cfg.vocab_size
        host_rows = []  # the rows the decode chunk would add, in its order
        if req.logit_bias or req.allowed_tokens:
            host_rows.append(_bias_row_cached(req, V))
        if self.min_toks[i] > 0 and req.stop_tokens:
            # this emission's index is gen_before, below the remaining floor
            host_rows.append(_stop_row_cached(req, V))
        if host_rows:
            lg = logits.cpu().numpy()
            for row in host_rows:
                lg = lg + row
            logits = torch.from_numpy(lg).to(self.device)
        if (req.frequency_penalty or req.presence_penalty) and self.gen_before[i] > 0:
            # a resumed request's prior output counts from its first emission
            cnt = np.zeros(V, np.float32)
            np.add.at(cnt, np.asarray(req.output, np.int64), 1.0)
            lg = logits.cpu().numpy()
            lg = lg - req.frequency_penalty * cnt - req.presence_penalty * (cnt > 0)
            logits = torch.from_numpy(lg.astype(np.float32)).to(self.device)
        if req.temperature > 0:
            row_seeds = None
            if req.seed is not None:
                # keyed like the chunks: the distribution sits at the
                # prompt's last position
                dev = self.device
                row_seeds = (torch.tensor([req.seed], dtype=torch.int64, device=dev),
                             torch.ones(1, dtype=torch.bool, device=dev),
                             torch.tensor([plen - 1], dtype=torch.int64, device=dev))
            tok = int(sample_static(
                logits[None], self.generator, temperature=req.temperature,
                top_k=req.top_k, top_p=req.top_p, row_seeds=row_seeds,
            )[0])
        else:
            tok = int(torch.argmax(logits))
        if req.logprobs > 0:
            # the first emission's logprobs, from the (V,) row on the host
            lg = logits.cpu().numpy().astype(np.float32)
            lse = float(np.logaddexp.reduce(lg))
            top = np.argsort(-lg, kind="stable")[: req.logprobs]
            self._emit(req, tok, lg[tok] - lse,
                       [(int(t), float(lg[t] - lse)) for t in top])
        else:
            self._emit(req, tok)
        self.emitted[i] = int(self.gen_before[i]) + 1
        self.lengths[i] = plen
        self.next_token[i] = tok
        self._carry_dirty.add(i)
        if self._stops(i, req, tok) or self.emitted[i] >= req.max_new_tokens or req.cancelled:
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
        self.adapter_ids[i] = 0
        self.matched_toks[i] = 0
        self._seeded[i] = False
        self._clear_bias(i)
        self._clear_stop(i)
        if self.draft is not None:
            self.draft_len[i] = 0  # its rows are rewritten lazily

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

    def evict_slot(self, i: int, requeue: bool = True) -> None:
        """Evict a live slot (a spill, a pool-exhaustion preemption, a
        migration): free its pages and, with ``requeue``, requeue the
        request for an exact resume.  An eviction from outside the step can race an overlapped
        chunk in flight, so this slot's stake in it is dropped FIRST: the
        drain pins a row by (slot, request) identity, and a request
        re-admitted into the same slot index would pass that pin and take
        the stale chunk's tokens on top of its re-prefilled stream.  The
        dropped chunk is the bounded loss, at most one per eviction,
        counted in ``chunks_discarded``."""
        req = self.slots[i]
        if req is None:
            return
        if self._pending is not None:
            kept = [(s, r) for (s, r) in self._pending.pairs if s != i]
            if len(kept) != len(self._pending.pairs):
                self.chunks_discarded += 1
                self._pending.pairs = kept
        self._release_slot(i)
        if requeue and not req.done.is_set():
            self._enqueue(req)

    # -- the disaggregated serving data plane (utils/kvwire) ----------------

    def run_task(self, fn, timeout: float = 30.0, abandon_on_timeout: bool = True):
        """Run ``fn()`` on the engine thread (drained at the top of every
        ``_admit``) and return its result, re-raising what it raised.  The
        caller must be another thread than the one driving the engine
        (the ``EngineLoop`` case); with no loop running this times out.
        On a mirrored engine it runs on rank 0 only: fit for reads of the
        mirrored host state (``cached_prefix_pages``); what changes state
        goes through ``run_verb``.

        A timeout ABANDONS the thunk: the engine thread skips it if it has
        not started, so a timed-out caller may treat the task as never run
        (a late migrate-in import would otherwise resurrect the session on
        a second replica).  Who wins is decided under one lock: a thunk
        that started before the caller gave up runs to its end, and the
        caller waits for its result.  ``abandon_on_timeout=False`` keeps
        it runnable, for a thunk that must happen (the refused
        migrate-out's local requeue: losing it loses the session)."""
        done = threading.Event()
        lock = threading.Lock()
        box: dict = {"state": "queued"}

        def thunk():
            with lock:
                if box["state"] == "abandoned":  # the caller gave up first
                    return
                box["state"] = "started"
            try:
                box["result"] = fn()
            except BaseException as e:  # re-raised on the caller's thread
                box["error"] = e
            finally:
                done.set()

        self._tasks.put(thunk)
        self._work.set()  # wake a parked EngineLoop
        if not done.wait(timeout):
            with lock:
                started = box["state"] == "started"
                if not started and abandon_on_timeout:
                    box["state"] = "abandoned"
            if not started:
                raise TimeoutError("engine task timed out (no engine loop?)")
            done.wait()  # its effects land: its result is the answer
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def run_verb(self, verb: str, *, timeout: float = 30.0, abandon_on_timeout: bool = True,
                 local: Optional[dict] = None, **args):
        """A disaggregated verb from another thread than the engine's (the
        HTTP handlers), with ``run_task``'s timeout and abandon rule:
        ``export`` (tokens, adapter, max_pages → bundle bytes or None),
        ``import`` (header, pages → the import's counts), ``migrate_out``
        (slot or None, ``local={"chooser": fn(engine, skip)}`` → (slot,
        request, bundle, pages shipped) or None), ``migrate_in`` (header,
        pages, ``local={"req": session_request(state)}`` → the live
        request), ``requeue`` (the refused migration's ``local={"req"}``
        and pages → None).  A bundle's geometry and a session's state are
        checked here, before anything is queued: a refusal lands nothing.

        On one device the verb runs as an engine task.  On a mirrored
        engine it joins rank 0's next ticket: every rank runs it at the
        same point of the round (a head-sharded pool's pages are a gather
        over ``tensor`` that every rank joins), rank 0's result comes
        back; abandoned before its ticket it runs on no rank."""
        task = self._new_task(verb, args, local)
        if not self.mirrored:
            return self.run_task(lambda: self._run_verb(task, set()), timeout=timeout,
                                 abandon_on_timeout=abandon_on_timeout)
        self._leader_only(verb)
        with self._cap_lock:
            if self.failed:
                raise RuntimeError(ENGINE_FAILED_ERROR)
            self._verb_queue.append(task)
        self._work.set()
        if not task.done.wait(timeout):
            with self._cap_lock:
                queued = task.state == "queued"
                if queued and abandon_on_timeout:
                    self._verb_queue.remove(task)
                    task.state = "abandoned"
            if queued:
                raise TimeoutError("engine task timed out (no engine loop?)")
            task.done.wait()  # in a ticket: it runs on every rank
        return task.outcome()

    def _call_verb(self, name: str, verb: str, local: Optional[dict] = None, **args):
        """A verb called directly by the thread that drives the engine: on
        one device it runs here; on a mirrored engine rank 0 sends it (and
        any verb queued before it) in a tasks-only ticket, every rank runs
        them, and no round follows."""
        self._leader_only(name)
        task = self._new_task(verb, args, local)
        if not self.mirrored:
            return self._run_verb(task, set())
        with self._cap_lock:
            self._verb_queue.append(task)
        self.exchange_ticket(tasks_only=True)
        self._run_tasks()
        return task.outcome()

    def _leader_only(self, name: str) -> None:
        if self.mirrored and not self.leader:
            raise RuntimeError(
                f"{name} on rank {self.mesh.rank}: a follower takes its requests from "
                "rank 0's tickets")

    def _new_task(self, verb: str, args: dict, local: Optional[dict]) -> _Task:
        """The task, its refusals raised now (on the caller's thread, from
        state that never changes: the bundle's geometry, the session's
        fields), so a refused one is never queued."""
        local = dict(local or {})
        if verb == "warm":  # the lattice point, every field given
            args = dict(kind=str(args["kind"]), tpad=int(args.get("tpad", 0)),
                        width=int(args.get("width", 0)),
                        flags=tuple(bool(f) for f in args.get("flags", ())))
        if verb == "export":
            args["tokens"] = [int(t) for t in args["tokens"]]
            self._chain_seed(args.get("adapter", ""))
        if verb == "import" or (verb == "migrate_in" and args["pages"] and self.prefix_cache):
            self._check_bundle(args["header"], args["pages"])
        if verb in ("migrate_in", "requeue"):
            args["session"] = {f: getattr(local["req"], f) for f in _SESSION_FIELDS}
        return _Task(verb, args, local)

    def _prepare_task(self, task: _Task, chosen: set) -> None:
        """Rank 0's decisions a task carries to every rank: a migrate-out's
        slot (the chooser's, past the slots ``chosen`` by earlier tasks of
        the same ticket; -1 when no session is live), and on a mirrored
        engine the ticket id a session enters under."""
        if task.verb == "migrate_out":
            slot = task.args.get("slot")
            if slot is None:
                live = [i for i, r in enumerate(self.slots)
                        if r is not None and not r.done.is_set() and i not in chosen]
                chooser = task.local.get("chooser")
                slot = -1 if not live else chooser(self, chosen) if chooser else live[0]
            task.args["slot"] = int(slot)
            chosen.add(int(slot))
        elif task.verb in ("migrate_in", "requeue") and self.mirrored:
            task.args["id"] = next(self._ticket_ids)

    def _run_verb(self, task: _Task, chosen: set):
        """One task on this rank (rank 0: its result; a follower: None)."""
        if not self.mirrored:
            self._prepare_task(task, chosen)
        return getattr(self, self._VERBS[task.verb])(task)

    def _run_tasks(self) -> None:
        """The engine tasks (rank 0's thunks), then the last ticket's
        disaggregated tasks in ticket order, each on every rank."""
        while True:
            try:
                thunk = self._tasks.get_nowait()
            except queue.Empty:
                break
            thunk()  # never raises: errors park in the caller's box
        tasks, self._round_tasks = self._round_tasks, []
        for n, t in enumerate(tasks):
            try:
                t.result = self._run_verb(t, set())
            except BaseException as e:  # re-raised on rank 0's caller's thread
                t.error = e
                if t.verb == "warm" and self.mirrored:
                    # a warm-up point's fault (``MeshWarmupError``, raised on
                    # every rank alike) is the round's: the tasks after it
                    # fail with the engine (``fail_mirrored``)
                    self._round_tasks = tasks[n + 1:]
                    raise
                if not self.leader:
                    log.info("rank %d: %s task raised: %s", self.mesh.rank, t.verb, e)
            finally:
                t.done.set()

    def _chain_seed(self, adapter: str) -> bytes:
        if adapter not in self.adapter_index:
            raise ValueError(
                f"unknown adapter {adapter!r} (registered: {sorted(self.adapter_index)})"
            )
        return _prefix_seed(int(self.adapter_index[adapter]))

    def _pool_keys(self) -> tuple:
        return ("k", "v", "ks", "vs") if self.kv_int8 else ("k", "v")

    def _wire_header(self, adapter: str, kind: str) -> dict:
        """The geometry an importer checks before any page lands; ``dtype``
        is numpy's name ("float32", "bfloat16", "int8"), as the
        reference writes it."""
        return {
            "kind": kind,
            "page_size": self.page_size,
            "n_layers": self.cfg.n_layers,
            "kv_heads": self.cfg.kv_heads,
            "head_dim": self.cfg.head_dim,
            "dtype": str(self.kv["k"].dtype).removeprefix("torch."),
            "kv_int8": self.kv_int8,
            "adapter": adapter,
        }

    def cached_prefix_pages(self, tokens, adapter: str = "") -> list[int]:
        """Page ids of the longest cached run of ``tokens``' leading full
        pages, capped at len - 1 as ``_match_prefix`` is (a page the
        receiver's admission can never attach is not worth shipping).
        Read-only: no reference taken, no LRU touch."""
        ps = self.page_size
        toks = np.asarray(list(tokens), np.int32)
        key = self._chain_seed(adapter)
        out: list[int] = []
        for j in range(max(0, len(toks) - 1) // ps):
            key = _prefix_page_key(key, toks[j * ps:(j + 1) * ps])
            pg = self.prefix_entries.get(key)
            if pg is None:
                break
            out.append(pg)
        return out

    def _page_payloads(self, pgs: list[int]) -> list[bytes]:
        """Pool pages ``pgs`` → each page's payload bytes (the pool keys'
        (L, page_size, ...) slices, concatenated, every kv head); [] on a
        follower.  One ``index_select`` and one device-to-host copy per
        pool key, on the engine's stream: the read is ordered after any
        chunk in flight, which writes only positions past the ones
        exported, so the bytes are confirmed.  Where the pool holds this
        rank's heads only, the blocks are first gathered over ``tensor``
        (as bytes, so every dtype travels alike) and laid out along the
        head axis, on every rank; a whole pool is read on rank 0 alone."""
        if not (self.leader or self._pool_cut):
            return []
        with torch.inference_mode():
            idx = torch.tensor(pgs, dtype=torch.long, device=self.device)
            per_key = {}
            for k in self._pool_keys():
                t = self.kv[k].index_select(1, idx)
                if self._pool_cut:
                    # the head axis is dim 3 of k / v and of the scales; a
                    # scale's bytes are its head's, so dim 3 of the bytes too
                    b = all_gather(t.contiguous().view(torch.uint8), self.mesh, "tensor", 3)
                    t = b.view(t.dtype)
                if not self.leader:
                    continue
                t = t.cpu()
                if t.dtype == torch.bfloat16:  # numpy has no bfloat16: its bits
                    t = t.view(torch.int16)
                per_key[k] = t.numpy()
        if not self.leader:
            return []
        return [
            b"".join(np.ascontiguousarray(per_key[k][:, j]).tobytes()
                     for k in self._pool_keys())
            for j in range(len(pgs))
        ]

    def export_prefix_pages(self, tokens, adapter: str = "",
                            max_pages: int = 0) -> Optional[bytes]:
        """A wire bundle of the cached pages covering ``tokens``' leading
        full pages, or None when none is cached.  The receiver re-derives
        registration keys from the shipped tokens under its own adapter
        seed, so bank-index skew between replicas cannot alias pages."""
        return self._call_verb("export_prefix_pages", "export", tokens=tokens,
                               adapter=adapter, max_pages=max_pages)

    def _export(self, task: _Task) -> Optional[bytes]:
        toks, adapter, max_pages = (task.args["tokens"], task.args.get("adapter", ""),
                                    task.args.get("max_pages", 0))
        pgs = self.cached_prefix_pages(toks, adapter)
        if max_pages > 0:
            pgs = pgs[:max_pages]
        if not pgs:
            return None
        ps = self.page_size
        payloads = self._page_payloads(pgs)
        for pg in pgs:
            self._touch(pg)  # shipped = used: kept under LRU pressure
        self.kv_exports += 1
        self.kv_pages_exported += len(pgs)
        if not self.leader:
            return None
        pages = [(toks[j * ps:(j + 1) * ps], payloads[j]) for j in range(len(pgs))]
        return kvwire.encode_bundle(
            self._wire_header(adapter, "prefix"), pages, self._chain_seed(adapter)
        )

    def _check_bundle(self, header: dict, pages: list) -> dict:
        """Refuse a bundle this engine cannot take (no prefix cache, another
        geometry, an unknown adapter, a partial page, a payload of another
        size) before anything is allocated; returns each pool key's
        (whole-head) page shape."""
        if not self.prefix_cache:
            raise ValueError("prefix cache disabled (--prefix-cache)")
        mine = self._wire_header(str(header.get("adapter", "")), "")
        for f in ("page_size", "n_layers", "kv_heads", "head_dim", "dtype", "kv_int8"):
            if header.get(f) != mine[f]:
                raise ValueError(
                    f"incompatible KV geometry: {f} {header.get(f)!r} != {mine[f]!r}"
                )
        self._chain_seed(mine["adapter"])  # raises on an unknown adapter
        ps = self.page_size
        L, hkv, hd = self.cfg.n_layers, self.cfg.kv_heads, self.cfg.head_dim
        shapes = {k: (L, ps, hkv, hd) if k in ("k", "v") else (L, ps, hkv)
                  for k in self._pool_keys()}
        payload_size = sum(int(np.prod(shapes[k])) * self.kv[k].dtype.itemsize
                           for k in self._pool_keys())
        for toks, payload in pages:
            if len(toks) != ps:
                raise ValueError("partial page in bundle")
            if len(payload) != payload_size:
                raise ValueError("payload size does not match geometry")
        return shapes

    def import_pages(self, header: dict, pages: list) -> dict:
        """Land a decoded bundle's pages in free pool pages and register
        them in the prefix cache, keyed under THIS engine's chain.  The
        geometry and every page's size are checked before anything is
        allocated or registered (a rejection lands nothing); pool
        pressure stops the import cleanly with a leading run landed
        (later pages are useless without their predecessors).  Pages are
        written in place (``index_copy_``): the pool keeps its storage,
        which captured decode graphs read by address.  On a mirrored
        engine every rank lands the same pages and writes its own kv
        heads of each.  Returns {"imported", "already", "tokens",
        "stopped"}."""
        return self._call_verb("import_pages", "import", header=header, pages=pages)

    def _import(self, task: _Task) -> dict:
        return self._import_pages(task.args["header"], task.args["pages"])

    def _import_pages(self, header: dict, pages: list) -> dict:
        shapes = self._check_bundle(header, pages)
        key = self._chain_seed(str(header.get("adapter", "")))
        ps = self.page_size
        staged: list[tuple[int, bytes]] = []
        pinned: list[int] = []  # referenced while the import runs
        imported = already = covered = 0
        stopped = None
        try:
            for toks, payload in pages:
                key = _prefix_page_key(key, np.asarray(toks, np.int32))
                existing = self.prefix_entries.get(key)
                if existing is not None:
                    already += 1
                    covered += ps
                    self._touch(existing)
                    # pinned: a later page's allocation must not evict an
                    # earlier link of the same chain
                    self.page_ref[existing] += 1
                    pinned.append(existing)
                    continue
                pg = self._alloc_page()
                if pg is None:
                    stopped = "page pool exhausted"
                    break
                self.page_ref[pg] = 1
                pinned.append(pg)
                self.prefix_entries[key] = pg
                self.page_key[pg] = key
                self._touch(pg)
                staged.append((pg, payload))
                imported += 1
                covered += ps
        finally:
            for pg in pinned:
                self.page_ref[pg] -= 1  # cached, unreferenced: LRU-evictable
        if staged:
            self._land_pages(staged, shapes)
            self.kv_imports += 1
            self.kv_pages_imported += imported
        return {"imported": imported, "already": already, "tokens": covered,
                "stopped": stopped}

    def _land_pages(self, staged: list, shapes: dict) -> None:
        """Write (page id, whole-head payload) pairs into the pool in place,
        one host-to-device copy per pool key; a rank whose pool holds its
        kv heads only writes those."""
        n = len(staged)
        heads = slice(None)
        if self._pool_cut:
            h = self.kv["k"].shape[3]
            h0 = self.mesh.axis_index("tensor") * h
            heads = slice(h0, h0 + h)
        with torch.inference_mode():
            idx = torch.tensor([pg for pg, _ in staged], dtype=torch.long, device=self.device)
            off = 0
            for k in self._pool_keys():
                size = int(np.prod(shapes[k])) * self.kv[k].dtype.itemsize
                rows = np.stack([np.frombuffer(p, np.uint8, size, off) for _, p in staged])
                src = (torch.from_numpy(rows).view(self.kv[k].dtype)
                       .reshape((n,) + shapes[k])[:, :, :, heads].transpose(0, 1))
                self.kv[k].index_copy_(1, idx, src.contiguous().to(self.device))
                off += size

    def migrate_out_bundle(self, slot: int) -> Optional[bytes]:
        """Detach live slot ``slot`` into a ``kind="session"`` bundle (the
        request's state and the pages covering its confirmed sequence),
        then evict it WITHOUT a local requeue: the caller owns the request
        from here and requeues it only if the destination refuses.  The
        eviction drops at most the one chunk in flight; the bundle holds
        confirmed state only, so the destination resumes exactly.  On a
        mirrored engine every rank evicts the slot."""
        out = self._call_verb("migrate_out_bundle", "migrate_out", slot=int(slot))
        return out[2] if out else None

    def _migrate_out(self, task: _Task):
        """(slot, request, bundle, pages shipped) on rank 0, None when the
        slot holds no live session (and on a follower)."""
        slot = task.args["slot"]
        if not 0 <= slot < self.max_batch:
            return None
        req = self.slots[slot]
        if req is None or req.done.is_set():
            return None
        seq = list(req.prompt) + list(req.output)
        ps = self.page_size
        # confirmed written positions only: lengths may run ahead for a
        # chunk in flight, but positions < len(seq) - 1 are written
        end = min(int(self.lengths[slot]), len(seq) - 1)
        n = max(0, min(end // ps, len(self.slot_pages[slot])))
        payloads = self._page_payloads(self.slot_pages[slot][:n]) if n > 0 else []
        data = None
        if self.leader:
            pages = [(seq[j * ps:(j + 1) * ps], payloads[j]) for j in range(n)]
            header = self._wire_header(req.adapter, "session")
            header["request"] = {
                "prompt": [int(t) for t in req.prompt],
                "output": [int(t) for t in req.output],
                "max_new_tokens": int(req.max_new_tokens),
                "temperature": float(req.temperature),
                "top_k": int(req.top_k),
                "top_p": float(req.top_p),
                "adapter": req.adapter,
                "stop_tokens": [int(t) for t in req.stop_tokens],
                "logprobs": int(req.logprobs),
                "token_logprobs": list(req.token_logprobs),
                "top_logprobs": [[[int(t), float(lp)] for t, lp in top]
                                 for top in req.top_logprobs],
                "logit_bias": {str(k): float(v) for k, v in req.logit_bias.items()},
                "frequency_penalty": float(req.frequency_penalty),
                "presence_penalty": float(req.presence_penalty),
                "min_tokens": int(req.min_tokens),
                "priority": int(req.priority),
                "seed": req.seed,
                "allowed_tokens": [int(t) for t in req.allowed_tokens],
                "pool_spills": int(req.pool_spills),
            }
            data = kvwire.encode_bundle(header, pages, self._chain_seed(req.adapter))
        self.sessions_migrated_out += 1
        self.kv_pages_exported += n
        self.evict_slot(slot, requeue=False)
        self._ticketed.pop(req.ticket, None)  # no longer this engine's
        if not self.leader:
            return None
        # the relay owns it now: a cancel must reach it at once, not by ticket
        req.cancelled, req.mirrored = req.cancelled or req.cancel_asked, False
        return slot, req, data, n

    def _requeue(self, task: _Task) -> None:
        """A refused handoff: the migrated-out session is this engine's
        again (an exact resume), the migrate-out counters rolled back."""
        self._enter(task)
        self.sessions_migrated_out -= 1
        self.kv_pages_exported -= task.args["pages"]

    def session_request(self, state: dict, on_token=None) -> Request:
        """A migrated session's Request from its bundle's ``request``
        state, held to ``submit``'s rules (``_invalid_reason``); raises
        ValueError on invalid state."""
        prompt = [int(t) for t in (state.get("prompt") or [])]
        if not prompt:
            raise ValueError("session has an empty prompt")
        req = Request(
            prompt=prompt,
            max_new_tokens=int(state.get("max_new_tokens", 16)),
            temperature=float(state.get("temperature", 0.0)),
            top_k=int(state.get("top_k", 0)),
            top_p=float(state.get("top_p", 1.0)),
            adapter=str(state.get("adapter", "")),
            stop_tokens=tuple(int(t) for t in (state.get("stop_tokens") or ())),
            logprobs=int(state.get("logprobs", 0)),
            logit_bias={int(k): float(v) for k, v in (state.get("logit_bias") or {}).items()},
            frequency_penalty=float(state.get("frequency_penalty", 0.0)),
            presence_penalty=float(state.get("presence_penalty", 0.0)),
            min_tokens=int(state.get("min_tokens", 0)),
            priority=int(state.get("priority", 0)),
            seed=state.get("seed"),
            allowed_tokens=tuple(int(t) for t in (state.get("allowed_tokens") or ())),
        )
        err = self._invalid_reason(req)  # submit's rule set
        if err is not None:
            raise ValueError(err)
        req.output = [int(t) for t in (state.get("output") or [])]
        req.token_logprobs = [None if lp is None else float(lp)
                              for lp in (state.get("token_logprobs") or [])]
        req.top_logprobs = [[(int(t), float(lp)) for t, lp in top]
                            for top in (state.get("top_logprobs") or [])]
        req.pool_spills = int(state.get("pool_spills", 0))
        req.on_token = on_token
        req.mirrored = self.mirrored  # on a mesh its cancel waits for its ticket
        return req

    def resume_session(self, state: dict, on_token=None) -> Request:
        """Re-create a migrated session's Request and enqueue it: admission
        feeds prompt + output and matches the imported pages, so only the
        unshipped tail is prefilled again.  Bypasses the queue cap (a
        migrated session is work in flight, not new traffic) and holds the
        state to ``submit``'s rules (``_invalid_reason``).  On a mirrored
        engine it enters every rank as a submit does (rank 0 keeps
        ``on_token``).  Raises on invalid state; returns the live
        Request."""
        self._leader_only("resume_session")
        req = self.session_request(state, on_token)
        return self._call_verb("resume_session", "migrate_in", local={"req": req},
                               header={}, pages=[])

    def _migrate_in(self, task: _Task) -> Request:
        """A migrated session's pages land (when it ships any and the prefix
        cache is on), then the session enters this engine."""
        if task.args["pages"] and self.prefix_cache:
            self._import_pages(task.args["header"], task.args["pages"])
        draining = self._ticket_draining if self.mirrored else self.draining
        if draining:
            raise RuntimeError(DRAINING_ERROR)
        req = self._enter(task, queue_it=False)
        self.sessions_migrated_in += 1
        if len(req.output) >= req.max_new_tokens:
            req.done.set()  # arrived complete: nothing left to generate
            self._ticketed.pop(req.ticket, None)
            return req
        self._enqueue(req)
        return req

    def _enter(self, task: _Task, queue_it: bool = True) -> Request:
        """The task's session on this rank (rank 0's own Request, a
        follower's from the carried fields), under its ticket id on a
        mirrored engine, and enqueued (past the queue cap)."""
        if self.leader:
            req = task.local["req"]
        else:
            req = Request(**task.args["session"])
        if self.mirrored:
            # every rank starts from the carried fields; a cancel rank 0 saw
            # since goes by the next ticket, as every later one does
            carried = task.args["session"]["cancelled"]
            req.cancel_asked = req.cancel_asked or (req.cancelled and not carried)
            req.cancelled, req.ticket, req.mirrored = carried, task.args["id"], True
            self._ticketed[req.ticket] = req
        if queue_it:
            self._enqueue(req)
        return req

    # verb → the method every rank runs it by
    _VERBS = {"export": "_export", "import": "_import", "migrate_out": "_migrate_out",
              "migrate_in": "_migrate_in", "requeue": "_requeue", "warm": "_warm_task"}

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
        log.info(
            "page pressure: spilling priority-%d slot %d (%d pages) for a "
            "priority-%d request", int(self.priorities[v]), v,
            len(self.slot_pages[v]), need,
        )
        self.spills += 1
        self.evict_slot(v)
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

    def _filters_requested(self, active) -> bool:
        return bool((self.top_ks[active] > 0).any() or (self.top_ps[active] < 1.0).any())

    def _pens_requested(self, active) -> bool:
        return bool((self.freq_pens[active] != 0).any() or (self.pres_pens[active] != 0).any())

    def _seeds_requested(self, active) -> bool:
        return bool(self._seeded[active].any())

    def _logprobs_requested(self, active) -> bool:
        """The logprob-emitting variant only when some active request
        asked: the default path never pays the top-k."""
        return any(req is not None and active[i] and req.logprobs > 0
                   for i, req in enumerate(self.slots))

    def _min_requested(self, active) -> bool:
        """The stop-suppressing variant only while some active request
        with stop ids is below its min_tokens floor."""
        return any(req is not None and active[i] and req.stop_tokens
                   and self.emitted[i] < req.min_tokens
                   for i, req in enumerate(self.slots))

    def _variant(self, active) -> dict:
        """The static flags of a pass over the ``active`` slots, so a batch
        never pays for a control none of its rows asked for: some row asks
        for top-k / top-p (``use_filters``), samples (``use_temp``), wants
        logprobs (``want_lp``), is penalised (``use_pen``), seeded
        (``use_seed``) or below its min_tokens floor (``use_min``)."""
        return dict(use_filters=self._filters_requested(active),
                    use_temp=bool((self.temps[active] > 0).any()),
                    want_lp=self._logprobs_requested(active),
                    use_pen=self._pens_requested(active),
                    use_seed=self._seeds_requested(active),
                    use_min=self._min_requested(active))

    def _host_counts(self) -> np.ndarray:
        """(B, V) counts of every GENERATED token at positions below
        ``lengths``: the penalty state, rebuilt from the output lists at
        each dispatch so nothing can drift.  A resumed request's output
        holds its pre-spill tokens, and all of them count."""
        out = np.zeros((self.max_batch, self.cfg.vocab_size), np.int32)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            n_gen = (int(self.lengths[i]) - int(self.prompt_lens[i])
                     + int(self.gen_before[i]))
            if n_gen > 0:
                np.add.at(out[i], np.asarray(req.output[:n_gen], np.int64), 1)
        return out

    def _control_args(self, v: dict, *, plens: bool = False) -> list:
        """The control tensors of a pass of variant ``v``, in the step
        functions' order (bias, fpens, ppens, counts, [plens,] seeds,
        seeded, stop_rows, min_toks); a control the variant does not use
        is None.  The bias rows always ride (zero rows are a no-op)."""
        ds = self._ds
        pen, seed, mn = v["use_pen"], v["use_seed"], v["use_min"]
        out = [
            self._bias_dev,
            ds.get("freq_pens", self.freq_pens) if pen else None,
            ds.get("pres_pens", self.pres_pens) if pen else None,
            ds.get("counts", self._host_counts()) if pen else None,
        ]
        if plens:
            out.append(ds.get("prompt_lens", self.prompt_lens) if pen or mn else None)
        return out + [
            ds.get("seeds", self.seeds) if seed else None,
            ds.get("seeded", self._seeded) if seed else None,
            self._stop_dev if mn else None,
            ds.get("min_toks", self.min_toks) if mn else None,
        ]

    def _adapter_args(self) -> list:
        """(bank, adapter ids) of a pass: the ids a device mirror refreshed
        in place, so a graph replay reads the batch's current adapters and a
        new mix is a refresh, not a capture; (None, None) without a bank."""
        if not self.lora_bank:
            return [None, None]
        return [self.lora_bank, self._ds.get("adapter_ids", self.adapter_ids)]

    def _static(self, v: dict, **kw) -> dict:
        """The step functions' keyword flags for variant ``v`` (and the
        mesh, on one)."""
        if self.mesh is not None:
            kw["mesh"] = self.mesh
        return dict(cfg=self.cfg, page_size=self.page_size, paged_kernel=self.paged_kernel,
                    use_filters=v["use_filters"], use_temp=v["use_temp"],
                    logprobs_k=self.logprobs_k if v["want_lp"] else 0,
                    use_pen=v["use_pen"], use_seed=v["use_seed"], use_min=v["use_min"], **kw)

    @staticmethod
    def _top_list(ids_row, lps_row, n: int) -> list:
        """[(token id, logprob), ...] of one emission, cut to the asked
        width."""
        return [(int(t), float(lp)) for t, lp in zip(ids_row[:n], lps_row[:n])]

    def _spec_useful(self) -> bool:
        """The verify pass beats sequential chunks only when some slot can
        use the window: a slot still feeding its prompt (W tokens a pass
        instead of one a step) or a greedy slot generating (drafts)."""
        for i, req in enumerate(self.slots):
            if req is None or req.cancelled or self.prefilling[i]:
                continue  # mid-chunked-prefill slots sit out verify passes
            if self.lengths[i] < self.prompt_lens[i] - 1:
                return True
            if self.temps[i] == 0:
                return True
        return False

    def _drain_pending(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self._drain_chunk(pending)

    def _step_chunk(self) -> None:
        """One fused chunk, dispatched then drained at once (the exact
        sequential loop)."""
        pending = self._dispatch_chunk()
        if pending is not None:
            self._drain_chunk(pending)

    def _step_chunk_overlapped(self) -> None:
        """Double-buffered decode step: dispatch the next chunk off the
        device carry, THEN drain the previous chunk while the new one
        runs.  When the dispatch finds the page pool exhausted it first
        drains the pending chunk (its completions may free pages) and
        retries once; a second exhaustion is real overload."""
        pending, self._pending = self._pending, None
        try:
            new = self._dispatch_chunk(pipelined=pending is not None)
        except RuntimeError as e:
            if pending is None or "page pool exhausted" not in str(e):
                raise
            self._drain_chunk(pending)
            pending = None
            new = self._dispatch_chunk()
        if pending is not None:
            self._drain_chunk(pending)
        self._pending = new

    def _step_verify(self) -> None:
        """Speculative engine step: build each active slot's verify window
        on the host (the confirmed token, then prompt tokens and/or
        drafts), run ONE wide pass, and accept per slot the longest fed
        prefix the model itself would have produced, plus the model's own
        "bonus" token after it.  Greedy slots emit 1..W tokens a pass,
        token-identical to the sequential engine; sampled slots emit one."""
        from .speculative import propose_ngram

        W = self.spec_k + 1
        B = self.max_batch
        prepared = self._prepare_step(W)
        if prepared is None:
            return
        self.steps_run += 1
        active, view = prepared
        draft_rows = self._propose_draft_model(active) if self.draft is not None else None
        feed = np.zeros((B, W), np.int32)
        for i, req in enumerate(self.slots):
            if req is None or not active[i]:
                continue
            p = int(self.lengths[i])
            plen = int(self.prompt_lens[i])
            feed[i, 0] = self.next_token[i]
            j = 1
            while j < W and p + j < plen:  # prompt feeding: always valid
                feed[i, j] = self.prompts[i, p + j]
                j += 1
            if j < W and self.temps[i] == 0:
                if draft_rows is not None:
                    # the draft's continuation starts right after the last
                    # known position, which is the window's first free slot
                    drafts = [int(t) for t in draft_rows[i, : W - j]]
                else:
                    # prompt + output is exactly the tokens at positions
                    # 0..p, so the proposal lands at the first free slot
                    drafts = propose_ngram(list(req.prompt) + req.output, self.spec_ngram,
                                           W - j)
                for d in drafts:
                    feed[i, j] = d
                    j += 1
        v = self._variant(active)
        want_lp = v["want_lp"]
        ds = self._ds
        self._last_drain_done = None  # gap metric: decode chunks only
        out, self.kv = _fused_verify_chunk(
            self.params, self.kv, ds.get("view", view), ds.put("feed", feed),
            ds.get("lengths", self.lengths), ds.get("active", active),
            ds.get("temps", self.temps), ds.get("top_ks", self.top_ks),
            ds.get("top_ps", self.top_ps), self.generator,
            *self._control_args(v, plens=True), *self._adapter_args(), **self._static(v),
        )
        if want_lp:
            picked, chosen_lp, top_ids, top_lps = (t.cpu().numpy() for t in out)
        else:
            picked = out.cpu().numpy()  # (B, W)
        self.spec_passes += 1

        def emit_at(req, i, tok, w):
            """Emit with the logprobs of window position w's distribution,
            the one the token at fed position w + 1 was drawn from."""
            if want_lp and req.logprobs > 0:
                self._emit(req, tok, chosen_lp[i, w],
                           self._top_list(top_ids[i, w], top_lps[i, w], req.logprobs))
            else:
                self._emit(req, tok)

        for i, req in enumerate(self.slots):
            if req is None or not active[i]:
                continue
            p = int(self.lengths[i])
            plen = int(self.prompt_lens[i])
            greedy = self.temps[i] == 0
            # longest valid fed prefix: prompt positions are valid by
            # definition; a greedy draft is valid iff it equals the model's
            # own choice at the previous position
            A = 1
            while A < W:
                if p + A < plen:
                    A += 1
                elif greedy and feed[i, A] == picked[i, A - 1]:
                    A += 1
                else:
                    break
            stopped = exhausted = False
            for j in range(1, A):
                if p + j < plen:
                    continue  # a prompt position: nothing to emit
                tok = int(feed[i, j])
                # accepted: feed[i, j] == picked[i, j - 1], drawn at j - 1
                emit_at(req, i, tok, j - 1)
                self.emitted[i] += 1
                self.spec_accepted += 1
                if self._stops(i, req, tok):
                    stopped = True
                    A = j + 1  # the confirmed rows end at the stop token
                    break
                if self.emitted[i] >= req.max_new_tokens:
                    exhausted = True
                    A = j + 1
                    break
            if not stopped and not exhausted and p + A >= plen:
                # the model's own token after the last valid fed position
                tok = int(picked[i, A - 1])
                emit_at(req, i, tok, A - 1)
                self.emitted[i] += 1
                if self._stops(i, req, tok):
                    stopped = True
            # rows p..p+A-1 hold confirmed K/V; the bonus token (position
            # p+A) is fed, and its row written, by the next pass
            self.lengths[i] = p + A
            if stopped or self.emitted[i] >= req.max_new_tokens or req.cancelled:
                req.done.set()
                self._release_slot(i)
            else:
                self.next_token[i] = (
                    self.prompts[i, p + A] if p + A < plen else int(picked[i, A - 1])
                )

    def _draft_context_token(self, i: int, q: int) -> int:
        """Slot i's token at position q of its fed prompt + output."""
        plen = int(self.prompt_lens[i])
        if q < plen:
            return int(self.prompts[i, q])
        return self.slots[i].output[int(self.gen_before[i]) + q - plen]

    def _propose_draft_model(self, active) -> np.ndarray:
        """Catch the draft cache up on newly confirmed context, then roll
        the draft model spec_k greedy steps: drafts (B, spec_k).

        Slot i's context is positions 0..max(lengths, plen - 1): prompt
        tokens are known before the target sees them, so the draft may read
        ahead of the paged cache.  Long backlogs pre-ingest in
        ``_draft_chunk``-wide passes; the last pass ingests at most W new
        tokens and proposes in the same call."""
        B, W = self.max_batch, self.spec_k + 1
        # a pass where no greedy row reads drafts skips all draft work: the
        # backlog accumulates and a later consuming pass catches up
        consumer = any(
            req is not None and active[i] and self.temps[i] == 0
            and int(self.lengths[i]) + W > int(self.prompt_lens[i])
            for i, req in enumerate(self.slots)
        )
        if not consumer:
            return np.zeros((B, self.spec_k), np.int32)
        pend: list[list[int]] = [[] for _ in range(B)]
        for i, req in enumerate(self.slots):
            if req is None or not active[i]:
                continue
            q_end = max(int(self.lengths[i]), int(self.prompt_lens[i]) - 1)
            pend[i] = [self._draft_context_token(i, q)
                       for q in range(int(self.draft_len[i]), q_end + 1)]
        dev = self.device
        CH = self._draft_chunk
        while max((len(t) for t in pend), default=0) > W:
            feed = np.zeros((B, CH), np.int32)
            counts = np.zeros(B, np.int32)
            for i, toks in enumerate(pend):
                if len(toks) <= W:
                    continue  # small backlogs wait for the propose pass, which
                    # must not start its rollout from a pad token's logits
                take = toks[:CH]
                feed[i, : len(take)] = take
                counts[i] = len(take)
                pend[i] = toks[CH:]
            _draft_forward(self.draft_params, self.dkv, torch.tensor(feed, device=dev),
                           torch.tensor(self.draft_len, device=dev), dcfg=self.draft_cfg)
            self.draft_len += counts
        feed = np.zeros((B, W), np.int32)
        counts = np.zeros(B, np.int32)
        starts = self.draft_len.copy()
        advance = np.zeros(B, np.int32)
        for i, toks in enumerate(pend):
            if not toks and self.draft_len[i] > 0 and active[i]:
                # caught up already: feed the last context token again one
                # position back, so the rollout starts from real logits
                # (rewriting that position's K/V is idempotent)
                q = int(self.draft_len[i]) - 1
                feed[i, 0] = self._draft_context_token(i, q) if self.slots[i] is not None else 0
                counts[i] = 1
                starts[i] = q
            else:
                feed[i, : len(toks)] = toks
                counts[i] = len(toks)
                advance[i] = len(toks)
        drafts, _ = _draft_ingest_propose(
            self.draft_params, self.dkv, torch.tensor(feed, device=dev),
            torch.tensor(starts, device=dev), torch.tensor(counts, device=dev),
            dcfg=self.draft_cfg, k=self.spec_k,
        )
        self.draft_len += advance
        return drafts.cpu().numpy()

    def _carry_feed(self):
        """(next tokens, lengths) device tensors for the next chunk: the
        previous chunk's carry, with host-mutated slots patched in; a full
        upload from the host only after a mode switch (engine start, a
        verify pass).  Every update is in place: captured graphs read and
        write these two tensors."""
        ds = self._ds
        if self._carry is None:
            self._carry_dirty.clear()
            tok, ln = self._carry_bufs
            with torch.inference_mode():
                tok.copy_(ds.put("carry_tok", self.next_token))
                ln.copy_(ds.put("carry_len", self.lengths))
            ds.uploads += 2
            self._carry = self._carry_bufs
            return self._carry
        if self._carry_dirty:
            mask = np.zeros(self.max_batch, bool)
            mask[sorted(self._carry_dirty)] = True
            self._carry_dirty.clear()
            tok, ln = self._carry
            with torch.inference_mode():
                m = ds.put("carry_mask", mask)
                tok.copy_(torch.where(m, ds.put("carry_tok", self.next_token), tok))
                ln.copy_(torch.where(m, ds.put("carry_len", self.lengths), ln))
            ds.uploads += 1
        return self._carry

    def _dispatch_chunk(self, pipelined: bool = False) -> Optional[_PendingChunk]:
        """Prepare and dispatch one fused decode chunk; returns the record
        to drain, or None when nothing is runnable.  Batch state rides the
        device mirrors (``_ds``) and the carry, so a steady-state dispatch
        uploads nothing.  Host ``lengths`` advance at once by K for active
        slots (data-independent), so page growth and admission stay exact
        while the tokens are in flight.

        ``pipelined``: the previous chunk was still undrained when this one
        was queued, so the device never waited and the gap sample is 0."""
        K = self.fused_steps
        prepared = self._prepare_step(K)
        if prepared is None:
            return None
        self.steps_run += 1
        active, view = prepared
        v = self._variant(active)
        carry = self._carry_feed()
        if pipelined:
            self.host_gap_chunks += 1
            self.last_host_gap_ms = 0.0
            self._gap_sample(0.0)
        elif self._last_drain_done is not None:
            gap = time.perf_counter_ns() - self._last_drain_done
            self.host_gap_ns += gap
            self.host_gap_chunks += 1
            self.last_host_gap_ms = gap / 1e6
            self._gap_sample(self.last_host_gap_ms)
        # before the lengths advance below: the control counts cover
        # positions below the chunk's first
        args = self._chunk_args(v, view, active, carry)
        static = self._static(v, n_steps=K)
        if self._capture:
            out = self._replay_chunk(self._graph_key(v, view.shape[1]), args, static)
        else:
            out = _chunk_in_place(*args, **static)
        host = ready = None
        if self._out_bufs:
            # the outputs' way to the host, queued right behind the chunk,
            # into pinned buffers made once per (output, shape, dtype)
            bufs = self._out_bufs[self._out_next]
            self._out_next ^= 1
            host = []
            for j, t in enumerate(out if v["want_lp"] else (out,)):
                buf = bufs.get(j)
                if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                    buf = bufs[j] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                host.append(buf)
            ready = torch.cuda.Event()
            ready.record()
        pos0 = self.lengths.copy()
        idx = np.nonzero(active)[0]
        self.lengths[idx] += K
        pairs = [(int(i), self.slots[int(i)]) for i in idx]
        return _PendingChunk(out=out, want_lp=v["want_lp"], n_steps=K, pos0=pos0,
                             pairs=pairs, host=host, ready=ready)

    def _chunk_args(self, v: dict, view: np.ndarray, active: np.ndarray, carry) -> tuple:
        """A decode chunk's positional arguments for variant ``v``: the
        persistent device mirrors of the batch state (refreshed where the
        host arrays changed) and the ``carry`` (tokens, lengths) tensors."""
        ds = self._ds
        return (
            self.params, self.kv, ds.get("view", view), *carry, ds.get("active", active),
            ds.get_versioned("prompts", self.prompts, self._prompts_version),
            ds.get("prompt_lens", self.prompt_lens), ds.get("temps", self.temps),
            ds.get("top_ks", self.top_ks), ds.get("top_ps", self.top_ps), self.generator,
            *self._control_args(v), *self._adapter_args(),
        )

    @staticmethod
    def _graph_key(v: dict, bucket: int) -> tuple:
        """A decode graph's key: the table-view bucket and the six flags."""
        return (bucket, v["use_filters"], v["use_temp"], v["want_lp"], v["use_pen"],
                v["use_seed"], v["use_min"])

    def graph_keys(self) -> set:
        """The ``_graph_key`` of every decode graph captured so far."""
        return set(self._aot_chunk.keys) if self._aot_chunk is not None else set()

    def _replay_chunk(self, key, args, static):
        """One decode chunk as a CUDA graph replay (captured at the first
        dispatch of its static shape and controls variant, ``_graph_key``,
        unless the lattice warm-up captured it).  The wrappers counted the
        graph's kernel launches once, at capture; every replay adds them to
        ``_build.LAUNCHES``, as eager calls would."""
        graph, out, launches = self._aot_chunk.build(key, args, static)
        graph.replay()
        self.graph_replays += 1
        for name, n in launches.items():
            _build.LAUNCHES[name] += n
        return out

    def _scratch_chunk(self, args, static) -> None:
        """Run ``_chunk_in_place`` once off the engine's state: every row
        inactive on the scratch page, a copy of the carry, a generator of
        its own.  It writes the scratch page only."""
        view, tok, ln, active = args[2], args[3], args[4], args[5]
        warm = list(args)
        warm[2], warm[3], warm[4] = torch.zeros_like(view), tok.clone(), ln.clone()
        warm[5] = torch.zeros_like(active)
        warm[11] = torch.Generator(device=self.device)
        _chunk_in_place(*warm, **static)

    def _capture_chunk(self, key, args, static):
        """Capture ``_chunk_in_place`` on ``args`` (the persistent device
        tensors every replay reads) into a CUDA graph in the engine's shared
        pool.  Before the first capture of each flag set (``key`` without
        its bucket) one eager chunk runs, on the capture stream and off the
        engine's state (every row inactive on the scratch page, a copy of
        the carry, a generator of its own), so first-use work (library
        handles, first launches of the set's operators) happens outside a
        capture; another bucket of the set differs only in the table
        view's width.  The capture is begun and ended on the stream
        directly: ``torch.cuda.graph``'s entry would synchronize and empty
        the allocator's and the pinned host caches at every capture, which
        the next chunk then refills.  The cyclic garbage collector is held
        off during the capture: an unreachable engine freed mid-capture (its
        graphs, pool memory, events) would make CUDA calls that invalidate
        it.  No fallback: a failed capture raises."""
        t0 = time.perf_counter()
        stream = self._capture_stream
        with torch.inference_mode():
            stream.wait_stream(torch.cuda.current_stream(self.device))
            if key[1:] not in self._warmed_variants:
                with torch.cuda.stream(stream):
                    self._scratch_chunk(args, static)
                self._warmed_variants.add(key[1:])
                self.graph_warmups += 1
                self.graph_warmup_s += time.perf_counter() - t0
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(self.generator)
            before = dict(_build.LAUNCHES)
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.stream(stream):
                    graph.capture_begin(self._graph_pool)
                    try:
                        out = _chunk_in_place(*args, **static)
                    finally:
                        graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
            torch.cuda.current_stream(self.device).wait_stream(stream)
        # the capture launched nothing: its counts move to the replays
        launches = {}
        for name, n in _build.LAUNCHES.items():
            if n != before[name]:
                launches[name] = n - before[name]
                _build.LAUNCHES[name] = before[name]
        self.graphs_captured += 1
        self.graph_capture_s += time.perf_counter() - t0
        return graph, out, launches

    def _drain_chunk(self, pending: _PendingChunk) -> None:
        """Bring a chunk's sampled tokens to the host and emit them.  Slots
        released or re-tenanted since the dispatch (a stop or cancel seen
        one chunk late under overlap, a spill) are skipped: their in-flight
        tokens are the bounded overshoot and are discarded."""
        arrs = pending.arrays()
        sampled = arrs[0]  # (B, K)
        if pending.want_lp:
            chosen_lp, top_ids, top_lps = arrs[1:]
        # from here to the next dispatch the device idles unless a later
        # chunk is already queued: the window the host-gap metric measures
        self._last_drain_done = time.perf_counter_ns()
        K = pending.n_steps
        for i, req in pending.pairs:
            if self.slots[i] is not req or req.done.is_set():
                self.chunks_discarded += 1
                continue  # released since dispatch
            pos = int(pending.pos0[i])
            plen = int(self.prompt_lens[i])
            stopped = False
            for s in range(K):
                # step s sampled at position pos+s: a real emission iff at
                # or past the last prompt token
                if pos + s >= plen - 1 and self.emitted[i] < req.max_new_tokens:
                    tok = int(sampled[i, s])
                    if pending.want_lp and req.logprobs > 0:
                        self._emit(req, tok, chosen_lp[i, s],
                                   self._top_list(top_ids[i, s], top_lps[i, s], req.logprobs))
                    else:
                        self._emit(req, tok)
                    self.emitted[i] += 1
                    if self._stops(i, req, tok):
                        stopped = True  # samples past the stop are dropped
                        break
            # the host mirror of the device carry (same selection), so it
            # does not dirty the carry: it feeds verify windows
            self.next_token[i] = (
                self.prompts[i, pos + K] if pos + K < plen else sampled[i, K - 1]
            )
            if stopped or self.emitted[i] >= req.max_new_tokens or req.cancelled:
                req.done.set()
                self._release_slot(i)
