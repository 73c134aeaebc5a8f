"""Flagship decoder-only transformer LM, dense forward and backward.

Counterpart of ``elastic_gpu_scheduler_tpu/models/transformer.py``: the
same config, the same L-stacked parameter dict (weights stored (in, out),
so ``x @ w`` matches), the same norm, rotary and GQA conventions.  Layers
run as a Python loop over the stacked leaves instead of ``lax.scan``;
attention goes through the port's ``flash_attention`` (kernel K1 forward
and K4 backward on CUDA).  ``cfg.remat`` recomputes each layer in the
backward (``torch.utils.checkpoint``, the counterpart of
``jax.checkpoint``); ``cfg.xent_chunks`` selects the vocab-chunked loss in
``models/train.py``.

A layer tree may carry LoRA leaves (``<family>_lora`` = {"a", "b"},
``models/lora.inject_lora``): ``_proj`` adds their term in the activation
domain.  ``cfg.n_experts`` > 0 replaces each layer's FFN by the Switch
MoE FFN (``models/moe.moe_ffn``), whose auxiliary loss ``hidden_with_aux``
sums over the layers.  A tree from ``quantize.quantize_params`` (int8
weights) runs the forward through ``quantize.wmatmul`` (kernel KE on
CUDA) and its embedding table is gathered before it is dequantised.

On a mesh (``parallel/mesh.Mesh``, connected) each rank holds its slice of
every leaf (``parallel/sharding``) and runs the reference's layout with
explicit collectives (``parallel/collectives``): a vocab-sharded embedding
(rows it does not hold masked, a sum over ``tensor``), column-parallel
wq / wk / wv / w_gate / w_in and row-parallel wo / w_out (Megatron's f and
g operators over ``tensor``: each rank computes its own query and KV
heads), ``fsdp``-sharded weights gathered where a layer uses them (inside
the remat region, so the backward gathers again) and their gradients
reduce-scattered, and the sequence cut over ``seq``: RoPE positions at the
shard's global offset, attention by the ring (``parallel/ring``, K3 and
K4) under ``cfg.use_ring_attention``, else by K1 over the keys gathered up
to the shard's end.  With ``cfg.n_microbatches`` > 0 and a ``pipe`` axis
past 1 the layers run in the GPipe schedule (``parallel/pipeline``), each
stage its L/PP layers, with the ring inside the stages when it is on (the
reference's sp × pp); ``n_microbatches`` without a ``pipe`` axis runs the
plain path, as the reference does, and a ``pipe`` axis without it
replicates the layers.  MoE layers split their experts over ``expert``
(``models/moe``), and LoRA leaves take the slice of each adapter that
matches their projection's.  Int8 weights on more than one rank do not
train: ``check_mesh_model`` refuses them by name on the training path
(they serve on a mesh: ``models/serving``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import flash_attention
from ..ops.xent import mm_f32
from ..parallel.collectives import copy_to, gather_from, group_size, reduce_from
from ..parallel.mesh import MeshSpec
from ..parallel.sharding import BATCH_AXES
from .moe import moe_ffn
from .quantize import is_qtensor, wmat, wmatmul

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"dtype {name!r} not supported by the port (want one of {sorted(_DTYPES)})"
        ) from None


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False); pass "
            "device='cpu' to run the port's plain PyTorch path"
        )
    return dev


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    d_ff: int = 1376
    n_kv_heads: int = 0  # 0 → MHA; 0 < n_kv_heads < n_heads → GQA
    window_size: int = 0  # >0 → sliding-window attention
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"  # compute dtype
    params_dtype: str = ""  # at-rest dtype of the matmul weights ("" → dtype)
    remat: bool = False
    use_ring_attention: bool = False
    n_experts: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    n_microbatches: int = 0
    xent_chunks: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def rest_dtype(self) -> torch.dtype:
        return torch_dtype(self.params_dtype or self.dtype)


def pipelined(cfg: TransformerConfig, mesh) -> bool:
    """Whether the layers run in the pipeline schedule: ``n_microbatches``
    set and a ``pipe`` axis past 1 (the reference's condition).  ``mesh``
    is a ``Mesh``, the ``MeshSpec`` a job asks for, or None."""
    if mesh is None or cfg.n_microbatches <= 0:
        return False
    spec = mesh if isinstance(mesh, MeshSpec) else mesh.spec
    return spec.pipe > 1


def check_mesh_model(cfg: TransformerConfig, mesh, params=None) -> None:
    """Raise, by name, on what the training mesh path does not run: int8
    weights on more than one rank (serving runs them; NotImplementedError);
    and on what the mesh cannot cut (ValueError): head counts the tensor axis cannot split,
    layers the pipe axis cannot, experts the expert axis cannot, a sliding
    window under the ring.  ``mesh`` is a ``Mesh`` or the ``MeshSpec`` a
    job asks for."""
    if mesh is None:
        return
    spec = mesh if isinstance(mesh, MeshSpec) else mesh.spec
    sizes, n = spec.sizes, spec.num_devices
    if n == 1:
        return
    if params is not None:
        for name, leaf in params["layers"].items():
            if is_qtensor(leaf):
                raise NotImplementedError(
                    f"int8 layer leaf {name!r} on a mesh of {n} ranks does not train: "
                    "the training path refuses int8 weights on a mesh (they serve "
                    "on one: InferenceEngine(mesh=...))")
    T = sizes["tensor"]
    if cfg.n_heads % T or cfg.kv_heads % T:
        raise ValueError(f"tensor={T} must divide n_heads={cfg.n_heads} and "
                         f"kv heads={cfg.kv_heads} (each rank keeps whole heads)")
    if sizes["seq"] > 1 and cfg.use_ring_attention and cfg.window_size:
        raise NotImplementedError("sliding window + ring attention is not supported "
                                  "(the reference asserts the same)")
    if cfg.n_experts > 0 and cfg.n_experts % sizes["expert"]:
        raise ValueError(f"n_experts={cfg.n_experts} not divisible by expert="
                         f"{sizes['expert']} (each rank keeps n_experts/expert experts)")
    if pipelined(cfg, spec):
        P = sizes["pipe"]
        if cfg.n_layers % P:
            raise ValueError(f"n_layers={cfg.n_layers} not divisible by pipe={P} (each "
                             "stage keeps n_layers/pipe layers)")


# -- init --------------------------------------------------------------------


def init_params(cfg: TransformerConfig, generator: torch.Generator, device=None) -> dict:
    """Random weights with the reference's shapes, scales and at-rest
    dtypes (normal / sqrt(fan_in); fp32 norms).  The values come from
    ``generator`` and differ from ``jax.random``'s: parity tests carry
    the reference's weights across with ``bridge.params_from_jax``."""
    dev = resolve_device(device)
    D, H, F_, L, V = (
        cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff, cfg.n_layers, cfg.vocab_size
    )
    KV = cfg.kv_heads * cfg.head_dim
    pd = cfg.rest_dtype

    def dense(shape, fan_in, rest=True):
        # cast leaf by leaf: the fp32 peak stays one leaf, not one model
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        w.mul_(fan_in ** -0.5)
        return w.to(pd) if rest else w

    layers = {
        "attn_norm": torch.ones((L, D), dtype=torch.float32, device=dev),
        "wq": dense((L, D, H), D),
        "wk": dense((L, D, KV), D),
        "wv": dense((L, D, KV), D),
        "wo": dense((L, H, D), H),
        "mlp_norm": torch.ones((L, D), dtype=torch.float32, device=dev),
    }
    if cfg.n_experts > 0:
        E = cfg.n_experts
        layers.update({
            "moe_gate": dense((L, D, E), D, rest=False),  # fp32 at rest
            "w_in": dense((L, E, D, F_), D),
            "w_gate": dense((L, E, D, F_), D),
            "w_out": dense((L, E, F_, D), F_),
        })
    else:
        layers.update({
            "w_in": dense((L, D, F_), D),
            "w_gate": dense((L, D, F_), D),
            "w_out": dense((L, F_, D), F_),
        })
    return {
        "embed": dense((V, D), 1.0),
        "layers": layers,
        "final_norm": torch.ones((D,), dtype=torch.float32, device=dev),
        "unembed": dense((D, V), D),
    }


def param_count(params: dict) -> int:
    n = 0
    for v in params.values():
        n += param_count(v) if isinstance(v, dict) else v.numel()
    return n


def layer_slice(layers: dict, i: int) -> dict:
    """Layer ``i`` of the L-stacked leaves, nested ones (LoRA's {"a",
    "b"}) included (views, no copy)."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i] for k, v in layers.items()}


def _unbind_layers(layers: dict) -> dict:
    """The L-stacked leaves unbound once into per-layer tuples, nested
    ones included, so gradients gather by one stack per leaf."""
    return {k: _unbind_layers(v) if isinstance(v, dict) else v.unbind(0)
            for k, v in layers.items()}


def _run_layers(layer_fn, layers: dict, x):
    """``layer_fn(x, layer)`` over the stacked ``layers`` in order: (x, the
    layers' aux summed, or None when none returns one)."""
    per_layer = _unbind_layers(layers)
    aux = None
    for i in range(layers["attn_norm"].shape[0]):
        x, a = layer_fn(x, layer_slice(per_layer, i))
        if a is not None:  # a MoE layer's load-balancing loss
            aux = a if aux is None else aux + a
    return x, aux


# -- building blocks ---------------------------------------------------------


def _embed_lookup(embed, tokens, dtype):
    """Embedding gather; an int8 table is gathered, THEN dequantised (its
    rows as ``wmat`` would give them, without the dense (V, D) table)."""
    if is_qtensor(embed):
        rows = embed["q8"][tokens.long()].to(dtype)
        return rows * embed["scale"][0].to(dtype)
    return embed.to(dtype)[tokens.long()]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _rope_tables(positions: torch.Tensor, half: int, theta: float):
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    )
    angles = positions.float()[..., None] * freqs  # (..., half)
    return torch.cos(angles), torch.sin(angles)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split layout.  x: (B, S, H, Dh); positions: (S,)."""
    half = x.shape[-1] // 2
    cos, sin = _rope_tables(positions, half, theta)  # (S, half)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    x1, x2 = x.float().split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, Dh) → (B, S, Hkv·n_rep, Dh): grouped KV heads expanded."""
    if n_rep == 1:
        return k
    B, S, Hkv, Dh = k.shape
    return k[:, :, :, None, :].expand(B, S, Hkv, n_rep, Dh).reshape(B, S, Hkv * n_rep, Dh)


def _attention(q, k, v, cfg: TransformerConfig, mesh=None):
    """(B, S, H, Dh) → (B, S, H, Dh) through flash attention.  With the
    sequence cut over ``seq`` (S the shard's length): ring attention under
    ``cfg.use_ring_attention``, else flash attention over the keys
    gathered from the shards up to this one's end."""
    n_rep = cfg.n_heads // cfg.kv_heads
    seq = group_size(mesh, "seq")
    if seq > 1 and not cfg.use_ring_attention:
        end = (mesh.axis_index("seq") + 1) * q.shape[1]
        k = gather_from(k, mesh, "seq", 1)[:, :end]
        v = gather_from(v, mesh, "seq", 1)[:, :end]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    if seq > 1 and cfg.use_ring_attention:
        from ..parallel.ring import ring_attention

        if cfg.window_size:
            raise NotImplementedError("sliding window + ring attention is not supported")
        o = ring_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mesh,
                           "seq", causal=True)
        return o.transpose(1, 2)
    o = flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        True, None, cfg.window_size,
    )
    return o.transpose(1, 2)


class _MatmulF32(torch.autograd.Function):
    """``h @ w`` with an fp32 output (``mm_f32``), for a frozen ``w``:
    the gradient reaches ``h`` only, as ``g @ wᵀ`` in h's dtype (the
    cotangent of a compute-dtype cast holds that dtype's values, so
    casting it down first is exact)."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(w)
        return mm_f32(h.reshape(-1, h.shape[-1]), w).reshape(*h.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return g.to(w.dtype) @ w.t(), None


def _proj(h, p, name, dtype):
    """``h @ p[name]``, plus the LoRA term when the layer carries a
    ``<name>_lora`` leaf (reference ``transformer._proj``): the base
    product with an fp32 output, ``(h·A)·B`` in fp32 added to it, and only
    the sum cast to ``dtype``, so an adapter below the base's ulp is not
    rounded away.  Without the leaf it is the plain product."""
    ad = p.get(name + "_lora")
    if ad is None:
        return wmatmul(h, p[name], dtype)
    w = wmat(p[name], dtype)
    y = h @ w if dtype == torch.float32 else _MatmulF32.apply(h, w)
    t = (h.float() @ ad["a"]) @ ad["b"]
    return (y + t).to(dtype)


def _gather_fsdp(w, spec, mesh):
    """``w`` whole along the dimensions its spec shards over ``fsdp``
    (an all-gather, whose backward reduce-scatters the gradient)."""
    for i, ax in enumerate(spec):
        if ax == "fsdp":
            w = gather_from(w, mesh, "fsdp", i)
    return w


def _layer_in_use(p: dict, mesh) -> dict:
    """A layer's leaves as the layer uses them on ``mesh``: fsdp dimensions
    gathered, tensor dimensions kept as this rank's slice."""
    if group_size(mesh, "fsdp") == 1:
        return p
    from ..parallel.sharding import _spec_for

    # LoRA's {"a", "b"} are whole on every rank
    return {k: v if isinstance(v, dict)
            else _gather_fsdp(v, _spec_for("layers/" + k, v.ndim + 1, None)[1:], mesh)
            for k, v in p.items()}


def _layer(x, p, cfg: TransformerConfig, mesh=None, route_axes=BATCH_AXES):
    B, S, _ = x.shape
    T = group_size(mesh, "tensor")
    Hn, Dh, Hkv = cfg.n_heads // T, cfg.head_dim, cfg.kv_heads // T
    dtype = torch_dtype(cfg.dtype)
    p = _layer_in_use(p, mesh)
    h = copy_to(rms_norm(x, p["attn_norm"]), mesh, "tensor")
    q = _proj(h, p, "wq", dtype).reshape(B, S, Hn, Dh)
    k = _proj(h, p, "wk", dtype).reshape(B, S, Hkv, Dh)
    v = _proj(h, p, "wv", dtype).reshape(B, S, Hkv, Dh)
    positions = torch.arange(S, device=x.device)
    if group_size(mesh, "seq") > 1:  # the shard's global positions
        positions = positions + mesh.axis_index("seq") * S
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = _attention(q, k, v, cfg, mesh).reshape(B, S, Hn * Dh)
    x = x + reduce_from(_proj(o, p, "wo", dtype), mesh, "tensor")
    h = rms_norm(x, p["mlp_norm"])
    if cfg.n_experts > 0:
        ffn, aux = moe_ffn(h, p["moe_gate"], p["w_in"], p["w_gate"], p["w_out"],
                           capacity_factor=cfg.capacity_factor, dtype=dtype, mesh=mesh,
                           route_axes=route_axes)
        return x + ffn, aux
    h = copy_to(h, mesh, "tensor")
    gate = F.silu(_proj(h, p, "w_gate", dtype))
    up = _proj(h, p, "w_in", dtype)
    return x + reduce_from(_proj(gate * up, p, "w_out", dtype), mesh, "tensor"), None


def _embed_mesh(embed, tokens, dtype, mesh):
    """The vocab-sharded lookup: this rank's rows (V/T of them) gathered
    whole over ``fsdp``, tokens outside them masked to 0, and the rows
    summed over ``tensor`` (one rank holds each token's row)."""
    w = _gather_fsdp(embed, ("tensor", "fsdp"), mesh)
    if group_size(mesh, "tensor") == 1:
        return _embed_lookup(w, tokens, dtype)
    v_local = w.shape[0]
    t = tokens.long() - mesh.axis_index("tensor") * v_local
    inside = (t >= 0) & (t < v_local)
    rows = w.to(dtype)[t.clamp(0, v_local - 1)]
    return reduce_from(torch.where(inside[..., None], rows, 0), mesh, "tensor")


def unembed_in_use(params: dict, dtype, mesh=None) -> torch.Tensor:
    """The unembed as the loss uses it: whole over ``fsdp``, this rank's
    V/T columns under ``tensor``, in the compute dtype."""
    return wmat(_gather_fsdp(params["unembed"], ("fsdp", "tensor"), mesh), dtype)


def hidden_with_aux(
    params: dict, tokens: torch.Tensor, cfg: TransformerConfig, mesh=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) int → (final-norm hidden (B, S, D), aux scalar: the
    MoE layers' load-balancing losses summed, 0 for a dense model).

    The pre-unembed trunk, so the chunked loss (ops/xent.py) can take
    hidden states without the logits ever existing.  The stacked layer
    leaves are unbound once, so their gradients gather into the stacked
    tensors by one stack in the backward, not by L full-size adds.  With
    ``cfg.remat`` each layer is checkpointed: only its input is kept and
    its forward (K1 included) runs again in the backward.

    On a mesh, ``params`` are this rank's slices and ``tokens`` its
    (batch, sequence) shard; the hidden states are its shard's, alike on
    every ``tensor`` (and ``pipe``, ``expert``) rank.  Pipelined
    (``pipelined``), each rank microbatches its rows; the aux is then the
    reference's mean over the microbatches (and seq shards, when the ring
    runs inside the stages and each shard routes its own tokens).  A MoE
    model routes each microbatch over every axis its tokens are cut over,
    so where (``data``, ``fsdp``) span more than one rank its rows must be
    the rank's share of every global microbatch
    (``pipeline.microbatch_shares``, as ``train.loss_fn`` cuts them)."""
    check_mesh_model(cfg, mesh, params)
    dtype = torch_dtype(cfg.dtype)
    if mesh is None:
        x = _embed_lookup(params["embed"], tokens, dtype)
    else:
        x = _embed_mesh(params["embed"], tokens, dtype, mesh)
    piped = pipelined(cfg, mesh)
    # sp × pp: the ring inside the stages, each seq shard routing its own
    # tokens (the reference's manual {pipe, seq} region); otherwise MoE
    # routes over every axis the tokens are cut over
    seq_manual = piped and cfg.use_ring_attention and group_size(mesh, "seq") > 1
    route = ("data", "fsdp") if seq_manual else BATCH_AXES
    remat = cfg.remat and torch.is_grad_enabled()

    def layer_fn(h, lp):
        if remat:
            return checkpoint(_layer, h, lp, cfg, mesh, route, use_reentrant=False)
        return _layer(h, lp, cfg, mesh, route)

    if piped:
        from ..parallel.pipeline import microbatch, pipeline_apply, unmicrobatch

        M = cfg.n_microbatches
        if x.shape[0] % M:
            dp = group_size(mesh, ("data", "fsdp"))
            raise ValueError(f"batch {x.shape[0]} not divisible by {M} microbatches (the "
                             f"batch a rank pipelines is its rows: the global batch over "
                             f"data*fsdp={dp})")
        y, aux = pipeline_apply(lambda h, layers: _run_layers(layer_fn, layers, h),
                                params["layers"], microbatch(x, M), mesh,
                                seq_axis="seq" if seq_manual else None)
        x = unmicrobatch(y)
    else:
        x, aux = _run_layers(layer_fn, params["layers"], x)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = rms_norm(x, params["final_norm"])
    return x, aux


def forward_with_aux(
    params: dict, tokens: torch.Tensor, cfg: TransformerConfig, mesh=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) int → (logits (B, S, V) float32, aux scalar).  On a
    mesh each rank computes its V/T columns and the logits are gathered
    whole over ``tensor``."""
    x, aux = hidden_with_aux(params, tokens, cfg, mesh)
    if mesh is None:
        logits = wmatmul(x, params["unembed"], torch_dtype(cfg.dtype))
        return logits.float(), aux
    from ..parallel.collectives import gather_replicated

    dtype = torch_dtype(cfg.dtype)
    logits = copy_to(x, mesh, "tensor") @ unembed_in_use(params, dtype, mesh)
    return gather_replicated(logits, mesh, "tensor", -1).float(), aux


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig, mesh=None) -> torch.Tensor:
    """tokens: (B, S) int → logits (B, S, V) float32."""
    return forward_with_aux(params, tokens, cfg, mesh)[0]
