"""LoRA: low-rank adapter fine-tuning for the flagship model.

Counterpart of ``elastic_gpu_scheduler_tpu/models/lora.py``.  Weights are
stacked over layers ((L, d_in, d_out), ``transformer.init_params``), so an
adapter is one pair of stacked low-rank factors A (L, d_in, r) and
B (L, r, d_out) per target family, and a merge W + (alpha/r)·A@B is one
batched product per family.

Training uses the activation-domain view (``inject_lora`` +
``transformer._proj``): each adapted product computes x@W + (x@A)@B·scale
with the low-rank term added in fp32 before the cast to the compute
dtype, and autograd reaches only (A, B): the base stays frozen bits (and
may sit in bf16).  A merged view would round a delta below the bf16
base's ulp to zero for every token, and early fine-tuning would stall.

On a mesh the base is sharded as any model's, and the adapters are whole
and alike on every rank, as the reference's unsharded ``lora`` tree.  Each
projection takes the slice of its adapter that matches its own: a
column-parallel one (wq, wk, wv, w_in, w_gate) B's columns for its heads
or F, a row-parallel one (wo, w_out) A's rows, and a pipe stage its
layers.  The gradient of a slice reaches the whole adapter with zeros
elsewhere, and the gradient of (h·A) is partial on each ``tensor`` rank,
so one sum over the batch axes, ``tensor`` and (pipelined) ``pipe``
assembles the whole gradient on every rank; the update then keeps the
adapters equal everywhere.

For serving, ``merge_lora`` bakes an adapter into plain parameters; the
multi-LoRA engine (``serving.build_lora_bank``) serves many adapters on
one base without merging.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from ..parallel.collectives import all_reduce, all_reduce_flat
from ..parallel.sharding import local_slice
from .train import BATCH_AXES, AdamW, _leaves, _unflatten, loss_fn
from .transformer import TransformerConfig, check_mesh_model, pipelined

# weight families eligible for adaptation (dense path)
DEFAULT_TARGETS = ("wq", "wv")
ALL_TARGETS = ("wq", "wk", "wv", "wo", "w_in", "w_gate", "w_out")
ROW_PARALLEL = ("wo", "w_out")


def lora_init(
    params: dict,
    rank: int,
    targets: Iterable[str] = DEFAULT_TARGETS,
    alpha: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
) -> dict:
    """Zero-impact adapters: A ~ N(0, 1/d_in) in fp32 from ``generator``
    (drawn on the generator's device, placed beside the weight), B = 0, so
    the merged model starts exactly equal to the base."""
    targets = tuple(targets)
    layers = params["layers"]
    adapters = {}
    for t in targets:
        if t not in layers:
            raise ValueError(f"LoRA target {t!r} not in model layers")
        W = layers[t]
        if isinstance(W, dict):  # an int8 {"q8", "scale"} leaf
            raise ValueError(
                f"LoRA target {t!r} is int8-quantized; adapters need a "
                "full-precision base (quantize AFTER merge_lora if serving)"
            )
        if W.ndim != 3:
            raise ValueError(
                f"LoRA target {t!r} must be stacked (L, d_in, d_out); "
                f"got shape {tuple(W.shape)} (MoE experts are not supported)"
            )
        L, d_in, d_out = W.shape
        gdev = generator.device if generator is not None else W.device
        a = torch.randn((L, d_in, rank), generator=generator, dtype=torch.float32, device=gdev)
        adapters[t] = {
            "a": (a * d_in ** -0.5).to(W.device),
            "b": torch.zeros((L, rank, d_out), dtype=torch.float32, device=W.device),
        }
    return {
        "adapters": adapters,
        "alpha": float(alpha if alpha is not None else rank),
        "rank": rank,
    }


def lora_param_count(lora: dict) -> int:
    return sum(x.numel() for x in _leaves(lora["adapters"]))


def _adapter_specs(target: str, lead) -> tuple[tuple, tuple]:
    """The (A, B) slices a rank's projection of ``target`` uses."""
    if target in ROW_PARALLEL:
        return (lead, "tensor", None), (lead, None, None)
    return (lead, None, None), (lead, None, "tensor")


def inject_lora(params: dict, lora: dict, mesh=None, pipeline: bool = False) -> dict:
    """A parameter tree whose layer dict carries ``<target>_lora`` leaves
    ({"a": (L, d_in, r), "b": (L, r, d_out)} with alpha/r folded into b):
    the training view, applied by ``transformer._proj`` in the activation
    domain.  Differentiable in (A, B).  On a mesh, ``params`` are this
    rank's slices and each adapter leaf is cut to match its projection's
    (``pipeline``: the layers are pipe-sharded)."""
    scale = lora["alpha"] / lora["rank"]
    layers = dict(params["layers"])
    for t, ab in lora["adapters"].items():
        a, b = ab["a"], ab["b"] * scale
        if mesh is not None and mesh.size > 1:
            sa, sb = _adapter_specs(t, "pipe" if pipeline else None)
            a, b = local_slice(a, sa, mesh), local_slice(b, sb, mesh)
        layers[t + "_lora"] = {"a": a, "b": b}
    out = dict(params)
    out["layers"] = layers
    return out


def merge_lora(params: dict, lora: dict) -> dict:
    """params + scale·A@B for every adapted family (the delta in fp32,
    the sum cast to each weight's dtype): the same structure and dtypes as
    ``params``, usable by every consumer.  Differentiable in (A, B)."""
    scale = lora["alpha"] / lora["rank"]
    layers = dict(params["layers"])
    for t, ab in lora["adapters"].items():
        W = layers[t]
        if isinstance(W, dict):
            raise ValueError(
                f"cannot merge into int8-quantized {t!r}; merge into the "
                "full-precision base, then quantize_params the result"
            )
        delta = torch.einsum("lir,lro->lio", ab["a"].float(), ab["b"].float())
        layers[t] = (W.float() + scale * delta).to(W.dtype)
    out = dict(params)
    out["layers"] = layers
    return out


def lora_loss_fn(lora: dict, params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
                 mesh=None) -> torch.Tensor:
    """The full fine-tune's objective (``train.loss_fn``) on the
    adapter-injected model (on a mesh: this rank's share)."""
    return loss_fn(inject_lora(params, lora, mesh, pipelined(cfg, mesh)), tokens, cfg, mesh)


def _frozen(tree):
    """The base parameters as tensors that autograd does not track."""
    if isinstance(tree, dict):
        return {k: _frozen(v) for k, v in tree.items()}
    return tree.detach()


def make_lora_train_step(cfg: TransformerConfig, optimizer: AdamW, mesh=None):
    """train_step(lora, opt_state, params, tokens) → (lora, opt_state,
    loss): the adapters and ``opt_state`` (``optimizer.init`` of
    ``lora["adapters"]``) updated in place, the loss a 0-dim fp32 tensor.

    Gradients reach the adapter leaves only: the base is read detached, so
    it gets no ``.grad`` and keeps its bits.  On a mesh ``params`` are
    this rank's slices and ``tokens`` its rows; the adapters' gradients are
    summed whole on every rank before the update, and the loss is the
    global mean."""
    check_mesh_model(cfg, mesh)
    if mesh is not None and not mesh.connected:
        raise RuntimeError("make_lora_train_step: connect the mesh first (Mesh.connect())")
    # the axes over which a rank holds a share or a slice of each gradient
    axes = BATCH_AXES + ("tensor",) + (("pipe",) if pipelined(cfg, mesh) else ())

    def step(lora, opt_state, params, tokens):
        leaves = _leaves(lora["adapters"])
        for p in leaves:
            p.requires_grad_(True)
        loss = lora_loss_fn(lora, _frozen(params), tokens, cfg, mesh)
        grads = [g.float() for g in torch.autograd.grad(loss, leaves)]
        if mesh is not None:
            grads = all_reduce_flat(grads, mesh, axes)
            loss = all_reduce(loss.detach(), mesh, BATCH_AXES)
        optimizer.update(_unflatten(lora["adapters"], grads), opt_state, lora["adapters"])
        return lora, opt_state, loss.detach()

    return step
