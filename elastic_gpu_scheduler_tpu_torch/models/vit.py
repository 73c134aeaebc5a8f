"""Second model family: Vision Transformer (image classification).

Counterpart of ``elastic_gpu_scheduler_tpu/models/vit.py``: the same
config, the same parameter tree (the flagship's layer names, so the LM's
rules apply to it unchanged: wq/wk/wv, wo, the SwiGLU FFN, stacked on a
leading L axis), RMSNorm pre-norm blocks and a CLS token.  Patchify is
one reshape and one product (square non-overlapping patches need no
convolution).

Attention is bidirectional: the port's ``flash_attention`` with
``causal=False``, so on CUDA kernel K1 runs the forward and K4 the
backward.  Every product goes through ``quantize.wmatmul``, so a tree from
``quantize_params`` (``patch_embed`` and ``head`` among its keys) runs its
int8 weights through kernel KE.  ``cfg.remat`` recomputes each layer in
the backward (``torch.utils.checkpoint``, the counterpart of
``jax.checkpoint``).  The train step is the port's AdamW
(``models/train``), in place, as the LM's is.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import flash_attention
from .quantize import wmatmul
from .train import AdamW, _leaves, apply_update
from .transformer import (
    _unbind_layers,
    layer_slice,
    resolve_device,
    rms_norm,
    torch_dtype,
)


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 32
    patch_size: int = 4
    channels: int = 3
    n_classes: int = 10
    d_model: int = 192
    n_layers: int = 6
    n_heads: int = 6
    d_ff: int = 512
    dtype: str = "bfloat16"
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def init_vit_params(cfg: ViTConfig, generator: torch.Generator, device=None) -> dict:
    """Random fp32 weights with the reference's shapes and scales (normal /
    sqrt(fan_in); the position table 0.02 of that; CLS zero; unit norms).
    The values come from ``generator``: parity tests carry the reference's
    weights across with ``bridge.vit_params_from_jax``."""
    dev = resolve_device(device)
    D, H, F_, L = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff, cfg.n_layers
    patch_dim = cfg.patch_size * cfg.patch_size * cfg.channels

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return w.mul_(fan_in ** -0.5)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    return {
        "patch_embed": dense((patch_dim, D), patch_dim),
        "pos_embed": dense((cfg.n_patches + 1, D), D).mul_(0.02),
        "cls_token": torch.zeros((D,), dtype=torch.float32, device=dev),
        "layers": {
            "attn_norm": ones(L, D),
            "wq": dense((L, D, H), D),
            "wk": dense((L, D, H), D),
            "wv": dense((L, D, H), D),
            "wo": dense((L, H, D), H),
            "mlp_norm": ones(L, D),
            "w_in": dense((L, D, F_), D),
            "w_gate": dense((L, D, F_), D),
            "w_out": dense((L, F_, D), F_),
        },
        "final_norm": ones(D),
        "head": dense((D, cfg.n_classes), D),
    }


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) → (B, N, patch·patch·C) non-overlapping patches."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (B, gh, gw, p, p, C)
    return x.reshape(B, gh * gw, patch * patch * C)


def _vit_layer(x, p, cfg: ViTConfig):
    """Pre-norm bidirectional block.  x: (B, N+1, D)."""
    B, S, _ = x.shape
    Hn, Dh = cfg.n_heads, cfg.head_dim
    dtype = torch_dtype(cfg.dtype)

    def heads(t):
        return t.reshape(B, S, Hn, Dh).transpose(1, 2)

    h = rms_norm(x, p["attn_norm"])
    q = heads(wmatmul(h, p["wq"], dtype))
    k = heads(wmatmul(h, p["wk"], dtype))
    v = heads(wmatmul(h, p["wv"], dtype))
    o = flash_attention(q, k, v, False, None)  # bidirectional
    o = o.transpose(1, 2).reshape(B, S, Hn * Dh)
    x = x + wmatmul(o, p["wo"], dtype)

    h = rms_norm(x, p["mlp_norm"])
    gate = F.silu(wmatmul(h, p["w_gate"], dtype))
    up = wmatmul(h, p["w_in"], dtype)
    return x + wmatmul(gate * up, p["w_out"], dtype)


def forward_vit(params: dict, images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """images: (B, H, W, C) float → logits (B, n_classes) float32."""
    dtype = torch_dtype(cfg.dtype)
    patches = patchify(images.to(dtype), cfg.patch_size)
    x = wmatmul(patches, params["patch_embed"], dtype)  # (B, N, D)
    B = x.shape[0]
    cls = params["cls_token"].to(dtype).expand(B, 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(dtype)
    per_layer = _unbind_layers(params["layers"])
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = layer_slice(per_layer, i)
        if remat:
            x = checkpoint(_vit_layer, x, lp, cfg, use_reentrant=False)
        else:
            x = _vit_layer(x, lp, cfg)
    x = rms_norm(x, params["final_norm"])
    logits = wmatmul(x[:, 0, :], params["head"], dtype)  # the CLS token
    return logits.float()


def vit_loss(params, images, labels, cfg: ViTConfig) -> torch.Tensor:
    """Mean softmax cross-entropy of the labels (B,) int."""
    logits = forward_vit(params, images, cfg)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[:, None])[:, 0]
    return torch.mean(logz - gold)


def make_vit_train_step(cfg: ViTConfig, optimizer: AdamW, mesh=None):
    """step(params, opt_state, images, labels) → (params, opt_state, loss):
    the same objects, updated in place (``optimizer.init(params)`` builds
    the state), and the loss as a 0-dim fp32 tensor.

    ``mesh`` is accepted and not used, as in the reference, whose ViT step
    takes a mesh and jits without it: the ViT has no sharded path."""

    def step(params, opt_state, images, labels):
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = vit_loss(params, images, labels, cfg)
        grads = torch.autograd.grad(loss, leaves)
        apply_update(optimizer, params, opt_state, [g.float() for g in grads])
        return params, opt_state, loss.detach()

    return step
