"""Training step on one device: loss, AdamW, fp32 masters, gradient
accumulation.

Counterpart of ``elastic_gpu_scheduler_tpu/models/train.py`` without a
mesh (a ``mesh`` argument raises, naming ``parallel/``).  Parameters are a
nested dict of tensors, as in ``transformer.py``; the step updates them
and the optimizer state in place (JAX donates both trees to its jitted
step; in place is PyTorch's way to the same memory) and returns them.

The optimizer is the reference's ``optax`` recipe written out on tensors
(optax has no PyTorch counterpart, and ``torch.optim.AdamW`` cannot keep
a bf16 first moment): ``chain(clip_by_global_norm(c), adamw(schedule,
b1=0.9, b2=0.95, eps=1e-8, weight_decay, mu_dtype))`` with

- global-norm clipping first, on the whole gradient tree;
- ``scale_by_adam``: mu = (1-b1)·g + b1·mu, nu = (1-b2)·g² + b2·nu, bias
  corrections at the incremented count, u = mu_hat / (sqrt(nu_hat) + eps);
  with ``mu_dtype`` the update uses mu before it is cast for storage;
- decoupled weight decay u + wd·p on every leaf, norms included (optax's
  default mask);
- the learning rate at the count before the increment, so a warmup's
  first update is zero (``scale_by_schedule``);
- ``warmup_cosine_decay_schedule(0, lr, warmup, total, end_value=lr·0.1)``
  when ``warmup_steps`` > 0 and ``total_steps`` > ``warmup_steps``, else a
  constant rate.

Bf16-at-rest parameters train through ``MasterState``: fp32 master copies
absorb the updates and the bf16 parameters are re-cast from them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from ..ops.xent import chunked_softmax_xent
from .quantize import wmat
from .transformer import (
    TransformerConfig,
    check_no_mesh,
    forward_with_aux,
    hidden_with_aux,
    init_params,
    torch_dtype,
)


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


# -- loss --------------------------------------------------------------------


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Masked mean next-token CE.  logits (B, S, V) fp32; targets (B, S)
    int.  Target ids outside [0, V) are ignored: no loss, no gradient, out
    of the denominator."""
    V = logits.shape[-1]
    t = targets.long()
    valid = (t >= 0) & (t < V)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, torch.clamp(t, 0, V - 1)[..., None])[..., 0]
    n_valid = torch.clamp(valid.sum(), min=1)
    return torch.where(valid, logz - gold, 0.0).sum() / n_valid


def loss_fn(params, tokens: torch.Tensor, cfg: TransformerConfig, mesh=None) -> torch.Tensor:
    """tokens (B, S+1): predicts tokens[:, 1:] from tokens[:, :-1]."""
    check_no_mesh(mesh, "loss_fn")
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if cfg.xent_chunks > 0:
        # vocab-chunked CE: the (B, S, V) logits never materialize
        hidden, aux = hidden_with_aux(params, inputs, cfg)
        w = wmat(params["unembed"], torch_dtype(cfg.dtype))
        loss = chunked_softmax_xent(hidden, w, targets, cfg.xent_chunks)
    else:
        logits, aux = forward_with_aux(params, inputs, cfg)
        loss = cross_entropy_loss(logits, targets)
    if cfg.n_experts > 0:
        loss = loss + cfg.aux_loss_weight * aux
    return loss


# -- optimizer ---------------------------------------------------------------


@dataclass
class AdamWState:
    """optax's ``ScaleByAdamState`` (count, mu, nu); the schedule's count
    is the same number.  ``mu`` is stored in ``mu_dtype`` when set."""

    count: int
    mu: Any
    nu: Any


class MasterState(NamedTuple):
    """Optimizer state of bf16-at-rest parameters: fp32 master copies and
    the inner optimizer state, which tracks the masters."""

    master: Any
    inner: AdamWState


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    weight_decay: float = 0.01
    warmup_steps: int = 0
    total_steps: int = 0
    grad_clip: float = 0.0
    mu_dtype: Optional[torch.dtype] = None

    # the reference's constants
    B1, B2, EPS = 0.9, 0.95, 1e-8

    def learning_rate(self, count: int) -> float:
        """The schedule at ``count`` (optax's formulas, in float64)."""
        lr, w, total = self.lr, self.warmup_steps, self.total_steps
        if not (w > 0 and total > w):
            return lr
        if count < w:  # linear_schedule(0, lr, w)
            frac = 1 - min(max(count, 0), w) / w
            return -lr * frac + lr
        # cosine_decay_schedule(lr, total - w, alpha=0.1) at count - w
        steps = total - w
        c = min(count - w, steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / steps))
        return lr * ((1 - 0.1) * cosine + 0.1)

    def init(self, params) -> AdamWState:
        return AdamWState(
            count=0,
            mu=_map(lambda p: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype), params),
            nu=_map(torch.zeros_like, params),
        )

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params) -> None:
        """One step, in place on ``params`` (and ``state``): grads, params
        and nu are trees of the same fp32 tensors' shapes."""
        gs, ps = _leaves(grads), _leaves(params)
        mus, nus = _leaves(state.mu), _leaves(state.nu)
        if self.grad_clip > 0:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in gs))
            if not bool(g_norm < self.grad_clip):
                gs = [(g / g_norm) * self.grad_clip for g in gs]
        lr = self.learning_rate(state.count)  # before the increment
        count = state.count + 1
        c1 = 1 - self.B1 ** count
        c2 = 1 - self.B2 ** count
        for g, p, mu, nu in zip(gs, ps, mus, nus):
            # b1 in mu's dtype, as JAX casts a Python scalar to a bf16
            # operand's dtype; the sum is fp32 even when mu is stored bf16
            m = (1 - self.B1) * g + torch.tensor(self.B1, dtype=mu.dtype) * mu
            nu.mul_(self.B2).add_((1 - self.B2) * (g * g))
            u = (m / c1) / (torch.sqrt(nu / c2) + self.EPS)
            u = u + self.weight_decay * p
            p.add_(-lr * u)
            mu.copy_(m)
        state.count = count


def make_optimizer(
    lr: float = 3e-4,
    weight_decay: float = 0.01,
    warmup_steps: int = 0,
    total_steps: int = 0,
    grad_clip: float = 0.0,
    mu_dtype: Optional[str] = None,
) -> AdamW:
    """AdamW with optional linear warmup + cosine decay and global-norm
    clipping; ``mu_dtype="bfloat16"`` stores the first moment in bf16."""
    return AdamW(
        lr=lr, weight_decay=weight_decay, warmup_steps=warmup_steps,
        total_steps=total_steps, grad_clip=grad_clip,
        mu_dtype=torch_dtype(mu_dtype) if mu_dtype else None,
    )


# -- the step ----------------------------------------------------------------


def _grads_of(params, tokens, cfg, grad_accum: int):
    """(mean loss, fp32 gradients as a list in ``_leaves`` order)."""
    leaves = _leaves(params)
    if grad_accum <= 1:
        loss = loss_fn(params, tokens, cfg)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), [g.float() for g in grads]
    B = tokens.shape[0]
    if B % grad_accum:
        raise ValueError(f"batch {B} not divisible by grad_accum {grad_accum}")
    # fp32 sums kept here, never through bf16 .grad fields
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
    loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for mb in tokens.reshape(grad_accum, B // grad_accum, tokens.shape[1]):
        loss = loss_fn(params, mb, cfg)
        for a, g in zip(acc, torch.autograd.grad(loss, leaves)):
            a += g.float()
        loss_sum += loss.detach()
    inv = 1.0 / grad_accum
    return loss_sum * inv, [a * inv for a in acc]


def _unflatten(like, flat: list):
    it = iter(flat)
    return _map(lambda _: next(it), like)


def make_train_step(cfg: TransformerConfig, optimizer: AdamW, mesh=None, grad_accum: int = 1):
    """Returns train_step(params, opt_state, tokens) → (params, opt_state,
    loss): the same objects, updated in place, and the mean loss (a
    0-dim fp32 tensor on the parameters' device).

    ``grad_accum`` > 1 splits the batch into that many microbatches and
    sums fp32 gradients before one optimizer update."""
    check_no_mesh(mesh, "make_train_step")

    def train_step(params, opt_state, tokens):
        loss, grads = _grads_of(params, tokens, cfg, grad_accum)
        apply_update(optimizer, params, opt_state, grads)
        return params, opt_state, loss

    return train_step


def apply_update(optimizer: AdamW, params, opt_state, grads: list) -> None:
    """One optimizer step in place from fp32 ``grads`` (a list in
    ``_leaves(params)`` order).  A ``MasterState`` updates the fp32
    masters, then re-casts the parameters from them."""
    if isinstance(opt_state, MasterState):
        optimizer.update(_unflatten(params, grads), opt_state.inner, opt_state.master)
        with torch.no_grad():
            for p, m in zip(_leaves(params), _leaves(opt_state.master)):
                p.copy_(m)
        return
    optimizer.update(_unflatten(params, grads), opt_state, params)


def init_state(cfg: TransformerConfig, optimizer: AdamW, generator: torch.Generator,
               device=None, mesh=None):
    """(params, opt_state) on one device: the counterpart of
    ``init_sharded_state`` with no mesh.  Parameters require grad; with
    any bf16 leaf the state is a ``MasterState`` of fp32 copies."""
    check_no_mesh(mesh, "init_state")
    params = init_params(cfg, generator, device)
    return state_for(params, optimizer)


def state_for(params, optimizer: AdamW):
    """Make ``params`` trainable and build their optimizer state."""
    for p in _leaves(params):
        p.requires_grad_(True)
    if any(p.dtype == torch.bfloat16 for p in _leaves(params)):
        master = _map(lambda p: p.detach().to(torch.float32, copy=True), params)
        return params, MasterState(master, optimizer.init(master))
    return params, optimizer.init(params)


@torch.no_grad()
def evaluate(params, cfg: TransformerConfig, batches, mesh=None) -> dict:
    """Mean next-token loss and perplexity over (B, S+1) token batches."""
    check_no_mesh(mesh, "evaluate")
    total, n = 0.0, 0
    for tokens in batches:
        total += float(loss_fn(params, tokens, cfg))
        n += 1
    if n == 0:
        raise ValueError("evaluate: no batches")
    mean = total / n
    return {"loss": mean, "perplexity": math.exp(min(mean, 30.0)), "batches": n}
