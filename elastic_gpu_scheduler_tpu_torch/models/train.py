"""Training step: loss, AdamW, fp32 masters, gradient accumulation, on
one device or on a mesh.

Counterpart of ``elastic_gpu_scheduler_tpu/models/train.py``.  Parameters
are a nested dict of tensors, as in ``transformer.py``; the step updates
them and the optimizer state in place (JAX donates both trees to its
jitted step; in place is PyTorch's way to the same memory) and returns
them.

On a mesh (``parallel/mesh.Mesh``, connected) a rank holds its slice of
each leaf and of its moments and master (``init_sharded_state``; layer
leaves pipe-sharded when the model is ``pipelined``), and the
step takes its rows of the global batch (``sharding.local_batch``: cut by
its (data, fsdp) index) with the whole sequence; a pipelined MoE model
re-cuts them into the rank's share of every global microbatch
(``pipeline.microbatch_shares``), since the reference routes each global
microbatch on its own.  The next-token targets
are built from the whole sequence before it is cut over ``seq``, so a
shard's last target is the next shard's first token.  Each rank's loss is
its tokens' sum over the global count of valid targets (and its share of
a MoE model's aux, which every rank holds whole), so the gradients sum
over ranks: a leaf's gradient is reduce-scattered over ``fsdp`` where
it is sharded there (the backward of the gather) and all-reduced over the
other batch axes (data, fsdp, seq) it is not sharded over.  The global
gradient norm for clipping counts each slice once (a leaf's squared norm
weighed by 1 / its number of copies, summed over the mesh).  The reported
loss is the sum over the batch axes: the global mean.

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

from ..ops.xent import chunked_softmax_xent, chunked_softmax_xent_tp
from ..parallel.collectives import all_reduce, all_reduce_flat, axes_of, group_size
from ..parallel.mesh import AXES
from ..parallel.pipeline import microbatch_shares
from ..parallel.sharding import BATCH_AXES, leaf_specs, shard_params
from .transformer import (
    TransformerConfig,
    check_mesh_model,
    forward_with_aux,
    hidden_with_aux,
    init_params,
    pipelined,
    torch_dtype,
    unembed_in_use,
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


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor, n_valid=None
                       ) -> torch.Tensor:
    """Masked mean next-token CE.  logits (B, S, V) fp32; targets (B, S)
    int.  Target ids outside [0, V) are ignored: no loss, no gradient, out
    of the denominator.  ``n_valid``: the denominator when it is not this
    call's own count (a loss summed across ranks)."""
    V = logits.shape[-1]
    t = targets.long()
    valid = (t >= 0) & (t < V)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, torch.clamp(t, 0, V - 1)[..., None])[..., 0]
    n_valid = torch.clamp(valid.sum() if n_valid is None else n_valid, min=1)
    return torch.where(valid, logz - gold, 0.0).sum() / n_valid


def seq_shard(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's columns of a (B, S) tensor cut over ``seq``."""
    n = group_size(mesh, "seq")
    if n == 1:
        return x
    if x.shape[1] % n:
        raise ValueError(f"sequence {x.shape[1]} not divisible by seq={n}")
    s = x.shape[1] // n
    i = mesh.axis_index("seq")
    return x[:, i * s:(i + 1) * s]


def loss_fn(params, tokens: torch.Tensor, cfg: TransformerConfig, mesh=None) -> torch.Tensor:
    """tokens (B, S+1): predicts tokens[:, 1:] from tokens[:, :-1].

    On a mesh: this rank's rows and whole sequence in, its share of the
    global mean out (its tokens' sum over the global valid count).  A
    pipelined MoE model first trades the rows for the rank's share of
    every global microbatch (the loss is a sum over the same tokens)."""
    n_valid = None
    if mesh is not None:
        check_mesh_model(cfg, mesh, params)
        if cfg.n_experts > 0 and pipelined(cfg, mesh):
            tokens = microbatch_shares(tokens, cfg.n_microbatches, mesh)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if mesh is not None:
        inputs, targets = seq_shard(inputs, mesh), seq_shard(targets, mesh)
        t = targets.long()
        n_valid = all_reduce(((t >= 0) & (t < cfg.vocab_size)).sum(), mesh, BATCH_AXES)
    if cfg.xent_chunks > 0:
        # vocab-chunked CE: the (B, S, V) logits never materialize
        hidden, aux = hidden_with_aux(params, inputs, cfg, mesh)
        w = unembed_in_use(params, torch_dtype(cfg.dtype), mesh)
        if group_size(mesh, "tensor") > 1:
            # V-sharded unembed: each rank scans its columns, one merge
            loss = chunked_softmax_xent_tp(hidden, w, targets, cfg.xent_chunks, mesh,
                                           n_valid=n_valid)
        else:
            loss = chunked_softmax_xent(hidden, w, targets, cfg.xent_chunks, n_valid)
    else:
        logits, aux = forward_with_aux(params, inputs, cfg, mesh)
        loss = cross_entropy_loss(logits, targets, n_valid)
    if cfg.n_experts > 0:
        # aux is the whole batch's on every rank: this rank adds its share
        loss = loss + cfg.aux_loss_weight * aux / group_size(mesh, BATCH_AXES)
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
    def update(self, grads, state: AdamWState, params, sq_norm=None) -> None:
        """One step, in place on ``params`` (and ``state``): grads, params
        and nu are trees of the same fp32 tensors' shapes.  ``sq_norm``
        (a function of the gradient list) gives the squared global norm
        for clipping when the gradients are slices of a mesh's leaves."""
        gs, ps = _leaves(grads), _leaves(params)
        mus, nus = _leaves(state.mu), _leaves(state.nu)
        if self.grad_clip > 0:
            sq = sq_norm(gs) if sq_norm else sum(torch.sum(g * g) for g in gs)
            g_norm = torch.sqrt(sq)
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


def _grads_of(params, tokens, cfg, grad_accum: int, mesh=None):
    """(mean loss, fp32 gradients as a list in ``_leaves`` order); on a
    mesh, this rank's shares of both, before any sum over ranks."""
    leaves = _leaves(params)
    if grad_accum <= 1:
        loss = loss_fn(params, tokens, cfg, mesh)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), [g.float() for g in grads]
    B = tokens.shape[0]
    if B % grad_accum:
        raise ValueError(f"batch {B} not divisible by grad_accum {grad_accum}")
    # fp32 sums kept here, never through bf16 .grad fields
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
    loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for mb in tokens.reshape(grad_accum, B // grad_accum, tokens.shape[1]):
        loss = loss_fn(params, mb, cfg, mesh)
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
    sums fp32 gradients before one optimizer update.  On a mesh the
    tokens are this rank's rows (``sharding.local_batch``), the gradients
    are summed over ranks before the update, and the loss is the global
    mean on every rank."""
    check_mesh_model(cfg, mesh)
    if mesh is not None and not mesh.connected:
        raise RuntimeError("make_train_step: connect the mesh first (Mesh.connect())")

    def train_step(params, opt_state, tokens):
        loss, grads = _grads_of(params, tokens, cfg, grad_accum, mesh)
        if mesh is None:
            apply_update(optimizer, params, opt_state, grads)
            return params, opt_state, loss
        specs = _leaves(leaf_specs(params, mesh, pipelined(cfg, mesh)))
        grads = reduce_grads(grads, specs, mesh)
        apply_update(optimizer, params, opt_state, grads,
                     sq_norm=lambda gs: global_sq_norm(gs, specs, mesh))
        return params, opt_state, all_reduce(loss, mesh, BATCH_AXES)

    return train_step


def reduce_grads(grads: list, specs: list, mesh) -> list:
    """Each leaf's gradient summed over the batch axes it is not sharded
    over (an ``fsdp``-sharded leaf got its sum over ``fsdp`` from the
    gather's backward); one all-reduce a set of axes.  A leaf's gradient is
    whole on every ``tensor``, ``pipe`` and ``expert`` rank that holds the
    same slice (the parallel operators' backwards see to it), so no sum
    runs over those."""
    buckets: dict[tuple, list[int]] = {}
    for i, spec in enumerate(specs):
        held = {a for ax in spec for a in axes_of(ax)}
        axes = tuple(a for a in BATCH_AXES if a not in held and mesh.shape[a] > 1)
        if axes:
            buckets.setdefault(axes, []).append(i)
    out = list(grads)
    for axes, idx in buckets.items():
        for i, g in zip(idx, all_reduce_flat([grads[i] for i in idx], mesh, axes)):
            out[i] = g
    return out


def global_sq_norm(grads: list, specs: list, mesh) -> torch.Tensor:
    """The squared norm of the whole gradient tree from every rank's
    slices: each leaf's local squared norm weighed by 1 / the number of
    ranks holding that slice, summed over the mesh.  ``specs`` must be the
    ones the leaves were cut by (``pipeline=True`` when the layers are
    pipe-sharded), else a stage's layers count as copies of the stack."""
    total = None
    for g, spec in zip(grads, specs):
        copies = mesh.size // mesh.axes_size([a for ax in spec for a in axes_of(ax)])
        term = torch.sum(g * g)
        if copies != 1:
            term = term / copies
        total = term if total is None else total + term
    return all_reduce(total, mesh, AXES)


def apply_update(optimizer: AdamW, params, opt_state, grads: list, sq_norm=None) -> None:
    """One optimizer step in place from fp32 ``grads`` (a list in
    ``_leaves(params)`` order).  A ``MasterState`` updates the fp32
    masters, then re-casts the parameters from them."""
    if isinstance(opt_state, MasterState):
        optimizer.update(_unflatten(params, grads), opt_state.inner, opt_state.master,
                         sq_norm)
        with torch.no_grad():
            for p, m in zip(_leaves(params), _leaves(opt_state.master)):
                p.copy_(m)
        return
    optimizer.update(_unflatten(params, grads), opt_state, params, sq_norm)


def init_sharded_state(cfg: TransformerConfig, optimizer: AdamW, generator: torch.Generator,
                       device=None, mesh=None):
    """(params, opt_state).  Parameters require grad; with any bf16 leaf
    the state is a ``MasterState`` of fp32 copies.  On a mesh every rank
    builds the whole params from the seed and keeps its slice (strict
    sharding rules); moments and masters follow the slices."""
    check_mesh_model(cfg, mesh)
    params = init_params(cfg, generator, device)
    if mesh is not None:
        params = shard_params(params, mesh, pipeline=pipelined(cfg, mesh))
    return state_for(params, optimizer)


init_state = init_sharded_state  # the name the one-device callers use


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
    """Mean next-token loss and perplexity over (B, S+1) token batches
    (on a mesh, this rank's rows of each)."""
    total, n = 0.0, 0
    for tokens in batches:
        total += float(all_reduce(loss_fn(params, tokens, cfg, mesh), mesh, BATCH_AXES))
        n += 1
    if n == 0:
        raise ValueError("evaluate: no batches")
    mean = total / n
    return {"loss": mean, "perplexity": math.exp(min(mean, 30.0)), "batches": n}
