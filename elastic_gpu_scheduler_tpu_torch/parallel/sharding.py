"""Sharding rules for the flagship transformer, and each rank's slice.

Counterpart of ``elastic_gpu_scheduler_tpu/parallel/sharding.py``.  A spec
is a tuple with one entry a dimension — an axis name, a tuple of axis names
or None — leaf for leaf the reference's ``PartitionSpec``:

    embed        (V, D)        → (tensor, fsdp)     vocab-sharded embed
    attn wq/wk/wv (L, D, H)    → (-, fsdp, tensor)  column-parallel
    attn wo      (L, H, D)     → (-, tensor, fsdp)  row-parallel
    mlp w_in/w_gate (L, D, F)  → (-, fsdp, tensor)  column-parallel
    mlp w_out    (L, F, D)     → (-, tensor, fsdp)  row-parallel
    norms        (L, D)        → replicated
    unembed      (D, V)        → (fsdp, tensor)

A serving rank holds ``serving_specs``: these rules cut over ``tensor``
and ``expert`` only (every other axis replicates), attention leaves whole
unless ``tensor`` divides both head counts, each spec fitted to its leaf,
int8 ``{q8, scale}`` leaves included.

The port's counterpart of a ``NamedSharding`` is a rank's local slice of
each leaf (``local_slice``): a dimension sharded over axes (a, b) is cut
into size(a)·size(b) equal blocks, a major, and the rank keeps block
``index(a)·size(b) + index(b)`` — the addressable shard JAX places on that
device.  ``full_leaf`` gathers the slices back into the whole leaf.
"""

from __future__ import annotations

from typing import Any

import torch

from .collectives import all_gather, axes_of

# the axes a rank's tokens are cut over (``batch_spec``): a loss, a gradient
# and the MoE routing sum over them
BATCH_AXES = ("data", "fsdp", "seq")


def _spec_for(name: str, nd: int, lead) -> tuple:
    in_layers = "layers" in name
    if "pos_embed" in name or "cls_token" in name:
        return ()
    if "patch_embed" in name:
        return ("fsdp", "tensor")
    if "unembed" in name:  # must precede the "embed" substring check
        return ("fsdp", "tensor")
    if "embed" in name:
        return ("tensor", "fsdp")
    if name.endswith("head"):
        return ("fsdp", None)
    if "moe_gate" in name:
        return (lead,) if in_layers else ()
    if any(k in name for k in ("wq", "wk", "wv", "w_in", "w_gate")):
        if nd == 4:
            return (lead, "expert", "fsdp", "tensor")
        return (lead, "fsdp", "tensor") if nd == 3 else ("fsdp", "tensor")
    if any(k in name for k in ("wo", "w_out")):
        if nd == 4:
            return (lead, "expert", "tensor", "fsdp")
        return (lead, "tensor", "fsdp") if nd == 3 else ("tensor", "fsdp")
    if in_layers and nd >= 1:
        return (lead,)
    return ()


def param_specs(params: Any, pipeline: bool = False) -> Any:
    """The spec tree of a params tree (nested dicts of tensors, or any
    leaves with ``ndim``).  ``pipeline=True`` shards the stacked layer axis
    over ``pipe``."""
    lead = "pipe" if pipeline else None

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (str(k),)) for k, v in tree.items()}
        return _spec_for("/".join(path), tree.ndim, lead)

    return walk(params, ())


def batch_spec() -> tuple:
    """Tokens/labels (batch, seq): batch over data+fsdp, seq over seq."""
    return (("data", "fsdp"), "seq")


def activation_spec() -> tuple:
    """(batch, seq, d_model) activations."""
    return (("data", "fsdp"), "seq", None)


def _fit_spec(spec: tuple, mesh, shape) -> tuple:
    """The spec restricted to what ``mesh`` and ``shape`` allow: axes the
    mesh lacks are dropped, and a dimension that does not divide by its
    axes' total size replicates (an odd vocab under tensor=2 still loads)."""
    fitted = []
    for i, ax in enumerate(spec):
        axes = axes_of(ax)
        kept = tuple(a for a in axes if a in mesh.axis_names)
        div = mesh.axes_size(kept)
        if not kept or shape[i] % div != 0:
            fitted.append(None)
        else:
            fitted.append(kept if isinstance(ax, (tuple, list)) else kept[0])
    return tuple(fitted)


def check_divides(spec: tuple, mesh, shape, name: str = "leaf") -> None:
    for i, ax in enumerate(spec):
        n = mesh.axes_size(axes_of(ax))
        if shape[i] % n:
            raise ValueError(f"{name}: dimension {i} of {tuple(shape)} does not divide "
                             f"by {ax}={n} (spec {spec})")


def local_slice(full: torch.Tensor, spec: tuple, mesh, rank=None) -> torch.Tensor:
    """``rank``'s (default: this rank's) slice of a whole leaf: a copy."""
    out = full
    for i, ax in enumerate(spec):
        axes = axes_of(ax)
        if not axes:
            continue
        n = mesh.axes_size(axes)
        if n == 1:
            continue
        if full.shape[i] % n:
            raise ValueError(f"dimension {i} of {tuple(full.shape)} does not divide by "
                             f"{ax}={n}")
        size = full.shape[i] // n
        out = out.narrow(i, mesh.axes_index(axes, rank) * size, size)
    return out.clone(memory_format=torch.contiguous_format)


def full_leaf(local: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole leaf from every rank's slice (an all-gather over each
    sharded dimension's axes; a collective call)."""
    out = local.detach()
    for i, ax in enumerate(spec):
        axes = axes_of(ax)
        if axes and mesh.axes_size(axes) > 1:
            out = all_gather(out, mesh, axes, dim=i)
    return out


def shard_params(params: Any, mesh, pipeline: bool = False, strict: bool = True,
                 rank=None) -> Any:
    """Each leaf's slice for ``rank`` under the sharding rules.  Strict
    raises where a dimension does not divide; ``strict=False`` fits each
    spec to the mesh and shape (``_fit_spec``), the mode for serving an
    arbitrary checkpoint or restoring onto a smaller mesh."""
    specs = param_specs(params, pipeline=pipeline)

    def walk(tree, sp, path):
        if isinstance(tree, dict):
            return {k: walk(tree[k], sp[k], path + (k,)) for k in tree}
        s = sp if strict else _fit_spec(sp, mesh, tree.shape)
        if strict:
            check_divides(s, mesh, tree.shape, "/".join(path))
        return local_slice(tree, s, mesh, rank)

    return walk(params, specs, ())


def slice_tree(params: Any, specs: Any, mesh, rank=None) -> Any:
    """Each leaf's slice for ``rank`` (default: this rank) under a spec
    tree of the same structure."""
    if isinstance(params, dict):
        return {k: slice_tree(params[k], specs[k], mesh, rank) for k in params}
    return local_slice(params, specs, mesh, rank)


# the axes a serving rank's weights are cut over; the attention leaves
# are cut only where every rank keeps whole query and KV heads
SERVING_AXES = ("tensor", "expert")
_ATTENTION = ("wq", "wk", "wv", "wo")


def serving_specs(params: Any, cfg, mesh) -> Any:
    """The spec tree of a serving rank's slice (``slice_tree``): the
    rules restricted to ``SERVING_AXES``; ``wq`` / ``wk`` / ``wv`` / ``wo``
    replicated unless ``tensor`` divides both ``cfg.n_heads`` and
    ``cfg.kv_heads`` (the layers' collectives need whole heads, where
    GSPMD would cut a 48-wide ``wq`` across head boundaries); each spec
    fitted to its leaf's shape (``_fit_spec``: a dimension that does not
    divide replicates).  An int8 leaf's ``q8`` takes its weight's spec and
    its ``scale`` (..., 1, N) the same, whose unit dimension replicates."""
    T = mesh.axes_size("tensor")
    whole_heads = cfg.n_heads % T == 0 and cfg.kv_heads % T == 0

    def restrict(ax):
        kept = tuple(a for a in axes_of(ax) if a in SERVING_AXES)
        if not kept:
            return None
        return kept if isinstance(ax, (tuple, list)) else kept[0]

    def walk(tree, sp, path):
        if isinstance(tree, dict):
            return {k: walk(tree[k], sp[k], path + (k,)) for k in tree}
        s = tuple(restrict(ax) for ax in sp)
        if not whole_heads and path[:1] == ("layers",) and path[1] in _ATTENTION:
            s = (None,) * len(s)
        return _fit_spec(s, mesh, tree.shape)

    return walk(params, param_specs(params), ())


def leaf_specs(params: Any, mesh, pipeline: bool = False) -> Any:
    """The spec tree with axes of size 1 dropped: what each local leaf is
    sharded over on ``mesh``."""
    def drop(s):
        return tuple(ax if mesh.axes_size(axes_of(ax)) > 1 else None for ax in s)

    def walk(sp):
        return {k: walk(v) for k, v in sp.items()} if isinstance(sp, dict) else drop(sp)

    return walk(param_specs(params, pipeline))


def local_batch(tokens, mesh):
    """This rank's rows of a global (B, ...) batch: cut by its (data, fsdp)
    index, as ``batch_spec`` places it."""
    axes = ("data", "fsdp")
    n = mesh.axes_size(axes)
    if tokens.shape[0] % n:
        raise ValueError(f"global batch {tokens.shape[0]} not divisible by data*fsdp={n}")
    b = tokens.shape[0] // n
    i = mesh.axes_index(axes)
    return tokens[i * b:(i + 1) * b]
