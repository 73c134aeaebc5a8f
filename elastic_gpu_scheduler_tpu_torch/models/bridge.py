"""Parameter trees between the JAX package's layout and the port's.

``params_from_jax`` takes the reference's parameter tree with its leaves
already as numpy arrays (``jax.tree.map(np.asarray, params)`` on the JAX
side) and returns the same tree of torch tensors: the same nesting, the
same shapes (weights (in, out), layers stacked on a leading L axis) and
the same dtypes.  It imports nothing of JAX.

bfloat16 arrives as an ``ml_dtypes`` bfloat16 array, which
``torch.from_numpy`` refuses, so it crosses as its raw 16 bits
(``view(np.uint16)`` → ``view(torch.bfloat16)``): the conversion is
bit-exact.  ``params_to_numpy`` is the way back, with bfloat16 leaves as
their raw bits in uint16 arrays (view them as ``ml_dtypes.bfloat16`` to
compare).  ``lora_from_jax`` / ``lora_to_numpy`` carry a LoRA adapter
tree (``{"adapters", "alpha", "rank"}``) the same way, and
``vit_params_from_jax`` the ViT family's tree (``models/vit``), int8
leaves ({"q8", "scale"}) included.
"""

from __future__ import annotations

import numpy as np
import torch

from .train import AdamWState, MasterState, _map
from .transformer import resolve_device

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int8): torch.int8,
}


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    if a.dtype not in _NP_TO_TORCH:
        raise TypeError(f"no torch counterpart for numpy dtype {a.dtype}")
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_from_jax(tree, device=None):
    """Nested dict of numpy arrays → the same nested dict of tensors."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    return tensor_from_numpy(tree, dev)


def params_to_numpy(tree):
    """Nested dict of tensors → nested dict of numpy arrays (bf16 as uint16 bits)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tensor_to_numpy(tree)


_VIT_KEYS = {"patch_embed", "pos_embed", "cls_token", "layers", "final_norm", "head"}


def vit_params_from_jax(tree, device=None):
    """The reference's ``init_vit_params`` tree (numpy leaves, or a
    ``quantize_params`` tree of it) → the port's: the same nesting,
    shapes and dtypes.  Raises when the top-level keys are not the ViT's."""
    if set(tree) != _VIT_KEYS:
        raise ValueError(f"not a ViT params tree: keys {sorted(tree)}, want {sorted(_VIT_KEYS)}")
    return params_from_jax(tree, device)


def lora_from_jax(lora_np: dict, device=None) -> dict:
    """The reference's ``lora_init`` tree with numpy leaves → the port's:
    the same nesting, ``alpha`` and ``rank``, fp32 tensors on ``device``."""
    dev = resolve_device(device)
    adapters = _map(lambda a: tensor_from_numpy(np.asarray(a, np.float32), dev),
                    lora_np["adapters"])
    return {"adapters": adapters, "alpha": float(lora_np["alpha"]),
            "rank": int(lora_np["rank"])}


def lora_to_numpy(lora: dict) -> dict:
    """The port's adapter tree → the reference's layout with numpy
    leaves (``jax.tree.map(jnp.asarray, ...)`` makes it the reference's)."""
    return {"adapters": params_to_numpy(lora["adapters"]), "alpha": float(lora["alpha"]),
            "rank": int(lora["rank"])}


def _adam_states(tree, found: list) -> None:
    """Every namedtuple with a ``count`` field, in order (optax's
    ``ScaleByAdamState`` and ``ScaleByScheduleState``)."""
    if hasattr(tree, "_fields"):
        if "count" in tree._fields:
            found.append(tree)
            return
    if isinstance(tree, (tuple, list)):
        for t in tree:
            _adam_states(t, found)


def opt_state_from_jax(state, device=None):
    """An optax AdamW state (numpy leaves) → the port's ``AdamWState``, or
    a ``MasterState`` of (master, inner) → the port's ``MasterState``."""
    dev = resolve_device(device)
    if hasattr(state, "_fields") and {"master", "inner"} <= set(state._fields):
        return MasterState(params_from_jax(state.master, dev),
                           opt_state_from_jax(state.inner, dev))
    found: list = []
    _adam_states(state, found)
    adam = [s for s in found if "mu" in s._fields and "nu" in s._fields]
    if len(adam) != 1:
        raise ValueError(f"expected one adam state (count, mu, nu), found {len(adam)}")
    counts = {int(np.asarray(s.count)) for s in found}
    if len(counts) != 1:
        raise ValueError(f"adam and schedule counts disagree: {sorted(counts)}")
    a = adam[0]
    return AdamWState(count=counts.pop(), mu=params_from_jax(a.mu, dev),
                      nu=params_from_jax(a.nu, dev))
