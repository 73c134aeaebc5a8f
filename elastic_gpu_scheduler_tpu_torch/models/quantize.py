"""Weight-only int8 quantization for inference.

Counterpart of ``elastic_gpu_scheduler_tpu/models/quantize.py``.  Matmul
weights are stored as int8 with per-output-channel fp32 scales
({"q8", "scale"} leaves); norm scales, the MoE router and small vectors
stay full precision.

The reference's ``wmat`` relies on XLA folding ``q8.astype(dtype) *
scale`` into the matmul's weight read, so the int8 weight is read and
never written out dense.  PyTorch folds nothing: ``wmat`` here is the
plain dequantisation (a dense copy), and the matmul sites call
``wmatmul``, which sends an int8 leaf to kernel KE
(``ops/expert_matmul``) on CUDA, where it is dequantised in registers.

Usage:
    qparams = quantize_params(params)   # tree with {"q8", "scale"} leaves
    y = wmatmul(x, qparams["layers"]["wq"][0], dtype)
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..ops.expert_matmul import expert_matmul
from ..ops.xent import mm_f32


def is_qtensor(x: Any) -> bool:
    return isinstance(x, dict) and "q8" in x and "scale" in x


def quantize_tensor(w: torch.Tensor) -> dict:
    """Per-output-channel symmetric int8 quantization over the contraction
    axis (-2), leading stack axes kept, bit for bit the reference's: the
    scale ``absmax / 127`` is computed in the weight's own dtype (a bf16
    weight gets a bf16-rounded scale) before the cast to fp32, and the
    quotient rounds half to even."""
    absmax = w.abs().amax(dim=-2, keepdim=True)
    scale = (absmax / 127.0).to(torch.float32)
    q = torch.clamp(torch.round(w / torch.clamp(scale, min=1e-12)), -127, 127).to(torch.int8)
    return {"q8": q, "scale": scale}


# matmul-weight leaves by name; norms, biases and the router stay full precision
_QUANT_KEYS = (
    "embed", "unembed", "wq", "wk", "wv", "wo", "w_in", "w_gate", "w_out",
    "patch_embed", "head",
)


def quantize_params(params: Any) -> Any:
    """Quantize every matmul weight leaf; returns a mixed tree."""

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if name in _QUANT_KEYS and tree.ndim >= 2:
            return quantize_tensor(tree)
        return tree

    return walk(params)


def wmat(w: Any, dtype: torch.dtype) -> torch.Tensor:
    """Weight as a dense matrix in ``dtype``: a dense leaf is cast, an int8
    leaf dequantised as the reference does (``q8`` and ``scale`` each cast
    to ``dtype``, then multiplied in it)."""
    if is_qtensor(w):
        return w["q8"].to(dtype) * w["scale"].to(dtype)
    return w.to(dtype)


def wmatmul(x: torch.Tensor, w: Any, dtype: torch.dtype,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ wmat(w, dtype)`` for a (d_in, d_out) weight, x (..., d_in) in
    ``dtype``.  A dense leaf takes ``torch.matmul``; an int8 leaf takes
    ``expert_matmul`` as its E = 1 case (kernel KE on CUDA, the weight read
    as int8): fp32 sums, the result in ``dtype``, or unrounded with
    ``out_dtype`` float32 (a row-parallel rank's partial sums)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if not is_qtensor(w):
        if out_dtype in (None, dtype):
            return x @ w.to(dtype)
        y = mm_f32(x2, w.to(dtype))
    else:
        y = expert_matmul(x2, w["q8"][None], None, scale=w["scale"][None], out_dtype=out_dtype)
    return y.reshape(*lead, y.shape[-1])


def quantized_bytes(params: Any) -> int:
    """Total parameter bytes after quantization (for memory reporting)."""
    if isinstance(params, dict):
        return sum(quantized_bytes(v) for v in params.values())
    return params.numel() * params.element_size()
