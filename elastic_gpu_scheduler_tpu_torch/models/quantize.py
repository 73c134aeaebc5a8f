"""Weight access for the matmul sites.

Counterpart of ``elastic_gpu_scheduler_tpu/models/quantize.py`` for dense
weights.  Weight-only int8 ({"q8", "scale"} leaves) is a later slice of the
port: ``wmat`` raises on such a leaf rather than misreading it.
"""

from __future__ import annotations

from typing import Any

import torch


def is_qtensor(x: Any) -> bool:
    return isinstance(x, dict) and "q8" in x and "scale" in x


def wmat(w: Any, dtype: torch.dtype) -> torch.Tensor:
    """Weight as a dense matrix in ``dtype``."""
    if is_qtensor(w):
        raise NotImplementedError(
            "int8 weight-only quantized tensors are not ported yet "
            "(models/quantize is a later slice of the port)"
        )
    return w.to(dtype)
