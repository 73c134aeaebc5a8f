"""Expert-indexed / int8 weight product: the hand-written Hopper kernel KE
and its plain PyTorch version.

``y[t] = x[t] @ W[ids[t]]`` for x (T, K) and an expert stack W (E, K, N),
with fp32 sums; a token whose id lies outside [0, E) gets a zero row.  W is in x's dtype, or int8 ``q8`` with per-column fp32
scales (E, 1, N) (``models/quantize``).  ``ids`` None puts every token on
expert 0: the dense int8 product, E = 1.

It replaces no Pallas kernel: in the reference this is XLA's fusion of
``wmat`` into the matmul's weight read (``models/quantize.py``) and the
gather and ``lax.ragged_dot`` forms of ``_moe_ffn_serve``
(``models/serving.py``).  On a CUDA tensor ``expert_matmul`` launches
``csrc/expert_matmul.cu`` once, which reads the weights in place through a
TMA ring (int8 stays int8 until it is in registers), finds each expert's
tokens on the device and touches only experts that some token chose; on a
CPU tensor it computes ``expert_matmul_reference``.  Its launches count as
``expert_matmul``.  ``expert_matmul_plan`` names the kernel a call takes.

Both dequantise as the reference's ``wmat``: for a bf16 x,
``bf16(bf16(q) * bf16(scale))``; for a float32 x, ``float(q) * scale``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .attention import _DTYPE_CODES


def dequantize(w: torch.Tensor, scale: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """W as a dense tensor in ``dtype``: an int8 W times its scales, both
    cast to ``dtype`` first (the reference's ``wmat``); else W cast."""
    if scale is None:
        return w.to(dtype)
    return w.to(dtype) * scale.to(dtype)


def expert_matmul_reference(x: torch.Tensor, w: torch.Tensor, ids: Optional[torch.Tensor],
                            scale: Optional[torch.Tensor] = None,
                            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain version: W dequantised as above, then per expert the rows
    routed to it (``index_select``) times its matrix, exact products summed
    in fp32, cast once to ``out_dtype`` (x's dtype when None)."""
    wd = dequantize(w, scale, x.dtype).float()
    xf = x.float()
    if ids is None:
        y = xf @ wd[0]
    else:
        y = torch.zeros((x.shape[0], w.shape[-1]), dtype=torch.float32, device=x.device)
        for e in range(w.shape[0]):
            sel = (ids == e).nonzero()[:, 0]
            if sel.numel():
                y.index_copy_(0, sel, xf.index_select(0, sel) @ wd[e])
    return y.to(out_dtype or x.dtype)


def _check(x, w, ids, scale, out_dtype) -> None:
    if x.ndim != 2 or w.ndim != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(
            f"expert_matmul: x{tuple(x.shape)} and w{tuple(w.shape)} are not (T, K) and (E, K, N)"
        )
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"expert_matmul takes float32 or bfloat16 x, got {x.dtype}")
    if w.dtype == torch.int8:
        if scale is None or scale.dtype != torch.float32 or tuple(scale.shape) != (
                w.shape[0], 1, w.shape[2]):
            raise ValueError(
                f"expert_matmul: an int8 w{tuple(w.shape)} needs float32 scales of shape "
                f"{(w.shape[0], 1, w.shape[2])}"
            )
    elif w.dtype != x.dtype or scale is not None:
        raise TypeError(
            f"expert_matmul: w must be int8 with scales or x's dtype {x.dtype} without, "
            f"got {w.dtype}"
        )
    if out_dtype not in (None, x.dtype, torch.float32):
        raise TypeError(f"expert_matmul writes x's dtype or float32, not {out_dtype}")
    if ids is not None and (ids.dtype != torch.int32 or tuple(ids.shape) != (x.shape[0],)):
        raise ValueError(
            f"expert_matmul: ids must be int32 of shape ({x.shape[0]},), got "
            f"{ids.dtype} {tuple(ids.shape)}"
        )
    if ids is None and w.shape[0] != 1:
        raise ValueError(f"expert_matmul: {w.shape[0]} experts need ids")
    devs = {t.device for t in (x, w, ids, scale) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"expert_matmul inputs on different devices: {sorted(map(str, devs))}")


def expert_matmul(x: torch.Tensor, w: torch.Tensor, ids: Optional[torch.Tensor], *,
                  scale: Optional[torch.Tensor] = None,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``y[t] = x[t] @ W[ids[t]]``, (T, N) in ``out_dtype`` (x's dtype when
    None, or float32).  ids (T,) int32; a row whose id lies outside [0, E)
    (a token routed to another rank's experts) is zeros, in the kernel and
    the plain version alike; None: one expert."""
    _check(x, w, ids, scale, out_dtype)
    if x.device.type == "cpu":
        return expert_matmul_reference(x, w, ids, scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"expert_matmul: unsupported device {x.device}")
    return _expert_matmul_cuda(x, w, ids, scale, out_dtype or x.dtype)


def _expert_matmul_cuda(x, w, ids, scale, out_dtype):
    """Launch KE (csrc/expert_matmul.cu); raises on anything it does not take."""
    if not w.is_contiguous():
        raise ValueError("expert_matmul kernel reads w in place: pass a contiguous w")
    T, K = x.shape
    E, _, N = w.shape
    out = torch.empty((T, N), dtype=out_dtype, device=x.device)
    if T == 0:
        return out
    lib = _build.lib()
    x = x.contiguous()
    plan = (T, K, N, E, int(ids is None), _DTYPE_CODES[x.dtype], int(w.dtype == torch.int8),
            _aligned(x, w))
    n_part = lib.egs_expert_matmul_workspace(*plan)
    part = torch.empty(n_part, dtype=torch.float32, device=x.device) if n_part else None
    sc = scale.contiguous() if scale is not None else None
    err = lib.egs_expert_matmul(
        x.data_ptr(), w.data_ptr(), sc.data_ptr() if sc is not None else None,
        ids.contiguous().data_ptr() if ids is not None else None, out.data_ptr(),
        part.data_ptr() if n_part else None, T, K, N, E, _DTYPE_CODES[x.dtype],
        int(w.dtype == torch.int8), int(out_dtype == torch.float32), plan[-1],
        _build.stream_ptr(x.device),
    )
    _build.check(err, "expert_matmul launch")
    _build.LAUNCHES["expert_matmul"] += 1
    return out


def _aligned(x, w) -> int:
    return int(x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


# the kernels by route, as the plan's route code numbers them
ROUTES = ("expert_matmul_kernel", "expert_matmul_ring_kernel", "expert_matmul_wgmma_kernel")


def expert_matmul_plan(x: torch.Tensor, w: torch.Tensor, ids: Optional[torch.Tensor]) -> dict:
    """The plan the kernel gives a call, from the shapes only: the kernel
    (``route``: CUDA cores, the ring kernel for decode runs, the wgmma kernel
    for grouped runs), its K splits (the ring kernel's thread-block
    cluster; CUDA cores add theirs with the combine kernel), and the depth
    of the TMA weight ring (0 on CUDA cores)."""
    T, K = x.shape
    E, _, N = w.shape
    code = _build.lib().egs_expert_matmul_plan(T, K, N, E, int(ids is None),
                                                _DTYPE_CODES[x.dtype], int(w.dtype == torch.int8),
                                                _aligned(x, w))
    route, splits, stages = code & 15, (code >> 4) & 15, code >> 8
    return {"route": ROUTES[route], "tensor_cores": route > 0, "splits": splits,
            "cluster": splits if route == 1 else 1, "ring_depth": stages,
            "combine": route == 0 and splits > 1}
