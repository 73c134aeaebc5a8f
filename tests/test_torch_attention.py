"""Port parity for the flash-attention forward (kernel K1).

The same numpy inputs go through the JAX package's ``flash_attention``
(on the CPU: its ``mha_reference``), its Pallas kernel in interpret mode
(resident and streamed variants), and the port's ``flash_attention`` on
CPU tensors (its plain version).  The CUDA kernel itself is held
against the plain version on the card (tests/test_torch_kernels_gpu.py).

Tolerances: float32 2e-5 and bfloat16 2e-2 (tests/test_paged_kernel.py's),
absolute, on outputs and logsumexps of unit-scale random inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.ops.attention import (
    _flash_forward_pallas,
    flash_attention as jax_flash_attention,
    mha_reference as jax_mha_reference,
)
from elastic_gpu_scheduler_tpu_torch.models.bridge import tensor_from_numpy
from elastic_gpu_scheduler_tpu_torch.ops.attention import flash_attention

# the suite runs in parallel worker processes: one intra-op thread keeps
# this file from crowding the workers that run beside it
torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (B, H, Sq, Sk, D, causal, window): square, rectangular (queries at the
# last Sq keys), sliding window, non-power-of-two lengths, non-causal; then
# shapes that cross more than one 64-row tile, the CUDA kernel's edges on
# the card (one row past a tile, a window ending mid-tile, Sq 1)
CASES = [
    (2, 2, 64, 64, 32, True, 0),
    (1, 3, 48, 80, 64, True, 0),
    (1, 2, 96, 96, 32, True, 20),
    (2, 1, 37, 37, 32, True, 0),
    (1, 2, 21, 50, 64, True, 9),
    (1, 2, 40, 40, 32, False, 0),
    (1, 2, 129, 200, 128, True, 0),
    (1, 2, 150, 150, 64, True, 70),
    (1, 1, 1, 65, 64, True, 0),
    (1, 2, 65, 65, 32, True, 0),
    (1, 2, 130, 190, 64, False, 0),
]


def _inputs(case, dtype, seed=0):
    B, H, Sq, Sk, D = case[:5]
    rng = np.random.default_rng(seed)
    arrs = [
        rng.standard_normal(s).astype(np.float32)
        for s in ((B, H, Sq, D), (B, H, Sk, D), (B, H, Sk, D))
    ]
    if dtype == "bfloat16":
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in arrs]
    return arrs


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_flash_attention_matches_jax(case, dtype):
    *_, causal, window = case
    qn, kn, vn = _inputs(case, dtype)
    want, want_lse = jax_mha_reference(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), causal, None, window
    )
    want_fa = jax_flash_attention(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), causal, None, window
    )
    q, k, v = (tensor_from_numpy(a, "cpu") for a in (qn, kn, vn))
    got, got_lse = flash_attention(q, k, v, causal, None, window, return_lse=True)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(_np32(got), _np32(want), atol=tol)
    np.testing.assert_allclose(_np32(got), _np32(want_fa), atol=tol)
    np.testing.assert_allclose(_np32(got_lse), _np32(want_lse), atol=2e-5 if dtype == "float32" else 1e-4)


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize(
    "case", [(1, 2, 64, 64, 32, True, 0), (1, 2, 48, 80, 32, True, 0),
             (1, 2, 96, 96, 32, True, 20)], ids=str,
)
def test_flash_attention_matches_pallas_interpret(case, resident):
    """Against the TPU kernel itself (interpret mode), both its variants;
    lengths are multiples of 16 so the kernel's block fitting accepts them
    (48 and 80 are not powers of two)."""
    *_, causal, window = case
    qn, kn, vn = _inputs(case, "float32", seed=1)
    D = qn.shape[-1]
    want, want_lse = _flash_forward_pallas(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), causal, D ** -0.5,
        32, 32, interpret=True, window=window, return_lse=True, resident=resident,
    )
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    got, got_lse = flash_attention(q, k, v, causal, None, window, return_lse=True)
    np.testing.assert_allclose(_np32(got), _np32(want), atol=2e-5)
    np.testing.assert_allclose(_np32(got_lse), _np32(want_lse), atol=2e-5)


def test_flash_attention_refuses_autograd():
    """Autograd runs through the output (K4's backward, ported) and is
    refused through the logsumexp, which the reference does not
    differentiate either."""
    q = torch.zeros(1, 1, 8, 32, requires_grad=True)
    out, lse = flash_attention(q, q, q, return_lse=True)
    assert out.requires_grad and not lse.requires_grad
    with pytest.raises(RuntimeError, match="does not require grad"):
        torch.autograd.grad(lse.sum(), q)
    (dq,) = torch.autograd.grad(out.sum(), q)
    assert dq.shape == q.shape and bool(torch.isfinite(dq).all())
