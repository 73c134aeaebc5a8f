"""Port parity for the flash-attention backward (kernel K4).

The same numpy inputs go through the JAX package's ``flash_attention``
under ``jax.grad`` (on the CPU: its ``mha_reference`` forward and its XLA
einsum backward), its Pallas backward kernels in interpret mode (resident
and streamed variants), and the port's ``flash_attention`` under
``torch.autograd`` on CPU tensors (``FlashAttention``: ``mha_reference``
forward, ``flash_backward_reference`` backward).  The CUDA kernel itself
is held against ``flash_backward_reference`` on the card
(tests/test_torch_kernels_gpu.py).

Tolerances: float32 1e-5 absolute against ``jax.grad`` (the same fp32
einsums, summed in another order); 2e-2 absolute and relative against
the Pallas kernels, as tests/test_model.py holds those kernels to autodiff
of the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.ops.attention import (
    _flash_backward_pallas,
    _flash_forward_pallas,
    flash_attention as jax_flash_attention,
)
from elastic_gpu_scheduler_tpu_torch.ops.attention import (
    flash_attention,
    flash_backward,
    flash_backward_reference,
    mha_reference,
)

torch.set_num_threads(1)

# (B, H, Sq, Sk, D, causal, window): square, rectangular, sliding window,
# ragged lengths, non-causal
CASES = [
    (2, 2, 64, 64, 32, True, 0),
    (1, 3, 48, 80, 64, True, 0),
    (1, 2, 96, 96, 32, True, 20),
    (2, 1, 37, 37, 32, True, 0),
    (1, 2, 21, 50, 64, True, 9),
    (1, 2, 40, 40, 32, False, 0),
]


def _inputs(case, seed):
    B, H, Sq, Sk, D = case[:5]
    rng = np.random.default_rng(seed)
    shapes = ((B, H, Sq, D), (B, H, Sk, D), (B, H, Sk, D), (B, H, Sq, D))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _torch_grads(qn, kn, vn, don, causal, window, scale=None):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn)]
    out = flash_attention(*leaves, causal, scale, window)
    return torch.autograd.grad(out, leaves, torch.from_numpy(don))


@pytest.mark.parametrize("case", CASES, ids=str)
def test_flash_attention_grads_match_jax_grad(case):
    *_, causal, window = case
    qn, kn, vn, don = _inputs(case, seed=0)

    def loss(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, causal, None, window) * don)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (qn, kn, vn)))
    got = _torch_grads(qn, kn, vn, don, causal, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, err_msg=name)


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("shape", [(256, 256, 100), (128, 256, 0), (128, 256, 60)], ids=str)
def test_flash_backward_matches_pallas_interpret(shape, resident):
    """Against the TPU kernels themselves (interpret mode), at the shapes
    tests/test_model.py checks them with."""
    sq, sk, window = shape
    B, H, D = 1, 2, 16
    qn, kn, vn, don = _inputs((B, H, sq, sk, D), seed=sq + sk + window)
    scale = D ** -0.5
    jq, jk, jv, jdo = map(jnp.asarray, (qn, kn, vn, don))
    out, lse = _flash_forward_pallas(
        jq, jk, jv, causal=True, sm_scale=scale, block_q=64, block_k=64,
        interpret=True, window=window, return_lse=True,
    )
    want = _flash_backward_pallas(
        jq, jk, jv, out, lse, jdo, True, scale, block_q=64, block_k=64,
        interpret=True, window=window, resident=resident,
    )
    got = _torch_grads(qn, kn, vn, don, True, window, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-2, atol=2e-2,
                                   err_msg=f"{name} {shape}")


def test_flash_backward_on_cpu_is_the_plain_version():
    """The wrapper takes the plain version for CPU tensors (and casts dO
    to q's dtype there as the kernel does), with no launch counted."""
    from elastic_gpu_scheduler_tpu_torch.ops import _build

    qn, kn, vn, don = _inputs((1, 2, 24, 40, 32), seed=3)
    q, k, v, do = map(torch.from_numpy, (qn, kn, vn, don))
    out, lse = mha_reference(q, k, v, True, None, 5)
    before = dict(_build.LAUNCHES)
    got = flash_backward(q, k, v, out, lse, do, True, None, 5)
    want = flash_backward_reference(q, k, v, out, lse, do, True, None, 5)
    assert _build.LAUNCHES == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_flash_attention_bf16_grads_keep_dtypes():
    qn, kn, vn, don = _inputs((1, 2, 16, 16, 32), seed=4)
    leaves = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (qn, kn, vn)]
    out = flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(don).bfloat16())
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all() for g in grads)


@pytest.mark.parametrize("resident", [True, False])
def test_rounded_reference_matches_pallas_bf16(resident):
    """``round_like_kernel`` rounds P and dS to bfloat16 where the TPU
    kernels (and K4) do: in bfloat16 it agrees with the Pallas backward
    in interpret mode within ``grad_close``'s rounded rule, and in
    float32 it changes nothing."""
    from elastic_gpu_scheduler_tpu_torch.ops.attention import grad_close

    B, H, sq, sk, D, window = 1, 2, 128, 256, 32, 60
    qn, kn, vn, don = _inputs((B, H, sq, sk, D), seed=7)
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (qn, kn, vn, don))
    out, lse = _flash_forward_pallas(
        jq, jk, jv, causal=True, sm_scale=D ** -0.5, block_q=64, block_k=64,
        interpret=True, window=window, return_lse=True,
    )
    want = _flash_backward_pallas(
        jq, jk, jv, out, lse, jdo, True, D ** -0.5, block_q=64, block_k=64,
        interpret=True, window=window, resident=resident,
    )
    q, k, v, o, do = (torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
                      for a in (jq, jk, jv, out, jdo))
    lse_t = torch.tensor(np.asarray(lse, np.float32))
    got = flash_backward_reference(q, k, v, o, lse_t, do, True, None, window,
                                   round_like_kernel=True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        assert grad_close(g, torch.from_numpy(np.asarray(w, np.float32)).bfloat16()), name
    qf, kf, vf, dof = map(torch.from_numpy, (qn, kn, vn, don))
    of, lf = mha_reference(qf, kf, vf, True, None, window)
    for a, b in zip(flash_backward_reference(qf, kf, vf, of, lf, dof, True, None, window),
                    flash_backward_reference(qf, kf, vf, of, lf, dof, True, None, window,
                                             round_like_kernel=True)):
        assert torch.equal(a, b)
