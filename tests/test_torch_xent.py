"""Port parity for the vocab-chunked cross-entropy (ops/xent.py).

The same numpy hidden states, unembedding and targets (some of them
out of range, so ignored) go through the JAX package's
``chunked_softmax_xent`` under ``jax.value_and_grad`` and the port's under
``torch.autograd``.

Tolerances: float32 loss 1e-6 and gradients 1e-6 absolute (the same fp32
sums in another order).  bfloat16 operands: both sides form exact
products summed in fp32 (the port's ``mm_f32``), so the loss agrees to
1e-5 relative; the gradients go through d_logits rounded to bfloat16 and
are themselves bfloat16, so they agree to one bfloat16 step (2^-8
relative) of the largest gradient entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.models.train import cross_entropy_loss as jax_ce
from elastic_gpu_scheduler_tpu.ops.xent import chunked_softmax_xent as jax_xent
from elastic_gpu_scheduler_tpu_torch.models.bridge import tensor_from_numpy, tensor_to_numpy
from elastic_gpu_scheduler_tpu_torch.models.train import cross_entropy_loss
from elastic_gpu_scheduler_tpu_torch.ops.xent import (
    chunked_softmax_xent,
    chunked_softmax_xent_tp,
    mm_f32,
)

torch.set_num_threads(1)

B, S, D, V = 2, 9, 32, 96


def _inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * D ** -0.5).astype(np.float32)
    t = rng.integers(0, V, (B, S)).astype(np.int32)
    t[0, 2], t[1, 0], t[1, 5] = -100, V, V + 7  # ignored ids
    if dtype == "bfloat16":
        x, w = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (x, w))
    return x, w, t


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("n_chunks", [1, 4, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_xent_matches_jax(dtype, n_chunks):
    x, w, t = _inputs(dtype)
    loss_j, (dx_j, dw_j) = jax.value_and_grad(
        lambda x, w: jax_xent(x, w, jnp.asarray(t), n_chunks), argnums=(0, 1)
    )(jnp.asarray(x), jnp.asarray(w))
    xt, wt = (tensor_from_numpy(a, "cpu").requires_grad_() for a in (x, w))
    loss = chunked_softmax_xent(xt, wt, torch.from_numpy(t), n_chunks)
    dx, dw = torch.autograd.grad(loss, (xt, wt))
    assert dx.dtype == xt.dtype and dw.dtype == wt.dtype
    if dtype == "float32":
        np.testing.assert_allclose(float(loss.detach()), float(loss_j), atol=1e-6)
        np.testing.assert_allclose(_f32(dx), _f32(dx_j), atol=1e-6)
        np.testing.assert_allclose(_f32(dw), _f32(dw_j), atol=1e-6)
    else:
        np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
        for g, gj in ((dx, dx_j), (dw, dw_j)):
            ref = _f32(gj)
            np.testing.assert_allclose(_f32(g), ref, atol=2 ** -8 * np.abs(ref).max())
    # ignored positions get exactly zero gradient
    assert not dx[0, 2].any() and not dx[1, 0].any() and not dx[1, 5].any()


def test_chunked_xent_equals_dense_loss():
    """Chunked and dense paths agree on any input, ignored ids included."""
    x, w, t = _inputs("float32", seed=1)
    xt, wt, tt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(t)
    dense = cross_entropy_loss((xt @ wt).float(), tt)
    want = jax_ce(jnp.asarray(x) @ jnp.asarray(w), jnp.asarray(t))
    assert abs(float(chunked_softmax_xent(xt, wt, tt, 3)) - float(dense)) < 1e-6
    assert abs(float(dense) - float(want)) < 1e-6


def test_all_ignored_targets_give_zero_loss():
    x, w, _ = _inputs("float32")
    t = torch.full((B, S), -1, dtype=torch.int32)
    xt = torch.from_numpy(x).requires_grad_()
    loss = chunked_softmax_xent(xt, torch.from_numpy(w), t, 2)
    (dx,) = torch.autograd.grad(loss, xt)
    assert float(loss.detach()) == 0.0 and not dx.any()


def test_mm_f32_keeps_bf16_products_exact():
    rng = np.random.default_rng(2)
    a = np.asarray(jnp.asarray(rng.standard_normal((5, 64)), jnp.bfloat16))
    b = np.asarray(jnp.asarray(rng.standard_normal((64, 7)), jnp.bfloat16))
    want = jnp.dot(jnp.asarray(a), jnp.asarray(b), preferred_element_type=jnp.float32)
    got = mm_f32(tensor_from_numpy(a, "cpu"), tensor_from_numpy(b, "cpu"))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(tensor_to_numpy(got), np.asarray(want), atol=1e-5)


def test_refusals():
    x, w, t = (torch.from_numpy(a) for a in _inputs("float32"))
    with pytest.raises(ValueError, match="not divisible"):
        chunked_softmax_xent(x, w, t, 5)
    from elastic_gpu_scheduler_tpu_torch.parallel.mesh import MeshSpec, RankDevice, make_mesh

    mesh = make_mesh(MeshSpec(tensor=2), [RankDevice(0), RankDevice(1)])
    with pytest.raises(ValueError, match="multiple of tensor=2"):
        chunked_softmax_xent_tp(x, w, t, 3, mesh)
