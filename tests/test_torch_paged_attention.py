"""Port parity for paged decode / verify attention (kernel K2).

The matrix of tests/test_paged_kernel.py over dense pools (int8 pools:
tests/test_torch_kv_int8.py): the same numpy inputs through the JAX package's
``paged_attention`` (Pallas, interpret mode), its
``paged_attention_reference``, and the port's ``paged_attention`` on CPU
tensors.  The CUDA kernel is held against the plain version on the card
in tests/test_torch_kernels_gpu.py.

Tolerances: float32 2e-5, bfloat16 2e-2 (test_paged_kernel.py's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention,
    paged_attention_reference as jax_paged_reference,
)
from elastic_gpu_scheduler_tpu_torch.models.bridge import tensor_from_numpy
from elastic_gpu_scheduler_tpu_torch.ops.paged_attention import paged_attention

# the suite runs in parallel worker processes: one intra-op thread keeps
# this file from crowding the workers that run beside it
torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(B, W, Hn, Hkv, Dh, ps, NP, NB, dtype, lengths, seed=0, low_page=0):
    rng = np.random.default_rng(seed)
    qshape = (B, Hn, Dh) if W == 0 else (B, W, Hn, Dh)
    arrs = [
        rng.standard_normal(s).astype(np.float32)
        for s in (qshape, (NP, ps, Hkv, Dh), (NP, ps, Hkv, Dh))
    ]
    if dtype == "bfloat16":
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in arrs]
    tables = rng.integers(low_page, NP, (B, NB)).astype(np.int32)
    return (*arrs, tables, np.asarray(lengths, np.int32))


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _both(args, window=0):
    j = [jnp.asarray(a) for a in args]
    want_k = jax_paged_attention(*j, window=window, interpret=True)
    want_r = jax_paged_reference(*j, window=window)
    got = paged_attention(*(tensor_from_numpy(a, "cpu") for a in args), window=window)
    return got, want_k, want_r


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [(8, 4), (4, 4), (6, 2)])
def test_paged_attention_matches_jax(dtype, heads):
    Hn, Hkv = heads
    B, Dh, ps, NP, NB = 4, 64, 16, 12, 4
    # edge positions: 0 (first token), page boundaries, the last slot
    args = _inputs(B, 0, Hn, Hkv, Dh, ps, NP, NB, dtype, [0, 15, 16, NB * ps - 1])
    got, want_k, want_r = _both(args)
    assert got.shape == args[0].shape
    np.testing.assert_allclose(_np32(got), _np32(want_k), atol=TOL[dtype])
    np.testing.assert_allclose(_np32(got), _np32(want_r), atol=TOL[dtype])


@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("window", [0, 20])
def test_paged_attention_composition_matrix(W, window):
    """The verify window (W > 1) and sliding windows, float32."""
    Hn, Hkv, Dh, ps, NP, NB, B = 8, 4, 64, 16, 12, 4, 4
    args = _inputs(B, W, Hn, Hkv, Dh, ps, NP, NB, "float32",
                   [0, 15, 30, NB * ps - W], seed=7, low_page=1)
    got, want_k, want_r = _both(args, window)
    np.testing.assert_allclose(_np32(got), _np32(want_k), atol=2e-5)
    np.testing.assert_allclose(_np32(got), _np32(want_r), atol=2e-5)


def test_paged_attention_rank3_equals_w1():
    args = _inputs(2, 0, 4, 2, 64, 16, 8, 3, "float32", [5, 40], seed=11)
    pools = [tensor_from_numpy(a, "cpu") for a in args]
    a = paged_attention(*pools)
    b = paged_attention(pools[0][:, None], *pools[1:])[:, 0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_paged_attention_refuses_int8_scales():
    """int8 pools are served (tests/test_torch_kv_int8.py); scales given
    one without the other are refused."""
    args = [tensor_from_numpy(a, "cpu") for a in
            _inputs(1, 0, 2, 2, 32, 8, 4, 2, "float32", [3])]
    for half in ("scales_k", "scales_v"):
        with pytest.raises(ValueError, match="both scales"):
            paged_attention(*args, **{half: torch.ones(4, 8, 2)})
