"""Port parity for blockwise attention with softmax statistics (kernel K3)
and the cached multi-token attention built on it.

The same numpy inputs go through the JAX package's ``flash_block_stats``
(its Pallas kernel in interpret mode, as the JAX package's own tests run
it on the CPU) and the port's ``flash_block_stats`` on CPU tensors (its
plain version); ``_cached_attention_multi_flash`` and
``cached_attention_multi`` are held against the JAX package's the same
way.  The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_kernels_gpu.py).

Tolerances: pv is an unnormalised sum of up to Sk terms, so it is held to
``tol * l`` (l the reference's row sum of p): float32 tol 2e-5, bfloat16
2e-2 (K1's output tolerances, on pv / l); m to 2e-5 absolute (1e-4 in
bfloat16, whose products are exact in fp32 but summed in another order);
l to 2e-5 relative (1e-4 in bfloat16).  Attention outputs: float32 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.models.generate import (
    _cached_attention_multi_flash as jax_multi_flash,
    cached_attention_multi as jax_cached_attention_multi,
)
from elastic_gpu_scheduler_tpu.ops.attention import flash_block_stats as jax_block_stats
from elastic_gpu_scheduler_tpu_torch.models.bridge import tensor_from_numpy
from elastic_gpu_scheduler_tpu_torch.models.generate import (
    _cached_attention_multi_flash,
    cached_attention_multi,
)
from elastic_gpu_scheduler_tpu_torch.ops import _build
from elastic_gpu_scheduler_tpu_torch.ops.attention import (
    NEG_INF,
    flash_block_stats,
    flash_block_stats_reference,
)

# the suite runs in parallel worker processes: one intra-op thread keeps
# this file from crowding the workers that run beside it
torch.set_num_threads(1)

PV_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
M_TOL = {"float32": 2e-5, "bfloat16": 1e-4}
L_RTOL = {"float32": 2e-5, "bfloat16": 1e-4}

# (B, H, Hkv, Sq, Sk, D, q_offset, k_offset, causal); Sq and Sk multiples
# of the 32-row blocks the TPU kernel runs with here
CASES = [
    (1, 2, 2, 32, 64, 32, 32, 0, True),  # queries behind a 32-token prefix
    (2, 2, 2, 64, 96, 32, 0, 0, True),  # more keys than the diagonal reaches
    (1, 3, 3, 32, 64, 64, 0, 16, True),  # rows 0..15 keep no key
    (1, 2, 2, 32, 64, 32, 0, 64, True),  # a "future" shard: no row keeps a key
    (1, 2, 2, 32, 64, 32, 5, 3, False),  # not causal: offsets do not matter
    (1, 4, 2, 32, 64, 32, 40, 0, True),  # GQA (the TPU kernel: k/v expanded)
    (2, 4, 1, 64, 128, 64, 70, 8, True),  # MQA, both offsets
]


def _inputs(B, H, Hkv, Sq, Sk, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))]
    if dtype == "bfloat16":
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in arrs]
    return arrs


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_stats_close(got, want, dtype):
    pv, m, l = (_np32(t) for t in got)
    wpv, wm, wl = (_np32(t) for t in want)
    np.testing.assert_allclose(m, wm, atol=M_TOL[dtype], rtol=1e-6)
    np.testing.assert_allclose(l, wl, rtol=L_RTOL[dtype])
    assert np.all(np.abs(pv - wpv) <= PV_TOL[dtype] * wl[..., None]), (
        float(np.max(np.abs(pv - wpv) / wl[..., None]))
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_block_stats_matches_pallas_interpret(case, dtype):
    B, H, Hkv, Sq, Sk, D, q_off, k_off, causal = case
    qn, kn, vn = _inputs(B, H, Hkv, Sq, Sk, D, dtype)
    n_rep = H // Hkv
    want = jax_block_stats(
        jnp.asarray(qn), jnp.repeat(jnp.asarray(kn), n_rep, axis=1),
        jnp.repeat(jnp.asarray(vn), n_rep, axis=1), q_off, k_off, causal=causal,
        block_q=32, block_k=32, interpret=True,
    )
    q, k, v = (tensor_from_numpy(a, "cpu") for a in (qn, kn, vn))
    before = _build.LAUNCHES["flash_block_stats"]
    got = flash_block_stats(q, k, v, q_off, k_off, causal=causal)
    assert _build.LAUNCHES["flash_block_stats"] == before  # CPU: the plain version
    assert [t.dtype for t in got] == [torch.float32] * 3
    assert got[0].shape == (B, H, Sq, D) and got[1].shape == got[2].shape == (B, H, Sq)
    _assert_stats_close(got, want, dtype)


def test_rows_that_keep_no_key_follow_the_tpu_kernel():
    """Masked logits are the finite NEG_INF: a row with no kept key ends
    with m = NEG_INF, l = Sk and pv = the sum of v, as the TPU kernel
    gives it; the other rows do not see the masked keys at all."""
    B, H, Hkv, Sq, Sk, D = 1, 2, 1, 32, 64, 32
    qn, kn, vn = _inputs(B, H, Hkv, Sq, Sk, D, "float32", seed=3)
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    pv, m, l = flash_block_stats_reference(q, k, v, 0, 16, causal=True)
    empty, kept = slice(0, 16), slice(16, None)
    assert torch.all(m[:, :, empty] == NEG_INF)
    assert torch.all(l[:, :, empty] == Sk)
    torch.testing.assert_close(pv[:, :, empty], v.sum(dim=2, keepdim=True).expand(B, H, 16, D),
                               rtol=1e-6, atol=1e-5)
    # row i >= 16 keeps keys 0..i-16: pv / l is softmax attention over them
    for i in (16, 20, 31):
        s = (q[0, :, i] @ k[0, 0, : i - 15].T) * D ** -0.5
        ref = torch.softmax(s, dim=-1) @ v[0, 0, : i - 15]
        torch.testing.assert_close(pv[0, :, i] / l[0, :, i, None], ref, rtol=1e-5, atol=2e-6)
    assert torch.all(m[:, :, kept] > NEG_INF)


def test_rounding_switch_only_moves_bfloat16():
    qn, kn, vn = _inputs(1, 2, 2, 32, 64, 32, "float32", seed=4)
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    a = flash_block_stats_reference(q, k, v, 32, 0, round_like_kernel=True)
    b = flash_block_stats_reference(q, k, v, 32, 0, round_like_kernel=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    a = flash_block_stats_reference(qb, kb, vb, 32, 0, round_like_kernel=True)
    b = flash_block_stats_reference(qb, kb, vb, 32, 0, round_like_kernel=False)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])  # m, l: unrounded p
    assert not torch.equal(a[0], b[0])


@pytest.mark.parametrize("T,M,start", [(16, 64, 20), (32, 128, 96), (8, 128, 0)])
def test_cached_attention_multi_flash_matches_pallas_interpret(T, M, start):
    """The K3 route of cached_attention_multi (MHA, as the reference gates
    it) against the reference's own, through the TPU kernel in interpret
    mode."""
    rng = np.random.default_rng(T + M)
    qn = rng.standard_normal((2, T, 4, 32)).astype(np.float32)
    kn, vn = (rng.standard_normal((2, M, 4, 32)).astype(np.float32) for _ in range(2))
    want = jax_multi_flash(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), start,
                           interpret=True)
    got = _cached_attention_multi_flash(*(torch.from_numpy(a) for a in (qn, kn, vn)), start)
    assert got.shape == (2, T, 4, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(_np32(got), _np32(want), atol=2e-5)


# (T, M, H, Hkv, start, window)
MULTI_CASES = [
    (16, 64, 4, 4, 20, 0),  # MHA behind a prefix
    (16, 64, 4, 2, 20, 0),  # GQA
    (8, 48, 6, 2, 0, 0),  # GQA, no prefix
    (16, 64, 4, 2, 30, 9),  # sliding window
    (1, 32, 4, 1, 17, 0),  # one query (a decode step), MQA
]


@pytest.mark.parametrize("case", MULTI_CASES, ids=str)
def test_cached_attention_multi_matches_jax(case):
    """Both the port's paths against the reference's einsum path: the
    einsum path (any window) and, with no window, the K3 route over the
    un-expanded cache, which the reference gates to MHA on the TPU."""
    T, M, H, Hkv, start, window = case
    rng = np.random.default_rng(sum(case))
    qn = rng.standard_normal((2, T, H, 32)).astype(np.float32)
    kn, vn = (rng.standard_normal((2, M, Hkv, 32)).astype(np.float32) for _ in range(2))
    want = jax_cached_attention_multi(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                                      start, window=window)
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    got = cached_attention_multi(q, k, v, start, window=window)
    np.testing.assert_allclose(_np32(got), _np32(want), atol=2e-5)
    if window == 0:
        np.testing.assert_allclose(
            _np32(_cached_attention_multi_flash(q, k, v, start)), _np32(want), atol=2e-5
        )


def test_block_stats_raises_off_cpu_and_cuda():
    q = torch.zeros(1, 1, 4, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_block_stats(q, q, q, 0, 0)
    with pytest.raises(ValueError, match="different devices"):
        flash_block_stats(torch.zeros(1, 1, 4, 32), q, q, 0, 0)
