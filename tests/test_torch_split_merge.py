"""The fold of split partials, on the CPU: the plain version of the merge
kernels of K3 (``flash_stats_kernel_combine``) and K2
(``paged_attn_combine_kernel``).

K3: the keys are cut at tile edges and mid-diagonal (a run may hold no
key some row keeps, or none any row keeps); each run goes through the
port's ``flash_block_stats_reference`` with ``k_offset`` moved to its first
key, ``merge_block_stats`` folds the runs in order, and the result is held
against the unsplit plain version and the JAX package's
``flash_block_stats`` (its Pallas kernel in interpret mode) on the same
numpy inputs.  Rows that keep no key must end with m = NEG_INF and l = Sk
exactly, however the keys were cut.

K2: ``paged_attention_split_reference`` (runs of table pages, each a
partial, folded in order) against the JAX package's
``paged_attention_reference`` and the port's, over dense and int8 pools,
with runs past a row's live pages, lengths 0 and NB * ps - W, and NB not a
multiple of the run.

Tolerances: float32 1e-5 (pv in units of the row's l, m absolute, l
relative: one more rescale of sums that are otherwise the same); bfloat16
``block_stats_tolerance_used``, the K3 kernel's own (p rounds at its run's
running max, as in the kernel); K2 outputs as tests/test_torch_paged_attention.py
holds them (float32 2e-5, bfloat16 2e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.ops.attention import flash_block_stats as jax_block_stats
from elastic_gpu_scheduler_tpu.ops.paged_attention import (
    paged_attention_reference as jax_paged_reference,
)
from elastic_gpu_scheduler_tpu_torch.models.bridge import tensor_from_numpy
from elastic_gpu_scheduler_tpu_torch.models.serving import _quantize_rows
from elastic_gpu_scheduler_tpu_torch.ops.attention import (
    NEG_INF,
    block_stats_tolerance_used,
    flash_block_stats_reference,
    merge_block_stats,
)
from elastic_gpu_scheduler_tpu_torch.ops.paged_attention import (
    paged_attention_reference,
    paged_attention_split_reference,
)

# the suite runs in parallel worker processes: one intra-op thread keeps
# this file from crowding the workers that run beside it
torch.set_num_threads(1)

F32_TOL = 1e-5

# (B, H, Hkv, Sq, Sk, D, q_offset, k_offset, causal, cuts): Sq and Sk
# multiples of the 32-row blocks the TPU kernel runs with here; cuts are
# the key indices where a run ends and the next begins
K3_SPLITS = [
    (1, 4, 2, 32, 128, 32, 32, 0, True, (64,)),  # a tile edge; the last run keeps no key
    (1, 4, 2, 32, 128, 32, 32, 0, True, (40, 64, 96)),  # mid-diagonal, then two empty runs
    (1, 2, 2, 64, 128, 32, 64, 0, True, (70, 100)),  # a cut inside every row's diagonal
    (1, 2, 1, 64, 128, 64, 0, 40, True, (16, 64)),  # rows 0..39 keep no key, in any run
    (1, 2, 2, 32, 96, 32, 0, 200, True, (32, 33, 64)),  # no row keeps a key; a 1-key run
    (2, 4, 1, 64, 128, 32, 70, 8, True, (64,)),  # MQA, both offsets
    (1, 2, 2, 32, 96, 32, 5, 3, False, (10, 50)),  # not causal
]


def _k3_inputs(B, H, Hkv, Sq, Sk, D, dtype, seed):
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


def _split_and_merge(q, k, v, q_off, k_off, causal, cuts):
    edges = [0, *cuts, k.shape[2]]
    parts = [flash_block_stats_reference(q, k[:, :, a:b], v[:, :, a:b], q_off, k_off + a,
                                         causal)
             for a, b in zip(edges[:-1], edges[1:])]
    return merge_block_stats(parts)


def _assert_f32_close(got, want):
    pv, m, l = (_np32(t) for t in got)
    wpv, wm, wl = (_np32(t) for t in want)
    np.testing.assert_allclose(m, wm, atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(l, wl, rtol=F32_TOL, atol=0)
    assert np.all(np.abs(pv - wpv) <= F32_TOL * wl[..., None]), (
        float(np.max(np.abs(pv - wpv) / wl[..., None]))
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", K3_SPLITS, ids=str)
def test_block_stats_split_merge_matches_unsplit_and_pallas(case, dtype):
    B, H, Hkv, Sq, Sk, D, q_off, k_off, causal, cuts = case
    qn, kn, vn = _k3_inputs(B, H, Hkv, Sq, Sk, D, dtype, seed=sum(cuts))
    q, k, v = (tensor_from_numpy(a, "cpu") for a in (qn, kn, vn))
    merged = _split_and_merge(q, k, v, q_off, k_off, causal, cuts)
    whole = flash_block_stats_reference(q, k, v, q_off, k_off, causal)
    n_rep = H // Hkv
    pallas = jax_block_stats(
        jnp.asarray(qn), jnp.repeat(jnp.asarray(kn), n_rep, axis=1),
        jnp.repeat(jnp.asarray(vn), n_rep, axis=1), q_off, k_off, causal=causal,
        block_q=32, block_k=32, interpret=True,
    )
    if dtype == "float32":
        _assert_f32_close(merged, whole)
        _assert_f32_close(merged, pallas)
    else:
        shares = block_stats_tolerance_used(merged, whole, torch.bfloat16)
        assert max(shares.values()) <= 1.0, shares
        shares = block_stats_tolerance_used(
            merged, [torch.from_numpy(_np32(t).copy()) for t in pallas], torch.bfloat16)
        assert max(shares.values()) <= 1.0, shares
    if causal and q_off < k_off:  # rows that keep no key, however the keys were cut
        empty = slice(0, min(Sq, k_off - q_off))
        assert torch.all(merged[1][:, :, empty] == NEG_INF)
        assert torch.all(merged[2][:, :, empty] == Sk)


def test_merge_of_one_part_is_the_part():
    qn, kn, vn = _k3_inputs(1, 2, 1, 32, 64, 32, "float32", seed=1)
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    part = flash_block_stats_reference(q, k, v, 0, 16)
    for x, y in zip(merge_block_stats([part]), part):
        assert torch.equal(x, y)


def test_empty_run_is_neutral():
    """A run that keeps no key for a row that keeps some elsewhere (the
    K2 partial m = NEG_INF, l = 0, acc = 0) leaves the fold unchanged."""
    qn, kn, vn = _k3_inputs(1, 2, 2, 32, 64, 32, "float32", seed=2)
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    part = flash_block_stats_reference(q, k, v, 32, 0)
    empty = (torch.zeros_like(part[0]), torch.full_like(part[1], NEG_INF),
             torch.zeros_like(part[2]))
    for got in (merge_block_stats([part, empty]), merge_block_stats([empty, part])):
        for x, y in zip(got, part):
            assert torch.equal(x, y)


def _paged_inputs(B, W, Hn, Hkv, Dh, ps, NP, NB, dtype, lengths, int8, seed):
    rng = np.random.default_rng(seed)
    qshape = (B, Hn, Dh) if W == 0 else (B, W, Hn, Dh)
    q = rng.standard_normal(qshape).astype(np.float32)
    if dtype == "bfloat16":
        q = np.asarray(jnp.asarray(q, jnp.bfloat16))
    pools, scales = [], []
    for _ in range(2):
        rows = rng.standard_normal((NP * ps, Hkv, Dh)).astype(np.float32)
        if int8:
            q8, sc = _quantize_rows(torch.from_numpy(rows))
            pools.append(q8.numpy().reshape(NP, ps, Hkv, Dh))
            scales.append(sc.numpy().reshape(NP, ps, Hkv))
        else:
            if dtype == "bfloat16":
                rows = np.asarray(jnp.asarray(rows, jnp.bfloat16))
            pools.append(rows.reshape(NP, ps, Hkv, Dh))
    tables = rng.integers(1, NP, (B, NB)).astype(np.int32)
    return q, pools, scales, tables, np.asarray(lengths, np.int32)


# (W, window, pages_per_split, lengths); B 4, NB 6, page 16.  Row 0 (length
# 0) and row 1 (length 5) leave every run but the first past their live
# pages; NB 6 is no multiple of runs of 4
K2_SPLITS = [
    (1, 0, 1, [0, 5, 16, 95]),
    (1, 0, 4, [0, 5, 63, 95]),
    (4, 0, 2, [0, 5, 31, 92]),
    (4, 20, 4, [0, 5, 64, 92]),
    (1, 20, 6, [0, 5, 40, 95]),
    (4, 0, 3, [0, 15, 47, 92]),  # a verify window across a run's last page
]


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8-float32", "int8-bfloat16"])
@pytest.mark.parametrize("case", K2_SPLITS, ids=str)
def test_paged_split_merge_matches_jax(case, pool):
    W, window, pps, lengths = case
    int8 = pool.startswith("int8")
    dtype = pool.split("-")[-1]
    Hn, Hkv, Dh, ps, NP, NB = 8, 4, 32, 16, 20, 6
    q, pools, scales, tables, ln = _paged_inputs(4, W, Hn, Hkv, Dh, ps, NP, NB, dtype, lengths,
                                                 int8, seed=pps + W)
    kw_j = dict(window=window)
    if int8:
        kw_j.update(scales_k=jnp.asarray(scales[0]), scales_v=jnp.asarray(scales[1]))
    want = jax_paged_reference(jnp.asarray(q), *(jnp.asarray(p) for p in pools),
                               jnp.asarray(tables), jnp.asarray(ln), **kw_j)
    tq = tensor_from_numpy(q, "cpu")
    args = (tq, *(tensor_from_numpy(p, "cpu") for p in pools), torch.from_numpy(tables),
            torch.from_numpy(ln))
    kw = dict(window=window)
    if int8:
        kw.update(scales_k=torch.from_numpy(scales[0]), scales_v=torch.from_numpy(scales[1]))
    got = paged_attention_split_reference(*args, pps, **kw)
    plain = paged_attention_reference(*args, **kw)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np32(got), _np32(want), atol=tol)
    np.testing.assert_allclose(_np32(got), _np32(plain), atol=tol)
