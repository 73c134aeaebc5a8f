"""Port parity for the int8 KV pool: row quantisation, pool writes and
gathers, paged attention over an int8 pool (K2's int8 half), the memory
estimate, and the int8 engine.

The same numpy inputs go through the JAX package's function and the
port's (CPU tensors: the plain paths).  Tolerances: ``_quantize_rows``,
the pool's rows and scales, ``estimate_hbm_bytes`` and the engines'
greedy tokens (float32) are held to bit equality; attention outputs to
2e-5 (float32) and 2e-2 (bfloat16, the K1/K2 tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.models import serving as jserving
from elastic_gpu_scheduler_tpu.models.transformer import TransformerConfig as JaxConfig
from elastic_gpu_scheduler_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention,
    paged_attention_reference as jax_paged_reference,
)
from elastic_gpu_scheduler_tpu_torch.models import serving
from elastic_gpu_scheduler_tpu_torch.models.bridge import tensor_from_numpy
from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig
from elastic_gpu_scheduler_tpu_torch.ops.paged_attention import paged_attention

from test_torch_engine import (  # noqa: F401  (the autouse fixture)
    CFG,
    PROMPTS,
    _jax_tokens,
    _port_tokens,
    reference_engine_copies_uploads,
    weights,
)

# the suite runs in parallel worker processes: one intra-op thread keeps
# this file from crowding the workers that run beside it
torch.set_num_threads(1)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rows(seed=0, dtype="float32"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((40, 3, 16)).astype(np.float32) * 3.0
    x[0] = 0.0  # all-zero rows: the 1e-8 floor
    x[1, 0] = np.linspace(-127, 127, 16)  # exact .5 ties after the division
    x[2, 1, 0] = 1e6  # one large value squeezes the rest of its row
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bit_identical(dtype):
    x = _rows(dtype=dtype)
    wq, ws = jserving._quantize_rows(jnp.asarray(x))
    gq, gs = serving._quantize_rows(tensor_from_numpy(x, "cpu"))
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy().view(np.uint32), np.asarray(ws).view(np.uint32))


def test_int8_pool_writes_and_gathers_like_jax():
    jcfg = JaxConfig(**CFG)
    cfg = TransformerConfig(**CFG)
    jkv = jserving.make_kv_pool(jcfg, 6, 4, True)
    kv = serving.make_kv_pool(cfg, 6, 4, "cpu", int8=True)
    assert {k: (tuple(v.shape), v.dtype) for k, v in kv.items()} == {
        "k": ((2, 6, 4, 2, 16), torch.int8), "v": ((2, 6, 4, 2, 16), torch.int8),
        "ks": ((2, 6, 4, 2), torch.float32), "vs": ((2, 6, 4, 2), torch.float32),
    }
    rng = np.random.default_rng(1)
    k_rows, v_rows = (rng.standard_normal((5, 2, 16)).astype(np.float32) for _ in range(2))
    pidx = np.array([1, 1, 3, 5, 2], np.int32)
    off = np.array([0, 3, 1, 2, 2], np.int32)
    jl = jserving._kv_write_rows(
        {k: v[1] for k, v in jkv.items()}, jnp.asarray(pidx), jnp.asarray(off),
        jnp.asarray(k_rows), jnp.asarray(v_rows),
    )
    pl_ = serving._kv_write_rows(
        serving._layer_kv(kv, 1), torch.from_numpy(pidx), torch.from_numpy(off),
        torch.from_numpy(k_rows), torch.from_numpy(v_rows),
    )
    for name in ("k", "v", "ks", "vs"):
        np.testing.assert_array_equal(pl_[name].numpy(), np.asarray(jl[name]))
        assert pl_[name].data_ptr() == kv[name][1].data_ptr()  # written in place
    tables = np.array([[1, 3], [5, 2]], np.int32)
    for dtype in (jnp.float32, jnp.bfloat16):
        wk, wv = jserving._kv_gather(jl, jnp.asarray(tables), 4, dtype)
        gk, gv = serving._kv_gather(pl_, torch.from_numpy(tables), 4,
                                    getattr(torch, jnp.dtype(dtype).name))
        np.testing.assert_array_equal(_np32(gk), _np32(wk))
        np.testing.assert_array_equal(_np32(gv), _np32(wv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("W", [0, 3])
def test_paged_attention_int8_matches_jax_reference_and_pallas(dtype, W):
    """The plain int8 K2 (the CPU wrapper) against the reference's gather
    oracle and its Pallas kernel in interpret mode (quantized=True)."""
    rng = np.random.default_rng(7)
    B, Hn, Hkv, Dh, ps, NP, NB = 3, 4, 2, 32, 8, 9, 3
    qshape = (B, Hn, Dh) if W == 0 else (B, W, Hn, Dh)
    q = rng.standard_normal(qshape).astype(np.float32)
    pk, pv = (rng.integers(-127, 128, (NP, ps, Hkv, Dh)).astype(np.int8) for _ in range(2))
    sk, sv = (rng.uniform(0.001, 0.05, (NP, ps, Hkv)).astype(np.float32) for _ in range(2))
    tables = rng.integers(1, NP, (B, NB)).astype(np.int32)
    lengths = np.array([0, 9, NB * ps - max(W, 1)], np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq = jnp.asarray(q, jdt)
    args = [jnp.asarray(a) for a in (pk, pv, tables, lengths)]
    kw = dict(scales_k=jnp.asarray(sk), scales_v=jnp.asarray(sv))
    want = jax_paged_reference(jq, args[0], args[1], args[2], args[3], **kw)
    want_k = jax_paged_attention(jq, *args, **kw, interpret=True)
    got = paged_attention(
        tensor_from_numpy(np.asarray(jq), "cpu"), *(torch.from_numpy(a) for a in
                                                    (pk, pv, tables, lengths)),
        scales_k=torch.from_numpy(sk), scales_v=torch.from_numpy(sv),
    )
    tol = 2e-5 if dtype == "float32" else 2e-2
    assert got.shape == qshape
    np.testing.assert_allclose(_np32(got), _np32(want), atol=tol)
    np.testing.assert_allclose(_np32(got), _np32(want_k), atol=tol)


def test_int8_dequant_rounds_through_bf16_like_jax():
    """Inputs on which rounding the dequantised K/V through bf16 moves the
    output by 5-8x the bf16 tolerance (``chip_smoke.py`` holds K2-int8 to
    them on the card): the port's plain version agrees with the JAX
    reference and its Pallas kernel, and the unrounded result does not."""
    Hn, Hkv, Dh, ps = 16, 8, 128, 16
    pk = np.zeros((3, ps, Hkv, Dh), np.int8)
    pv = np.zeros_like(pk)
    sk = np.ones((3, ps, Hkv), np.float32)
    sv = np.ones((3, ps, Hkv), np.float32)
    pk[1, :2], pv[1:, 0], pv[1:, 1] = 127, 127, -127
    sk[1, 0], sk[1, 1], sv[1, :2] = 1.0035 / 127, 1 / 127, 1 / 127
    sv[2, 0], sv[2, 1] = 100.2 / 127, 100 / 127
    q = np.full((2, Hn, Dh), 8.0, np.float32)
    tables, lengths = np.array([[1], [2]], np.int32), np.ones(2, np.int32)
    jargs = [jnp.asarray(q, jnp.bfloat16)] + [jnp.asarray(a) for a in (pk, pv, tables, lengths)]
    jkw = dict(scales_k=jnp.asarray(sk), scales_v=jnp.asarray(sv))
    targs = [tensor_from_numpy(q, "cpu").bfloat16()] + [
        torch.from_numpy(a) for a in (pk, pv, tables, lengths)]
    tkw = dict(scales_k=torch.from_numpy(sk), scales_v=torch.from_numpy(sv))
    got = paged_attention(*targs, **tkw)
    unrounded = paged_attention(targs[0].float(), *targs[1:], **tkw)
    for want in (jax_paged_reference(*jargs, **jkw),
                 jax_paged_attention(*jargs, **jkw, interpret=True)):
        np.testing.assert_allclose(_np32(got), _np32(want), atol=2e-2)
        assert np.abs(_np32(unrounded) - _np32(want)).max() > 5 * 2e-2


@pytest.mark.parametrize("kv_int8", [False, True])
def test_estimate_hbm_bytes_equals_reference(kv_int8):
    big = dict(vocab_size=32000, d_model=2048, n_layers=16, n_heads=16, n_kv_heads=8,
               d_ff=6912, dtype="bfloat16")
    for kw in (dict(), dict(n_pages=300)):
        want = jserving.estimate_hbm_bytes(JaxConfig(**big), 8, 1024, 16, kv_int8=kv_int8, **kw)
        got = serving.estimate_hbm_bytes(
            TransformerConfig(**big), 8, 1024, 16, kv_int8=kv_int8, **kw)
        assert got == want
    assert serving._cfg_param_count(TransformerConfig(**big)) == jserving._cfg_param_count(
        JaxConfig(**big))


@pytest.mark.parametrize("paged_kernel", [False, True])
def test_int8_engine_greedy_tokens_match_jax(weights, paged_kernel):
    jcfg, jp, params = weights
    kw = dict(max_batch=4, max_len=64, page_size=8, fused_steps=4, kv_int8=True,
              paged_kernel=paged_kernel)
    new = [8, 6, 8, 9, 5, 7]
    want = _jax_tokens(jcfg, jp, PROMPTS, new, **kw)
    got, eng = _port_tokens(params, PROMPTS, new, **kw)
    assert got == want
    assert eng.kv["k"].dtype == torch.int8 and "ks" in eng.kv


def test_int8_engine_kernel_and_gather_paths_agree(weights):
    """The plain int8 paged path and the gather path dequantise alike, so
    their greedy tokens are identical (on the card, K2-int8 is held to
    the same in chip_smoke.py)."""
    _, _, params = weights
    kw = dict(max_batch=2, max_len=64, page_size=8, fused_steps=4, kv_int8=True)
    a, _ = _port_tokens(params, PROMPTS, [10] * 6, paged_kernel=False, **kw)
    b, _ = _port_tokens(params, PROMPTS, [10] * 6, paged_kernel=True, **kw)
    assert a == b
