"""Port parity for ``models/generate.py``: the KV cache, the multi-token
cached forward, prefill, the decode loop and ``generate``.

Weights come from the JAX package's ``init_params`` through
``bridge.params_from_jax``; the same numpy tokens go through the JAX
function and its port (CPU tensors: the einsum attention path, as the
reference takes off a TPU).  Float32 throughout.

Tolerances: logits and cache rows 2e-5 absolute (float32, unit-scale
logits, two layers); greedy tokens identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.models import generate as jgen
from elastic_gpu_scheduler_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    init_params as jax_init_params,
)
from elastic_gpu_scheduler_tpu_torch.models import generate as gen
from elastic_gpu_scheduler_tpu_torch.models.bridge import params_from_jax
from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig

# the suite runs in parallel worker processes: one intra-op thread keeps
# this file from crowding the workers that run beside it
torch.set_num_threads(1)

TOL = 2e-5


def _model(seed=0, **kw):
    base = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
                dtype="float32")
    base.update(kw)
    jcfg = JaxConfig(**base)
    jp = jax_init_params(jax.random.key(seed), jcfg)
    return jcfg, jp, TransformerConfig(**base), params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 97, shape).astype(np.int32)


def test_kv_cache_empty_matches_reference_layout():
    jcfg, _, cfg, _ = _model()
    want = jgen.KVCache.empty(jcfg, 3, 40)
    got = gen.KVCache.empty(cfg, 3, 40, device="cpu")
    assert tuple(got.k.shape) == want.k.shape == (2, 3, 40, 2, 16)
    assert got.v.shape == got.k.shape and got.length == int(want.length) == 0
    assert got.k.dtype == torch.float32 and not got.k.any()


@pytest.mark.parametrize("window", [0, 6])
def test_forward_cached_matches_jax(window):
    """Two passes (a prompt, then a 5-token block behind it): logits and
    every written cache row equal the reference's."""
    jcfg, jp, cfg, params = _model(seed=1, window_size=window)
    toks = _tokens((2, 11), seed=1)
    jc = jgen.KVCache.empty(jcfg, 2, 24)
    pc = gen.KVCache.empty(cfg, 2, 24, device="cpu")
    for a, b in ((0, 6), (6, 11)):
        want, jc = jgen.forward_cached(jp, jnp.asarray(toks[:, a:b]), jc, jcfg)
        got, pc = gen.forward_cached(params, torch.from_numpy(toks[:, a:b]), pc, cfg)
        assert got.dtype == torch.float32 and tuple(got.shape) == (2, b - a, 97)
        np.testing.assert_allclose(_np32(got), _np32(want), atol=TOL)
        assert pc.length == int(jc.length) == b
    np.testing.assert_allclose(_np32(pc.k[:, :, :11]), _np32(jc.k[:, :, :11]), atol=TOL)
    np.testing.assert_allclose(_np32(pc.v[:, :, :11]), _np32(jc.v[:, :, :11]), atol=TOL)


def test_prefill_matches_jax_and_sequential():
    jcfg, jp, cfg, params = _model(seed=2)
    toks = _tokens((2, 21), seed=2)
    want, jc = jgen.prefill(jp, jnp.asarray(toks), jgen.KVCache.empty(jcfg, 2, 32), jcfg,
                            chunk=8)
    got, pc = gen.prefill(params, torch.from_numpy(toks), gen.KVCache.empty(cfg, 2, 32, "cpu"),
                          cfg, chunk=8)
    np.testing.assert_allclose(_np32(got), _np32(want), atol=TOL)
    np.testing.assert_allclose(_np32(pc.k[:, :, :21]), _np32(jc.k[:, :, :21]), atol=TOL)
    seq, sc = gen.prefill_sequential(params, torch.from_numpy(toks),
                                     gen.KVCache.empty(cfg, 2, 32, "cpu"), cfg)
    assert sc.length == pc.length == 21
    np.testing.assert_allclose(_np32(seq), _np32(got), atol=TOL)
    np.testing.assert_allclose(_np32(sc.v), _np32(pc.v), atol=TOL)


def test_decode_loop_greedy_tokens_match_jax():
    jcfg, jp, cfg, params = _model(seed=3)
    toks = _tokens((3, 7), seed=3)
    jl, jc = jgen.prefill(jp, jnp.asarray(toks), jgen.KVCache.empty(jcfg, 3, 24), jcfg)
    want, want_logits, jc = jgen.decode_loop(jp, jl, jc, jcfg, 12)
    pl_, pc = gen.prefill(params, torch.from_numpy(toks), gen.KVCache.empty(cfg, 3, 24, "cpu"),
                          cfg)
    got, got_logits, pc = gen.decode_loop(params, pl_, pc, cfg, 12)
    assert got.shape == (3, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(_np32(got_logits), _np32(want_logits), atol=TOL)
    assert pc.length == int(jc.length) == 19


@pytest.mark.parametrize("kw", [dict(), dict(window_size=5), dict(n_kv_heads=1)], ids=str)
def test_generate_greedy_matches_jax(kw):
    jcfg, jp, cfg, params = _model(seed=4, **kw)
    prompt = _tokens((2, 9), seed=4)
    want = np.asarray(jgen.generate(jp, jnp.asarray(prompt), jcfg, 10))
    got = gen.generate(params, torch.from_numpy(prompt), cfg, 10)
    assert got.dtype == torch.int32 and got.shape == (2, 19)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_eos_fills_after_first_eos_like_jax():
    jcfg, jp, cfg, params = _model(seed=5)
    prompt = _tokens((2, 6), seed=5)
    free = gen.generate(params, torch.from_numpy(prompt), cfg, 10).numpy()
    eos = int(free[0, 6 + 3])  # row 0's fourth new token
    want = np.asarray(jgen.generate(jp, jnp.asarray(prompt), jcfg, 10, eos_id=eos))
    got = gen.generate(params, torch.from_numpy(prompt), cfg, 10, eos_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(got[0, 6 + 3:] == eos)


def test_sampled_generate_runs_and_respects_top_k():
    """Sampled tokens come from torch.Generator bits (not jax.random's):
    the draw must stay inside the top-k set of each step's logits."""
    _, _, cfg, params = _model(seed=6)
    prompt = torch.from_numpy(_tokens((2, 5), seed=6))
    g = torch.Generator().manual_seed(0)
    out = gen.generate(params, prompt, cfg, 6, temperature=0.9, generator=g, top_k=1)
    greedy = gen.generate(params, prompt, cfg, 6)
    assert torch.equal(out, greedy)  # top_k=1 keeps only the argmax


def test_forward_cached_refuses_cache_overflow():
    _, _, cfg, params = _model()
    cache = gen.KVCache.empty(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="overflow"):
        gen.forward_cached(params, torch.zeros(1, 9, dtype=torch.int32), cache, cfg)
