"""Port parity for the decoder LM and the serving step functions.

Weights come from the JAX package's ``init_params`` and cross through
``bridge.params_from_jax``; the same numpy tokens go through the JAX
function and its port (CPU tensors: the plain paths).

Tolerances: float32 2e-5 absolute on logits and pool rows.  bfloat16:
2e-2 on attention-sized values (test_paged_kernel.py's); on LM logits
6e-2 absolute, because every matmul output and activation is rounded to
bfloat16 (relative step 2^-8) in an order the two frameworks do not
share, and two layers of that on unit-scale logits reach a few 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.models import serving as jserving
from elastic_gpu_scheduler_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    forward as jax_forward,
    init_params as jax_init_params,
)
from elastic_gpu_scheduler_tpu_torch.models import serving
from elastic_gpu_scheduler_tpu_torch.models.bridge import (
    params_from_jax,
    params_to_numpy,
    tensor_from_numpy,
)
from elastic_gpu_scheduler_tpu_torch.models.transformer import (
    TransformerConfig,
    forward,
    init_params,
)

# the suite runs in parallel worker processes: one intra-op thread keeps
# this file from crowding the workers that run beside it
torch.set_num_threads(1)

LOGIT_TOL = {"float32": 2e-5, "bfloat16": 6e-2}


def _cfgs(**kw):
    base = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128)
    base.update(kw)
    return JaxConfig(**base), TransformerConfig(**base)


def _weights(jcfg, seed=0):
    jp = jax_init_params(jax.random.key(seed), jcfg)
    return jp, jax.tree.map(np.asarray, jp)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_roundtrip_bit_exact(dtype):
    jcfg, _ = _cfgs(dtype=dtype)
    _, tree = _weights(jcfg)
    back = params_to_numpy(params_from_jax(tree, "cpu"))

    def walk(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                walk(a[k], b[k])
            return
        assert a.shape == b.shape
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(a.view(np.uint16), b)
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    walk(tree, back)


def test_port_init_params_matches_reference_layout():
    jcfg, cfg = _cfgs(dtype="bfloat16")
    _, tree = _weights(jcfg)
    ours = init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def walk(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                walk(a[k], b[k])
            return
        assert tuple(a.shape) == tuple(b.shape)
        assert str(b.dtype).removeprefix("torch.") == a.dtype.name

    walk(tree, ours)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 7])
def test_forward_matches_jax(dtype, window):
    jcfg, cfg = _cfgs(dtype=dtype, window_size=window)
    jp, tree = _weights(jcfg, seed=1)
    tokens = np.random.default_rng(0).integers(0, 97, (2, 21)).astype(np.int32)
    want = jax_forward(jp, jnp.asarray(tokens), jcfg)
    got = forward(params_from_jax(tree, "cpu"), torch.from_numpy(tokens), cfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 21, 97)
    np.testing.assert_allclose(_np32(got), _np32(want), atol=LOGIT_TOL[dtype])


def test_forward_rejects_unported_config():
    """``n_microbatches`` runs the plain path on one device now; int8
    weights on a mesh of more than one rank stay refused by name."""
    from elastic_gpu_scheduler_tpu_torch.parallel.mesh import MeshSpec, RankDevice, make_mesh

    _, cfg = _cfgs(n_microbatches=2, dtype="float32")
    two = make_mesh(MeshSpec(tensor=2), [RankDevice(0), RankDevice(1)])
    q8 = {"layers": {"wq": {"q8": None, "scale": None}}}
    with pytest.raises(NotImplementedError, match="int8 layer leaf 'wq'"):
        forward(q8, torch.zeros(1, 4, dtype=torch.int32), cfg, two)


def _pools(jcfg, cfg, n_pages, ps):
    jkv = jserving.make_kv_pool(jcfg, n_pages, ps, False)
    return jkv, serving.make_kv_pool(cfg, n_pages, ps, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_prefill_then_decode_match_jax(dtype):
    """_paged_prefill (padded prompt, padding to scratch, last real row
    unembedded), then _paged_decode_step on the gather path and the
    paged-kernel path, against the JAX step functions on the same pool."""
    jcfg, cfg = _cfgs(dtype=dtype, window_size=0)
    jp, tree = _weights(jcfg, seed=2)
    params = params_from_jax(tree, "cpu")
    ps, n_pages, NB = 8, 12, 4
    jkv, kv = _pools(jcfg, cfg, n_pages, ps)
    rng = np.random.default_rng(1)
    pages = np.array([3, 7, 1, 9], np.int32)
    t_real = 11
    toks = np.zeros((1, 16), np.int32)
    toks[0, :t_real] = rng.integers(0, 97, t_real)
    want_l, jkv = jserving._paged_prefill(
        jp, jnp.asarray(toks), jkv, jnp.asarray(pages), jnp.asarray(t_real),
        cfg=jcfg, page_size=ps,
    )
    got_l, kv = serving._paged_prefill(
        params, torch.from_numpy(toks), kv, torch.from_numpy(pages), t_real,
        cfg=cfg, page_size=ps,
    )
    np.testing.assert_allclose(_np32(got_l), _np32(want_l), atol=LOGIT_TOL[dtype])
    # bfloat16 rows of layer 2 inherit layer 1's roundings: a relative
    # term of the same 2e-2 covers the few values a step or two apart
    kv_tol = dict(atol=2e-5) if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    for name in ("k", "v"):  # rows written to the real pages (not scratch)
        np.testing.assert_allclose(
            _np32(kv[name][:, 1:]), _np32(jkv[name][:, 1:]), **kv_tol
        )

    # two slots: the prefilled one at position t_real, one inactive on scratch
    tables = np.stack([pages, np.zeros(NB, np.int32)])
    lengths = np.array([t_real, 5], np.int32)
    tokens = np.array([int(rng.integers(0, 97)), 4], np.int32)
    for paged_kernel in (False, True):
        jkv2 = jax.tree.map(lambda x: x.copy(), jkv)
        kv2 = {k: v.clone() for k, v in kv.items()}
        want, _ = jserving._paged_decode_step(
            jp, jnp.asarray(tokens), jkv2, jnp.asarray(tables), jnp.asarray(lengths),
            jcfg, ps, paged_kernel=paged_kernel,
        )
        got, _ = serving._paged_decode_step(
            params, torch.from_numpy(tokens), kv2, torch.from_numpy(tables),
            torch.from_numpy(lengths), cfg, ps, paged_kernel=paged_kernel,
        )
        np.testing.assert_allclose(
            _np32(got[0]), _np32(want[0]), atol=LOGIT_TOL[dtype],
            err_msg=f"paged_kernel={paged_kernel}",
        )


def test_decode_step_window_gqa_matches_jax():
    jcfg, cfg = _cfgs(dtype="float32", window_size=6, n_heads=6, n_kv_heads=2, d_model=96)
    jp, tree = _weights(jcfg, seed=3)
    params = params_from_jax(tree, "cpu")
    ps, n_pages = 4, 10
    rng = np.random.default_rng(2)
    kv_np = {
        k: rng.standard_normal((2, n_pages, ps, 2, 16)).astype(np.float32)
        for k in ("k", "v")
    }
    tables = np.array([[2, 5, 7, 1], [9, 3, 0, 0]], np.int32)
    lengths = np.array([13, 5], np.int32)
    tokens = np.array([8, 60], np.int32)
    for paged_kernel in (False, True):
        jkv = {k: jnp.asarray(v) for k, v in kv_np.items()}
        kv = {k: tensor_from_numpy(v, "cpu") for k, v in kv_np.items()}
        want, _ = jserving._paged_decode_step(
            jp, jnp.asarray(tokens), jkv, jnp.asarray(tables), jnp.asarray(lengths),
            jcfg, ps, paged_kernel=paged_kernel,
        )
        got, _ = serving._paged_decode_step(
            params, torch.from_numpy(tokens), kv, torch.from_numpy(tables),
            torch.from_numpy(lengths), cfg, ps, paged_kernel=paged_kernel,
        )
        np.testing.assert_allclose(_np32(got), _np32(want), atol=2e-5)
