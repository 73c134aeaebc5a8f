"""Port parity for LoRA fine-tuning (``models/lora.py`` and the adapter
term of ``transformer._proj``).

The JAX package's weights and adapters cross through
``bridge.params_from_jax`` / ``bridge.lora_from_jax``; the same numpy
tokens go through the reference's functions and the port's (CPU tensors:
the plain paths).  The model is the float32 one of ``tests/test_lora.py``.

Tolerances: merged and injected trees 1e-6 absolute (the same fp32
products in another order); the loss and its adapter gradients 1e-5
absolute; three train steps 1e-5 absolute on losses and adapter leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.models import lora as jlora
from elastic_gpu_scheduler_tpu.models.train import make_optimizer as jax_make_optimizer
from elastic_gpu_scheduler_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    init_params as jax_init_params,
)
from elastic_gpu_scheduler_tpu_torch.models import lora
from elastic_gpu_scheduler_tpu_torch.models.bridge import (
    lora_from_jax,
    lora_to_numpy,
    params_from_jax,
)
from elastic_gpu_scheduler_tpu_torch.models.train import make_optimizer
from elastic_gpu_scheduler_tpu_torch.models.transformer import (
    TransformerConfig,
    forward,
    init_params,
    param_count,
)

torch.set_num_threads(1)

CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64, dtype="float32")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _weights(cfg_kw=CFG, seed=0):
    jcfg = JaxConfig(**cfg_kw)
    jp = jax_init_params(jax.random.key(seed), jcfg)
    return jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _jax_lora(jp, rank=4, targets=jlora.DEFAULT_TARGETS, b_scale=0.02, seed=1):
    """The reference's adapters with B drawn non-zero (a trained look)."""
    lo = jlora.lora_init(jax.random.key(seed), jp, rank=rank, targets=targets)
    for n, (t, ab) in enumerate(lo["adapters"].items()):
        lo["adapters"][t]["b"] = jax.random.normal(jax.random.key(seed + 7 + n),
                                                   ab["b"].shape) * b_scale
    return lo


def _both_loras(jp, **kw):
    jl = _jax_lora(jp, **kw)
    return jl, lora_from_jax(jax.tree.map(np.asarray, jl), "cpu")


def _tokens(shape=(2, 17), seed=3):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], shape).astype(np.int32)


@pytest.mark.parametrize("targets", [jlora.DEFAULT_TARGETS, jlora.ALL_TARGETS])
def test_merge_and_inject_match_reference(targets):
    _, jp, params = _weights()
    jl, pl = _both_loras(jp, targets=targets)
    merged_j, merged_p = jlora.merge_lora(jp, jl), lora.merge_lora(params, pl)
    inj_j, inj_p = jlora.inject_lora(jp, jl), lora.inject_lora(params, pl)
    for t in targets:
        np.testing.assert_allclose(_np(merged_p["layers"][t]), _np(merged_j["layers"][t]),
                                   atol=1e-6, rtol=0)
        for n in ("a", "b"):
            np.testing.assert_allclose(_np(inj_p["layers"][t + "_lora"][n]),
                                       _np(inj_j["layers"][t + "_lora"][n]), atol=1e-6, rtol=0)
    assert sorted(inj_p["layers"]) == sorted(inj_j["layers"])
    # the bridge's way back is the reference's tree
    back = lora_to_numpy(pl)
    assert back["alpha"] == jl["alpha"] and back["rank"] == jl["rank"]
    for a, b in zip(_leaves(back["adapters"]), _leaves(jl["adapters"])):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("variant", ["dense", "remat_xent"])
def test_loss_and_adapter_grads_match_reference(variant):
    kw = dict(CFG, remat=True, xent_chunks=2) if variant == "remat_xent" else CFG
    jcfg, jp, params = _weights(kw)
    jl, pl = _both_loras(jp, targets=jlora.ALL_TARGETS)
    toks = _tokens()

    def jloss(adapters):
        return jlora.lora_loss_fn({**jl, "adapters": adapters}, jp, jnp.asarray(toks), jcfg)

    want_loss, want_g = jax.value_and_grad(jloss)(jl["adapters"])
    leaves = _leaves(pl["adapters"])
    for p in leaves:
        p.requires_grad_(True)
    cfg = TransformerConfig(**kw)
    loss = lora.lora_loss_fn(pl, params, torch.from_numpy(toks), cfg)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(want_loss)) < 1e-5
    for g, w in zip(grads, _leaves(want_g)):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-5, rtol=0)
    assert all(float(g.abs().max()) > 0 for g in grads)


@pytest.mark.parametrize("opt_kw", [dict(lr=1e-2, weight_decay=0.01),
                                    dict(lr=1e-2, weight_decay=0.0, grad_clip=0.5,
                                         warmup_steps=1, total_steps=4)])
def test_three_train_steps_match_reference(opt_kw):
    jcfg, jp, params = _weights()
    jl, pl = _both_loras(jp, targets=("wq", "wk", "wv", "w_out"))
    toks = _tokens((4, 17))
    jopt = jax_make_optimizer(**opt_kw)
    jstate = jopt.init(jl["adapters"])
    jstep = jlora.make_lora_train_step(jcfg, jopt)
    popt = make_optimizer(**opt_kw)
    pstate = popt.init(pl["adapters"])
    pstep = lora.make_lora_train_step(TransformerConfig(**CFG), popt)
    base = {k: v.clone() for k, v in params["layers"].items()}
    for _ in range(3):
        jl, jstate, jloss = jstep(jl, jstate, jp, jnp.asarray(toks))
        pl, pstate, ploss = pstep(pl, pstate, params, torch.from_numpy(toks))
        assert abs(float(ploss) - float(jloss)) < 1e-5
    for a, b in zip(_leaves(pl["adapters"]), _leaves(jl["adapters"])):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5, rtol=0)
    for k, v in params["layers"].items():
        assert v.grad is None and torch.equal(v, base[k])


def test_zero_init_is_identity():
    cfg = TransformerConfig(**CFG)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lo = lora.lora_init(params, rank=4, generator=torch.Generator().manual_seed(1))
    for t, ab in lo["adapters"].items():
        L, d_in, d_out = params["layers"][t].shape
        assert ab["a"].shape == (L, d_in, 4) and ab["a"].dtype == torch.float32
        assert ab["b"].shape == (L, 4, d_out) and not ab["b"].any()
        assert abs(float(ab["a"].std()) - d_in ** -0.5) < 0.5 * d_in ** -0.5
    assert lo["alpha"] == 4.0 and lo["rank"] == 4
    toks = torch.from_numpy(_tokens((2, 16)))
    base = forward(params, toks, cfg)
    assert torch.allclose(forward(lora.merge_lora(params, lo), toks, cfg), base, atol=1e-6)
    assert torch.equal(forward(lora.inject_lora(params, lo), toks, cfg), base)


def test_adapter_size_is_tiny():
    params = init_params(TransformerConfig(**CFG), torch.Generator().manual_seed(0), "cpu")
    lo = lora.lora_init(params, rank=4, targets=("wq", "wv"),
                        generator=torch.Generator().manual_seed(1))
    expect = 0
    for t in ("wq", "wv"):
        L, d_in, d_out = params["layers"][t].shape
        expect += L * d_in * 4 + L * 4 * d_out
    assert lora.lora_param_count(lo) == expect
    assert lora.lora_param_count(lo) < 0.05 * param_count(params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_moves_loss_not_base(dtype):
    """The adapters train and the base keeps its bits, in float32 and on a
    bf16 base (the fp32-output base product and its backward)."""
    cfg = TransformerConfig(**dict(CFG, dtype=dtype))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for p in params["layers"].values():
        p.requires_grad_(True)  # a model fresh from training: still frozen here
    base = {k: v.detach().clone() for k, v in params["layers"].items()}
    lo = lora.lora_init(params, rank=8, generator=torch.Generator().manual_seed(1))
    opt = make_optimizer(lr=1e-2, weight_decay=0.0)
    state = opt.init(lo["adapters"])
    step = lora.make_lora_train_step(cfg, opt)
    toks = torch.from_numpy(_tokens((4, 33)))
    losses = []
    for _ in range(20):
        lo, state, loss = step(lo, state, params, toks)
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 0.2, losses
    for k, v in params["layers"].items():
        assert v.grad is None and torch.equal(v.detach(), base[k]), k
    t2 = toks[:, :-1]
    with torch.no_grad():
        assert not torch.allclose(forward(params, t2, cfg),
                                  forward(lora.merge_lora(params, lo), t2, cfg))


def test_injected_matches_merged_f32():
    """In float32 the activation-domain and merged views agree to rounding."""
    _, jp, params = _weights()
    _, pl = _both_loras(jp, targets=jlora.ALL_TARGETS)
    cfg = TransformerConfig(**CFG)
    toks = torch.from_numpy(_tokens((2, 16)))
    merged = forward(lora.merge_lora(params, pl), toks, cfg)
    injected = forward(lora.inject_lora(params, pl), toks, cfg)
    torch.testing.assert_close(merged, injected, atol=2e-4, rtol=2e-4)


def test_sub_ulp_adapter_survives_bf16_base():
    """An adapter term far below a bf16 base weight's ulp still moves the
    forward through the injected view, and the forward equals the
    reference's on the same weights."""
    kw = dict(CFG, dtype="bfloat16")
    jcfg, jp, params = _weights(kw)
    jl = jlora.lora_init(jax.random.key(1), jp, rank=4)
    for t, ab in jl["adapters"].items():
        jl["adapters"][t]["b"] = jnp.ones_like(ab["b"]) * 3e-5
    pl = lora_from_jax(jax.tree.map(np.asarray, jl), "cpu")
    cfg = TransformerConfig(**kw)
    toks = _tokens((2, 16))
    base = forward(params, torch.from_numpy(toks), cfg)
    injected = forward(lora.inject_lora(params, pl), torch.from_numpy(toks), cfg)
    assert not torch.allclose(base, injected)
    from elastic_gpu_scheduler_tpu.models.transformer import forward as jforward

    want = np.asarray(jforward(jlora.inject_lora(jp, jl), jnp.asarray(toks), jcfg), np.float32)
    # bf16 activations: one bf16 step of the logits' scale
    np.testing.assert_allclose(_np(injected), want, atol=0.05, rtol=0)


def test_rejects_bad_targets_and_mesh():
    cfg = TransformerConfig(**CFG)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    with pytest.raises(ValueError, match="not in model layers"):
        lora.lora_init(params, rank=4, targets=("nope",), generator=g)
    q8 = dict(params, layers=dict(params["layers"], wq={"q8": None, "scale": None}))
    with pytest.raises(ValueError, match="int8-quantized"):
        lora.lora_init(q8, rank=4, generator=g)
    lo = lora.lora_init(params, rank=4, generator=g)
    with pytest.raises(ValueError, match="int8-quantized"):
        lora.merge_lora(q8, lo)
    flat = dict(params, layers=dict(params["layers"], wq=params["layers"]["wq"][0]))
    with pytest.raises(ValueError, match="stacked"):
        lora.lora_init(flat, rank=4, generator=g)
    from elastic_gpu_scheduler_tpu_torch.parallel.mesh import MeshSpec, RankDevice, make_mesh

    two = make_mesh(MeshSpec(tensor=2), [RankDevice(0), RankDevice(1)])
    with pytest.raises(RuntimeError, match="connect the mesh"):
        lora.make_lora_train_step(cfg, make_optimizer(), mesh=two)
