"""The ViT family in the port against the reference's ``models/vit.py``.

The reference's tests (``test_vit.py``) ported: patchify's values, the
forward's shapes, and a synthetic task the model must learn.  Parity:
the reference's ``init_vit_params(jax.random.key(n))`` carried over by
``bridge.vit_params_from_jax``, the same numpy images and labels through
both packages (float32; attention non-causal: the plain version of K1
and K4 on CPU tensors): logits, every gradient of ``vit_loss`` and the
parameters after 3 AdamW steps within 1e-5 (``test_torch_train.py``'s
float32 tolerance for three train steps), and with ``remat`` on.  A
gradient leaf is held to 1e-5 of its own scale, max(1, max |ref|): the
CLS token's gradient sums every row of the batch and reaches ~50 on
random weights, where one float32 step is already 4e-6.  int8:
the quantized trees (``patch_embed`` and ``head`` quantized too) give
logits within 1e-4 of the reference's (the reference dequantises the
weight and multiplies; the port's ``wmatmul`` sums the int8 product in
fp32 and scales after, so the two round differently).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.models import vit as ref_vit
from elastic_gpu_scheduler_tpu.models.quantize import quantize_params as ref_quantize
from elastic_gpu_scheduler_tpu.models.train import make_optimizer as ref_make_optimizer
from elastic_gpu_scheduler_tpu_torch.models import train, vit
from elastic_gpu_scheduler_tpu_torch.models.bridge import params_to_numpy, vit_params_from_jax
from elastic_gpu_scheduler_tpu_torch.models.quantize import is_qtensor, quantize_params

torch.set_num_threads(1)

CFG = vit.ViTConfig(image_size=16, patch_size=4, n_classes=4, d_model=32, n_layers=2,
                    n_heads=2, d_ff=64, dtype="float32")
TOL = 1e-5


def _ref_cfg(cfg):
    return ref_vit.ViTConfig(**dataclasses.asdict(cfg))


def _weights(seed=0, cfg=CFG):
    jp = ref_vit.init_vit_params(jax.random.key(seed), _ref_cfg(cfg))
    return jp, vit_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _batch(n, seed=1):
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(n, 16, 16, 3)).astype(np.float32)
    return imgs, rng.integers(0, 4, size=n).astype(np.int32)


def test_patchify_roundtrip_values():
    imgs = torch.arange(2 * 16 * 16 * 3, dtype=torch.float32).reshape(2, 16, 16, 3)
    p = vit.patchify(imgs, 4)
    assert p.shape == (2, 16, 48)
    # first patch = top-left 4x4 block
    assert torch.equal(p[0, 0].reshape(4, 4, 3), imgs[0, :4, :4, :])
    want = np.asarray(ref_vit.patchify(jnp.asarray(imgs.numpy()), 4))
    np.testing.assert_array_equal(p.numpy(), want)


def test_forward_shapes():
    params = vit.init_vit_params(CFG, torch.Generator().manual_seed(0), "cpu")
    imgs = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    logits = vit.forward_vit(params, imgs, CFG)
    assert logits.shape == (2, 4) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
    jp = ref_vit.init_vit_params(jax.random.key(0), _ref_cfg(CFG))
    assert jax.tree.structure(params_to_numpy(params)) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(params_to_numpy(params)), jax.tree.leaves(jp)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_vit_learns_synthetic_task():
    """Classify which quadrant carries the bright blob: learnable in a few
    dozen steps if attention and the patch embedding work."""
    rng = np.random.default_rng(0)

    def batch(n):
        imgs = rng.normal(0, 0.1, size=(n, 16, 16, 3)).astype(np.float32)
        labels = rng.integers(0, 4, size=n)
        for i, lab in enumerate(labels):
            y, x = divmod(int(lab), 2)
            imgs[i, y * 8: y * 8 + 8, x * 8: x * 8 + 8, :] += 1.0
        return torch.from_numpy(imgs), torch.from_numpy(labels)

    params = vit.init_vit_params(CFG, torch.Generator().manual_seed(0), "cpu")
    opt = train.make_optimizer(lr=3e-3)
    opt_state = opt.init(params)
    step = vit.make_vit_train_step(CFG, opt)
    for _ in range(60):
        imgs, labels = batch(32)
        params, opt_state, loss = step(params, opt_state, imgs, labels)
    imgs, labels = batch(128)
    with torch.no_grad():
        preds = torch.argmax(vit.forward_vit(params, imgs, CFG), dim=-1)
    acc = float((preds == labels).float().mean())
    assert acc > 0.9, f"accuracy {acc}"


def test_logits_and_gradients_match_the_reference():
    jp, params = _weights(3)
    imgs, labels = _batch(4)
    rcfg = _ref_cfg(CFG)
    want = np.asarray(ref_vit.forward_vit(jp, jnp.asarray(imgs), rcfg))
    leaves = train._leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    got = vit.forward_vit(params, torch.from_numpy(imgs), CFG)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL, rtol=0)
    loss = vit.vit_loss(params, torch.from_numpy(imgs), torch.from_numpy(labels), CFG)
    grads = torch.autograd.grad(loss, leaves)
    jloss, jgrads = jax.value_and_grad(ref_vit.vit_loss)(jp, jnp.asarray(imgs),
                                                         jnp.asarray(labels), rcfg)
    assert abs(loss.item() - float(jloss)) <= TOL
    want_g = jax.tree.leaves(jax.tree.map(np.asarray, jgrads))
    got_g = jax.tree.leaves(params_to_numpy(train._unflatten(params, list(grads))))
    assert len(got_g) == len(want_g) == 14
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, b, atol=TOL * max(1.0, float(np.abs(b).max())), rtol=0)


@pytest.mark.parametrize("remat", [False, True])
def test_three_adamw_steps_match_the_reference(remat):
    cfg = dataclasses.replace(CFG, remat=remat)
    jp, params = _weights(4, cfg)
    rcfg = _ref_cfg(cfg)
    jopt = ref_make_optimizer(lr=1e-2)
    jstate = jopt.init(jp)
    jstep = ref_vit.make_vit_train_step(rcfg, jopt)
    opt = train.make_optimizer(lr=1e-2)
    state = opt.init(params)
    step = vit.make_vit_train_step(cfg, opt)
    for i in range(3):
        imgs, labels = _batch(4, seed=10 + i)
        jp, jstate, jloss = jstep(jp, jstate, jnp.asarray(imgs), jnp.asarray(labels))
        params, state, loss = step(params, state, torch.from_numpy(imgs),
                                   torch.from_numpy(labels))
        assert abs(float(loss) - float(jloss)) <= TOL
    assert state.count == 3
    for a, b in zip(jax.tree.leaves(params_to_numpy(params)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)


def test_int8_logits_match_the_references_quantized_vit():
    jp, _ = _weights(5)
    jq = ref_quantize(jp)
    params = vit_params_from_jax(jax.tree.map(np.asarray, jq), "cpu")
    assert is_qtensor(params["patch_embed"]) and is_qtensor(params["head"])
    assert is_qtensor(params["layers"]["wq"]) and not is_qtensor(params["pos_embed"])
    # the port's quantizer gives the reference's bits
    mine = quantize_params(vit_params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    for a, b in zip(jax.tree.leaves(params_to_numpy(mine)),
                    jax.tree.leaves(params_to_numpy(params))):
        np.testing.assert_array_equal(a, b)
    imgs, _ = _batch(3)
    want = np.asarray(ref_vit.forward_vit(jq, jnp.asarray(imgs), _ref_cfg(CFG)))
    with torch.no_grad():
        got = vit.forward_vit(params, torch.from_numpy(imgs), CFG).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_vit_params_from_jax_refuses_another_tree():
    with pytest.raises(ValueError, match="not a ViT params tree"):
        vit_params_from_jax({"embed": np.zeros(2, np.float32)}, "cpu")
