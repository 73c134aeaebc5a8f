"""Port parity for the Switch MoE (``models/moe``) in training and
``generate``.

``moe_ffn`` on the same numpy inputs as the JAX package's, at the shapes of
``tests/test_moe_pipeline.py``: output and aux within 1e-5 in float32 with
tokens dropped at capacity factors 1.0 and 1.25; gradients of a loss through it within 1e-5; the MoE
model's forward and aux; three float32 MoE train steps (the aux in the
loss, on the logits and the vocab-chunked paths) within 1e-5 of
``make_jitted_train_step``; ``generate`` on a MoE model with tokens
identical to the reference's.  Port-only: ``init_params`` gives the
reference's MoE shapes and at-rest dtypes; ``estimate_hbm_bytes`` counts
experts as the reference does; LoRA refuses expert-stacked targets word
for word; the launcher trains a MoE ``JobSpec``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.models import lora as jlora
from elastic_gpu_scheduler_tpu.models import serving as jserving
from elastic_gpu_scheduler_tpu.models.generate import generate as jax_generate
from elastic_gpu_scheduler_tpu.models.moe import moe_ffn as jax_moe_ffn
from elastic_gpu_scheduler_tpu.models.train import (
    init_sharded_state,
    make_jitted_train_step,
    make_optimizer as jax_make_optimizer,
)
from elastic_gpu_scheduler_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    forward_with_aux as jax_forward_with_aux,
    init_params as jax_init_params,
)
from elastic_gpu_scheduler_tpu_torch.launcher import JobSpec, run_job
from elastic_gpu_scheduler_tpu_torch.models import data, lora, serving, train
from elastic_gpu_scheduler_tpu_torch.models.bridge import (
    opt_state_from_jax,
    params_from_jax,
    params_to_numpy,
)
from elastic_gpu_scheduler_tpu_torch.models.generate import generate
from elastic_gpu_scheduler_tpu_torch.models.moe import moe_ffn
from elastic_gpu_scheduler_tpu_torch.models.transformer import (
    TransformerConfig,
    forward_with_aux,
    init_params,
)

torch.set_num_threads(1)


def _ffn_inputs(seed, B=2, S=8, D=16, E=4, F=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, D)).astype(np.float32),
            (rng.standard_normal((D, E)) * 0.5).astype(np.float32),
            (rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32),
            (rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32),
            (rng.standard_normal((E, F, D)) * F ** -0.5).astype(np.float32)]


def _dropped(x, gate_w, cf) -> int:
    """Tokens past their expert's capacity (the test must drop some)."""
    T, E = x.shape[0] * x.shape[1], gate_w.shape[-1]
    idx = np.argmax(x.reshape(T, -1) @ gate_w, axis=-1)
    cap = max(1, int(cf * T / E))
    return int(sum(max(0, c - cap) for c in np.bincount(idx, minlength=E)))


@pytest.mark.parametrize("cf", [1.0, 1.25])
def test_moe_ffn_output_and_aux_match_jax(cf):
    args = _ffn_inputs(0)
    assert _dropped(args[0], args[1], cf) > 0
    want, waux = jax_moe_ffn(*map(jnp.asarray, args), capacity_factor=cf, dtype=jnp.float32)
    got, aux = moe_ffn(*map(torch.from_numpy, args), capacity_factor=cf, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(float(aux), float(waux), atol=1e-5)
    # dropped tokens give exact zeros, as the reference's
    np.testing.assert_array_equal(got.numpy() == 0, np.asarray(want) == 0)


def test_moe_ffn_capacity_bounds_the_kept_tokens():
    """capacity_factor ~0: one token an expert survives, the rest give 0."""
    args = [torch.from_numpy(a) for a in _ffn_inputs(1, B=1, D=8, E=2, F=16)]
    out, _ = moe_ffn(*args, capacity_factor=1e-9, dtype=torch.float32)
    assert int((out != 0).any(dim=-1).sum()) <= 2
    full, _ = moe_ffn(*args, capacity_factor=10.0, dtype=torch.float32)
    assert bool((full != 0).any(dim=-1).all())


def test_moe_ffn_gradients_match_jax():
    args = _ffn_inputs(2)
    cot = np.random.default_rng(3).standard_normal(args[0].shape).astype(np.float32)

    def jloss(*a):
        out, aux = jax_moe_ffn(*a, capacity_factor=1.0, dtype=jnp.float32)
        return jnp.sum(out * cot) + 0.5 * aux

    want = jax.grad(jloss, argnums=tuple(range(5)))(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out, aux = moe_ffn(*leaves, capacity_factor=1.0, dtype=torch.float32)
    (torch.sum(out * torch.from_numpy(cot)) + 0.5 * aux).backward()
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5)


# -- the MoE model ----------------------------------------------------------------

BASE = dict(vocab_size=96, d_model=32, n_layers=2, n_heads=2, d_ff=64, n_experts=4,
            capacity_factor=1.0)


def _cfgs(**kw):
    c = dict(BASE, **kw)
    return JaxConfig(**c), TransformerConfig(**c)


def test_init_params_has_the_reference_moe_tree():
    jcfg, cfg = _cfgs(dtype="bfloat16")
    want = jax_init_params(jax.random.key(0), jcfg)
    got = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    wl = jax.tree.leaves_with_path(want)
    gl = jax.tree.leaves_with_path(params_to_numpy(got))
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        assert g.shape == w.shape, path
        assert (g.dtype == np.uint16) == (w.dtype.name == "bfloat16"), path
    assert got["layers"]["moe_gate"].dtype == torch.float32


def test_moe_forward_and_aux_match_jax():
    jcfg, cfg = _cfgs(dtype="float32")
    jp = jax_init_params(jax.random.key(1), jcfg)
    tokens = np.random.default_rng(0).integers(0, 96, (2, 12)).astype(np.int32)
    want, waux = jax_forward_with_aux(jp, jnp.asarray(tokens), jcfg)
    got, aux = forward_with_aux(params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
                                torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(float(aux), float(waux), atol=1e-5)
    assert float(aux) > 0


def _tokens(n, batch=4, seq=16, seed=1):
    src = data.SyntheticTokenDataset(BASE["vocab_size"], seed=seed)
    it = data.batches(src, batch_size=batch, seq_len=seq, seed=seed + 1)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("variant", ["logits", "remat_chunked"])
def test_three_fp32_moe_steps_match_jax(variant):
    kw = dict(dtype="float32", aux_loss_weight=0.1)
    if variant == "remat_chunked":
        kw.update(remat=True, xent_chunks=4)
    jcfg, cfg = _cfgs(**kw)
    okw = dict(lr=1e-3, warmup_steps=1, total_steps=4, grad_clip=1.0)
    jopt, opt = jax_make_optimizer(**okw), train.make_optimizer(**okw)
    jp, js = init_sharded_state(jax.random.key(0), jcfg, jopt)
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    state = opt_state_from_jax(jax.tree.map(np.asarray, js), "cpu")
    for leaf in train._leaves(params):
        leaf.requires_grad_(True)
    jstep = make_jitted_train_step(jcfg, jopt)
    step = train.make_train_step(cfg, opt)
    # the aux term is in the loss, weighted, on this path
    toks0 = torch.from_numpy(_tokens(1)[0])
    with torch.no_grad():
        logits, aux = forward_with_aux(params, toks0[:, :-1], cfg)
        ce = train.cross_entropy_loss(logits, toks0[:, 1:])
        whole = train.loss_fn(params, toks0, cfg)
    assert float(aux) > 0.5
    np.testing.assert_allclose(float(whole), float(ce) + 0.1 * float(aux), atol=1e-5)
    for toks in _tokens(3):
        jp, js, jloss = jstep(jp, js, jnp.asarray(toks))
        params, state, loss = step(params, state, torch.from_numpy(toks))
        np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)
    for got, want in zip(jax.tree.leaves(params_to_numpy(params)),
                         jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_moe_generate_matches_jax():
    """``generate`` on a MoE model runs training's capacity-factor
    ``moe_ffn`` (here with drops in the prompt pass) and gives the
    reference's greedy tokens."""
    jcfg, cfg = _cfgs(dtype="float32", capacity_factor=1.0)
    jp = jax_init_params(jax.random.key(4), jcfg)
    jp["layers"]["moe_gate"] = jp["layers"]["moe_gate"] * 8.0  # spread the routing
    prompt = np.random.default_rng(5).integers(0, 96, (2, 9)).astype(np.int32)
    want = jax_generate(jp, jnp.asarray(prompt), jcfg, max_new_tokens=8)
    got = generate(params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
                   torch.from_numpy(prompt), cfg, max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lora_refuses_expert_targets_like_the_reference():
    jcfg, _ = _cfgs(dtype="float32")
    jp = jax_init_params(jax.random.key(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    with pytest.raises(ValueError) as want:
        jlora.lora_init(jax.random.key(0), jp, rank=2, targets=("wq", "w_in"))
    with pytest.raises(ValueError) as got:
        lora.lora_init(tp, rank=2, targets=("wq", "w_in"))
    assert str(got.value) == str(want.value)
    # the attention families of a MoE model take adapters
    assert set(lora.lora_init(tp, rank=2, targets=("wq", "wo"))["adapters"]) == {"wq", "wo"}


@pytest.mark.parametrize("per", [2.0, 1.0])
def test_hbm_estimate_counts_experts_like_the_reference(per):
    jcfg, cfg = _cfgs(dtype="bfloat16", n_experts=8)
    kw = dict(max_batch=4, max_len=128, page_size=16, kv_int8=True, param_bytes_per=per)
    assert serving.estimate_hbm_bytes(cfg, **kw) == jserving.estimate_hbm_bytes(jcfg, **kw)
    assert serving._cfg_param_count(cfg) == jserving._cfg_param_count(jcfg)


def test_launcher_trains_a_moe_job():
    spec = JobSpec(model=TransformerConfig(**dict(BASE, dtype="float32")), steps=3,
                   batch_size=2, seq_len=8, lr=1e-2)
    losses = run_job(spec, device="cpu")
    assert len(losses) == 3 and all(np.isfinite(losses)) and losses[-1] < losses[0]
