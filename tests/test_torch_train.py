"""Port parity for the training path: AdamW, train steps, data, serving
trained weights.

Weights come from the JAX package's ``init_sharded_state`` and cross
through ``bridge.params_from_jax`` / ``bridge.opt_state_from_jax``; the
same numpy gradients or token batches go through the JAX functions and
their port (CPU tensors: the plain paths).

Tolerances: the optimizer 1e-6 absolute on parameters and moments (the
same fp32 arithmetic, with the bias corrections and the schedule in
float64 on the port's side and float32 on the reference's); a bfloat16
first moment to one bfloat16 step.  Three float32 train steps: 1e-5
absolute on losses and parameters (the same fp32 model, summed in another
order, through three Adam updates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.models import data as jdata
from elastic_gpu_scheduler_tpu.models.train import (
    init_sharded_state,
    make_jitted_train_step,
    make_optimizer as jax_make_optimizer,
)
from elastic_gpu_scheduler_tpu.models.transformer import TransformerConfig as JaxConfig
from elastic_gpu_scheduler_tpu_torch.models import data, serving, train
from elastic_gpu_scheduler_tpu_torch.models.bridge import (
    opt_state_from_jax,
    params_from_jax,
    params_to_numpy,
)
from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig

torch.set_num_threads(1)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


# -- optimizer -----------------------------------------------------------------


def _tree(rng):
    return {
        "a": rng.standard_normal((4, 5)).astype(np.float32),
        "b": {"c": rng.standard_normal(7).astype(np.float32),
              "d": rng.standard_normal((3, 2, 2)).astype(np.float32)},
    }


OPT_CASES = {
    "constant": dict(lr=1e-2, weight_decay=0.1),
    "warmup_cosine_clip": dict(lr=1e-2, weight_decay=0.1, warmup_steps=2,
                               total_steps=6, grad_clip=0.5),
    "bf16_mu": dict(lr=1e-2, weight_decay=0.01, warmup_steps=1, total_steps=5,
                    grad_clip=2.0, mu_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_adamw_matches_optax(case):
    """k steps of optax, the state carried across at count k > 0 (bias
    corrections and schedule no longer trivial), then more steps on both
    sides from there."""
    kw = OPT_CASES[case]
    rng = np.random.default_rng(0)
    jopt = jax_make_optimizer(**kw)
    opt = train.make_optimizer(**kw)
    params = _tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    grads = [_tree(rng) for _ in range(6)]
    for g in grads[:3]:
        u, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jax.tree.map(lambda p, d: p + d, jp, u)
    state = opt_state_from_jax(jax.tree.map(np.asarray, js), "cpu")
    assert state.count == 3
    p = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    for g in grads[3:]:
        u, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jax.tree.map(lambda p, d: p + d, jp, u)
        opt.update(params_from_jax(g, "cpu"), state, p)
    assert state.count == 6
    mu_tol = 2 ** -8 if kw.get("mu_dtype") else 1e-6
    for got, want in zip(jax.tree.leaves(params_to_numpy(p)), _leaves_np(jp)):
        np.testing.assert_allclose(got, want, atol=1e-6)
    want_state = jax.tree.map(np.asarray, js)
    inner = [s for s in jax.tree.leaves(want_state, is_leaf=lambda s: hasattr(s, "mu"))
             if hasattr(s, "mu")][0]
    for got, want in zip(train._leaves(state.mu), jax.tree.leaves(inner.mu)):
        assert got.dtype == (torch.bfloat16 if kw.get("mu_dtype") else torch.float32)
        np.testing.assert_allclose(_np32(got), _np32(want), atol=mu_tol)
    for got, want in zip(train._leaves(state.nu), jax.tree.leaves(inner.nu)):
        np.testing.assert_allclose(_np32(got), np.asarray(want), atol=1e-6)


def test_first_warmup_update_is_zero():
    """optax reads the schedule before its count moves: with warmup the
    first update is zero, weight decay included."""
    opt = train.make_optimizer(lr=1e-2, weight_decay=0.1, warmup_steps=3, total_steps=9)
    p = {"w": torch.ones(3)}
    before = p["w"].clone()
    state = opt.init(p)
    opt.update({"w": torch.full((3,), 5.0)}, state, p)
    assert torch.equal(p["w"], before) and state.count == 1
    assert opt.learning_rate(1) == pytest.approx(1e-2 / 3)
    assert opt.learning_rate(9) == pytest.approx(1e-3)


# -- train steps ----------------------------------------------------------------

BASE = dict(vocab_size=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128)


def _cfgs(**kw):
    c = dict(BASE, **kw)
    return JaxConfig(**c), TransformerConfig(**c)


def _tokens(n, batch=4, seq=16, seed=1):
    src = data.SyntheticTokenDataset(BASE["vocab_size"], seed=seed)
    it = data.batches(src, batch_size=batch, seq_len=seq, seed=seed + 1)
    return [next(it) for _ in range(n)]


def _port_state(jparams, jstate):
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    state = opt_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    for leaf in train._leaves(params):
        leaf.requires_grad_(True)
    return params, state


@pytest.mark.parametrize("variant", ["dense", "remat_chunked"])
def test_three_fp32_steps_match_jax(variant):
    kw = dict(dtype="float32")
    if variant == "remat_chunked":
        kw.update(remat=True, xent_chunks=4, window_size=5)
    jcfg, cfg = _cfgs(**kw)
    okw = dict(lr=1e-3, warmup_steps=1, total_steps=4, grad_clip=1.0)
    jopt, opt = jax_make_optimizer(**okw), train.make_optimizer(**okw)
    jp, js = init_sharded_state(jax.random.key(0), jcfg, jopt)
    params, state = _port_state(jp, js)
    jstep = make_jitted_train_step(jcfg, jopt)
    step = train.make_train_step(cfg, opt)
    for toks in _tokens(3):
        jp, js, jloss = jstep(jp, js, jnp.asarray(toks))
        params, state, loss = step(params, state, torch.from_numpy(toks))
        np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)
    assert state.count == 3
    for got, want in zip(jax.tree.leaves(params_to_numpy(params)), _leaves_np(jp)):
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_master_state_crosses_the_bridge():
    """A bf16 model's MasterState after two JAX steps: the masters, the
    bf16 first moment and the count arrive as they are."""
    jcfg, _ = _cfgs(dtype="bfloat16")
    jopt = jax_make_optimizer(lr=1e-2, mu_dtype="bfloat16", grad_clip=1.0)
    jp, js = init_sharded_state(jax.random.key(5), jcfg, jopt)
    jstep = make_jitted_train_step(jcfg, jopt)
    for toks in _tokens(2, seq=8):
        jp, js, _ = jstep(jp, js, jnp.asarray(toks))
    state = opt_state_from_jax(jax.tree.map(np.asarray, js), "cpu")
    assert isinstance(state, train.MasterState) and state.inner.count == 2
    for got, want in zip(train._leaves(state.master), _leaves_np(js.master)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    mu = state.inner.mu["layers"]["wq"]
    assert mu.dtype == torch.bfloat16 and mu.abs().sum() > 0


def test_bf16_master_state_trains():
    _, cfg = _cfgs(dtype="bfloat16", remat=True, xent_chunks=2)
    opt = train.make_optimizer(lr=1e-2, grad_clip=1.0, mu_dtype="bfloat16")
    params, state = train.init_state(cfg, opt, torch.Generator().manual_seed(0), "cpu")
    assert isinstance(state, train.MasterState)
    assert params["layers"]["wq"].dtype == torch.bfloat16
    assert state.master["layers"]["wq"].dtype == torch.float32
    assert state.inner.mu["layers"]["wq"].dtype == torch.bfloat16
    # the masters are copies, not aliases
    assert state.master["final_norm"].data_ptr() != params["final_norm"].data_ptr()
    step = train.make_train_step(cfg, opt)
    toks = _tokens(1, batch=4, seq=32)[0]
    losses = [float(step(params, state, torch.from_numpy(toks))[2]) for _ in range(8)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    for p, m in zip(train._leaves(params), train._leaves(state.master)):
        assert torch.equal(p, m.to(p.dtype))


def test_grad_accum_gives_full_batch_gradients():
    jcfg, cfg = _cfgs(dtype="float32", remat=True)
    jp, _ = init_sharded_state(jax.random.key(1), jcfg, jax_make_optimizer())
    params, _ = _port_state(jp, jax_make_optimizer().init(jp))
    toks = torch.from_numpy(_tokens(1, batch=8)[0])
    loss1, g1 = train._grads_of(params, toks, cfg, 1)
    loss4, g4 = train._grads_of(params, toks, cfg, 4)
    assert abs(float(loss1) - float(loss4)) < 1e-6
    for a, b in zip(g1, g4):
        assert a.dtype == b.dtype == torch.float32
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="grad_accum"):
        train._grads_of(params, toks, cfg, 3)


def test_grad_accum_step_matches_jax():
    jcfg, cfg = _cfgs(dtype="float32")
    jopt, opt = jax_make_optimizer(lr=1e-3), train.make_optimizer(lr=1e-3)
    jp, js = init_sharded_state(jax.random.key(2), jcfg, jopt)
    params, state = _port_state(jp, js)
    toks = _tokens(1, batch=8, seed=3)[0]
    jp, js, jloss = make_jitted_train_step(jcfg, jopt, grad_accum=4)(jp, js, jnp.asarray(toks))
    params, state, loss = train.make_train_step(cfg, opt, grad_accum=4)(
        params, state, torch.from_numpy(toks))
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)
    for got, want in zip(jax.tree.leaves(params_to_numpy(params)), _leaves_np(jp)):
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_evaluate_matches_jax():
    from elastic_gpu_scheduler_tpu.models.train import evaluate as jax_evaluate

    jcfg, cfg = _cfgs(dtype="float32", xent_chunks=3)
    jp, js = init_sharded_state(jax.random.key(4), jcfg, jax_make_optimizer())
    params, _ = _port_state(jp, js)
    bs = _tokens(2, seed=5)
    want = jax_evaluate(jp, jcfg, [jnp.asarray(b) for b in bs])
    got = train.evaluate(params, cfg, [torch.from_numpy(b) for b in bs])
    assert got["batches"] == 2
    assert got["loss"] == pytest.approx(want["loss"], abs=1e-5)
    assert got["perplexity"] == pytest.approx(want["perplexity"], rel=1e-5)


def test_mesh_and_unported_configs_refused():
    """The pipe and expert axes train now; what a mesh cannot cut is a
    ValueError by name, int8 layer leaves on a mesh are refused by name,
    MoE pipelined over a batch cut by data passes the model's checks, and
    a step needs a connected mesh."""
    from elastic_gpu_scheduler_tpu_torch.parallel.mesh import MeshSpec, RankDevice, make_mesh

    _, cfg = _cfgs(dtype="float32", n_microbatches=2)
    opt = train.make_optimizer()
    three = make_mesh(MeshSpec(pipe=3), [RankDevice(i) for i in range(3)])
    for fn in (lambda: train.make_train_step(cfg, opt, mesh=three),
               lambda: train.init_state(cfg, opt, torch.Generator(), "cpu", mesh=three)):
        with pytest.raises(ValueError, match="not divisible by pipe=3"):
            fn()
    _, moe = _cfgs(dtype="float32", n_experts=2, n_microbatches=2)
    piped = make_mesh(MeshSpec(data=2, pipe=2), [RankDevice(i) for i in range(4)])
    with pytest.raises(RuntimeError, match="connect"):  # past the model's checks
        train.make_train_step(moe, opt, mesh=piped)
    from elastic_gpu_scheduler_tpu_torch.models.quantize import quantize_params
    from elastic_gpu_scheduler_tpu_torch.models.transformer import check_mesh_model, init_params

    int8 = quantize_params(init_params(moe, torch.Generator().manual_seed(0), "cpu"))
    with pytest.raises(NotImplementedError, match="int8 layer leaf"):
        check_mesh_model(moe, piped, int8)
    with pytest.raises(ValueError, match="n_experts=2 not divisible by expert=4"):
        train.make_train_step(moe, opt, make_mesh(MeshSpec(expert=4),
                                                  [RankDevice(i) for i in range(4)]))
    two = make_mesh(MeshSpec(tensor=2), [RankDevice(0), RankDevice(1)])
    with pytest.raises(RuntimeError, match="connect"):
        train.make_train_step(cfg, opt, mesh=two)
    # one device: n_microbatches takes the plain path, as the reference's
    params, state = train.init_state(cfg, opt, torch.Generator(), "cpu")
    assert np.isfinite(float(train.make_train_step(cfg, opt)(
        params, state, torch.zeros(2, 5, dtype=torch.int32))[2]))


# -- data -----------------------------------------------------------------------


@pytest.mark.parametrize("source", ["synthetic", "memmap"])
def test_batch_streams_identical_to_reference(source, tmp_path):
    if source == "memmap":
        toks = np.random.default_rng(0).integers(0, 500, 4000)
        path = str(tmp_path / "tokens.bin")
        data.write_token_file(path, toks)
        ours, ref = data.MemmapTokenDataset(path), jdata.MemmapTokenDataset(path)
    else:
        ours, ref = data.SyntheticTokenDataset(500, seed=7), jdata.SyntheticTokenDataset(500, seed=7)
    kw = dict(batch_size=4, seq_len=33, seed=9, process_index=1, process_count=2,
              max_batches=3, start_batch=2)
    got, want = list(data.batches(ours, **kw)), list(jdata.batches(ref, **kw))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# -- serving trained weights ------------------------------------------------------


def test_serving_trainable_parameters_builds_no_graph():
    """Parameters fresh from training (requires_grad) serve: the step
    functions and the engine run under inference mode."""
    _, cfg = _cfgs(dtype="float32")
    opt = train.make_optimizer(lr=1e-3)
    params, state = train.init_state(cfg, opt, torch.Generator().manual_seed(0), "cpu")
    train.make_train_step(cfg, opt)(params, state, torch.from_numpy(_tokens(1)[0]))
    assert params["layers"]["wq"].requires_grad
    eng = serving.InferenceEngine(params, cfg, max_batch=2, max_len=64, page_size=8,
                                  fused_steps=4, device="cpu")
    reqs = [eng.submit(serving.Request(prompt=p, max_new_tokens=6)) for p in ([3, 4, 5], [9])]
    eng.run_until_idle()
    assert all(r.done.is_set() and not r.error and len(r.output) == 6 for r in reqs)
    kv = serving.make_kv_pool(cfg, 4, 8, "cpu")
    logits, _ = serving._paged_decode_step(
        params, torch.tensor([1, 2], dtype=torch.int32), kv,
        torch.ones((2, 2), dtype=torch.int32), torch.tensor([0, 3], dtype=torch.int32),
        cfg, 8,
    )
    assert not logits.requires_grad and logits.grad_fn is None
