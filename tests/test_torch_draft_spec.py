"""Port parity for draft-model speculative decoding in the serving engine.

The draft's forward (``_draft_forward``, its dense cache written in place)
is held to the JAX package's on the same numpy inputs, weights carried by
``bridge.params_from_jax``: logits and cache rows within 2e-5 (float32).
The engines are held to exact tokens: with a draft model the port's greedy
output equals its non-speculative engine's and the JAX draft engine's,
with equal ``spec_passes`` / ``spec_accepted``.  The target used as its
own draft accepts the full window.  The JAX engine runs behind
``reference_engine_copies_uploads``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.models import serving as jserving
from elastic_gpu_scheduler_tpu.models.serving import (
    InferenceEngine as JaxEngine,
    Request as JaxRequest,
)
from elastic_gpu_scheduler_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    init_params as jax_init_params,
)
from elastic_gpu_scheduler_tpu_torch.models import serving
from elastic_gpu_scheduler_tpu_torch.models.bridge import params_from_jax, tensor_from_numpy
from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine, Request
from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig

from test_torch_engine import reference_engine_copies_uploads  # noqa: F401

# the suite runs in parallel worker processes: one intra-op thread keeps
# this file from crowding the workers that run beside it
torch.set_num_threads(1)

TOL = 2e-5
CFG = dict(vocab_size=97, d_model=48, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=96,
           dtype="float32")
DRAFT = dict(vocab_size=97, d_model=32, n_layers=1, n_heads=2, d_ff=64, dtype="float32")
PROMPTS = [[5, 17, 3], [60, 2, 9, 9, 9, 9], list(range(1, 20)), [42, 5]]


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, cfg, seed in (("target", CFG, 0), ("draft", DRAFT, 7)):
        jcfg = JaxConfig(**cfg)
        jp = jax_init_params(jax.random.key(seed), jcfg)
        out[name] = (jcfg, jp, TransformerConfig(**cfg),
                     params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    return out


def _run(models, draft=None, spec_k=0, temps=None, new=10, jax_engine=False, **kw):
    jcfg, jp, cfg, params = models["target"]
    kw = dict(dict(max_batch=4, max_len=96, page_size=8), **kw)
    if jax_engine:
        jdraft = None if draft is None else tuple(models[draft][1::-1])
        eng = JaxEngine(jp, jcfg, overlap=False, spec_k=spec_k, draft=jdraft, **kw)
        req_cls = JaxRequest
    else:
        pdraft = None if draft is None else tuple(models[draft][3:1:-1])
        eng = InferenceEngine(params, cfg, device="cpu", spec_k=spec_k, draft=pdraft, **kw)
        req_cls = Request
    temps = temps or [0.0] * len(PROMPTS)
    reqs = [eng.submit(req_cls(prompt=p, max_new_tokens=new, temperature=t))
            for p, t in zip(PROMPTS, temps)]
    eng.run_until_idle()
    for r in reqs:
        assert r.done.is_set() and not r.error, r.error
    return [list(r.output) for r in reqs], eng


@pytest.mark.parametrize("W", [1, 4])
def test_draft_forward_matches_jax(models, W):
    jcfg, jp, cfg, params = models["draft"]
    rng = np.random.default_rng(W)
    B, M = 3, 24
    shape = (cfg.n_layers, B, M + 1, cfg.kv_heads, cfg.head_dim)
    dkv = {"k": rng.standard_normal(shape).astype(np.float32),
           "v": rng.standard_normal(shape).astype(np.float32)}
    feed = rng.integers(0, cfg.vocab_size, (B, W)).astype(np.int32)
    starts = np.asarray([0, 9, M + 1 - W + 1], np.int32)[:B]  # the last runs past M
    jl, jkv = jserving._draft_forward(jp, {k: jnp.asarray(v) for k, v in dkv.items()},
                                      jnp.asarray(feed), jnp.asarray(starts), dcfg=jcfg)
    pkv = {k: tensor_from_numpy(v, "cpu") for k, v in dkv.items()}
    pl, pkv2 = serving._draft_forward(params, pkv, torch.from_numpy(feed),
                                      torch.from_numpy(starts), dcfg=cfg)
    assert pkv2 is pkv  # written in place
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    for name in ("k", "v"):
        # every row but the overflow scratch row (index M, written by
        # several positions at once in the last row of the batch)
        np.testing.assert_allclose(pkv[name][:, :, :M].numpy(),
                                   np.asarray(jkv[name])[:, :, :M], atol=TOL, rtol=0)


def test_draft_ingest_propose_matches_jax(models):
    jcfg, jp, cfg, params = models["draft"]
    rng = np.random.default_rng(11)
    B, M, W, k = 2, 40, 5, 4
    shape = (cfg.n_layers, B, M + 1, cfg.kv_heads, cfg.head_dim)
    dkv = {"k": np.zeros(shape, np.float32), "v": np.zeros(shape, np.float32)}
    feed = rng.integers(0, cfg.vocab_size, (B, W)).astype(np.int32)
    starts = np.asarray([0, 3], np.int32)
    counts = np.asarray([5, 2], np.int32)
    jd, _ = jserving._draft_ingest_propose(
        jp, {n: jnp.asarray(v) for n, v in dkv.items()}, jnp.asarray(feed),
        jnp.asarray(starts), jnp.asarray(counts), dcfg=jcfg, k=k)
    pd, _ = serving._draft_ingest_propose(
        params, {n: torch.from_numpy(v.copy()) for n, v in dkv.items()},
        torch.from_numpy(feed), torch.from_numpy(starts), torch.from_numpy(counts),
        dcfg=cfg, k=k)
    assert pd.tolist() == np.asarray(jd).tolist()


def test_draft_model_outputs_token_identical(models):
    """An unrelated random draft (mostly wrong drafts) changes no token of
    the plain engine's, and the port's counters equal the JAX engine's."""
    base, _ = _run(models)
    got, eng = _run(models, draft="draft", spec_k=3, overlap=False)
    want, jeng = _run(models, draft="draft", spec_k=3, jax_engine=True)
    assert got == base == want
    assert eng.spec_passes > 0
    assert (eng.spec_passes, eng.spec_accepted) == (jeng.spec_passes, jeng.spec_accepted)
    # the overlapped default serves the same tokens
    assert _run(models, draft="draft", spec_k=3)[0] == base


def test_self_draft_accepts_full_window(models):
    _, eng = _run(models, draft="target", spec_k=4, new=16)
    assert eng.spec_passes > 0
    assert eng.spec_accepted >= eng.spec_passes * 1.5, (eng.spec_accepted, eng.spec_passes)
    base, _ = _run(models, new=16)
    got, _ = _run(models, draft="target", spec_k=4, new=16)
    assert got == base


def test_self_draft_acceptance_survives_prompt_boundary(models):
    """The first generating pass after a prompt longer than the window
    rolls drafts from the last REAL token's logits: a perfect draft keeps
    near-full acceptance from the first pass on."""
    _, _, cfg, params = models["target"]
    prompt = [(3 * i) % 97 for i in range(20)]
    outs = []
    for draft, spec_k in (((params, cfg), 4), (None, 0)):
        eng = InferenceEngine(params, cfg, max_batch=1, max_len=96, page_size=8, device="cpu",
                              spec_k=spec_k, draft=draft)
        r = eng.submit(Request(prompt=prompt, max_new_tokens=20))
        eng.run_until_idle()
        assert r.done.is_set() and not r.error, r.error
        outs.append(r.output)
        if draft is not None:
            assert eng.spec_accepted >= 12, (eng.spec_accepted, eng.spec_passes)
    assert outs[0] == outs[1]


def test_draft_with_mixed_sampled_batch(models):
    temps = [0.0, 0.9, 0.0, 0.0]
    base, _ = _run(models, temps=temps)
    got, _ = _run(models, draft="draft", spec_k=3, temps=temps)
    for n, t in enumerate(temps):
        if t == 0.0:
            assert got[n] == base[n], f"greedy row {n} diverged"
        else:
            assert len(got[n]) == 10 and all(0 <= x < 97 for x in got[n])


def test_draft_long_prompt_chunked_ingest(models):
    """A prompt longer than the ingest chunk catches the draft up in
    several passes and still matches the plain engine and the JAX one."""
    _, _, cfg, params = models["target"]
    jcfg, jp = models["target"][:2]
    long_prompt = [(7 * i) % 97 for i in range(90)]
    outs = []
    for eng, req_cls in (
        (InferenceEngine(params, cfg, max_batch=2, max_len=160, page_size=8, spec_k=3,
                         draft=tuple(models["draft"][3:1:-1]), device="cpu"), Request),
        (JaxEngine(jp, jcfg, max_batch=2, max_len=160, page_size=8, spec_k=3,
                   draft=tuple(models["draft"][1::-1]), overlap=False), JaxRequest),
        (InferenceEngine(params, cfg, max_batch=2, max_len=160, page_size=8, device="cpu"),
         Request),
    ):
        if hasattr(eng, "_draft_chunk"):
            eng._draft_chunk = 16  # several pre-ingest passes
        r = eng.submit(req_cls(prompt=long_prompt, max_new_tokens=8))
        eng.run_until_idle()
        assert r.done.is_set() and not r.error, r.error
        outs.append(list(r.output))
    assert outs[0] == outs[1] == outs[2]


def test_draft_rejects_bad_configs(models):
    _, _, cfg, params = models["target"]
    _, _, dcfg, dparams = models["draft"]
    bad_vocab = TransformerConfig(**dict(DRAFT, vocab_size=50))
    with pytest.raises(ValueError, match="vocab"):
        InferenceEngine(params, cfg, spec_k=3, draft=(dparams, bad_vocab), device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        InferenceEngine(params, cfg, draft=(dparams, dcfg), device="cpu")
    moe = TransformerConfig(**dict(DRAFT, n_experts=4))
    with pytest.raises(ValueError, match="dense"):
        InferenceEngine(params, cfg, spec_k=3, draft=(dparams, moe), device="cpu")
