"""Port parity for speculative decoding: prompt lookup, the per-sequence
``speculative_generate``, the engine's verify pass and the speculative
engine.

The same inputs (made with numpy from a seed, weights carried by
``bridge.params_from_jax``) go through the JAX package's function and
the port's, float32, on the CPU (the plain paths: K2 at W = spec_k + 1 is
its plain version here).  Tolerances: prompt lookup, token streams,
picked tokens and the counters ``spec_passes`` / ``spec_accepted`` are
exact; verify logits (as log-softmax of the top tokens) and the pool rows
a verify pass writes are within 2e-5 (float32, the kernels' float32
tolerance).  The JAX engine runs behind ``reference_engine_copies_uploads``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.models import serving as jserving
from elastic_gpu_scheduler_tpu.models import speculative as jspec
from elastic_gpu_scheduler_tpu.models.serving import (
    InferenceEngine as JaxEngine,
    Request as JaxRequest,
)
from elastic_gpu_scheduler_tpu_torch.models import serving, speculative
from elastic_gpu_scheduler_tpu_torch.models.bridge import params_from_jax, tensor_from_numpy
from elastic_gpu_scheduler_tpu_torch.models.generate import generate
from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine, Request
from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig

from test_torch_engine import (  # noqa: F401  (the autouse fixture)
    CFG,
    reference_engine_copies_uploads,
    weights,
)

# the suite runs in parallel worker processes: one intra-op thread keeps
# this file from crowding the workers that run beside it
torch.set_num_threads(1)

TOL = 2e-5
BASE = dict(max_batch=4, max_len=48, page_size=8)


def _mixed():
    return [([5, 17, 3], 10), ([60, 2], 6), ([9] * 8, 12), (list(range(1, 20)), 8)]


def _serve(eng, request_cls, specs):
    reqs = [eng.submit(request_cls(prompt=list(p), max_new_tokens=n, **extra))
            for p, n, *rest in specs for extra in [rest[0] if rest else {}]]
    eng.run_until_idle(max_steps=100_000)
    for r in reqs:
        assert r.done.is_set() and not r.error, r.error
    return [list(r.output) for r in reqs]


@pytest.fixture(scope="module")
def cyclic(weights):
    """Every transformer layer zeroed but the norms: logits depend on the
    current token only, so greedy decoding iterates a map over the vocab
    and enters a cycle, which prompt lookup drafts and the model accepts."""
    jcfg, jp, _ = weights
    jc = dict(jp)
    jc["layers"] = {k: (v if k.endswith("norm") else v * 0.0) for k, v in jp["layers"].items()}
    return jcfg, jc, params_from_jax(jax.tree.map(np.asarray, jc), "cpu")


@pytest.mark.parametrize("seed", range(6))
def test_propose_ngram_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        ctx = rng.integers(0, 4 + seed, rng.integers(0, 30)).tolist()
        n, k = int(rng.integers(1, 4)), int(rng.integers(1, 6))
        assert speculative.propose_ngram(ctx, n, k) == jspec.propose_ngram(ctx, n, k)


@pytest.mark.parametrize("kind", ["random", "cyclic"])
def test_speculative_generate_matches_jax(weights, cyclic, kind):
    jcfg, jp, params = weights if kind == "random" else cyclic
    cfg = TransformerConfig(**CFG)
    prompt = np.asarray([[5, 17, 3, 5, 17, 3, 8]], np.int32)
    want, wstats = jspec.speculative_generate(jp, jnp.asarray(prompt), jcfg, 24, ngram=2,
                                              k=4)
    got, stats = speculative.speculative_generate(params, torch.from_numpy(prompt), cfg, 24,
                                                  ngram=2, k=4)
    assert got.tolist() == np.asarray(want).tolist()
    assert stats == wstats
    # greedy-equivalent: the plain generate's tokens
    plain = generate(params, torch.from_numpy(prompt), cfg, 24)
    assert got.tolist() == plain.tolist()
    if kind == "cyclic":
        assert stats["accepted_drafts"] > 0 and stats["model_passes"] < 23


def _pool_state(cfg, jcfg, kv_int8, seed=3):
    """The same random pool contents, block tables, lengths and verify
    windows for both packages."""
    rng = np.random.default_rng(seed)
    B, W, ps, NB = 3, 5, 8, 4
    n_pages = B * NB + 1
    shape = (cfg.n_layers, n_pages, ps, cfg.kv_heads, cfg.head_dim)
    if kv_int8:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        pool = {"k": k, "v": v,
                "ks": rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32),
                "vs": rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32)}
    else:
        pool = {"k": rng.standard_normal(shape).astype(np.float32),
                "v": rng.standard_normal(shape).astype(np.float32)}
    tables = (rng.permutation(n_pages - 1)[: B * NB] + 1).reshape(B, NB).astype(np.int32)
    lengths = np.asarray([0, 13, NB * ps - 3], np.int32)  # the last window runs off the table
    feed = rng.integers(0, cfg.vocab_size, (B, W)).astype(np.int32)
    active = np.asarray([True, True, True])
    return pool, tables, lengths, feed, active, ps


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("paged_kernel", [False, True])
def test_fused_verify_chunk_matches_jax(weights, kv_int8, paged_kernel):
    jcfg, jp, params = weights
    cfg = TransformerConfig(**CFG)
    pool, tables, lengths, feed, active, ps = _pool_state(cfg, jcfg, kv_int8)
    B, W = feed.shape
    zeros_f, zeros_i = np.zeros(B, np.float32), np.zeros(B, np.int32)
    ones_f = np.ones(B, np.float32)
    topk = 4
    (jpicked, jchosen, jtop_ids, jtop_lps), jkv = jserving._fused_verify_chunk(
        jp, {k: jnp.asarray(v) for k, v in pool.items()}, jnp.asarray(tables),
        jnp.asarray(feed), jnp.asarray(lengths), jnp.asarray(active), jnp.asarray(zeros_f),
        jnp.asarray(zeros_i), jnp.asarray(ones_f), jax.random.key(0),
        cfg=jcfg, page_size=ps, use_filters=False, paged_kernel=paged_kernel,
        logprobs_k=topk,
    )
    args = (tensor_from_numpy(tables, "cpu"), tensor_from_numpy(feed, "cpu"),
            tensor_from_numpy(lengths, "cpu"), torch.from_numpy(active))
    kv = {k: tensor_from_numpy(v, "cpu") for k, v in pool.items()}
    logits = serving._verify_logits(params, kv, *args, cfg=cfg, page_size=ps,
                                    paged_kernel=paged_kernel)
    assert logits.shape == (B, W, cfg.vocab_size)
    lps = torch.log_softmax(logits, dim=-1)
    top_lps, top_ids = torch.topk(lps, topk, dim=-1)
    np.testing.assert_allclose(top_lps.numpy(), np.asarray(jtop_lps), atol=TOL, rtol=0)
    assert top_ids.tolist() == np.asarray(jtop_ids).tolist()
    # the fused pass from the same starting pool: its picked tokens, and
    # the rows it writes
    kv = {k: tensor_from_numpy(v, "cpu") for k, v in pool.items()}
    picked, kv = serving._fused_verify_chunk(
        params, kv, *args, torch.from_numpy(zeros_f), torch.from_numpy(zeros_i),
        torch.from_numpy(ones_f), torch.Generator().manual_seed(0), cfg=cfg, page_size=ps,
        use_filters=False, use_temp=False, paged_kernel=paged_kernel,
    )
    assert picked.tolist() == np.asarray(jpicked).tolist()
    for name in pool:
        np.testing.assert_allclose(kv[name].float().numpy(),
                                   np.asarray(jkv[name], np.float32), atol=TOL, rtol=0)


def _spec_pair(weights, specs, **kw):
    """(JAX, port) speculative engines' outputs and counters, and the port
    non-speculative engine's outputs; sequential mode for the counters."""
    jcfg, jp, params = weights
    cfg = TransformerConfig(**CFG)
    kw = dict(BASE, **kw)
    spec_k = kw.pop("spec_k")
    jeng = JaxEngine(jp, jcfg, overlap=False, spec_k=spec_k, **kw)
    jout = _serve(jeng, JaxRequest, specs)
    peng = InferenceEngine(params, cfg, device="cpu", overlap=False, spec_k=spec_k, **kw)
    pout = _serve(peng, Request, specs)
    plain = _serve(InferenceEngine(params, cfg, device="cpu", **kw), Request, specs)
    counters = [(e.spec_passes, e.spec_accepted, e.steps_run) for e in (jeng, peng)]
    return jout, pout, plain, counters, peng


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("spec_k", [4, 5])
def test_spec_engine_matches_jax_and_plain(weights, spec_k, kv_int8):
    jout, pout, plain, counters, peng = _spec_pair(
        weights, _mixed(), spec_k=spec_k, kv_int8=kv_int8, paged_kernel=kv_int8)
    assert pout == jout == plain
    assert counters[0] == counters[1]
    assert peng.spec_passes > 0
    # the overlapped default serves the same tokens
    on = _serve(InferenceEngine(weights[2], TransformerConfig(**CFG), device="cpu",
                                spec_k=spec_k, kv_int8=kv_int8, **BASE), Request, _mixed())
    assert on == plain


def test_spec_acceptance_above_one_on_repetitive_output(cyclic):
    n_new = 40
    specs = [([5, 17, 3], n_new)]
    kw = dict(max_batch=1, max_len=64, page_size=8)
    jout, pout, plain, counters, peng = _spec_pair(cyclic, specs, spec_k=5, **kw)
    ref = plain[0]
    assert any(ref[-2 * p:-p] == ref[-p:] for p in range(1, 13))  # it cycles
    assert pout == jout == plain and counters[0] == counters[1]
    assert peng.spec_accepted > 0
    assert n_new / peng.spec_passes > 1.5, counters


def test_spec_stop_token_inside_accepted_drafts(cyclic):
    """A stop token delivered by an ACCEPTED draft ends the stream exactly
    where the sequential engine ends it; drafts past it are dropped.  The
    prompt holds the model's cycle twice, so the first verify pass drafts
    the cycle and the stop (the third generated token) comes as a draft."""
    kw = dict(max_batch=1, max_len=64, page_size=8)
    cfg = TransformerConfig(**CFG)
    full = _serve(InferenceEngine(cyclic[2], cfg, device="cpu", **kw), Request,
                  [([5, 17, 3], 30)])[0]
    period = next(p for p in range(2, 13) if full[-p:] == full[-2 * p:-p])
    prompt = [5, 17, 3] + full[: 2 * period + 2]
    cont = _serve(InferenceEngine(cyclic[2], cfg, device="cpu", **kw), Request,
                  [(prompt, 20)])[0]
    stop = cont[2]
    assert stop not in cont[:2]
    specs = [(prompt, 20, dict(stop_tokens=(stop,)))]
    jout, pout, plain, counters, peng = _spec_pair(cyclic, specs, spec_k=5, **kw)
    assert pout == jout == plain and counters[0] == counters[1]
    assert pout[0] == cont[:3]
    assert peng.spec_passes == 1 and peng.spec_accepted == 2


def test_spec_with_sampled_rows_in_batch(weights):
    """Sampled rows ride the verify passes (one token a pass) and stay
    valid samples; greedy rows equal their solo ``generate`` runs."""
    _, _, params = weights
    cfg = TransformerConfig(**CFG)
    eng = InferenceEngine(params, cfg, device="cpu", spec_k=4, max_batch=3, max_len=48,
                          page_size=8)
    greedy_a = Request(prompt=[5, 17, 3], max_new_tokens=8)
    sampled = Request(prompt=[60, 2], max_new_tokens=8, temperature=0.8, top_k=12)
    greedy_b = Request(prompt=[9, 9, 9, 9], max_new_tokens=8)
    for r in (greedy_a, sampled, greedy_b):
        eng.submit(r)
    eng.run_until_idle()
    for r in (greedy_a, greedy_b):
        ref = generate(params, torch.tensor([r.prompt]), cfg, r.max_new_tokens)
        assert ref[0, len(r.prompt):].tolist() == r.output
    assert len(sampled.output) == 8 and all(0 <= t < cfg.vocab_size for t in sampled.output)
    assert eng.spec_passes > 0


@pytest.mark.parametrize("mode", ["prefix cache", "chunked prefill"])
def test_spec_with_prefix_cache_and_chunked_prefill(weights, mode):
    kw = dict(prefix_cache=True) if mode == "prefix cache" else dict(prefill_chunk=8)
    shared = list(range(1, 18))
    specs = [(shared + [40, 41], 8), ([60, 2], 6), (shared + [7], 9), (list(range(30, 60)), 7)]
    jout, pout, plain, counters, peng = _spec_pair(weights, specs, spec_k=4, max_len=64, **kw)
    assert pout == jout == plain and counters[0] == counters[1]
    if mode == "prefix cache":
        # a second wave on the same prefix hits the cache, tokens unchanged
        again = _serve(peng, Request, specs[:1])
        assert again == pout[:1] and peng.prefix_admission_hits >= 1


def test_spec_composes_with_overlap(weights):
    """Verify passes drain the chunk in flight and reset the carry; decode
    chunks (a step where only sampled rows generate) interleave with them;
    greedy streams stay exact."""
    _, _, params = weights
    cfg = TransformerConfig(**CFG)
    specs = [([3, 9, 14], 6), ([2, 4, 6, 8], 10)]
    off = _serve(InferenceEngine(params, cfg, device="cpu", overlap=False, spec_k=3, **BASE),
                 Request, specs)
    eng = InferenceEngine(params, cfg, device="cpu", spec_k=3, **BASE)
    greedy = [eng.submit(Request(prompt=p, max_new_tokens=n)) for p, n in specs]
    sampled = eng.submit(Request(prompt=[7, 7, 1], max_new_tokens=30, temperature=0.9))
    kinds = []
    for _ in range(1000):
        eng._admit()
        if not any(s is not None for s in eng.slots):
            break
        verify = eng._spec_useful()
        passes = eng.spec_passes
        eng.step()
        if verify:
            assert eng._pending is None and eng._carry is None
            assert eng.spec_passes == passes + 1
        kinds.append(verify)
    eng.run_until_idle()
    assert [r.output for r in greedy] == off
    assert len(sampled.output) == 30 and not sampled.error
    assert True in kinds and False in kinds  # both step kinds ran
    assert eng._pending is None


def test_stats_report_speculation_and_overlap(weights):
    import http.client
    import json

    from elastic_gpu_scheduler_tpu_torch.server.inference import serve_inference

    _, _, params = weights
    eng = InferenceEngine(params, TransformerConfig(**CFG), device="cpu", spec_k=2, **BASE)
    server, loop = serve_inference(eng, port=0, host="127.0.0.1")
    try:
        conn = http.client.HTTPConnection(*server.server_address, timeout=60)
        conn.request("POST", "/v1/completions", json.dumps({"prompt": [5, 17, 3],
                                                            "max_tokens": 6}))
        resp = conn.getresponse()
        assert resp.status == 200 and len(json.loads(resp.read())["tokens"]) == 6
        conn.request("GET", "/v1/stats")
        stats = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()
    assert stats["spec_k"] == 2 and stats["spec_passes"] > 0
    assert stats["spec_accepted"] >= 0 and stats["draft_model"] is False
    assert stats["overlap"] is True and stats["logprobs_k"] == 5
    assert set(stats["host_gap"]) == {"chunks", "mean_ms", "last_ms", "overlap"}
    assert stats["device_uploads"] > 0 and stats["chunks_discarded"] >= 0
