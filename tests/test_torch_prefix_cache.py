"""Port parity for the prefix cache and chunked prefill.

The JAX package's engine in its sequential mode (``overlap=False``) and
the port's engine serve the same waves of prompts on the same weights,
float32: greedy tokens must be identical, and so must the prefix-cache
counters and the number of prefill passes.  Port-only checks cover the
LRU eviction under a small pool, page conservation, and the digest
chain, which must be byte-identical to the reference's
(``utils/prefixdigest``).
"""

import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.models.serving import (
    InferenceEngine as JaxEngine,
    Request as JaxRequest,
)
from elastic_gpu_scheduler_tpu.utils import prefixdigest as jax_prefixdigest
from elastic_gpu_scheduler_tpu_torch.models import serving
from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine, Request
from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig
from elastic_gpu_scheduler_tpu_torch.utils import prefixdigest

from test_torch_engine import (  # noqa: F401  (the autouse fixture)
    CFG,
    reference_engine_copies_uploads,
    weights,
)

# the suite runs in parallel worker processes: one intra-op thread keeps
# this file from crowding the workers that run beside it
torch.set_num_threads(1)

RNG = np.random.default_rng(0)
SHARED = RNG.integers(0, 97, 24).tolist()  # three full pages of 8
WAVE1 = [SHARED + [1, 2, 3], RNG.integers(0, 97, 40).tolist(), [5]]
WAVE2 = [SHARED + RNG.integers(0, 97, n).tolist() for n in (1, 2, 9, 17, 30)]
COUNTERS = ("prefix_lookups", "prefix_admission_hits", "prefix_hit_tokens", "prefills_run")


def _serve(eng, request_cls, waves, max_new=6):
    outs = []
    for wave in waves:
        reqs = [eng.submit(request_cls(prompt=p, max_new_tokens=max_new)) for p in wave]
        eng.run_until_idle()
        for r in reqs:
            assert r.done.is_set() and not r.error, r.error
        outs.append([r.output for r in reqs])
    return outs, {c: int(getattr(eng, c)) for c in COUNTERS}


def _both(weights, waves, **kw):
    jcfg, jp, params = weights
    want = _serve(JaxEngine(jp, jcfg, overlap=False, **kw), JaxRequest, waves)
    eng = InferenceEngine(params, TransformerConfig(**CFG), device="cpu", overlap=False, **kw)
    got = _serve(eng, Request, waves)
    return want, got, eng


def _conserved(eng):
    """Every page but scratch is free or cached-and-unreferenced once the
    engine is idle, and nobody holds a reference."""
    unref_cached = [pg for pg in eng.page_key if eng.page_ref[pg] == 0]
    assert not eng.page_ref.any()
    assert len(eng.free_pages) + len(unref_cached) == eng.n_pages - 1
    assert len(set(eng.free_pages)) == len(eng.free_pages)
    assert not set(eng.free_pages) & set(eng.page_key)


BASE = dict(max_batch=3, max_len=96, page_size=8, fused_steps=4)
MODES = {
    "prefix": dict(prefix_cache=True),
    "chunk": dict(prefill_chunk=8),
    "prefix+chunk": dict(prefix_cache=True, prefill_chunk=8),
    "all, gather": dict(prefix_cache=True, prefill_chunk=8, kv_int8=True),
    "all, kernel": dict(prefix_cache=True, prefill_chunk=8, kv_int8=True, paged_kernel=True),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_modes_match_jax(weights, mode):
    want, got, eng = _both(weights, [WAVE1, WAVE2], **BASE, **MODES[mode])
    assert got[0] == want[0]
    assert got[1] == want[1]
    if eng.prefix_cache:
        # wave 2: every prompt of 25 tokens or more attaches the 3 shared pages
        assert got[1]["prefix_admission_hits"] >= 4
    if eng.prefill_chunk:
        # the 40-token prompt ingests in chunks of 8: more passes than prompts
        assert got[1]["prefills_run"] > len(WAVE1) + len(WAVE2) - 1
    _conserved(eng)


def test_prefix_hit_prefills_only_the_tail(weights, monkeypatch):
    """A hit's pass starts behind the cached pages (``_paged_prefill_prefixed``
    at t0 = the matched length) and emits the same tokens as a cold run."""
    _, _, params = weights
    cfg = TransformerConfig(**CFG)
    calls = []
    real = serving._paged_prefill_prefixed

    def spy(params_, tokens, kv, pages, t0, t_real, **kw):
        calls.append((t0, t_real))
        return real(params_, tokens, kv, pages, t0, t_real, **kw)

    monkeypatch.setattr(serving, "_paged_prefill_prefixed", spy)
    prompt = SHARED + [7, 8, 9, 10]
    cold, _ = _serve(InferenceEngine(params, cfg, device="cpu", **BASE), Request, [[prompt]])
    eng = InferenceEngine(params, cfg, device="cpu", prefix_cache=True, **BASE)
    warm, counters = _serve(eng, Request, [[prompt], [prompt]])
    assert warm[0] == warm[1] == cold[0]
    assert calls == [(24, 4)]
    assert counters["prefix_admission_hits"] == 1 and counters["prefix_hit_tokens"] == 24


def test_lru_eviction_under_a_small_pool(weights):
    """A pool too small to keep every cached page: the least recently used
    unreferenced page goes first, tokens still match the reference, and
    pages are conserved."""
    prompts = [RNG.integers(0, 97, 20).tolist() for _ in range(4)]
    waves = [[p] for p in prompts] + [[prompts[3]], [prompts[0]]]
    kw = dict(max_batch=1, max_len=40, page_size=8, n_pages=7, fused_steps=4,
              prefix_cache=True)
    want, got, eng = _both(weights, waves, **kw)
    assert got == want
    _conserved(eng)
    # prompts[3] was served last before its repeat: it hit; prompts[0]'s
    # pages were the oldest and were evicted before its repeat
    assert got[1]["prefix_admission_hits"] == 1
    digests = prefixdigest.page_digests(prompts[0], 8)
    assert digests[0] in eng.prefix_entries  # re-registered by the repeat
    assert len(eng.page_key) <= eng.n_pages - 1


def test_evicts_least_recently_used_unreferenced_page(weights):
    _, _, params = weights
    eng = InferenceEngine(params, TransformerConfig(**CFG), max_batch=1, max_len=32,
                          page_size=8, n_pages=4, prefix_cache=True, device="cpu")
    eng.free_pages = []
    for pg, key, t in ((1, b"a", 5), (2, b"b", 3), (3, b"c", 9)):
        eng.page_key[pg], eng.prefix_entries[key], eng.page_lru[pg] = key, pg, t
    eng.page_ref[2] = 1  # referenced: never evicted
    assert eng._alloc_page() == 1
    assert 1 not in eng.page_key and b"a" not in eng.prefix_entries
    assert eng._alloc_page() == 3
    assert eng._alloc_page() is None


def test_prefix_digests_byte_identical_to_reference():
    toks = RNG.integers(0, 32000, 70).tolist()
    for ps, aid, mx in ((16, 0, 0), (8, 3, 2), (7, 0, 0)):
        assert prefixdigest.page_digests(toks, ps, aid, mx) == jax_prefixdigest.page_digests(
            toks, ps, aid, mx)
    assert prefixdigest.prefix_seed(5) == jax_prefixdigest.prefix_seed(5)
    assert prefixdigest.token_bytes(toks) == jax_prefixdigest.token_bytes(toks)
    # the engine's chain over its int32 prompt rows is the same chain
    row = np.asarray(toks, np.int32)
    key = serving._prefix_seed(0)
    for j, want in enumerate(prefixdigest.page_digests(toks, 16)):
        key = serving._prefix_page_key(key, row[j * 16:(j + 1) * 16])
        assert key == want


def test_chunked_prefill_interleaves_with_decoding(weights):
    """A long prompt admitted beside a decoding slot ingests one chunk a
    step; the decoding slot keeps emitting meanwhile, and neither slot's
    tokens change."""
    _, _, params = weights
    cfg = TransformerConfig(**CFG)
    long_p = RNG.integers(0, 97, 60).tolist()
    short = [3, 9, 14]
    ref, _ = _serve(InferenceEngine(params, cfg, device="cpu", **BASE), Request,
                    [[short, long_p]], max_new=20)
    # the sequential loop: a step's decode chunk drains within the step
    eng = InferenceEngine(params, cfg, device="cpu", prefill_chunk=8, overlap=False, **BASE)
    a = eng.submit(Request(prompt=short, max_new_tokens=20))
    b = eng.submit(Request(prompt=long_p, max_new_tokens=20))
    eng._admit()
    assert eng.prefilling[1] and int(eng.lengths[1]) == 8 and len(a.output) == 1
    eng.step()  # one more chunk for b, one decode chunk for a
    assert int(eng.lengths[1]) == 16 and len(a.output) == 1 + eng.fused_steps
    assert not b.output
    eng.run_until_idle()
    assert [a.output, b.output] == ref[0]
    _conserved(eng)
