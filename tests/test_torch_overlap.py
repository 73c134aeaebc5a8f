"""Port parity for the overlapped serving engine (``overlap=True``, the
reference's default mode).

The port's engine in both modes and the JAX package's engine at
``overlap=True`` serve the same prompts on the same weights
(``bridge.params_from_jax``), float32: greedy tokens must be identical,
with several requests, a stop token found mid-chunk (the overshoot is
discarded), a cancel mid-stream, a spill and resume under pool pressure,
the prefix cache, int8 KV, chunked prefill and the paged-kernel path.
The reference runs behind ``reference_engine_copies_uploads``
(``tests/test_torch_engine.py``): its overlapped pipeline is the engine
that races on the CPU backend without it.

Port-only checks (the reference's ``tests/test_serve_overlap.py`` holds
the JAX engine to the same): steady-state chunks upload no batch state,
an admission refreshes only what it changed, zero-gap samples dominate
``host_gap_stats`` with overlap on, the serving loop drains the chunk in
flight before it parks, and the reference's engine options with their
defaults (``logprobs_k=5``, ``spec_ngram=3``) construct and serve.
"""

import time

import pytest
import torch

from elastic_gpu_scheduler_tpu.models.serving import (
    InferenceEngine as JaxEngine,
    Request as JaxRequest,
)
from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine, Request
from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig
from elastic_gpu_scheduler_tpu_torch.server.inference import EngineLoop

from test_torch_engine import (  # noqa: F401  (the autouse fixture)
    CFG,
    reference_engine_copies_uploads,
    weights,
)

# the suite runs in parallel worker processes: one intra-op thread keeps
# this file from crowding the workers that run beside it
torch.set_num_threads(1)

BASE = dict(max_batch=4, max_len=64, page_size=8, fused_steps=4)
MULTI = [([3, 9, 14], 12), ([2, 4, 6, 8, 10], 9), ([60, 2, 33], 15), ([1] * 12, 7),
         ([5, 17, 3, 44], 10), ([42], 8)]


def _serve(eng, request_cls, specs):
    reqs = [eng.submit(request_cls(prompt=list(p), max_new_tokens=n, **extra))
            for p, n, *rest in specs for extra in [rest[0] if rest else {}]]
    eng.run_until_idle(max_steps=100_000)
    for r in reqs:
        assert r.done.is_set() and not r.error, r.error
    return [list(r.output) for r in reqs]


def _three(weights, specs, **kw):
    """(JAX overlap=True, port overlap=False, port overlap=True) outputs,
    and the port's overlapped engine."""
    jcfg, jp, params = weights
    kw = dict(BASE, **kw)
    jax_on = _serve(JaxEngine(jp, jcfg, overlap=True, **kw), JaxRequest, specs)
    cfg = TransformerConfig(**CFG)
    off = _serve(InferenceEngine(params, cfg, device="cpu", overlap=False, **kw), Request, specs)
    eng = InferenceEngine(params, cfg, device="cpu", **kw)  # overlap=True: the default
    on = _serve(eng, Request, specs)
    return jax_on, off, on, eng


def _conserved(eng):
    unref_cached = [pg for pg in eng.page_key if eng.page_ref[pg] == 0]
    assert not eng.page_ref.any()
    assert len(eng.free_pages) + len(unref_cached) == eng.n_pages - 1
    assert eng._pending is None


MODES = {
    "gather": {},
    "paged kernel": dict(paged_kernel=True),
    "int8 KV": dict(kv_int8=True, paged_kernel=True),
    "chunked prefill": dict(prefill_chunk=4, max_batch=3),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_overlap_greedy_tokens_match_sequential_and_jax(weights, mode):
    jax_on, off, on, eng = _three(weights, MULTI, **MODES[mode])
    assert on == off == jax_on
    assert [len(t) for t in on] == [n for _, n in MULTI]
    assert eng.overlap and eng.host_gap_stats()["chunks"] > 0
    _conserved(eng)


def test_overlap_stop_token_mid_chunk_discards_overshoot(weights):
    """A stop token landing mid-chunk is found one chunk late under
    overlap: the overshoot chunk's rows are discarded at its drain and the
    stream still ends exactly where the sequential loop ends it."""
    _, _, params = weights
    cfg = TransformerConfig(**CFG)
    full = _serve(InferenceEngine(params, cfg, device="cpu", overlap=False, **BASE), Request,
                  [([3, 9, 14], 12)])[0]
    stop = full[5]  # mid second chunk of four steps
    want = full[: full.index(stop) + 1]
    specs = [([3, 9, 14], 12, dict(stop_tokens=(stop,))), ([2, 4, 6, 8], 14)]
    jax_on, off, on, eng = _three(weights, specs)
    assert on == off == jax_on
    assert on[0] == want
    assert eng.chunks_discarded >= 1
    _conserved(eng)


def test_overlap_cancel_mid_stream(weights):
    """Cancel with a chunk in flight: the request ends, its tokens are a
    prefix of its uncancelled stream (the overshoot is never emitted) and
    the companion's stream is untouched."""
    _, _, params = weights
    cfg = TransformerConfig(**CFG)
    specs = [([3, 9, 14], 30), ([2, 4, 6], 12)]
    full = _serve(InferenceEngine(params, cfg, device="cpu", overlap=False, **BASE), Request,
                  specs)
    eng = InferenceEngine(params, cfg, device="cpu", **BASE)
    victim = eng.submit(Request(prompt=[3, 9, 14], max_new_tokens=30))
    other = eng.submit(Request(prompt=[2, 4, 6], max_new_tokens=12))
    eng._admit()
    for _ in range(3):
        eng.step()
    assert eng._pending is not None and not victim.done.is_set()
    victim.cancel()
    eng.run_until_idle(max_steps=100_000)
    assert victim.done.is_set() and not other.error
    assert list(other.output) == full[1]
    n = len(victim.output)
    assert 0 < n < 30 and list(victim.output) == full[0][:n]
    assert all(s is None for s in eng.slots)
    _conserved(eng)


def _contended(make, request_cls):
    """Drive one request into page pressure, then submit a higher-priority
    one: the first spills with a chunk in flight and resumes."""
    eng = make()
    victim = eng.submit(request_cls(prompt=[3, 9, 14, 27, 5, 1, 2, 6], max_new_tokens=30,
                                    priority=0))
    for _ in range(40):
        eng._admit()
        eng.step()
        if len(eng.free_pages) == 0:
            break
    assert not victim.done.is_set()
    high = eng.submit(request_cls(prompt=[2, 4, 6, 8, 10, 12, 1, 7], max_new_tokens=8,
                                  priority=5))
    eng.run_until_idle(max_steps=100_000)
    assert not victim.error and not high.error
    assert eng.spills >= 1
    return [list(victim.output), list(high.output)]


def test_overlap_spill_and_resume_matches_sequential_and_jax(weights):
    jcfg, jp, params = weights
    cfg = TransformerConfig(**CFG)
    kw = dict(max_batch=2, max_len=64, page_size=8, n_pages=6, fused_steps=2)
    jax_on = _contended(lambda: JaxEngine(jp, jcfg, overlap=True, **kw), JaxRequest)
    off = _contended(lambda: InferenceEngine(params, cfg, device="cpu", overlap=False, **kw),
                     Request)
    on = _contended(lambda: InferenceEngine(params, cfg, device="cpu", **kw), Request)
    assert on == off == jax_on
    # and the victim's stream equals an uncontended run's
    solo = _serve(InferenceEngine(params, cfg, device="cpu", max_batch=2, max_len=64,
                                  page_size=8, n_pages=9, fused_steps=4),
                  Request, [([3, 9, 14, 27, 5, 1, 2, 6], 30)])
    assert on[0] == solo[0]


def test_overlap_prefix_cache_matches_cold_and_jax(weights):
    """Cache hits under the overlapped engine: the second run of a prompt
    attaches two full pages and gives the cold run's tokens."""
    jcfg, jp, params = weights
    cfg = TransformerConfig(**CFG)
    prompt = list(range(1, 21))
    cold = _serve(InferenceEngine(params, cfg, device="cpu", **BASE), Request,
                  [(prompt, 10)])[0]
    outs = {}
    for name, eng, req in (
        ("port", InferenceEngine(params, cfg, device="cpu", prefix_cache=True, **BASE),
         Request),
        ("jax", JaxEngine(jp, jcfg, overlap=True, prefix_cache=True, **BASE), JaxRequest),
    ):
        first = _serve(eng, req, [(prompt, 10)])[0]
        second = _serve(eng, req, [(prompt, 10)])[0]
        outs[name] = (first, second, int(eng.prefix_hit_tokens))
    assert outs["port"] == outs["jax"] == (cold, cold, 16)


def test_steady_state_decode_uploads_nothing(weights):
    """Once the batch settles, decode chunks refresh no batch state: the
    dispatch rides the device mirrors and the carry.  One page a slot
    (page_size == max_len), so no table growth moves the view."""
    _, _, params = weights
    eng = InferenceEngine(params, TransformerConfig(**CFG), max_batch=2, max_len=64,
                          page_size=64, fused_steps=4, device="cpu")
    reqs = [eng.submit(Request(prompt=[3, 9, 14], max_new_tokens=40)),
            eng.submit(Request(prompt=[2, 4, 6, 8], max_new_tokens=40))]
    eng._admit()
    eng.step()  # the first chunk pays the mirror uploads
    eng.step()  # the carry adopted, the mirrors warm
    flat = eng.device_uploads
    for _ in range(5):
        eng.step()
        assert eng.device_uploads == flat
    eng.run_until_idle(max_steps=100_000)
    assert all(not r.error and len(r.output) == 40 for r in reqs)


def test_admission_refreshes_only_changed_state(weights):
    _, _, params = weights
    eng = InferenceEngine(params, TransformerConfig(**CFG), max_batch=2, max_len=64,
                          page_size=64, fused_steps=4, device="cpu")
    eng.submit(Request(prompt=[3, 9, 14], max_new_tokens=60))
    eng._admit()
    eng.step()
    eng.step()
    flat = eng.device_uploads
    eng.step()
    assert eng.device_uploads == flat
    eng.submit(Request(prompt=[7, 7, 7], max_new_tokens=8))
    eng._admit()  # the batch changed: the next dispatch refreshes what did
    eng.step()
    # the table view, the active mask, the prompts, the prompt lengths and
    # one carry patch; temperatures and filters did not change
    assert eng.device_uploads == flat + 5
    eng.step()
    settled = eng.device_uploads
    eng.step()
    assert eng.device_uploads == settled


def _gap_samples(params, overlap):
    eng = InferenceEngine(params, TransformerConfig(**CFG), overlap=overlap, device="cpu",
                          **BASE)
    eng.submit(Request(prompt=[3, 9, 14], max_new_tokens=24))
    eng.submit(Request(prompt=[5, 6], max_new_tokens=20))
    eng.run_until_idle(max_steps=100_000)
    stats = eng.host_gap_stats()
    assert stats["chunks"] > 0 and stats["overlap"] is overlap
    samples = eng.drain_host_gaps()
    assert len(samples) == stats["chunks"] and not eng.drain_host_gaps()
    return stats, samples


def test_host_gap_zero_samples_dominate_with_overlap(weights):
    _, _, params = weights
    on, on_samples = _gap_samples(params, True)
    off, off_samples = _gap_samples(params, False)
    assert sum(s == 0.0 for s in on_samples) > len(on_samples) / 2
    assert all(s > 0.0 for s in off_samples)
    assert on["mean_ms"] < off["mean_ms"]


def test_engine_loop_drains_in_flight_chunk_before_parking(weights):
    _, _, params = weights
    eng = InferenceEngine(params, TransformerConfig(**CFG), device="cpu", **BASE)
    loop = EngineLoop(eng).start()
    try:
        r1 = eng.submit(Request(prompt=[3, 9, 14], max_new_tokens=6))
        assert r1.done.wait(60) and not r1.error
        # the loop cleared `parked` when it woke for r1, before r1 finished:
        # set now, it marks a park after r1 (a park counted before r1 was
        # submitted would pass a wait on idle_parks with r1's last chunk
        # still in flight)
        assert loop.parked.wait(10)
        assert loop.idle_parks >= 1
        assert eng._pending is None  # drained before it parked
        parks = loop.idle_parks
        time.sleep(0.3)
        assert loop.idle_parks - parks <= 1  # parked, not spinning
        r2 = eng.submit(Request(prompt=[2, 4, 6], max_new_tokens=6))
        assert r2.done.wait(60) and not r2.error
    finally:
        loop.stop()
    assert not loop._thread.is_alive()


def test_reference_default_options_construct_and_serve(weights):
    """The reference's defaults, passed by name (its serve always passes
    ``logprobs_k``), are options of the port's engine too."""
    _, _, params = weights
    cfg = TransformerConfig(**CFG)
    eng = InferenceEngine(params, cfg, device="cpu", overlap=True, logprobs_k=5,
                          spec_ngram=3, **BASE)
    assert (eng.overlap, eng.logprobs_k, eng.spec_ngram, eng.spec_k) == (True, 5, 3, 0)
    got = _serve(eng, Request, MULTI[:3])
    want = _serve(InferenceEngine(params, cfg, device="cpu", overlap=False, **BASE), Request,
                  MULTI[:3])
    assert got == want
    with pytest.raises(TypeError, match="unknown engine options"):
        InferenceEngine(params, cfg, device="cpu", no_such_option=1)


def test_serve_flags_select_the_engine_modes():
    """``serve``'s --serve-overlap (default on) and --spec-k, under the
    reference's names and defaults."""
    from elastic_gpu_scheduler_tpu_torch.serve import build_args

    args = build_args(["--init"])
    assert (args.serve_overlap, args.spec_k) == ("on", 0)
    args = build_args(["--init", "--serve-overlap", "off", "--spec-k", "4"])
    assert (args.serve_overlap, args.spec_k) == ("off", 4)
    with pytest.raises(SystemExit):
        build_args(["--init", "--serve-overlap", "maybe"])
