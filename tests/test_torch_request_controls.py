"""Port parity for the per-request controls: logit_bias, allowed_tokens,
frequency and presence penalties, min_tokens and logprobs.

The JAX package's ``InferenceEngine`` in its sequential mode
(``overlap=False``) and the port's engine serve one mixed batch of
controlled requests on the same weights (``bridge.params_from_jax``),
float32.  In every engine mode the port serves (sequential, overlapped,
``spec_k=3``, int8 + prefix cache + chunked prefill) the greedy tokens
must be identical to the sequential JAX engine's with the same options,
and the logprobs
(the prefill's first emission included) must match: the same top ids,
and values within 1e-5.  A penalised ``min_tokens`` request spilled and
resumed under page pressure, and the bias and stop rows against the
reference's own, complete the file.

The reference runs behind ``reference_engine_copies_uploads``
(``tests/test_torch_engine.py``).
"""

import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.models import serving as jax_serving
from elastic_gpu_scheduler_tpu.models.serving import (
    InferenceEngine as JaxEngine,
    Request as JaxRequest,
)
from elastic_gpu_scheduler_tpu_torch.models import serving
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

TOL = 1e-5
BASE = dict(max_batch=4, max_len=64, page_size=8, fused_steps=4)
MODES = {
    "sequential": dict(overlap=False),
    "overlapped": dict(overlap=True),
    "spec_k 3": dict(overlap=False, spec_k=3),
    "int8 prefix chunked": dict(overlap=False, kv_int8=True, prefix_cache=True,
                                prefill_chunk=8, paged_kernel=True),
}
SHARED = list(range(1, 18))  # two full pages: the prefix mode's second wave hits them


def _specs(stop_ids):
    """One mixed batch: every control, some with logprobs, more requests
    than slots, one prompt of a single token (fed by the chunks) and two
    on a shared prefix."""
    return [
        ([5, 17, 3], 10, dict(logit_bias={4: 2.5, 11: -3.0, 60: 1.5}, logprobs=3)),
        (SHARED + [40], 9, dict(allowed_tokens=(1, 2, 3, 50, 60), logprobs=2)),
        ([9], 12, dict(frequency_penalty=0.9)),
        ([60, 2, 33, 8], 11, dict(presence_penalty=1.3, frequency_penalty=0.2, logprobs=4)),
        ([2, 3], 12, dict(min_tokens=7, stop_tokens=stop_ids)),
        (SHARED + [7, 7], 8, dict(logprobs=5)),
    ]


def _serve(eng, request_cls, specs):
    reqs = [eng.submit(request_cls(prompt=list(p), max_new_tokens=n, **extra))
            for p, n, extra in specs]
    eng.run_until_idle(max_steps=100_000)
    for r in reqs:
        assert r.done.is_set() and not r.error, r.error
    return reqs


def _stop_ids(params):
    """Two ids the min_tokens request's unconstrained greedy stream emits
    early (so the floor has something to hold back)."""
    eng = InferenceEngine(params, TransformerConfig(**CFG), device="cpu", overlap=False, **BASE)
    out = _serve(eng, Request, [([2, 3], 12, {})])[0].output
    return (out[0], out[2])


def _same_logprobs(got, want):
    assert len(got.token_logprobs) == len(want.token_logprobs) == len(want.output)
    np.testing.assert_allclose(got.token_logprobs, want.token_logprobs, atol=TOL, rtol=0)
    for g, w in zip(got.top_logprobs, want.top_logprobs):
        assert [t for t, _ in g] == [t for t, _ in w]
        np.testing.assert_allclose([lp for _, lp in g], [lp for _, lp in w], atol=TOL, rtol=0)


@pytest.mark.parametrize("mode", list(MODES))
def test_controls_match_jax_in_every_mode(weights, mode):
    jcfg, jp, params = weights
    kw = dict(BASE, **MODES[mode])
    specs = _specs(_stop_ids(params))
    jeng = JaxEngine(jp, jcfg, **dict(kw, overlap=False))
    peng = InferenceEngine(params, TransformerConfig(**CFG), device="cpu", **kw)
    want = _serve(jeng, JaxRequest, specs)
    got = _serve(peng, Request, specs)
    if mode == "int8 prefix chunked":
        # a second wave on the shared prefix: cache hits, controls unchanged
        want += _serve(jeng, JaxRequest, specs[1:2])
        got += _serve(peng, Request, specs[1:2])
        assert peng.prefix_admission_hits >= 1
    assert [r.output for r in got] == [r.output for r in want]
    for g, w in zip(got, want):
        if w.logprobs:
            _same_logprobs(g, w)
        else:
            assert g.token_logprobs == g.top_logprobs == []
    # the controls held: allowed ids only, no stop id before the floor
    assert set(got[1].output) <= {1, 2, 3, 50, 60}
    stop_ids = specs[4][2]["stop_tokens"]
    assert not set(got[4].output[:6]) & set(stop_ids)
    if mode == "sequential":
        # every control bit: each controlled stream differs from its plain run
        plain = _serve(InferenceEngine(params, TransformerConfig(**CFG), device="cpu", **kw),
                       Request, [(p, n, {}) for p, n, _ in specs])
        assert all(g.output != q.output for g, q in zip(got[:5], plain[:5]))
    if mode == "spec_k 3":
        assert peng.spec_passes == jeng.spec_passes > 0
    assert len(peng.free_pages) + len(peng.page_key) == peng.n_pages - 1


def _contended(make, request_cls, victim_kw):
    """A penalised min_tokens request driven into page pressure, then a
    higher-priority request: the first spills and resumes."""
    eng = make()
    victim = eng.submit(request_cls(prompt=[3, 9, 14, 27, 5, 1, 2, 6], max_new_tokens=30,
                                    priority=0, **victim_kw))
    for _ in range(40):
        eng._admit()
        eng.step()
        if len(eng.free_pages) == 0:
            break
    assert not victim.done.is_set()
    high = eng.submit(request_cls(prompt=[2, 4, 6, 8, 10, 12, 1, 7], max_new_tokens=8,
                                  priority=5, logprobs=2))
    eng.run_until_idle(max_steps=100_000)
    assert not victim.error and not high.error
    assert eng.spills >= 1
    return victim, high


def test_penalised_min_tokens_request_spills_and_resumes_like_jax(weights):
    jcfg, jp, params = weights
    cfg = TransformerConfig(**CFG)
    solo_eng = InferenceEngine(params, cfg, device="cpu", overlap=False, **BASE)
    solo = _serve(solo_eng, Request, [([3, 9, 14, 27, 5, 1, 2, 6], 30, {})])[0].output
    # min_tokens reaches past the spill, with a stop id the stream holds
    victim_kw = dict(frequency_penalty=0.6, presence_penalty=0.3, min_tokens=20,
                     stop_tokens=(solo[3],), logprobs=3)
    kw = dict(max_batch=2, max_len=64, page_size=8, n_pages=6, fused_steps=2)
    outs = {}
    for name, make, cls in (
        ("jax", lambda: JaxEngine(jp, jcfg, overlap=False, **kw), JaxRequest),
        ("port", lambda: InferenceEngine(params, cfg, device="cpu", overlap=False, **kw),
         Request),
        ("port overlap", lambda: InferenceEngine(params, cfg, device="cpu", **kw), Request),
    ):
        outs[name] = _contended(make, cls, victim_kw)
    jv, jh = outs["jax"]
    for name in ("port", "port overlap"):
        v, h = outs[name]
        assert v.output == jv.output and h.output == jh.output, name
        _same_logprobs(v, jv)
        _same_logprobs(h, jh)
    assert solo[3] not in jv.output[:19]
    # an uncontended run of the same request gives the same stream
    free = InferenceEngine(params, cfg, device="cpu", overlap=False, **BASE)
    alone = _serve(free, Request, [([3, 9, 14, 27, 5, 1, 2, 6], 30, victim_kw)])[0]
    assert alone.output == outs["port"][0].output


@pytest.mark.parametrize("kind", ["bias", "allowed", "allowed with bias", "stop"])
def test_bias_and_stop_rows_equal_the_reference(kind):
    V = 97
    fields = {
        "bias": dict(logit_bias={3: 1.5, 90: -2.25, 4: 1e6}),
        "allowed": dict(allowed_tokens=(0, 7, 96)),
        "allowed with bias": dict(allowed_tokens=(5, 6), logit_bias={5: -1e12, 6: 3.0, 8: 9.0}),
        "stop": dict(stop_tokens=(3, 50, 200, -1)),
    }[kind]
    req = Request(prompt=[1], max_new_tokens=1, **fields)
    jreq = JaxRequest(prompt=[1], max_new_tokens=1, **fields)
    pairs = [(serving._bias_row, jax_serving._bias_row),
             (serving._stop_row, jax_serving._stop_row)]
    for port_fn, ref_fn in pairs:
        got, want = port_fn(req, V), ref_fn(jreq, V)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    # the memoised rows are the same object, made once
    row = serving._bias_row_cached(req, V)
    assert serving._bias_row_cached(req, V) is row
    np.testing.assert_array_equal(row, jax_serving._bias_row_cached(jreq, V))
    np.testing.assert_array_equal(serving._stop_row_cached(req, V),
                                  jax_serving._stop_row_cached(jreq, V))


def test_logprob_rows_equal_the_reference():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    lg = (rng.standard_normal((3, 4, 97)) * 3).astype(np.float32)
    chosen = rng.integers(0, 97, (3, 4)).astype(np.int32)
    want = jax_serving._logprob_rows(jnp.asarray(lg), jnp.asarray(chosen), 5)
    got = serving._logprob_rows(torch.from_numpy(lg), torch.from_numpy(chosen), 5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=TOL, rtol=0)
    assert got[1].tolist() == np.asarray(want[1]).tolist()
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=TOL, rtol=0)


@pytest.mark.parametrize("field,value,match", [
    ("seed", 1.5, "seed must be an integer"),
    ("seed", True, "seed must be an integer"),
    ("frequency_penalty", float("nan"), "finite"),
    ("presence_penalty", float("inf"), "finite"),
    ("allowed_tokens", (1, 97), "allowed_tokens"),
    ("logit_bias", {97: 1.0}, "logit_bias"),
    ("logit_bias", {3: float("nan")}, "logit_bias"),
])
def test_invalid_controls_fail_like_the_reference(weights, field, value, match):
    jcfg, jp, params = weights
    peng = InferenceEngine(params, TransformerConfig(**CFG), device="cpu", **BASE)
    jeng = JaxEngine(jp, jcfg, overlap=False, **BASE)
    kw = {field: value, "temperature": 0.5}
    got = peng.submit(Request(prompt=[1, 2], max_new_tokens=2, **kw))
    want = jeng.submit(JaxRequest(prompt=[1, 2], max_new_tokens=2, **kw))
    assert got.done.is_set() and match in got.error
    assert got.error == want.error


def test_seed_and_logprobs_normalised_like_the_reference(weights):
    _, _, params = weights
    eng = InferenceEngine(params, TransformerConfig(**CFG), device="cpu", logprobs_k=3, **BASE)
    greedy = Request(prompt=[1], max_new_tokens=1, seed=7, logprobs=9)
    sampled = Request(prompt=[1], max_new_tokens=1, seed=2 ** 40 + 5, temperature=0.7)
    for r in (greedy, sampled):
        assert eng._invalid_reason(r) is None
    assert greedy.seed is None and greedy.logprobs == 3
    assert sampled.seed == 5
    off = InferenceEngine(params, TransformerConfig(**CFG), device="cpu", logprobs_k=0, **BASE)
    r = off.submit(Request(prompt=[1], max_new_tokens=1, logprobs=1))
    assert r.error == "engine built with logprobs_k=0 (logprobs off)"
