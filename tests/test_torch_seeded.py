"""Seeded sampling in the port: self-consistency, not JAX's bits.

A seeded request's uniforms come from a counter-based hash of (seed,
position, vocab index) in exact integer arithmetic
(``sampling.seeded_uniforms``), so its tokens must not depend on the
batch around it, its slot, the engine mode (sequential, overlapped,
``spec_k``, int8 + prefix + chunked), a fresh engine, or a spill and
resume; another seed gives another stream, a greedy request ignores its
seed, and the HTTP layer's ``n`` choices draw with seed + k.  The hash
must give the golden vector below on any device (the card tests hold
the card to it).
"""

import http.client
import json

import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu_torch.models import sampling
from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine, Request
from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig, init_params
from elastic_gpu_scheduler_tpu_torch.server.inference import serve_inference

# the suite runs in parallel worker processes: one intra-op thread keeps
# this file from crowding the workers that run beside it
torch.set_num_threads(1)

CFG = TransformerConfig(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                        d_ff=128, dtype="float32")
BASE = dict(max_batch=4, max_len=64, page_size=8, fused_steps=4)
PROMPT = [5, 17, 3, 44]
SEEDED = dict(temperature=0.9, seed=1234)

# seeded_bits(seeds, positions, 5) for these (seed, position) rows
GOLDEN_ROWS = [(0, 0), (1, 0), (12345, 7), (2 ** 32 - 1, 2 ** 31 - 1)]
GOLDEN_BITS = [
    [2715602470, 3018101312, 2068194199, 2643081366, 1542255554],
    [2783676248, 3925587121, 2869577357, 2491144862, 3174878903],
    [1513388740, 1930143743, 3975773601, 3697108420, 1291943146],
    [1687246876, 2113594901, 4152827996, 1028600257, 1012037608],
]


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), "cpu")


def _run(params, specs, n_new=14, **kw):
    eng = InferenceEngine(params, CFG, device="cpu", **dict(BASE, **kw))
    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=n_new, **extra))
            for p, extra in specs]
    eng.run_until_idle(max_steps=100_000)
    for r in reqs:
        assert r.done.is_set() and not r.error, r.error
    return [r.output for r in reqs], eng


def test_seeded_uniforms_golden_vector():
    seeds = torch.tensor([s for s, _ in GOLDEN_ROWS])
    positions = torch.tensor([p for _, p in GOLDEN_ROWS])
    assert sampling.seeded_bits(seeds, positions, 5).tolist() == GOLDEN_BITS
    u = sampling.seeded_uniforms(seeds, positions, 5)
    assert u.dtype == torch.float32
    want = ((np.asarray(GOLDEN_BITS, np.int64) >> 9) * 2 + 1) * 2.0 ** -24
    np.testing.assert_array_equal(u.numpy().astype(np.float64), want)
    # int32 positions (the engine's) give the same bits
    assert sampling.seeded_bits(seeds, positions.to(torch.int32), 5).tolist() == GOLDEN_BITS


def test_seeded_uniforms_are_uniform_and_distinct():
    u = sampling.seeded_uniforms(torch.arange(32), torch.arange(32) * 3, 4096)
    assert 0 < float(u.min()) and float(u.max()) < 1
    hist = np.histogram(u.numpy().ravel(), bins=64, range=(0, 1))[0]
    expect = u.numel() / 64
    assert ((hist - expect) ** 2 / expect).sum() < 130  # chi-square, 63 dof
    # neighbouring seeds and positions give unrelated rows
    assert len({tuple(r.tolist()) for r in (u[:, :8] * 2 ** 24).long()}) == 32


def test_categorical_seeded_rows_keep_the_generator_stream():
    logits = torch.randn(3, 50, generator=torch.Generator().manual_seed(1))
    row_seeds = (torch.tensor([7, 0, 9]), torch.tensor([True, False, True]),
                 torch.tensor([4, 4, 11]))
    a = sampling.categorical(logits, torch.Generator().manual_seed(5), row_seeds)
    b = sampling.categorical(logits, torch.Generator().manual_seed(6), row_seeds)
    plain = sampling.categorical(logits, torch.Generator().manual_seed(5))
    assert a[0] == b[0] and a[2] == b[2]  # seeded rows: the generator plays no part
    assert a[1] == plain[1]  # the unseeded row draws what it drew without seeds
    # the seeded draw is Gumbel-max on the hash's uniforms
    u = sampling.seeded_uniforms(row_seeds[0], row_seeds[2], 50)
    want = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
    assert a[0] == want[0] and a[2] == want[2]


def test_seeded_stream_independent_of_batch_slot_mode_and_engine(params):
    """The same seeded request alone, batched (in the last slot), under
    overlap, under spec_k, in the int8 + prefix + chunked mode, and from
    a fresh engine: the same tokens."""
    others = [([9, 9, 9], dict(temperature=0.7)), ([60, 2], {}),
              ([33, 1, 80], dict(temperature=1.1, top_k=20))]
    filtered = dict(SEEDED, top_k=30, top_p=0.9)
    want, _ = _run(params, [(PROMPT, SEEDED), (PROMPT, filtered)], overlap=False)
    runs = {
        "alone, overlap": ([(PROMPT, SEEDED), (PROMPT, filtered)], dict(overlap=True)),
        "batched, last slots": (others[:2] + [(PROMPT, SEEDED), (PROMPT, filtered)],
                                dict(overlap=False)),
        "batched, overlap": (others + [(PROMPT, SEEDED), (PROMPT, filtered)], {}),
        "spec_k 3": (others + [(PROMPT, SEEDED), (PROMPT, filtered)], dict(spec_k=3)),
        "int8 prefix chunked": ([(PROMPT, SEEDED), (PROMPT, filtered)],
                                dict(kv_int8=True, prefix_cache=True, prefill_chunk=2,
                                     paged_kernel=True)),
    }
    for name, (specs, kw) in runs.items():
        outs, _ = _run(params, specs, **kw)
        assert outs[-2:] == want, name
    again, _ = _run(params, [(PROMPT, SEEDED), (PROMPT, filtered)], overlap=False)
    assert again == want


def test_seeded_stream_survives_spill_and_resume(params):
    """A seeded sampled request spilled under page pressure resumes with
    exactly the tokens of an uncontended run (positions, and with them
    its draws, are unchanged by the re-prefill)."""
    victim_prompt = [3, 9, 14, 27, 5, 1, 2, 6]
    solo, _ = _run(params, [(victim_prompt, SEEDED)], n_new=30, overlap=False)
    for overlap in (False, True):
        eng = InferenceEngine(params, CFG, device="cpu", overlap=overlap, max_batch=2,
                              max_len=64, page_size=8, n_pages=6, fused_steps=2)
        victim = eng.submit(Request(prompt=victim_prompt, max_new_tokens=30, **SEEDED))
        for _ in range(40):
            eng._admit()
            eng.step()
            if len(eng.free_pages) == 0:
                break
        assert not victim.done.is_set()
        eng.submit(Request(prompt=[2, 4, 6, 8, 10, 12, 1, 7], max_new_tokens=8, priority=5))
        eng.run_until_idle(max_steps=100_000)
        assert eng.spills >= 1 and not victim.error
        assert victim.output == solo[0], f"overlap={overlap}"


def test_other_seed_other_stream_and_greedy_ignores_seed(params):
    outs, eng = _run(params, [(PROMPT, SEEDED), (PROMPT, dict(SEEDED, seed=1235)),
                              (PROMPT, dict(seed=99)), (PROMPT, {})], n_new=20)
    assert outs[0] != outs[1]
    assert outs[2] == outs[3]  # greedy: the seed is dropped at submit
    # an unseeded sampled request draws from the engine's stream instead
    unseeded, _ = _run(params, [(PROMPT, dict(temperature=0.9))], n_new=20)
    assert unseeded[0] != outs[0]


def test_n_choices_draw_with_seed_plus_k(params):
    eng = InferenceEngine(params, CFG, device="cpu", **BASE)
    server, loop = serve_inference(eng, port=0, host="127.0.0.1")
    try:
        conn = http.client.HTTPConnection(*server.server_address, timeout=60)
        body = {"prompt": PROMPT, "max_tokens": 10, "n": 3, "seed": 40, "temperature": 0.9}
        conn.request("POST", "/v1/completions", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        out = json.loads(resp.read())
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()
    assert resp.status == 200
    assert [c["index"] for c in out["choices"]] == [0, 1, 2]
    want, _ = _run(params, [(PROMPT, dict(temperature=0.9, seed=40 + k)) for k in range(3)],
                   n_new=10)
    assert [c["tokens"] for c in out["choices"]] == want
    assert len({tuple(t) for t in want}) == 3
