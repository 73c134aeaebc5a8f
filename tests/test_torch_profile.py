"""The port's workload profiler against the reference's, and the
profiling of the port's serving engine.

``elastic_gpu_scheduler_tpu_torch.profile`` is an own copy of the part of
the reference's profiler a serving replica runs.  Seeded step-sample
streams (several classes and generations, co-tenant classes from the
identity or the sample, stride sampling, a capped ring) must give an
equal ``debug_state`` and series-equal ``tpu_workload_*`` /
``tpu_interference_*`` gauges.  Then the port's counterparts of the
reference's ``tests/test_profile_serving.py``: profiling adds no
host-to-device upload, the engine loop records samples (served on
``/debug/profiles``), the host-gap histogram is on ``/metrics`` and a
scrape drains the engine's gap buffer.
"""

import http.client
import json

import numpy as np
import pytest
import torch

from conftest import poll
from elastic_gpu_scheduler_tpu import profile as ref_profile
from elastic_gpu_scheduler_tpu_torch import profile as port_profile
from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine, Request
from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig, init_params
from elastic_gpu_scheduler_tpu_torch.profile import PROFILER
from elastic_gpu_scheduler_tpu_torch.server.inference import serve_inference

from test_torch_metrics import series

torch.set_num_threads(1)

PACKAGES = {"ref": ref_profile, "port": port_profile}


@pytest.fixture(autouse=True)
def _restore_gauge_refreshers():
    """A new WorkloadProfiler takes the gauges' refresher: hand it back to
    each package's process-global profiler."""
    yield
    for m in PACKAGES.values():
        m.PROFILE_TOKENS.refresher = m.PROFILER._refresh_gauges


def _samples(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        kw = {
            "tokens": int(rng.integers(0, 129)),
            "wall_s": float(rng.choice([0.0, rng.exponential(0.02)])),
            "slots_active": int(rng.integers(0, 9)),
            "slots_total": 8,
            "host_gap_ms": float(rng.exponential(0.5)),
            "queue_depth": int(rng.integers(0, 5)),
            "hbm_pages": int(rng.integers(0, 400)),
        }
        pick = rng.random()
        if pick < 0.3:
            kw.update(wclass=str(rng.choice(["serve", "batch"])),
                      generation=str(rng.choice(["nvidia-h100-80gb-hbm3", "cpu"])),
                      chips=int(rng.integers(1, 3)))
        elif pick < 0.5:
            kw["neighbors"] = tuple(rng.choice(["noisy", "train"], int(rng.integers(0, 3)),
                                               replace=False))
        out.append(kw)
    return out


def _drive(m, seed: int, sample: float, neighbors: tuple):
    prof = m.WorkloadProfiler()
    prof.configure(sample=sample)
    prof.set_identity(pod="ns/serve-0", wclass="serve", generation="nvidia-h100-80gb-hbm3",
                      chips=1, neighbors=neighbors)
    prof._cap = 150
    captured = [prof.record_step(**kw) for kw in _samples(seed, 400)]
    state = prof.debug_state()
    for kw in _samples(seed + 100, 80):
        prof.record_step(**kw)
    prof._refresh_gauges()
    gauges = "\n".join(line for g in (m.PROFILE_TOKENS, m.INTERFERENCE_RATIO)
                       for line in super(type(g), g).collect()) + "\n"
    return captured, state, prof.debug_state(), prof.interference_matrix(), series(gauges)


@pytest.mark.parametrize("seed,sample,neighbors", [
    (0, 1.0, ()), (1, 0.25, ()), (2, 1.0, ("noisy",)), (3, 0.5, ("noisy", "train")),
])
def test_debug_state_matches(seed, sample, neighbors):
    ref = _drive(ref_profile, seed, sample, neighbors)
    port = _drive(port_profile, seed, sample, neighbors)
    assert port == ref
    captured, state, final, matrix, gauges = port
    assert sum(captured) == round(400 * sample)
    assert set(state["profiles"]) >= {"serve"} and state["identity"]["chips"] == 1
    assert sorted(state) == sorted(ref[1])
    if neighbors:
        assert set(matrix["serve"]) >= set(neighbors)


def test_disabled_and_reset_match():
    out = {}
    for name, m in PACKAGES.items():
        prof = m.WorkloadProfiler()
        prof.configure(sample=0.0)
        off = prof.record_step(tokens=1, wall_s=0.01)
        prof.configure(sample=1.0)
        prof.record_step(tokens=4, wall_s=0.01, wclass="c")
        before = prof.debug_state()
        prof.reset()
        out[name] = (off, before, prof.debug_state())
    assert out["port"] == out["ref"]
    assert out["port"][0] is False and out["port"][2]["profiles"] == {}


# -- the port's serving engine under the profiler ---------------------------


CFG = TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
                        dtype="float32")


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), "cpu")


@pytest.fixture()
def profiler():
    PROFILER.configure(sample=1.0)
    PROFILER.reset()
    PROFILER.set_identity(pod="default/serve-0", wclass="serve", generation="cpu", chips=1)
    yield PROFILER
    PROFILER.reset()
    PROFILER.set_identity()
    port_profile.configure_from_env()


def make_engine(params, **kw):
    return InferenceEngine(params, CFG, **{**dict(max_batch=4, max_len=64, page_size=8,
                                                  fused_steps=4, device="cpu"), **kw})


def _post(addr, path, body=None):
    conn = http.client.HTTPConnection(*addr, timeout=120)
    if body is None:
        conn.request("GET", path)
    else:
        conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


@pytest.mark.parametrize("overlap", [False, True])
def test_profiling_adds_zero_device_uploads(params, profiler, overlap):
    """The same traffic through the engine loop with every plane off and
    on: the engine's upload count is equal, since samples and spans read
    host counters only."""
    from elastic_gpu_scheduler_tpu_torch.tracing import TRACER

    uploads = {}
    for on in (False, True):
        profiler.configure(sample=1.0 if on else 0.0)
        TRACER.configure(1.0 if on else 0.0)
        eng = make_engine(params, overlap=overlap)
        server, loop = serve_inference(eng, port=0, host="127.0.0.1")
        try:
            reqs = [Request(prompt=[3, 9, 14], max_new_tokens=16),
                    Request(prompt=[2, 4, 6, 8], max_new_tokens=12),
                    Request(prompt=[1] * 7, max_new_tokens=14)]
            if on:
                with TRACER.span("client") as sp:
                    for r in reqs:
                        r.trace_ctx = sp.context()
            # one engine task submits them all, so every run admits alike
            eng.run_task(lambda: [eng.submit(r) for r in reqs])
            for r in reqs:
                assert r.done.wait(60) and not r.error
        finally:
            server.shutdown()
            server.server_close()
            loop.stop()
        uploads[on] = eng.device_uploads
    TRACER.configure(1.0)
    assert uploads[True] == uploads[False] > 0
    assert profiler.profiles()["serve"]["samples"] > 0


def test_engine_loop_emits_profile_samples(params, profiler):
    eng = make_engine(params)
    server, loop = serve_inference(eng, port=0, host="127.0.0.1")
    try:
        status, data = _post(server.server_address, "/v1/completions",
                             {"prompt": [3, 9, 14], "max_tokens": 24})
        assert status == 200 and len(json.loads(data)["tokens"]) == 24
        # the last record_step lands after done wakes the client: poll.
        # The first token is emitted by the admission's prefill, outside
        # the step bracket
        assert poll(lambda: profiler.profiles()["serve"]["tokens"] >= 23)
        prof = profiler.profiles()["serve"]
        assert prof["samples"] > 0 and prof["tokens"] == 23
        assert prof["tokens_per_sec_per_chip"]["cpu"] > 0
        status, data = _post(server.server_address, "/debug/profiles")
        dbg = json.loads(data)
        assert status == 200 and dbg["identity"]["class"] == "serve"
        assert "serve" in dbg["profiles"]
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()


def test_host_gap_histogram_on_metrics(params, profiler):
    eng = make_engine(params)
    server, loop = serve_inference(eng, port=0, host="127.0.0.1")
    try:
        status, _ = _post(server.server_address, "/v1/completions",
                          {"prompt": [2, 4, 6], "max_tokens": 16})
        assert status == 200 and eng.host_gap_stats()["chunks"] > 0
        status, data = _post(server.server_address, "/metrics")
        text = data.decode()
        assert "# TYPE tpu_serve_host_gap_ms histogram" in text
        count = series(text)["tpu_serve_host_gap_ms"]["samples"][("tpu_serve_host_gap_ms_count",
                                                                   "")]
        assert count > 0  # per-chunk samples, not one last value
        assert len(eng._gap_buf) <= eng.host_gap_stats()["chunks"]  # the scrape drained it
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()


def test_drain_host_gaps_moves_samples_out(params):
    eng = make_engine(params, overlap=False)
    eng.submit(Request(prompt=[3, 9, 14], max_new_tokens=16))
    eng.run_until_idle(max_steps=100_000)
    n = len(eng._gap_buf)
    assert n > 0
    vals = eng.drain_host_gaps()
    assert len(vals) == n and all(v >= 0.0 for v in vals)
    assert eng.drain_host_gaps() == []
