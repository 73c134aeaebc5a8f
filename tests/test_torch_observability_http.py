"""The observability plane of a port replica against a reference replica,
over real sockets.

A port server and a reference server serve the same small float32
weights (the reference's ``init_params``, carried over by
``bridge.params_from_jax``; both engines sequential, the reference behind
``reference_engine_copies_uploads``) and get the same requests, each with
a client ``traceparent``.  Compared: the span names, parent links and
attributes in ``/traces``; the ``tpu_serve_*`` and ``tpu_kv_*`` counts on
``/metrics``; the ``: slo`` comment, once, before the first token of
every stream; the journey counts in ``/debug/slo``; the keys of
``/debug/profiles``.  Then the port's ``serve`` flags against the
reference's, the reference's fleet router recording a journey with the
queue wait from a port replica, and the reference's trace assembler
pulling a port replica's spans.
"""

import contextlib
import http.client
import json

import jax
import numpy as np
import pytest
import torch

from conftest import poll
from elastic_gpu_scheduler_tpu import profile as ref_profile
from elastic_gpu_scheduler_tpu import serve as ref_serve
from elastic_gpu_scheduler_tpu import slo as ref_slo
from elastic_gpu_scheduler_tpu import tracing as ref_tracing
from elastic_gpu_scheduler_tpu.fleet.router import FleetRouter, Replica, ReplicaSet
from elastic_gpu_scheduler_tpu.models.serving import InferenceEngine as JaxEngine
from elastic_gpu_scheduler_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    init_params as jax_init_params,
)
from elastic_gpu_scheduler_tpu.server.inference import serve_inference as ref_serve_inference
from elastic_gpu_scheduler_tpu.slo.assembly import TraceAssembler
from elastic_gpu_scheduler_tpu_torch import profile as port_profile
from elastic_gpu_scheduler_tpu_torch import serve as port_serve
from elastic_gpu_scheduler_tpu_torch import slo as port_slo
from elastic_gpu_scheduler_tpu_torch import tracing as port_tracing
from elastic_gpu_scheduler_tpu_torch.models.bridge import params_from_jax
from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine
from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig
from elastic_gpu_scheduler_tpu_torch.server.inference import serve_inference

from test_torch_engine import reference_engine_copies_uploads  # noqa: F401  (autouse)
from test_torch_metrics import series

torch.set_num_threads(1)

CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64, dtype="float32")
ENGINE = dict(max_batch=2, max_len=64, page_size=8, fused_steps=4, overlap=False)
SLO_CONFIG = {"classes": {"serve": {"ttft_p95_ms": 5000, "e2e_p99_ms": 30000,
                                    "availability": 0.5}}}
PLANES = {"ref": (ref_tracing, ref_profile, ref_slo),
          "port": (port_tracing, port_profile, port_slo)}


def tp(i: int) -> str:
    return f"00-{i + 1:032x}-{0xd0 + i:016x}-01"


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxConfig(**CFG)
    jp = jax_init_params(jax.random.key(3), jcfg)
    return jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(autouse=True)
def planes():
    """Every plane of both packages on and empty; afterwards the SLO
    planes off, the profilers back at their previous rate."""
    rates = {}
    for name, (tracing, profile, slo) in PLANES.items():
        tracing.TRACER.configure(1.0)
        tracing.TRACER.reset()
        rates[name] = profile.PROFILER.sample
        profile.PROFILER.configure(sample=1.0)
        profile.PROFILER.reset()
        profile.PROFILER.set_identity(pod="ns/rep-0", wclass="serve", generation="cpu")
        slo.SLO.reset()
        if slo is ref_slo:
            slo.SLO.load_config(SLO_CONFIG, journal=False)
        else:
            slo.SLO.load_config(SLO_CONFIG)
        slo.SLO.default_class = "serve"
    yield
    for name, (tracing, profile, slo) in PLANES.items():
        slo.SLO.reset()
        slo.SLO.default_class = "default"
        profile.PROFILER.reset()
        profile.PROFILER.set_identity()
        profile.PROFILER.configure(sample=rates[name])
        tracing.TRACER.reset()


@contextlib.contextmanager
def servers(weights):
    """{"ref": addr, "port": addr} of two fresh servers on the same
    weights, and their engines."""
    jcfg, jp, params = weights
    ref_eng = JaxEngine(jp, jcfg, **ENGINE)
    port_eng = InferenceEngine(params, TransformerConfig(**CFG), device="cpu", **ENGINE)
    ref_eng.replica_name = port_eng.replica_name = "rep-0"
    started = {"ref": ref_serve_inference(ref_eng, port=0, host="127.0.0.1"),
               "port": serve_inference(port_eng, port=0, host="127.0.0.1")}
    try:
        yield ({k: srv.server_address for k, (srv, _) in started.items()},
               {"ref": ref_eng, "port": port_eng})
    finally:
        for srv, loop in started.values():
            srv.shutdown()
            srv.server_close()
            loop.stop()


def _request(addr, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection(*addr, timeout=120)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, resp, data


def _get(addr, path):
    return json.loads(_request(addr, "GET", path)[2])


def _stream_lines(addr, body, traceparent):
    """A streamed completion's SSE lines (comments included)."""
    status, _, data = _request(addr, "POST", "/v1/completions", dict(body, stream=True),
                               {"traceparent": traceparent})
    assert status == 200
    return [ln for ln in data.decode().split("\n") if ln]


# the traffic both servers get: streamed, blocking and n=2 completions
TRAFFIC = [
    ({"prompt": [3, 9, 14, 2], "max_tokens": 9, "stream": True}, tp(0)),
    ({"prompt": [5, 6, 7], "max_tokens": 6}, tp(1)),
    ({"prompt": [1, 2, 3, 4, 5, 6, 7, 8, 9], "max_tokens": 7, "stream": True}, tp(2)),
    ({"prompt": [8, 8, 1], "max_tokens": 5, "n": 2}, tp(3)),
]


@contextlib.contextmanager
def _admit_whole(eng, n: int):
    """Hold ``eng``'s admissions until ``n`` requests are queued.  The
    handler submits the choices of an ``n`` > 1 completion one by one, and
    a loop pass between two submissions admits the first choice alone: the
    trace's order (queued, admitted, queued, admitted against queued,
    queued, admitted, admitted) would then depend on the machine's load."""
    admit = eng._admit

    def gated():
        if eng.queue.qsize() >= n:
            admit()

    eng._admit = gated
    try:
        yield
    finally:
        del eng._admit  # the class's method again


def _drive(addrs, engines):
    """TRAFFIC to each server in turn; waits for each engine loop's last
    step and each request span to finish.  Returns the raw responses."""
    out = {}
    for name, addr in addrs.items():
        got = []
        for body, tparent in TRAFFIC:
            with _admit_whole(engines[name], body.get("n", 1)):
                status, resp, data = _request(addr, "POST", "/v1/completions", body,
                                              {"traceparent": tparent})
            assert status == 200, data
            got.append((data, resp.getheader("X-TPU-Queue-Wait-Ms")))
        # the handler ends its serve.request span after the last write
        assert poll(lambda: all(any(s["name"] == "serve.request" for s in _get(
            addr, f"/traces?trace={t[3:35]}")["spans"]) for _, t in TRAFFIC))
        out[name] = got
    return out


# attributes whose values both replicas must agree on (the rest are times)
_STABLE_ATTRS = {"n", "stream", "prompt_tokens", "max_tokens", "tokens", "sse_chunks",
                 "priority", "resumed", "slot", "prefill_tokens", "step", "slots", "overlap"}


def _trace_tree(spans: list[dict]) -> list[tuple]:
    names = {s["span_id"]: s["name"] for s in spans}
    return sorted(
        (s["name"], names.get(s["parent_id"], f"remote:{s['parent_id']}"), s["status"],
         sorted(s["attrs"]), sorted((k, v) for k, v in s["attrs"].items() if k in _STABLE_ATTRS),
         [e["name"] for e in s["events"]])
        for s in spans)


def test_span_trees_match(weights):
    with servers(weights) as (addrs, engines):
        got = _drive(addrs, engines)
        trees = {name: [_trace_tree(_get(addr, f"/traces?trace={t[3:35]}")["spans"])
                        for _, t in TRAFFIC] for name, addr in addrs.items()}
        causal = {name: [[s["name"] for s in _get(addr, f"/debug/trace/{t[3:35]}")["spans"]]
                         for _, t in TRAFFIC] for name, addr in addrs.items()}
    assert trees["port"] == trees["ref"]
    assert causal["port"] == causal["ref"]
    # the blocking answers: the same float32 greedy tokens, and the queue
    # wait header on the single completion only
    for i in (1, 3):
        assert got["port"][i][0] == got["ref"][i][0]
        assert (got["port"][i][1] is None) == (got["ref"][i][1] is None) == (i == 3)
    first = trees["port"][0]
    assert [(n, p) for n, p, *_ in first] == [
        ("engine.admitted", "serve.request"), ("engine.queued", "serve.request"),
        ("engine.step", "serve.request"), ("serve.request", f"remote:{0xd0:016x}")]
    assert causal["port"][0][:3] == ["serve.request", "engine.queued", "engine.admitted"]
    # the n = 2 request: both choices queue and are admitted in its trace
    assert [n for n, *_ in trees["port"][3]].count("engine.admitted") == 2


def test_metrics_counts_match(weights):
    before, after = {}, {}
    with servers(weights) as (addrs, engines):
        for name, addr in addrs.items():
            before[name] = series(_request(addr, "GET", "/metrics")[2].decode())
        _drive(addrs, engines)
        for name, addr in addrs.items():
            after[name] = series(_request(addr, "GET", "/metrics")[2].decode())

    def sample(s, fam, name=None, labels=""):
        return s.get(fam, {"samples": {}})["samples"].get((name or fam, labels), 0.0)

    def counts(name):
        b, a = before[name], after[name]
        delta = {
            "ok": sample(a, "tpu_serve_requests_total", labels='{result="ok"}')
            - sample(b, "tpu_serve_requests_total", labels='{result="ok"}'),
            "tokens": sample(a, "tpu_serve_tokens_total")
            - sample(b, "tpu_serve_tokens_total"),
            "latency_count": sample(a, "tpu_serve_request_seconds",
                                    "tpu_serve_request_seconds_count")
            - sample(b, "tpu_serve_request_seconds", "tpu_serve_request_seconds_count"),
        }
        kv = {fam: a[fam]["samples"] for fam in ("tpu_kv_pages_resident",
                                                "tpu_kv_pages_shipped",
                                                "tpu_kv_prefix_admissions",
                                                "tpu_serve_spills")}
        return delta, kv, sorted(a["tpu_serve_queue_depth"]["samples"]), (
            sample(a, "tpu_serve_host_gap_ms", "tpu_serve_host_gap_ms_count") > 0)
    assert counts("port") == counts("ref")
    delta, kv, _, gaps = counts("port")
    assert delta == {"ok": 5.0, "tokens": 9 + 6 + 7 + 2 * 5, "latency_count": 4.0}
    assert sum(kv["tpu_kv_pages_resident"].values()) == kv["tpu_kv_pages_resident"][
        ("tpu_kv_pages_resident", '{kind="free"}')] > 0 and gaps


def test_slo_comment_once_before_first_token(weights):
    with servers(weights) as (addrs, _):
        lines = {name: _stream_lines(addr, {"prompt": [4, 4, 2], "max_tokens": 6}, tp(9))
                 for name, addr in addrs.items()}
    for name, ls in lines.items():
        slo = [i for i, ln in enumerate(ls) if ln.startswith(": slo ")]
        data = [i for i, ln in enumerate(ls) if ln.startswith("data: ")]
        assert len(slo) == 1 and slo[0] < data[0], (name, ls)
        meta = json.loads(ls[slo[0]][len(": slo "):])
        assert list(meta) == ["queue_ms"] and meta["queue_ms"] >= 0.0
    strip = [[ln for ln in ls if not ln.startswith(": slo ")] for ls in lines.values()]
    assert strip[0] == strip[1]  # the same events, tokens included


def test_debug_slo_and_profiles_match(weights):
    with servers(weights) as (addrs, engines):
        _drive(addrs, engines)
        # the last record_step lands after the last answer: wait for both
        # loops to park
        for name, addr in addrs.items():
            eng = engines[name]
            assert poll(lambda: eng.queue.empty() and all(s is None for s in eng.slots))
        slo = {name: _get(addr, "/debug/slo") for name, addr in addrs.items()}
        prof = {name: _get(addr, "/debug/profiles") for name, addr in addrs.items()}
    for st in slo.values():
        # the two streams and the blocking request: as in the reference,
        # an n > 1 completion records no journey
        assert st["folded"] == {"router": 0, "replica": 3}
        w = st["windows"]["serve"]
        assert w["samples"] == 3 and w["ok_frac"] == 1.0
    assert sorted(slo["port"]) == sorted(slo["ref"])
    assert sorted(slo["port"]["windows"]["serve"]) == sorted(slo["ref"]["windows"]["serve"])
    assert slo["port"]["objectives"] == slo["ref"]["objectives"]
    assert sorted(prof["port"]) == sorted(prof["ref"])
    assert prof["port"]["identity"] == prof["ref"]["identity"]
    assert sorted(prof["port"]["profiles"]["serve"]) == sorted(prof["ref"]["profiles"]["serve"])
    assert prof["port"]["profiles"]["serve"]["samples"] > 0


def test_serve_flags_match_the_references(tmp_path):
    argv = ["--init", "--trace-sample", "0.25", "--profile-sample", "0.5",
            "--slo-config", '{"classes": {"serve": {"ttft_p95_ms": 200}}}',
            "--workload-class", "interactive"]
    keys = ("trace_sample", "profile_sample", "slo_config", "workload_class")
    for args in (argv, ["--init"]):
        ref, port = ref_serve.build_args(args), port_serve.build_args(args)
        assert [getattr(port, k) for k in keys] == [getattr(ref, k) for k in keys]


def test_serve_planes_flags_apply(tmp_path, monkeypatch):
    path = tmp_path / "slo.json"
    path.write_text(json.dumps(SLO_CONFIG))
    monkeypatch.setenv("TPU_COTENANT_CLASSES", "train,batch")
    monkeypatch.setenv("POD_NAME", "serve-0")
    monkeypatch.setenv("POD_NAMESPACE", "ns")
    args = port_serve.build_args(["--init", "--cpu", "--trace-sample", "0.5",
                                  "--profile-sample", "0.25", "--slo-config", f"@{path}",
                                  "--workload-class", "interactive"])
    try:
        port_serve.configure_planes(args, "cpu")
        assert port_tracing.TRACER.sample == 0.5
        assert port_profile.PROFILER.stride == 4
        ident = port_profile.PROFILER.debug_state()["identity"]
        assert ident == {"pod": "ns/serve-0", "class": "interactive", "generation": "cpu",
                         "chips": 1}
        assert port_profile.PROFILER._id_neighbors == ("train", "batch")
        assert port_slo.SLO.enabled and port_slo.SLO.default_class == "interactive"
        assert port_serve.device_generation("cpu") == "cpu"
    finally:
        port_tracing.TRACER.configure(1.0)
        port_profile.PROFILER.configure(sample=1.0)


@pytest.mark.parametrize("raw", ['{"classes": {"a": {"nope_p95_ms": 1}}}', "{bad json",
                                 "@/nonexistent/slo.json", "[1]"])
def test_bad_slo_config_exits_as_the_references(raw):
    args = port_serve.build_args(["--init", "--cpu", "--slo-config", raw])
    with pytest.raises(SystemExit) as e:
        port_serve.configure_planes(args, "cpu")
    # the reference's main: SystemExit(f"--slo-config: {e}") over the
    # same load_config_source and load_config
    try:
        ref_slo.SloPlane().load_config(ref_slo.load_config_source(raw), journal=False)
    except (ValueError, TypeError, OSError) as ref_e:
        assert str(e.value) == f"--slo-config: {ref_e}"
    else:
        raise AssertionError("the reference accepted the config")


class _RelayUp:
    up = True
    detail = "no relay"


def test_reference_router_journey_carries_the_port_replicas_queue_wait(weights):
    """The reference's ``FleetRouter`` in front of a port replica reads the
    replica's ``: slo`` comment into its (router-vantage) journey."""
    _, _, params = weights
    eng = InferenceEngine(params, TransformerConfig(**CFG), device="cpu", **ENGINE)
    eng.replica_name = "rep-0"
    srv, loop = serve_inference(eng, port=0, host="127.0.0.1")
    rs = ReplicaSet(interval_s=60.0, relay_monitor=_RelayUp())
    rs.add(Replica("rep-0", "127.0.0.1", srv.server_address[1]))
    rs.refresh()
    router = FleetRouter(rs, host="127.0.0.1", port=0, page_size=8)
    try:
        rport = router.start()
        lines = _stream_lines(("127.0.0.1", rport), {"prompt": [3, 1, 4, 1, 5],
                                                      "max_tokens": 6}, tp(5))
        assert lines[-1] == "data: [DONE]"
        assert poll(lambda: ref_slo.SLO.debug_state()["folded"]["router"] == 1)
        assert poll(lambda: port_slo.SLO.debug_state()["folded"]["replica"] == 1)
        journey = ref_slo.SLO.debug_state()["recent"][-1]
        own = port_slo.SLO.debug_state()["windows"]["serve"]["queue_ms"]["p50"]
    finally:
        router.stop()
        srv.shutdown()
        srv.server_close()
        loop.stop()
    assert journey["vantage"] == "router" and journey["replica"] == "rep-0"
    assert journey["ok"] is True and journey["tokens"] == 6
    assert journey["queue_ms"] is not None and abs(journey["queue_ms"] - own) < 1e-3
    assert journey["trace_id"] == f"{6:032x}"


def test_reference_assembler_pulls_a_port_replicas_spans(weights):
    _, _, params = weights
    eng = InferenceEngine(params, TransformerConfig(**CFG), device="cpu", **ENGINE)
    srv, loop = serve_inference(eng, port=0, host="127.0.0.1")
    try:
        _stream_lines(srv.server_address, {"prompt": [2, 7, 1, 8], "max_tokens": 5}, tp(7))
        tid = tp(7)[3:35]
        assert poll(lambda: any(s["name"] == "serve.request" for s in _get(
            srv.server_address, f"/traces?trace={tid}")["spans"]))
        asm = TraceAssembler(sources=lambda: [("rep-0", srv.server_address)],
                             tracer=ref_tracing.Tracer(sample=1.0))
        rec = asm.assemble(tid)
    finally:
        srv.shutdown()
        srv.server_close()
        loop.stop()
    assert rec["pull_errors"] == {} and rec["sources"] == ["rep-0"] and rec["processes"] == 1
    names = [s["name"] for s in rec["spans"]]
    assert names[:3] == ["serve.request", "engine.queued", "engine.admitted"]
    assert "engine.step" in names
