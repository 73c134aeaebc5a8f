"""The port's tracing and trace assembly against the reference's.

``elastic_gpu_scheduler_tpu_torch.tracing`` and ``slo.assembly`` are own
copies of the reference's serving-replica tracing.  The same operations
go to a ``Tracer`` of each package and must give the same span trees
(names, parent links, attributes, status, events), the same sampling and
pinning behaviour, and ``/traces`` and ``/debug/trace/<id>`` payloads of
the same shape; ``traceparent`` values cross between the packages both
ways; ``causal_order`` orders the same seeded span sets identically.
Span ids are random in both, so trees are compared by names.  The
engines' points go into the same traces: a request that spills and
resumes gets a second ``engine.queued`` (resumed) and ``engine.admitted``
in each engine, and keeps its first queue and admission stamps.
"""

import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu import tracing as ref_tracing
from elastic_gpu_scheduler_tpu.models.serving import (
    InferenceEngine as JaxEngine,
    Request as JaxRequest,
)
from elastic_gpu_scheduler_tpu.metrics import METRICS_DROPPED as REF_DROPPED
from elastic_gpu_scheduler_tpu.slo import assembly as ref_assembly
from elastic_gpu_scheduler_tpu_torch import tracing as port_tracing
from elastic_gpu_scheduler_tpu_torch.metrics import METRICS_DROPPED as PORT_DROPPED
from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine, Request
from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig
from elastic_gpu_scheduler_tpu_torch.slo import assembly as port_assembly

from test_torch_engine import (  # noqa: F401  (the autouse fixture)
    CFG,
    reference_engine_copies_uploads,
    weights,
)

torch.set_num_threads(1)

PACKAGES = {"ref": (ref_tracing, ref_assembly, REF_DROPPED),
            "port": (port_tracing, port_assembly, PORT_DROPPED)}
CLIENT_TP = "00-" + "c" * 32 + "-" + "d" * 16 + "-01"


def _tree(spans: list[dict]) -> list[tuple]:
    """Span dicts → sorted (name, parent's name, attrs, status, events),
    with an outside parent named by its id."""
    names = {s["span_id"]: s["name"] for s in spans}
    out = []
    for s in spans:
        parent = s["parent_id"]
        out.append((s["name"], names.get(parent, f"remote:{parent}"), s["attrs"], s["status"],
                    tuple(e["name"] for e in s["events"])))
    return sorted(out, key=repr)


def _serve_like(tracing):
    """One request's spans as the serving replica makes them, plus an
    untraced request rooting its own trace; returns (tracer, trace ids)."""
    tr = tracing.Tracer(capacity=256, sample=1.0)
    with tr.span("serve.request", parent=CLIENT_TP, n=1, stream=True, prompt_tokens=5,
                 max_tokens=8) as sp:
        ctx = sp.context()
        tr.point("engine.queued", parent=ctx, priority=0, resumed=False)
        tr.point("engine.admitted", parent=ctx, slot=3, prefill_tokens=5)
        with tr.span("engine.step", parent=ctx, step=0, slots=1) as st:
            st.set_attr("host_gap_ms", 0.0)
            st.set_attr("overlap", True)
        sp.event("sse_first_flush")
        with tr.span("nested.child", k=1):  # parent: the thread's current span
            pass
        sp.set_attr("sse_chunks", 8)
    with pytest.raises(ZeroDivisionError):
        with tr.span("serve.request", n=1):
            1 / 0
    other = [s.trace_id for s in tr.finished() if s.trace_id != "c" * 32][0]
    return tr, ("c" * 32, other)


def test_span_trees_match():
    trees = {}
    for name, (tracing, _, _) in PACKAGES.items():
        tr, tids = _serve_like(tracing)
        trees[name] = [_tree(tr.trace(t)) for t in tids]
    assert trees["port"] == trees["ref"]
    traced, untraced = trees["port"]
    assert ("engine.step", "serve.request", {"step": 0, "slots": 1, "host_gap_ms": 0.0,
                                             "overlap": True}, "ok", ()) in traced
    assert ("serve.request", "remote:" + "d" * 16,
            {"n": 1, "stream": True, "prompt_tokens": 5, "max_tokens": 8, "sse_chunks": 8},
            "ok", ("sse_first_flush",)) in traced
    assert untraced == [("serve.request", "remote:",
                         {"n": 1, "error": "ZeroDivisionError: division by zero"},
                         "error", ())]


def test_traces_response_and_payload_shapes_match():
    shapes = {}
    for name, (tracing, assembly, _) in PACKAGES.items():
        tr, (tid, _) = _serve_like(tracing)
        summary = tracing.traces_response({}, tracer=tr)
        one = tracing.traces_response({"trace": tid}, tracer=tr)
        chrome = tracing.traces_response({"format": "chrome", "trace": tid}, tracer=tr)
        limited = tracing.traces_response({"limit": "1"}, tracer=tr)
        payload = assembly.local_trace_payload(tid, tracer=tr)
        missing = assembly.local_trace_payload("e" * 32, tracer=tr)
        shapes[name] = {
            "summary": (sorted(summary), sorted(summary["tracer"]),
                        [sorted(t) for t in summary["traces"]],
                        [(t["name"], t["spans"], t["open"], t["status"])
                         for t in summary["traces"]]),
            "status": {k: v for k, v in summary["tracer"].items()},
            "one": (sorted(one), [sorted(s) for s in one["spans"]]),
            "chrome": (sorted(chrome), sorted((e["name"], e["ph"]) for e in chrome["traceEvents"])),
            "limited": len(limited["traces"]),
            "payload": ({k: v for k, v in payload.items() if k != "spans"},
                        [(s["name"], s["source"]) for s in payload["spans"]]),
            "missing": missing,
        }
    assert shapes["port"] == shapes["ref"]
    assert shapes["port"]["limited"] == 1
    assert shapes["port"]["payload"][0]["processes"] == 1


def test_traceparent_crosses_both_ways():
    for a, b in (("ref", "port"), ("port", "ref")):
        ta, tb = PACKAGES[a][0], PACKAGES[b][0]
        tr = ta.Tracer(sample=1.0)
        sp = tr.span("serve.request")
        tp = sp.traceparent()
        ctx = tb.parse_traceparent(tp)
        assert (ctx.trace_id, ctx.span_id, ctx.sampled) == (sp.trace_id, sp.span_id, True)
        assert tb.format_traceparent(ctx) == tp
        # a child opened from the other package's header joins the trace
        child = tb.Tracer(sample=1.0).span("engine.step", parent=tp)
        assert (child.trace_id, child.parent_id) == (sp.trace_id, sp.span_id)
        unsampled = tb.format_traceparent(tb.SpanContext("1" * 32, "2" * 16, sampled=False))
        assert unsampled == ta.format_traceparent(ta.SpanContext("1" * 32, "2" * 16, False))
        assert ta.parse_traceparent(unsampled).sampled is False
    assert port_tracing.TRACEPARENT_HEADER == ref_tracing.TRACEPARENT_HEADER


@pytest.mark.parametrize("bad", [
    "", None, "garbage", "00-abc-def-01",
    "00-" + "g" * 32 + "-" + "0" * 16 + "-01",
    "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "1" * 32 + "-" + "0" * 16 + "-01",
    "00-" + "1" * 32 + "-" + "1" * 16,
    "zz-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-a_" + "a" * 30 + "-" + "b" * 16 + "-01",
    "00-+" + "a" * 31 + "-" + "b" * 16 + "-01",
    "  00-" + "A" * 32 + "-" + "B" * 16 + "-03  ",  # upper case and blanks: accepted
])
def test_traceparent_parsing_matches(bad):
    ref, port = ref_tracing.parse_traceparent(bad), port_tracing.parse_traceparent(bad)
    assert (ref is None) == (port is None)
    if ref is not None:
        assert (port.trace_id, port.span_id, port.sampled) == (ref.trace_id, ref.span_id,
                                                                ref.sampled)


@pytest.mark.parametrize("sample", [0.0, 1.0])
def test_sampling_matches(sample):
    seen = {}
    for name, (tracing, _, _) in PACKAGES.items():
        tr = tracing.Tracer(sample=1.0)
        tr.configure(sample)
        root = tr.span("serve.request")
        child = tr.span("engine.step", parent=root)
        unsampled = tr.span("x", parent="00-" + "a" * 32 + "-" + "b" * 16 + "-00")
        noop_child = tr.span("y", parent=tracing.NOOP_SPAN)
        point = tr.point("engine.queued", parent=root)
        child.end()
        root.end()
        seen[name] = (bool(root), bool(child), unsampled is tracing.NOOP_SPAN,
                      noop_child is tracing.NOOP_SPAN, bool(point),
                      sorted(s.name for s in tr.finished()), tr.status()["sample"])
    assert seen["port"] == seen["ref"]
    assert seen["port"][0] is (sample == 1.0)


def test_pinning_matches():
    runs = {}
    for name, (tracing, _, dropped) in PACKAGES.items():
        with dropped._lock:
            before = dropped._values.get(("trace_pin_cap",), 0.0)
        tr = tracing.Tracer(capacity=8, sample=1.0, pinned_capacity=5)
        sp = tr.span("serve.request")
        tid = sp.trace_id
        tr.pin(tid)
        tr.pin(tid)  # pins nest
        for k in range(9):
            tr.span(f"engine.step-{k}", parent=sp).end()
        for i in range(20):
            tr.span(f"noise-{i}").end()
        kept_pinned = sorted(s.name for s in tr.finished() if s.trace_id == tid)
        status_pinned = tr.status()
        tr.unpin(tid)
        still = len([s for s in tr.finished() if s.trace_id == tid])
        tr.unpin(tid)
        released = tr.status()
        for i in range(20):
            tr.span(f"noise2-{i}").end()
        after_flood = [s for s in tr.finished() if s.trace_id == tid]
        with dropped._lock:
            counted = dropped._values.get(("trace_pin_cap",), 0.0) - before
        runs[name] = (kept_pinned, status_pinned, still, released, after_flood,
                      counted, len(tr._pin_ring))
    assert runs["port"] == runs["ref"]
    kept, status, still, released, after_flood, counted, ring = runs["port"]
    assert kept == [f"engine.step-{k}" for k in range(4, 9)]
    assert status["dropped_pinned_spans"] == 4 and counted == 4.0
    assert still == 5 and released["pinned_spans"] == 0 and ring == 0
    assert after_flood == []


def test_current_span_stack_matches():
    for tracing, _, _ in PACKAGES.values():
        tr = tracing.Tracer(sample=1.0)
        assert tr.current() is None
        with tr.span("a") as a:
            assert tr.current() is a
            with tr.span("b") as b:
                assert tr.current() is b and b.parent_id == a.span_id
            assert tr.current() is a
        assert tr.current() is None
        a.end()  # a second end keeps the first timing
        assert [s.name for s in tr.finished()] == ["b", "a"]


def _random_spans(rng, n: int) -> list[dict]:
    """A seeded span set: a forest with remote parents, duplicate start
    times and a duplicated id."""
    spans = []
    for i in range(n):
        parent = ""
        if i and rng.random() < 0.7:
            parent = spans[int(rng.integers(0, i))]["span_id"]
        elif rng.random() < 0.3:
            parent = f"remote{i:010d}"
        spans.append({"span_id": f"{i:016x}", "parent_id": parent, "name": f"s{i}",
                      "start_unix": float(rng.integers(0, n // 2))})
    spans.append(dict(spans[int(rng.integers(0, n))]))  # a duplicate id
    order = rng.permutation(len(spans))
    return [spans[i] for i in order]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_causal_order_matches(seed):
    spans = _random_spans(np.random.default_rng(seed), 40)
    ref = ref_assembly.causal_order([dict(s) for s in spans])
    port = port_assembly.causal_order([dict(s) for s in spans])
    assert [s["span_id"] for s in port] == [s["span_id"] for s in ref]
    pos = {s["span_id"]: i for i, s in enumerate(port)}
    for s in port:  # parents before children
        if s["parent_id"] in pos:
            assert pos[s["parent_id"]] < pos[s["span_id"]]


def test_engine_points_through_a_spill_match(weights):
    """The JAX engine and the port's (both sequential), each with its own
    package's tracer: a low-priority request under page pressure spills
    for a higher one and resumes.  Its trace holds the same points with
    the same attributes, and its t_submit / t_admit stay the first ones
    (the queue wait a client saw)."""
    jcfg, jp, params = weights
    kw = dict(max_batch=2, max_len=64, page_size=8, n_pages=6, fused_steps=2, overlap=False)
    runs = {}
    for name, tracing, make, request_cls in (
        ("ref", ref_tracing, lambda: JaxEngine(jp, jcfg, **kw), JaxRequest),
        ("port", port_tracing,
         lambda: InferenceEngine(params, TransformerConfig(**CFG), device="cpu", **kw), Request),
    ):
        tracing.TRACER.configure(1.0)
        tracing.TRACER.reset()
        root = tracing.TRACER.span("serve.request")
        eng = make()
        victim = request_cls(prompt=[3, 9, 14, 27, 5, 1, 2, 6], max_new_tokens=30, priority=0)
        victim.trace_ctx = root.context()
        eng.submit(victim)
        for _ in range(40):
            eng._admit()
            eng.step()
            if len(eng.free_pages) == 0:
                break
        first = (victim.t_submit, victim.t_admit)
        high = eng.submit(request_cls(prompt=[2, 4, 6, 8, 10, 12, 1, 7], max_new_tokens=8,
                                      priority=5))
        eng.run_until_idle(max_steps=100_000)
        root.end()
        assert not victim.error and not high.error and eng.spills >= 1
        assert (victim.t_submit, victim.t_admit) == first and 0.0 < first[0] <= first[1]
        points = [(s["name"], s["attrs"]) for s in tracing.TRACER.trace(root.trace_id)
                  if s["name"] != "serve.request"]
        runs[name] = (points, list(victim.output))
        tracing.TRACER.reset()
    assert runs["port"] == runs["ref"]
    points = runs["port"][0]
    spills = len(points) // 2 - 1  # each spill requeues and readmits
    assert spills >= 1
    assert [n for n, _ in points] == ["engine.queued", "engine.admitted"] * (spills + 1)
    assert [a["resumed"] for n, a in points if n == "engine.queued"] == [False] + [True] * spills
