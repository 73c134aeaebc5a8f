"""One trace's spans from this process, in causal order.

Own copy of what a serving replica uses of
``elastic_gpu_scheduler_tpu/slo/assembly.py``: ``causal_order`` and the
``/debug/trace/<id>`` answer of a process without an assembler.  The
reference's ``TraceAssembler`` runs in the fleet router, which pulls a
replica's spans from its ``/traces?trace=<id>``.
"""

from __future__ import annotations

from ..tracing import TRACER

__all__ = ["causal_order", "local_trace_payload"]


def causal_order(spans: list[dict]) -> list[dict]:
    """Parents before children, siblings by start time.  A span whose
    parent is not in the set (a remote parent) ranks as a root by its own
    start time; no span is dropped."""
    by_id = {s.get("span_id"): s for s in spans if s.get("span_id")}
    children: dict[str, list[dict]] = {}
    roots: list[dict] = []
    for s in spans:
        parent = s.get("parent_id") or ""
        if parent and parent in by_id:
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)
    key = lambda s: (s.get("start_unix") or 0.0, s.get("span_id") or "")  # noqa: E731
    out: list[dict] = []
    stack = sorted(roots, key=key, reverse=True)
    seen: set = set()
    while stack:
        s = stack.pop()
        sid = s.get("span_id")
        if sid in seen:
            continue  # a duplicate id must not loop
        seen.add(sid)
        out.append(s)
        stack.extend(sorted(children.get(sid, ()), key=key, reverse=True))
    return out


def local_trace_payload(trace_id: str, tracer=None) -> dict:
    """``/debug/trace/<id>`` without an assembler: this process's spans
    only, causally ordered, in the shape the reference's assembler
    returns."""
    tracer = tracer if tracer is not None else TRACER
    spans = causal_order(tracer.trace(trace_id))
    for s in spans:
        s.setdefault("source", "local")
    return {
        "trace_id": trace_id,
        "spans": spans,
        "span_count": len(spans),
        "sources": ["local"] if spans else [],
        "processes": 1 if spans else 0,
    }
