"""HTTP front end for the port's serving engine.

Counterpart of ``elastic_gpu_scheduler_tpu/server/inference.py`` for the
routes this slice serves (stdlib HTTP only):

    POST /v1/completions   → {"prompt": [ids], "max_tokens": N, ...}
                             blocking JSON, or Server-Sent Events with
                             {"stream": true} (``data: {"token": t}`` …
                             ``data: [DONE]``); the reference's request
                             controls (logprobs, logit_bias,
                             allowed_tokens, the penalties, min_tokens,
                             seed), ``adapter`` (a name registered with
                             the engine; "" the base model) and ``n``
                             parallel choices
                             (with an ``X-KV-Source: host:port``
                             header: first pull the prompt's cached
                             prefix pages from that replica, best-effort)
    POST /v1/prefill       → {"prompt": [ids]}: prefill only, so the pages
                             land in this replica's prefix cache for export
    POST /v1/kv/export     → {"tokens": [ids]}: the cached prefix pages as
                             a binary ``utils/kvwire`` bundle
    POST /v1/kv/adopt      → {"source": "host:port", "tokens": [ids]}: pull
                             and import a peer's pages
    POST /v1/migrate/out   → {"dest": "host:port"[, "slot": i]}: move a live
                             session to a peer and relay its continuation
                             into the original client stream
    POST /v1/migrate/in    → a session bundle: import, resume, and stream
                             the continuation back as SSE
    POST /policy/load      → {"name", "verb": "kv", "expr", "budget"?}: put
                             a ``kv`` policy in force (the reference
                             scheduler's body; 400 for a bad expression)
    POST /policy/rollback  → {"verb"?, "reason"?}: back to the built-in
                             victim ranking
    GET  /v1/stats         → engine state (slots, pages, queue, prefix cache
                             and KV shipping counters, registered adapters,
                             replica name and fleet role, the warm-up's
                             state and the compile cache's counters)
    GET  /metrics          → Prometheus text: the ``tpu_serve_*`` series,
                             the ``tpu_kv_*`` gauges set at scrape time,
                             the SLO, profile and policy series
    GET  /traces           → the span ring (``?trace=<id>``, ``?format=chrome``,
                             ``?limit=N``)
    GET  /debug/trace/<id> → one trace's spans in causal order
    GET  /debug/slo        → this replica's journey windows and objectives
    GET  /debug/profiles   → this replica's workload profiles
    GET  /debug/policy     → the loaded ``kv`` policy, its counts, history
    GET  /healthz          → readiness (503 while draining, once a mesh
                             engine has failed, ``{"warming": true}``
                             while the shape lattice warms, and
                             ``{"warmup_failed": true}`` once the warm-up
                             could not build or load the kernel library,
                             or a point failed on some rank of a mesh)
    GET  /version          → build version

ONE engine thread (``EngineLoop``) owns all engine state and drives
fused chunks; HTTP handler threads only submit requests and wait on them,
and reach the data plane's verbs through ``engine.run_verb`` (reads of
the cache through ``engine.run_task``).  On a mesh (``serve --tensor N``)
the loop runs on rank 0: each of its rounds starts with the engine's
ticket (``InferenceEngine.exchange_ticket``), which carries the handlers'
submits, cancels and data-plane verbs to the other ranks, and
it sends an empty one every ``TICKET_HEARTBEAT_S`` while parked, so the
followers' collective never times out.  A fault there stops the loop:
the ranks may have parted, so no ticket follows, every waiting request
and later submit fails at once with a 503
(``InferenceEngine.fail_mirrored``), ``/healthz`` answers 503, and
``serve`` exits non-zero so the replica is restarted.  An
unknown adapter is a 400 naming the registered ones; a full bounded queue
is a 429.  The data-plane routes answer with the reference's codes: 409
without the prefix cache (or with no live session to migrate), 404 when
no page is cached, 400 for a bad bundle or body, 502 for a failed pull or
a refused handoff (the session then resumes here), 503 when the engine
task times out.

The observability plane is the reference's, under its names: a client
``traceparent`` header joins its trace (``serve.request``, then the
engine's ``engine.queued`` / ``engine.admitted`` points and the loop's
paced ``engine.step`` spans); a stream writes the SSE comment
``: slo {"queue_ms": ...}`` once, before its first token, for the fleet
router's journey record (a blocking answer carries the
``X-TPU-Queue-Wait-Ms`` header); every completion records its replica
journey when an SLO config is loaded; the loop records a profile sample a
step.  None of it reads the device.
"""

from __future__ import annotations

import http.client
import json
import logging
import math
import queue
import select
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qsl

import torch

from .. import __version__
from ..metrics import (
    KV_MIGRATIONS,
    KV_PAGES_RESIDENT,
    KV_PAGES_SHIPPED,
    KV_PREFIX_ADMISSIONS,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
)
from ..models.serving import (
    DRAINING_ERROR,
    ENGINE_FAILED_ERROR,
    QUEUE_FULL_ERROR,
    InferenceEngine,
    Request,
)
from ..ops import _build
from ..policy import POLICIES
from ..policy.vm import DEFAULT_BUDGET
from ..profile import PROFILER
from ..slo import SLO
from ..slo.assembly import local_trace_payload
from ..tracing import TRACEPARENT_HEADER, TRACER, traces_response
from ..utils import kvwire
from ..utils.kvwire import KV_SOURCE_HEADER

log = logging.getLogger("tpu-scheduler")

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found", 409: "Conflict",
            429: "Too Many Requests", 502: "Bad Gateway", 503: "Service Unavailable",
            504: "Gateway Timeout"}


SERVE_REQUESTS = REGISTRY.register(
    Counter(
        "tpu_serve_requests_total",
        "Inference requests by result (ok/error/timeout/cancelled)",
        ("result",),
    )
)
SERVE_TOKENS = REGISTRY.register(
    Counter(
        "tpu_serve_tokens_total",
        "Tokens emitted to clients",
    )
)
SERVE_QUEUE_DEPTH = REGISTRY.register(
    Gauge(
        "tpu_serve_queue_depth",
        "Queued requests per priority class (set at scrape time)",
        ("priority",),
    )
)
_SCRAPE_LOCK = threading.Lock()  # reset + set + expose of the scrape-time gauges
SERVE_SPILLS = REGISTRY.register(
    Gauge(
        "tpu_serve_spills",
        "Low-priority slots spilled (pages freed, request requeued for "
        "exact resume) under page pressure — the serving-plane mirror of "
        "the scheduler's preemption verb",
    )
)
SERVE_LATENCY = REGISTRY.register(
    Histogram(
        "tpu_serve_request_seconds",
        "End-to-end request latency (submit to done)",
        buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                 60.0, 120.0),
    )
)
SERVE_HOST_GAP = REGISTRY.register(
    Histogram(
        "tpu_serve_host_gap_ms",
        "Wall time between consecutive fused decode chunk dispatches, in "
        "ms (the window where the accelerator can starve on host "
        "bookkeeping; the overlapped pipeline keeps it near zero).  A "
        "HISTOGRAM of per-chunk samples folded at scrape time — p50/p99 "
        "are real distribution tails, not whichever chunk scraped last "
        "(the old last-value gauge's failure mode)",
        buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                 100.0, 500.0),
    )
)

# a traced batch gets one engine.step span every this many loop steps, so
# one long generation cannot flood the span ring
STEP_SPAN_EVERY = 32

# a parked loop on a mesh sends an empty ticket this often: the followers
# wait in a collective that times out after the process group's limit
TICKET_HEARTBEAT_S = 30.0


def choose_kv_victim(eng: InferenceEngine, skip=()) -> int:
    """The slot to preempt when every slot stalls for pages, and the
    session ``/v1/migrate/out`` moves when no slot is named: the policy
    registry's ``kv`` verb over each live slot's priority, pages held,
    tokens emitted, index and prefix-matched tokens (a loaded policy's
    highest score), else the built-in ranking: the lowest priority, then
    most pages held, then the lowest slot.  Done-but-unreleased slots are
    not candidates, nor are the slots in ``skip`` (taken by an earlier
    migration of the same ticket)."""
    return POLICIES.select_kv_victim([
        {
            "slot": float(i),
            "priority": float(eng.priorities[i]),
            "pages": float(len(eng.slot_pages[i])),
            "tokens": float(len(s.output)),
            "matched": float(eng.matched_toks[i]),
        }
        for i, s in enumerate(eng.slots)
        if s is not None and not s.done.is_set() and i not in skip
    ])


class EngineLoop:
    """Single thread that owns the engine: admit + step while work exists,
    park on the engine's work event when idle.  Before it parks (and so
    before a drain can complete) it drains the overlapped engine's chunk
    still in flight, so no dispatched work outlives the requests."""

    def __init__(self, engine: InferenceEngine):
        self.engine = engine
        self.idle_parks = 0
        # set while the loop waits for work (so after its drain), cleared
        # when it wakes: a park that follows a request's completion
        self.parked = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # set by the LOOP thread when it observes draining + idle
        self.drained = threading.Event()
        # set by the LOOP thread when a mirrored engine faulted and it
        # stopped: /healthz answers 503, and ``serve`` exits non-zero
        self.failed = threading.Event()
        self._step_seq = 0  # steps since a traced batch started (span pacing)
        # the warm-start plane: ``serve --warmup`` puts its WarmupState here
        # and /healthz answers 503 {"warming": true} until it completes;
        # None = no warm-up phase
        self.warmup = None
        self.http_inflight = 0  # handler threads still writing responses
        self._inflight_lock = threading.Lock()

    def inflight_enter(self) -> None:
        with self._inflight_lock:
            self.http_inflight += 1

    def inflight_exit(self) -> None:
        with self._inflight_lock:
            self.http_inflight -= 1

    def start(self) -> "EngineLoop":
        self._thread = threading.Thread(target=self._run, name="engine-loop", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.engine._work.set()  # wake a parked loop so it can exit
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        # serving never differentiates: trainable parameters build no graph
        with torch.inference_mode():
            self._serve()
            if self.engine.mirrored and not self.failed.is_set():
                self.engine.stop_followers()

    def _serve(self) -> None:
        eng = self.engine
        failures = 0
        while not self._stop.is_set():
            try:
                if eng.mirrored:
                    eng.exchange_ticket(preempt=True)
                # the body every follower runs too; a dry pool preempts ONE
                # victim (overload, not a bug), on every rank of a mesh
                if not eng.round(preempt=True, victim_fn=choose_kv_victim, step=self._step):
                    if eng.draining and eng.queue.empty() and not eng._unticketed:
                        self.drained.set()
                    # clear → re-check → wait: a submit after the clear
                    # re-sets the event, so no wakeup is lost
                    eng._work.clear()
                    if (
                        eng.queue.empty()
                        and eng._tasks.empty()
                        and not eng._verb_queue
                        and not eng._unticketed
                        and not any(s is not None for s in eng.slots)
                        and not self._stop.is_set()
                    ):
                        self.idle_parks += 1
                        self.parked.set()
                        eng._work.wait(TICKET_HEARTBEAT_S if eng.mirrored else None)
                        self.parked.clear()
                failures = 0
            except Exception:
                failures += 1
                self._fail_all("internal engine error", failures)
                if eng.mirrored:
                    # the ranks' mirrors may have parted: stop serving, and
                    # let the process exit so the replica is restarted
                    log.error("engine on a mesh failed; the replica stops")
                    eng.fail_mirrored()
                    self.failed.set()
                    return

    def _step(self) -> None:
        """One engine step inside the loop's span and profile."""
        eng = self.engine
        traced = next((s.trace_ctx for s in eng.slots
                       if s is not None and s.trace_ctx is not None), None)
        # host counters only: a clock read and the token count (which,
        # overlapped, moves one chunk late), never the device
        prof = PROFILER.enabled
        if prof:
            prof_t0 = time.perf_counter()
            prof_tok0 = eng.tokens_emitted
        if traced is not None and self._step_seq % STEP_SPAN_EVERY == 0:
            # overlapped, the step returns once the next chunk is
            # dispatched: the span times the host's dispatch
            with TRACER.span("engine.step", parent=traced, step=self._step_seq,
                             slots=sum(1 for s in eng.slots if s is not None)) as sp:
                eng.step()
                sp.set_attr("host_gap_ms", round(eng.last_host_gap_ms, 3))
                sp.set_attr("overlap", eng.overlap)
                if prof:
                    wall = time.perf_counter() - prof_t0
                    sp.set_attr("tokens_per_sec",
                                round((eng.tokens_emitted - prof_tok0) / wall, 1)
                                if wall > 0 else 0.0)
        else:
            eng.step()
        if prof:
            PROFILER.record_step(
                tokens=eng.tokens_emitted - prof_tok0,
                wall_s=time.perf_counter() - prof_t0,
                slots_active=sum(1 for s in eng.slots if s is not None),
                slots_total=eng.max_batch,
                host_gap_ms=eng.last_host_gap_ms,
                queue_depth=eng.queue.qsize(),
                hbm_pages=eng.n_pages - 1 - len(eng.free_pages),
            )
        self._step_seq = self._step_seq + 1 if traced is not None else 0

    def _fail_all(self, msg: str, failures: int = 1) -> None:
        """An engine fault must not kill the loop silently: fail every
        in-flight request so clients unblock, back off, keep serving."""
        log.exception(
            "engine loop error (consecutive=%d); failing in-flight requests", failures
        )
        for i, req in enumerate(self.engine.slots):
            if req is None:
                continue
            try:
                req.error = msg
                req.done.set()
                self.engine._release_slot(i)
            except Exception:
                log.exception("cleanup of slot %d failed; force-dropping", i)
                self.engine._force_drop_slot(i)
        self._stop.wait(min(1.0, 0.05 * (2 ** min(failures, 10))))


def _queue_wait_ms(req: Request) -> Optional[float]:
    """The queue wait the request saw (first enqueue to first admission:
    a spill's requeue keeps the first stamps), or None before admission."""
    if req.t_submit > 0.0 and req.t_admit > 0.0:
        return max(0.0, (req.t_admit - req.t_submit) * 1000.0)
    return None


def _token_ids(x, vocab_size: int, what: str) -> list:
    """A JSON list of in-range token ids (bool is rejected, and an
    out-of-range id would silently clamp in the embedding gather)."""
    if not isinstance(x, list) or not all(
        isinstance(t, int) and not isinstance(t, bool) and 0 <= t < vocab_size
        for t in x
    ):
        raise ValueError(f"{what!r} must be a list of token ids in [0, {vocab_size})")
    return x


def _strict_seed(v):
    """None, or an int: a float, bool or string is a 400 (coercing it would
    hand two different client values the same completion)."""
    if v is None:
        return None
    if isinstance(v, bool) or not isinstance(v, int):
        raise ValueError("'seed' must be an integer")
    return v


def _strict_nonneg_int(body: dict, name: str, default: int = 0) -> int:
    """A non-negative JSON integer (a bool or a float is a 400)."""
    v = body.get(name, default)
    if not isinstance(v, int) or isinstance(v, bool) or v < 0:
        raise ValueError(f"'{name}' must be a non-negative integer")
    return v


def _strict_finite_number(body: dict, name: str) -> float:
    """A finite JSON number: not a bool, not NaN or infinite."""
    v = body.get(name, 0.0)
    if isinstance(v, bool) or not isinstance(v, (int, float)) or not math.isfinite(v):
        raise ValueError(f"'{name}' must be a finite number")
    return float(v)


def _request_from_body(body: dict, vocab_size: int) -> Request:
    prompt = _token_ids(body.get("prompt"), vocab_size, "prompt")
    priority = body.get("priority", 0)
    if isinstance(priority, bool) or not isinstance(priority, int):
        raise ValueError("'priority' must be an integer")
    stop = _token_ids(body.get("stop", []), vocab_size, "stop")
    logprobs = _strict_nonneg_int(body, "logprobs")
    bias_raw = body.get("logit_bias", {})
    if not isinstance(bias_raw, dict):
        raise ValueError("'logit_bias' must be an object of id -> bias")
    bias = {}
    for k, v in bias_raw.items():
        try:
            tid = int(k)  # JSON object keys are strings
        except (TypeError, ValueError):
            raise ValueError(f"logit_bias key {k!r} is not a token id") from None
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            raise ValueError(f"logit_bias value for {k!r} must be a number")
        bias[tid] = float(v)
    return Request(
        prompt=prompt,
        max_new_tokens=int(body.get("max_tokens", 16)),
        temperature=float(body.get("temperature", 0.0)),
        top_k=int(body.get("top_k", 0)),
        top_p=float(body.get("top_p", 1.0)),
        adapter=str(body.get("adapter", "")),
        stop_tokens=tuple(stop),
        logprobs=logprobs,
        logit_bias=bias,
        frequency_penalty=_strict_finite_number(body, "frequency_penalty"),
        presence_penalty=_strict_finite_number(body, "presence_penalty"),
        min_tokens=_strict_nonneg_int(body, "min_tokens"),
        priority=priority,
        seed=_strict_seed(body.get("seed")),
        allowed_tokens=tuple(
            _token_ids(body.get("allowed_tokens", []), vocab_size, "allowed_tokens")
        ),
    )


def _requests_from_body(body: dict, vocab_size: int, max_batch: int) -> list:
    """The ``n`` choices of one completion body (``n`` in [1, max_batch]);
    with a seed, choice k draws with seed + k."""
    if not isinstance(body, dict):
        raise ValueError("body must be a JSON object")
    n = body.get("n", 1)
    if not isinstance(n, int) or isinstance(n, bool) or not 1 <= n <= max_batch:
        raise ValueError(f"'n' must be an integer in [1, {max_batch}]")
    reqs = []
    for k in range(n):
        req = _request_from_body(body, vocab_size)
        if n > 1 and req.seed is not None:
            req.seed = req.seed + k
        reqs.append(req)
    return reqs


def _split_hostport(addr: str) -> tuple[str, int]:
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"bad replica address {addr!r} (want host:port)")
    return host, int(port)


# ceiling on the adoption pull (X-KV-Source, /v1/kv/adopt → the donor's
# /v1/kv/export): adoption only saves a prefill, so a stalled donor must
# cost less than the prefill it was meant to save
ADOPT_PULL_TIMEOUT_S = 5.0


def _backend_post(addr: str, path: str, body: bytes, ctype: str,
                  timeout: float = 30.0) -> tuple[int, bytes]:
    """One replica-to-replica POST, its response read whole."""
    host, port = _split_hostport(addr)
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", path, body, {"Content-Type": ctype})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _backend_stream(addr: str, path: str, body: bytes, timeout: float = 300.0):
    """A streaming POST to a peer: (response, connection, error), the
    connection left open for the migration relay's incremental reads."""
    try:
        host, port = _split_hostport(addr)
        conn = http.client.HTTPConnection(host, port, timeout=timeout)
        conn.request("POST", path, body, {"Content-Type": "application/octet-stream"})
        return conn.getresponse(), conn, None
    except (OSError, ValueError) as e:
        return None, None, str(e)


def _relay_migrated(req: Request, resp, conn) -> None:
    """Source side of a migrated session: feed the destination's SSE
    continuation into the ORIGINAL request (output, logprobs, on_token,
    done), as the engine thread would have.  The request passed from the
    engine to this thread at eviction, so nothing else mutates it; the
    client's connection never moves.  A client cancel drops the relay
    connection, and the destination cancels at its next write."""
    try:
        while True:
            if req.cancelled:
                break  # closing conn below cancels the destination too
            line = resp.readline()
            if not line:
                if not req.cancelled and not req.error:
                    req.error = "migrated session relay closed early"
                break
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            payload = line[6:]
            if payload == b"[DONE]":
                resp.read()  # the chunked body's end, so the connection closes clean
                break
            ev = json.loads(payload)
            if "error" in ev:
                req.error = str(ev["error"])
                continue  # the [DONE] terminator follows
            tok = ev.get("token")
            if tok is None:
                continue
            if req.logprobs > 0:
                req.token_logprobs.append(ev.get("logprob"))
                req.top_logprobs.append([(int(d["id"]), float(d["logprob"]))
                                         for d in ev.get("top_logprobs") or []])
            req.output.append(int(tok))
            cb = req.on_token
            if cb is not None:
                try:
                    cb(int(tok))
                except Exception:
                    log.warning("on_token raised during migration relay; streaming "
                                "disabled", exc_info=True)
                    req.on_token = None
    except (OSError, ValueError) as e:
        if not req.error:
            req.error = f"migration relay broke: {e}"
    finally:
        try:
            conn.close()
        except OSError:
            pass
        req.done.set()


def _logprobs_payload(req: Request) -> dict:
    return {
        "token_logprobs": req.token_logprobs,
        "top_logprobs": [[{"id": t, "logprob": lp} for t, lp in top]
                         for top in req.top_logprobs],
    }


def _reject_code(error: str) -> int:
    """draining or a failed mesh engine → 503 (retry elsewhere); queue full
    → 429 (back off); everything else → 400."""
    if error in (DRAINING_ERROR, ENGINE_FAILED_ERROR):
        return 503
    if error == QUEUE_FULL_ERROR:
        return 429
    return 400


def make_handler(loop: EngineLoop, request_timeout: float = 300.0):
    engine = loop.engine

    class InferenceHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "tpu-elastic-inference-torch"

        def log_message(self, fmt, *args):
            log.debug("inference http: " + fmt, *args)

        def _json(self, code: int, obj: dict, extra_headers: Optional[dict] = None) -> None:
            data = json.dumps(obj).encode()
            self.send_response(code, _REASONS.get(code, ""))
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _metrics(self) -> None:
            # scrape-time gauges from live engine state (reset first, so a
            # drained priority class does not linger); the lock makes
            # reset + set + expose atomic across concurrent scrapes
            eng = engine
            with _SCRAPE_LOCK:
                SERVE_QUEUE_DEPTH.reset()
                for pri, depth in eng.queue_depths().items():
                    SERVE_QUEUE_DEPTH.set(str(pri), value=float(depth))
                SERVE_SPILLS.set(value=float(eng.spills))
                free = len(eng.free_pages)
                cached = len(eng.page_key)
                total = eng.n_pages - 1
                KV_PAGES_RESIDENT.set("active", value=float(total - free - cached))
                KV_PAGES_RESIDENT.set("cached", value=float(cached))
                KV_PAGES_RESIDENT.set("free", value=float(free))
                KV_PAGES_SHIPPED.set("exported", value=float(eng.kv_pages_exported))
                KV_PAGES_SHIPPED.set("imported", value=float(eng.kv_pages_imported))
                KV_PREFIX_ADMISSIONS.set("hit", value=float(eng.prefix_admission_hits))
                KV_PREFIX_ADMISSIONS.set(
                    "miss", value=float(eng.prefix_lookups - eng.prefix_admission_hits))
                # the engine's buffered per-chunk gap samples: the scraper
                # pays the bucketing, never the engine
                SERVE_HOST_GAP.observe_batch(values=eng.drain_host_gaps())
                data = REGISTRY.expose().encode()
            self.send_response(200, "OK")
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/healthz":
                wu = loop.warmup
                if loop.failed.is_set():
                    # a warm-up point that failed on some rank of a mesh
                    # stops the loop too: the body says which
                    return self._json(503, dict({"ok": False, "failed": True},
                                                **({"warmup_failed": True, "warmup": wu.to_dict()}
                                                   if wu is not None and wu.failed else {})))
                if engine.draining:
                    return self._json(503, {"ok": False, "draining": True})
                if wu is not None and wu.warming:
                    # capacity is coming, not going: the fleet router holds
                    # the replica in 'warming', distinct from draining
                    return self._json(503, {"ok": False, "warming": True,
                                            "warmup": wu.to_dict()})
                if wu is not None and wu.failed:
                    # no kernel library (or no lattice): every request
                    # would fail at its first kernel call
                    return self._json(503, {"ok": False, "warmup_failed": True,
                                            "warmup": wu.to_dict()})
                return self._json(200, {"ok": True})
            if self.path == "/version":
                return self._json(200, {"version": __version__})
            if self.path == "/metrics":
                return self._metrics()
            if self.path == "/debug/profiles":
                return self._json(200, PROFILER.debug_state())
            if self.path == "/debug/slo":
                return self._json(200, SLO.debug_state())
            if self.path == "/debug/policy":
                return self._json(200, POLICIES.debug_state())
            if self.path.startswith("/debug/trace/"):
                tid = self.path[len("/debug/trace/"):].split("?", 1)[0]
                return self._json(200, local_trace_payload(tid))
            if self.path.split("?", 1)[0] == "/traces":
                _, _, query = self.path.partition("?")
                return self._json(200, traces_response(
                    dict(parse_qsl(query, keep_blank_values=True))))
            if self.path == "/v1/stats":
                eng = engine
                return self._json(200, {
                    "queued_by_priority": {
                        str(k): v for k, v in eng.queue_depths().items()
                    },
                    "spills": int(eng.spills),
                    "active_slots": sum(1 for s in eng.slots if s is not None),
                    "max_batch": eng.max_batch,
                    "queued": eng.queue.qsize(),
                    "free_pages": len(eng.free_pages),
                    "total_pages": eng.n_pages - 1,
                    "prefix_hit_tokens": int(eng.prefix_hit_tokens),
                    "adapters": sorted(a for a in eng.adapter_index if a),
                    "page_size": eng.page_size,
                    "prefill_chunk": eng.prefill_chunk,
                    "paged_kernel": eng.paged_kernel,
                    "vocab_size": eng.cfg.vocab_size,
                    "device": str(eng.device),
                    "mesh": (None if eng.mesh is None else
                             {"shape": {a: n for a, n in eng.mesh.shape.items() if n > 1},
                              "ranks": eng.mesh.size}),
                    "steps_run": int(eng.steps_run),
                    "prefills_run": int(eng.prefills_run),
                    "tokens_emitted": int(eng.tokens_emitted),
                    # speculation: spec_accepted / spec_passes is the mean
                    # count of extra tokens a verify pass bought
                    "spec_k": eng.spec_k,
                    "spec_passes": int(eng.spec_passes),
                    "spec_accepted": int(eng.spec_accepted),
                    "draft_model": eng.draft is not None,
                    "logprobs_k": eng.logprobs_k,
                    "max_queue": eng.max_queue,
                    # the overlapped pipeline: its mode, the host gap it
                    # exists to shrink, and the transfer-count probe
                    "overlap": eng.overlap,
                    "host_gap": {
                        k: round(v, 4) if isinstance(v, float) else v
                        for k, v in eng.host_gap_stats().items()
                    },
                    "device_uploads": int(eng.device_uploads),
                    "chunks_discarded": int(eng.chunks_discarded),
                    # the fleet's view: the router keeps prefill-role
                    # replicas out of completion rotation
                    "replica": eng.replica_name,
                    "role": eng.fleet_role,
                    # KV shipping and prefix-cache counters, under the
                    # reference's names
                    "kv": {
                        "pages_exported": int(eng.kv_pages_exported),
                        "pages_imported": int(eng.kv_pages_imported),
                        "export_bundles": int(eng.kv_exports),
                        "import_bundles": int(eng.kv_imports),
                        "migrated_out": int(eng.sessions_migrated_out),
                        "migrated_in": int(eng.sessions_migrated_in),
                        "prefix_lookups": int(eng.prefix_lookups),
                        "prefix_hits": int(eng.prefix_admission_hits),
                        "prefix_misses": int(
                            eng.prefix_lookups - eng.prefix_admission_hits
                        ),
                        "resident_pages": int(eng.n_pages - 1 - len(eng.free_pages)),
                        "cached_pages": len(eng.page_key),
                    },
                    # the warm-start plane: the warm-up's state and the
                    # cache's counters (a second start on the same dir
                    # shows fills 0), and the decode graphs captured so far
                    "warmup": (loop.warmup.to_dict() if loop.warmup is not None
                               else {"state": "none"}),
                    "compile_cache": (eng.compile_cache.stats()
                                      if eng.compile_cache is not None else None),
                    "graphs_captured": int(eng.graphs_captured),
                    "graph_replays": int(eng.graph_replays),
                    # this process's hand-written kernel launches by kernel
                    # (none on the CPU, where the plain versions run)
                    "kernel_launches": dict(_build.LAUNCHES),
                })
            return self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            # drain accounting: the response (incl. an SSE stream) must
            # flush before a draining process may exit
            loop.inflight_enter()
            try:
                return self._do_post()
            finally:
                loop.inflight_exit()

        def _do_post(self):
            # the disaggregated data plane: engine state is touched only
            # through engine.run_verb (the engine thread owns it; on a mesh
            # the verb rides a ticket to every rank)
            route = {"/v1/prefill": self._prefill_only, "/v1/kv/export": self._kv_export,
                     "/v1/kv/adopt": self._kv_adopt, "/v1/migrate/out": self._migrate_out,
                     "/v1/migrate/in": self._migrate_in, "/policy/load": self._policy,
                     "/policy/rollback": self._policy}.get(self.path)
            if route is not None:
                return route()
            if self.path != "/v1/completions":
                return self._json(404, {"error": f"no route {self.path}"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                reqs = _requests_from_body(body, engine.cfg.vocab_size, engine.max_batch)
            except (ValueError, TypeError, OverflowError, json.JSONDecodeError) as e:
                return self._json(400, {"error": str(e)})
            kv_src = self.headers.get(KV_SOURCE_HEADER)
            if kv_src and engine.prefix_cache:
                # the router knows another replica holds this prompt's
                # pages: pull them before admission, so _match_prefix
                # skips their prefill.  Best-effort: any failure just
                # prefills here
                try:
                    self._adopt_from(kv_src, body.get("prompt"), str(body.get("adapter", "")))
                except Exception:
                    log.warning("KV adoption from %s failed; prefilling here", kv_src,
                                exc_info=True)
            # a client traceparent joins its trace, else the request roots
            # one; the context rides on each Request so the engine thread
            # drops its points into the same trace
            with TRACER.span("serve.request",
                             parent=self.headers.get(TRACEPARENT_HEADER) or None,
                             n=len(reqs), stream=bool(body.get("stream")),
                             prompt_tokens=len(reqs[0].prompt),
                             max_tokens=reqs[0].max_new_tokens) as sp:
                ctx = sp.context() if sp else None
                for r in reqs:
                    r.trace_ctx = ctx
                if body.get("stream"):
                    return self._stream(reqs)
                if len(reqs) > 1:
                    return self._multi(reqs)
                return self._single(reqs[0], sp)

        # -- the disaggregated serving data plane -------------------------

        def _read_json(self) -> dict:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
            return body

        def _bytes_resp(self, code: int, data: bytes) -> None:
            self.send_response(code, _REASONS.get(code, ""))
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _adopt_from(self, source: str, tokens, adapter: str, max_pages: int = 0) -> dict:
            """Pull the prefix's cached pages from ``source`` and land them
            here; skipped when the local cache already covers every page
            admission could attach."""
            if not isinstance(tokens, list) or not all(
                isinstance(t, int) and not isinstance(t, bool) for t in tokens
            ):
                return {"imported": 0, "reason": "no adoptable prompt"}
            want = max(0, (len(tokens) - 1) // engine.page_size)
            if max_pages > 0:
                want = min(want, max_pages)
            if want == 0:
                return {"imported": 0, "reason": "prompt shorter than one full page"}
            have = engine.run_task(lambda: len(engine.cached_prefix_pages(tokens, adapter)))
            if have >= want:
                return {"imported": 0, "already": have,
                        "reason": "local cache already covers the prefix"}
            status, data = _backend_post(
                source, "/v1/kv/export",
                json.dumps({"tokens": tokens, "adapter": adapter,
                            "max_pages": max_pages}).encode(),
                "application/json", timeout=ADOPT_PULL_TIMEOUT_S,
            )
            if status != 200:
                return {"imported": 0, "reason": f"source answered {status}"}
            hdr, pages = kvwire.decode_bundle(data)
            return engine.run_verb("import", header=hdr, pages=pages)

        def _policy(self):
            """The ``kv`` verb's control surface, on the reference
            scheduler's bodies (its gate and canary fields are ignored: a
            ``kv`` policy decides every eviction once loaded)."""
            try:
                body = self._read_json()
                if self.path == "/policy/load":
                    for name in ("name", "verb", "expr"):
                        if not body.get(name):
                            raise ValueError(f"missing field {name!r}")
                    out = POLICIES.load(str(body["name"]), str(body["verb"]), str(body["expr"]),
                                        budget=int(body.get("budget", DEFAULT_BUDGET)))
                else:
                    out = POLICIES.rollback(str(body.get("verb", "kv")),
                                            reason=str(body.get("reason", "operator")))
            except (ValueError, TypeError) as e:
                # a bad expression, verb or field is the client's, never a 500
                return self._json(400, {"Error": str(e)})
            return self._json(200, out)

        def _prefill_only(self):
            """Prefill-role admission, the split's first half: the prompt
            runs through (chunked) prefill, so its pages land in this
            replica's prefix cache, ready for export.  It costs one
            emitted and discarded token: the completion path exactly."""
            if not engine.prefix_cache:
                return self._json(409, {"error": "prefix cache disabled (--prefix-cache)"})
            try:
                body = self._read_json()
                prompt = _token_ids(body.get("prompt"), engine.cfg.vocab_size, "prompt")
                adapter = str(body.get("adapter", ""))
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                return self._json(400, {"error": str(e)})
            t0 = time.monotonic()
            req = Request(prompt=list(prompt), max_new_tokens=1, adapter=adapter)
            engine.submit(req)
            if not req.done.wait(request_timeout):
                req.cancel()
                req.done.wait(10.0)
                return self._json(504, {"error": "prefill timed out"})
            if req.error:
                return self._json(_reject_code(req.error), {"error": req.error})
            return self._json(200, {
                "ok": True,
                "tokens": len(prompt),
                # the pages a later admission or export can use (len - 1)
                "pages": max(0, (len(prompt) - 1) // engine.page_size),
                "replica": engine.replica_name,
                "wall_ms": round((time.monotonic() - t0) * 1000, 3),
            })

        def _kv_export(self):
            if not engine.prefix_cache:
                return self._json(409, {"error": "prefix cache disabled (--prefix-cache)"})
            try:
                body = self._read_json()
                tokens = _token_ids(body.get("tokens"), engine.cfg.vocab_size, "tokens")
                adapter = str(body.get("adapter", ""))
                max_pages = int(body.get("max_pages", 0))
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                return self._json(400, {"error": str(e)})
            try:
                data = engine.run_verb("export", tokens=tokens, adapter=adapter,
                                       max_pages=max_pages)
            except (TimeoutError, RuntimeError) as e:
                return self._json(503, {"error": str(e)})
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            if data is None:
                return self._json(404, {"error": "no cached pages for this prefix"})
            return self._bytes_resp(200, data)

        def _kv_adopt(self):
            if not engine.prefix_cache:
                return self._json(409, {"error": "prefix cache disabled (--prefix-cache)"})
            try:
                body = self._read_json()
                source = str(body.get("source", ""))
                if not source:
                    raise ValueError("'source' (host:port) is required")
                res = self._adopt_from(source, body.get("tokens"),
                                       str(body.get("adapter", "")),
                                       int(body.get("max_pages", 0)))
            except kvwire.WireError as e:
                return self._json(502, {"error": f"corrupt bundle: {e}"})
            except OSError as e:  # TimeoutError included, as the reference answers
                return self._json(502, {"error": f"source pull failed: {e}"})
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                return self._json(400, {"error": str(e)})
            return self._json(200, res)

        def _migrate_out(self):
            """Live migration, source side: detach a session (the
            ``choose_kv_victim`` ranking unless a slot is named), ship it
            to ``dest``, then relay the destination's continuation into
            the original request.  A refused handoff requeues the session
            here (an exact resume), so it is never lost."""
            try:
                body = self._read_json()
                dest = str(body.get("dest", ""))
                if not dest:
                    raise ValueError("'dest' (host:port) is required")
                slot = body.get("slot")
                if slot is not None and (isinstance(slot, bool) or not isinstance(slot, int)):
                    raise ValueError("'slot' must be an integer")
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                return self._json(400, {"error": str(e)})

            try:
                got = engine.run_verb("migrate_out", slot=slot,
                                      local={"chooser": choose_kv_victim})
            except (TimeoutError, RuntimeError) as e:
                # abandoned (or a failed mesh): nothing was detached
                return self._json(503, {"error": str(e)})
            if got is None:
                return self._json(409, {"error": "no live session to migrate"})
            i, req, data, n_pages = got
            resp, conn, err = _backend_stream(dest, "/v1/migrate/in", data)
            if resp is None or resp.status != 200:
                if resp is not None:
                    err = f"destination answered {resp.status}"
                    try:
                        conn.close()
                    except OSError:
                        pass

                # the session is ours again: the exact local resume, with
                # the migrate-out counters rolled back
                try:
                    # not abandonable: the requeue must run eventually
                    engine.run_verb("requeue", local={"req": req}, pages=n_pages,
                                    abandon_on_timeout=False)
                except TimeoutError:
                    log.warning("local resume of a refused migration is queued behind a "
                                "busy engine; it runs at the next admission pass")
                KV_MIGRATIONS.inc("out_refused")
                return self._json(502, {"ok": False, "resumed_local": True, "error": err})
            threading.Thread(target=_relay_migrated, args=(req, resp, conn),
                             name="migrate-relay", daemon=True).start()
            KV_MIGRATIONS.inc("out")
            return self._json(200, {"ok": True, "slot": i, "dest": dest,
                                    "pages_shipped": n_pages,
                                    "tokens_done": len(req.output)})

        def _migrate_in(self):
            """Live migration, destination side: import the bundle's
            pages, resume the session (matching what just landed) and
            stream the continuation back as SSE; the source relays it
            into the original client's stream."""
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length)
            try:
                hdr, pages = kvwire.decode_bundle(raw)
            except kvwire.WireError as e:
                return self._json(400, {"error": str(e)})
            if hdr.get("kind") != "session":
                return self._json(400, {
                    "error": f"expected a session bundle, got {hdr.get('kind')!r}"})
            state = hdr.get("request") or {}
            q: "queue.Queue" = queue.Queue()
            box: dict = {}

            def on_token(tok):
                r = box["req"]
                if r.logprobs > 0:
                    q.put((0, tok, r.token_logprobs[-1], r.top_logprobs[-1]))
                else:
                    q.put((0, tok, None, None))

            try:
                req = engine.session_request(state, on_token=on_token)
                box["req"] = req
                req = engine.run_verb("migrate_in", header=hdr, pages=pages,
                                      local={"req": req})
            except TimeoutError as e:
                # abandoned (engine busy): nothing landed, the source keeps
                # the session, so it never runs on two replicas
                return self._json(503, {"error": str(e)})
            except RuntimeError as e:
                return self._json(503, {"error": str(e)})
            except (ValueError, TypeError) as e:
                return self._json(400, {"error": str(e)})
            KV_MIGRATIONS.inc("in")
            self._sse_reply([req], q, "migrated session timed out")

        def _replica_journey(self, sp, ok: bool, e2e_ms: float, queue_ms, tokens: int,
                             ttft_ms=None, tpot_ms=None) -> None:
            """This replica's own vantage on the journey (the router
            records the client's): one append when the SLO plane is on."""
            if not SLO.enabled:
                return
            SLO.record_journey(
                vantage="replica", ok=ok, ttft_ms=ttft_ms, tpot_ms=tpot_ms,
                e2e_ms=round(e2e_ms, 3), queue_ms=queue_ms, tokens=tokens,
                trace_id=sp.trace_id if sp else "", replica=engine.replica_name,
            )

        def _single(self, req: Request, sp):
            t0 = time.monotonic()
            engine.submit(req)
            if not req.done.wait(request_timeout):
                req.cancel()  # the engine frees the slot at the next boundary
                acked = req.done.wait(10.0)
                SERVE_REQUESTS.inc("timeout")
                e2e = time.monotonic() - t0
                SERVE_LATENCY.observe(value=e2e)
                if acked:  # tokens handed over are emitted work
                    SERVE_TOKENS.inc(value=len(req.output))
                self._replica_journey(sp, ok=False, e2e_ms=e2e * 1000,
                                      queue_ms=_queue_wait_ms(req),
                                      tokens=len(req.output) if acked else 0)
                return self._json(504, {
                    "error": "generation timed out",
                    "tokens": list(req.output) if acked else [],
                    **({"logprobs": _logprobs_payload(req)}
                       if acked and req.logprobs > 0 else {}),
                })
            e2e = time.monotonic() - t0
            SERVE_LATENCY.observe(value=e2e)
            queue_ms = _queue_wait_ms(req)
            if req.error:
                SERVE_REQUESTS.inc("error")
                sp.set_attr("error", req.error)
                self._replica_journey(sp, ok=False, e2e_ms=e2e * 1000, queue_ms=queue_ms,
                                      tokens=0)
                return self._json(_reject_code(req.error), {"error": req.error})
            SERVE_REQUESTS.inc("ok")
            SERVE_TOKENS.inc(value=len(req.output))
            sp.set_attr("tokens", len(req.output))
            resp = {"tokens": req.output}
            if req.logprobs > 0:
                resp["logprobs"] = _logprobs_payload(req)
            self._replica_journey(sp, ok=True, e2e_ms=e2e * 1000, queue_ms=queue_ms,
                                  tokens=len(req.output))
            # a blocking answer's headers go out after generation, so the
            # queue wait rides a header (a stream's, an SSE comment)
            extra = ({"X-TPU-Queue-Wait-Ms": f"{queue_ms:.3f}"}
                     if queue_ms is not None else None)
            return self._json(200, resp, extra_headers=extra)

        def _multi(self, reqs: list):
            """``n`` parallel choices: submit all, wait for all, answer the
            indexed choices; one choice's error cancels its siblings and
            answers for the request."""
            t0 = time.monotonic()
            deadline = t0 + request_timeout
            for r in reqs:
                engine.submit(r)
            timed_out = cancelled_for_err = False
            for r in reqs:
                if not cancelled_for_err and any(x.error for x in reqs):
                    cancelled_for_err = True
                    for x in reqs:
                        x.cancel()
                if not r.done.wait(max(0.0, deadline - time.monotonic())):
                    timed_out = True
                    r.cancel()
            # only read a choice's output once the engine acknowledged it
            acked = {id(r): r.done.wait(10.0) if timed_out or cancelled_for_err else True
                     for r in reqs}
            SERVE_LATENCY.observe(value=time.monotonic() - t0)
            errs = [r.error for r in reqs if r.error]
            if errs:
                # only the errored choices are errors; their siblings were
                # cancelled
                SERVE_REQUESTS.inc("error", value=float(len(errs)))
                if len(errs) < len(reqs):
                    SERVE_REQUESTS.inc("cancelled", value=float(len(reqs) - len(errs)))
                return self._json(_reject_code(errs[0]), {"error": errs[0]})
            SERVE_REQUESTS.inc("timeout" if timed_out else "ok", value=float(len(reqs)))
            choices = []
            for k, r in enumerate(reqs):
                ok = acked[id(r)]
                c = {"index": k, "tokens": list(r.output) if ok else []}
                if ok:
                    SERVE_TOKENS.inc(value=len(r.output))
                if ok and r.logprobs > 0:
                    c["logprobs"] = _logprobs_payload(r)
                choices.append(c)
            out = {"choices": choices}
            if timed_out:
                out["error"] = "generation timed out"
            return self._json(504 if timed_out else 200, out)

        def _stream(self, reqs: list):
            # tokens go from the ENGINE thread into a queue sized for every
            # choice's whole response; this handler thread writes them out,
            # so a slow client never blocks generation.  Events carry
            # "index" when n > 1.
            n = len(reqs)
            q: "queue.Queue" = queue.Queue(maxsize=sum(r.max_new_tokens for r in reqs) + 2 * n)

            def make_on_token(k, r):
                def on_token(tok):
                    # the engine thread, after _emit appended this token's
                    # logprobs: reading [-1] here is safe
                    if r.logprobs > 0:
                        q.put((k, tok, r.token_logprobs[-1], r.top_logprobs[-1]))
                    else:
                        q.put((k, tok, None, None))
                return on_token

            for k, r in enumerate(reqs):
                r.on_token = make_on_token(k, r)
            t0 = time.monotonic()
            for r in reqs:
                engine.submit(r)
            bad = [r for r in reqs if r.done.is_set() and r.error]
            if bad:
                # rejected at submit: the same answer as the blocking path
                for r in reqs:
                    r.cancel()
                return self._json(_reject_code(bad[0].error), {"error": bad[0].error})
            self._sse_reply(reqs, q, "generation timed out", t0=t0)

        def _sse_reply(self, reqs: list, q: "queue.Queue", timeout_error: str,
                       t0: Optional[float] = None) -> None:
            """Write (choice, token, logprob, top) items from ``q`` as SSE
            events, one HTTP chunk per burst, until every request is done
            or the deadline passes; then each error event and [DONE].
            Events carry "index" when there are several choices.  A dead
            client cancels the requests: seen on a write, or while no token
            is due (still queued, or between chunks) by a peek of the socket
            and two SSE-comment pings, which a half-closed client that still
            reads survives.

            ``t0`` (a completion's submit time; None for a migrated
            session's continuation, whose source counts it) turns on the
            completion's instruments: the ``: slo`` comment before the first
            token, the serving series, the request span's trace pinned
            while the stream runs, and the replica journey."""
            n = len(reqs)
            completion = t0 is not None
            # the serve.request span is on this thread's stack
            sp = (TRACER.current() or None) if completion else None
            self.send_response(200, "OK")
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            flushes = 0

            def chunk(payloads: list) -> None:
                nonlocal flushes
                data = b"".join(f"data: {p}\n\n".encode() for p in payloads)
                self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()
                flushes += 1
                if flushes == 1 and sp is not None:
                    sp.event("sse_first_flush")

            def event_json(item) -> str:
                k, tok, lp, top = item
                ev = {"token": tok}
                if n > 1:
                    ev["index"] = k
                if lp is not None:
                    ev["logprob"] = lp
                    ev["top_logprobs"] = [{"id": t, "logprob": v} for t, v in top]
                return json.dumps(ev)

            def ping() -> None:
                # an SSE comment line, which clients ignore: a probe of the socket
                data = b": ping\n\n"
                self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()

            sent = 0
            t_first_tok = t_last_tok = 0.0
            half_closed = False  # the client shut down its sending side: legal
            # a live stream's spans must survive span pressure from other
            # requests: pinned until the stream ends
            pinned_tid = sp.trace_id if sp is not None else ""
            TRACER.pin(pinned_tid)
            deadline = time.monotonic() + request_timeout
            try:
                while time.monotonic() < deadline:
                    try:
                        first = q.get(timeout=0.1)
                    except queue.Empty:
                        if all(r.done.is_set() for r in reqs) and q.empty():
                            break
                        if not half_closed and self._client_gone():
                            # EOF while no token is due (queued, or between
                            # chunks): a closed client, or a half-close that
                            # still reads.  Two pings tell them apart: a closed
                            # socket raises by the second write (the first may
                            # sit in the send buffer until the reset comes back)
                            try:
                                ping()
                                time.sleep(0.05)
                                ping()
                            except OSError:
                                raise BrokenPipeError("client disconnected") from None
                            half_closed = True  # EOF stays: stop peeking
                        continue
                    if completion and not t_first_tok:
                        t_first_tok = time.monotonic()
                        # an SSE comment, which clients ignore: the queue
                        # wait for the fleet router's journey record (the
                        # stream's headers went out before admission)
                        qw = _queue_wait_ms(reqs[0])
                        if qw is not None:
                            meta = f': slo {{"queue_ms": {qw:.3f}}}\n\n'.encode()
                            self.wfile.write(f"{len(meta):x}\r\n".encode() + meta + b"\r\n")
                    items = [first]
                    while True:  # one HTTP chunk per burst of tokens
                        try:
                            items.append(q.get_nowait())
                        except queue.Empty:
                            break
                    chunk([event_json(e) for e in items])
                    sent += len(items)
                    t_last_tok = time.monotonic()
                if not all(r.done.is_set() for r in reqs):
                    for r in reqs:
                        r.cancel()
                    if completion:
                        SERVE_REQUESTS.inc("timeout", value=float(n))
                    chunk([json.dumps({"error": timeout_error})])
                else:
                    for k, r in enumerate(reqs):
                        if r.error:
                            ev = {"error": r.error, **({"index": k} if n > 1 else {})}
                            chunk([json.dumps(ev)])
                        if completion:
                            SERVE_REQUESTS.inc("error" if r.error else "ok")
                chunk(["[DONE]"])
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                for r in reqs:
                    r.cancel()  # dead client: a slot goes at the next chunk boundary
                engine._purge_cancelled_queued()  # a queue entry goes now
                if completion:
                    SERVE_REQUESTS.inc("cancelled", value=float(n))
                log.info("stream client disconnected after %d tokens", sent)
            finally:
                TRACER.unpin(pinned_tid)
                if completion:
                    e2e = time.monotonic() - t0
                    SERVE_LATENCY.observe(value=e2e)
                    SERVE_TOKENS.inc(value=sent)
                    if sp is not None:
                        sp.set_attr("sse_chunks", sent)
                        sp.set_attr("sse_flushes", flushes)
                    self._replica_journey(
                        sp, ok=all(r.done.is_set() and not r.error for r in reqs),
                        e2e_ms=e2e * 1000, queue_ms=_queue_wait_ms(reqs[0]), tokens=sent,
                        ttft_ms=round((t_first_tok - t0) * 1000, 3) if t_first_tok else None,
                        tpot_ms=(round((t_last_tok - t_first_tok) * 1000 / (sent - 1), 3)
                                 if sent > 1 and t_last_tok > t_first_tok else None),
                    )

        def _client_gone(self) -> bool:
            """True when a zero-timeout peek finds the client socket at EOF
            or in error.  Completion clients send nothing mid-stream, so a
            readable socket with no bytes is a close (or a half-close, which
            the caller's ping tells apart).  ``poll``, not ``select``:
            ``select`` raises for descriptors past FD_SETSIZE, which a busy
            server would take for a disconnect."""
            try:
                p = select.poll()
                p.register(self.connection, select.POLLIN | select.POLLHUP)
                if not p.poll(0):
                    return False
                return self.connection.recv(1, socket.MSG_PEEK) == b""
            except OSError:
                return True

    return InferenceHandler


def drain(loop: EngineLoop, timeout: float = 30.0, poll: float = 0.05) -> bool:
    """Graceful drain: reject new requests (503, /healthz 503), wait for
    in-flight requests to finish and for handlers to flush.  True when
    fully drained, False on timeout.  The loop must keep running."""
    engine = loop.engine
    engine.draining = True
    engine._work.set()
    deadline = time.monotonic() + timeout
    engine_idle = loop.drained.wait(max(0.0, deadline - time.monotonic()))
    while time.monotonic() < deadline and loop.http_inflight > 0:
        time.sleep(poll)
    return (
        engine_idle
        or (not any(s is not None for s in engine.slots) and engine.queue.empty())
    ) and loop.http_inflight == 0


class _Server(ThreadingHTTPServer):
    # the stdlib's listen backlog of 5 drops the connections past it in a
    # burst of concurrent clients, and each of those waits a second for its
    # SYN to be sent again
    request_queue_size = 128


def serve_inference(
    engine: InferenceEngine,
    port: int = 8000,
    host: str = "0.0.0.0",
    request_timeout: float = 300.0,
    warmup=None,
) -> tuple[ThreadingHTTPServer, EngineLoop]:
    """Start the engine loop and the HTTP server (daemon threads); the
    caller owns shutdown: ``server.shutdown(); loop.stop()``.  ``warmup``
    (a ``WarmupState``) is the loop's before the server listens, so
    ``/healthz`` never answers 200 ahead of the warm-up."""
    loop = EngineLoop(engine)
    loop.warmup = warmup
    loop.start()
    server = _Server((host, port), make_handler(loop, request_timeout))
    threading.Thread(target=server.serve_forever, name="inference-http", daemon=True).start()
    log.info("inference server on %s:%d", host, server.server_address[1])
    return server, loop
