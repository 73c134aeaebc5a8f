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
    GET  /v1/stats         → engine state (slots, pages, queue, prefix cache,
                             registered adapters)
    GET  /healthz          → liveness (503 while draining)
    GET  /version          → build version

ONE engine thread (``EngineLoop``) owns all engine state and drives fused
chunks; HTTP handler threads only submit requests and wait on them.  An
unknown adapter is a 400 naming the registered ones; a full bounded queue
is a 429.  The reference's
disaggregated-serving verbs (``/v1/kv/*``, ``/v1/prefill``,
``/v1/migrate/*``) are not ported and answer 404.
"""

from __future__ import annotations

import json
import logging
import math
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from .. import __version__
from ..models.serving import DRAINING_ERROR, QUEUE_FULL_ERROR, InferenceEngine, Request

log = logging.getLogger("tpu-scheduler")

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found", 429: "Too Many Requests",
            503: "Service Unavailable", 504: "Gateway Timeout"}

def choose_kv_victim(eng: InferenceEngine) -> int:
    """The slot to preempt when every slot stalls for pages: the lowest
    priority, most pages held as the tie-break."""
    live = [
        i for i, s in enumerate(eng.slots) if s is not None and not s.done.is_set()
    ]
    return min(live, key=lambda i: (int(eng.priorities[i]), -len(eng.slot_pages[i])))


class EngineLoop:
    """Single thread that owns the engine: admit + step while work exists,
    park on the engine's work event when idle.  Before it parks (and so
    before a drain can complete) it drains the overlapped engine's chunk
    still in flight, so no dispatched work outlives the requests."""

    def __init__(self, engine: InferenceEngine):
        self.engine = engine
        self.idle_parks = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # set by the LOOP thread when it observes draining + idle
        self.drained = threading.Event()
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

    def _serve(self) -> None:
        eng = self.engine
        failures = 0
        while not self._stop.is_set():
            try:
                eng._admit()
                if any(s is not None for s in eng.slots):
                    eng.step()
                else:
                    eng._drain_pending()
                    if eng.draining and eng.queue.empty():
                        self.drained.set()
                    # clear → re-check → wait: a submit after the clear
                    # re-sets the event, so no wakeup is lost
                    eng._work.clear()
                    if (
                        eng.queue.empty()
                        and not any(s is not None for s in eng.slots)
                        and not self._stop.is_set()
                    ):
                        self.idle_parks += 1
                        eng._work.wait()
                failures = 0
            except RuntimeError as e:
                if "page pool exhausted" not in str(e):
                    failures += 1
                    self._fail_all("internal engine error", failures)
                    continue
                # overload, not a bug: preempt ONE victim.  Its first
                # eviction requeues it for an exact resume; a second means
                # it cannot fit the pool and it fails.
                victim = choose_kv_victim(eng)
                req = eng.slots[victim]
                log.warning(
                    "KV page pool exhausted; preempting priority-%d slot %d "
                    "(%d pages held)", int(eng.priorities[victim]), victim,
                    len(eng.slot_pages[victim]),
                )
                if req.pool_spills < 1:
                    req.pool_spills += 1
                    eng.spills += 1
                    eng._release_slot(victim)
                    eng._enqueue(req)
                else:
                    req.error = "preempted: KV page pool exhausted"
                    req.done.set()
                    eng._release_slot(victim)
            except Exception:
                failures += 1
                self._fail_all("internal engine error", failures)

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


def _logprobs_payload(req: Request) -> dict:
    return {
        "token_logprobs": req.token_logprobs,
        "top_logprobs": [[{"id": t, "logprob": lp} for t, lp in top]
                         for top in req.top_logprobs],
    }


def _reject_code(error: str) -> int:
    """draining → 503 (retry elsewhere); queue full → 429 (back off);
    everything else → 400."""
    if error == DRAINING_ERROR:
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

        def _json(self, code: int, obj: dict) -> None:
            data = json.dumps(obj).encode()
            self.send_response(code, _REASONS.get(code, ""))
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/healthz":
                if engine.draining:
                    return self._json(503, {"ok": False, "draining": True})
                return self._json(200, {"ok": True})
            if self.path == "/version":
                return self._json(200, {"version": __version__})
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
                    # the prefix-cache counters, under the reference's names
                    "kv": {
                        "prefix_lookups": int(eng.prefix_lookups),
                        "prefix_hits": int(eng.prefix_admission_hits),
                        "prefix_misses": int(
                            eng.prefix_lookups - eng.prefix_admission_hits
                        ),
                        "resident_pages": int(eng.n_pages - 1 - len(eng.free_pages)),
                        "cached_pages": len(eng.page_key),
                    },
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
            if self.path != "/v1/completions":
                return self._json(404, {"error": f"no route {self.path}"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                reqs = _requests_from_body(body, engine.cfg.vocab_size, engine.max_batch)
            except (ValueError, TypeError, OverflowError, json.JSONDecodeError) as e:
                return self._json(400, {"error": str(e)})
            if body.get("stream"):
                return self._stream(reqs)
            if len(reqs) > 1:
                return self._multi(reqs)
            return self._single(reqs[0])

        def _single(self, req: Request):
            engine.submit(req)
            if not req.done.wait(request_timeout):
                req.cancel()  # the engine frees the slot at the next boundary
                acked = req.done.wait(10.0)
                return self._json(504, {
                    "error": "generation timed out",
                    "tokens": list(req.output) if acked else [],
                    **({"logprobs": _logprobs_payload(req)}
                       if acked and req.logprobs > 0 else {}),
                })
            if req.error:
                return self._json(_reject_code(req.error), {"error": req.error})
            resp = {"tokens": req.output}
            if req.logprobs > 0:
                resp["logprobs"] = _logprobs_payload(req)
            return self._json(200, resp)

        def _multi(self, reqs: list):
            """``n`` parallel choices: submit all, wait for all, answer the
            indexed choices; one choice's error cancels its siblings and
            answers for the request."""
            deadline = time.monotonic() + request_timeout
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
            errs = [r.error for r in reqs if r.error]
            if errs:
                return self._json(_reject_code(errs[0]), {"error": errs[0]})
            choices = []
            for k, r in enumerate(reqs):
                ok = acked[id(r)]
                c = {"index": k, "tokens": list(r.output) if ok else []}
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
            for r in reqs:
                engine.submit(r)
            bad = [r for r in reqs if r.done.is_set() and r.error]
            if bad:
                # rejected at submit: the same answer as the blocking path
                for r in reqs:
                    r.cancel()
                return self._json(_reject_code(bad[0].error), {"error": bad[0].error})
            self.send_response(200, "OK")
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(payloads: list) -> None:
                data = b"".join(f"data: {p}\n\n".encode() for p in payloads)
                self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()

            def event_json(item) -> str:
                k, tok, lp, top = item
                ev = {"token": tok}
                if n > 1:
                    ev["index"] = k
                if lp is not None:
                    ev["logprob"] = lp
                    ev["top_logprobs"] = [{"id": t, "logprob": v} for t, v in top]
                return json.dumps(ev)

            sent = 0
            deadline = time.monotonic() + request_timeout
            try:
                while time.monotonic() < deadline:
                    try:
                        first = q.get(timeout=0.1)
                    except queue.Empty:
                        if all(r.done.is_set() for r in reqs) and q.empty():
                            break
                        continue
                    items = [first]
                    while True:  # one HTTP chunk per burst of tokens
                        try:
                            items.append(q.get_nowait())
                        except queue.Empty:
                            break
                    chunk([event_json(e) for e in items])
                    sent += len(items)
                if not all(r.done.is_set() for r in reqs):
                    for r in reqs:
                        r.cancel()
                    chunk([json.dumps({"error": "generation timed out"})])
                else:
                    for k, r in enumerate(reqs):
                        if r.error:
                            ev = {"error": r.error, **({"index": k} if n > 1 else {})}
                            chunk([json.dumps(ev)])
                chunk(["[DONE]"])
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                for r in reqs:
                    r.cancel()  # dead client: stop generating for it
                log.info("stream client disconnected after %d tokens", sent)

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


def serve_inference(
    engine: InferenceEngine,
    port: int = 8000,
    host: str = "0.0.0.0",
    request_timeout: float = 300.0,
) -> tuple[ThreadingHTTPServer, EngineLoop]:
    """Start the engine loop and the HTTP server (daemon threads); the
    caller owns shutdown: ``server.shutdown(); loop.stop()``."""
    loop = EngineLoop(engine).start()
    server = ThreadingHTTPServer((host, port), make_handler(loop, request_timeout))
    threading.Thread(target=server.serve_forever, name="inference-http", daemon=True).start()
    log.info("inference server on %s:%d", host, server.server_address[1])
    return server, loop
