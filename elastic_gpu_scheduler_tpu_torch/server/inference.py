"""HTTP front end for the port's serving engine.

Counterpart of ``elastic_gpu_scheduler_tpu/server/inference.py`` for the
routes this slice serves (stdlib HTTP only):

    POST /v1/completions   → {"prompt": [ids], "max_tokens": N, ...}
                             blocking JSON, or Server-Sent Events with
                             {"stream": true} (``data: {"token": t}`` …
                             ``data: [DONE]``)
    GET  /v1/stats         → engine state (slots, pages, queue, prefix cache)
    GET  /healthz          → liveness (503 while draining)
    GET  /version          → build version

ONE engine thread (``EngineLoop``) owns all engine state and drives fused
chunks; HTTP handler threads only submit requests and wait on them.  A
body field the slice has not ported (logprobs, penalties, logit bias,
seeds, adapters, n > 1, ...) is a 400 that names it, never ignored.  The
reference's disaggregated-serving verbs (``/v1/kv/*``, ``/v1/prefill``,
``/v1/migrate/*``) are not ported and answer 404.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from .. import __version__
from ..models.serving import DRAINING_ERROR, InferenceEngine, Request

log = logging.getLogger("tpu-scheduler")

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            503: "Service Unavailable", 504: "Gateway Timeout"}

# request fields of the reference's API that this slice does not serve
_UNPORTED_FIELDS = (
    "logprobs", "logit_bias", "allowed_tokens", "frequency_penalty",
    "presence_penalty", "min_tokens", "seed", "adapter",
)


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


def _request_from_body(body: dict, vocab_size: int) -> Request:
    if not isinstance(body, dict):
        raise ValueError("body must be a JSON object")
    asked = [f for f in _UNPORTED_FIELDS if f in body]
    if asked:
        raise ValueError(f"request fields {asked} are not served by this port yet")
    n = body.get("n", 1)
    if n != 1 or isinstance(n, bool):
        raise ValueError("'n' other than 1 is not served by this port yet")
    prompt = _token_ids(body.get("prompt"), vocab_size, "prompt")
    priority = body.get("priority", 0)
    if isinstance(priority, bool) or not isinstance(priority, int):
        raise ValueError("'priority' must be an integer")
    stop = _token_ids(body.get("stop", []), vocab_size, "stop")
    return Request(
        prompt=prompt,
        max_new_tokens=int(body.get("max_tokens", 16)),
        temperature=float(body.get("temperature", 0.0)),
        top_k=int(body.get("top_k", 0)),
        top_p=float(body.get("top_p", 1.0)),
        stop_tokens=tuple(stop),
        priority=priority,
    )


def _reject_code(error: str) -> int:
    """draining → 503 (retry elsewhere); everything else → 400."""
    return 503 if error == DRAINING_ERROR else 400


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
                req = _request_from_body(body, engine.cfg.vocab_size)
            except (ValueError, TypeError, OverflowError, json.JSONDecodeError) as e:
                return self._json(400, {"error": str(e)})
            if body.get("stream"):
                return self._stream(req)
            return self._single(req)

        def _single(self, req: Request):
            engine.submit(req)
            if not req.done.wait(request_timeout):
                req.cancel()  # the engine frees the slot at the next boundary
                acked = req.done.wait(10.0)
                return self._json(504, {
                    "error": "generation timed out",
                    "tokens": list(req.output) if acked else [],
                })
            if req.error:
                return self._json(_reject_code(req.error), {"error": req.error})
            return self._json(200, {"tokens": req.output})

        def _stream(self, req: Request):
            # tokens go from the ENGINE thread into a queue sized for the
            # whole response; this handler thread writes them out, so a
            # slow client never blocks generation
            q: "queue.Queue" = queue.Queue(maxsize=req.max_new_tokens + 2)
            req.on_token = q.put
            engine.submit(req)
            if req.done.is_set() and req.error:
                # rejected at submit: the same 400 as the blocking path
                return self._json(_reject_code(req.error), {"error": req.error})
            self.send_response(200, "OK")
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(payloads: list) -> None:
                data = b"".join(f"data: {p}\n\n".encode() for p in payloads)
                self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()

            sent = 0
            deadline = time.monotonic() + request_timeout
            try:
                while time.monotonic() < deadline:
                    try:
                        first = q.get(timeout=0.1)
                    except queue.Empty:
                        if req.done.is_set() and q.empty():
                            break
                        continue
                    toks = [first]
                    while True:  # one HTTP chunk per burst of tokens
                        try:
                            toks.append(q.get_nowait())
                        except queue.Empty:
                            break
                    chunk([json.dumps({"token": t}) for t in toks])
                    sent += len(toks)
                if not req.done.is_set():
                    req.cancel()
                    chunk([json.dumps({"error": "generation timed out"})])
                elif req.error:
                    chunk([json.dumps({"error": req.error})])
                chunk(["[DONE]"])
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                req.cancel()  # dead client: stop generating for it
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
