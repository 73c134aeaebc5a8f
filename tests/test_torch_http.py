"""The port's HTTP front end on the CPU: completions as JSON and as SSE,
stats, health, version, validation, the pool-exhaustion preemption of
the serving loop, and a streaming client that goes away (mid-stream,
while queued) or half-closes — over real sockets."""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest
import torch

from elastic_gpu_scheduler_tpu_torch.models.lora import ALL_TARGETS, lora_init
from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine, Request
from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig, init_params
from elastic_gpu_scheduler_tpu_torch.ops import _build
from elastic_gpu_scheduler_tpu_torch.server.inference import (
    EngineLoop,
    drain,
    serve_inference,
)

# the suite runs in parallel worker processes: one intra-op thread keeps
# this file from crowding the workers that run beside it
torch.set_num_threads(1)

CFG = TransformerConfig(vocab_size=64, d_model=64, n_layers=2, n_heads=2, d_ff=64,
                        dtype="float32")


def _params():
    return init_params(CFG, torch.Generator().manual_seed(0), "cpu")


def _adapters(params):
    """Two registered adapters, B non-zero so they change the tokens."""
    out = {}
    for n, name in enumerate(("style-a", "style-b")):
        lo = lora_init(params, rank=2, targets=ALL_TARGETS,
                       generator=torch.Generator().manual_seed(10 + n))
        for ab in lo["adapters"].values():
            ab["b"] = torch.randn(ab["b"].shape,
                                  generator=torch.Generator().manual_seed(20 + n)) * 0.5
        out[name] = lo
    return out


@pytest.fixture(scope="module")
def served():
    params = _params()
    engine = InferenceEngine(params, CFG, max_batch=2, max_len=64, page_size=8,
                             device="cpu", adapters=_adapters(params))
    server, loop = serve_inference(engine, port=0, host="127.0.0.1")
    yield server.server_address, engine
    server.shutdown()
    server.server_close()
    loop.stop()


def _post(addr, body, path="/v1/completions"):
    conn = http.client.HTTPConnection(*addr, timeout=60)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def _get(addr, path):
    conn = http.client.HTTPConnection(*addr, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def test_completion_json_matches_engine(served):
    addr, engine = served
    code, body = _post(addr, {"prompt": [3, 9, 14], "max_tokens": 8})
    assert code == 200 and len(body["tokens"]) == 8
    r = engine.submit(Request(prompt=[3, 9, 14], max_new_tokens=8))
    assert r.done.wait(60) and r.output == body["tokens"]


def test_completion_sse_matches_json(served):
    addr, _ = served
    _, full = _post(addr, {"prompt": [2, 4, 6], "max_tokens": 6})
    conn = http.client.HTTPConnection(*addr, timeout=60)
    conn.request("POST", "/v1/completions",
                 json.dumps({"prompt": [2, 4, 6], "max_tokens": 6, "stream": True}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "text/event-stream"
    events = [raw[len("data: "):] for raw in resp.read().decode().split("\n\n")
              if raw.startswith("data: ")]
    conn.close()
    assert events[-1] == "[DONE]"
    assert [json.loads(e)["token"] for e in events[:-1]] == full["tokens"]


def test_stats_health_version_and_validation(served):
    addr, engine = served
    code, stats = _get(addr, "/v1/stats")
    assert code == 200 and stats["max_batch"] == 2
    assert stats["total_pages"] == engine.n_pages - 1 and stats["device"] == "cpu"
    # the kernels' launch counts by name: none on the CPU
    assert stats["kernel_launches"] == dict.fromkeys(_build.LAUNCHES, 0)
    assert _get(addr, "/healthz") == (200, {"ok": True})
    code, body = _get(addr, "/version")
    assert code == 200 and body["version"]
    code, body = _post(addr, {"prompt": "not ids"})
    assert code == 400 and "token ids" in body["error"]
    code, body = _post(addr, {"prompt": [1], "max_tokens": 999})
    assert code == 400 and "max_len" in body["error"]
    # the request controls, n and adapter are served: no field is refused by name
    code, body = _post(addr, {"prompt": [1], "seed": 3, "logprobs": 2, "max_tokens": 3})
    assert code == 200 and len(body["tokens"]) == 3
    assert len(body["logprobs"]["token_logprobs"]) == 3
    code, body = _post(addr, {"prompt": [1], "n": 2, "max_tokens": 3})
    assert code == 200 and [c["index"] for c in body["choices"]] == [0, 1]
    assert stats["adapters"] == ["style-a", "style-b"]
    code, base = _post(addr, {"prompt": [5, 9, 2], "max_tokens": 6})
    code, body = _post(addr, {"prompt": [5, 9, 2], "max_tokens": 6, "adapter": "style-a"})
    assert code == 200 and len(body["tokens"]) == 6 and body["tokens"] != base["tokens"]
    r = engine.submit(Request(prompt=[5, 9, 2], max_new_tokens=6, adapter="style-a"))
    assert r.done.wait(60) and r.output == body["tokens"]
    code, body = _post(addr, {"prompt": [1], "adapter": "a"})
    assert code == 400
    assert body["error"] == "unknown adapter 'a' (registered: ['', 'style-a', 'style-b'])"
    # the strict validators: a bool, a float, a NaN, a negative are 400s
    for field, value in (("seed", True), ("seed", 1.5), ("logprobs", True),
                         ("logprobs", 2.0), ("min_tokens", -1), ("frequency_penalty", True),
                         ("presence_penalty", float("nan")), ("n", 3), ("n", True)):
        code, body = _post(addr, {"prompt": [1], field: value})
        assert code == 400 and f"'{field}'" in body["error"], (field, value, body)
    code, body = _post(addr, {"prompt": [1], "logit_bias": {"x": 1}})
    assert code == 400 and "logit_bias" in body["error"]
    code, body = _post(addr, {"prompt": [1], "allowed_tokens": [64]})
    assert code == 400 and "allowed_tokens" in body["error"]
    assert _post(addr, {}, path="/v1/nope")[0] == 404


def _sse(addr, body):
    conn = http.client.HTTPConnection(*addr, timeout=60)
    conn.request("POST", "/v1/completions", json.dumps(dict(body, stream=True)),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    events = [raw[len("data: "):] for raw in resp.read().decode().split("\n\n")
              if raw.startswith("data: ")]
    conn.close()
    assert events[-1] == "[DONE]"
    return [json.loads(e) for e in events[:-1]]


def test_logprobs_and_n_in_json_and_sse(served):
    """``n`` = 2 with a seed and logprobs: JSON choices carry indexed
    tokens and logprobs; the SSE events carry the same per choice, with
    ``index``, ``logprob`` and ``top_logprobs``; each choice equals the
    engine's own run with seed + k."""
    addr, engine = served
    body = {"prompt": [3, 9, 14], "max_tokens": 6, "n": 2, "seed": 11, "temperature": 0.8,
            "logprobs": 2, "logit_bias": {"5": 1.5}, "min_tokens": 2}
    code, out = _post(addr, body)
    assert code == 200 and len(out["choices"]) == 2
    events = _sse(addr, body)
    for k, choice in enumerate(out["choices"]):
        r = engine.submit(Request(prompt=[3, 9, 14], max_new_tokens=6, seed=11 + k,
                                  temperature=0.8, logprobs=2, logit_bias={5: 1.5},
                                  min_tokens=2))
        assert r.done.wait(60) and not r.error
        assert choice["index"] == k and choice["tokens"] == r.output
        lp = choice["logprobs"]
        assert lp["token_logprobs"] == r.token_logprobs
        assert lp["top_logprobs"] == [[{"id": t, "logprob": v} for t, v in top]
                                      for top in r.top_logprobs]
        mine = [e for e in events if e["index"] == k]
        assert [e["token"] for e in mine] == r.output
        assert [e["logprob"] for e in mine] == r.token_logprobs
        assert all(len(e["top_logprobs"]) == 2 for e in mine)
    # a single-choice stream keeps the flat shape, with logprobs
    flat = _sse(addr, {"prompt": [3, 9, 14], "max_tokens": 4, "logprobs": 1})
    assert all("index" not in e and len(e["top_logprobs"]) == 1 for e in flat)


def test_adapter_with_n_in_json_and_sse(served):
    """``n`` = 2 on an adapter: each choice is served under it, in JSON and
    in SSE, and equals the engine's own run on that adapter."""
    addr, engine = served
    body = {"prompt": [7, 1, 30], "max_tokens": 5, "n": 2, "adapter": "style-b"}
    code, out = _post(addr, body)
    assert code == 200 and len(out["choices"]) == 2
    events = _sse(addr, body)
    r = engine.submit(Request(prompt=[7, 1, 30], max_new_tokens=5, adapter="style-b"))
    assert r.done.wait(60) and not r.error
    for k, choice in enumerate(out["choices"]):
        assert choice["index"] == k and choice["tokens"] == r.output
        assert [e["token"] for e in events if e["index"] == k] == r.output


def test_full_queue_answers_429_and_stats_report_max_queue():
    """``max_queue`` = 1 with the engine loop held: the first request
    waits in the queue, the next answers 429 (JSON, SSE and an ``n``
    request alike); /v1/stats reports the cap."""
    engine = InferenceEngine(_params(), CFG, max_batch=2, max_len=64, page_size=8,
                             device="cpu", max_queue=1)
    server, loop = serve_inference(engine, port=0, host="127.0.0.1")
    addr = server.server_address
    try:
        loop.stop()  # nothing is admitted: the queue only fills
        waiting = engine.submit(Request(prompt=[1, 2], max_new_tokens=2))
        assert not waiting.done.is_set()
        code, body = _post(addr, {"prompt": [3, 4], "max_tokens": 2})
        assert code == 429 and body["error"] == "admission queue full"
        code, _ = _post(addr, {"prompt": [3, 4], "max_tokens": 2, "n": 2})
        assert code == 429
        conn = http.client.HTTPConnection(*addr, timeout=60)
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": [3, 4], "max_tokens": 2, "stream": True}),
                     {"Content-Type": "application/json"})
        assert conn.getresponse().status == 429
        conn.close()
        code, stats = _get(addr, "/v1/stats")
        assert code == 200 and stats["max_queue"] == 1 and stats["queued"] == 1
        # a cancelled waiter is purged: the next request fits
        waiting.cancel()
        ok = engine.submit(Request(prompt=[5, 6], max_new_tokens=1))
        assert not ok.error and waiting.done.is_set()
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()


def test_serve_flags_logprobs_k_and_max_queue():
    """``serve``'s --logprobs-k and --max-queue, under the reference's
    names and defaults."""
    from elastic_gpu_scheduler_tpu_torch.serve import build_args

    args = build_args(["--init"])
    assert (args.logprobs_k, args.max_queue) == (5, 0)
    args = build_args(["--init", "--logprobs-k", "0", "--max-queue", "16"])
    assert (args.logprobs_k, args.max_queue) == (0, 16)


def test_pool_exhaustion_preempts_one_victim_not_all():
    """Every slot stalls for pages: the loop preempts ONE request (most
    pages held), requeues it once, fails it the second time; the other
    finishes."""
    engine = InferenceEngine(_params(), CFG, max_batch=2, max_len=32, page_size=8,
                             n_pages=5, device="cpu")
    loop = EngineLoop(engine).start()
    try:
        ra = Request(prompt=[3, 9, 14, 27, 5, 1, 2, 6], max_new_tokens=16)
        rb = Request(prompt=[2, 4, 6, 8, 10, 12, 1, 7], max_new_tokens=16)
        engine.submit(ra)
        engine.submit(rb)
        assert ra.done.wait(60) and rb.done.wait(60)
    finally:
        loop.stop()
    errs = [r for r in (ra, rb) if r.error]
    assert len(errs) == 1 and "preempted" in errs[0].error
    survivor = rb if errs[0] is ra else ra
    assert len(survivor.output) == 16


def test_drain_rejects_new_and_finishes_inflight():
    engine = InferenceEngine(_params(), CFG, max_batch=2, max_len=64, page_size=8,
                             device="cpu")
    server, loop = serve_inference(engine, port=0, host="127.0.0.1")
    try:
        r = engine.submit(Request(prompt=[5, 6, 7], max_new_tokens=20))
        assert drain(loop, timeout=60)
        assert r.done.is_set() and len(r.output) == 20
        assert _get(server.server_address, "/healthz")[0] == 503
        code, body = _post(server.server_address, {"prompt": [1, 2], "max_tokens": 2})
        assert code == 503 and "draining" in body["error"]
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()


# -- a streaming client that goes away (the reference's
# tests/test_stop_stream.py holds its server to the same): a dead client
# releases its slot or its queue entry at once, found on a write or, with no
# token due, by the handler's peek of the socket; a half-close is no
# disconnect


def _poll(fn, timeout):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if fn():
            return True
        time.sleep(0.02)
    return False


def _stream_socket(port, body):
    raw = json.dumps(body).encode()
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    s.sendall(f"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
              f"Content-Length: {len(raw)}\r\n\r\n".encode() + raw)
    return s


def test_client_disconnect_mid_stream_releases_slot_promptly():
    engine = InferenceEngine(_params(), CFG, max_batch=2, max_len=1024, page_size=16,
                             device="cpu")
    server, loop = serve_inference(engine, port=0, host="127.0.0.1")
    try:
        s = _stream_socket(server.server_address[1],
                           {"prompt": [3, 9, 14], "max_tokens": 900, "stream": True})
        buf = b""
        while buf.count(b"data:") < 3:  # tokens flow; then vanish
            buf += s.recv(4096)
        s.close()
        assert _poll(lambda: all(sl is None for sl in engine.slots), 20), \
            "slot not released after the client disconnected"
        assert engine.tokens_emitted < 900, "decoded to the end for a dead client"
        r = engine.submit(Request(prompt=[2, 4, 6], max_new_tokens=5))
        assert r.done.wait(60) and not r.error  # the slot takes a new request
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()


def test_queued_request_disconnect_detected_without_any_token():
    """The idle peek: a stream still queued (one slot, held) has no token
    to write, so no broken pipe would show; the handler finds the EOF
    itself and cancels, and the queue purges the entry before it ever
    takes a slot.  A wider, deeper model than the module's keeps the one
    slot streaming for seconds on the CPU, so the queued stream is still
    queued when its client goes."""
    cfg = TransformerConfig(vocab_size=64, d_model=512, n_layers=12, n_heads=8, d_ff=1024,
                            dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    engine = InferenceEngine(params, cfg, max_batch=1, max_len=1024, page_size=16,
                             device="cpu")
    server, loop = serve_inference(engine, port=0, host="127.0.0.1")
    try:
        port = server.server_address[1]
        s1 = _stream_socket(port, {"prompt": [3, 9, 14], "max_tokens": 1000, "stream": True})
        buf = b""
        while buf.count(b"data:") < 2:  # the slot is busy streaming
            buf += s1.recv(4096)
        s2 = _stream_socket(port, {"prompt": [2, 4, 6], "max_tokens": 1000, "stream": True})
        assert _poll(lambda: engine.queue.qsize() >= 1, 10), "s2 never queued"
        queued = engine.queue.qsize()
        s2.close()  # gone while queued: not one token was written to it
        assert _poll(lambda: engine.queue.qsize() < queued, 20), \
            "the cancelled queued request was never purged"
        assert engine.slots[0] is not None and not engine.slots[0].done.is_set(), \
            "s1 finished before the check: no token-free window was tested"
        before = engine.tokens_emitted
        s1.close()
        assert _poll(lambda: all(sl is None for sl in engine.slots), 20)
        assert engine.tokens_emitted < before + 1000, "decoded for a dead client"
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()


def test_half_closed_client_still_receives_full_stream():
    """shutdown(SHUT_WR) after the request, still reading: the EOF alone is
    no disconnect (the pings tell it apart), and the whole stream arrives."""
    engine = InferenceEngine(_params(), CFG, max_batch=2, max_len=256, page_size=16,
                             device="cpu")
    server, loop = serve_inference(engine, port=0, host="127.0.0.1")
    try:
        s = _stream_socket(server.server_address[1],
                           {"prompt": [3, 9, 14], "max_tokens": 24, "stream": True})
        s.shutdown(socket.SHUT_WR)
        s.settimeout(120)
        buf = b""
        while b"data: [DONE]" not in buf:
            b = s.recv(4096)
            if not b:
                break
            buf += b
        s.close()
        assert b"data: [DONE]" in buf, "the half-closed client lost its stream"
        assert buf.count(b'"token"') == 24
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()


def test_serve_cli_with_kv_int8_prefix_cache_and_chunked_prefill():
    """``serve --init --cpu --kv-int8 --prefix-cache --prefill-chunk 8
    --fleet-role decode --replica-name rep-0`` in its own process: the
    same prompt twice answers the same tokens, the second time through the
    prefix cache, and /v1/stats shows the counters under the reference's
    names and the fleet role; an export of a prompt with no cached page is
    a 404; SIGTERM drains and exits 0."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "elastic_gpu_scheduler_tpu_torch.serve", "--init", "--cpu",
           "--kv-int8", "--prefix-cache", "--prefill-chunk", "8", "--port", str(port),
           "--fleet-role", "decode", "--replica-name", "rep-0",
           "--host", "127.0.0.1", "--vocab-size", "64", "--d-model", "64",
           "--n-layers", "2", "--n-heads", "2", "--d-ff", "64", "--dtype", "float32",
           "--max-batch", "2", "--max-len", "64", "--page-size", "8", "--fused-steps", "4"]
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, cwd=repo, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    addr = ("127.0.0.1", port)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                if _get(addr, "/healthz")[0] == 200:
                    break
            except OSError:
                pass
            assert proc.poll() is None, proc.stderr.read()
            assert time.monotonic() < deadline, "serve did not come up"
            time.sleep(0.2)
        prompt = list(range(1, 30))  # 3 full pages of 8, 5 tokens past them
        first = _post(addr, {"prompt": prompt, "max_tokens": 6})
        second = _post(addr, {"prompt": prompt, "max_tokens": 6})
        assert first[0] == second[0] == 200
        assert first[1]["tokens"] == second[1]["tokens"] and len(first[1]["tokens"]) == 6
        code, stats = _get(addr, "/v1/stats")
        assert code == 200 and stats["prefill_chunk"] == 8
        assert stats["kv"]["prefix_lookups"] == 2 and stats["kv"]["prefix_hits"] == 1
        assert stats["kv"]["prefix_misses"] == 1
        assert stats["prefix_hit_tokens"] == 24 and stats["kv"]["cached_pages"] >= 3
        assert (stats["role"], stats["replica"]) == ("decode", "rep-0")
        assert _post(addr, {"tokens": [1]}, path="/v1/kv/export")[0] == 404
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_listen_backlog_holds_a_burst_of_connections():
    """A burst of concurrent clients past the stdlib's listen backlog of 5
    must not lose connections (each lost one waits a second for its SYN to
    be sent again): with accepting stopped, 24 connections still complete
    their handshake in the listen queue."""
    engine = InferenceEngine(_params(), CFG, max_batch=2, max_len=64, page_size=8, device="cpu")
    server, loop = serve_inference(engine, port=0, host="127.0.0.1")
    server.shutdown()  # stop accepting; the socket keeps listening
    socks = []
    try:
        for _ in range(24):
            socks.append(socket.create_connection(server.server_address, timeout=0.5))
    finally:
        for s in socks:
            s.close()
        server.server_close()
        loop.stop()
    assert len(socks) == 24
