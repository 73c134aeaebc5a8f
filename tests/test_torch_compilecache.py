"""The port's warm-start plane (``compilecache/``) against the reference's.

Mirrors ``tests/test_compile_cache.py`` at its size (vocab 64, d_model 32,
2 layers, 2 heads, d_ff 64, float32; max_batch 2, max_len 64, page_size 8,
fused_steps 4):

- the entry container is byte-identical to the reference's, and each side
  reads the other's entries;
- miss → fill → persistent load, quarantine of a flipped byte, a truncated
  entry, a wrong key and a payload that does not deserialize, single
  flight (8 threads, one build, 7 coalesced), a failing builder handing
  the build to a waiter, memory-only entries, ``AotFunction``'s keys;
- the kernel library's entry (``ops/_build.open_library``) with the nvcc
  build and the ``ctypes`` load replaced by stand-ins: a corrupt entry is
  quarantined and rebuilt, never loaded;
- the lattice: the port's prefill points and decode / verify buckets equal
  the labels of the reference's ``aot_signatures`` (an engine built with
  ``compile_cache=None``, so nothing compiles);
- a warm-up leaves the engine's lengths, tables, pool pages and generator
  as they were; greedy, sampled and seeded tokens are the same with and
  without one, and the greedy ones equal the JAX engine's;
- HTTP: ``/healthz`` 503 ``{"warming": true}`` then 200 (and 503
  ``{"warmup_failed": true}`` after a warm-up that failed), ``/v1/stats``
  ``warmup`` / ``compile_cache``, the metrics on ``/metrics``; ``serve
  --warmup lattice --compile-cache-dir`` in its own process;
- ``serve``'s ``--warmup`` and ``--compile-cache-dir`` parse as the
  reference's.

The reference's journal test is not mirrored: the port has no journal.
"""

import http.client
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu import serve as jax_serve
from elastic_gpu_scheduler_tpu.compilecache import CompileCache as JaxCompileCache
from elastic_gpu_scheduler_tpu.compilecache import cache_key as jax_cache_key
from elastic_gpu_scheduler_tpu.models.serving import (
    InferenceEngine as JaxEngine,
    Request as JaxRequest,
)
from elastic_gpu_scheduler_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    init_params as jax_init_params,
)
from elastic_gpu_scheduler_tpu_torch import serve
from elastic_gpu_scheduler_tpu_torch.compilecache import (
    AotFunction,
    Codec,
    CompileCache,
    WarmupState,
    cache_key,
    start_warmup_thread,
    warmup_engine,
)
from elastic_gpu_scheduler_tpu_torch.models.bridge import params_from_jax
from elastic_gpu_scheduler_tpu_torch.models.serving import (
    SCRATCH_PAGE,
    InferenceEngine,
    Request,
)
from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig
from elastic_gpu_scheduler_tpu_torch.ops import _build
from elastic_gpu_scheduler_tpu_torch.server.inference import serve_inference

from test_torch_engine import reference_engine_copies_uploads  # noqa: F401  (autouse)

torch.set_num_threads(1)

CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64, dtype="float32")
ENGINE = dict(max_batch=2, max_len=64, page_size=8, fused_steps=4)
BYTES = Codec(serialize=lambda b: b, deserialize=lambda b: b)
PROMPTS = [[9, 8, 7, 6, 5, 4], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], [20, 21, 22]]


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxConfig(**CFG)
    jp = jax_init_params(jax.random.key(0), jcfg)
    return jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _engine(params, cache=None, **kw):
    return InferenceEngine(params, TransformerConfig(**CFG), device="cpu",
                           compile_cache=cache, **{**ENGINE, **kw})


# -- the entry container --------------------------------------------------------


def test_entry_container_byte_identical_to_reference(tmp_path):
    key = cache_key("kernels", "digest", (9, 0))
    payload = bytes(range(256)) * 3
    meta = {"tag": "kernels", "sources": ["a.cu", "b.cu"]}
    port = CompileCache(str(tmp_path / "port"))
    ref = JaxCompileCache(str(tmp_path / "ref"))
    port._write_entry(key, payload, meta)
    ref._write_entry(key, payload, meta)
    with open(port.path(key), "rb") as f, open(ref._path(key), "rb") as g:
        assert f.read() == g.read()
    assert key == jax_cache_key("kernels", "digest", (9, 0))


def test_each_side_reads_the_others_entries(tmp_path):
    port = CompileCache(str(tmp_path / "port"))
    ref = JaxCompileCache(str(tmp_path / "ref"))
    port._write_entry("from-port", b"port payload", {"by": "port"})
    ref._write_entry("from-ref", b"ref payload", {"by": "ref"})
    os.replace(port.path("from-port"), ref._path("from-port"))
    os.replace(ref._path("from-ref"), port.path("from-ref"))
    assert ref._read_entry("from-port") == b"port payload"
    assert port._read_entry("from-ref") == b"ref payload"
    assert port.quarantined == ref.quarantined == 0


# -- cache behaviour ----------------------------------------------------------------


def test_get_or_compile_miss_fill_then_persistent_load(tmp_path):
    d = str(tmp_path)
    key = cache_key("t", (8,))
    c1 = CompileCache(d)
    assert c1.get_or_compile(key, lambda: b"built once", codec=BYTES) == b"built once"
    assert (c1.misses, c1.fills, c1.loads) == (1, 1, 0)
    c1.get_or_compile(key, lambda: pytest.fail("must not rebuild"), codec=BYTES)
    assert c1.hits == 1
    c2 = CompileCache(d)
    assert c2.get_or_compile(key, lambda: pytest.fail("must not build"),
                             codec=BYTES) == b"built once"
    assert (c2.misses, c2.fills, c2.loads) == (0, 0, 1)
    assert c2.stats()["disk_entries"] == 1 and c2.stats()["fallbacks"] == 0


def _flip(path):
    blob = bytearray(open(path, "rb").read())
    blob[-3] ^= 0xFF  # a payload bit: the CRC must catch it
    open(path, "wb").write(bytes(blob))


def _truncate(path):
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:-5])


@pytest.mark.parametrize("damage", ["flipped_byte", "truncated", "wrong_key",
                                    "does_not_deserialize"])
def test_corrupt_entry_is_quarantined_and_rebuilt(tmp_path, damage):
    d = str(tmp_path)
    key = cache_key("q", 4)
    c1 = CompileCache(d)
    c1.get_or_compile(key, lambda: b"good payload", codec=BYTES)
    path = c1.path(key)
    codec = BYTES
    if damage == "flipped_byte":
        _flip(path)
    elif damage == "truncated":
        _truncate(path)
    elif damage == "wrong_key":
        other = cache_key("q", 5)
        c1.get_or_compile(other, lambda: b"other payload", codec=BYTES)
        os.replace(c1.path(other), path)
    else:
        def refuse(b):
            raise OSError("the loader refuses this payload")

        codec = Codec(serialize=lambda b: b, deserialize=refuse)
    c2 = CompileCache(d)
    got = c2.get_or_compile(key, lambda: b"rebuilt", codec=codec)
    assert got == b"rebuilt"
    assert (c2.quarantined, c2.misses, c2.fills, c2.loads) == (1, 1, 1, 0)
    assert os.path.exists(path + ".bad")
    c3 = CompileCache(d)
    assert c3.get_or_compile(key, lambda: pytest.fail("must not rebuild"),
                             codec=BYTES) == b"rebuilt"
    assert c3.loads == 1


def test_single_flight_eight_threads_build_once(tmp_path):
    c = CompileCache(str(tmp_path))
    key = cache_key("sf", 16)
    builds = []

    def build():
        builds.append(threading.get_ident())
        deadline = time.monotonic() + 30
        while c.coalesced < 7 and time.monotonic() < deadline:
            time.sleep(0.01)  # hold the flight open until every peer parks
        return b"one build"

    outs = []
    start = threading.Barrier(8)

    def worker():
        start.wait()
        outs.append(c.get_or_compile(key, build, codec=BYTES))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and len(outs) == 8 and all(o is outs[0] for o in outs)
    assert (c.misses, c.coalesced, c.fills) == (1, 7, 1)


def test_failing_builder_hands_the_build_to_a_waiter(tmp_path):
    c = CompileCache(str(tmp_path))
    key = cache_key("fail", 1)
    results, errors = [], []

    def failing():
        deadline = time.monotonic() + 30
        while c.coalesced < 1 and time.monotonic() < deadline:
            time.sleep(0.01)  # the waiter is parked behind this flight
        raise RuntimeError("nvcc failed")

    def first():
        try:
            c.get_or_compile(key, failing, codec=BYTES)
        except RuntimeError as e:
            errors.append(str(e))

    def second():
        while not c._inflight:
            time.sleep(0.005)
        results.append(c.get_or_compile(key, lambda: b"second builder", codec=BYTES))

    threads = [threading.Thread(target=first), threading.Thread(target=second)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert errors == ["nvcc failed"] and results == [b"second builder"]
    assert (c.misses, c.coalesced, c.fills) == (2, 1, 1)


def test_memory_only_entries_and_aot_function_keys(tmp_path):
    """An entry without a codec (a CUDA graph) never touches the disk; the
    port's ``AotFunction`` captures once a dispatch key, hands the capture
    its key, and keys the entry by (tag and fingerprint, dispatch key)."""
    c = CompileCache(str(tmp_path))
    captures = []
    aot = AotFunction(lambda key, *a: captures.append((key, *a)) or len(captures), c,
                      ("fp", 1), tag="serve_chunk")
    assert aot.build((1, False), "args") == 1
    assert aot.build((1, False), "args") == 1
    assert aot.build((2, False), "args") == 2
    assert captures == [((1, False), "args"), ((2, False), "args")]
    assert aot.keys == {(1, False), (2, False)}
    assert (c.misses, c.hits, c.fills, c.loads) == (2, 1, 0, 0)
    key = cache_key(cache_key("serve_chunk", "fp", 1), (1, False))
    assert c.get_or_compile(key, lambda: "captured again") == 1
    assert c.disk_entries() == 0 and c.entries() == 2
    assert CompileCache(str(tmp_path)).get_or_compile(
        key, lambda: "captured again") == "captured again"


# -- the kernel library's entry --------------------------------------------------


class _FakeLib:
    def __init__(self, path):
        self._name = str(path)
        self.blob = open(path, "rb").read()


def test_library_entry_quarantined_rebuilt_never_loaded(tmp_path, monkeypatch):
    """``open_library`` with the nvcc build and the ctypes load replaced:
    a cold directory builds and fills, a second cache loads (writing the
    payload out as ``<key>.so``), a flipped byte is quarantined and
    rebuilt, and the loader never sees the corrupt bytes."""
    lib_bytes = b"\x7fELF" + bytes(range(200))
    builds, opened = [], []

    def compile_and_link(root, key):
        builds.append(key)
        (root / f"{key}.so").write_bytes(lib_bytes)
        return root / f"{key}.so"

    def open_(path):
        lib = _FakeLib(path)
        opened.append(lib.blob)
        return lib

    monkeypatch.setattr(_build, "library_key", lambda: "libkey")
    monkeypatch.setattr(_build, "nvcc_release", lambda: "release 12.9")
    monkeypatch.setattr(_build, "_compile_and_link", compile_and_link)
    monkeypatch.setattr(_build, "_open", open_)
    d = str(tmp_path)
    cold = CompileCache(d)
    _build.open_library(cold)
    assert (cold.misses, cold.fills, cold.loads) == (1, 1, 0) and builds == ["libkey"]
    warm = CompileCache(d)
    os.remove(os.path.join(d, "libkey.so"))
    lib = _build.open_library(warm)
    assert (warm.misses, warm.fills, warm.loads) == (0, 0, 1) and builds == ["libkey"]
    assert lib.blob == lib_bytes and open(os.path.join(d, "libkey.so"), "rb").read() == lib_bytes
    _flip(warm.path("libkey"))
    again = CompileCache(d)
    _build.open_library(again)
    assert (again.quarantined, again.misses, again.fills) == (1, 1, 1)
    assert builds == ["libkey", "libkey"] and all(b == lib_bytes for b in opened)
    blob = open(again.path("libkey"), "rb").read()
    (hlen,) = struct.unpack_from("<I", blob, 8)
    header = json.loads(blob[12:12 + hlen])
    assert header["meta"] == {"tag": "kernels", "nvcc": "release 12.9",
                              "sources": [s.name for s in _build.sources()]}
    assert header["len"] == len(lib_bytes)


def test_library_cache_precedence(tmp_path, monkeypatch):
    """A given cache with a directory, else the one handed to ``use_cache``,
    else ``TPU_COMPILE_CACHE_DIR``'s, else the package's."""
    monkeypatch.setattr(_build, "_cache", None)
    monkeypatch.setattr(_build, "_default_cache", None)
    monkeypatch.setenv(_build.CACHE_DIR_ENV, str(tmp_path / "env"))
    assert _build.library_cache().cache_dir == str(tmp_path / "env")
    handed = CompileCache(str(tmp_path / "handed"))
    _build.use_cache(CompileCache(None))  # no directory: not taken
    assert _build.library_cache().cache_dir == str(tmp_path / "env")
    _build.use_cache(handed)
    assert _build.library_cache() is handed
    given = CompileCache(str(tmp_path / "given"))
    assert _build.library_cache(given) is given
    assert _build.library_cache(CompileCache(None)) is handed
    monkeypatch.setattr(_build, "_cache", None)
    monkeypatch.setattr(_build, "_default_cache", None)
    monkeypatch.delenv(_build.CACHE_DIR_ENV)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "pkg")
    assert _build.library_cache().cache_dir == str(tmp_path / "pkg")


# -- the lattice against the reference's ------------------------------------------


@pytest.mark.parametrize("mode", [
    {}, {"prefill_chunk": 16}, {"prefix_cache": True}, {"spec_k": 3},
], ids=lambda m: ",".join(f"{k}={v}" for k, v in m.items()) or "plain")
def test_lattice_labels_equal_reference(weights, mode):
    jcfg, jp, params = weights
    ref = JaxEngine(jp, jcfg, compile_cache=None, **{**ENGINE, **mode})
    ref_labels = [label for label, _, _ in ref.aot_signatures()]
    port = _engine(params, CompileCache(None), **mode)
    minimal = [label for label, _ in port.aot_signatures()]
    full = [label for label, _ in port.aot_signatures("full")]

    def prefill(labels):
        return sorted(x for x in labels if x.startswith("prefill"))

    def buckets(labels, tag):
        return sorted({x.rsplit(":p", 1)[1] for x in labels if x.startswith(tag)}, key=int)

    assert prefill(minimal) == prefill(full) == prefill(ref_labels)
    assert buckets(minimal, "serve_chunk") == buckets(ref_labels, "serve_chunk") == [
        "1", "2", "4", "8"]
    assert buckets(minimal, "verify_chunk") == buckets(ref_labels, "verify_chunk")
    n_chunks = len(buckets(ref_labels, "serve_chunk"))
    assert sum(x.startswith("serve_chunk") for x in minimal) == 3 * n_chunks
    assert sum(x.startswith("serve_chunk") for x in full) == 64 * n_chunks
    assert {x.split(":")[1] for x in minimal if x.startswith("serve_chunk")} == {
        "000000", "010000", "110000"}
    assert sum(x.startswith("verify_chunk") for x in minimal) == (
        n_chunks if mode.get("spec_k") else 0)


# -- engine state and tokens ------------------------------------------------------


def _snapshot(eng):
    pool = {k: v.clone() for k, v in eng.kv.items()}
    for t in pool.values():
        t[:, SCRATCH_PAGE] = 0  # the points write the scratch page only
    return dict(lengths=eng.lengths.copy(), tables=eng.tables.copy(), pool=pool,
                generator=eng.generator.get_state().clone(), free=list(eng.free_pages),
                slots=list(eng.slots), next_token=eng.next_token.copy(),
                emitted=eng.emitted.copy(), steps=eng.steps_run, prefills=eng.prefills_run)


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "pool":
            assert all(torch.equal(a[k][n], b[k][n]) for n in a[k]), "a real page changed"
        elif isinstance(a[k], (np.ndarray, torch.Tensor)):
            assert (a[k] == b[k]).all(), k
        else:
            assert a[k] == b[k], k


def _submit(eng, seeded=True):
    return [eng.submit(Request(prompt=list(PROMPTS[0]), max_new_tokens=10)),
            eng.submit(Request(prompt=list(PROMPTS[1]), max_new_tokens=12, temperature=0.8,
                               top_k=20, top_p=0.9)),
            eng.submit(Request(prompt=list(PROMPTS[2]), max_new_tokens=9, temperature=0.7,
                               seed=7 if seeded else None))]


@pytest.mark.parametrize("mode", [
    {}, {"overlap": False, "kv_int8": True}, {"prefix_cache": True, "prefill_chunk": 8},
    {"spec_k": 3},
], ids=lambda m: ",".join(f"{k}={v}" for k, v in m.items()) or "overlap")
def test_warmup_leaves_engine_state_and_tokens_unchanged(weights, mode):
    """A full warm-up in the middle of a batch (live slots, a chunk in
    flight on the overlapped engine) changes no length, table, real pool
    page, slot or generator state, and the batch's tokens (greedy,
    top-k / top-p sampled and seeded) are those of an engine never
    warmed."""
    _, _, params = weights

    def run(warm):
        eng = _engine(params, CompileCache(None) if warm else None, **mode)
        reqs = _submit(eng)
        eng._admit()
        eng.step()
        eng.step()
        if warm:
            before = _snapshot(eng)
            st = warmup_engine(eng, variants="full")
            assert st.state == "ready" and st.errors == 0
            assert st.built == st.lattice_size > 0
            _same(before, _snapshot(eng))
        eng.run_until_idle()
        assert all(r.done.is_set() and not r.error for r in reqs)
        return [r.output for r in reqs]

    assert run(True) == run(False)


def test_warmed_greedy_tokens_equal_jax_engine(weights):
    """Float32 greedy tokens after a warm-up equal the JAX engine's (both
    sequential), and seeded / unseeded sampled streams equal an unwarmed
    port engine's."""
    jcfg, jp, params = weights
    ref = JaxEngine(jp, jcfg, overlap=False, **ENGINE)
    jreqs = [ref.submit(JaxRequest(prompt=list(p), max_new_tokens=10)) for p in PROMPTS]
    ref.run_until_idle()
    want = [r.output for r in jreqs]

    def port(warm, **req):
        eng = _engine(params, CompileCache(None) if warm else None, overlap=False)
        if warm:
            warmup_engine(eng)
        reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=10, **req)) for p in PROMPTS]
        eng.run_until_idle()
        return [r.output for r in reqs]

    assert port(True) == port(False) == want
    for req in (dict(temperature=0.9, seed=11), dict(temperature=0.9)):
        assert port(True, **req) == port(False, **req)


def test_no_cache_nothing_to_warm(weights):
    st = warmup_engine(_engine(weights[2]))
    assert st.state == "ready" and st.lattice_size == 0 and "no compile cache" in st.detail


# -- HTTP ------------------------------------------------------------------------


def _get(addr, path):
    conn = http.client.HTTPConnection(*addr, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, (body.decode() if path == "/metrics" else json.loads(body))


def _post(addr, body):
    conn = http.client.HTTPConnection(*addr, timeout=60)
    conn.request("POST", "/v1/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def test_healthz_warming_then_ready_and_stats(weights, tmp_path):
    """``/healthz`` answers 503 ``{"warming": true}`` while the lattice
    warms (through the running loop, one task a point) and 200 after;
    draining takes precedence; ``/v1/stats`` carries ``warmup`` and
    ``compile_cache``; the metrics are on ``/metrics``."""
    cache = CompileCache(str(tmp_path))
    eng = _engine(weights[2], cache)
    server, loop = serve_inference(eng, port=0, host="127.0.0.1")
    addr = ("127.0.0.1", server.server_address[1])
    try:
        code, stats = _get(addr, "/v1/stats")
        assert stats["warmup"] == {"state": "none"} and stats["compile_cache"]["fills"] == 0
        loop.warmup = WarmupState()
        loop.warmup.state = "warming"
        code, body = _get(addr, "/healthz")
        assert code == 503 and body["warming"] is True and body["ok"] is False
        assert body["warmup"]["state"] == "warming"
        eng.draining = True
        assert _get(addr, "/healthz") == (503, {"ok": False, "draining": True})
        eng.draining = False
        # a request beside the warm-up is served between its points
        answers = []
        pending = threading.Thread(target=lambda: answers.append(
            _post(addr, {"prompt": [1, 2, 3], "max_tokens": 4})[0]))
        pending.start()
        thread = start_warmup_thread(eng, loop.warmup, variants="full")
        thread.join(timeout=120)
        pending.join(timeout=60)
        assert not thread.is_alive() and not pending.is_alive() and answers == [200]
        assert _get(addr, "/healthz") == (200, {"ok": True})
        code, stats = _get(addr, "/v1/stats")
        wu = stats["warmup"]
        assert wu["state"] == "ready" and wu["errors"] == 0
        assert wu["built"] == wu["lattice_size"] == 4 + 64 * 4
        assert stats["compile_cache"]["dir"] == str(tmp_path)
        assert stats["compile_cache"]["fallbacks"] == 0 and stats["graphs_captured"] == 0
        code, greedy = _post(addr, {"prompt": PROMPTS[0], "max_tokens": 6})
        assert code == 200 and len(greedy["tokens"]) == 6
        cache.get_or_compile("metric-probe", lambda: 1)
        _, text = _get(addr, "/metrics")
        assert 'tpu_compile_cache_events_total{event="miss"}' in text
        assert "tpu_warmup_seconds " in text
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()


@pytest.mark.parametrize("broken", ["library", "lattice"])
def test_healthz_refuses_traffic_after_a_failed_warmup(weights, monkeypatch, broken):
    """A warm-up that cannot build the kernel library (or enumerate the
    lattice) ends in state ``error``, and ``/healthz`` then answers 503
    ``{"warmup_failed": true}``: the port has no fallback, so the replica
    must not go into rotation.  The library step runs for a CUDA engine:
    its device is made to read as one for the warm-up, with the build
    replaced by one that fails."""
    eng = _engine(weights[2], CompileCache(None))

    def boom(*a, **k):
        raise RuntimeError(f"{broken} broken")

    if broken == "library":
        monkeypatch.setattr(_build, "lib", boom)
        monkeypatch.setattr(eng, "device", torch.device("cuda", 0))
    else:
        monkeypatch.setattr(eng, "aot_signatures", boom)
    st = warmup_engine(eng, WarmupState())
    monkeypatch.undo()
    assert st.state == "error" and f"{broken} broken" in st.detail and st.failed
    server, loop = serve_inference(eng, port=0, host="127.0.0.1")
    addr = ("127.0.0.1", server.server_address[1])
    try:
        loop.warmup = st
        code, body = _get(addr, "/healthz")
        assert code == 503 and body["ok"] is False and body["warmup_failed"] is True
        assert body["warmup"]["state"] == "error"
        eng.draining = True
        assert _get(addr, "/healthz") == (503, {"ok": False, "draining": True})
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()


def test_serve_cli_warmup_and_compile_cache_dir(tmp_path):
    """``serve --init --cpu --warmup lattice --compile-cache-dir D`` in its
    own process: /healthz turns 200 once the lattice is warm, /v1/stats
    shows it built with no error and the cache on D, a completion is
    served; SIGTERM drains and exits 0."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cache_dir = str(tmp_path / "cache")
    cmd = [sys.executable, "-m", "elastic_gpu_scheduler_tpu_torch.serve", "--init", "--cpu",
           "--warmup", "lattice", "--compile-cache-dir", cache_dir, "--port", str(port),
           "--host", "127.0.0.1", "--vocab-size", "64", "--d-model", "32", "--n-layers", "2",
           "--n-heads", "2", "--n-kv-heads", "1", "--d-ff", "64", "--dtype", "float32",
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
        code, stats = _get(addr, "/v1/stats")
        wu = stats["warmup"]
        assert wu["state"] == "ready" and wu["errors"] == 0
        assert wu["built"] == wu["lattice_size"] == 4 + 3 * 4
        assert stats["compile_cache"]["dir"] == cache_dir and os.path.isdir(cache_dir)
        assert _post(addr, {"prompt": [3, 9, 14], "max_tokens": 5})[0] == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# -- flags ------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    [], ["--warmup", "full"], ["--warmup", "off", "--compile-cache-dir", "/var/cache/x"],
    ["--compile-cache-dir", "/c"], ["--warmup", "lattice"],
], ids=str)
def test_serve_warmup_flags_parse_as_reference(argv):
    port = serve.build_args(["--init", *argv])
    ref = jax_serve.build_args(["--init", *argv])
    assert (port.warmup, port.compile_cache_dir) == (ref.warmup, ref.compile_cache_dir)


def test_serve_warmup_flag_choices_as_reference():
    with pytest.raises(SystemExit):
        serve.build_args(["--init", "--warmup", "eager"])
    with pytest.raises(SystemExit):
        jax_serve.build_args(["--init", "--warmup", "eager"])
