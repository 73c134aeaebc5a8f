"""The port's disaggregated serving data plane: KV-page export and import,
prefix adoption, the prefill/decode split and live session migration.

The model is the reference's ``tests/test_disagg.py`` config (V 64, D 32,
L 2, float32), its weights drawn by the JAX package and carried over with
``bridge.params_from_jax``.  Correctness bars, all on greedy float32
tokens, which must be identical:

- **Across implementations**: the JAX engine exports and the port imports,
  and the other way round, with a dense pool and an int8 pool.  Headers
  and token frames are identical; payloads agree to float32 rounding
  (int8: equal scales to float32 rounding and dequantised values within
  one quantisation step, the row's scale); tokens after adoption equal the
  other engine's own warm-hit run.
- **On the port** (the reference's disagg tests, mirrored): adoption equals
  a local warm hit; geometry and payload-size rejections land nothing;
  pool pressure stops an import with a leading run; a session migrated at
  any point, over every overlap pairing, mid chunked prefill, with seeded
  sampling and logprobs, on an adapter, an int8 pool or ``spec_k``,
  continues exactly as an undisturbed run, losing at most one in-flight
  chunk (``chunks_discarded``).  Seeded draws are the port's own hash, so
  they are held to the port's undisturbed run.
- **HTTP**: the five routes with the reference's status codes, the
  ``X-KV-Source`` adoption, a migration mid-stream relayed to the client,
  a refused handoff resumed locally, the ``/v1/stats`` fields, and the
  reference's fleet router (host Python) in front of two port replicas.

JAX engines run in their sequential mode behind
``reference_engine_copies_uploads`` (``tests/test_torch_engine.py``).
"""

import functools
import http.client
import json
import socket
import threading

import jax
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.fleet.router import FleetRouter, Replica, ReplicaSet
from elastic_gpu_scheduler_tpu.models.serving import (
    InferenceEngine as JaxEngine,
    Request as JaxRequest,
)
from elastic_gpu_scheduler_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    init_params as jax_init_params,
)
from elastic_gpu_scheduler_tpu_torch import serve
from elastic_gpu_scheduler_tpu_torch.models.bridge import params_from_jax
from elastic_gpu_scheduler_tpu_torch.models.lora import lora_init
from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine, Request
from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig
from elastic_gpu_scheduler_tpu_torch.server.inference import choose_kv_victim, serve_inference
from elastic_gpu_scheduler_tpu_torch.utils import kvwire

from test_torch_engine import reference_engine_copies_uploads  # noqa: F401  (autouse)

torch.set_num_threads(1)

CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64, dtype="float32")
BASE = dict(max_batch=4, max_len=128, page_size=8, fused_steps=4, prefix_cache=True)
PREFIX = [3, 9, 14, 2, 4, 6, 8, 10, 60, 2, 33, 1, 5, 17, 3, 8, 58, 41, 22, 7, 7, 30,
          12, 5, 9, 9, 1, 0, 44, 13, 6, 2, 19]  # four full pages and one token
SUFFIX = [7, 7, 2]


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxConfig(**CFG)
    jp = jax_init_params(jax.random.key(0), jcfg)
    return jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def make_engine(params, **kw):
    return InferenceEngine(params, TransformerConfig(**CFG), device="cpu", **{**BASE, **kw})


def serve_one(eng, prompt, max_new=8, **req_kw):
    req = eng.submit(Request(prompt=list(prompt), max_new_tokens=max_new, **req_kw))
    eng.run_until_idle(max_steps=100_000)
    assert req.done.is_set() and not req.error, req.error
    return req


def run_plain(params, prompt, max_new, req_kw=None, **kw):
    return list(serve_one(make_engine(params, **kw), prompt, max_new, **(req_kw or {})).output)


# -- across implementations ------------------------------------------------------


def _pool_arrays(hdr, payload):
    """A page payload → {pool key: array}, keys in the engines' order."""
    L, ps, hkv, hd = hdr["n_layers"], hdr["page_size"], hdr["kv_heads"], hdr["head_dim"]
    keys = [("k", np.int8 if hdr["kv_int8"] else np.float32, (L, ps, hkv, hd)),
            ("v", np.int8 if hdr["kv_int8"] else np.float32, (L, ps, hkv, hd))]
    if hdr["kv_int8"]:
        keys += [("ks", np.float32, (L, ps, hkv)), ("vs", np.float32, (L, ps, hkv))]
    out, off = {}, 0
    for k, dt, shape in keys:
        n = int(np.prod(shape)) * np.dtype(dt).itemsize
        out[k] = np.frombuffer(payload[off:off + n], dt).reshape(shape)
        off += n
    assert off == len(payload)
    return out


def _assert_payloads_agree(hdr, got_pages, want_pages):
    for (gt, gp), (wt, wp) in zip(got_pages, want_pages, strict=True):
        assert gt == wt
        g, w = _pool_arrays(hdr, gp), _pool_arrays(hdr, wp)
        if not hdr["kv_int8"]:
            for k in ("k", "v"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-5)
            continue
        for k, s in (("k", "ks"), ("v", "vs")):
            np.testing.assert_allclose(g[s], w[s], rtol=1e-5, atol=1e-7)
            gd = g[k].astype(np.float32) * g[s][..., None]
            wd = w[k].astype(np.float32) * w[s][..., None]
            step = np.maximum(g[s], w[s])[..., None]
            assert np.all(np.abs(gd - wd) <= step * (1 + 1e-5) + 1e-7)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["dense", "int8"])
def test_bundles_cross_between_jax_and_port(weights, kv_int8):
    jcfg, jp, params = weights
    kw = dict(BASE, kv_int8=kv_int8)
    jsrc = JaxEngine(jp, jcfg, overlap=False, **kw)
    jsrc.submit(JaxRequest(prompt=list(PREFIX), max_new_tokens=4))
    jsrc.run_until_idle()
    jwarm = jsrc.submit(JaxRequest(prompt=PREFIX + SUFFIX, max_new_tokens=8))
    jsrc.run_until_idle()
    jdata = jsrc.export_prefix_pages(PREFIX, "")

    psrc = make_engine(params, overlap=False, kv_int8=kv_int8)
    serve_one(psrc, PREFIX, 4)
    pwarm = serve_one(psrc, PREFIX + SUFFIX, 8)
    pdata = psrc.export_prefix_pages(PREFIX, "")
    assert list(pwarm.output) == list(jwarm.output)

    jh, jpages = kvwire.decode_bundle(jdata)
    ph, ppages = kvwire.decode_bundle(pdata)
    assert ph == jh and len(ppages) == 4
    assert ph["dtype"] == ("int8" if kv_int8 else "float32")
    _assert_payloads_agree(ph, ppages, jpages)

    # the JAX engine's pages into the port: the JAX engine's warm hit
    pdst = make_engine(params, overlap=False, kv_int8=kv_int8)
    assert pdst.import_pages(jh, jpages)["imported"] == 4
    adopted = serve_one(pdst, PREFIX + SUFFIX, 8)
    assert list(adopted.output) == list(jwarm.output)
    assert pdst.prefix_hit_tokens == 32 and pdst.kv_pages_imported == 4

    # the port's pages into the JAX engine: the port's warm hit
    jdst = JaxEngine(jp, jcfg, overlap=False, **kw)
    assert jdst.import_pages(ph, ppages)["imported"] == 4
    jadopted = jdst.submit(JaxRequest(prompt=PREFIX + SUFFIX, max_new_tokens=8))
    jdst.run_until_idle()
    assert list(jadopted.output) == list(pwarm.output)
    assert jdst.prefix_hit_tokens == 32


def test_session_bundles_cross_between_jax_and_port(weights):
    """A JAX engine's session resumes on the port and the other way round,
    greedy float32, equal to an undisturbed run."""
    jcfg, jp, params = weights
    prompt = list(range(2, 23))
    want = run_plain(params, prompt, 16, overlap=False)
    jsrc = JaxEngine(jp, jcfg, overlap=False, **BASE)
    jreq = jsrc.submit(JaxRequest(prompt=prompt, max_new_tokens=16))
    jsrc._admit()
    jsrc.step()
    jh, jpages = kvwire.decode_bundle(jsrc.migrate_out_bundle(0))
    assert jpages and not jreq.done.is_set()
    pdst = make_engine(params, overlap=False)
    pdst.import_pages(jh, jpages)
    resumed = pdst.resume_session(jh["request"])
    pdst.run_until_idle()
    assert list(resumed.output) == want

    psrc = make_engine(params, overlap=False)
    preq = psrc.submit(Request(prompt=prompt, max_new_tokens=16))
    psrc._admit()
    psrc.step()
    ph, ppages = kvwire.decode_bundle(psrc.migrate_out_bundle(0))
    assert ph["request"].keys() == jh["request"].keys()
    assert not preq.done.is_set()
    jdst = JaxEngine(jp, jcfg, overlap=False, **BASE)
    jdst.import_pages(ph, ppages)
    jresumed = jdst.resume_session(ph["request"])
    jdst.run_until_idle()
    assert list(jresumed.output) == want


# -- adoption and import ----------------------------------------------------------


def test_prefix_adoption_parity_vs_local_warm_hit(weights):
    params = weights[2]
    prefix = PREFIX[:17]
    src = make_engine(params)
    serve_one(src, prefix, 4)
    hit0 = src.prefix_hit_tokens
    warm = serve_one(src, prefix + SUFFIX, 8)
    warm_matched = src.prefix_hit_tokens - hit0
    assert warm_matched == 16
    hdr, pages = kvwire.decode_bundle(src.export_prefix_pages(prefix, ""))
    assert len(pages) == 2 and src.kv_exports == 1 and src.kv_pages_exported == 2
    dst = make_engine(params)
    res = dst.import_pages(hdr, pages)
    assert res == {"imported": 2, "already": 0, "tokens": 16, "stopped": None}
    adopted = serve_one(dst, prefix + SUFFIX, 8)
    assert list(adopted.output) == list(warm.output)
    assert dst.prefix_hit_tokens == warm_matched and dst.prefix_admission_hits == 1
    # idempotent re-import: everything already cached
    res2 = dst.import_pages(hdr, pages)
    assert res2["imported"] == 0 and res2["already"] == 2
    # nothing cached: no bundle; read-only lookups cap at len - 1
    assert src.export_prefix_pages([9] * 20, "") is None
    assert len(src.cached_prefix_pages(prefix[:16], "")) == 1


def test_import_rejects_geometry_and_lands_nothing(weights):
    params = weights[2]
    src = make_engine(params)
    prefix = list(range(1, 18))
    serve_one(src, prefix, 2)
    hdr, pages = kvwire.decode_bundle(src.export_prefix_pages(prefix, ""))
    for other, field in ((dict(page_size=16), "page_size"), (dict(kv_int8=True), "dtype")):
        with pytest.raises(ValueError, match=field):
            make_engine(params, **other).import_pages(hdr, pages)
    dst = make_engine(params)
    with pytest.raises(ValueError, match="dtype"):
        dst.import_pages(dict(hdr, dtype="bfloat16"), pages)
    with pytest.raises(ValueError, match="unknown adapter"):
        dst.import_pages(dict(hdr, adapter="nope"), pages)
    # a bad LAST page rejects the bundle before the first one lands
    with pytest.raises(ValueError, match="payload size"):
        dst.import_pages(hdr, [pages[0], (pages[1][0], pages[1][1][:-4])])
    with pytest.raises(ValueError, match="partial page"):
        dst.import_pages(hdr, [pages[0], (pages[1][0][:-1], pages[1][1])])
    assert not dst.prefix_entries and dst.kv_imports == 0
    assert len(dst.free_pages) == dst.n_pages - 1
    with pytest.raises(ValueError, match="prefix cache disabled"):
        make_engine(params, prefix_cache=False).import_pages(hdr, pages)


def test_import_pool_pressure_stops_cleanly(weights):
    params = weights[2]
    src = make_engine(params)
    prefix = list(range(1, 42))  # five full pages
    serve_one(src, prefix, 2)
    hdr, pages = kvwire.decode_bundle(src.export_prefix_pages(prefix, ""))
    assert len(pages) == 5
    dst = make_engine(params, n_pages=4)  # scratch + 3 usable
    res = dst.import_pages(hdr, pages)
    assert res["stopped"] == "page pool exhausted"
    assert 0 < res["imported"] <= 3
    # the partial prefix is a leading run, never a gapped chain
    assert len(dst.cached_prefix_pages(prefix, "")) == res["imported"]
    assert not dst.page_ref.any()  # the import's pins were released
    ref = run_plain(params, prefix, 6)
    dst2 = make_engine(params)
    assert dst2.import_pages(hdr, pages[:3])["imported"] == 3
    assert list(serve_one(dst2, prefix, 6).output) == ref
    assert dst2.prefix_hit_tokens == 24


def test_import_writes_the_pool_in_place(weights):
    params = weights[2]
    for kv_int8 in (False, True):
        src = make_engine(params, kv_int8=kv_int8)
        serve_one(src, PREFIX, 2)
        hdr, pages = kvwire.decode_bundle(src.export_prefix_pages(PREFIX, ""))
        dst = make_engine(params, kv_int8=kv_int8)
        pool = dict(dst.kv)
        ptrs = {k: t.data_ptr() for k, t in pool.items()}
        assert dst.import_pages(hdr, pages)["imported"] == 4
        assert all(dst.kv[k] is pool[k] and dst.kv[k].data_ptr() == ptrs[k] for k in pool)
        # the landed bytes are the shipped bytes
        assert kvwire.decode_bundle(dst.export_prefix_pages(PREFIX, ""))[1] == pages


# -- migration -------------------------------------------------------------------


def _migrate_once(params, prompt, max_new, steps_before, src_kw, dst_kw, req_kw=None):
    """Run a session ``steps_before`` steps on one engine, migrate it, finish
    it on another: (output, chunks lost, pages shipped, resumed request)."""
    src, dst = make_engine(params, **src_kw), make_engine(params, **dst_kw)
    req = src.submit(Request(prompt=list(prompt), max_new_tokens=max_new, **(req_kw or {})))
    src._admit()
    for _ in range(steps_before):
        if req.done.is_set():
            break
        src.step()
    if req.done.is_set():
        return list(req.output), 0, 0, req
    before = src.chunks_discarded
    bundle = src.migrate_out_bundle(0)
    assert bundle is not None and src.slots[0] is None
    lost = src.chunks_discarded - before
    hdr, pages = kvwire.decode_bundle(bundle)
    assert hdr["kind"] == "session"
    if pages:
        assert dst.import_pages(hdr, pages)["imported"] == len(pages)
    resumed = dst.resume_session(hdr["request"])
    dst.run_until_idle(max_steps=100_000)
    assert not resumed.error, resumed.error
    assert src.sessions_migrated_out == 1 and dst.sessions_migrated_in == 1
    return list(resumed.output), lost, len(pages), resumed


PROMPTS = [[3, 9, 14], list(range(2, 23)), [60, 2, 33, 1, 5]]


@pytest.mark.parametrize("overlap_src", [False, True], ids=["src_seq", "src_overlap"])
@pytest.mark.parametrize("overlap_dst", [False, True], ids=["dst_seq", "dst_overlap"])
def test_migration_parity(weights, overlap_src, overlap_dst):
    """Every migration point of each prompt, token-identical, with at most
    one chunk lost."""
    params = weights[2]
    shipped = 0
    for prompt in PROMPTS:
        want = run_plain(params, prompt, 24)
        for steps in range(1, 7):
            out, lost, pages, _ = _migrate_once(params, prompt, 24, steps,
                                                dict(overlap=overlap_src),
                                                dict(overlap=overlap_dst))
            assert out == want, (prompt, steps)
            assert lost <= (1 if overlap_src else 0)
            shipped += pages
    assert shipped > 0


def test_migration_preserves_seeded_sampling_and_logprobs(weights):
    params = weights[2]
    prompt = list(range(5, 26))
    kw = dict(temperature=0.8, top_k=8, seed=777, logprobs=3)
    ref = serve_one(make_engine(params), prompt, 16, **kw)
    for steps in (1, 3):
        out, lost, _, resumed = _migrate_once(params, prompt, 16, steps, {}, {}, req_kw=kw)
        assert out == list(ref.output)
        assert lost <= 1
        assert len(resumed.token_logprobs) == len(resumed.top_logprobs) == len(out)
        # the first emission after the resume comes from the prefill path's
        # host log-softmax: the values agree to float32 rounding
        assert all(abs(a - b) < 1e-4 for a, b in zip(resumed.token_logprobs, ref.token_logprobs))
        for got, want in zip(resumed.top_logprobs, ref.top_logprobs):
            assert [t for t, _ in got] == [t for t, _ in want]
            assert all(abs(g - w) < 1e-4 for (_, g), (_, w) in zip(got, want))


def test_migration_mid_chunked_prefill(weights):
    params = weights[2]
    prompt = list(range(1, 60))
    want = run_plain(params, prompt, 10, prefill_chunk=8)
    src = make_engine(params, prefill_chunk=8)
    dst = make_engine(params, prefill_chunk=8)
    req = src.submit(Request(prompt=prompt, max_new_tokens=10))
    src._admit()  # the first prefill chunk only
    assert src.prefilling[0]
    hdr, pages = kvwire.decode_bundle(src.migrate_out_bundle(0))
    assert hdr["request"]["output"] == [] and len(pages) == 1
    dst.import_pages(hdr, pages)
    resumed = dst.resume_session(hdr["request"])
    dst.run_until_idle()
    assert list(resumed.output) == want
    assert not req.done.is_set() and dst.prefix_hit_tokens == 8


def _adapter(params, seed):
    lo = lora_init(params, 4, ("wq", "wv", "w_out"), generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    for ab in lo["adapters"].values():
        ab["b"] = torch.randn(ab["b"].shape, generator=g) * 0.3
    return lo


def test_migration_of_an_adapter_session(weights):
    """The destination registers the adapter at another bank index: its
    pages are keyed again under the receiver's seed."""
    params = weights[2]
    a, other = _adapter(params, 1), _adapter(params, 5)
    prompt = list(range(2, 23))
    want = run_plain(params, prompt, 16, req_kw=dict(adapter="a"), adapters={"a": a})
    base = run_plain(params, prompt, 16, adapters={"a": a})
    assert want != base  # the adapter changes the stream
    out, lost, pages, _ = _migrate_once(params, prompt, 16, 2,
                                        dict(adapters={"a": a}),
                                        dict(adapters={"other": other, "a": a}),
                                        req_kw=dict(adapter="a"))
    assert out == want and lost <= 1 and pages > 0
    with pytest.raises(ValueError, match="unknown adapter"):
        _migrate_once(params, prompt, 16, 2, dict(adapters={"a": a}), {},
                      req_kw=dict(adapter="a"))


@pytest.mark.parametrize("mode", ["int8 pool", "spec_k"])
def test_migration_in_engine_modes(weights, mode):
    params = weights[2]
    kw = dict(kv_int8=True, paged_kernel=True, prefill_chunk=8) if mode == "int8 pool" \
        else dict(spec_k=3)
    prompt = [4, 5, 6, 4, 5, 6, 4, 5, 6, 4, 5, 6, 7, 8, 9, 1, 2, 3]
    want = run_plain(params, prompt, 24, **kw)
    for steps in (1, 2, 4):
        out, lost, _, _ = _migrate_once(params, prompt, 24, steps, kw, kw)
        assert out == want, steps
        assert lost <= 1


def test_evict_slot_into_the_same_index_emits_no_stale_token(weights):
    """An overlapped chunk in flight when a slot is evicted: the request,
    re-admitted into the same slot index, must not receive that chunk's
    tokens on top of its re-prefilled stream."""
    params = weights[2]
    prompt = [5, 17, 3, 9, 11, 2]
    want = run_plain(params, prompt, 20)
    eng = make_engine(params, overlap=True)
    req = eng.submit(Request(prompt=prompt, max_new_tokens=20))
    eng._admit()
    eng.step()
    eng.step()
    assert eng._pending is not None and [s for s, _ in eng._pending.pairs] == [0]
    before = eng.chunks_discarded
    eng.evict_slot(0)  # requeued
    assert eng.chunks_discarded == before + 1 and eng.slots[0] is None
    eng.run_until_idle()
    assert list(req.output) == want
    after = eng.chunks_discarded
    eng.evict_slot(0)  # an empty slot: nothing to do
    assert eng.chunks_discarded == after


def test_resume_session_validates_and_bypasses_the_queue_cap(weights):
    params = weights[2]
    eng = make_engine(params, max_queue=1)
    state = {"prompt": [1, 2, 3], "output": [], "max_new_tokens": 4}
    eng.submit(Request(prompt=[4, 5], max_new_tokens=2))  # fills the queue
    r = eng.resume_session(state)
    assert not r.done.is_set() and eng.queue.qsize() == 2
    with pytest.raises(ValueError, match="empty prompt"):
        eng.resume_session({"prompt": []})
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.resume_session({"prompt": [1], "max_new_tokens": 500})
    done = eng.resume_session({"prompt": [1], "output": [2, 3], "max_new_tokens": 2})
    assert done.done.is_set()
    eng.draining = True
    with pytest.raises(RuntimeError):
        eng.resume_session(state)


def test_run_task_times_out_and_abandons(weights):
    eng = make_engine(weights[2])
    serve_one(eng, PREFIX, 2)
    with pytest.raises(TimeoutError):
        eng.run_task(lambda: eng.export_prefix_pages(PREFIX), timeout=0.05)
    ran = []
    with pytest.raises(TimeoutError):
        eng.run_task(lambda: ran.append(1), timeout=0.05, abandon_on_timeout=False)
    eng._admit()  # the engine thread drains its tasks
    assert eng.kv_exports == 0 and ran == [1]


def test_run_task_started_before_the_timeout_returns_its_result(weights):
    """A thunk the engine thread started before the caller gave up is not
    abandoned: it runs to its end and the caller gets its result, so a
    caller never answers "nothing landed" for work that did land."""
    eng = make_engine(weights[2])
    started, release = threading.Event(), threading.Event()

    def slow():
        started.set()
        release.wait(5.0)
        return "landed"

    box = {}
    caller = threading.Thread(
        target=lambda: box.setdefault("out", eng.run_task(slow, timeout=0.1)))
    caller.start()
    engine_thread = threading.Thread(target=eng._run_tasks)
    while eng._tasks.empty():
        threading.Event().wait(0.001)
    engine_thread.start()
    assert started.wait(5.0)
    threading.Event().wait(0.3)  # past the caller's timeout, the thunk still running
    release.set()
    caller.join(5.0)
    engine_thread.join(5.0)
    assert box == {"out": "landed"}


def test_spill_drops_the_victims_row_from_the_chunk_in_flight(weights):
    """A spill goes through ``evict_slot``: with an overlapped chunk in
    flight, the victim's row is dropped from it (counted once), and the
    requeued request still resumes exactly."""
    params = weights[2]
    low, high = [5, 17, 3, 9, 11, 2], [8, 1, 40, 22]
    want = run_plain(params, low, 20)
    eng = make_engine(params, overlap=True)
    r_low = eng.submit(Request(prompt=low, max_new_tokens=20, priority=0))
    eng.submit(Request(prompt=high, max_new_tokens=20, priority=1))
    eng._admit()
    eng.step()
    eng.step()
    assert eng._pending is not None and len(eng._pending.pairs) == 2
    i = eng.slots.index(r_low)
    j = 1 - i
    before = eng.chunks_discarded
    eng.stalled[j] = True
    assert eng._maybe_spill()
    eng.stalled[j] = False
    assert eng.slots[i] is None and eng.chunks_discarded == before + 1
    assert [s for s, _ in eng._pending.pairs] == [j]
    eng.run_until_idle()
    assert list(r_low.output) == want


def test_choose_kv_victim_ranking(weights):
    eng = make_engine(weights[2], max_batch=4)
    for i, (pri, pages) in enumerate([(1, 2), (0, 1), (0, 3), (0, 3)]):
        eng.slots[i] = Request(prompt=[1], max_new_tokens=1)
        eng.priorities[i] = pri
        eng.slot_pages[i] = list(range(pages))
    assert choose_kv_victim(eng) == 2  # lowest priority, most pages, lowest slot
    eng.slots[2].done.set()
    assert choose_kv_victim(eng) == 3


# -- HTTP ------------------------------------------------------------------------


def _serve(eng):
    server, loop = serve_inference(eng, port=0, host="127.0.0.1")
    return server, loop, server.server_address[1]


def _stop(*pairs):
    for server, loop in pairs:
        server.shutdown()
        server.server_close()
        loop.stop()


def _post(port, path, body, headers=None, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    h = {"Content-Type": "application/json", **(headers or {})}
    conn.request("POST", path, body if isinstance(body, bytes) else json.dumps(body), h)
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, data


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    r = conn.getresponse()
    data = json.loads(r.read())
    conn.close()
    return data


def _closed_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _slowed(eng, seconds=0.02):
    """Pace the engine's steps so a test can act mid-stream."""
    step = eng.step

    def slow_step():
        threading.Event().wait(seconds)
        step()

    eng.step = slow_step


def _stream(port, body, on_first_token=None):
    """Stream a completion; returns (tokens, error events)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/completions", json.dumps(dict(body, stream=True)),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    toks, errors = [], []
    while True:
        line = resp.readline()
        if not line:
            break
        line = line.strip()
        if not line.startswith(b"data: "):
            continue
        payload = line[6:]
        if payload == b"[DONE]":
            break
        ev = json.loads(payload)
        if "error" in ev:
            errors.append(ev)
        if "token" in ev:
            toks.append(ev["token"])
            if len(toks) == 1 and on_first_token is not None:
                on_first_token()
    conn.close()
    return toks, errors


def test_http_prefill_export_adopt_flow(weights):
    params = weights[2]
    eng_a, eng_b = make_engine(params), make_engine(params)
    eng_a.replica_name, eng_a.fleet_role = "A", "prefill"
    eng_b.replica_name, eng_b.fleet_role = "B", "decode"
    srv_a, loop_a, pa = _serve(eng_a)
    srv_b, loop_b, pb = _serve(eng_b)
    try:
        prompt = list(range(3, 40))
        ref = run_plain(params, prompt, 8)
        st, d = _post(pa, "/v1/prefill", {"prompt": prompt})
        assert st == 200, d
        body = json.loads(d)
        assert body["pages"] == 4 and body["replica"] == "A" and body["tokens"] == len(prompt)
        st, d = _post(pb, "/v1/completions", {"prompt": prompt, "max_tokens": 8},
                      headers={kvwire.KV_SOURCE_HEADER: f"127.0.0.1:{pa}"})
        assert st == 200, d
        assert json.loads(d)["tokens"] == ref
        assert eng_b.kv_pages_imported == 4 and eng_b.prefix_admission_hits == 1
        # the explicit adopt route is idempotent
        st, d = _post(pb, "/v1/kv/adopt", {"source": f"127.0.0.1:{pa}", "tokens": prompt})
        assert st == 200 and json.loads(d)["imported"] == 0
        # the raw export is a bundle of the prompt's pages
        st, d = _post(pa, "/v1/kv/export", {"tokens": prompt})
        assert st == 200 and len(kvwire.decode_bundle(d)[1]) == 4
        st, _ = _post(pa, "/v1/kv/export", {"tokens": [9] * 20})
        assert st == 404
        sa, sb = _get(pa, "/v1/stats"), _get(pb, "/v1/stats")
        assert (sa["role"], sa["replica"], sb["role"], sb["replica"]) == \
            ("prefill", "A", "decode", "B")
        assert sa["page_size"] == 8
        assert sa["kv"]["export_bundles"] == 2 and sa["kv"]["pages_exported"] == 8
        assert sb["kv"]["import_bundles"] == 1 and sb["kv"]["pages_imported"] == 4
        assert sb["kv"]["prefix_hits"] == 1
        assert {"migrated_out", "migrated_in", "prefix_lookups", "prefix_misses",
                "resident_pages", "cached_pages"} <= set(sb["kv"])
        # a dead X-KV-Source costs nothing but the prefill here
        st, d = _post(pb, "/v1/completions", {"prompt": [1] + prompt, "max_tokens": 8},
                      headers={kvwire.KV_SOURCE_HEADER: f"127.0.0.1:{_closed_port()}"})
        assert st == 200 and json.loads(d)["tokens"] == run_plain(params, [1] + prompt, 8)
    finally:
        _stop((srv_a, loop_a), (srv_b, loop_b))


def test_http_migrate_mid_stream_token_identical(weights):
    params = weights[2]
    eng_a, eng_b = make_engine(params), make_engine(params)
    _slowed(eng_a)
    srv_a, loop_a, pa = _serve(eng_a)
    srv_b, loop_b, pb = _serve(eng_b)
    try:
        prompt = [5, 17, 3, 9, 11, 2]
        ref = run_plain(params, prompt, 60)
        result = {}

        def migrate():
            st, d = _post(pa, "/v1/migrate/out", {"dest": f"127.0.0.1:{pb}"})
            result.update(status=st, body=json.loads(d))

        t = threading.Thread(target=migrate, daemon=True)
        toks, errors = _stream(pa, {"prompt": prompt, "max_tokens": 60}, on_first_token=t.start)
        t.join(timeout=30)
        assert not t.is_alive()
        assert result["status"] == 200, result
        assert result["body"]["ok"] and result["body"]["slot"] == 0
        assert toks == ref and not errors
        assert eng_b.sessions_migrated_in == 1 and eng_a.sessions_migrated_out == 1
        assert _get(pb, "/v1/stats")["kv"]["migrated_in"] == 1
        # nothing live: a clean 409
        st, _ = _post(pa, "/v1/migrate/out", {"dest": f"127.0.0.1:{pb}"})
        assert st == 409
    finally:
        _stop((srv_a, loop_a), (srv_b, loop_b))


@pytest.mark.parametrize("refusal", ["draining", "closed port"])
def test_http_migrate_refused_resumes_locally(weights, refusal):
    params = weights[2]
    eng_a, eng_b = make_engine(params), make_engine(params)
    eng_b.draining = True  # refuses resume_session
    _slowed(eng_a)
    srv_a, loop_a, pa = _serve(eng_a)
    srv_b, loop_b, pb = _serve(eng_b)
    dest = f"127.0.0.1:{pb if refusal == 'draining' else _closed_port()}"
    try:
        prompt = [8, 8, 1, 30]
        ref = run_plain(params, prompt, 40)
        result = {}

        def migrate():
            st, d = _post(pa, "/v1/migrate/out", {"dest": dest})
            result.update(status=st, body=json.loads(d))

        t = threading.Thread(target=migrate, daemon=True)
        toks, errors = _stream(pa, {"prompt": prompt, "max_tokens": 40}, on_first_token=t.start)
        t.join(timeout=30)
        assert result["status"] == 502, result
        assert result["body"]["resumed_local"] is True
        assert toks == ref and not errors
        assert eng_b.sessions_migrated_in == 0
        # the refused hop rolled its counters back
        assert eng_a.sessions_migrated_out == 0 and eng_a.kv_pages_exported == 0
    finally:
        _stop((srv_a, loop_a), (srv_b, loop_b))


def test_http_route_status_codes(weights):
    params = weights[2]
    plain, cached = make_engine(params, prefix_cache=False), make_engine(params)
    srv_p, loop_p, pp = _serve(plain)
    srv_c, loop_c, pc = _serve(cached)
    try:
        for path, body in (("/v1/prefill", {"prompt": [1, 2]}),
                           ("/v1/kv/export", {"tokens": [1, 2]}),
                           ("/v1/kv/adopt", {"source": "127.0.0.1:1", "tokens": [1, 2]})):
            st, _ = _post(pp, path, body)
            assert st == 409, path
        assert _post(pc, "/v1/migrate/out", {"dest": "127.0.0.1:1"})[0] == 409
        assert _post(pc, "/v1/kv/export", {"tokens": list(range(20))})[0] == 404
        bad = [("/v1/prefill", {"prompt": [999]}), ("/v1/kv/export", {"tokens": "x"}),
               ("/v1/kv/adopt", {"tokens": [1]}), ("/v1/migrate/out", {}),
               ("/v1/migrate/out", {"dest": "h:1", "slot": True}),
               ("/v1/migrate/in", b"not a bundle"),
               ("/v1/migrate/in", kvwire.encode_bundle({"kind": "prefix"}, [], b"s")),
               ("/v1/migrate/in", kvwire.encode_bundle(
                   {"kind": "session", "request": {"prompt": []}}, [], b"s")),
               ("/v1/kv/export", {"tokens": [1, 2], "adapter": "nope"})]
        for path, body in bad:
            st, d = _post(pc, path, body)
            assert st == 400, (path, body, d)
        st, d = _post(pc, "/v1/kv/adopt", {"source": f"127.0.0.1:{_closed_port()}",
                                          "tokens": list(range(20))})
        assert st == 502 and "source pull failed" in json.loads(d)["error"]
        assert _post(pc, "/v1/kv/nope", {})[0] == 404
        # an engine that stops draining its tasks: 503, the thunk abandoned
        serve_one_remote = _post(pc, "/v1/prefill", {"prompt": PREFIX})
        assert serve_one_remote[0] == 200
        loop_c.stop()
        cached.run_task = functools.partial(InferenceEngine.run_task, cached, timeout=0.2)
        cached.run_verb = functools.partial(InferenceEngine.run_verb, cached, timeout=0.2)
        assert _post(pc, "/v1/kv/export", {"tokens": PREFIX})[0] == 503
        assert _post(pc, "/v1/migrate/out", {"dest": "127.0.0.1:1"})[0] == 503
        session = kvwire.encode_bundle({"kind": "session", "request": {
            "prompt": [1, 2, 3], "max_new_tokens": 2}}, [], b"s")
        assert _post(pc, "/v1/migrate/in", session)[0] == 503
        cached._run_tasks()
        assert cached.kv_exports == 0 and cached.sessions_migrated_in == 0
    finally:
        _stop((srv_p, loop_p), (srv_c, loop_c))


# -- serve's flags and the reference's fleet router ----------------------------


def test_serve_fleet_flags_fail_fast(monkeypatch):
    monkeypatch.delenv("TPU_FLEET_ROLE", raising=False)
    with pytest.raises(SystemExit, match="requires --prefix-cache"):
        serve.main(["--init", "--cpu", "--fleet-role", "prefill"])
    monkeypatch.setenv("TPU_FLEET_ROLE", "Decoder")
    with pytest.raises(SystemExit, match="TPU_FLEET_ROLE='decoder' invalid"):
        serve.main(["--init", "--cpu", "--prefix-cache"])
    monkeypatch.setenv("TPU_FLEET_ROLE", " Decode ")
    assert serve.fleet_role(serve.build_args(["--init", "--prefix-cache"])) == "decode"
    with pytest.raises(SystemExit, match="--fleet-role decode requires"):
        serve.main(["--init", "--cpu"])
    assert serve.fleet_role(serve.build_args(["--init", "--fleet-role", "both"])) == "both"
    with pytest.raises(SystemExit):  # argparse refuses an unknown flag value
        serve.build_args(["--init", "--fleet-role", "router"])


class _RelayUp:
    up = True
    detail = "no relay"


def test_reference_router_splits_through_port_replicas(weights):
    """``fleet/router.FleetRouter`` in front of a prefill-role and a
    decode-role port replica: a long prompt prefills on P, D adopts its
    pages through ``X-KV-Source``, and the tokens equal one engine's."""
    params = weights[2]
    eng_p, eng_d = make_engine(params), make_engine(params)
    eng_p.replica_name, eng_p.fleet_role = "pre-0", "prefill"
    eng_d.replica_name, eng_d.fleet_role = "dec-0", "decode"
    srv_p, loop_p, pp = _serve(eng_p)
    srv_d, loop_d, pd = _serve(eng_d)
    rs = ReplicaSet(interval_s=60.0, relay_monitor=_RelayUp())
    rs.add(Replica("pre-0", "127.0.0.1", pp))
    rs.add(Replica("dec-0", "127.0.0.1", pd))
    rs.refresh()
    router = FleetRouter(rs, host="127.0.0.1", port=0, page_size=8, disagg_min_pages=3)
    try:
        rport = router.start()
        assert {r.name: r.role for r in rs.all()} == {"pre-0": "prefill", "dec-0": "decode"}
        prompt = list(range(4, 44))  # four full pages
        conn = http.client.HTTPConnection("127.0.0.1", rport, timeout=60)
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": prompt, "max_tokens": 8}),
                     {"Content-Type": "application/json", "Connection": "close"})
        resp = conn.getresponse()
        status, data = resp.status, resp.read()
        conn.close()
        assert status == 200, data
        assert json.loads(data)["tokens"] == run_plain(params, prompt, 8)
        assert router.disagg_prefills == 1 and router.adoptions == 1
        assert eng_p.prefix_lookups == 1 and eng_p.kv_exports == 1
        assert eng_d.kv_pages_imported == 4 and eng_d.prefix_admission_hits == 1
        assert eng_d.prefix_hit_tokens == 32
    finally:
        router.stop()
        _stop((srv_p, loop_p), (srv_d, loop_d))

