"""Port parity for the paged serving engine.

The JAX package's ``InferenceEngine`` in its sequential mode
(``overlap=False``) and the port's engine serve the same prompts on the
same weights (``bridge.params_from_jax``), float32: the greedy tokens must
be identical, on the gather path and on the paged-kernel path, with mixed
prompt lengths (one-pass prefill), a one-token prompt (fed by the fused
chunks) and more requests than slots.

The reference engine runs behind ``reference_engine_copies_uploads``: on
the CPU backend ``jnp.asarray`` of an aligned numpy array aliases its
buffer, and the reference engine mutates host arrays (``lengths`` right
after an asynchronous chunk dispatch, ``tables``, ``next_token``) that a
dispatched computation may still read, so its tokens would depend on
timing.  The fixture hands the reference serving module a ``jnp`` whose
``asarray`` copies host arrays; nothing in the JAX package changes.  The
other engine-parity files import the fixture from here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.models import serving as jax_serving
from elastic_gpu_scheduler_tpu.models.serving import (
    InferenceEngine as JaxEngine,
    Request as JaxRequest,
)
from elastic_gpu_scheduler_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    init_params as jax_init_params,
)
from elastic_gpu_scheduler_tpu_torch.compilecache import CompileCache
from elastic_gpu_scheduler_tpu_torch.models.bridge import params_from_jax
from elastic_gpu_scheduler_tpu_torch.models.serving import (
    QUEUE_FULL_ERROR,
    InferenceEngine,
    Request,
)
from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig

# the suite runs in parallel worker processes: one intra-op thread keeps
# this file from crowding the workers that run beside it
torch.set_num_threads(1)

CFG = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=128, dtype="float32")
PROMPTS = [[5, 17, 3], [60, 2, 9, 9], list(range(1, 17)), [42],
           [7] * 11, [33, 1, 80, 4, 4, 19]]
MAX_NEW = [8, 6, 8, 9, 5, 7]


class _CopyingJnp:
    """``jax.numpy`` with an ``asarray`` that copies numpy arrays (the
    reference engine's uploads of host state it later mutates)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(a, dtype=None, **kw):
        if isinstance(a, np.ndarray):
            return jnp.array(a, dtype=dtype, copy=True)
        return jnp.asarray(a, dtype=dtype, **kw)


@pytest.fixture(autouse=True)
def reference_engine_copies_uploads(monkeypatch):
    monkeypatch.setattr(jax_serving, "jnp", _CopyingJnp())


def test_copying_jnp_copies_host_arrays_only():
    a = np.arange(1024, dtype=np.int32)
    dev = _CopyingJnp().asarray(a)
    a += 1
    assert int(dev[0]) == 0 and int(dev[-1]) == 1023
    x = jnp.ones(3)
    assert _CopyingJnp().asarray(x) is x
    assert _CopyingJnp().int32 is jnp.int32


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxConfig(**CFG)
    jp = jax_init_params(jax.random.key(2), jcfg)
    return jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _jax_tokens(jcfg, jp, prompts, max_new, **kw):
    eng = JaxEngine(jp, jcfg, overlap=False, **kw)
    reqs = [eng.submit(JaxRequest(prompt=p, max_new_tokens=n)) for p, n in zip(prompts, max_new)]
    eng.run_until_idle()
    for r in reqs:
        assert r.done.is_set() and not r.error, r.error
    return [r.output for r in reqs]


def _port_tokens(params, prompts, max_new, **kw):
    # the sequential mode, as the JAX engine it is compared with runs
    kw.setdefault("overlap", False)
    eng = InferenceEngine(params, TransformerConfig(**CFG), device="cpu", **kw)
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=n)) for p, n in zip(prompts, max_new)]
    eng.run_until_idle()
    for r in reqs:
        assert r.done.is_set() and not r.error, r.error
    assert len(eng.free_pages) == eng.n_pages - 1  # every page came back
    return [r.output for r in reqs], eng


@pytest.mark.parametrize("paged_kernel", [False, True])
def test_engine_greedy_tokens_match_jax(weights, paged_kernel):
    jcfg, jp, params = weights
    kw = dict(max_batch=4, max_len=64, page_size=8, fused_steps=4, paged_kernel=paged_kernel)
    want = _jax_tokens(jcfg, jp, PROMPTS, MAX_NEW, **kw)
    got, eng = _port_tokens(params, PROMPTS, MAX_NEW, **kw)
    assert got == want
    assert [len(t) for t in got] == MAX_NEW
    # every prompt of two or more tokens went through the one-pass prefill
    assert eng.prefills_run == sum(len(p) >= 2 for p in PROMPTS)


def test_engine_sliding_window_matches_jax():
    """A sliding-window model: pages wholly below the window are skipped
    by the paged path; both paths still match the JAX engine."""
    cfg = dict(CFG, window_size=12)
    jcfg = JaxConfig(**cfg)
    jp = jax_init_params(jax.random.key(3), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    prompts, new = [list(range(1, 30)), [7, 8, 9], [50] * 20, [1]], [8, 8, 8, 8]
    for paged_kernel in (False, True):
        kw = dict(max_batch=4, max_len=64, page_size=8, paged_kernel=paged_kernel)
        want = _jax_tokens(jcfg, jp, prompts, new, **kw)
        eng = InferenceEngine(params, TransformerConfig(**cfg), device="cpu", overlap=False,
                              **kw)
        reqs = [eng.submit(Request(prompt=p, max_new_tokens=n)) for p, n in zip(prompts, new)]
        eng.run_until_idle()
        assert [r.output for r in reqs] == want, f"paged_kernel={paged_kernel}"


def test_engine_stall_and_resume_matches_jax(weights):
    """4 usable pages of 8 tokens: two requests of ~24 tokens cannot hold
    their peak pages at once, so one stalls and resumes."""
    jcfg, jp, params = weights
    kw = dict(max_batch=2, max_len=32, page_size=8, n_pages=5, fused_steps=4)
    prompts, new = [[7, 8, 9], [11, 12]], [12, 12]
    want = _jax_tokens(jcfg, jp, prompts, new, **kw)
    got, _ = _port_tokens(params, prompts, new, **kw)
    assert got == want


def test_engine_pool_exhaustion_raises(weights):
    _, _, params = weights
    eng = InferenceEngine(
        params, TransformerConfig(**CFG), max_batch=1, max_len=32, page_size=8,
        n_pages=2, fused_steps=8, device="cpu",
    )  # one usable page = 8 tokens; a 16-token request can never fit
    eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=13))
    with pytest.raises(RuntimeError, match="page pool exhausted"):
        eng.run_until_idle()


def test_engine_stop_tokens_and_sampling(weights):
    _, _, params = weights
    full, _ = _port_tokens(params, [[3, 9, 14]], [12], max_batch=2, max_len=64, page_size=8)
    stop = full[0][4]
    eng = InferenceEngine(params, TransformerConfig(**CFG), max_batch=2, max_len=64,
                          page_size=8, device="cpu")
    r = eng.submit(Request(prompt=[3, 9, 14], max_new_tokens=12, stop_tokens=(stop,)))
    s = eng.submit(Request(prompt=[3, 9, 14], max_new_tokens=12, temperature=0.8,
                           top_k=5, top_p=0.9))
    eng.run_until_idle()
    assert r.output == full[0][: full[0].index(stop) + 1]
    assert len(s.output) == 12 and all(0 <= t < 97 for t in s.output)


def test_engine_rejects_unported_options_and_fields(weights):
    """An unknown engine option raises ``TypeError``; ``compile_cache``
    takes a ``CompileCache`` (the engine keeps it); ``adapters`` is served
    (an engine without them knows only the base model, "")."""
    _, _, params = weights
    cfg = TransformerConfig(**CFG)
    with pytest.raises(TypeError, match="bogus_option"):
        InferenceEngine(params, cfg, device="cpu", bogus_option=1)
    cache = CompileCache(None)
    assert InferenceEngine(params, cfg, max_len=16, device="cpu",
                           compile_cache=cache).compile_cache is cache
    eng = InferenceEngine(params, cfg, max_len=16, device="cpu")
    assert eng.adapter_index == {"": 0} and eng.lora_bank == {}
    unknown = eng.submit(Request(prompt=[1], max_new_tokens=2, adapter="a"))
    assert unknown.done.is_set() and unknown.error == "unknown adapter 'a' (registered: [''])"
    bad = eng.submit(Request(prompt=[1] * 10, max_new_tokens=10))
    assert bad.done.is_set() and "max_len" in bad.error


def test_engine_without_cuda_raises_unless_cpu_requested(weights, monkeypatch):
    _, _, params = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(params, TransformerConfig(**CFG))


def test_engine_bounded_queue_429s_and_purges_cancelled(weights):
    """``max_queue``: a full queue fails a submit with QUEUE_FULL_ERROR (the
    HTTP layer's 429); a request cancelled while queued is purged before
    it counts; spill requeues bypass the cap."""
    _, _, params = weights
    eng = InferenceEngine(params, TransformerConfig(**CFG), max_batch=4, max_len=64,
                          page_size=8, max_queue=2, device="cpu")
    a = eng.submit(Request(prompt=[1, 2], max_new_tokens=3))
    b = eng.submit(Request(prompt=[3, 4], max_new_tokens=3))
    c = eng.submit(Request(prompt=[5, 6], max_new_tokens=3))
    assert not a.done.is_set() and not b.done.is_set()
    assert c.done.is_set() and c.error == QUEUE_FULL_ERROR
    b.cancel()
    d = eng.submit(Request(prompt=[7, 8], max_new_tokens=3))
    assert b.done.is_set() and not b.output  # purged, never admitted
    assert not d.done.is_set() and eng.queue.qsize() == 2
    eng.run_until_idle()
    assert len(a.output) == len(d.output) == 3 and not a.error and not d.error
    for p in ([1], [2], [3]):
        eng._enqueue(Request(prompt=p, max_new_tokens=1))  # the spill requeue path
    assert eng.queue.qsize() == 3
