"""Port parity for multi-LoRA serving: the adapter bank, the per-slot
deltas in every engine mode, the adapter-seeded prefix cache, and spill
and resume.

The JAX package's ``InferenceEngine`` in its sequential mode
(``overlap=False``) and the port's engine serve the same requests on the
same weights and adapters (``bridge.params_from_jax`` /
``bridge.lora_from_jax``), float32: greedy tokens must be identical for
each adapter and for mixed batches, in every mode the port serves
(sequential, overlapped, ``spec_k=3``, int8 + prefix cache + chunked
prefill), with the counters equal.  The port's own checks follow
``tests/test_multilora.py``: each adapter equals an engine on its merged
weights, a mixed batch equals isolated runs, and cached pages are never
shared across adapters.

The reference runs behind ``reference_engine_copies_uploads``
(``tests/test_torch_engine.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.models import lora as jlora
from elastic_gpu_scheduler_tpu.models.serving import (
    InferenceEngine as JaxEngine,
    Request as JaxRequest,
    build_lora_bank as jax_build_lora_bank,
)
from elastic_gpu_scheduler_tpu_torch.models.bridge import lora_from_jax
from elastic_gpu_scheduler_tpu_torch.models.lora import merge_lora
from elastic_gpu_scheduler_tpu_torch.models.serving import (
    InferenceEngine,
    Request,
    build_lora_bank,
)
from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig

from test_torch_engine import (  # noqa: F401  (the autouse fixture)
    CFG,
    reference_engine_copies_uploads,
    weights,
)

torch.set_num_threads(1)

BASE = dict(max_batch=4, max_len=64, page_size=8, fused_steps=4)
MODES = {
    "sequential": dict(overlap=False),
    "overlapped": dict(overlap=True),
    "spec_k 3": dict(overlap=False, spec_k=3),
    "int8 prefix chunked": dict(overlap=False, kv_int8=True, prefix_cache=True,
                                prefill_chunk=8, paged_kernel=True),
}
# (name, rank, targets): different ranks and targets, every family covered
ADAPTERS = [("styleA", 4, ("wq", "wv")), ("styleB", 2, ("wq", "wk", "w_out")),
            ("styleC", 3, jlora.ALL_TARGETS)]
SHARED = list(range(1, 18))  # two full pages


def _jax_adapters(jp, seed=10):
    """The reference's adapters with non-trivial B, as
    ``tests/test_multilora.py`` builds them."""
    out = {}
    for n, (name, rank, targets) in enumerate(ADAPTERS):
        lo = jlora.lora_init(jax.random.key(seed + n), jp, rank=rank, targets=targets)
        for t, ab in lo["adapters"].items():
            lo["adapters"][t]["b"] = jax.random.normal(jax.random.key(seed + 10 + n),
                                                       ab["b"].shape) * 0.3
        out[name] = lo
    return out


@pytest.fixture(scope="module")
def adapters(weights):
    _, jp, _ = weights
    ja = _jax_adapters(jp)
    return ja, {k: lora_from_jax(jax.tree.map(np.asarray, v), "cpu") for k, v in ja.items()}


def _specs():
    """One mixed batch over the base and every adapter: more requests than
    slots, a one-token prompt (fed by the chunks), two adapters on the
    same prompt, and two prompts on a shared prefix."""
    return [
        ([5, 17, 3], 9, ""),
        ([5, 17, 3], 9, "styleA"),
        (SHARED + [40], 8, "styleB"),
        ([9], 10, "styleC"),
        ([60, 2, 33, 8], 7, "styleA"),
        (SHARED + [7, 7], 8, "styleC"),
        ([2, 3], 9, ""),
    ]


def _serve(eng, request_cls, specs):
    reqs = [eng.submit(request_cls(prompt=list(p), max_new_tokens=n, adapter=a))
            for p, n, a in specs]
    eng.run_until_idle(max_steps=100_000)
    for r in reqs:
        assert r.done.is_set() and not r.error, r.error
    return [r.output for r in reqs]


def _port(params, pa, **kw):
    return InferenceEngine(params, TransformerConfig(**CFG), device="cpu", adapters=pa,
                           **dict(BASE, **kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bank_equals_reference(weights, adapters, dtype):
    _, jp, params = weights
    ja, pa = adapters
    jbank, jindex = jax_build_lora_bank(ja, jnp.dtype(dtype), base_layers=jp["layers"])
    bank, index = build_lora_bank(pa, getattr(torch, dtype), base_layers=params["layers"])
    assert index == jindex == {"": 0, "styleA": 1, "styleB": 2, "styleC": 3}
    assert set(bank) == set(jbank) == set(jlora.ALL_TARGETS)
    for t in bank:
        for n in ("a", "b"):
            got, want = bank[t][n], jbank[t][n]
            assert tuple(got.shape) == want.shape and got.dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want.astype(jnp.float32)))
        assert not bank[t]["a"][:, 0].any() and not bank[t]["b"][:, 0].any()


def _bad_banks(jp, ja):
    """(case, adapters, base layers) that each bank must refuse."""
    small_cfg = dict(CFG, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64)
    from elastic_gpu_scheduler_tpu.models.transformer import (
        TransformerConfig as JaxConfig,
        init_params as jax_init_params,
    )

    p_small = jax_init_params(jax.random.key(1), JaxConfig(**small_cfg))
    other = jlora.lora_init(jax.random.key(3), p_small, rank=4, targets=("wq",))
    nope = {"adapters": {"nope": ja["styleA"]["adapters"]["wq"]}, "alpha": 4.0, "rank": 4}
    return {
        "empty name": ({"": ja["styleA"]}, jp["layers"]),
        "target not in model": ({"x": nope}, jp["layers"]),
        "adapters on two bases": ({"a": ja["styleA"], "b": other}, None),
        "another base": ({"b": other}, jp["layers"]),
    }


@pytest.mark.parametrize("case", ["empty name", "target not in model", "adapters on two bases",
                                  "another base"])
def test_bank_errors_match_reference(weights, adapters, case):
    _, jp, params = weights
    ja, _ = adapters
    jad, jlayers = _bad_banks(jp, ja)[case]
    with pytest.raises(ValueError) as want:
        jax_build_lora_bank(jad, jnp.float32, base_layers=jlayers)
    pad = {k: lora_from_jax(jax.tree.map(np.asarray, v), "cpu") for k, v in jad.items()}
    with pytest.raises(ValueError) as got:
        build_lora_bank(pad, torch.float32,
                        base_layers=params["layers"] if jlayers is not None else None)
    assert str(got.value) == str(want.value)


def test_unknown_adapter_fails_like_the_reference(weights, adapters):
    jcfg, jp, params = weights
    ja, pa = adapters
    jeng = JaxEngine(jp, jcfg, overlap=False, adapters=ja, **BASE)
    peng = _port(params, pa)
    want = jeng.submit(JaxRequest(prompt=[1, 2], max_new_tokens=2, adapter="nope"))
    got = peng.submit(Request(prompt=[1, 2], max_new_tokens=2, adapter="nope"))
    assert got.done.is_set() and got.error == want.error
    assert "'nope'" in got.error and "styleC" in got.error


@pytest.mark.parametrize("mode", list(MODES))
def test_tokens_match_jax_in_every_mode(weights, adapters, mode):
    jcfg, jp, params = weights
    ja, pa = adapters
    kw = dict(BASE, **MODES[mode])
    jeng = JaxEngine(jp, jcfg, adapters=ja, **dict(kw, overlap=False))
    peng = _port(params, pa, **MODES[mode])
    specs = _specs()
    want = _serve(jeng, JaxRequest, specs)
    got = _serve(peng, Request, specs)
    if mode == "int8 prefix chunked":
        # a second wave on the shared prefix, under the adapter that cached
        # it and under another: one hits, the other must not
        wave2 = [(SHARED + [40], 6, "styleB"), (SHARED + [40], 6, "styleA")]
        want += _serve(jeng, JaxRequest, wave2)
        got += _serve(peng, Request, wave2)
        for name in ("prefix_lookups", "prefix_admission_hits", "prefix_hit_tokens"):
            assert getattr(peng, name) == getattr(jeng, name), name
        assert peng.prefix_admission_hits >= 1
    assert got == want
    # the adapters act: the same prompt under "" and styleA differs
    assert got[0] != got[1]
    if mode == "spec_k 3":
        assert (peng.spec_passes, peng.spec_accepted) == (jeng.spec_passes, jeng.spec_accepted)
        assert peng.spec_passes > 0
    assert not peng.adapter_ids.any()  # every released slot is back on the base
    assert len(peng.free_pages) + len(peng.page_key) == peng.n_pages - 1


@pytest.mark.parametrize("overlap", [False, True])
def test_each_adapter_matches_merged_engine(weights, adapters, overlap):
    _, _, params = weights
    _, pa = adapters
    multi = _port(params, pa, overlap=overlap)
    prompt = [3, 9, 14, 27, 5]
    for name in ["", "styleA", "styleB", "styleC"]:
        ref_params = params if name == "" else merge_lora(params, pa[name])
        ref = InferenceEngine(ref_params, TransformerConfig(**CFG), device="cpu",
                              overlap=overlap, **BASE)
        assert _serve(multi, Request, [(prompt, 6, name)]) == \
            _serve(ref, Request, [(prompt, 6, "")]), name


def test_mixed_batch_matches_isolated_runs(weights, adapters):
    _, _, params = weights
    _, pa = adapters
    specs = _specs()
    solo = [_serve(_port(params, pa), Request, [s])[0] for s in specs]
    assert _serve(_port(params, pa), Request, specs) == solo
    assert solo[0] != solo[1]


def test_prefix_cache_isolated_per_adapter(weights, adapters):
    """Cached prompt pages are reused only under the same adapter, with
    the reference's counters."""
    jcfg, jp, params = weights
    ja, pa = adapters
    kw = dict(max_batch=2, max_len=64, page_size=8, prefix_cache=True, overlap=False)
    jeng = JaxEngine(jp, jcfg, adapters=ja, **kw)
    peng = InferenceEngine(params, TransformerConfig(**CFG), device="cpu", adapters=pa, **kw)
    prompt = [int(t) for t in np.arange(2, 20) % CFG["vocab_size"]]  # 18 tokens: 2 pages
    hits, outs = [], []
    for eng, cls in ((jeng, JaxRequest), (peng, Request)):
        h, o = [], []
        for name in ("styleA", "styleC", "styleA"):
            o.append(_serve(eng, cls, [(prompt, 6, name)])[0])
            h.append(eng.prefix_hit_tokens)
        hits.append(h)
        outs.append(o)
    assert hits[1] == hits[0] == [0, 0, 16]
    assert outs[1] == outs[0]
    assert outs[1][2] == outs[1][0] and outs[1][1] != outs[1][0]


def _contended(make, request_cls):
    """An adapter request driven into page pressure, then a higher-priority
    request on another adapter: the first spills and resumes."""
    eng = make()
    victim = eng.submit(request_cls(prompt=[3, 9, 14, 27, 5, 1, 2, 6], max_new_tokens=30,
                                    priority=0, adapter="styleC"))
    for _ in range(40):
        eng._admit()
        eng.step()
        if len(eng.free_pages) == 0:
            break
    assert not victim.done.is_set()
    high = eng.submit(request_cls(prompt=[2, 4, 6, 8, 10, 12, 1, 7], max_new_tokens=8,
                                  priority=5, adapter="styleB"))
    eng.run_until_idle(max_steps=100_000)
    assert not victim.error and not high.error
    assert eng.spills >= 1
    return victim.output, high.output


def test_adapter_request_spills_and_resumes_like_jax(weights, adapters):
    jcfg, jp, params = weights
    ja, pa = adapters
    cfg = TransformerConfig(**CFG)
    kw = dict(max_batch=2, max_len=64, page_size=8, n_pages=6, fused_steps=2)
    want = _contended(lambda: JaxEngine(jp, jcfg, overlap=False, adapters=ja, **kw), JaxRequest)
    for overlap in (False, True):
        got = _contended(lambda: InferenceEngine(params, cfg, device="cpu", overlap=overlap,
                                                 adapters=pa, **kw), Request)
        assert got == want, overlap
    # uncontended, the request gives the same stream
    alone = _serve(_port(params, pa), Request, [([3, 9, 14, 27, 5, 1, 2, 6], 30, "styleC")])
    assert alone[0] == want[0]
