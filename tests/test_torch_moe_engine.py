"""Port parity for the serving engine on MoE, int8-weight and MoE +
int8-weight models.

The JAX package's ``InferenceEngine`` and the port's serve the same
requests on the same weights (``bridge.params_from_jax``), float32: greedy
tokens must be identical, with the prefix counters and the speculative
pass counts equal, in every engine mode: sequential, overlapped, int8 KV
with the prefix cache and chunked prefill, ``spec_k`` 3 with prompt
lookup and with a dense draft model.  The MoE model is
``tests/test_serving_moe.py``'s (E 4, the router sharpened × 8 so tokens
spread over the experts); max_batch 4 (= E: the reference's decode
gathers each token's experts) and 6 (> E: its grouped ``ragged_dot``
form) exercise both of the reference's forms against the port's one
(``_moe_ffn_serve``; on the CPU the plain version of kernel KE).  The
reference engine runs behind ``reference_engine_copies_uploads``.  Also:
multi-LoRA on an int8 base and on a MoE base's attention families.
"""

import jax
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.models import lora as jlora
from elastic_gpu_scheduler_tpu.models.quantize import quantize_params as jax_quantize
from elastic_gpu_scheduler_tpu.models.serving import (
    InferenceEngine as JaxEngine,
    Request as JaxRequest,
)
from elastic_gpu_scheduler_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    init_params as jax_init_params,
)
from elastic_gpu_scheduler_tpu_torch.models.bridge import lora_from_jax, params_from_jax
from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine, Request
from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig

from test_torch_engine import reference_engine_copies_uploads  # noqa: F401  (autouse)

torch.set_num_threads(1)

MOE = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=2, d_ff=64, dtype="float32",
           n_experts=4, capacity_factor=4.0)
DRAFT = dict(vocab_size=97, d_model=16, n_layers=1, n_heads=2, d_ff=32, dtype="float32")
VARIANTS = {"moe": (4, False), "int8": (0, True), "moe + int8": (4, True)}
BASE = dict(max_len=48, page_size=8, fused_steps=4)
MODES = {
    "sequential": dict(overlap=False),
    "overlapped": dict(overlap=True),
    "int8 KV prefix chunked": dict(overlap=False, kv_int8=True, prefix_cache=True,
                                   prefill_chunk=8, paged_kernel=True),
    "spec_k 3": dict(overlap=False, spec_k=3),
    "spec_k 3 draft": dict(overlap=False, spec_k=3, draft=True),
}
SHARED = list(range(1, 18))  # two full pages
SPECS = [([5, 17, 3], 6), ([60, 2], 7), ([9, 9, 9, 9], 6), (list(range(1, 20)), 6), ([42], 8),
         ([7] * 11, 5), (SHARED + [40], 6), ([33, 1, 80, 4, 4, 19], 7)]
WAVE2 = [(SHARED + [11, 12], 6), (SHARED + [40], 5)]


def _jax_weights(n_experts, int8, key=1):
    jcfg = JaxConfig(**dict(MOE, n_experts=n_experts))
    jp = jax_init_params(jax.random.key(key), jcfg)
    if n_experts:
        jp["layers"]["moe_gate"] = jp["layers"]["moe_gate"] * 8.0
    return jcfg, jax_quantize(jp) if int8 else jp


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, (n_experts, int8) in VARIANTS.items():
        jcfg, jp = _jax_weights(n_experts, int8)
        out[name] = (jcfg, jp, TransformerConfig(**dict(MOE, n_experts=n_experts)),
                     params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    djcfg = JaxConfig(**DRAFT)
    djp = jax_init_params(jax.random.key(7), djcfg)
    out["draft"] = (djcfg, djp, TransformerConfig(**DRAFT),
                    params_from_jax(jax.tree.map(np.asarray, djp), "cpu"))
    return out


def _serve(eng, request_cls, specs, **extra):
    reqs = [eng.submit(request_cls(prompt=list(p), max_new_tokens=n, **extra))
            for p, n in specs]
    eng.run_until_idle(max_steps=100_000)
    for r in reqs:
        assert r.done.is_set() and not r.error, r.error
    return [list(r.output) for r in reqs]


def _engines(models, variant, mode, max_batch):
    """(the JAX engine, sequential; the port's engine in ``mode``)."""
    jcfg, jp, cfg, params = models[variant]
    kw = dict(BASE, max_batch=max_batch, **MODES[mode])
    jkw, pkw = {}, {}
    if kw.pop("draft", False):
        djcfg, djp, dcfg, dparams = models["draft"]
        jkw["draft"], pkw["draft"] = (djp, djcfg), (dparams, dcfg)
    return (JaxEngine(jp, jcfg, **dict(kw, overlap=False), **jkw),
            InferenceEngine(params, cfg, device="cpu", **kw, **pkw))


CASES = [(v, m, b) for v in VARIANTS for m in MODES
         for b in ((4, 6) if VARIANTS[v][0] else (4,))]


@pytest.mark.parametrize("variant,mode,max_batch", CASES)
def test_tokens_and_counters_match_jax(models, variant, mode, max_batch):
    jeng, peng = _engines(models, variant, mode, max_batch)
    want = _serve(jeng, JaxRequest, SPECS)
    got = _serve(peng, Request, SPECS)
    if "prefix" in mode:
        want += _serve(jeng, JaxRequest, WAVE2)
        got += _serve(peng, Request, WAVE2)
        for name in ("prefix_lookups", "prefix_admission_hits", "prefix_hit_tokens"):
            assert getattr(peng, name) == getattr(jeng, name), name
        assert peng.prefix_admission_hits >= 1
    assert got == want
    assert [len(t) for t in got[:len(SPECS)]] == [n for _, n in SPECS]
    if "spec" in mode:
        assert (peng.spec_passes, peng.spec_accepted) == (jeng.spec_passes, jeng.spec_accepted)
        assert peng.spec_passes > 0
    assert len(peng.free_pages) + len(peng.page_key) == peng.n_pages - 1


def test_router_spreads_tokens_over_the_experts(models):
    """The parity above is vacuous if every token routes to one expert."""
    _, _, _, params = models["moe"]
    toks = torch.tensor([t for p, _ in SPECS for t in p])
    x = params["embed"][toks]
    chosen = torch.argmax(x @ params["layers"]["moe_gate"][0], dim=-1)
    assert len(set(chosen.tolist())) >= 3


def _adapters(jp, targets):
    lo = jlora.lora_init(jax.random.key(20), jp, rank=2, targets=targets)
    for t, ab in lo["adapters"].items():
        lo["adapters"][t]["b"] = jax.random.normal(jax.random.key(21), ab["b"].shape) * 0.3
    return {"tenant": lo}


@pytest.mark.parametrize("variant", ["int8", "moe"])
def test_multilora_on_int8_and_moe_bases_matches_jax(models, variant):
    """Adapters on an int8 dense base (trained on the full-precision base,
    served on its quantization, as the reference allows) and on a MoE
    base's attention families; mixed batch, sequential and overlapped."""
    n_experts, _ = VARIANTS[variant]
    _, full = _jax_weights(n_experts, False)
    ja = _adapters(full, ("wq", "wv", "wo"))
    pa = {k: lora_from_jax(jax.tree.map(np.asarray, v), "cpu") for k, v in ja.items()}
    jcfg, jp, cfg, params = models[variant]
    specs = SPECS[:5]
    for overlap in (False, True):
        jeng = JaxEngine(jp, jcfg, adapters=ja, overlap=False, max_batch=4, **BASE)
        peng = InferenceEngine(params, cfg, device="cpu", adapters=pa, overlap=overlap,
                               max_batch=4, **BASE)
        for adapter in ("", "tenant"):
            want = _serve(jeng, JaxRequest, specs, adapter=adapter)
            got = _serve(peng, Request, specs, adapter=adapter)
            assert got == want, (overlap, adapter)
    assert want != _serve(jeng, JaxRequest, specs)  # the adapter acts


def test_adapter_on_expert_stack_fails_like_the_reference(models):
    dense = jax_init_params(jax.random.key(1), JaxConfig(**dict(MOE, n_experts=0)))
    ja = {"bad": jlora.lora_init(jax.random.key(0), dense, rank=2, targets=("w_in",))}
    pa = {k: lora_from_jax(jax.tree.map(np.asarray, v), "cpu") for k, v in ja.items()}
    jcfg, jp, cfg, params = models["moe"]
    with pytest.raises(ValueError) as want:
        JaxEngine(jp, jcfg, adapters=ja, max_batch=4, **BASE)
    with pytest.raises(ValueError) as got:
        InferenceEngine(params, cfg, device="cpu", adapters=pa, max_batch=4, **BASE)
    assert str(got.value) == str(want.value)
