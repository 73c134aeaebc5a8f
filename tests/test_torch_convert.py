"""HF Llama import in the port against the reference's and against
``transformers`` itself.

Each case builds a small ``LlamaForCausalLM`` (or Mistral) from a config,
as ``tests/test_convert.py`` does: MHA, GQA (2 kv heads of 4), a Mistral
sliding window, and tied embeddings (the state dict without
``lm_head.weight``, as a tied checkpoint is saved).  The port's config
must equal the reference's ``config_from_hf_llama`` field for field and
its params the reference's ``params_from_hf_llama`` leaves exactly (both
float32).  Logits: port against the reference's ``forward`` within 2e-5
(``test_torch_model.py``'s float32 tolerance), and against HF's within
2e-4 (3e-4 for Mistral), the reference's own bounds.  Greedy ``generate``
must be token-identical to the reference's and to HF's.

The port also reads a ``config.json`` dict, where the reference's
converter raises ``AttributeError`` (it reads attributes only), and it
refuses what the reference refuses, with the same messages.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from elastic_gpu_scheduler_tpu.models import convert as ref_convert
from elastic_gpu_scheduler_tpu.models.generate import generate as ref_generate
from elastic_gpu_scheduler_tpu.models.transformer import forward as ref_forward
from elastic_gpu_scheduler_tpu_torch.models import convert
from elastic_gpu_scheduler_tpu_torch.models.bridge import params_to_numpy
from elastic_gpu_scheduler_tpu_torch.models.generate import generate
from elastic_gpu_scheduler_tpu_torch.models.transformer import forward

torch.set_num_threads(1)

PORT_TOL = 2e-5


def _llama(seed, tie=False, **kw):
    base = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=64,
                rope_theta=10000.0, tie_word_embeddings=tie)
    base.update(kw)
    torch.manual_seed(seed)
    model = transformers.LlamaForCausalLM(transformers.LlamaConfig(**base))
    return model.eval()


def _mistral(seed):
    cfg = transformers.MistralConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        sliding_window=4, tie_word_embeddings=False)
    torch.manual_seed(seed)
    return transformers.MistralForCausalLM(cfg).eval()


# name -> (a function making the model, HF logits tolerance, tokens)
CASES = {
    "mha": (lambda: _llama(0), 2e-4, [[3, 17, 42, 99, 7, 0, 1, 64], [5, 5, 5, 5, 9, 8, 7, 6]]),
    "gqa": (lambda: _llama(1, vocab_size=64, hidden_size=32, intermediate_size=64,
                           num_key_value_heads=2), 2e-4, [[1, 2, 3, 4, 5, 6]]),
    "mistral_window": (lambda: _mistral(2), 3e-4, [[7, 3, 9, 1, 5, 8, 2, 4, 6, 0, 11, 13]]),
    "tied": (lambda: _llama(3, tie=True), 2e-4, [[9, 8, 7, 1, 2, 3, 4]]),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    build, tol, tokens = CASES[request.param]
    model = build()
    sd = model.state_dict()
    if request.param == "tied":
        sd = {k: v for k, v in sd.items() if k != "lm_head.weight"}
    return request.param, model, sd, tol, np.array(tokens)


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_config_equals_the_references(case):
    name, model, _, _, _ = case
    port, ref = _fields(convert.config_from_hf_llama(model.config)), _fields(
        ref_convert.config_from_hf_llama(model.config))
    assert set(port) <= set(ref)
    assert port == {k: ref[k] for k in port}
    assert port["dtype"] == "float32"
    assert port["n_kv_heads"] == {"mha": 0, "tied": 0, "gqa": 2, "mistral_window": 2}[name]
    assert port["window_size"] == (4 if name == "mistral_window" else 0)


def test_config_json_dict_reads_like_the_config(case, tmp_path):
    """The port reads the dict of the checkpoint's own ``config.json``; the
    reference's converter, handed the same dict (its ``serve --hf``
    path), raises."""
    _, model, _, _, _ = case
    model.config.to_json_file(tmp_path / "config.json")
    d = json.loads((tmp_path / "config.json").read_text())
    assert convert.config_from_hf_llama(d) == convert.config_from_hf_llama(model.config)
    with pytest.raises(AttributeError):
        ref_convert.config_from_hf_llama(d)


def test_params_equal_the_references_exactly(case):
    _, model, sd, _, _ = case
    cfg = convert.config_from_hf_llama(model.config)
    ref = jax.tree.map(np.asarray, ref_convert.params_from_hf_llama(
        sd, ref_convert.config_from_hf_llama(model.config)))
    port = params_to_numpy(convert.params_from_hf_llama(sd, cfg, "cpu"))
    assert jax.tree.structure(port) == jax.tree.structure(ref)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(port), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    if "lm_head.weight" not in sd:
        np.testing.assert_array_equal(port["unembed"], port["embed"].T)


def test_logits_match_the_reference_and_hf(case):
    _, model, sd, hf_tol, tokens = case
    cfg = convert.config_from_hf_llama(model.config)
    params = convert.params_from_hf_llama(sd, cfg, "cpu")
    rcfg = ref_convert.config_from_hf_llama(model.config)
    rparams = ref_convert.params_from_hf_llama(sd, rcfg)
    with torch.no_grad():
        got = forward(params, torch.from_numpy(tokens), cfg).numpy()
        hf = model(torch.from_numpy(tokens)).logits.numpy()
    want = np.asarray(ref_forward(rparams, jnp.asarray(tokens), rcfg))
    np.testing.assert_allclose(got, want, atol=PORT_TOL, rtol=0)
    np.testing.assert_allclose(got, hf, rtol=hf_tol, atol=hf_tol)


def test_greedy_generate_is_token_identical(case):
    _, model, sd, _, tokens = case
    cfg = convert.config_from_hf_llama(model.config)
    params = convert.params_from_hf_llama(sd, cfg, "cpu")
    rcfg = ref_convert.config_from_hf_llama(model.config)
    rparams = ref_convert.params_from_hf_llama(sd, rcfg)
    prompt = tokens[:1, :6]
    with torch.no_grad():
        got = generate(params, torch.from_numpy(prompt), cfg, max_new_tokens=8).numpy()
        hf = model.generate(torch.from_numpy(prompt), max_new_tokens=8, do_sample=False,
                            pad_token_id=0).numpy()
    want = np.asarray(ref_generate(rparams, jnp.asarray(prompt), rcfg, max_new_tokens=8))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, hf)


REFUSALS = [
    (dict(rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                        "high_freq_factor": 4.0, "original_max_position_embeddings": 64}),
     "rope_scaling"),
    (dict(attention_bias=True), "bias terms"),
    (dict(mlp_bias=True), "bias terms"),
    (dict(head_dim=32), "explicit head_dim 32 != hidden/heads 16"),
]


@pytest.mark.parametrize("over, match", REFUSALS, ids=[m for _, m in REFUSALS])
def test_refusals_raise_as_the_references(over, match):
    hf = transformers.LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=64,
                                  num_hidden_layers=1, num_attention_heads=4, **over)
    for src in (hf, hf.to_dict()):
        with pytest.raises(ValueError, match=match) as port_err:
            convert.config_from_hf_llama(src)
        if src is hf:
            with pytest.raises(ValueError) as ref_err:
                ref_convert.config_from_hf_llama(hf)
            assert str(port_err.value) == str(ref_err.value)
