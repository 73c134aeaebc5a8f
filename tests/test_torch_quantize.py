"""Port parity for weight-only int8 (``models/quantize``) and the plain
version of kernel KE (``ops/expert_matmul``).

Quantization is held to the JAX package's bit for bit: ``quantize_tensor``
and ``quantize_params`` on the same numpy weights (fp32 and bf16,
layer-stacked (L, D, H) and expert-stacked (L, E, D, F)), ``wmat`` and the
int8 embedding gather, ``quantized_bytes``, and the bridge carrying
{"q8", "scale"} leaves both ways.  ``expert_matmul_reference`` is held to
the reference's two forms of ``_moe_ffn_serve``'s products, the per-token
gather einsum and the sorted ``lax.ragged_dot``, in float32 within 1e-5
(the same products summed in another order).  The LoRA refusals of a
quantized base are the reference's word for word, and ``serve --int8
--cpu`` serves over HTTP in its own process.
"""

import os
import signal
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.models import lora as jlora
from elastic_gpu_scheduler_tpu.models import quantize as jq
from elastic_gpu_scheduler_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    _embed_lookup as jax_embed_lookup,
    init_params as jax_init_params,
)
from elastic_gpu_scheduler_tpu_torch.models import lora, quantize
from elastic_gpu_scheduler_tpu_torch.models.bridge import (
    params_from_jax,
    params_to_numpy,
    tensor_from_numpy,
    tensor_to_numpy,
)
from elastic_gpu_scheduler_tpu_torch.models.transformer import _embed_lookup
from elastic_gpu_scheduler_tpu_torch.ops import _build
from elastic_gpu_scheduler_tpu_torch.ops.expert_matmul import (
    expert_matmul,
    expert_matmul_reference,
)

from test_torch_http import _get, _post

torch.set_num_threads(1)

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16)}
SHAPES = {"layers (L, D, H)": (3, 24, 40), "experts (L, E, D, F)": (2, 4, 16, 24)}


def _bits(t) -> np.ndarray:
    """A tensor's or array's raw bytes as a flat uint8 array (bf16 exact)."""
    a = tensor_to_numpy(t) if isinstance(t, torch.Tensor) else np.asarray(t)
    return np.ascontiguousarray(a).view(np.uint8).ravel()


def _weight(shape, dtype, seed=0):
    np_dt = DTYPES[dtype][0]
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.7
    w.reshape(-1)[::17] = 0.0  # columns with zeros, and exact halves below
    w.reshape(-1)[5::23] = 0.5
    return w.astype(np_dt)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_tensor_bitwise(dtype, shape):
    w = _weight(SHAPES[shape], dtype)
    want = jq.quantize_tensor(jnp.asarray(w))
    got = quantize.quantize_tensor(tensor_from_numpy(w, "cpu"))
    assert got["q8"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    assert tuple(got["scale"].shape) == tuple(want["scale"].shape)
    np.testing.assert_array_equal(_bits(got["q8"]), _bits(want["q8"]))
    np.testing.assert_array_equal(_bits(got["scale"]), _bits(want["scale"]))


def test_all_zero_column_quantizes_like_the_reference():
    w = np.zeros((4, 6), np.float32)
    w[:, 1] = [1e-30, -2e-30, 0, 0]  # a column far below the 1e-12 floor
    want = jq.quantize_tensor(jnp.asarray(w))
    got = quantize.quantize_tensor(torch.from_numpy(w))
    np.testing.assert_array_equal(_bits(got["q8"]), _bits(want["q8"]))
    np.testing.assert_array_equal(_bits(got["scale"]), _bits(want["scale"]))


def _jax_tree(dtype, n_experts=0):
    jcfg = JaxConfig(vocab_size=61, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                     d_ff=48, dtype=dtype, n_experts=n_experts)
    return jax_init_params(jax.random.key(3), jcfg)


@pytest.mark.parametrize("n_experts", [0, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_params_bitwise_and_bytes(dtype, n_experts):
    jp = _jax_tree(dtype, n_experts)
    want = jq.quantize_params(jp)
    got = quantize.quantize_params(params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    wl = jax.tree.leaves_with_path(want)
    gl = jax.tree.leaves_with_path(params_to_numpy(got))
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=str(path))
    assert quantize.is_qtensor(got["layers"]["wq"]) and quantize.is_qtensor(got["embed"])
    assert not quantize.is_qtensor(got["layers"]["attn_norm"])
    if n_experts:
        assert not quantize.is_qtensor(got["layers"]["moe_gate"])
        assert tuple(got["layers"]["w_in"]["scale"].shape) == (2, 4, 1, 48)
    assert quantize.quantized_bytes(got) == jq.quantized_bytes(want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_wmat_and_int8_embed_lookup_bitwise(dtype):
    jp = jq.quantize_params(_jax_tree(dtype))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jdt, tdt = DTYPES[dtype][1], DTYPES[dtype][2]
    for name in ("wq", "w_out"):
        want = jq.wmat(jax.tree.map(lambda a: a[1], jp["layers"][name]), jdt)
        got = quantize.wmat({k: v[1] for k, v in tp["layers"][name].items()}, tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(_bits(got), _bits(want))
    toks = np.random.default_rng(0).integers(0, 61, (3, 7)).astype(np.int32)
    want = jax_embed_lookup(jp["embed"], jnp.asarray(toks), jdt)
    got = _embed_lookup(tp["embed"], torch.from_numpy(toks), tdt)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # gathered then dequantised: the rows wmat's dense table would give
    dense = quantize.wmat(tp["embed"], tdt)[torch.from_numpy(toks).long()]
    np.testing.assert_array_equal(_bits(got), _bits(dense))


def test_bridge_roundtrips_qtensor_leaves_bit_for_bit():
    want = jax.tree.map(np.asarray, jq.quantize_params(_jax_tree("bfloat16", n_experts=4)))
    back = params_to_numpy(params_from_jax(want, "cpu"))
    wl, bl = jax.tree.leaves(want), jax.tree.leaves(back)
    assert len(wl) == len(bl)
    for w, b in zip(wl, bl):
        np.testing.assert_array_equal(_bits(b), _bits(w))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_wmatmul_int8_is_x_times_wmat(dtype):
    """The int8 branch of ``wmatmul`` (KE's plain version on the CPU) is
    x @ wmat(w) with exact products summed in fp32, cast once; a dense
    leaf keeps ``x @ w``."""
    tdt = DTYPES[dtype][2]
    w = quantize.quantize_tensor(torch.randn(24, 40, generator=torch.Generator().manual_seed(0)))
    x = torch.randn(2, 5, 24, generator=torch.Generator().manual_seed(1)).to(tdt)
    before = _build.LAUNCHES["expert_matmul"]
    got = quantize.wmatmul(x, w, tdt)
    assert _build.LAUNCHES["expert_matmul"] == before  # the CPU: the plain version
    want = (x.float() @ quantize.wmat(w, tdt).float()).to(tdt)
    assert got.shape == (2, 5, 40) and got.dtype == tdt
    torch.testing.assert_close(got, want, atol=1e-5 if dtype == "float32" else 1e-2, rtol=0)
    dense = quantize.wmat(w, tdt)
    assert torch.equal(quantize.wmatmul(x, dense, tdt), x @ dense)


# -- expert_matmul_reference against the reference's two serving forms --------


def _jax_gather(x, w, ids):
    return jnp.einsum("td,tdf->tf", x, w[ids], preferred_element_type=jnp.float32)


def _jax_ragged(x, w, ids, E):
    order = jnp.argsort(ids)
    inv = jnp.argsort(order)
    counts = jnp.bincount(ids, length=E)
    return jax.lax.ragged_dot(x[order], w, counts, preferred_element_type=jnp.float32)[inv]


CASES = {
    "T <= E": (3, 8, [5, 0, 5]),
    "T > E, one expert idle": (11, 4, [0, 2, 2, 3, 0, 0, 2, 3, 3, 0, 2]),
    "one token": (1, 4, [3]),
}


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_expert_matmul_reference_matches_gather_and_ragged_forms(case, int8):
    T, E, ids = CASES[case]
    K, N = 24, 40
    rng = np.random.default_rng(T + E)
    x = rng.standard_normal((T, K)).astype(np.float32)
    w = rng.standard_normal((E, K, N)).astype(np.float32) * K ** -0.5
    ids = np.asarray(ids, np.int32)
    if int8:
        jw = jq.quantize_tensor(jnp.asarray(w))
        wdense = jq.wmat(jw, jnp.float32)
        tw = quantize.quantize_tensor(torch.from_numpy(w))
        got = expert_matmul(torch.from_numpy(x), tw["q8"], torch.from_numpy(ids),
                            scale=tw["scale"], out_dtype=torch.float32)
    else:
        wdense = jnp.asarray(w)
        got = expert_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(ids))
    for want in (_jax_gather(jnp.asarray(x), wdense, ids),
                 _jax_ragged(jnp.asarray(x), wdense, jnp.asarray(ids), E)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_expert_matmul_reference_bf16_rounds_once():
    """bf16 x and an int8 stack: the plain version dequantises through bf16
    and rounds the fp32 sum once, to bf16 or (asked) not at all."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(6, 16, generator=g).to(torch.bfloat16)
    qt = quantize.quantize_tensor(torch.randn(3, 16, 8, generator=g))
    ids = torch.tensor([2, 0, 0, 2, 1, 2], dtype=torch.int32)
    f32 = expert_matmul_reference(x, qt["q8"], ids, qt["scale"], torch.float32)
    bf = expert_matmul_reference(x, qt["q8"], ids, qt["scale"])
    assert bf.dtype == torch.bfloat16 and torch.equal(bf, f32.to(torch.bfloat16))
    wd = quantize.wmat(qt, torch.bfloat16)
    for t in range(6):
        want = x[t].float() @ wd[int(ids[t])].float()
        torch.testing.assert_close(f32[t], want, atol=1e-6, rtol=0)


def test_expert_matmul_refuses_what_it_does_not_take():
    x = torch.zeros(2, 4)
    w = torch.zeros(3, 4, 5)
    with pytest.raises(ValueError, match="need ids"):
        expert_matmul(x, w, None)
    with pytest.raises(ValueError, match="int32"):
        expert_matmul(x, w, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(TypeError, match="dtype"):
        expert_matmul(x, w.to(torch.bfloat16), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="scales"):
        expert_matmul(x, w.to(torch.int8), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError, match="float32"):
        expert_matmul(x, w, torch.zeros(2, dtype=torch.int32), out_dtype=torch.float16)


# -- LoRA refuses a quantized base, word for word -----------------------------


def test_lora_refuses_int8_targets_like_the_reference():
    jp = jq.quantize_params(_jax_tree("float32"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    with pytest.raises(ValueError) as want:
        jlora.lora_init(jax.random.key(0), jp, rank=2)
    with pytest.raises(ValueError) as got:
        lora.lora_init(tp, rank=2)
    assert str(got.value) == str(want.value)
    dense = _jax_tree("float32")
    jl = jlora.lora_init(jax.random.key(0), dense, rank=2)
    tl = lora.lora_init(params_from_jax(jax.tree.map(np.asarray, dense), "cpu"), rank=2)
    with pytest.raises(ValueError) as want:
        jlora.merge_lora(jp, jl)
    with pytest.raises(ValueError) as got:
        lora.merge_lora(tp, tl)
    assert str(got.value) == str(want.value)


# -- serve --int8 ---------------------------------------------------------------


def test_serve_cli_int8_weights_over_http():
    """``serve --init --cpu --int8`` in its own process: a completion and
    its SSE twin answer the same tokens off the quantized weights, and the
    HTTP surface (/v1/stats, /healthz) is the plain engine's; SIGTERM
    drains and exits 0."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "elastic_gpu_scheduler_tpu_torch.serve", "--init", "--cpu",
           "--int8", "--port", str(port), "--host", "127.0.0.1", "--vocab-size", "64",
           "--d-model", "64", "--n-layers", "2", "--n-heads", "2", "--d-ff", "64",
           "--dtype", "float32", "--max-batch", "2", "--max-len", "64", "--page-size", "8",
           "--fused-steps", "4"]
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
        first = _post(addr, {"prompt": [3, 1, 4, 1, 5, 9, 2, 6], "max_tokens": 6})
        second = _post(addr, {"prompt": [3, 1, 4, 1, 5, 9, 2, 6], "max_tokens": 6})
        assert first[0] == second[0] == 200
        assert first[1]["tokens"] == second[1]["tokens"] and len(first[1]["tokens"]) == 6
        code, stats = _get(addr, "/v1/stats")
        assert code == 200 and stats["max_batch"] == 2
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()

