"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips (from the ``cuda``
fixture) where there is no CUDA device.  The file imports torch and the
port only, so it also runs on a GPU host without JAX:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu

Tolerances: float32 2e-5 absolute; bfloat16 2e-2 absolute plus 1e-2
relative (the kernel and the plain version round P at different points,
and an output past |2| then sits one bfloat16 step, 2^-8 relative, either
side); logsumexp 1e-4.  TF32 is off so float32 products stay float32.

Gradients (K4): ``attention.grad_close``, against
``flash_backward_reference`` rounded where the kernel rounds (P and dS to
bfloat16), and with its looser bfloat16 rule against autograd of
``mha_reference``, which rounds neither.

Blockwise statistics (K3): ``attention.block_stats_tolerance_used``
against ``flash_block_stats_reference`` (p rounded like the kernel);
pv / l against ``mha_reference`` over the kept keys with K1's output
tolerances.  K2 over an int8 pool: the same tolerances as dense K2.
"""

import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu_torch.models import serving
from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig, init_params
from elastic_gpu_scheduler_tpu_torch.ops import _build
from elastic_gpu_scheduler_tpu_torch.ops.attention import (
    NEG_INF,
    block_stats_tolerance_used,
    flash_attention,
    flash_backward,
    flash_backward_reference,
    flash_block_stats,
    flash_block_stats_reference,
    grad_close,
    mha_reference,
)
from elastic_gpu_scheduler_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_reference,
)

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
RTOL = {torch.float32: 0.0, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


def _close(out, ref):
    return bool(((out.float() - ref.float()).abs()
                 <= TOL[ref.dtype] + RTOL[ref.dtype] * ref.float().abs()).all())


# (B, H, Sq, Sk, D, causal, window)
K1_CASES = [
    (2, 2, 64, 64, 32, True, 0),
    (1, 3, 48, 80, 64, True, 0),
    (1, 2, 96, 96, 32, True, 20),
    (2, 1, 37, 37, 32, True, 0),
    (1, 2, 21, 50, 64, True, 9),
    (1, 2, 40, 40, 32, False, 0),
    (1, 4, 128, 1000, 128, True, 0),
    (1, 2, 1, 300, 128, True, 0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", K1_CASES, ids=str)
def test_flash_kernel_matches_plain(cuda, case, dtype):
    B, H, Sq, Sk, D, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(B, H, Sq, D, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, H, Sk, D, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, H, Sk, D, generator=g, device=cuda).to(dtype)
    before = _build.LAUNCHES["flash_fwd"]
    out, lse = flash_attention(q, k, v, causal, None, window, return_lse=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_fwd"] == before + 1
    ref, ref_lse = mha_reference(q, k, v, causal, None, window)
    assert out.dtype == dtype and out.shape == q.shape
    assert _close(out, ref)
    assert _err(lse, ref_lse) <= 1e-4


@pytest.mark.gpu
def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 1, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    h = torch.zeros(1, 1, 8, 32, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(h, h, h)
    q = torch.zeros(1, 1, 16, 32, device=cuda)
    k = torch.zeros(1, 1, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        flash_attention(q, k, k)


# (B, H, Sq, Sk, D, causal, window): the K1 cases plus the train shape's
# head_dim and ragged lengths
K4_CASES = K1_CASES + [(2, 2, 1000, 1000, 128, True, 0), (1, 2, 130, 190, 64, True, 50)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", K4_CASES, ids=str)
def test_flash_backward_kernel_matches_plain(cuda, case, dtype):
    B, H, Sq, Sk, D, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(B, H, Sq, D, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, H, Sk, D, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, H, Sk, D, generator=g, device=cuda).to(dtype)
    do = torch.randn(B, H, Sq, D, generator=g, device=cuda).to(dtype)
    out, lse = mha_reference(q, k, v, causal, None, window)
    before = dict(_build.LAUNCHES)
    got = flash_backward(q, k, v, out, lse, do, causal, None, window)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert _build.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    want = flash_backward_reference(q, k, v, out, lse, do, causal, None, window,
                                    round_like_kernel=True)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert grad_close(a, b), (name, _err(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_grads_match_autograd_of_plain(cuda, dtype):
    """K1 + K4 through the autograd function against autograd of
    mha_reference, on the card."""
    g = torch.Generator(device=cuda).manual_seed(3)
    B, H, S, D = 2, 4, 200, 64
    leaves = [torch.randn(B, H, S, D, generator=g, device=cuda).to(dtype).requires_grad_()
              for _ in range(3)]
    do = torch.randn(B, H, S, D, generator=g, device=cuda).to(dtype)
    got = torch.autograd.grad(flash_attention(*leaves, True, None, 0), leaves, do)
    want = torch.autograd.grad(mha_reference(*leaves, True, None, 0)[0], leaves, do)
    for a, b in zip(got, want):
        assert grad_close(a, b, rounded=False), _err(a, b)


@pytest.mark.gpu
def test_flash_backward_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 1, 8, 48, device=cuda)
    lse = torch.zeros(1, 1, 8, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_backward(q, q, q, q, lse, q)
    q = torch.zeros(1, 1, 16, 32, device=cuda)
    k = torch.zeros(1, 1, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        flash_backward(q, k, k, q, torch.zeros(1, 1, 16, device=cuda), q)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("W", [0, 1, 4])
@pytest.mark.parametrize("window", [0, 20])
@pytest.mark.parametrize("heads", [(8, 4), (6, 2), (16, 8)], ids=str)
def test_paged_kernel_matches_plain(cuda, dtype, W, window, heads):
    Hn, Hkv = heads
    B, Dh, ps, NP, NB = 4, 128, 16, 40, 6
    g = torch.Generator(device=cuda).manual_seed(1)
    qshape = (B, Hn, Dh) if W == 0 else (B, W, Hn, Dh)
    q = torch.randn(qshape, generator=g, device=cuda).to(dtype)
    pk = torch.randn(NP, ps, Hkv, Dh, generator=g, device=cuda).to(dtype)
    pv = torch.randn(NP, ps, Hkv, Dh, generator=g, device=cuda).to(dtype)
    tables = torch.randint(0, NP, (B, NB), generator=g, device=cuda, dtype=torch.int32)
    lengths = torch.tensor([0, 15, 16, NB * ps - max(W, 1)], dtype=torch.int32, device=cuda)
    before = _build.LAUNCHES["paged_attention"]
    out = paged_attention(q, pk, pv, tables, lengths, window=window)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["paged_attention"] == before + 1
    ref = paged_attention_reference(q, pk, pv, tables, lengths, window=window)
    assert out.shape == q.shape
    assert _close(out, ref)


@pytest.mark.gpu
def test_paged_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 2, 48, device=cuda)
    pool = torch.zeros(4, 8, 2, 48, device=cuda)
    t = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    n = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention(q, pool, pool, t, n)
    q = torch.zeros(1, 2, 32, device=cuda)
    pool = torch.zeros(4, 8, 2, 32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        paged_attention(q, pool, pool, t.long(), n)


@pytest.mark.gpu
def test_engine_on_card_matches_cpu_float32(cuda):
    """Small float32 model: greedy tokens on the card (both kernels) equal
    the port's CPU run on the same weights."""
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=256, dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).tolist() for n in (1, 3, 17, 40, 9)]
    outs = {}
    for dev in ("cpu", cuda):
        eng = serving.InferenceEngine(params, cfg, max_batch=4, max_len=96, page_size=16,
                                      fused_steps=4, paged_kernel=True, device=dev)
        reqs = [eng.submit(serving.Request(prompt=p, max_new_tokens=12)) for p in prompts]
        _build.reset_launches()
        eng.run_until_idle()
        assert all(r.done.is_set() and not r.error for r in reqs)
        outs[str(dev)] = [r.output for r in reqs]
        if dev is cuda:
            assert _build.LAUNCHES["flash_fwd"] == cfg.n_layers * eng.prefills_run
            assert _build.LAUNCHES["paged_attention"] == (
                cfg.n_layers * eng.fused_steps * eng.steps_run
            )
    assert outs["cpu"] == outs[str(cuda)]


# (B, H, Hkv, Sq, Sk, D, q_offset, k_offset, causal)
K3_CASES = [
    (1, 16, 8, 128, 512, 128, 384, 0, True),  # a prefix-cached chunk (GQA)
    (1, 16, 8, 200, 640, 128, 440, 0, True),  # ragged Sq and Sk
    (2, 4, 4, 96, 160, 64, 0, 0, True),  # MHA, more keys than the diagonal
    (1, 4, 2, 64, 128, 64, 0, 40, True),  # rows 0..39 keep no key
    (1, 2, 1, 64, 128, 32, 0, 200, True),  # no row keeps a key
    (1, 4, 2, 70, 90, 32, 7, 3, False),  # not causal
]


def _kept_keys_reference(q, k, v, q_off, k_off, causal):
    """mha_reference over the keys the rows keep, where every row keeps
    keys 0..(q_off - k_off + i) (or all keys when not causal); None when
    the geometry has rows with no key."""
    n_rep = q.shape[1] // k.shape[1]
    ke, ve = (t.repeat_interleave(n_rep, dim=1) for t in (k, v))
    if not causal:
        return mha_reference(q, ke, ve, False)[0]
    diag = q_off - k_off
    if diag < 0 or diag + q.shape[2] > k.shape[2]:
        return None
    n = diag + q.shape[2]
    return mha_reference(q, ke[:, :, :n], ve[:, :, :n], True)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", K3_CASES, ids=str)
def test_block_stats_kernel_matches_plain(cuda, case, dtype):
    B, H, Hkv, Sq, Sk, D, q_off, k_off, causal = case
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(B, H, Sq, D, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, Hkv, Sk, D, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, Hkv, Sk, D, generator=g, device=cuda).to(dtype)
    before = _build.LAUNCHES["flash_block_stats"]
    got = flash_block_stats(q, k, v, q_off, k_off, causal=causal)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_block_stats"] == before + 1
    want = flash_block_stats_reference(q, k, v, q_off, k_off, causal)
    shares = block_stats_tolerance_used(got, want, dtype)
    assert max(shares.values()) <= 1.0, shares
    pv, m, l = got
    if causal and q_off < k_off:  # the rows that keep no key, as on the TPU
        empty = slice(0, min(Sq, k_off - q_off))
        assert torch.all(m[:, :, empty] == NEG_INF) and torch.all(l[:, :, empty] == Sk)
    ref = _kept_keys_reference(q, k, v, q_off, k_off, causal)
    if ref is not None:
        assert _close((pv / l[..., None]).to(dtype), ref)


@pytest.mark.gpu
def test_block_stats_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_block_stats(q, q, q, 0, 0)
    q = torch.zeros(1, 3, 8, 32, device=cuda)
    k = torch.zeros(1, 2, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="heads"):
        flash_block_stats(q, k, k, 0, 0)
    h = torch.zeros(1, 2, 8, 32, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_block_stats(h, h, h, 0, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("W", [0, 4])
@pytest.mark.parametrize("window", [0, 20])
def test_paged_kernel_int8_matches_plain(cuda, dtype, W, window):
    Hn, Hkv, B, Dh, ps, NP, NB = 16, 8, 4, 128, 16, 40, 6
    g = torch.Generator(device=cuda).manual_seed(5)
    qshape = (B, Hn, Dh) if W == 0 else (B, W, Hn, Dh)
    q = torch.randn(qshape, generator=g, device=cuda).to(dtype)
    pk, pv = (torch.randint(-127, 128, (NP, ps, Hkv, Dh), generator=g, device=cuda,
                            dtype=torch.int8) for _ in range(2))
    sk, sv = (torch.rand(NP, ps, Hkv, generator=g, device=cuda) * 0.02 for _ in range(2))
    tables = torch.randint(0, NP, (B, NB), generator=g, device=cuda, dtype=torch.int32)
    lengths = torch.tensor([0, 15, 16, NB * ps - max(W, 1)], dtype=torch.int32, device=cuda)
    before = dict(_build.LAUNCHES)
    out = paged_attention(q, pk, pv, tables, lengths, scales_k=sk, scales_v=sv, window=window)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["paged_attention_int8"] == before["paged_attention_int8"] + 1
    assert _build.LAUNCHES["paged_attention"] == before["paged_attention"]
    ref = paged_attention_reference(q, pk, pv, tables, lengths, scales_k=sk, scales_v=sv,
                                    window=window)
    assert out.shape == q.shape
    assert _close(out, ref)


@pytest.mark.gpu
def test_paged_kernel_int8_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 2, 32, device=cuda)
    pool = torch.zeros(4, 8, 2, 32, device=cuda, dtype=torch.int8)
    t = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    n = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="scales"):
        paged_attention(q, pool, pool, t, n, scales_k=torch.zeros(4, 8, 3, device=cuda),
                        scales_v=torch.zeros(4, 8, 3, device=cuda))
    s = torch.zeros(4, 8, 2, device=cuda)
    with pytest.raises(TypeError, match="dequantises"):
        paged_attention(q, pool, pool, t, n, scales_k=s, scales_v=s, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        paged_attention(q, pool.float(), pool.float(), t, n, scales_k=s, scales_v=s)


@pytest.mark.gpu
def test_prefix_chunked_int8_engine_on_card_matches_cpu_float32(cuda):
    """Small float32 model with int8 KV, the prefix cache and chunked
    prefill: greedy tokens on the card (K1, K2-int8, K3) equal the port's
    CPU run, and every kernel of the path ran."""
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=256, dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 256, 32).tolist()
    waves = [[shared + [1, 2], rng.integers(0, 256, 50).tolist()],
             [shared + rng.integers(0, 256, n).tolist() for n in (3, 12, 30)]]
    outs = {}
    for dev in ("cpu", cuda):
        eng = serving.InferenceEngine(params, cfg, max_batch=4, max_len=96, page_size=16,
                                      fused_steps=4, paged_kernel=True, kv_int8=True,
                                      prefix_cache=True, prefill_chunk=16, device=dev)
        _build.reset_launches()
        got = []
        for wave in waves:
            reqs = [eng.submit(serving.Request(prompt=p, max_new_tokens=10)) for p in wave]
            eng.run_until_idle()
            assert all(r.done.is_set() and not r.error for r in reqs)
            got.append([r.output for r in reqs])
        outs[str(dev)] = got
        if dev is cuda:
            assert eng.prefix_admission_hits == 3
            for name in ("flash_fwd", "flash_block_stats", "paged_attention_int8"):
                assert _build.LAUNCHES[name] > 0, name
            assert _build.LAUNCHES["paged_attention"] == 0
    assert outs["cpu"] == outs[str(cuda)]
