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

import re

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


# (B, H, Sq, Sk, D, causal, window).  Each runs in bf16 (the register
# design: 64-row tiles on mma.sync, or 128-row tiles on wgmma at D 128 where
# they give >= 2 blocks an SM, the cases marked "wgmma" on an H100) and in
# float32 (register micro-tiles: 32-row query tiles where 64-row tiles give
# < 2 blocks an SM, else 64-row tiles).
K1_CASES = [
    (2, 2, 64, 64, 32, True, 0),
    (1, 3, 48, 80, 64, True, 0),
    (1, 2, 96, 96, 32, True, 20),
    (2, 1, 37, 37, 32, True, 0),
    (1, 2, 21, 50, 64, True, 9),
    (1, 2, 40, 40, 32, False, 0),
    (1, 4, 128, 1000, 128, True, 0),
    (1, 2, 1, 300, 128, True, 0),
    (1, 3, 17, 60, 128, True, 0),  # one key tile, ragged
    (1, 2, 100, 320, 64, False, 0),  # five key tiles: the ring drains on an odd count
    (1, 2, 150, 192, 32, True, 0),  # three key tiles, causal
    (1, 2, 1, 1, 64, True, 0),  # Sq = Sk = 1
    (1, 2, 129, 129, 128, True, 0),  # two 64-row tiles plus one row
    (1, 2, 256, 256, 128, True, 100),  # a window that ends mid-tile
    (4, 34, 129, 129, 128, True, 0),  # wgmma: a 128-row tile plus one row
    (8, 17, 200, 300, 128, True, 0),  # wgmma: ragged, Sq < Sk
    (8, 17, 256, 256, 64, True, 70),  # a large grid at D 64: mma.sync under a window
    (8, 17, 256, 256, 128, True, 70),  # wgmma under a window that ends mid-tile
    (4, 34, 384, 512, 128, False, 0),  # wgmma, not causal, Sq < Sk
]


# (B, H, Sq, Sk, D, causal, window): the float32 kernel's edges, as
# chip_smoke.py's phase 3 holds them: both query tiles (32 rows on a grid
# of 64-row tiles under two blocks an SM, else 64), windows ending
# mid-tile, one row past a tile, Sq 1, rectangular, not causal
K1_FP32_EDGES = [
    (1, 16, 512, 512, 128, True, 0),  # the flagship's longest float32 prefill
    (1, 32, 256, 256, 64, True, 0),  # the --hf prefill
    (1, 16, 512, 512, 128, True, 100),  # a window ending mid-tile
    (4, 34, 200, 300, 128, True, 100),  # the same on 64-row tiles, Sq < Sk
    (1, 2, 150, 150, 64, True, 70),  # D 64, a window ending mid-tile
    (4, 34, 150, 150, 64, True, 70),  # the same on 64-row tiles
    (1, 2, 129, 200, 128, True, 0),  # one row past two tiles, Sq < Sk
    (1, 2, 65, 65, 32, True, 0),  # one row past a tile, D 32
    (1, 2, 1, 65, 64, True, 0),  # Sq 1
    (1, 8, 200, 333, 64, False, 0),  # not causal, ragged
    (4, 34, 129, 300, 64, False, 0),  # not causal on 64-row tiles
]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "case, dtype",
    [pytest.param(c, dt, id=f"{c}-{dt}") for c in K1_CASES
     for dt in (torch.float32, torch.bfloat16)]
    + [pytest.param(c, torch.float32, id=f"{c}-{torch.float32}-edge") for c in K1_FP32_EDGES])
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


def _kernel_names(fn, pattern) -> set:
    """Names matching ``pattern`` of the kernels ``fn`` launches, from
    torch.profiler (which now and then sees no device event, so up to
    five tries).  Late in a long process a profiler window loses some of
    its kernels' records, so, as ``chip_smoke.py``'s windows do, the
    window opens with a ~20 ms spin on the device and calls ``fn`` twice,
    each behind a spin, then spins again: the names are those of either
    call (both launch the same kernels)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(40_000_000)
            for _ in range(2):
                fn()
                torch.cuda._sleep(10_000_000)
            torch.cuda.synchronize()
        names = {m.group(0) for e in prof.key_averages() if (m := re.search(pattern, e.key))}
        if names:
            return names
    return set()


def _k1_kernels(q, k, v, window) -> set:
    """Names of the K1 kernels one causal call launched; the float32
    kernel's with its template arguments ``<D, ROWS>`` (the query tile)."""
    return _kernel_names(lambda: flash_attention(q, k, v, True, None, window),
                         r"flash_fwd_(?:fp32_tile_kernel<\d+, \d+>|\w+?_kernel)")


# (B, H, S, D, window, dtype) -> the kernel that runs there on an H100
K1_ROUTES = [
    ((8, 16, 1024, 128, 0, torch.bfloat16), "flash_fwd_wgmma_kernel"),  # the train shape
    ((8, 17, 256, 128, 70, torch.bfloat16), "flash_fwd_wgmma_kernel"),
    ((1, 16, 512, 128, 0, torch.bfloat16), "flash_fwd_bf16_kernel"),  # the longest serve prefill
    ((8, 16, 1024, 64, 0, torch.bfloat16), "flash_fwd_bf16_kernel"),  # wgmma is D 128 only
    ((8, 16, 1024, 128, 0, torch.float32), "flash_fwd_fp32_tile_kernel<128, 64>"),  # 2,048 blocks
    ((1, 32, 256, 64, 0, torch.float32), "flash_fwd_fp32_tile_kernel<64, 32>"),  # the --hf prefill
]


@pytest.mark.gpu
@pytest.mark.parametrize("case, kernel", K1_ROUTES, ids=str)
def test_flash_kernel_route(cuda, case, kernel):
    """bf16 K1 runs the wgmma kernel at D 128 while its 128-row tiles give
    >= 2 blocks an SM, the 64-row mma.sync kernel otherwise; float32 the
    register micro-tile kernel, on 64-row query tiles where they give >= 2
    blocks an SM (132 SMs), on 32-row tiles otherwise."""
    B, H, S, D, window, dtype = case
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(B, H, S, D, generator=g, device=cuda).to(dtype) for _ in range(3))
    assert _k1_kernels(q, k, v, window) == {kernel}


@pytest.mark.gpu
def test_flash_kernels_bitwise_repeatable(cuda):
    """K1 and K4, K3 with its keys split, and K2 over dense and int8 pools
    with its pages split (no atomics, fixed summation and merge orders)
    give identical bytes when called twice on the same bf16 inputs; so do
    K3's and K4's float32 kernels (the ring's) on the same inputs in
    float32, and K1's float32 kernel causal on 64-row tiles (D 128) and
    under a window on 32-row tiles (D 64)."""
    B, H, S, D = 2, 4, 1000, 128
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, do = (torch.randn(B, H, S, D, generator=g, device=cuda).to(torch.bfloat16)
                   for _ in range(4))
    kv = k[:, :2].contiguous(), v[:, :2].contiguous()
    pq, pools, tables, lengths = _paged_case(cuda, 8, 8, 4, 40, torch.bfloat16, False, seed=7)
    pq8, pools8, tables8, lengths8 = _paged_case(cuda, 8, 8, 4, 40, torch.bfloat16, True,
                                                 seed=8)
    assert _k2_splits(pq, 40) > 1 and _k3_splits(q[:1, :, :64], kv[0][:1], 900, 0) > 1
    runs = []
    for _ in range(2):
        out, lse = flash_attention(q, k, v, True, None, 0, return_lse=True)
        runs.append((out, lse) + flash_backward(q, k, v, out, lse, do, True, None, 0)
                    + flash_block_stats(q[:1, :, :64], kv[0][:1], kv[1][:1], 900, 0)
                    + (paged_attention(pq, *pools, tables, lengths),
                       paged_attention(pq8, *pools8[:2], tables8, lengths8,
                                       scales_k=pools8[2], scales_v=pools8[3])))
    torch.cuda.synchronize()
    names = ("out", "lse", "dq", "dk", "dv", "k3 pv", "k3 m", "k3 l", "k2", "k2 int8")
    for name, a, b in zip(names, *runs):
        assert torch.equal(a, b), name
    # float32: K3 at a diagonal and an earlier-shard offset, K4 causal
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    out, lse = mha_reference(qf, kf, vf, True, None, 0)
    q1, k1, v1 = (torch.randn(4, 8, 600, 128, generator=g, device=cuda) for _ in range(3))
    q64, k64, v64 = (t[..., :64].contiguous() for t in (qf, kf, vf))
    runs = [flash_block_stats(qf, kf, vf, 0, 0) + flash_block_stats(qf, kf, vf, S, 0)
            + flash_backward(qf, kf, vf, out, lse, dof, True, None, 0)
            + flash_attention(q1, k1, v1, True, None, 0, return_lse=True)
            + flash_attention(q64, k64, v64, True, None, 100, return_lse=True)
            for _ in range(2)]
    torch.cuda.synchronize()
    names = ("k3 pv", "k3 m", "k3 l", "k3 pv shard", "k3 m shard", "k3 l shard", "dq", "dk",
             "dv", "k1 out", "k1 lse", "k1 out window", "k1 lse window")
    for name, a, b in zip(names, *runs):
        assert a.dtype == torch.float32 and torch.equal(a, b), f"float32 {name}"


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
# head_dim and ragged lengths.  Sq = Sk = 1 gives each row one key, whose
# softmax has no gradient: dq and dk are zero up to rounding, so no
# tolerance relative to them holds; one row over two keys takes its place.
K4_CASES = [c for c in K1_CASES if c[3] > 1] + [
    (1, 2, 1, 2, 64, True, 0),
    (2, 2, 1000, 1000, 128, True, 0),
    (1, 2, 130, 190, 64, True, 50),
    (8, 16, 512, 512, 128, True, 0),  # the ring's diagonal hop (a 512-token shard)
    (8, 16, 512, 512, 128, False, 0),  # the ring's hop on an earlier shard
]


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


# (B, H, S, D, dtype): bidirectional attention at the ViT's ragged length
# (196 patches + CLS, no multiple of any tile) in bfloat16 at ViT-B/16's
# head_dim, and a float32 case one row past a 64-row tile
NOT_CAUSAL_CASES = [(4, 12, 197, 64, torch.bfloat16), (2, 3, 65, 32, torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", NOT_CAUSAL_CASES, ids=str)
def test_flash_kernels_not_causal_at_ragged_lengths(cuda, case):
    """K1 and K4 with ``causal=False``, as the ViT calls them: the forward
    against ``mha_reference``, the backward against
    ``flash_backward_reference`` rounded like the kernel (``grad_close``),
    and K1 + K4 through autograd against autograd of the plain version."""
    B, H, S, D, dtype = case
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v, do = (torch.randn(B, H, S, D, generator=g, device=cuda).to(dtype)
                   for _ in range(4))
    out, lse = flash_attention(q, k, v, False, None, 0, return_lse=True)
    ref, ref_lse = mha_reference(q, k, v, False, None, 0)
    assert _close(out, ref) and _err(lse, ref_lse) <= 1e-4
    got = flash_backward(q, k, v, ref, ref_lse, do, False, None, 0)
    want = flash_backward_reference(q, k, v, ref, ref_lse, do, False, None, 0,
                                    round_like_kernel=True)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert grad_close(a, b), (name, _err(a, b))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*leaves, False, None, 0), leaves, do)
    want = torch.autograd.grad(mha_reference(*leaves, False, None, 0)[0], leaves, do)
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


def _paged_case(cuda, B, Hn, W, NB, dtype, int8, seed=0, ps=16, Dh=128, Hkv=8):
    """q (rank 3 for W == 1), the pools (with scales when int8), tables
    and lengths: row 0 at 0, rows ending on a page, on the split edges of
    128 and 256 keys (either side), mid-page, and the last row at
    NB * ps - W (a verify window reaching the table's last slot)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    NP = B * NB + 1
    qs = (B, Hn, Dh) if W == 1 else (B, W, Hn, Dh)
    q = torch.randn(qs, generator=g, device=cuda).to(dtype)
    if int8:
        pk, pv = (torch.randint(-127, 128, (NP, ps, Hkv, Dh), generator=g, device=cuda,
                                dtype=torch.int8) for _ in range(2))
        sk, sv = (torch.rand(NP, ps, Hkv, generator=g, device=cuda) * 0.02 for _ in range(2))
        pools = (pk, pv, sk, sv)
    else:
        pools = tuple(torch.randn(NP, ps, Hkv, Dh, generator=g, device=cuda).to(dtype)
                      for _ in range(2))
    tables = (torch.randperm(NP - 1, generator=g, device=cuda)[: B * NB] + 1)
    tables = tables.reshape(B, NB).to(torch.int32)
    cand = [0, 15, 127, 128, 255, 256, 300, NB * ps - W]
    lengths = torch.tensor([min(x, NB * ps - W) for x in cand[:B - 1]] + [NB * ps - W],
                           dtype=torch.int32, device=cuda)
    return q, pools, tables, lengths


def _k2_splits(q, NB) -> int:
    """Splits K2 takes for q against a table of width NB (from the C plan)."""
    W = 1 if q.ndim == 3 else q.shape[1]
    B, Hn, Dh = q.shape[0], q.shape[-2], q.shape[-1]
    words = _build.lib().egs_paged_attention_workspace(B, W, Hn, 8, Dh, NB)
    return words // (B * W * Hn * (Dh + 2)) if words else 1


# (B, Hn, W, NB, window): the engines' widths (NB 40 dense, 64 int8) split,
# NB 41 (a last split of one page), NB 4 (one split: no combine kernel),
# B 1 (many splits), 16 query rows a kv-head (W 4 x n_rep 4: two row groups)
K2_SPLIT_CASES = [
    (8, 16, 1, 40, 0), (8, 16, 4, 40, 256), (8, 16, 1, 64, 256), (8, 16, 4, 64, 0),
    (4, 16, 1, 41, 0), (4, 16, 4, 4, 0), (1, 16, 1, 64, 100), (4, 32, 4, 40, 0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8-float32", "int8-bfloat16"])
@pytest.mark.parametrize("case", K2_SPLIT_CASES, ids=str)
def test_paged_kernel_splits_match_plain(cuda, case, pool):
    """K2 with its pages split across blocks (and not): the plain version
    and the split reference agree with it; the combine kernel runs exactly
    when there is more than one split."""
    from elastic_gpu_scheduler_tpu_torch.ops.paged_attention import (
        paged_attention_split_reference,
    )

    B, Hn, W, NB, window = case
    int8 = pool.startswith("int8")
    dtype = torch.float32 if pool.endswith("float32") else torch.bfloat16
    q, pools, tables, lengths = _paged_case(cuda, B, Hn, W, NB, dtype, int8, seed=NB + W)
    kw = dict(window=window)
    if int8:
        kw.update(scales_k=pools[2], scales_v=pools[3])
    res = []
    names = _kernel_names(lambda: res.append(paged_attention(q, *pools[:2], tables, lengths,
                                                             **kw)),
                          r"paged_attn_\w*kernel")
    out = res[-1]
    ref = paged_attention_reference(q, *pools[:2], tables, lengths, **kw)
    assert out.shape == q.shape and _close(out, ref)
    splits = _k2_splits(q, NB)
    assert names == ({"paged_attn_kernel", "paged_attn_combine_kernel"} if splits > 1
                     else {"paged_attn_kernel"}), (splits, names)
    for pps in (4, NB):
        assert _close(out, paged_attention_split_reference(q, *pools[:2], tables, lengths, pps,
                                                           **kw))


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
            # the overlapped default replays CUDA graphs: each capture's
            # warm-up is one more eager chunk
            assert eng.graphs_captured > 0
            assert _build.LAUNCHES["flash_fwd"] == cfg.n_layers * eng.prefills_run
            assert _build.LAUNCHES["paged_attention"] == (
                cfg.n_layers * eng.fused_steps * (eng.steps_run + eng.graph_warmups)
            )
    assert outs["cpu"] == outs[str(cuda)]


# the verify window of speculative decoding: W = spec_k + 1 queries a row,
# W x n_rep query rows a kv-head, more than a block's 4 (row groups, the
# last one partial at W 5 x n_rep 2); tables that split (NB 40) and one
# that does not (NB 4)
@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8-float32", "int8-bfloat16"])
@pytest.mark.parametrize("NB", [40, 4])
@pytest.mark.parametrize("Hn", [16, 64], ids=["n_rep2", "n_rep8"])
@pytest.mark.parametrize("W", [5, 8])
def test_paged_kernel_verify_window_matches_plain(cuda, W, Hn, NB, pool):
    int8 = pool.startswith("int8")
    dtype = torch.float32 if pool.endswith("float32") else torch.bfloat16
    q, pools, tables, lengths = _paged_case(cuda, 4, Hn, W, NB, dtype, int8, seed=W * NB)
    kw = dict(scales_k=pools[2], scales_v=pools[3]) if int8 else {}
    out = paged_attention(q, *pools[:2], tables, lengths, **kw)
    ref = paged_attention_reference(q, *pools[:2], tables, lengths, **kw)
    assert out.shape == q.shape and _close(out, ref), _err(out, ref)


def _small_model(dtype="float32"):
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=256, dtype=dtype)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _small_engine(cuda, **kw):
    cfg, params = _small_model(kw.pop("dtype", "float32"))
    return cfg, params, serving.InferenceEngine(params, cfg, max_batch=4, max_len=96,
                                                page_size=16, fused_steps=4,
                                                paged_kernel=True, device=cuda, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_replay_matches_eager_chunk(cuda, dtype):
    """One CUDA-graph replay of the decode chunk and one eager
    ``_chunk_in_place`` from cloned identical state give identical sampled
    tokens, carry and pool bytes."""
    _, _, eng = _small_engine(cuda, dtype=dtype)
    rng = np.random.default_rng(2)
    for n in (3, 17, 40):
        eng.submit(serving.Request(prompt=rng.integers(0, 256, n).tolist(),
                                   max_new_tokens=30))
    eng._admit()
    eng.step()  # captures this shape's graph
    eng._drain_pending()
    seen = []
    real = eng._replay_chunk

    def spy(key, args, static):
        seen.append((args, static, {k: v.clone() for k, v in args[1].items()},
                     args[3].clone(), args[4].clone()))
        return real(key, args, static)

    eng._replay_chunk = spy
    captured = eng.graphs_captured
    pending = eng._dispatch_chunk()
    torch.cuda.synchronize()
    # a replay of the graph the first step captured (no warm-up in between)
    assert eng.graphs_captured == captured and eng.graph_replays == 2 and len(seen) == 1
    args, static, kv0, tok0, len0 = seen[0]
    eager_args = list(args)
    eager_args[1], eager_args[3], eager_args[4] = kv0, tok0, len0
    out = serving._chunk_in_place(*eager_args, **static)
    torch.cuda.synchronize()
    assert torch.equal(out, pending.out)
    assert torch.equal(tok0, args[3]) and torch.equal(len0, args[4])
    for name in eng.kv:
        assert torch.equal(kv0[name], eng.kv[name]), name
    eng._drain_chunk(pending)
    eng.run_until_idle()


@pytest.mark.gpu
def test_library_entry_quarantined_rebuilt_and_loaded(cuda, tmp_path):
    """The kernel library as a compile-cache entry: a cold directory builds
    and fills it; a flipped payload byte is quarantined to ``.bad`` and the
    library rebuilt (never loaded from the bad entry); a third start loads
    it, and the loaded library answers."""
    from elastic_gpu_scheduler_tpu_torch.compilecache import CompileCache

    d = str(tmp_path)
    key = _build.library_key()
    cold = CompileCache(d)
    _build.open_library(cold)
    assert (cold.misses, cold.fills, cold.loads) == (1, 1, 0)
    path = cold.path(key)
    blob = bytearray(open(path, "rb").read())
    blob[-100] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    again = CompileCache(d)
    _build.open_library(again)
    assert (again.quarantined, again.misses, again.fills, again.loads) == (1, 1, 1, 0)
    assert (tmp_path / (key + ".aotx.bad")).exists()
    warm = CompileCache(d)
    handle = _build.open_library(warm)
    assert (warm.misses, warm.fills, warm.loads) == (0, 0, 1)
    assert handle.egs_error_string(0)
    assert handle.egs_paged_attention_smem(128, 2) == _build.lib().egs_paged_attention_smem(128, 2)


@pytest.mark.gpu
def test_launcher_compile_cache_fills_then_loads(cuda, tmp_path):
    """``launcher --compile-cache D`` twice, each a process of its own on
    the card: the first builds the library and fills D's entry, the second
    loads it (fills 0, loads 1) and runs no nvcc."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = str(tmp_path / "cache")
    runs = []
    for _ in range(2):
        proc = subprocess.run(
            [sys.executable, "-m", "elastic_gpu_scheduler_tpu_torch.launcher", "--steps", "1",
             "--batch-size", "2", "--seq-len", "64", "--compile-cache", d],
            cwd=repo, env=dict(os.environ, PYTHONPATH=repo), capture_output=True, text=True,
            timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        last = proc.stdout.strip().splitlines()[-1]
        assert last.startswith(f"compile cache {d}: "), proc.stdout[-500:]
        runs.append(json.loads(last.split(": ", 1)[1]))
    assert os.path.exists(os.path.join(d, _build.library_key() + ".aotx"))
    (cold,), (warm,) = runs
    assert (cold["misses"], cold["fills"], cold["loads"]) == (1, 1, 0)
    assert (warm["misses"], warm["fills"], warm["loads"]) == (0, 0, 1)


@pytest.mark.gpu
def test_lattice_captures_every_graph_replay_equals_eager(cuda):
    """The warm-up captures one graph a lattice decode point (3 variants
    x buckets), with one eager scratch chunk before each variant's first
    capture only, leaves the generator where it was, and serving
    afterwards captures nothing; a replay of a warmed graph and one eager
    chunk from cloned identical state give identical tokens, carry and
    pool bytes, for the live dispatch's graph, and then for every captured
    graph at the live slots' state, its live rows' tokens, the carry and
    every page but the scratch page; the tokens equal an unwarmed
    engine's."""
    from elastic_gpu_scheduler_tpu_torch.compilecache import CompileCache, warmup_engine

    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, n).tolist() for n in (3, 17, 40)]
    outs = {}
    for warm in (True, False):
        cache = CompileCache(None) if warm else None
        _, _, eng = _small_engine(cuda, compile_cache=cache)
        if warm:
            gen0 = eng.generator.get_state().clone()
            st = warmup_engine(eng)
            n_chunks = sum(label.startswith("serve_chunk") for label, _ in eng.aot_signatures())
            assert st.state == "ready" and st.errors == 0 and st.built == st.lattice_size
            buckets = eng._pow2_lattice(1, eng.max_pages_per_slot)  # 1, 2, 4, 6
            assert st.captures == eng.graphs_captured == eng.graph_cache.misses == n_chunks
            assert n_chunks == 3 * len(buckets) == 12 and eng.graph_warmups == 3
            assert torch.equal(eng.generator.get_state(), gen0)
        reqs = [eng.submit(serving.Request(prompt=p, max_new_tokens=30)) for p in prompts]
        eng._admit()
        eng.step()
        eng._drain_pending()
        if warm:
            seen = []
            real = eng._replay_chunk

            def spy(key, args, static):
                seen.append((args, static, {k: v.clone() for k, v in args[1].items()},
                             args[3].clone(), args[4].clone()))
                return real(key, args, static)

            eng._replay_chunk = spy
            pending = eng._dispatch_chunk()
            torch.cuda.synchronize()
            args, static, kv0, tok0, len0 = seen[0]
            eager_args = list(args)
            eager_args[1], eager_args[3], eager_args[4] = kv0, tok0, len0
            out = serving._chunk_in_place(*eager_args, **static)
            torch.cuda.synchronize()
            assert torch.equal(out, pending.out)
            assert torch.equal(tok0, args[3]) and torch.equal(len0, args[4])
            for name in eng.kv:
                assert torch.equal(kv0[name], eng.kv[name]), name
            eng._drain_chunk(pending)
            eng._replay_chunk = real
            # every captured graph, at the live slots' state: its view cut
            # or padded with the scratch page to the graph's bucket
            host_view = args[2].cpu().numpy()
            active = args[5].cpu().numpy()
            tok, ln = args[3], args[4]
            for key in sorted(eng.graph_keys()):
                bucket, flags = key[0], key[1:]
                if bucket < host_view.shape[1]:
                    continue  # it would cut a live slot's pages
                view = np.full((eng.max_batch, bucket), serving.SCRATCH_PAGE, np.int32)
                view[:, :host_view.shape[1]] = host_view
                v = dict(zip(("use_filters", "use_temp", "want_lp", "use_pen", "use_seed",
                              "use_min"), flags))
                kargs = eng._chunk_args(v, view, active, (tok, ln))
                kstatic = eng._static(v, n_steps=eng.fused_steps)
                kv0 = {k: t.clone() for k, t in eng.kv.items()}
                tok0, len0, gen0 = tok.clone(), ln.clone(), eng.generator.get_state()
                replayed = eng._replay_chunk(key, kargs, kstatic).clone()
                torch.cuda.synchronize()
                after = ({k: t.clone() for k, t in eng.kv.items()}, tok.clone(), ln.clone())
                for k in eng.kv:
                    eng.kv[k].copy_(kv0[k])
                tok.copy_(tok0)
                ln.copy_(len0)
                eng.generator.set_state(gen0)
                eager = serving._chunk_in_place(*kargs, **kstatic)
                torch.cuda.synchronize()
                # the live rows and every page but the scratch page (an
                # inactive row's sampled tokens and writes are discarded)
                live = torch.from_numpy(active).to(cuda)
                assert torch.equal(eager[live], replayed[live]), key
                assert torch.equal(tok, after[1]) and torch.equal(ln, after[2]), key
                for k in eng.kv:
                    assert torch.equal(eng.kv[k][:, 1:], after[0][k][:, 1:]), (key, k)
                    eng.kv[k].copy_(kv0[k])
                tok.copy_(tok0)
                ln.copy_(len0)
                eng.generator.set_state(gen0)
        eng.run_until_idle()
        assert all(r.done.is_set() and not r.error for r in reqs)
        if warm:
            assert eng.graphs_captured == n_chunks
            assert eng.graph_cache.hits == eng.graph_replays
        outs[warm] = [r.output for r in reqs]
    assert outs[True] == outs[False]


@pytest.mark.gpu
def test_overlapped_engine_on_card_matches_sequential_float32(cuda):
    """The overlapped engine (graph replays) gives the sequential engine's
    greedy tokens on the card and the CPU's, with exact launch counts."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n).tolist() for n in (1, 3, 17, 40, 9, 60)]
    outs = {}
    for name, dev, overlap in (("cpu", "cpu", True), ("seq", cuda, False),
                               ("overlap", cuda, True)):
        cfg, _, eng = _small_engine(dev, overlap=overlap)
        reqs = [eng.submit(serving.Request(prompt=p, max_new_tokens=14)) for p in prompts]
        _build.reset_launches()
        eng.run_until_idle()
        assert all(r.done.is_set() and not r.error for r in reqs)
        outs[name] = [r.output for r in reqs]
        if name == "overlap":
            assert eng.graphs_captured >= 1 and eng.graph_replays == eng.steps_run
            assert _build.LAUNCHES["paged_attention"] == (
                cfg.n_layers * eng.fused_steps * (eng.steps_run + eng.graph_warmups)
            )
            assert eng.host_gap_stats()["chunks"] > 0
    assert outs["overlap"] == outs["seq"] == outs["cpu"]


@pytest.mark.gpu
def test_overlapped_engine_samples_through_graphs(cuda):
    """Sampled rows under overlap replay the filtered and temperature
    graph variants, which draw from the engine's registered generator:
    the same seed gives the same stream, and each replay draws fresh
    numbers.  With the unembedding zeroed every logit is equal, so a
    sampled token is the noise's argmax alone: noise repeated replay
    after replay would give the same fused_steps tokens chunk after chunk."""
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=256, dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params["unembed"].zero_()
    outs = []
    for _ in range(2):
        eng = serving.InferenceEngine(params, cfg, max_batch=4, max_len=96, page_size=16,
                                      fused_steps=4, paged_kernel=True, device=cuda)
        reqs = [eng.submit(serving.Request(prompt=[5, 17, 3], max_new_tokens=40,
                                           temperature=1.0)),
                eng.submit(serving.Request(prompt=[9, 9], max_new_tokens=40, temperature=0.9,
                                           top_k=200, top_p=0.99)),
                eng.submit(serving.Request(prompt=[1, 2, 3, 4], max_new_tokens=40))]
        eng.run_until_idle()
        assert all(r.done.is_set() and not r.error for r in reqs)
        assert eng.graph_replays == eng.steps_run > 0
        assert any(key[1] for key in eng.graph_keys())  # (bucket, use_filters, ...)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
    assert outs[0][2] == [0] * 40  # greedy over equal logits
    for out in outs[0][:2]:
        assert len(set(out)) > 3 * eng.fused_steps, out


@pytest.mark.gpu
@pytest.mark.parametrize("kv_int8", [False, True])
def test_speculative_engine_on_card_matches_cpu_float32(cuda, kv_int8):
    """spec_k 4 through K2's W = 5 window: greedy tokens equal the plain
    engine's and the CPU's, and every verify pass launched K2 once a layer."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, n).tolist() for n in (2, 5, 30)] + [[7, 3, 11, 5] * 6]
    outs = {}
    for name, dev, spec_k in (("cpu", "cpu", 4), ("card", cuda, 4), ("plain", cuda, 0)):
        cfg, _, eng = _small_engine(dev, spec_k=spec_k, kv_int8=kv_int8)
        reqs = [eng.submit(serving.Request(prompt=p, max_new_tokens=16)) for p in prompts]
        _build.reset_launches()
        eng.run_until_idle()
        assert all(r.done.is_set() and not r.error for r in reqs)
        outs[name] = [r.output for r in reqs]
        if name == "card":
            k2 = "paged_attention_int8" if kv_int8 else "paged_attention"
            chunks = eng.steps_run - eng.spec_passes
            assert eng.spec_passes > 0
            assert _build.LAUNCHES[k2] == cfg.n_layers * (
                eng.spec_passes + eng.fused_steps * (chunks + eng.graph_warmups))
    assert outs["card"] == outs["plain"] == outs["cpu"]


# (B, H, Hkv, Sq, Sk, D, q_offset, k_offset, causal).  bf16 splits the keys
# across blocks where the grid is small (most cases here)
K3_CASES = [
    (1, 16, 8, 128, 512, 128, 384, 0, True),  # a prefix-cached chunk (GQA)
    (1, 16, 8, 200, 640, 128, 440, 0, True),  # ragged Sq and Sk
    (2, 4, 4, 96, 160, 64, 0, 0, True),  # MHA, more keys than the diagonal
    (1, 4, 2, 64, 128, 64, 0, 40, True),  # rows 0..39 keep no key
    (1, 2, 1, 64, 128, 32, 0, 200, True),  # no row keeps a key
    (1, 4, 2, 70, 90, 32, 7, 3, False),  # not causal
    (1, 16, 8, 8, 1024, 128, 896, 0, True),  # 8 queries, 1024 keys: many splits
    (1, 16, 8, 256, 512, 128, 256, 0, True),  # the path's longest chunk
    (1, 4, 2, 64, 1000, 64, 0, 300, True),  # no-key rows over several splits, ragged Sk
    (1, 16, 8, 33, 700, 128, 600, 0, True),  # the diagonal mid-tile, a 1-row last tile
    (1, 32, 4, 40, 600, 64, 500, 0, True),  # n_rep 8: a warp spans two heads
    (1, 6, 2, 50, 300, 32, 200, 0, True),  # n_rep 3: 21 positions a block, a padding row
    (1, 16, 8, 64, 64, 128, 0, 0, True),  # one key tile: no split
    (8, 16, 16, 512, 512, 128, 512, 512, True),  # the ring's diagonal hop
    (8, 16, 16, 512, 512, 128, 512, 0, True),  # the ring's hop on an earlier shard
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


def _k3_splits(q, k, q_off, k_off, causal=True) -> int:
    B, H, Sq, D = q.shape
    return _build.lib().egs_flash_block_stats_splits(B, H, k.shape[1], Sq, k.shape[2], 1,
                                                     int(causal), q_off, k_off)


@pytest.mark.gpu
@pytest.mark.parametrize("case", K3_CASES, ids=str)
def test_block_stats_kernel_route(cuda, case):
    """bf16 K3 runs the register kernel, plus the combine kernel exactly
    when its plan splits the keys; float32 its register-tile kernel."""
    B, H, Hkv, Sq, Sk, D, q_off, k_off, causal = case
    q = torch.randn(B, H, Sq, D, device=cuda).to(torch.bfloat16)
    k = torch.randn(B, Hkv, Sk, D, device=cuda).to(torch.bfloat16)
    names = _kernel_names(lambda: flash_block_stats(q, k, k, q_off, k_off, causal),
                          r"flash_stats_kernel\w*")
    want = {"flash_stats_kernel_bf16"}
    if _k3_splits(q, k, q_off, k_off, causal) > 1:
        want.add("flash_stats_kernel_combine")
    assert names == want
    names = _kernel_names(lambda: flash_block_stats(q.float(), k.float(), k.float(), q_off,
                                                    k_off, causal), r"flash_stats_kernel\w*")
    assert names == {"flash_stats_kernel"}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_block_stats_kernel_reads_strided_views(cuda, dtype):
    """The prefix engine's layout: (B, T, H, D) queries and a (B, M, Hkv, D)
    cache seen through transposes go to K3 where they lie (no copy) and give
    the bytes a contiguous copy gives."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn(1, 128, 16, 128, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(1, 512, 8, 128, generator=g, device=cuda).to(dtype) for _ in range(2))
    qT, kT, vT = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    got = flash_block_stats(qT, kT, vT, 300, 0)
    want = flash_block_stats(qT.contiguous(), kT.contiguous(), vT.contiguous(), 300, 0)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


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


# per-request controls: request mixes whose decode chunks take each graph
# variant of chip_smoke.py's phase 6e (every sampled row seeded, so the
# chunk's draws do not depend on the generator's state)
CONTROL_MIXES = {
    "logprobs, bias, allowed, seed, min_tokens": [
        dict(logprobs=5, logit_bias={3: 2.0, 40: -4.0}, min_tokens=12, stop_tokens=(7, 9)),
        dict(logprobs=2, allowed_tokens=tuple(range(100, 164))),
        dict(temperature=0.8, seed=11, logprobs=3, logit_bias={5: 1.0}),
    ],
    "penalties, logprobs": [
        dict(frequency_penalty=0.6, presence_penalty=0.4, logprobs=4),
        dict(frequency_penalty=1.2),
        dict(temperature=0.9, seed=3, presence_penalty=0.5),
    ],
    "filters, seed": [
        dict(temperature=0.7, top_k=20, top_p=0.9, seed=5),
        dict(),
    ],
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mix", list(CONTROL_MIXES))
def test_controls_graph_replay_matches_eager_chunk(cuda, dtype, mix):
    """A graph replay of a controls chunk (bias rows, min_tokens rows,
    penalty counts, seeds, logprob rows) and one eager ``_chunk_in_place``
    from cloned identical state give identical outputs (tokens and the
    logprob triplet), carry and pool bytes."""
    _, _, eng = _small_engine(cuda, dtype=dtype)
    rng = np.random.default_rng(7)
    for n, kw in zip((3, 17, 40), CONTROL_MIXES[mix]):
        eng.submit(serving.Request(prompt=rng.integers(0, 256, n).tolist(),
                                   max_new_tokens=30, **kw))
    eng._admit()
    eng.step()  # captures this variant's graph
    eng._drain_pending()
    seen = []
    real = eng._replay_chunk

    def spy(key, args, static):
        seen.append((key, args, static, {k: v.clone() for k, v in args[1].items()},
                     args[3].clone(), args[4].clone()))
        return real(key, args, static)

    eng._replay_chunk = spy
    captured = eng.graphs_captured
    pending = eng._dispatch_chunk()
    torch.cuda.synchronize()
    assert eng.graphs_captured == captured and len(seen) == 1
    key, args, static, kv0, tok0, len0 = seen[0]
    assert any(key[3:]), key  # a controls variant: logprobs, penalties, seeds or min
    eager_args = list(args)
    eager_args[1], eager_args[3], eager_args[4] = kv0, tok0, len0
    out = serving._chunk_in_place(*eager_args, **static)
    torch.cuda.synchronize()
    outs = out if isinstance(out, tuple) else (out,)
    replayed = pending.out if isinstance(pending.out, tuple) else (pending.out,)
    assert len(outs) == len(replayed) == (4 if key[3] else 1)
    for a, b in zip(outs, replayed):
        assert torch.equal(a, b)
    assert torch.equal(tok0, args[3]) and torch.equal(len0, args[4])
    for name in eng.kv:
        assert torch.equal(kv0[name], eng.kv[name]), name
    eng._drain_chunk(pending)
    eng.run_until_idle()


@pytest.mark.gpu
def test_seeded_uniforms_on_card_equal_golden_vector(cuda):
    """The counter-based draw gives the CPU's golden bits and uniforms on
    the card (int64 arithmetic, exact in float32)."""
    from elastic_gpu_scheduler_tpu_torch.models import sampling

    from test_torch_seeded import GOLDEN_BITS, GOLDEN_ROWS

    seeds = torch.tensor([s for s, _ in GOLDEN_ROWS], device=cuda)
    positions = torch.tensor([p for _, p in GOLDEN_ROWS], device=cuda, dtype=torch.int32)
    assert sampling.seeded_bits(seeds, positions, 5).cpu().tolist() == GOLDEN_BITS
    card = sampling.seeded_uniforms(seeds, positions, 32000).cpu()
    cpu = sampling.seeded_uniforms(seeds.cpu(), positions.cpu(), 32000)
    assert torch.equal(card, cpu)


@pytest.mark.gpu
def test_controls_engine_on_card_matches_cpu_float32(cuda):
    """Greedy requests carrying each control, sequential and overlapped on
    the card, give the sequential CPU run's tokens, and their logprobs
    within 1e-4 with equal top ids; a seeded sampled request gives the
    same tokens in both card modes."""
    rng = np.random.default_rng(8)
    mix = [dict(logprobs=5, logit_bias={3: 2.0, 40: -4.0}),
           dict(logprobs=2, allowed_tokens=tuple(range(100, 164))),
           dict(frequency_penalty=0.7, presence_penalty=0.4, logprobs=3),
           dict(min_tokens=10, stop_tokens=(7, 9, 11)),
           dict(temperature=0.9, seed=21, logprobs=2)]
    prompts = [rng.integers(0, 256, n).tolist() for n in (1, 5, 17, 40, 9)]
    outs = {}
    for name, dev, overlap in (("cpu", "cpu", False), ("seq", cuda, False),
                               ("overlap", cuda, True)):
        _, _, eng = _small_engine(dev, overlap=overlap)
        reqs = [eng.submit(serving.Request(prompt=p, max_new_tokens=16, **kw))
                for p, kw in zip(prompts, mix)]
        eng.run_until_idle()
        assert all(r.done.is_set() and not r.error for r in reqs)
        outs[name] = reqs
    for name in ("seq", "overlap"):
        assert [r.output for r in outs[name][:4]] == [r.output for r in outs["cpu"][:4]]
        for got, want in zip(outs[name][:4], outs["cpu"][:4]):
            if want.logprobs:
                np.testing.assert_allclose(got.token_logprobs, want.token_logprobs,
                                           atol=1e-4, rtol=0)
                assert ([[t for t, _ in top] for top in got.top_logprobs]
                        == [[t for t, _ in top] for top in want.top_logprobs])
    assert outs["seq"][4].output == outs["overlap"][4].output


# multi-LoRA: two adapters on the small engine's base, B non-zero
def _small_lora_engine(cuda, dtype, adapters=True, **kw):
    from elastic_gpu_scheduler_tpu_torch.models.lora import ALL_TARGETS, lora_init

    cfg, params = _small_model(dtype)
    ads = {}
    for n, (name, rank, targets) in enumerate((("a1", 4, ("wq", "wv")),
                                               ("a2", 8, ALL_TARGETS))):
        lo = lora_init(params, rank=rank, targets=targets,
                       generator=torch.Generator().manual_seed(20 + n))
        for ab in lo["adapters"].values():
            ab["b"] = torch.randn(ab["b"].shape, generator=torch.Generator().manual_seed(30 + n))
        ads[name] = lo
    return serving.InferenceEngine(params, cfg, max_batch=4, max_len=96, page_size=16,
                                   fused_steps=4, paged_kernel=True, device=cuda,
                                   adapters=ads if adapters else None, **kw)


LORA_MIX = ("", "a1", "", "a2")


def _lora_requests(eng, mix, max_new=30):
    rng = np.random.default_rng(4)
    return [eng.submit(serving.Request(prompt=rng.integers(0, 256, n).tolist(),
                                       max_new_tokens=max_new, adapter=a))
            for n, a in zip((3, 17, 40, 9), mix)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_graph_replay_matches_eager_chunk(cuda, dtype):
    """A graph replay of a mixed-adapter decode chunk and one eager
    ``_chunk_in_place`` from cloned identical state give identical tokens,
    carry and pool bytes; a new adapter mix replays the same graph."""
    eng = _small_lora_engine(cuda, dtype, overlap=True)
    reqs = _lora_requests(eng, LORA_MIX)
    eng._admit()
    eng.step()  # captures this shape's graph
    eng._drain_pending()
    seen = []
    real = eng._replay_chunk

    def spy(key, args, static):
        seen.append((args, static, {k: v.clone() for k, v in args[1].items()},
                     args[3].clone(), args[4].clone()))
        return real(key, args, static)

    eng._replay_chunk = spy
    captured = eng.graphs_captured
    pending = eng._dispatch_chunk()
    torch.cuda.synchronize()
    assert eng.graphs_captured == captured and len(seen) == 1
    args, static, kv0, tok0, len0 = seen[0]
    assert args[-2] is eng.lora_bank and args[-1].tolist() == [0, 1, 0, 2]
    eager_args = list(args)
    eager_args[1], eager_args[3], eager_args[4] = kv0, tok0, len0
    out = serving._chunk_in_place(*eager_args, **static)
    torch.cuda.synchronize()
    assert torch.equal(out, pending.out)
    assert torch.equal(tok0, args[3]) and torch.equal(len0, args[4])
    for name in eng.kv:
        assert torch.equal(kv0[name], eng.kv[name]), name
    eng._drain_chunk(pending)
    eng.run_until_idle()
    assert all(r.done.is_set() and not r.error for r in reqs)
    # the same prompts on another mix of adapters walk the same table-view
    # buckets: a mirror refresh, no capture
    captured = eng.graphs_captured
    _lora_requests(eng, ("a2", "a2", "a1", ""))
    eng.run_until_idle()
    assert eng.graphs_captured == captured


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_base_rows_equal_bankless_chunks(cuda, dtype):
    """The id-0 rows of every decode chunk of a mixed-adapter batch are
    bitwise the chunks of an engine without adapters on the same batch
    (a zero delta is an exact no-op); both capture the same graph keys."""
    outs = {}
    for bank in (False, True):
        eng = _small_lora_engine(cuda, dtype, adapters=bank, overlap=True)
        chunks = []
        real = eng._drain_chunk

        def spy(p, real=real, chunks=chunks):
            chunks.append([a.copy() for a in p.arrays()][0])
            return real(p)

        eng._drain_chunk = spy
        reqs = _lora_requests(eng, LORA_MIX if bank else ("",) * 4)
        eng.run_until_idle()
        assert all(r.done.is_set() and not r.error for r in reqs)
        outs[bank] = (chunks, [r.output for r in reqs], eng.graph_keys())
    (plain, plain_toks, plain_keys), (mixed, mixed_toks, mixed_keys) = outs[False], outs[True]
    assert len(plain) == len(mixed) and mixed_keys == plain_keys
    base_rows = [i for i, a in enumerate(LORA_MIX) if a == ""]
    for a, b in zip(plain, mixed):
        assert np.array_equal(a[base_rows], b[base_rows])
    assert [plain_toks[i] for i in base_rows] == [mixed_toks[i] for i in base_rows]
    assert plain_toks != mixed_toks  # the adapters act


# -- KE: the expert-indexed / int8 weight product --------------------------------

# (T, E, K, N, ids): one token; T < E; T > E with idle experts; N neither a
# multiple of the 64-column tile nor of 8 (the column-by-column loads); the
# decode and w_out shapes of the flagship MoE (K 2048 / 6912); a K the plan
# splits (few tokens over a narrow N); the dense int8 case (ids None).  A
# bf16 call takes the tensor-core kernel unless N is not a multiple of 16
# (97, 200); float32 the CUDA-core kernel.  Then runs of 64 tokens over
# several chunks, a ragged last K step (K 200), a ragged last column tile
# (N 208), an int8 decode whose K splits
KE_CASES = [
    (1, 8, 2048, 6912, [5]),
    (3, 8, 256, 200, [7, 0, 7]),
    (37, 6, 128, 97, "idle"),
    (8, 8, 2048, 6912, "spread"),
    (8, 8, 6912, 2048, "spread"),
    (24, 4, 2048, 256, "spread"),
    (5, 1, 2048, 2048, None),
    (19, 1, 6912, 320, None),
    (150, 2, 200, 208, "spread"),
    (300, 4, 512, 384, "spread"),
    (512, 8, 2048, 6912, "spread"),
    (8, 1, 6912, 2048, None),
    (40, 1, 2048, 32000, None),
]


def _ke_ids(T, E, ids, cuda):
    if ids is None:
        return None
    if ids == "idle":  # experts 1 and 4 get no token
        ids = [(0, 2, 3, 5)[t % 4] for t in range(T)]
    elif ids == "spread":
        ids = np.random.default_rng(T).integers(0, E, T).tolist()
    return torch.tensor(ids, dtype=torch.int32, device=cuda)


def _ke_inputs(cuda, T, E, K, N, dtype, int8, seed=0):
    from elastic_gpu_scheduler_tpu_torch.models.quantize import quantize_tensor

    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(T, K, generator=g, device=cuda).to(dtype)
    w = torch.randn(E, K, N, generator=g, device=cuda) * K ** -0.5
    if int8:
        qt = quantize_tensor(w.to(dtype))
        return x, qt["q8"], qt["scale"]
    return x, w.to(dtype), None


# sums of up to 6912 products in another order: fp32 1e-4 absolute; a bf16
# output one rounding step either side (2^-8 relative) of the plain one's
KE_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 1e-2)}


@pytest.mark.gpu
@pytest.mark.parametrize("int8,case", [(q, c) for q in (False, True) for c in KE_CASES
                                       if q or c[-1] is not None], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_expert_matmul_kernel_matches_plain(cuda, dtype, int8, case):
    """A dense weight with one expert and no ids is torch.matmul's, never
    KE's: the cases without ids are int8 only."""
    from elastic_gpu_scheduler_tpu_torch.ops.expert_matmul import (
        expert_matmul,
        expert_matmul_reference,
    )

    T, E, K, N, ids = case
    x, w, sc = _ke_inputs(cuda, T, E, K, N, dtype, int8)
    ids = _ke_ids(T, E, ids, cuda)
    for out_dtype in (dtype, torch.float32):
        before = _build.LAUNCHES["expert_matmul"]
        got = expert_matmul(x, w, ids, scale=sc, out_dtype=out_dtype)
        assert _build.LAUNCHES["expert_matmul"] == before + 1
        want = expert_matmul_reference(x, w, ids, sc, out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and got.shape == (T, N)
        atol, rtol = KE_TOL[dtype]
        d = (got.float() - want.float()).abs()
        assert bool((d <= atol + rtol * want.float().abs()).all()), float(d.max())
        assert bool(torch.isfinite(got).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("K", [64, 2048])
def test_expert_matmul_int8_dequantisation_bit_exact(cuda, dtype, K):
    """x = rows of the identity picks weight rows one by one (one product
    1·w, the rest exact zeros), so an fp32 output is the dequantised
    weight itself: bf16(bf16(q)·bf16(scale)) or float(q)·scale, bit for
    bit, 16 rows a call and all K at once: through the CUDA-core kernel
    (float32, and bf16 at N 136, not a multiple of 16; its K split at K
    2048) and the tensor-core kernel (bf16 at N 144)."""
    from elastic_gpu_scheduler_tpu_torch.ops.expert_matmul import (
        dequantize,
        expert_matmul,
        expert_matmul_plan,
    )

    E = 3
    eye = torch.eye(K, device=cuda, dtype=dtype)
    seen = set()
    for N in (136, 144):
        _, w, sc = _ke_inputs(cuda, 1, E, K, N, dtype, True, seed=1)
        for e in range(E):
            want = dequantize(w[e:e + 1], sc[e:e + 1], dtype)[0].float()
            for r0, n in [(r, 16) for r in range(0, K, 16)] + [(0, K)]:
                x = eye[r0:r0 + n]
                ids = torch.full((n,), e, dtype=torch.int32, device=cuda)
                got = expert_matmul(x, w, ids, scale=sc, out_dtype=torch.float32)
                assert torch.equal(got, want[r0:r0 + n]), (N, e, r0, n)
                seen.add(expert_matmul_plan(x, w, ids)["tensor_cores"])
    assert seen == ({False, True} if dtype == torch.bfloat16 else {False})


@pytest.mark.gpu
def test_expert_matmul_bitwise_repeatable_and_graph_replay_equals_eager(cuda):
    """Twice on the same inputs: identical bytes (no atomics; the K splits
    fold in order).  A CUDA graph captured on one routing replays another
    written into the same ids tensor, equal to the eager call on it."""
    from elastic_gpu_scheduler_tpu_torch.ops.expert_matmul import expert_matmul

    for T, E, K, N in ((8, 8, 2048, 6912), (6, 1, 2048, 2048), (8, 1, 2048, 2048),
                       (512, 8, 2048, 512)):
        for int8 in (False, True):
            x, w, sc = _ke_inputs(cuda, T, E, K, N, torch.bfloat16, int8, seed=2)
            ids = _ke_ids(T, E, "spread" if E > 1 else None, cuda)
            a = expert_matmul(x, w, ids, scale=sc)
            b = expert_matmul(x, w, ids, scale=sc)
            assert torch.equal(a, b), (T, E, K, N, int8)
    x, w, sc = _ke_inputs(cuda, 8, 8, 2048, 6912, torch.bfloat16, True, seed=3)
    ids = torch.zeros(8, dtype=torch.int32, device=cuda)
    expert_matmul(x, w, ids, scale=sc)  # first use outside the capture
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = expert_matmul(x, w, ids, scale=sc)
    for routing in ([0] * 8, [7, 1, 1, 3, 0, 7, 2, 2], list(range(8))):
        ids.copy_(torch.tensor(routing, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, expert_matmul(x, w, ids, scale=sc)), routing


@pytest.mark.gpu
def test_expert_matmul_kernel_route(cuda):
    """The profiler sees the kernel the plan names: the ring kernel for bf16
    decode runs (its K splits one thread-block cluster, no combine kernel),
    the wgmma kernel for grouped runs, CUDA cores for float32 and for a
    bf16 N that is not a multiple of 16, and the combine kernel exactly when
    CUDA cores split K."""
    from elastic_gpu_scheduler_tpu_torch.ops.expert_matmul import (
        expert_matmul,
        expert_matmul_plan,
    )

    # (T, E, K, N, dtype) -> (kernel, K splits, ring depth): the MoE decode
    # (w_gate unsplit, w_out in a cluster of 7), the int8 wq of a decode
    # step (a cluster of 5), the grouped prefill, the int8 dense prefill, a
    # float32 int8 decode, a bf16 N that is not a multiple of 16
    routes = {(8, 8, 2048, 6912, torch.bfloat16): ("expert_matmul_ring_kernel", 1, 4),
              (8, 8, 6912, 2048, torch.bfloat16): ("expert_matmul_ring_kernel", 7, 4),
              (8, 1, 2048, 2048, torch.bfloat16): ("expert_matmul_ring_kernel", 5, 4),
              (512, 8, 2048, 6912, torch.bfloat16): ("expert_matmul_wgmma_kernel", 1, 4),
              (512, 1, 2048, 6912, torch.bfloat16): ("expert_matmul_wgmma_kernel", 1, 4),
              (8, 1, 2048, 2048, torch.float32): ("expert_matmul_kernel", 8, 0),
              (8, 8, 256, 200, torch.bfloat16): ("expert_matmul_kernel", 1, 0)}
    for (T, E, K, N, dtype), (kernel, splits, depth) in routes.items():
        x, w, sc = _ke_inputs(cuda, T, E, K, N, dtype, True)
        ids = _ke_ids(T, E, "spread" if E > 1 else None, cuda)
        plan = expert_matmul_plan(x, w, ids)
        assert (plan["route"], plan["splits"], plan["ring_depth"]) == (kernel, splits, depth), (
            T, E, K, N, plan)
        ring = kernel == "expert_matmul_ring_kernel"
        assert plan["cluster"] == (splits if ring else 1)
        assert plan["tensor_cores"] == (kernel != "expert_matmul_kernel")
        assert plan["combine"] == (not plan["tensor_cores"] and splits > 1)
        names = _kernel_names(lambda: expert_matmul(x, w, ids, scale=sc),
                              r"expert_matmul_\w*?kernel")
        want = {kernel} | ({"expert_matmul_combine_kernel"} if plan["combine"] else set())
        assert names == want, (T, E, K, N, names)


def _ke_check(cuda, T, E, K, N, int8, ids="spread", seed=0):
    """One bf16 call at this shape (bf16 and fp32 out) against the plain
    version, one launch each, its plan and the kernels the profiler saw."""
    from elastic_gpu_scheduler_tpu_torch.ops.expert_matmul import (
        expert_matmul,
        expert_matmul_plan,
        expert_matmul_reference,
    )

    x, w, sc = _ke_inputs(cuda, T, E, K, N, torch.bfloat16, int8, seed=seed)
    ids = _ke_ids(T, E, ids if E > 1 else None, cuda)
    for out_dtype in (torch.bfloat16, torch.float32):
        before = _build.LAUNCHES["expert_matmul"]
        got = expert_matmul(x, w, ids, scale=sc, out_dtype=out_dtype)
        assert _build.LAUNCHES["expert_matmul"] == before + 1
        want = expert_matmul_reference(x, w, ids, sc, out_dtype)
        torch.cuda.synchronize()
        atol, rtol = KE_TOL[torch.bfloat16]
        d = (got.float() - want.float()).abs()
        assert bool((d <= atol + rtol * want.float().abs()).all()), (T, E, K, N, float(d.max()))
        assert bool(torch.isfinite(got).all())
    names = _kernel_names(lambda: expert_matmul(x, w, ids, scale=sc), r"expert_matmul_\w*?kernel")
    return x, w, sc, ids, expert_matmul_plan(x, w, ids), names


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", KE_CASES, ids=str)
def test_expert_matmul_new_route_at_every_case(cuda, case, int8):
    """Every KE_CASES shape in bf16 (a dense weight only as int8): N a
    multiple of 16 takes the ring or the wgmma kernel, alone, within
    tolerance; 97 and 200 stay on CUDA cores."""
    T, E, K, N, ids = case
    if ids is None and not int8:
        pytest.skip("a dense bf16 weight is torch.matmul's, never KE's")
    *_, plan, names = _ke_check(cuda, T, E, K, N, int8, ids=ids)
    if N % 16:
        assert plan["route"] == "expert_matmul_kernel"
    else:
        want = ("expert_matmul_wgmma_kernel" if T > 16 * E else "expert_matmul_ring_kernel")
        assert plan["route"] == want and names == {want}, (plan, names)


@pytest.mark.gpu
@pytest.mark.parametrize("cluster,shape", [
    (2, (8, 1, 2048, 6912)),    # the int8 w_gate / w_in
    (3, (8, 1, 1000, 208)),     # a ragged last split (232 rows)
    (4, (8, 1, 2048, 2560)),
    (5, (8, 1, 2048, 2048)),    # the int8 wq
    (7, (8, 8, 6912, 2048)),    # the MoE + int8 w_out
    (8, (8, 1, 2048, 1024)),    # the int8 wk / wv
])
def test_expert_matmul_cluster_split_bitwise_repeatable(cuda, cluster, shape):
    """K split across a thread-block cluster, summed in split order from
    distributed shared memory: the plan's cluster, within tolerance, equal
    bytes twice, no combine kernel."""
    from elastic_gpu_scheduler_tpu_torch.ops.expert_matmul import expert_matmul

    T, E, K, N = shape
    x, w, sc, ids, plan, names = _ke_check(cuda, T, E, K, N, True, seed=4)
    assert (plan["route"], plan["cluster"]) == ("expert_matmul_ring_kernel", cluster), plan
    assert names == {"expert_matmul_ring_kernel"}
    for out_dtype in (torch.bfloat16, torch.float32):
        a = expert_matmul(x, w, ids, scale=sc, out_dtype=out_dtype)
        b = expert_matmul(x, w, ids, scale=sc, out_dtype=out_dtype)
        assert torch.equal(a, b), out_dtype


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("shape", [(8, 4, 1000, 208), (5, 1, 1000, 208), (300, 2, 1000, 208),
                                   (70, 1, 1000, 208)], ids=str)
def test_expert_matmul_ragged_n_and_k(cuda, shape, int8):
    """N 208 (not a multiple of either tile's 64 or 128 columns: TMA reads
    zeros past it, the consumers mask the stores) and K 1000 (a ragged last
    64-row stage: zeros from TMA and from the staged x) on both tensor-core
    kernels."""
    T, E, K, N = shape
    if E == 1 and not int8:
        pytest.skip("a dense bf16 weight is torch.matmul's, never KE's")
    *_, plan, names = _ke_check(cuda, T, E, K, N, int8, seed=5)
    want = "expert_matmul_wgmma_kernel" if T > 16 * E else "expert_matmul_ring_kernel"
    assert plan["route"] == want and names == {want}, (plan, names)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("E", [1, 8])
def test_expert_matmul_grouped_wgmma_t512(cuda, E, int8):
    """T 512 grouped through wgmma: over 8 experts (the MoE prefill) and
    dense (the int8 prefill), within tolerance and bitwise repeatable."""
    from elastic_gpu_scheduler_tpu_torch.ops.expert_matmul import expert_matmul

    if E == 1 and not int8:
        pytest.skip("a dense bf16 weight is torch.matmul's, never KE's")
    x, w, sc, ids, plan, names = _ke_check(cuda, 512, E, 2048, 6912, int8, seed=6)
    assert plan["route"] == "expert_matmul_wgmma_kernel" and names == {plan["route"]}
    assert torch.equal(expert_matmul(x, w, ids, scale=sc), expert_matmul(x, w, ids, scale=sc))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 8, 6912, 2048, True), (512, 8, 2048, 512, False),
                                   (512, 8, 2048, 512, True)], ids=str)
def test_expert_matmul_graph_replay_new_routes(cuda, shape):
    """A graph captured on one routing replays three others equal to the
    eager call: the ring kernel with its K split in a cluster of 7 (the
    tensor map and the cluster captured by value) and the wgmma kernel."""
    from elastic_gpu_scheduler_tpu_torch.ops.expert_matmul import (
        expert_matmul,
        expert_matmul_plan,
    )

    T, E, K, N, int8 = shape
    x, w, sc = _ke_inputs(cuda, T, E, K, N, torch.bfloat16, int8, seed=7)
    ids = torch.zeros(T, dtype=torch.int32, device=cuda)
    plan = expert_matmul_plan(x, w, ids)
    assert plan["cluster"] == (7 if T == 8 else 1) and plan["tensor_cores"], plan
    expert_matmul(x, w, ids, scale=sc)  # first use outside the capture
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = expert_matmul(x, w, ids, scale=sc)
    rng = np.random.default_rng(8)
    for routing in ([3] * T, rng.integers(0, E, T).tolist(), [t % E for t in range(T)]):
        ids.copy_(torch.tensor(routing, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, expert_matmul(x, w, ids, scale=sc)), routing[:8]


def _small_moe_engine(device, dtype, int8, **kw):
    from elastic_gpu_scheduler_tpu_torch.models.quantize import quantize_params

    cfg = TransformerConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                            d_ff=256, dtype=dtype, n_experts=4)
    params = init_params(cfg, torch.Generator(device="cpu").manual_seed(0), "cpu")
    params["layers"]["moe_gate"] = params["layers"]["moe_gate"] * 8.0
    if int8:
        params = quantize_params(params)
    return cfg, serving.InferenceEngine(params, cfg, max_batch=4, max_len=96, page_size=16,
                                        fused_steps=4, paged_kernel=True, device=device, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True], ids=["moe", "moe + int8"])
def test_moe_engine_on_card_matches_cpu_float32(cuda, int8):
    """Float32 MoE (and MoE + int8) greedy tokens on the card, overlapped
    (each decode chunk a graph replay), equal the CPU's sequential run; KE
    launches 3 x L a decode step and a prefill (7 x L + 1 with int8
    weights); a second batch with other routing captures no graph."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n).tolist() for n in (3, 17, 40, 9)]
    outs = {}
    for where in ("cpu", cuda):
        cfg, eng = _small_moe_engine(where, "float32", int8, overlap=where != "cpu")
        _build.reset_launches()
        reqs = [eng.submit(serving.Request(prompt=p, max_new_tokens=20)) for p in prompts]
        eng.run_until_idle()
        assert all(r.done.is_set() and not r.error for r in reqs)
        outs[str(where)] = [r.output for r in reqs]
        if where != "cpu":
            # a pass: 3 expert products a layer; with int8 weights also
            # wq, wk, wv, wo and the unembed
            per_pass = 3 * cfg.n_layers + int8 * (4 * cfg.n_layers + 1)
            passes = eng.fused_steps * (eng.steps_run + eng.graph_warmups) + eng.prefills_run
            assert _build.LAUNCHES["expert_matmul"] == per_pass * passes
            captured = eng.graphs_captured
            more = [eng.submit(serving.Request(prompt=p[::-1], max_new_tokens=20))
                    for p in prompts]
            eng.run_until_idle()
            assert all(r.done.is_set() and not r.error for r in more)
            assert eng.graphs_captured == captured
    assert outs["cpu"] == outs[str(cuda)]


@pytest.mark.gpu
@pytest.mark.parametrize("kv_int8", [False, True], ids=["dense", "int8"])
def test_import_into_a_captured_pool_replays_the_imported_pages(cuda, kv_int8):
    """Pages imported into the pool of an overlapped engine whose decode
    chunk is already captured land in place (every pool tensor keeps its
    address): the next request adopts them, its chunks replay the graph
    captured before the import (no new capture) and its tokens equal the
    eager (sequential) engine's local warm hit and the CPU's."""
    from elastic_gpu_scheduler_tpu_torch.utils import kvwire

    rng = np.random.default_rng(9)
    prefix = rng.integers(0, 256, 33).tolist()  # two full pages of 16 adoptable
    prompt = prefix + rng.integers(0, 256, 5).tolist()
    warmup = rng.integers(0, 256, len(prompt)).tolist()  # the same table bucket
    outs = {}
    for where, overlap in (("cpu", False), (cuda, False), (cuda, True)):
        _, _, src = _small_engine(where, prefix_cache=True, overlap=False, kv_int8=kv_int8)
        for p in (prefix, prompt):
            r = src.submit(serving.Request(prompt=p, max_new_tokens=20))
            src.run_until_idle()
        warm_hit = r.output
        hdr, pages = kvwire.decode_bundle(src.export_prefix_pages(prefix))
        _, _, dst = _small_engine(where, prefix_cache=True, overlap=overlap, kv_int8=kv_int8)
        w = dst.submit(serving.Request(prompt=warmup, max_new_tokens=20))
        dst.run_until_idle()
        assert w.done.is_set() and not w.error
        captured, replays = dst.graphs_captured, dst.graph_replays
        ptrs = {k: t.data_ptr() for k, t in dst.kv.items()}
        assert dst.import_pages(hdr, pages)["imported"] == 2
        assert ptrs == {k: t.data_ptr() for k, t in dst.kv.items()}
        r = dst.submit(serving.Request(prompt=prompt, max_new_tokens=20))
        dst.run_until_idle()
        assert r.done.is_set() and not r.error
        assert dst.prefix_hit_tokens == 32 and r.output == warm_hit
        if overlap:
            assert captured >= 1 and dst.graphs_captured == captured
            assert dst.graph_replays > replays
        outs[(str(where), overlap)] = r.output
    assert len(set(map(tuple, outs.values()))) == 1


# (T, E, K, N, dtype, int8): the ring kernel (bf16 decode runs, with and
# without a K cluster), the wgmma kernel (grouped prefill runs) and CUDA
# cores split over K (float32, partials and the combine kernel)
KE_FOREIGN_CASES = [
    (8, 4, 2048, 6912, torch.bfloat16, False),
    (8, 4, 2048, 6912, torch.bfloat16, True),
    (5, 4, 2048, 2048, torch.bfloat16, True),
    (300, 4, 512, 384, torch.bfloat16, False),
    (300, 4, 512, 384, torch.bfloat16, True),
    (8, 4, 6912, 2048, torch.float32, False),
    (8, 4, 6912, 2048, torch.float32, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", KE_FOREIGN_CASES, ids=str)
def test_expert_matmul_foreign_ids_are_zero_rows(cuda, case):
    """A token routed outside [0, E) (another rank's expert on an expert
    mesh: local id = id - e0) gets a zero row from every route, as from the
    plain version, and every other row is the plain version's.  The output
    starts as NaNs, so a row the kernel left unwritten shows."""
    from elastic_gpu_scheduler_tpu_torch.ops.expert_matmul import (
        expert_matmul,
        expert_matmul_plan,
        expert_matmul_reference,
    )

    T, E, K, N, dtype, int8 = case
    x, w, sc = _ke_inputs(cuda, T, E, K, N, dtype, int8)
    # as a rank of expert=2 sees its half of 2E experts: ids in [-E, 2E)
    ids = torch.tensor(np.random.default_rng(T + K).integers(-E, 2 * E, T).tolist(),
                       dtype=torch.int32, device=cuda)
    foreign = (ids < 0) | (ids >= E)
    assert bool(foreign.any()) and not bool(foreign.all())
    plan = expert_matmul_plan(x, w, ids)
    for out_dtype in (dtype, torch.float32):
        # the caching allocator hands this block to the kernel's output next
        torch.full((T, N), float("nan"), dtype=out_dtype, device=cuda)
        got = expert_matmul(x, w, ids, scale=sc, out_dtype=out_dtype)
        want = expert_matmul_reference(x, w, ids, sc, out_dtype)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all()), plan
        assert bool((got[foreign] == 0).all()), plan
        atol, rtol = KE_TOL[dtype]
        d = (got.float() - want.float()).abs()
        assert bool((d <= atol + rtol * want.float().abs()).all()), (plan, float(d.max()))


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["bfloat16", "int8-bfloat16", "float32"])
@pytest.mark.parametrize("W", [1, 4])
def test_paged_kernel_on_a_head_slice_matches_plain(cuda, pool, W):
    """K2 as a tensor=2 serving rank calls it: its half of the pool's kv
    heads (a tensor of its own) and its half of the query heads, n_rep
    unchanged; equal to the plain version on the slice and to the whole
    pool's kernel output on those heads."""
    int8 = pool.startswith("int8")
    dtype = torch.float32 if pool.endswith("float32") else torch.bfloat16
    q, pools, tables, lengths = _paged_case(cuda, 8, 16, W, 40, dtype, int8, seed=W)
    kw = {}
    if int8:
        kw.update(scales_k=pools[2], scales_v=pools[3])
    whole = paged_attention(q, *pools[:2], tables, lengths, **kw)
    for half in (0, 1):
        hq = slice(8 * half, 8 * half + 8)
        hk = slice(4 * half, 4 * half + 4)
        ql = q[..., hq, :].contiguous()
        pl = [p[:, :, hk].contiguous() for p in pools]
        kwl = {} if not int8 else dict(scales_k=pl[2], scales_v=pl[3])
        name = "paged_attention_int8" if int8 else "paged_attention"
        before = _build.LAUNCHES[name]
        got = paged_attention(ql, *pl[:2], tables, lengths, **kwl)
        assert _build.LAUNCHES[name] == before + 1
        ref = paged_attention_reference(ql, *pl[:2], tables, lengths, **kwl)
        torch.cuda.synchronize()
        assert got.shape == ql.shape and _close(got, ref)
        assert _close(got, whole[..., hq, :])
