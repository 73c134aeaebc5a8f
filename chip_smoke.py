"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit) on any fault:

1. device and toolchain: the card's name and power limit (nvidia-smi),
   torch / CUDA / nvcc versions;
2. build: every ``csrc/*.cu`` of the port compiled with nvcc for sm_90a
   (ptxas registers and spills logged);
3. K1 (flash-attention forward) against ``mha_reference`` on the card:
   the serve-prefill shapes, the train shape and edge cases on its grid,
   each logging the kernel (and so the query tile) that ran, so that every
   kernel of ``flash_fwd.cu`` is held;
4. K2 (paged decode attention) against ``paged_attention_reference``,
   over dense pools and (its int8 half) over int8 pools with per-(token,
   kv-head) scales, plus inputs on which skipping the dequantised values'
   rounding through bf16 would fail the tolerance; K3 (blockwise attention with softmax statistics)
   against ``flash_block_stats_reference``, at the prefix-cached path's
   shapes plus edge cases (ragged lengths, offsets, rows that keep no
   key, not causal, GQA and MHA, Dh 64 and 128, fp32 and bf16), and its
   pv / l against ``mha_reference`` over the kept keys;
5. K4 (flash-attention backward) against ``flash_backward_reference``
   rounded where the kernel rounds: the training shape plus edge cases;
   faults planted in the training-shape result, which the tolerance must
   refuse; gradients through ``FlashAttention`` (K1 + K4) against
   autograd of ``mha_reference``;
6. the port's serving engine at the full width of the repo's largest LM
   config (~1.01B parameters, GQA 16q/8kv, bf16, random weights from a
   seed, 16 layers): 12 mixed-length greedy prompts, 64 new tokens each,
   with the paged kernel; launch counts must match the path exactly; the
   gather-path engine on the same weights must agree; a small float32
   model must give identical greedy tokens on the card and on the CPU;
6b. the prefix-cached, chunked, int8-KV engine at the same full width
   (``kv_int8``, ``prefix_cache``, ``prefill_chunk=128``, paged kernel,
   max_len 1024): a wave that primes the cache (a 256-token shared prefix
   with a 64-token tail) beside two unshared prompts of 700 and 900
   tokens, then a wave of 8 prompts on the shared prefix; launch counts
   must equal the passes (K1 = L x passes at t0 = 0, K3 = L x passes at
   t0 > 0, K2-int8 = L x fused_steps x chunks) and the prefix counters
   the traffic; a small float32 model with the same options must give
   identical greedy tokens on the card and the CPU, with the kernel and
   gather paths, and with and without the prefix cache; the bf16
   agreement with a cache-less engine and the device memory against
   ``estimate_hbm_bytes`` are reported;
7. HTTP: ``serve_inference`` on the card-resident engine, one blocking
   and one SSE completion against the engine's own tokens, /healthz and
   /v1/stats;
8. one fused decode chunk of the full-width engine under torch.profiler:
   device time by kernel and the device's idle share;
9. the training path at the same full width (``remat``, 8 vocab chunks,
   AdamW with a bf16 first moment and fp32 masters, B 8, S 1024 from the
   port's synthetic token stream): one warm-up step and 5 timed steps;
   the loss must be finite and fall, and K1 / K4 launches must equal
   2L and L per step; a small float32 model must train to the same
   losses and parameters on the card and on the CPU; ``launcher.run_job``
   with the reference's default ``JobSpec``; one train step under
   torch.profiler;
10. K1 and K4 called twice at the train shape must give identical bytes;
   a ``{"kernels": [...]}`` line with each kernel's launches on its main
   path, error against its plain version, time, plain time, library
   time and lower bound, its share of the bound (``of_bound``) and its
   factor over the library call (``vs_library``), then the card line and
   the final ``{"ok": ...}``.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import gc
import http.client
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# H100 SXM peaks (NVIDIA data sheet, dense): the lower bounds below
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# absolute, plus a relative term for bfloat16: the kernel and the plain
# version round P at different points, and an output past |2| then sits
# one bfloat16 step (2^-8 relative) either side
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
RTOL = {"bfloat16": 1e-2, "float32": 0.0}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_kernels(prof) -> list[dict]:
    """Device time by kernel from a torch.profiler run, longest first."""
    out = []
    for e in prof.key_averages():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            out.append({"kernel": e.key[:120], "count": e.count, "ms": us / 1e3})
    return sorted(out, key=lambda k: -k["ms"])


# Now and then torch.profiler hands back no device events for a window
# (one window in ~50 of one run on the card, cause not known); such a
# window runs again, up to this many times in all
PROFILE_TRIES = 3


def profiled(fn, what: str, cpu: bool = False) -> tuple[float, list[dict]]:
    """Run ``fn`` once under torch.profiler: (wall ms, device kernels).
    The run fails if no try of PROFILE_TRIES saw the device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = device_kernels(prof)
        if kernels:
            return wall_ms, kernels
        log(f"the profiler saw no device time in {what} (attempt {attempt} of {PROFILE_TRIES})")
    fail(f"the profiler saw no device time in {what} in {PROFILE_TRIES} attempts")


def device_ms(fn, reps: int, match: str = "") -> float:
    """Device time of one call (every kernel it launches whose name holds
    ``match``, summed; host launch overhead excluded), from torch.profiler
    over ``reps`` calls."""
    fn()

    def run():
        for _ in range(reps):
            fn()

    _, kernels = profiled(run, f"{reps} calls ({match or 'all kernels'})")
    total = sum(k["ms"] for k in kernels if match in k["kernel"])
    check(total > 0, f"no kernel named {match!r} ran")
    return total / reps


def maxerr(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item())


def close(out, ref, name: str) -> bool:
    """|out - ref| <= TOL + RTOL * |ref| everywhere, and out finite."""
    import torch

    d = (out.float() - ref.float()).abs()
    lim = TOL[name] + RTOL[name] * ref.float().abs()
    return bool((d <= lim).all()) and bool(torch.isfinite(out).all())


# -- phase 3: K1 -----------------------------------------------------------


def k1_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps: the work this input needs."""
    qpos = np.arange(sq)[:, None] + (sk - sq)
    kpos = np.arange(sk)[None, :]
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= qpos >= kpos
    if window > 0:
        keep &= (qpos - kpos) < window
    return int(keep.sum())


def k1_bound_ms(B, H, sq, sk, D, causal, window, itemsize) -> tuple[float, str]:
    flops = 4 * B * H * k1_pairs(sq, sk, causal, window) * D
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS
    byts = B * H * (2 * sq + 2 * sk) * D * itemsize + B * H * sq * 4
    t_ops, t_bytes = flops / peak * 1e3, byts / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# the kernels of csrc/flash_fwd.cu, by the name the profiler reports
K1_KERNELS = {
    "flash_fwd_wgmma_kernel": "bf16, wgmma + TMA, 128-row query tiles",
    "flash_fwd_bf16_kernel": "bf16, mma.sync, 64-row query tiles",
    "flash_fwd_fp32_kernel": "float32, FMA, 64-row query tiles",
}


def k1_kernel(kernels: list[dict]) -> str:
    """The one K1 kernel among a profiled call's device kernels."""
    names = {n for k in kernels for n in K1_KERNELS if n in k["kernel"]}
    check(len(names) == 1, f"one K1 kernel a call expected, the profiler saw {sorted(names)}")
    return names.pop()


def phase_k1(dev):
    """K1 against mha_reference: the serve-prefill shapes (1 x 16 heads),
    the train shape and edge cases on its grid, float32.  Each call runs
    under torch.profiler, which names the kernel that ran (and so the
    query tile it took); every kernel of flash_fwd.cu must be held here."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.ops.attention import flash_attention, mha_reference

    g = torch.Generator(device=dev).manual_seed(1)
    tb, th, ts, _, td = TRAIN_ATTN
    # (B, H, Sq, Sk, D, dtype, causal, window)
    cases = [(1, 16, s, s, 128, torch.bfloat16, True, 0) for s in (8, 64, 128, 256, 512)] + [
        (1, 16, 1000, 1000, 128, torch.bfloat16, True, 0),  # non-power-of-two
        (1, 16, 200, 640, 128, torch.bfloat16, True, 0),  # rectangular
        (1, 16, 512, 512, 128, torch.bfloat16, True, 128),  # sliding window
        (tb, th, ts, ts, td, torch.bfloat16, True, 0),  # the train shape
        (tb, th, 300, 640, td, torch.bfloat16, True, 0),  # its grid: ragged, rectangular
        (tb, th, 512, 512, td, torch.bfloat16, True, 100),  # a window ending mid-tile
        (2, 4, 96, 160, 64, torch.float32, True, 0),  # fp32, TF32 off
        (1, 2, 37, 37, 32, torch.float32, False, 0),  # fp32, not causal
    ]
    worst, ran = 0.0, set()
    for B, H, sq, sk, D, dt, causal, window in cases:
        q = torch.randn(B, H, sq, D, generator=g, device=dev).to(dt)
        k = torch.randn(B, H, sk, D, generator=g, device=dev).to(dt)
        v = torch.randn(B, H, sk, D, generator=g, device=dev).to(dt)
        res = []

        def call():
            res[:] = flash_attention(q, k, v, causal, None, window, return_lse=True)

        _, kernels = profiled(call, f"K1 at {(B, H, sq, sk, D)}")
        out, lse = res
        kern = k1_kernel(kernels)
        ran.add(kern)
        ref, ref_lse = mha_reference(q, k, v, causal, None, window)
        name = "bfloat16" if dt == torch.bfloat16 else "float32"
        e, el = maxerr(out, ref), maxerr(lse, ref_lse)
        ok = close(out, ref, name) and el <= 1e-4
        log(f"K1 B={B} H={H} Sq={sq} Sk={sk} D={D} {name} causal={causal} "
            f"window={window}: {kern} ({K1_KERNELS[kern]}) max|out-ref|={e:.3g} "
            f"(tol {TOL[name]} + {RTOL[name]}|ref|) max|lse-ref|={el:.3g} (tol 1e-4)")
        check(ok, f"K1 disagrees with mha_reference at {(B, H, sq, sk, D, name, window)}")
        if B == 1 and dt == torch.bfloat16 and window == 0 and sq == sk:
            worst = max(worst, e)
    check(ran == set(K1_KERNELS), f"K1 cases ran {sorted(ran)}, not every kernel of flash_fwd.cu")
    return worst


def check_repeatable(q, k, v, do) -> None:
    """K1 and K4 called twice on the same bf16 inputs give identical
    bytes (no atomics; every sum in a fixed order)."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.ops.attention import flash_attention, flash_backward

    runs = []
    for _ in range(2):
        out, lse = flash_attention(q, k, v, True, None, 0, return_lse=True)
        runs.append((out, lse) + flash_backward(q, k, v, out, lse, do, True, None, 0))
    torch.cuda.synchronize()
    same = {n: bool(torch.equal(a, b)) for n, a, b in zip(("out", "lse", "dq", "dk", "dv"), *runs)}
    log(f"K1 + K4 bitwise repeatable at {tuple(q.shape)} bf16: {same}")
    check(all(same.values()), "K1 / K4 differ between two calls on the same inputs")


# -- phase 4: K2 -----------------------------------------------------------


def phase_k2(dev):
    import torch

    from elastic_gpu_scheduler_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_reference,
    )

    g = torch.Generator(device=dev).manual_seed(2)
    B, Hn, Hkv, Dh, ps, NB = 8, 16, 8, 128, 16, 40
    n_pages = B * NB + 1
    worst = 0.0
    for dt in (torch.bfloat16, torch.float32):
        name = "bfloat16" if dt == torch.bfloat16 else "float32"
        pk = torch.randn(n_pages, ps, Hkv, Dh, generator=g, device=dev).to(dt)
        pv = torch.randn(n_pages, ps, Hkv, Dh, generator=g, device=dev).to(dt)
        tables = (torch.randperm(n_pages - 1, generator=g, device=dev)[: B * NB] + 1)
        tables = tables.reshape(B, NB).to(torch.int32)
        for W in (1, 4):
            # 0, page boundaries, mid-context, and the last slot
            lengths = torch.tensor(
                [0, 15, 16, 31, 32, 300, 511, NB * ps - W], dtype=torch.int32, device=dev
            )
            for window in (0, 256):
                q = torch.randn(B, W, Hn, Dh, generator=g, device=dev).to(dt)
                if W == 1:
                    q = q[:, 0]  # rank 3: plain decode
                out = paged_attention(q, pk, pv, tables, lengths, window=window)
                torch.cuda.synchronize()
                ref = paged_attention_reference(q, pk, pv, tables, lengths, window=window)
                e = maxerr(out, ref)
                log(f"K2 B={B} Hn={Hn} Hkv={Hkv} Dh={Dh} ps={ps} W={W} window={window} "
                    f"{name}: max|out-ref|={e:.3g} (tol {TOL[name]} + {RTOL[name]}|ref|)")
                check(close(out, ref, name),
                      f"K2 disagrees with paged_attention_reference ({name}, W={W}, "
                      f"window={window})")
                if dt == torch.bfloat16 and W == 1 and window == 0:
                    worst = max(worst, e)
    return worst


def int8_pool(g, n_pages, ps, Hkv, Dh, dev):
    """An int8 K or V pool with its scales, quantised from unit normals by
    the engine's own ``_quantize_rows``."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models.serving import _quantize_rows

    rows = torch.randn(n_pages * ps, Hkv, Dh, generator=g, device=dev).to(torch.bfloat16)
    q8, scale = _quantize_rows(rows)
    return q8.reshape(n_pages, ps, Hkv, Dh), scale.reshape(n_pages, ps, Hkv)


def phase_k2_int8(dev):
    """K2 over int8 pools at the prefix engine's shapes (B 8, 16q/8kv,
    Dh 128, page 16, 64 pages a row: max_len 1024)."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_reference,
    )

    g = torch.Generator(device=dev).manual_seed(8)
    B, Hn, Hkv, Dh, ps, NB = 8, 16, 8, 128, 16, 64
    n_pages = B * NB + 1
    pk, sk = int8_pool(g, n_pages, ps, Hkv, Dh, dev)
    pv, sv = int8_pool(g, n_pages, ps, Hkv, Dh, dev)
    tables = (torch.randperm(n_pages - 1, generator=g, device=dev)[: B * NB] + 1)
    tables = tables.reshape(B, NB).to(torch.int32)
    worst = 0.0
    for dt in (torch.bfloat16, torch.float32):
        name = "bfloat16" if dt == torch.bfloat16 else "float32"
        for W in (1, 4):
            lengths = torch.tensor([0, 15, 16, 300, 511, 700, 900, NB * ps - W],
                                   dtype=torch.int32, device=dev)
            q = torch.randn(B, W, Hn, Dh, generator=g, device=dev).to(dt)
            if W == 1:
                q = q[:, 0]
            out = paged_attention(q, pk, pv, tables, lengths, scales_k=sk, scales_v=sv)
            torch.cuda.synchronize()
            ref = paged_attention_reference(q, pk, pv, tables, lengths, scales_k=sk,
                                            scales_v=sv)
            e = maxerr(out, ref)
            log(f"K2-int8 B={B} Hn={Hn} Hkv={Hkv} Dh={Dh} ps={ps} W={W} {name}: "
                f"max|out-ref|={e:.3g} (tol {TOL[name]} + {RTOL[name]}|ref|)")
            check(close(out, ref, name), f"K2-int8 disagrees with its plain version "
                                         f"({name}, W={W})")
            if dt == torch.bfloat16 and W == 1:
                worst = max(worst, e)
    k2_int8_rounding_probe(dev)
    return worst


def k2_int8_rounding_probe(dev) -> None:
    """Inputs on which K2-int8's bf16 result shows whether it rounds the
    dequantised K/V through bf16 (random inputs cannot: the rounding moves
    their output ~1e-4).  Two keys a row, each (token, head) row constant.
    Row 0: k = 1.0035 and 1.0 (bf16: both 1.0) under q = 8, v = +1 and -1:
    rounded, the scores tie and out = 0; unrounded, out = 0.157.  Row 1:
    k = 0, v = 100.2 and -100 (bf16: +-100): rounded 0, unrounded 0.1.
    The kernel must match the plain version, which must in turn differ
    from the unrounded result by more than the tolerance."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_reference,
    )

    Hn, Hkv, Dh, ps = 16, 8, 128, 16
    pk = torch.zeros(3, ps, Hkv, Dh, dtype=torch.int8)  # page 0: scratch
    pv = torch.zeros_like(pk)
    sk = torch.ones(3, ps, Hkv)
    sv = torch.ones(3, ps, Hkv)
    pk[1, :2], pv[1:, 0], pv[1:, 1] = 127, 127, -127
    sk[1, 0], sk[1, 1], sv[1, :2] = 1.0035 / 127, 1 / 127, 1 / 127
    sv[2, 0], sv[2, 1] = 100.2 / 127, 100 / 127
    q = torch.full((2, Hn, Dh), 8.0, dtype=torch.bfloat16)
    args = [t.to(dev) for t in (q, pk, pv, torch.tensor([[1], [2]], dtype=torch.int32),
                                torch.ones(2, dtype=torch.int32))]
    kw = dict(scales_k=sk.to(dev), scales_v=sv.to(dev))
    out = paged_attention(*args, **kw)
    torch.cuda.synchronize()
    ref = paged_attention_reference(*args, **kw)
    unrounded = paged_attention_reference(args[0].float(), *args[1:], **kw)
    log(f"K2-int8 rounding probe bfloat16: max|out-ref|={maxerr(out, ref):.3g}, "
        f"max|unrounded-ref|={maxerr(unrounded, ref):.3g} (tol {TOL['bfloat16']} + "
        f"{RTOL['bfloat16']}|ref|)")
    check(close(out, ref, "bfloat16"), "K2-int8 disagrees with its plain version on the "
                                       "rounding probe")
    check(not close(unrounded, ref, "bfloat16") and not close(out, unrounded, "bfloat16"),
          "the rounding probe cannot tell a kernel that skips the bf16 rounding")


def k3_pairs(sq, sk, q_off, k_off, causal) -> int:
    """(query, key) pairs K3's output depends on: the kept pairs, plus every
    key of a row that keeps none (its pv is the sum of v)."""
    if not causal:
        return sq * sk
    kept = np.clip(q_off + np.arange(sq) - k_off + 1, 0, sk)
    return int(kept.sum() + sk * (kept == 0).sum())


def k3_keys(sq, sk, q_off, k_off, causal) -> tuple[int, int]:
    """(K rows, V rows) K3's output depends on: when causal, keys up to
    the last row's diagonal; every V row when some row keeps no key (its
    pv is the sum of v)."""
    if not causal:
        return sk, sk
    n_k = int(np.clip(q_off + sq - k_off, 0, sk))
    return n_k, (sk if q_off < k_off else n_k)


def k3_bound_ms(B, H, Hkv, sq, sk, D, q_off, k_off, causal, itemsize) -> tuple[float, str]:
    """q and the K/V rows the output depends on read once, pv (fp32) and
    m, l written once; 4 FLOPs a pair a head dimension (Q K^T and P V)."""
    flops = 4 * B * H * k3_pairs(sq, sk, q_off, k_off, causal) * D
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS
    n_k, n_v = k3_keys(sq, sk, q_off, k_off, causal)
    byts = B * (H * sq + Hkv * (n_k + n_v)) * D * itemsize + B * H * sq * (D + 2) * 4
    t_ops, t_bytes = flops / peak * 1e3, byts / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kept_keys_reference(q, k, v, q_off, k_off, causal):
    """mha_reference over the keys each row keeps, where row i keeps keys
    0..(q_off - k_off + i), or all keys when not causal; None when some
    row keeps no key or the diagonal runs past the keys."""
    from elastic_gpu_scheduler_tpu_torch.ops.attention import mha_reference

    n_rep = q.shape[1] // k.shape[1]
    ke, ve = (t.repeat_interleave(n_rep, dim=1) for t in (k, v))
    if not causal:
        return mha_reference(q, ke, ve, False)[0]
    diag = q_off - k_off
    if diag < 0 or diag + q.shape[2] > k.shape[2]:
        return None
    n = diag + q.shape[2]
    return mha_reference(q, ke[:, :, :n], ve[:, :, :n], True)[0]


def check_k3(q, k, v, q_off, k_off, causal, label) -> float:
    """K3 against its plain version (pv, m, l) and pv / l against
    mha_reference over the kept keys; returns max |pv/l - plain pv/l|."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.ops.attention import (
        NEG_INF,
        block_stats_tolerance_used,
        flash_block_stats,
        flash_block_stats_reference,
    )

    got = flash_block_stats(q, k, v, q_off, k_off, causal)
    torch.cuda.synchronize()
    want = flash_block_stats_reference(q, k, v, q_off, k_off, causal)
    shares = block_stats_tolerance_used(got, want, q.dtype)
    name = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    out = got[0] / got[2][..., None]
    ref = kept_keys_reference(q, k, v, q_off, k_off, causal)
    text = " ".join(f"{n} {u:.3g}" for n, u in shares.items())
    if ref is not None:
        d = (out - ref.float()).abs()
        use = float((d / (TOL[name] + RTOL[name] * ref.float().abs())).max())
        text += f"; pv/l vs mha_reference over the kept keys {use:.3g}"
        shares["out"] = use
    n_empty = int((got[1] == NEG_INF).sum())
    log(f"K3 {label} {name}: tolerance used {text}; rows keeping no key {n_empty}")
    check(max(shares.values()) <= 1.0, f"K3 disagrees with its plain version at {label} {name}")
    if causal and q_off < k_off:
        empty = slice(0, min(q.shape[2], k_off - q_off))
        check(bool((got[1][:, :, empty] == NEG_INF).all())
              and bool((got[2][:, :, empty] == k.shape[2]).all()),
              f"K3 rows that keep no key differ from the TPU kernel's at {label}")
    return maxerr(out, want[0] / want[2][..., None])


# the prefix engine's K3 geometry: (T, M, start) of its passes
K3_PATH = [(128, 256, 128), (64, 512, 256), (128, 1024, 768), (16, 512, 256),
           (256, 512, 256), (8, 1024, 896)]
# (B, H, Hkv, Sq, Sk, D, q_offset, k_offset, causal)
K3_EDGES = [
    (1, 16, 8, 200, 640, 128, 440, 0, True),  # Sq 200 / Sk 640, ragged
    (2, 4, 4, 96, 160, 64, 32, 0, True),  # MHA, Dh 64, q_offset > 0
    (1, 4, 2, 64, 128, 64, 0, 40, True),  # k_offset > 0: rows 0..39 keep no key
    (1, 2, 1, 64, 128, 128, 0, 200, True),  # no row keeps a key
    (1, 4, 2, 70, 90, 128, 7, 3, False),  # not causal
]


def phase_k3(dev):
    """K3 at the path's shapes (bf16, 16q/8kv, Dh 128) and the edge cases
    (fp32 and bf16); returns the worst bf16 error at the path's shapes."""
    import torch

    g = torch.Generator(device=dev).manual_seed(9)
    worst = 0.0
    cases = [((1, 16, 8, T, M, 128, start, 0, True), (torch.bfloat16,))
             for T, M, start in K3_PATH]
    cases += [(c, (torch.float32, torch.bfloat16)) for c in K3_EDGES]
    for (B, H, Hkv, sq, sk, D, q_off, k_off, causal), dts in cases:
        for dt in dts:
            q = torch.randn(B, H, sq, D, generator=g, device=dev).to(dt)
            k = torch.randn(B, Hkv, sk, D, generator=g, device=dev).to(dt)
            v = torch.randn(B, Hkv, sk, D, generator=g, device=dev).to(dt)
            label = (f"B={B} H={H} Hkv={Hkv} Sq={sq} Sk={sk} D={D} q_off={q_off} "
                     f"k_off={k_off} causal={causal}")
            e = check_k3(q, k, v, q_off, k_off, causal, label)
            if (B, H, Hkv, D) == (1, 16, 8, 128) and k_off == 0 and dt == torch.bfloat16:
                worst = max(worst, e)
    return worst


# -- phase 6: the engine ---------------------------------------------------


FULL = dict(vocab_size=32000, d_model=2048, n_layers=16, n_heads=16, n_kv_heads=8,
            d_ff=6912, dtype="bfloat16")
PROMPT_LENS = [64, 128, 256, 512, 64, 128, 256, 512, 96, 200, 400, 70]
NEW_TOKENS = 64
ENGINE = dict(max_batch=8, max_len=640, page_size=16, fused_steps=16)


def drive(eng, prompts, max_new):
    """run_until_idle with host timers: (requests, prefill s, step s)."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models.serving import Request

    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=max_new)) for p in prompts]
    t_admit = t_step = 0.0
    for _ in range(100_000):
        t0 = time.perf_counter()
        eng._admit()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        t_admit += t1 - t0
        if not any(s is not None for s in eng.slots):
            if eng.queue.empty():
                break
            continue
        eng.step()  # drains: the sampled tokens come to the host
        t_step += time.perf_counter() - t1
    for r in reqs:
        check(r.done.is_set() and not r.error, f"request failed: {r.error!r}")
        check(len(r.output) == max_new, f"request gave {len(r.output)} tokens, not {max_new}")
    return reqs, t_admit, t_step


class CallSampler:
    """Keeps the inputs of a few of the main path's calls of ``fn`` (every
    ``every``-th, up to ``keep``), so a kernel can be timed and checked on
    exactly what the path gave it.  ``clone`` copies what the path may
    overwrite later."""

    def __init__(self, clone, every: int, keep: int = 6):
        self.clone, self.every, self.keep, self.n, self.calls = clone, every, keep, 0, []

    def wrap(self, fn):
        def call(*args, **kw):
            self.n += 1
            if self.n % self.every == 1 and len(self.calls) < self.keep:
                self.calls.append(self.clone(*args, **kw))
            return fn(*args, **kw)
        return call


def k2_sampler(every: int, keep: int) -> CallSampler:
    """Samples ``serving._paged_attn_call``: the query, tables and lengths
    copied, the layer's pool views as they are (K2 is timed on them)."""
    return CallSampler(lambda q, lkv, tables, lengths, cfg, dtype: (
        q.clone(), lkv, tables.clone(), lengths.clone(), cfg), every=every, keep=keep)


def phase_engine(dev):
    import torch

    from elastic_gpu_scheduler_tpu_torch.models import serving
    from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine
    from elastic_gpu_scheduler_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
        param_count,
    )
    from elastic_gpu_scheduler_tpu_torch.ops import _build

    cfg = TransformerConfig(**FULL)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    log(f"engine: {param_count(params) / 1e9:.3f}B parameters, "
        f"{cfg.n_layers} layers, d={cfg.d_model}, {cfg.n_heads}q/{cfg.kv_heads}kv heads, "
        f"{cfg.dtype}")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]

    eng = InferenceEngine(params, cfg, paged_kernel=True, device=dev, **ENGINE)
    sampler = k2_sampler(every=211, keep=12)
    real_call = serving._paged_attn_call
    serving._paged_attn_call = sampler.wrap(real_call)
    torch.cuda.synchronize()
    # the main path: counts at 0 just before, read just after
    _build.reset_launches()
    t0 = time.perf_counter()
    try:
        reqs, t_admit, t_step = drive(eng, prompts, NEW_TOKENS)
    finally:
        serving._paged_attn_call = real_call
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    L = cfg.n_layers
    want_k1 = L * eng.prefills_run
    want_k2 = L * eng.fused_steps * eng.steps_run
    log(f"engine main path: {len(reqs)} requests, prefills={eng.prefills_run} "
        f"chunks={eng.steps_run} launches={launches} "
        f"(want flash_fwd={want_k1}, paged_attention={want_k2})")
    check(eng.prefills_run == len(prompts), "every prompt should take the one-pass prefill")
    check(launches["flash_fwd"] == want_k1 > 0, "K1 launches != layers x prefills")
    check(launches["paged_attention"] == want_k2 > 0, "K2 launches != layers x decode steps")
    check(launches["paged_attention_int8"] == launches["flash_block_stats"] == 0,
          "the dense engine launched the int8 K2 or K3")
    gen_tokens = sum(len(r.output) for r in reqs)
    decode_iters = eng.steps_run * eng.fused_steps
    perf = {
        "wall_s": wall, "generated_tokens": gen_tokens,
        "tokens_per_s": gen_tokens / wall,
        "prefill_s": t_admit, "decode_s": t_step,
        "ms_per_fused_step": t_step / eng.steps_run * 1e3,
        "ms_per_decode_iteration": t_step / decode_iters * 1e3,
        "prefill_ms_per_request": t_admit / eng.prefills_run * 1e3,
    }
    log("engine perf: " + json.dumps(perf))

    # the gather path on the same weights
    geng = InferenceEngine(params, cfg, paged_kernel=False, device=dev, **ENGINE)
    greqs, _, _ = drive(geng, prompts, NEW_TOKENS)
    firsts = [r.output[0] for r in reqs]
    check(firsts == [r.output[0] for r in greqs], "kernel and gather engines differ in first tokens")
    agree = sum(a == b for r, s in zip(reqs, greqs) for a, b in zip(r.output, s.output))
    log(f"kernel vs gather engine: first tokens identical; {agree}/{gen_tokens} tokens "
        "identical overall (bf16: later tokens may part where rounding differs)")
    # prefill and first decode-step logits, both paths, on one prompt
    p = prompts[9]
    eng_logits = {}
    for pk_ in (True, False):
        e = InferenceEngine(params, cfg, paged_kernel=pk_, device=dev, **ENGINE)
        e.prompts[0, : len(p)] = p  # slot 0, prefilled by hand
        check(e._ensure_pages(0, len(p) + 1), "pages for the logits check")
        pre = e._prefill_dispatch(0, 0, len(p))
        tables = torch.tensor(e.tables[:, :32], device=dev)
        tables[1:] = 0
        lengths = torch.zeros(8, dtype=torch.int32, device=dev)
        lengths[0] = len(p)
        toks = torch.zeros(8, dtype=torch.int32, device=dev)
        toks[0] = int(torch.argmax(pre))
        dec, _ = serving._paged_decode_step(params, toks, e.kv, tables, lengths, cfg,
                                            e.page_size, paged_kernel=pk_)
        eng_logits[pk_] = (pre, dec[0])
        del e
    e_pre = maxerr(eng_logits[True][0], eng_logits[False][0])
    e_dec = maxerr(eng_logits[True][1], eng_logits[False][1])
    log(f"kernel vs gather: prefill logits max diff {e_pre:.3g} (tol 2e-2), first "
        f"decode-step logits max diff {e_dec:.3g} (tol 0.25: 16 bf16 layers)")
    check(e_pre <= 2e-2, "prefill logits differ between the engines")
    check(e_dec <= 0.25, "decode logits: kernel path far from gather path")
    del geng, greqs

    # small float32 model: the card's greedy tokens equal the CPU's
    small = TransformerConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=4,
                              n_kv_heads=2, d_ff=512, dtype="float32")
    sp = init_params(small, torch.Generator().manual_seed(3), "cpu")
    srng = np.random.default_rng(5)
    sprompts = [srng.integers(0, 512, n).tolist() for n in (1, 5, 17, 40, 9, 64)]
    outs = {}
    for where in ("cpu", dev):
        se = InferenceEngine(sp, small, max_batch=4, max_len=128, page_size=16,
                             fused_steps=8, paged_kernel=True, device=where)
        rs = [se.submit(serving.Request(prompt=q, max_new_tokens=24)) for q in sprompts]
        se.run_until_idle()
        for r in rs:
            check(r.done.is_set() and not r.error, f"small engine request failed: {r.error}")
        outs[str(where)] = [r.output for r in rs]
    check(outs["cpu"] == outs[str(dev)], "float32 greedy tokens differ between card and CPU")
    log(f"small float32 engine: greedy tokens identical on card and CPU "
        f"({sum(map(len, outs['cpu']))} tokens)")
    return eng, prompts, reqs, launches, sampler, perf


# -- phase 6b: the prefix-cached, chunked, int8-KV engine --------------------


PREFIX_ENGINE = dict(kv_int8=True, prefix_cache=True, prefill_chunk=128, paged_kernel=True,
                     max_batch=8, max_len=1024, page_size=16, fused_steps=16)
SHARED_PREFIX = 256
WAVE1_LENS = (64, 700, 900)  # the primer's tail, then two unshared prompts
WAVE2_TAILS = (16, 48, 80, 112, 129, 176, 208, 256)


def prefix_traffic(rng, vocab, shared_len, wave1_lens, wave2_tails):
    shared = rng.integers(0, vocab, shared_len).tolist()
    wave1 = [shared + rng.integers(0, vocab, wave1_lens[0]).tolist()]
    wave1 += [rng.integers(0, vocab, n).tolist() for n in wave1_lens[1:]]
    wave2 = [shared + rng.integers(0, vocab, n).tolist() for n in wave2_tails]
    return wave1, wave2


def common_prefix(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def phase_prefix_engine(dev, params, cfg):
    """The prefix-cached, chunked, int8-KV engine on the full-width model:
    exact launch counts, prefix counters, memory, bf16 agreement with a
    cache-less engine, and the small float32 model's identities."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models import generate, serving
    from elastic_gpu_scheduler_tpu_torch.models.serving import (
        InferenceEngine,
        estimate_hbm_bytes,
    )
    from elastic_gpu_scheduler_tpu_torch.ops import _build

    rng = np.random.default_rng(12)
    wave1, wave2 = prefix_traffic(rng, cfg.vocab_size, SHARED_PREFIX, WAVE1_LENS, WAVE2_TAILS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = InferenceEngine(params, cfg, device=dev, **PREFIX_ENGINE)
    passes = {"plain": 0, "prefixed": 0}

    def counted(fn, kind):
        def call(*args, **kw):
            passes[kind] += 1
            return fn(*args, **kw)
        return call

    # spread the samples over both waves (~400 K3 and ~3300 K2 calls)
    k3_sampler = CallSampler(lambda q, k, v, q_off, k_off, causal=True: (
        q.contiguous().clone(), k.contiguous().clone(), v.contiguous().clone(),
        int(q_off), int(k_off), causal), every=67)
    k2i_sampler = k2_sampler(every=499, keep=6)
    real = (serving._paged_prefill, serving._paged_prefill_prefixed,
            generate.flash_block_stats, serving._paged_attn_call)
    serving._paged_prefill = counted(real[0], "plain")
    serving._paged_prefill_prefixed = counted(real[1], "prefixed")
    generate.flash_block_stats = k3_sampler.wrap(real[2])
    serving._paged_attn_call = k2i_sampler.wrap(real[3])
    torch.cuda.synchronize()
    # the main path: counts at 0 just before, read just after
    _build.reset_launches()
    t0 = time.perf_counter()
    try:
        reqs1, ta1, ts1 = drive(eng, wave1, NEW_TOKENS)
        t1 = time.perf_counter()
        reqs2, ta2, ts2 = drive(eng, wave2, NEW_TOKENS)
    finally:
        (serving._paged_prefill, serving._paged_prefill_prefixed,
         generate.flash_block_stats, serving._paged_attn_call) = real
    t2 = time.perf_counter()
    launches = dict(_build.LAUNCHES)
    L = cfg.n_layers
    want = dict.fromkeys(launches, 0)
    want.update(flash_fwd=L * passes["plain"], flash_block_stats=L * passes["prefixed"],
                paged_attention_int8=L * eng.fused_steps * eng.steps_run)
    log(f"prefix engine main path: passes {passes} (t0 = 0 / t0 > 0), chunks "
        f"{eng.steps_run}, launches {launches} (want {want})")
    check(launches == want and min(want["flash_fwd"], want["flash_block_stats"],
                                   want["paged_attention_int8"]) > 0,
          "prefix engine launches differ from L x passes / L x fused_steps x chunks")
    counters = {"prefix_lookups": eng.prefix_lookups,
                "prefix_admission_hits": eng.prefix_admission_hits,
                "prefix_hit_tokens": eng.prefix_hit_tokens}
    want_c = {"prefix_lookups": len(wave1) + len(wave2),
              "prefix_admission_hits": len(wave2),
              "prefix_hit_tokens": len(wave2) * SHARED_PREFIX}
    log(f"prefix counters {counters} (want {want_c})")
    check(counters == want_c, "prefix counters differ from the traffic")
    unref = sum(1 for pg in eng.page_key if eng.page_ref[pg] == 0)
    check(not eng.page_ref.any() and len(eng.free_pages) + unref == eng.n_pages - 1,
          "pages not conserved after the prefix engine drained")
    pool_bytes = sum(t.numel() * t.element_size() for t in eng.kv.values())
    est = estimate_hbm_bytes(cfg, eng.max_batch, eng.max_len, eng.page_size, kv_int8=True)
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    mem = {"max_memory_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "kv_pool_bytes": pool_bytes, "estimate_kv_pool_bytes": est["kv_pool_bytes"],
           "param_bytes": param_bytes, "estimate_target_param_bytes": est["target_param_bytes"],
           "estimate_total": est["total"]}
    log("prefix engine memory: " + json.dumps(mem))
    check(pool_bytes == est["kv_pool_bytes"], "int8 KV pool bytes differ from estimate_hbm_bytes")
    gen1 = sum(len(r.output) for r in reqs1)
    gen2 = sum(len(r.output) for r in reqs2)
    perf = {"wall_s": t2 - t0, "generated_tokens": gen1 + gen2,
            "tokens_per_s": (gen1 + gen2) / (t2 - t0),
            "wave1": {"wall_s": t1 - t0, "admit_s": ta1, "step_s": ts1,
                      "tokens_per_s": gen1 / (t1 - t0)},
            "wave2": {"wall_s": t2 - t1, "admit_s": ta2, "step_s": ts2,
                      "tokens_per_s": gen2 / (t2 - t1),
                      "prefill_ms_per_request": ta2 / len(wave2) * 1e3},
            "passes": passes, "chunks": eng.steps_run, "memory": mem}
    log("prefix engine perf: " + json.dumps(perf))

    # bf16 at full width: against an int8 engine without the prefix cache
    # on the wave-2 prompts (reported, not gated)
    ref_eng = InferenceEngine(params, cfg, device=dev, **dict(PREFIX_ENGINE, prefix_cache=False))
    rreqs, _, _ = drive(ref_eng, wave2, NEW_TOKENS)
    firsts = sum(a.output[0] == b.output[0] for a, b in zip(reqs2, rreqs))
    prefixes = [common_prefix(a.output, b.output) for a, b in zip(reqs2, rreqs)]
    log(f"bf16 prefix cache vs none on wave 2: first tokens equal {firsts}/{len(wave2)}, "
        f"common prefix lengths {prefixes} of {NEW_TOKENS}")
    perf["bf16_vs_no_cache"] = {"first_tokens_equal": firsts, "common_prefix": prefixes}
    del ref_eng, rreqs
    perf["profile_idle_share"] = phase_prefix_profile(eng, wave1[0][:SHARED_PREFIX])["idle_share"]
    phase_prefix_small_fp32(dev)
    return eng, launches, k3_sampler, k2i_sampler, perf


def phase_prefix_profile(eng, shared) -> dict:
    """One step of the prefix engine under torch.profiler, with 8 slots on
    the shared prefix: each slot's continuing prefill chunk (K3) and then
    one fused decode chunk (K2-int8).  Device time by kernel class and the
    device's idle share."""
    from elastic_gpu_scheduler_tpu_torch.models.serving import Request

    rng = np.random.default_rng(14)
    # tails of prefill_chunk + 72..121: admission runs one chunk, the step
    # the last pass
    tails = [eng.prefill_chunk + 72 + 7 * i for i in range(eng.max_batch)]
    reqs = [eng.submit(Request(prompt=shared + rng.integers(0, eng.cfg.vocab_size, n).tolist(),
                               max_new_tokens=4 * eng.fused_steps))
            for n in tails]
    eng._admit()  # the first passes, outside the window
    wall_ms, kernels = profiled(eng.step, "a prefix engine step", cpu=True)
    eng.run_until_idle()
    check(all(r.done.is_set() and not r.error for r in reqs), "profiled prefix requests failed")
    busy = sum(k["ms"] for k in kernels)

    def share(sub):
        return sum(k["ms"] for k in kernels if sub in k["kernel"]) / busy

    res = {"window": "one prefix engine step (8 slots' last prefill passes, 72-121 rows "
                     "behind 384 cached or chunked positions, then a fused decode chunk)",
           "wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
           "launches": sum(k["count"] for k in kernels),
           "k3_share": share("flash_stats"), "k2_share": share("paged_attn"),
           "top": kernels[:25]}
    log(json.dumps({"prefix_profile": res}))
    log(f"prefix profile: step wall {wall_ms:.2f} ms, device busy {busy:.2f} ms (idle share "
        f"{res['idle_share']:.3f}), K3 {res['k3_share']:.3f} and K2-int8 "
        f"{res['k2_share']:.3f} of device time, {res['launches']} kernel launches")
    for k in kernels[:12]:
        log(f"  {k['ms']:9.3f} ms  x{k['count']:5d}  {k['kernel']}")
    return res


def phase_prefix_small_fp32(dev) -> None:
    """A small float32 model with int8 KV, the prefix cache and chunked
    prefill: greedy tokens identical on the card and the CPU, with the
    paged kernel and the gather path, and with and without the cache."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine, Request
    from elastic_gpu_scheduler_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )

    small = TransformerConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=4,
                              n_kv_heads=2, d_ff=512, dtype="float32")
    sp = init_params(small, torch.Generator().manual_seed(3), "cpu")
    wave1, wave2 = prefix_traffic(np.random.default_rng(13), 512, 64, (16, 100, 150),
                                  (5, 20, 40, 70))
    kw = dict(kv_int8=True, prefill_chunk=32, max_batch=4, max_len=256, page_size=16,
              fused_steps=8)
    outs = {}
    for where, paged, cache in (("cpu", True, True), (dev, True, True),
                                (dev, False, True), (dev, True, False)):
        se = InferenceEngine(sp, small, paged_kernel=paged, prefix_cache=cache,
                             device=where, **kw)
        got = []
        for wave in (wave1, wave2):
            rs = [se.submit(Request(prompt=p, max_new_tokens=12)) for p in wave]
            se.run_until_idle()
            check(all(r.done.is_set() and not r.error for r in rs),
                  "small prefix engine request failed")
            got.append([r.output for r in rs])
        if cache:
            check(se.prefix_admission_hits == len(wave2), "small engine missed the cache")
        outs[(str(where), paged, cache)] = got
    card = str(dev)
    check(outs[("cpu", True, True)] == outs[(card, True, True)],
          "float32 prefix engine: greedy tokens differ between card and CPU")
    check(outs[(card, True, True)] == outs[(card, False, True)],
          "float32 prefix engine: kernel and gather paths differ")
    check(outs[(card, True, True)][1] == outs[(card, True, False)][1],
          "float32 prefix engine: wave-2 tokens differ with and without the cache")
    log(f"small float32 prefix engine: greedy tokens identical card vs CPU, kernel vs "
        f"gather, cache vs none ({sum(map(len, outs[(card, True, True)][1]))} wave-2 tokens)")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# -- phase 7: HTTP ---------------------------------------------------------


def phase_http(eng, prompt):
    from elastic_gpu_scheduler_tpu_torch.models.serving import Request
    from elastic_gpu_scheduler_tpu_torch.server.inference import serve_inference

    server, loop = serve_inference(eng, port=0, host="127.0.0.1")
    addr = server.server_address
    try:
        def post(body):
            conn = http.client.HTTPConnection(*addr, timeout=300)
            conn.request("POST", "/v1/completions", json.dumps(body),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            conn.close()
            return resp.status, resp.getheader("Content-Type"), data

        code, _, data = post({"prompt": prompt, "max_tokens": 16})
        check(code == 200, f"blocking completion answered {code}")
        blocking = json.loads(data)["tokens"]
        code, ctype, data = post({"prompt": prompt, "max_tokens": 16, "stream": True})
        check(code == 200 and ctype == "text/event-stream", f"SSE answered {code} {ctype}")
        events = [e[len("data: "):] for e in data.decode().split("\n\n")
                  if e.startswith("data: ")]
        check(events and events[-1] == "[DONE]", "SSE stream did not end with [DONE]")
        streamed = [json.loads(e)["token"] for e in events[:-1]]
        direct = eng.submit(Request(prompt=list(prompt), max_new_tokens=16))
        check(direct.done.wait(300) and not direct.error, "direct request failed")
        check(blocking == direct.output and streamed == direct.output,
              "HTTP tokens differ from the engine's own")
        for path in ("/healthz", "/v1/stats"):
            conn = http.client.HTTPConnection(*addr, timeout=30)
            conn.request("GET", path)
            resp = conn.getresponse()
            body = json.loads(resp.read())
            conn.close()
            check(resp.status == 200, f"GET {path} answered {resp.status}")
        check(body["paged_kernel"] and body["device"].startswith("cuda"), "stats off")
        log(f"HTTP: blocking and SSE completions equal the engine's 16 tokens; "
            f"/healthz and /v1/stats answer ({body['steps_run']} chunks so far)")
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()


# -- phases 8 and 10: profile and the kernels line -------------------------


def kernel_k1(eng, prompts, launches, worst):
    """K1 at the main path's prefill shapes: one (1, 16, Tpad, 128) bf16
    call per layer per prompt, Tpad the prompt padded to a power of two."""
    import torch
    import torch.nn.functional as F

    from elastic_gpu_scheduler_tpu_torch.ops.attention import flash_attention, mha_reference

    dev = eng.device
    cfg = eng.cfg
    g = torch.Generator(device=dev).manual_seed(4)
    rows, err = [], worst
    tpads = []
    for p in prompts:
        t = 8
        while t < len(p):
            t *= 2
        tpads.append(min(t, eng.max_len))
    for t in sorted(set(tpads)):
        q, k, v = (torch.randn(1, cfg.n_heads, t, cfg.head_dim, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        out = flash_attention(q, k, v, True, None, 0)
        ref = mha_reference(q, k, v, True, None, 0)[0]
        err = max(err, maxerr(out, ref))
        ms = device_ms(lambda: flash_attention(q, k, v, True, None, 0), 100)
        plain = device_ms(lambda: mha_reference(q, k, v, True, None, 0), 20)
        lib = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 100)
        bound, by = k1_bound_ms(1, cfg.n_heads, t, t, cfg.head_dim, True, 0, 2)
        n = tpads.count(t)
        rows.append((n, ms, plain, lib, bound, by))
        log(f"K1 timing Tpad={t} (x{n} prompts): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"sdpa {lib:.4f} ms, bound {bound:.5f} ms ({by})")
    tot = sum(r[0] for r in rows)
    mean = [sum(r[0] * r[i] for r in rows) / tot for i in (1, 2, 3, 4)]
    return {
        "name": "flash_fwd", "route": "cuda",
        "source": "elastic_gpu_scheduler_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "elastic_gpu_scheduler_tpu/ops/attention.py:290",
        "launches": launches["flash_fwd"], "max_abs_err": err,
        "ms": mean[0], "plain_ms": mean[1], "bound_ms": mean[3],
        "bound_by": max(rows, key=lambda r: r[0] * r[4])[5],
        "library_ms": mean[2],
    }


def kernel_k2(sampler, launches, worst, name="paged_attention"):
    """K2 on inputs the main path gave it (sampled calls); ``name`` is
    ``paged_attention_int8`` for the int8-pool variant."""
    from elastic_gpu_scheduler_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_reference,
    )

    check(sampler.calls, f"no {name} call was sampled on the main path")
    ms_l, plain_l, bound_l, err = [], [], [], worst
    for q, lkv, tables, lengths, cfg in sampler.calls:
        pk, pv = lkv["k"], lkv["v"]
        kw = dict(window=cfg.window_size, scales_k=lkv.get("ks"), scales_v=lkv.get("vs"))
        check((kw["scales_k"] is not None) == (name == "paged_attention_int8"),
              f"{name}: the sampled pool is not of its kind")

        def kern():
            return paged_attention(q, pk, pv, tables, lengths, **kw)

        def plain():
            return paged_attention_reference(q, pk, pv, tables, lengths, **kw)

        err = max(err, maxerr(kern(), plain()))
        ms_l.append(device_ms(kern, 50))
        plain_l.append(device_ms(plain, 10))
        # bytes this call must move: q, out, tables, lengths, and each
        # distinct live (page, kv-head) K and V tile once
        B, Hn, Dh = q.shape
        ps, Hkv = pk.shape[1], pk.shape[2]
        NB = tables.shape[1]
        ln = lengths.cpu().numpy()
        tb = tables.cpu().numpy()
        live = set()
        for b in range(B):
            for j in range(min(NB, int(ln[b]) // ps + 1)):
                live.add(int(tb[b, j]))
        # an int8 page also carries its fp32 scales, one a (token, kv-head)
        page_bytes = ps * Hkv * (Dh * pk.element_size() + (4 if kw["scales_k"] is not None
                                                            else 0))
        byts = (len(live) * page_bytes * 2 + 2 * q.numel() * q.element_size()
                + tables.numel() * 4 + lengths.numel() * 4)
        bound_l.append(byts / PEAK_BYTES * 1e3)
    log(f"{name} timing over {len(ms_l)} main-path calls: kernel {np.mean(ms_l):.4f} ms, "
        f"plain {np.mean(plain_l):.4f} ms, bound {np.mean(bound_l):.5f} ms (bytes)")
    return {
        "name": name, "route": "cuda",
        "source": "elastic_gpu_scheduler_tpu_torch/csrc/paged_attention.cu",
        "replaces": "elastic_gpu_scheduler_tpu/ops/paged_attention.py:204",
        "launches": launches[name], "max_abs_err": err,
        "ms": float(np.mean(ms_l)), "plain_ms": float(np.mean(plain_l)),
        "bound_ms": float(np.mean(bound_l)), "bound_by": "bytes", "library_ms": None,
    }


def kernel_k3(sampler, launches, worst):
    """K3 on inputs the prefix engine's main path gave it (sampled calls):
    kernel, plain and SDPA (with ``enable_gqa`` and the same causal
    offsets as a mask: the same attention, returned normalised)."""
    import torch
    import torch.nn.functional as F

    from elastic_gpu_scheduler_tpu_torch.ops.attention import (
        flash_block_stats,
        flash_block_stats_reference,
    )

    check(sampler.calls, "no K3 call was sampled on the main path")
    rows, err = [], worst
    for q, k, v, q_off, k_off, causal in sampler.calls:
        B, H, sq, D = q.shape
        Hkv, sk = k.shape[1], k.shape[2]
        err = max(err, check_k3(q, k, v, q_off, k_off, causal,
                                f"main-path call T={sq} M={sk} start={q_off}"))
        qpos = q_off + torch.arange(sq, device=q.device)
        kpos = k_off + torch.arange(sk, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        ms = device_ms(lambda: flash_block_stats(q, k, v, q_off, k_off, causal), 50,
                       match="flash_stats_kernel")
        plain = device_ms(lambda: flash_block_stats_reference(q, k, v, q_off, k_off, causal), 10)
        lib = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                               enable_gqa=True), 50)
        bound, by = k3_bound_ms(B, H, Hkv, sq, sk, D, q_off, k_off, causal, q.element_size())
        rows.append((ms, plain, lib, bound, by))
        log(f"K3 timing T={sq} M={sk} start={q_off}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"sdpa {lib:.4f} ms, bound {bound:.5f} ms ({by})")
    mean = [float(np.mean([r[i] for r in rows])) for i in range(4)]
    return {
        "name": "flash_block_stats", "route": "cuda",
        "source": "elastic_gpu_scheduler_tpu_torch/csrc/flash_stats.cu",
        "replaces": "elastic_gpu_scheduler_tpu/ops/attention.py:902",
        "launches": launches["flash_block_stats"], "max_abs_err": err,
        "ms": mean[0], "plain_ms": mean[1], "bound_ms": mean[3],
        "bound_by": max(set(r[4] for r in rows), key=[r[4] for r in rows].count),
        "library_ms": mean[2],
        "note": "max_abs_err is on pv / l; library_ms is SDPA (enable_gqa, the same "
                "causal offsets as a mask), which returns normalised output",
    }


def phase_profile(eng, prompts) -> None:
    """One fused decode chunk of a full batch under torch.profiler: device
    time by kernel, and the device's busy share of the chunk's wall time
    (one stream, so busy = the sum of kernel times)."""
    from elastic_gpu_scheduler_tpu_torch.models.serving import Request

    # enough tokens that every slot stays live through a window run again
    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=5 * eng.fused_steps))
            for p in prompts[: eng.max_batch]]
    eng._admit()  # the prefills, outside the window
    eng.step()  # warm
    wall_ms, kernels = profiled(eng.step, "a fused decode chunk", cpu=True)
    eng.run_until_idle()
    check(all(r.done.is_set() and not r.error for r in reqs), "profiled requests failed")
    busy = sum(k["ms"] for k in kernels)
    res = {"window": f"one fused chunk ({eng.fused_steps} decode iterations, "
                     f"batch {eng.max_batch})",
           "wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
           "launches": sum(k["count"] for k in kernels), "top": kernels[:25]}
    log(json.dumps({"profile": res}))
    log(f"profile: chunk wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
        f"(idle share {1 - busy / wall_ms:.3f}), {res['launches']} kernel launches")
    for k in kernels[:12]:
        log(f"  {k['ms']:9.3f} ms  x{k['count']:5d}  {k['kernel']}")


# -- phase 5: K4 -----------------------------------------------------------


def tol_use(got, ref, rounded=True) -> tuple[float, str]:
    """The largest share of its K4 tolerance (``grad_limit``) any element
    of ``got`` takes (<= 1 passes), and a line with the readings behind it."""
    from elastic_gpu_scheduler_tpu_torch.ops.attention import grad_limit

    r = ref.float()
    d = (got.float() - r).abs()
    use = float((d / grad_limit(ref, got.dtype, rounded)).max())
    text = (f"max|d|={float(d.max()):.3g} median|ref|={float(r.abs().median()):.3g} "
            f"rms(ref)={float(r.pow(2).mean().sqrt()):.3g} max|ref|={float(r.abs().max()):.3g} "
            f"tolerance used {use:.3g}")
    return use, text


TRAIN_ATTN = (8, 16, 1024, 1024, 128)  # B, H (after repeat_kv), Sq, Sk, Dh


def planted_faults(q, k, v, out, lse, do, got, want) -> dict:
    """K4's bf16 check must refuse a wrong kernel: faults planted in the
    kernel's train-shape result (or its inputs) must each exceed the
    tolerance.  Returns each fault's share of the tolerance."""
    from elastic_gpu_scheduler_tpu_torch.ops.attention import flash_backward, grad_close

    dq, dk, dv = got
    no_delta = flash_backward(q, k, v, out.new_zeros(out.shape), lse, do, True, None, 0)
    faults = {
        "dv, last 128 keys zeroed": (_scaled_tail(dv, 128, 0.0), want[2]),
        "dk, last 64 keys zeroed": (_scaled_tail(dk, 64, 0.0), want[1]),
        "dq, rows 512 on x0.97": (_scaled_tail(dq, 512, 0.97), want[0]),
        "dq, delta dropped": (no_delta[0], want[0]),
        "dk, delta dropped": (no_delta[1], want[1]),
    }
    res = {}
    for name, (bad, ref) in faults.items():
        use, text = tol_use(bad, ref)
        log(f"K4 planted fault ({name}): {text}")
        check(not grad_close(bad, ref), f"K4's tolerance lets a planted fault through: {name}")
        res[name] = use
    return res


def _scaled_tail(t, n, factor):
    """A copy of (B, H, S, D) ``t`` with its last ``n`` rows times ``factor``."""
    bad = t.clone()
    bad[:, :, -n:] = (bad[:, :, -n:].float() * factor).to(t.dtype)
    return bad


def phase_k4(dev):
    """Returns the worst |kernel - plain| of dq and of dk/dv at the train
    shape (bf16), and the planted faults' shares of the tolerance."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.ops.attention import (
        flash_attention,
        flash_backward,
        flash_backward_reference,
        grad_close,
        mha_reference,
    )

    g = torch.Generator(device=dev).manual_seed(6)
    B, H, S, _, D = TRAIN_ATTN
    # (B, H, Sq, Sk, D, dtype, causal, window)
    cases = [
        (B, H, S, S, D, torch.bfloat16, True, 0),  # the train path's shape
        (1, 16, 1000, 1000, 128, torch.bfloat16, True, 0),  # non-power-of-two
        (1, 16, 200, 640, 128, torch.bfloat16, True, 0),  # rectangular
        (1, 16, 512, 512, 128, torch.bfloat16, True, 128),  # sliding window
        (2, 8, 384, 384, 64, torch.bfloat16, True, 0),  # head_dim 64
        (2, 4, 96, 160, 64, torch.float32, True, 0),  # fp32, TF32 off
    ]
    worst, uses = {"dq": 0.0, "dkv": 0.0}, {}
    for B_, H_, sq, sk, D_, dt, causal, window in cases:
        q = torch.randn(B_, H_, sq, D_, generator=g, device=dev).to(dt)
        k = torch.randn(B_, H_, sk, D_, generator=g, device=dev).to(dt)
        v = torch.randn(B_, H_, sk, D_, generator=g, device=dev).to(dt)
        do = torch.randn(B_, H_, sq, D_, generator=g, device=dev).to(dt)
        out, lse = mha_reference(q, k, v, causal, None, window)
        got = flash_backward(q, k, v, out, lse, do, causal, None, window)
        torch.cuda.synchronize()
        # rounded where the kernel rounds (P and dS to bf16), so the bf16
        # tolerance can be a few bf16 steps
        want = flash_backward_reference(q, k, v, out, lse, do, causal, None, window,
                                        round_like_kernel=True)
        name = "bfloat16" if dt == torch.bfloat16 else "float32"
        at = f"B={B_} H={H_} Sq={sq} Sk={sk} D={D_} {name} causal={causal} window={window}"
        for nm, a, b in zip(("dq", "dk", "dv"), got, want):
            use, text = tol_use(a, b)
            log(f"K4 {at} {nm}: {text}")
            check(a.dtype == b.dtype and grad_close(a, b),
                  f"K4 {nm} disagrees with flash_backward_reference at {at}")
            uses[f"{at} {nm}"] = use
        if (B_, H_, sq, D_, dt) == (B, H, S, D, torch.bfloat16):
            errs = [maxerr(a, b) for a, b in zip(got, want)]
            worst = {"dq": errs[0], "dkv": max(errs[1], errs[2])}
            faults = planted_faults(q, k, v, out, lse, do, got, want)
        del q, k, v, do, out, lse, got, want
        torch.cuda.empty_cache()
    # K1 + K4 through the autograd function against autograd of the plain
    # forward, which rounds neither P nor dS (the looser bf16 tolerance)
    for shape, dt in (((2, 16, 512, 128), torch.bfloat16), ((1, 4, 200, 64), torch.float32)):
        leaves = [torch.randn(*shape, generator=g, device=dev).to(dt).requires_grad_()
                  for _ in range(3)]
        do = torch.randn(*shape, generator=g, device=dev).to(dt)
        got = torch.autograd.grad(flash_attention(*leaves, True, None, 0), leaves, do)
        want = torch.autograd.grad(mha_reference(*leaves, True, None, 0)[0], leaves, do)
        for nm, a, b in zip(("dq", "dk", "dv"), got, want):
            use, text = tol_use(a, b, rounded=False)
            log(f"FlashAttention {shape} {dt} {nm} against autograd of mha_reference: {text}")
            check(grad_close(a, b, rounded=False),
                  f"FlashAttention gradients disagree at {shape} {dt}")
            uses[f"FlashAttention {shape} {dt} {nm}"] = use
    torch.cuda.empty_cache()
    log(json.dumps({"k4_tolerance_used": uses, "k4_planted_faults": faults}))
    return worst


# -- phase 9: training -------------------------------------------------------


TRAIN = dict(FULL, remat=True, xent_chunks=8)
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 1024, 5


def matmul_flops_fwd(cfg, batch: int, seq: int) -> float:
    """Matmul-only forward FLOPs, as the repo's bench counts them
    (bench.py ``matmul_flops_fwd``): projections, FFN, unembed and the
    causal half of QK^T and PV; the embedding gather is excluded."""
    D, F, L, V, S = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size, seq
    H = cfg.n_heads * cfg.head_dim
    KV = cfg.kv_heads * cfg.head_dim
    per_token_dense = L * (2 * D * (H + 2 * KV) + 2 * H * D + 6 * D * F)
    per_token_dense += 2 * D * V  # unembed
    dense = batch * S * per_token_dense
    attn = L * batch * 2 * (S * S // 2) * (2 * H)  # causal half, qk + pv
    return float(dense + attn)


def phase_train(dev):
    """The full-width training path: 1 warm-up and TRAIN_STEPS timed steps."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models.data import SyntheticTokenDataset, batches
    from elastic_gpu_scheduler_tpu_torch.models.train import (
        init_state,
        make_optimizer,
        make_train_step,
    )
    from elastic_gpu_scheduler_tpu_torch.models.transformer import (
        TransformerConfig,
        param_count,
    )
    from elastic_gpu_scheduler_tpu_torch.ops import _build

    cfg = TransformerConfig(**TRAIN)
    opt = make_optimizer(mu_dtype="bfloat16")
    params, state = init_state(cfg, opt, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = param_count(params)
    step = make_train_step(cfg, opt)
    # one batch of the synthetic stream, stepped on repeatedly (as the
    # repo's train bench does), so "the loss falls" does not hang on how
    # hard the next batch happens to be
    batch = next(batches(SyntheticTokenDataset(cfg.vocab_size, seed=0), TRAIN_B, TRAIN_S, seed=1))
    toks = [torch.from_numpy(batch).to(dev)] * (TRAIN_STEPS + 1)
    log(f"train: {n_params / 1e9:.3f}B parameters, B={TRAIN_B} S={TRAIN_S}, remat, "
        f"xent_chunks={cfg.xent_chunks}, AdamW mu bf16 + fp32 masters")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    # the main path: counts at 0 just before, read just after
    _build.reset_launches()
    losses, times = [], []
    for t in toks:
        t0 = time.perf_counter()
        _, _, loss = step(params, state, t)
        losses.append(float(loss))  # synchronizes
        times.append(time.perf_counter() - t0)
    launches = dict(_build.LAUNCHES)
    n_steps = len(toks)
    L = cfg.n_layers
    want = dict.fromkeys(launches, 0)
    want.update(flash_fwd=2 * L * n_steps, flash_bwd_dq=L * n_steps, flash_bwd_dkv=L * n_steps)
    log(f"train main path: {n_steps} steps, losses {[round(x, 4) for x in losses]}, "
        f"launches {launches} (want {want})")
    check(all(np.isfinite(losses)), "train loss not finite")
    check(losses[-1] < losses[0], "train loss did not fall")
    check(launches == want, "train-path launches differ from 2L / L per step")
    step_ms = float(np.mean(times[1:])) * 1e3
    flops = 3 * matmul_flops_fwd(cfg, TRAIN_B, TRAIN_S)
    perf = {
        "step_ms": step_ms, "step_ms_each": [x * 1e3 for x in times],
        "tokens_per_s": TRAIN_B * TRAIN_S / (step_ms / 1e3),
        "model_tflops": flops / (step_ms / 1e3) / 1e12,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "params_b": n_params / 1e9, "losses": losses,
    }
    log("train perf: " + json.dumps(perf))
    return cfg, params, state, step, toks[0], launches, perf


def phase_train_profile(step, params, state, tokens) -> dict:
    """One full-width train step under torch.profiler: device busy time,
    idle share, top kernels and K4's share."""
    wall_ms, kernels = profiled(lambda: float(step(params, state, tokens)[2]),
                                "a train step", cpu=True)
    busy = sum(k["ms"] for k in kernels)

    def share(sub):
        return sum(k["ms"] for k in kernels if sub in k["kernel"]) / busy

    res = {"window": "one full-width train step", "wall_ms": wall_ms,
           "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
           "launches": sum(k["count"] for k in kernels),
           "k4_share": share("flash_bwd"), "k1_share": share("flash_fwd"),
           "top": kernels[:25]}
    log(json.dumps({"train_profile": res}))
    log(f"train profile: step wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
        f"(idle share {res['idle_share']:.3f}), K4 {res['k4_share']:.3f} and K1 "
        f"{res['k1_share']:.3f} of device time, {res['launches']} kernel launches")
    for k in kernels[:12]:
        log(f"  {k['ms']:9.3f} ms  x{k['count']:5d}  {k['kernel']}")
    return res


def phase_train_cpu_vs_card(dev) -> None:
    """A small float32 model, 3 steps on the card and 3 on the CPU from
    the same weights and tokens: losses and final parameters within 1e-4
    relative (of the loss; of each leaf's largest magnitude)."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models.data import SyntheticTokenDataset, batches
    from elastic_gpu_scheduler_tpu_torch.models.train import (
        _leaves,
        make_optimizer,
        make_train_step,
        state_for,
    )
    from elastic_gpu_scheduler_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )

    small = TransformerConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=4,
                              n_kv_heads=2, d_ff=512, dtype="float32", remat=True,
                              xent_chunks=4)
    base = init_params(small, torch.Generator().manual_seed(3), "cpu")
    stream = batches(SyntheticTokenDataset(512, seed=4), 4, 128, seed=5)
    toks = [torch.from_numpy(next(stream)) for _ in range(3)]
    out = {}
    for where in ("cpu", dev):
        opt = make_optimizer(lr=3e-4, warmup_steps=1, total_steps=4, grad_clip=1.0)
        params = {k: (v.clone().to(where) if not isinstance(v, dict)
                      else {n: t.clone().to(where) for n, t in v.items()})
                  for k, v in base.items()}
        params, state = state_for(params, opt)
        step = make_train_step(small, opt)
        losses = [float(step(params, state, t.to(where))[2]) for t in toks]
        out[str(where)] = (losses, [p.detach().cpu() for p in _leaves(params)])
    (lc, pc), (lg, pg) = out["cpu"], out[str(dev)]
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
    param_rel = max(float((a - b).abs().max() / a.abs().max()) for a, b in zip(pc, pg))
    log(f"small float32 train, card vs CPU: losses {lg} vs {lc}; max loss rel diff "
        f"{loss_rel:.3g}, max param diff / leaf max {param_rel:.3g} (tol 1e-4)")
    check(loss_rel <= 1e-4 and param_rel <= 1e-4, "float32 training differs between card and CPU")


def phase_launcher(dev) -> dict:
    """``launcher.run_job`` with the reference's default JobSpec (the
    default 4-layer bf16 model, B 8, S 128), 3 steps on the card."""
    from elastic_gpu_scheduler_tpu_torch import launcher
    from elastic_gpu_scheduler_tpu_torch.ops import _build

    spec = launcher.JobSpec(steps=3)
    _build.reset_launches()
    t0 = time.perf_counter()
    losses = launcher.run_job(spec, device=dev)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    L = spec.model.n_layers
    log(f"launcher.run_job default JobSpec: losses {losses} in {wall:.2f} s, launches {launches}")
    check(len(losses) == 3 and all(np.isfinite(losses)), "run_job losses")
    check(launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == L * 3
          and launches["flash_fwd"] == L * 3, "run_job did not run K1/K4 once a layer a step")
    return {"losses": losses, "wall_s": wall}


def k4_bound_ms(B, H, sq, sk, D, causal, window, itemsize) -> tuple[float, str]:
    """The whole backward the two K4 kernels replace: 5 products a kept
    pair (S, dP, dV, dQ, dK; 2 FLOPs a MAC); q, k, v, out, dO and the fp32
    lse read once, dq, dk, dv written once."""
    pairs = B * H * k1_pairs(sq, sk, causal, window)
    flops = 2 * 5 * pairs * D
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS
    byts = B * H * (3 * sq + 2 * sk) * D * itemsize + B * H * sq * 4
    byts += B * H * (sq + 2 * sk) * D * itemsize
    t_ops, t_bytes = flops / peak * 1e3, byts / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# each K4 kernel's share of the backward's bound: the products it alone
# must do (the dq kernel dQ; the dkv kernel S, dP, dV and dK), so the two
# rows add up to the function's bound and not to the 7 products the
# two-kernel design does
K4_SHARE = {"dq": 1 / 5, "dkv": 4 / 5}


def kernel_train_rows(dev, launches, k4_err) -> list[dict]:
    """K1 and K4 at the train path's attention shape (bf16, causal)."""
    import torch
    import torch.nn.functional as F

    from elastic_gpu_scheduler_tpu_torch.ops.attention import (
        flash_attention,
        flash_backward,
        flash_backward_reference,
        mha_reference,
    )

    B, H, S, _, D = TRAIN_ATTN
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, do = (torch.randn(B, H, S, D, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    check_repeatable(q, k, v, do)
    # K1 forward
    out, lse = flash_attention(q, k, v, True, None, 0, return_lse=True)
    ref, ref_lse = mha_reference(q, k, v, True, None, 0)
    k1_err, k1_lse_err = maxerr(out, ref), maxerr(lse, ref_lse)
    log(f"K1 at the train shape: max|out-ref|={k1_err:.3g} max|lse-ref|={k1_lse_err:.3g}")
    check(close(out, ref, "bfloat16") and k1_lse_err <= 1e-4,
          "K1 disagrees with mha_reference at the train shape")
    k1_ms = device_ms(lambda: flash_attention(q, k, v, True, None, 0), 20)
    k1_plain = device_ms(lambda: mha_reference(q, k, v, True, None, 0), 5)
    k1_lib = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 20)
    k1_bound, k1_by = k1_bound_ms(B, H, S, S, D, True, 0, 2)
    # K4: each kernel's own device time, from the same calls
    def bwd():
        return flash_backward(q, k, v, out, lse, do, True, None, 0)

    dq_ms = device_ms(bwd, 10, match="flash_bwd_dq")
    dkv_ms = device_ms(bwd, 10, match="flash_bwd_dkv")
    plain_ms = device_ms(lambda: flash_backward_reference(q, k, v, ref, ref_lse, do, True,
                                                          None, 0), 3)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves, is_causal=True)
        return torch.autograd.grad(o, leaves, do)

    lib_bwd = device_ms(sdpa_fwd_bwd, 10) - k1_lib
    log(f"train-shape timing (B={B} H={H} S={S} D={D} bf16 causal): K1 {k1_ms:.4f} ms "
        f"(plain {k1_plain:.4f}, sdpa {k1_lib:.4f}, bound {k1_bound:.5f} {k1_by}); "
        f"K4 dq {dq_ms:.4f} ms + dkv {dkv_ms:.4f} ms (plain backward {plain_ms:.4f}, "
        f"sdpa backward {lib_bwd:.4f})")
    rows = [{
        "name": "flash_fwd", "path": "train", "route": "cuda",
        "source": "elastic_gpu_scheduler_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "elastic_gpu_scheduler_tpu/ops/attention.py:290",
        "launches": launches["flash_fwd"], "max_abs_err": k1_err,
        "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound, "bound_by": k1_by,
        "library_ms": k1_lib,
    }]
    k4_bound, k4_by = k4_bound_ms(B, H, S, S, D, True, 0, 2)
    log(f"K4 bound (the whole backward): {k4_bound:.5f} ms ({k4_by}); dq + dkv "
        f"{dq_ms + dkv_ms:.4f} ms, {(dq_ms + dkv_ms) / k4_bound:.1f}x")
    for which, ms in (("dq", dq_ms), ("dkv", dkv_ms)):
        bound, by = K4_SHARE[which] * k4_bound, k4_by
        rows.append({
            "name": f"flash_bwd_{which}", "path": "train", "route": "cuda",
            "source": "elastic_gpu_scheduler_tpu_torch/csrc/flash_bwd.cu",
            "replaces": "elastic_gpu_scheduler_tpu/ops/attention.py:633",
            "launches": launches[f"flash_bwd_{which}"], "max_abs_err": k4_err[which],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_bwd,
            "note": "plain_ms and library_ms are the whole backward (dq, dk and dv): "
                    "flash_backward_reference, and SDPA forward+backward minus forward; "
                    "bound_ms is this kernel's share (dq 1/5, dkv 4/5) of the whole "
                    "backward's bound",
        })
    return rows


# the PR that last rebuilt each kernel's bf16 path for Hopper
REDESIGNED = {"flash_fwd": "PR 4", "flash_bwd_dq": "PR 4", "flash_bwd_dkv": "PR 4"}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    try:
        from elastic_gpu_scheduler_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"the port's package is not next to this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. device and toolchain
    card = card_line()
    nvcc = _build.nvcc_path()
    nvcc_v = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                            check=True).stdout.strip().splitlines()[-1]
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, nvcc: {nvcc_v}, "
        f"capability {torch.cuda.get_device_capability(0)}")

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    log(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log_path().read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())

    # 3. to 5. the kernels against their plain versions
    k1_err = phase_k1(dev)
    k2_err = phase_k2(dev)
    k2i_err = phase_k2_int8(dev)
    k3_err = phase_k3(dev)
    k4_err = phase_k4(dev)

    # 6. the engine, 7. HTTP
    eng, prompts, reqs, launches, sampler, perf = phase_engine(dev)
    phase_http(eng, prompts[0])

    # 8. where a fused chunk's time goes; the engine's kernel rows
    phase_profile(eng, prompts)
    kernels = [kernel_k1(eng, prompts, launches, k1_err), kernel_k2(sampler, launches, k2_err)]
    kernels[0]["path"] = kernels[1]["path"] = "serve"

    # 6b. the prefix-cached, chunked, int8-KV engine on the same weights
    peng, plaunches, k3_sampler, k2i_sampler, pperf = phase_prefix_engine(
        dev, eng.params, eng.cfg)
    prefix_rows = [kernel_k2(k2i_sampler, plaunches, k2i_err, name="paged_attention_int8"),
                   kernel_k3(k3_sampler, plaunches, k3_err)]
    for r in prefix_rows:
        r["path"] = "serve: prefix cache, prefill_chunk 128, int8 KV"
    kernels += prefix_rows
    del eng, prompts, reqs, sampler, peng, k3_sampler, k2i_sampler
    gc.collect()
    torch.cuda.empty_cache()

    # 9. the training path, card against CPU, the launcher, a profiled step
    cfg, params, state, step, tokens, train_launches, train_perf = phase_train(dev)
    train_prof = phase_train_profile(step, params, state, tokens)
    del cfg, params, state, step, tokens
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_cpu_vs_card(dev)
    launcher_res = phase_launcher(dev)

    # 10. the kernels line
    kernels += kernel_train_rows(dev, train_launches, k4_err)
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was not launched on its main path")
        k["of_bound"] = k["bound_ms"] / k["ms"]
        k["vs_library"] = k["ms"] / k["library_ms"] if k["library_ms"] else None
        if k["name"] in REDESIGNED:
            k["redesigned"] = REDESIGNED[k["name"]]
    log(json.dumps({"engine": perf}))
    log(json.dumps({"prefix_engine": pperf}))
    log(json.dumps({"train": train_perf, "train_profile_idle_share": train_prof["idle_share"],
                    "launcher": launcher_res}))
    log(card)
    print(json.dumps({"kernels": kernels}))
    # the one card this script drives (cuda:0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
