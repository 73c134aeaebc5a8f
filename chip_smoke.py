"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit) on any fault:

1. device and toolchain: the card's name and power limit (nvidia-smi),
   torch / CUDA / nvcc versions;
2. build: every ``csrc/*.cu`` of the port compiled with nvcc for sm_90a;
3. K1 (flash-attention forward) against ``mha_reference`` on the card:
   the prefill shapes of the main path plus edge cases;
4. K2 (paged decode attention) against ``paged_attention_reference``;
5. the port's serving engine at the full width of the repo's largest LM
   config (~1.01B parameters, GQA 16q/8kv, bf16, random weights from a
   seed, 16 layers): 12 mixed-length greedy prompts, 64 new tokens each,
   with the paged kernel; launch counts must match the path exactly; the
   gather-path engine on the same weights must agree; a small float32
   model must give identical greedy tokens on the card and on the CPU;
6. HTTP: ``serve_inference`` on the card-resident engine, one blocking
   and one SSE completion against the engine's own tokens, /healthz and
   /v1/stats;
7. one fused decode chunk of the full-width engine under torch.profiler:
   device time by kernel and the device's idle share;
8. a ``{"kernels": [...]}`` line with each kernel's launches on the main
   path, error against its plain version, time, plain time, library
   time and lower bound, then the card line and the final ``{"ok": ...}``.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

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


def device_ms(fn, reps: int) -> float:
    """Device time of one call (every kernel it launches, summed; host
    launch overhead excluded), from torch.profiler over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(k["ms"] for k in device_kernels(prof))
    check(total > 0, "the profiler saw no device time")
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


def phase_k1(dev):
    import torch

    from elastic_gpu_scheduler_tpu_torch.ops.attention import flash_attention, mha_reference

    g = torch.Generator(device=dev).manual_seed(1)
    # (B, H, Sq, Sk, D, dtype, causal, window)
    cases = [(1, 16, s, s, 128, torch.bfloat16, True, 0) for s in (8, 128, 512)] + [
        (1, 16, 1000, 1000, 128, torch.bfloat16, True, 0),  # non-power-of-two
        (1, 16, 200, 640, 128, torch.bfloat16, True, 0),  # rectangular
        (1, 16, 512, 512, 128, torch.bfloat16, True, 128),  # sliding window
        (2, 4, 96, 160, 64, torch.float32, True, 0),  # fp32, TF32 off
        (1, 2, 37, 37, 32, torch.float32, False, 0),  # fp32, not causal
    ]
    worst = 0.0
    for B, H, sq, sk, D, dt, causal, window in cases:
        q = torch.randn(B, H, sq, D, generator=g, device=dev).to(dt)
        k = torch.randn(B, H, sk, D, generator=g, device=dev).to(dt)
        v = torch.randn(B, H, sk, D, generator=g, device=dev).to(dt)
        out, lse = flash_attention(q, k, v, causal, None, window, return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = mha_reference(q, k, v, causal, None, window)
        name = "bfloat16" if dt == torch.bfloat16 else "float32"
        e, el = maxerr(out, ref), maxerr(lse, ref_lse)
        ok = close(out, ref, name) and el <= 1e-4
        log(f"K1 B={B} H={H} Sq={sq} Sk={sk} D={D} {name} causal={causal} "
            f"window={window}: max|out-ref|={e:.3g} (tol {TOL[name]} + "
            f"{RTOL[name]}|ref|) "
            f"max|lse-ref|={el:.3g} (tol 1e-4)")
        check(ok, f"K1 disagrees with mha_reference at {(B, H, sq, sk, D, name, window)}")
        if dt == torch.bfloat16 and window == 0 and sq == sk:
            worst = max(worst, e)
    return worst


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


# -- phase 5: the engine ---------------------------------------------------


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


class K2Sampler:
    """Keeps a few of the main path's K2 calls (their inputs) so the
    kernel can be timed and checked on exactly what the path gave it."""

    def __init__(self, every: int = 211, keep: int = 12):
        self.every, self.keep, self.n, self.calls = every, keep, 0, []

    def wrap(self, fn):
        def call(q, lkv, tables, lengths, cfg, dtype):
            self.n += 1
            if self.n % self.every == 1 and len(self.calls) < self.keep:
                self.calls.append((q.clone(), lkv, tables.clone(), lengths.clone(), cfg))
            return fn(q, lkv, tables, lengths, cfg, dtype)
        return call


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
    sampler = K2Sampler()
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
        pre = e._prefill_dispatch(0, len(p))
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


# -- phase 6: HTTP ---------------------------------------------------------


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


# -- phase 7: the kernels line ---------------------------------------------


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


def kernel_k2(sampler, launches, worst):
    """K2 on inputs the main path gave it (sampled calls)."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_reference,
    )

    check(sampler.calls, "no K2 call was sampled on the main path")
    ms_l, plain_l, bound_l, err = [], [], [], worst
    for q, lkv, tables, lengths, cfg in sampler.calls:
        pk, pv = lkv["k"], lkv["v"]
        w = cfg.window_size

        def kern():
            return paged_attention(q, pk, pv, tables, lengths, window=w)

        def plain():
            return paged_attention_reference(q, pk, pv, tables, lengths, window=w)

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
        isz = pk.element_size()
        byts = (len(live) * ps * Hkv * Dh * isz * 2 + 2 * q.numel() * q.element_size()
                + tables.numel() * 4 + lengths.numel() * 4)
        bound_l.append(byts / PEAK_BYTES * 1e3)
    log(f"K2 timing over {len(ms_l)} main-path calls: kernel {np.mean(ms_l):.4f} ms, "
        f"plain {np.mean(plain_l):.4f} ms, bound {np.mean(bound_l):.5f} ms (bytes)")
    return {
        "name": "paged_attention", "route": "cuda",
        "source": "elastic_gpu_scheduler_tpu_torch/csrc/paged_attention.cu",
        "replaces": "elastic_gpu_scheduler_tpu/ops/paged_attention.py:204",
        "launches": launches["paged_attention"], "max_abs_err": err,
        "ms": float(np.mean(ms_l)), "plain_ms": float(np.mean(plain_l)),
        "bound_ms": float(np.mean(bound_l)), "bound_by": "bytes", "library_ms": None,
    }


def phase_profile(eng, prompts) -> None:
    """One fused decode chunk of a full batch under torch.profiler: device
    time by kernel, and the device's busy share of the chunk's wall time
    (one stream, so busy = the sum of kernel times)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from elastic_gpu_scheduler_tpu_torch.models.serving import Request

    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=3 * eng.fused_steps))
            for p in prompts[: eng.max_batch]]
    eng._admit()  # the prefills, outside the window
    eng.step()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.run_until_idle()
    check(all(r.done.is_set() and not r.error for r in reqs), "profiled requests failed")
    kernels = device_kernels(prof)
    busy = sum(k["ms"] for k in kernels)
    check(busy > 0, "the profiler saw no device time")
    res = {"window": f"one fused chunk ({eng.fused_steps} decode iterations, "
                     f"batch {eng.max_batch})",
           "wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
           "launches": sum(k["count"] for k in kernels), "top": kernels[:25]}
    log(json.dumps({"profile": res}))
    log(f"profile: chunk wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
        f"(idle share {1 - busy / wall_ms:.3f}), {res['launches']} kernel launches")
    for k in kernels[:12]:
        log(f"  {k['ms']:9.3f} ms  x{k['count']:5d}  {k['kernel']}")


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

    # 3. and 4. the kernels against their plain versions
    k1_err = phase_k1(dev)
    k2_err = phase_k2(dev)

    # 5. the engine, 6. HTTP
    eng, prompts, reqs, launches, sampler, perf = phase_engine(dev)
    phase_http(eng, prompts[0])

    # 7. where a fused chunk's time goes, 8. the kernels line
    phase_profile(eng, prompts)
    kernels = [kernel_k1(eng, prompts, launches, k1_err), kernel_k2(sampler, launches, k2_err)]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was not launched on the main path")
    log(json.dumps({"engine": perf}))
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
