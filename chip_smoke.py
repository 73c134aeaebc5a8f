"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit) on any fault:

1. device and toolchain: the card's name and power limit (nvidia-smi),
   torch / CUDA / nvcc versions;
2. build: every ``csrc/*.cu`` of the port compiled with nvcc for sm_90a
   into the kernel library's compile-cache entry (ptxas registers and
   spills logged);
3. K1 (flash-attention forward) against ``mha_reference`` on the card:
   the serve-prefill shapes, the train shape and edge cases on its grid,
   each logging the kernel (and so the query tile) that ran, so that every
   kernel of ``flash_fwd.cu`` is held;
4. K2 (paged decode attention) against ``paged_attention_reference``,
   over dense pools and (its int8 half) over int8 pools with per-(token,
   kv-head) scales, at table widths that split the pages across blocks
   and one that does not, with rows on both sides of a split's edge, W 1
   and 4, window 0 and 256, plus inputs on which skipping the dequantised
   values' rounding through bf16 would fail the tolerance; K3 (blockwise
   attention with softmax statistics) against
   ``flash_block_stats_reference``, at the prefix-cached path's shapes
   plus edge cases (ragged lengths, offsets, rows that keep no key over
   several key splits, not causal, GQA and MHA, Dh 64 and 128, fp32 and
   bf16), its pv / l against ``mha_reference`` over the kept keys, and
   the engine's transposed views read in place; each K2 and K3 call logs
   the kernels that ran (torch.profiler), which must be the combine
   kernel exactly when the kernel's plan splits;
5. K4 (flash-attention backward) against ``flash_backward_reference``
   rounded where the kernel rounds: the training shape plus edge cases;
   faults planted in the training-shape result, which the tolerance must
   refuse; gradients through ``FlashAttention`` (K1 + K4) against
   autograd of ``mha_reference``;
KE. the expert-indexed / int8 weight product (``csrc/expert_matmul.cu``)
   against ``expert_matmul_reference`` at the one-device main paths'
   shapes (MoE decode w_gate / w_in and w_out, the grouped prefill at T
   512, MoE + int8 decode, the int8 projections and unembed at M 8, the
   int8 prefill at T 512; the mesh's slices and foreign ids are held in
   phase 16): tolerance, bitwise repeatable, the plan's
   kernel alone and once a call (the ring kernel, its K splits one
   cluster with no combine kernel, or the wgmma kernel), both readings
   over calls that find their weight cold in L2, against the plain
   version, a library call and the bound; each row's launch (kernel,
   grid, block, shared memory) counted in phases 6g and 6h's profiled
   windows, a chunk or a prefill, every KE launch of a chunk some row's;
   a graph captured on one routing replays three others equal to eager;
   ptxas registers and spills by kernel;
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
6c. the overlapped engine (``overlap=True``, the default: each decode
   chunk a CUDA graph replay) on the same weights and prompts: a warm-up
   batch that captures the graphs, then the timed batch beside phase 6's
   sequential engine (pinned to ``overlap=False``, as phase 6b is) driven
   the same way (tokens per second, wall ms a chunk, host gap, graphs and
   capture seconds, uploads a chunk); K2's replay-counted launches must
   equal L x fused_steps x (chunks + captures' warm-ups); first tokens
   must equal phase 6's; the device's idle share over a profiled window of
   consecutive chunks; one replay against one eager chunk from cloned
   state (identical tokens, carry and pool bytes); float32 tokens with
   overlap on the card equal to the sequential CPU run's;
6d. speculative decoding (``spec_k=4``: K2's W = 5 window) on the same
   weights: the serve prompts (W = 5 calls = L x verify passes, sampled
   and held to ``paged_attention_reference``) and bench.py's repetitive
   prompts (tokens per second, passes, accepted drafts a pass); an int8,
   prefix-cached, chunked run whose W = 5 calls go through K2-int8 beside
   K3; a small random-init draft model (D 512, L 4) at the full
   vocabulary (first tokens equal to the target's); on a small float32
   model, spec_k 4 equal to spec_k 0 on the card and the CPU (dense and
   int8) and the model as its own draft accepting most of its window;
6e. per-request controls on the same weights and prompts: the overlapped
   engine serves the plain batch and a batch where every request asks for
   logprobs 5 with a logit_bias and min_tokens (stop ids its phase 6
   stream emits), two add allowed_tokens and the sampled half a seed
   (tokens per second and wall ms a chunk for both; exact K1 / K2
   launches and every chunk a replay on the controls batch); the same
   batch with both penalties (the sequential loop) and under spec_k 4;
   every token held to its constraints, every logprob row to sanity, the
   seeded requests identical when run twice in one mode; device ms and
   kernels a chunk, plain against controls (torch.profiler); graphs and
   capture seconds per variant; HTTP ``n`` = 2 with a seed and logprobs
   in JSON and SSE, a flood against ``max_queue=1`` meeting a 429, and
   /v1/stats; on the small float32 model, each control's greedy tokens
   and logprobs on the card equal to the CPU's in four modes, and a
   seeded request identical alone, batched, overlapped, under spec_k 4
   and across a spill;
6f. multi-LoRA serving on the same weights and prompts with four adapters
   (r 16 on every family, r 8 on wq/wv, r 16 on attention, r 4 on the
   MLP; B drawn from a seed at a printed scale): the bank engine with
   every request on "" gives the bank-less engine's tokens and graph keys;
   the mixed batch (round-robin over "" and the adapters) captures no
   graph, launches K1 / K2 exactly, and some adapter changes some tokens;
   each request against its adapter's batch alone (reported); tokens per
   second, wall ms and (torch.profiler) device ms and kernels a chunk for
   the bank-less, all-"" and mixed batches; spec_k 4 with the mixed
   batch; the int8 + prefix + chunked engine with adapters (hit counters:
   pages shared only under one adapter; wave-2 prefill ms); HTTP (an
   adapter 200, an unknown one 400, n = 2 on an adapter, /v1/stats); on a
   small float32 model, card = CPU in four modes, each adapter = its
   merged engine, prefix hits 0, 0, 16, and 3 LoRA train steps within
   1e-4 of the CPU;
6g. MoE serving at the same width with 8 experts (Switch top-1, ~5.8B
   parameters, bf16, not cut): the overlapped engine on the 12 prompts
   (every chunk a replay; K1, K2 and KE launches exact: KE 3L a decode
   step and a prefill), a new routing mix that captures nothing, the
   sequential engine beside it (first tokens equal), device ms and
   kernels a chunk, the int8 + prefix + chunked engine (launches and
   prefix counters exact), spec_k 4 (KE 3L a verify pass) and one HTTP
   completion;
6h. int8 weights: the dense flagship after ``quantize_params``, overlapped,
   beside the bf16 engine in the same call (tokens/s, device ms a chunk,
   weight bytes; KE 7L + 1 a pass exactly; first tokens against bf16
   reported), then the MoE weights quantized;
6i. small float32 MoE, int8 and MoE + int8 engines: card = CPU,
   sequential, overlapped, int8 KV + prefix + chunked and spec_k 4;
6j. disaggregated serving at the same width on 6b's options, once with a
   bf16 pool and once with an int8 pool: a prefill-role and a decode-role
   ``serve_inference`` server in this process, sharing the weights; 6b's
   256-token shared prefix and its 700- and 900-token prompts through
   ``/v1/prefill`` on one and ``X-KV-Source`` adoption on the other
   (imported pages and prefix hits equal the traffic; the decode side's
   launches exact: K1 none, K3 L x passes, K2 or K2-int8 L x fused_steps
   x chunks; its tokens equal a single engine's local warm hit, its first
   tokens the single engine's cold run); a stream on an overlapped engine
   moved by ``/v1/migrate/out`` after one chunk (at most one chunk
   discarded, agreement with the unmigrated stream reported), a refused
   handoff resumed locally, and a captured decode graph replayed over
   freshly imported pages equal to the eager chunk with no new capture;
   bundle bytes, export and import ms as engine tasks, ``/v1/prefill`` +
   adoption against a cold prefill, the migration's wall to its first
   relayed token; a small float32 model's split and migration equal on
   the card, the CPU and an engine that ships nothing;
7. HTTP: ``serve_inference`` on the card-resident engine, one blocking
   and one SSE completion against the engine's own tokens, /healthz and
   /v1/stats;
7b. (run last) the observability plane on the overlapped engine (the
   default) at the same width, every plane on (tracing and profiling at 1.0, TTFT and e2e
   objectives): a cold batch through the engine loop with the planes off
   and on (uploads and graph captures equal); then the main path, phase
   6's 12 prompts as 12 concurrent SSE streams into 8 slots, each with
   its own traceparent: launches exact (K1 L x prefills, K2 L x K x
   chunks); one ``: slo`` comment before each stream's first token;
   ``/metrics`` counting 12 ok requests, 768 tokens and 12 latencies, the
   resident page gauges adding up to the pool; every trace serve.request
   -> engine.queued -> engine.admitted under the client's span (causal on
   ``/debug/trace/<id>``); engine.step spans exactly where the pacing puts
   them (steps 0, 32, ... of the traced steps the profiler counted), each
   in a trace between its admission and its response; 12 replica
   journeys on ``/debug/slo``; ``/debug/profiles`` with the card's
   generation and the step-sampled tokens (all but each request's prefill
   token); client TTFT, e2e, time a token and queue wait beside the
   server's; tokens/s of the same batch in 6 pairs of rounds (3 batches
   a round) with every plane on and off, the cost resolved against the
   off rounds' spread, and the idle share under torch.profiler on 2
   batches a side; the batch behind the stdlib's listen backlog of 5;
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
9b. LoRA fine-tuning at the same shape: rank 16 on every family over the
   frozen bf16 base, one warm-up and 5 timed steps on one batch; the loss
   must fall, the base keep its bits, K1 / K4 launch 2L / L a step; step
   ms, tokens per second, memory and trainable parameters beside phase 9;
9c. MoE training at the same width with 8 experts, depth cut to 4
   layers (fp32 masters and AdamW moments), B 8, S 1024: the loss falls,
   the aux is finite and in the loss, K1 / K4 2L / L a step and no KE;
   one step profiled; a small float32 MoE model card vs CPU;
   ``launcher.run_job`` with a MoE JobSpec beside the default one;
11. ``serve --hf`` (after 7b, as are 12-14): a Llama-layout checkpoint at
   TinyLlama-1.1B's published widths (hidden 2048, 22 layers, 32 heads, 4
   kv heads, d_ff 5632, vocab 32000; random bf16 weights from a seed)
   written as safetensors by the port's own writer, served by ``python -m
   elastic_gpu_scheduler_tpu_torch.serve --hf`` in its own process (a
   float32 model, as the converter sets it; paged kernel): four concurrent
   completions over HTTP equal to the same engine built in this process
   from the same checkpoint (K1 = L x prefills and K2 = L x K x (chunks +
   captures' warm-ups) on that main path), and the port's first-token
   logits within 1e-3 of a plain float32 forward of the HF-layout state
   dict; load time, tokens/s and the weights' GB logged;
12. ``--draft-hf``: a 2-layer draft (the checkpoint's embedding, first two
   layers and head) with ``--spec-k 4``: greedy streams equal to the
   unspeculated ones, over HTTP and in this process (K2 = L x (verify
   passes + K x (chunks + warm-ups))), accepted drafts a pass logged;
13. checkpoint and resume: ``launcher.run_job`` at the dense flagship's
   width, depth cut to 2 layers, B 8, S 1024, 6 steps: uninterrupted
   (K1 2L and K4 L a step), then in a child process killed (SIGKILL)
   as step 5 starts, after its saves of steps 2 and 4 were dispatched,
   then resumed here from the latest complete step; the resumed losses
   and the final checkpoint against the uninterrupted run's (whether
   bitwise, else the largest difference); save, write and restore ms
   and the bytes;
14. ViT training at ViT-B/16's widths (image 224, patch 16, D 768, 12
   heads, d_ff 3072, 1000 classes, bf16, all 12 layers), B 64, one
   warm-up and 5 timed steps on one batch: the loss falls, K1 and K4 L a
   step, all not causal; step ms, images/s, model TFLOP/s;
15. training on a mesh (``parallel/``): (a) ``launcher.run_job`` at
   phase 9's model and batch through a one-rank NCCL process group,
   bitwise equal to the same job on one device; (b) ranks sharing the
   card over gloo (collectives staged through the host) at the
   flagship's width, depth cut to 2 layers for time, 3 steps each:
   tensor=2 (K1 / K4 on 8 query / 4 KV heads a rank, the tensor-parallel
   loss), seq=2 with ring attention (K3 forward hops, K4 backward hops,
   float32) and fsdp=2,tensor=2, against the single-device run; (c) the
   same meshes with a small float32 model, within 1e-5; (d) a float32 job
   saved on tensor=2 and resumed on one device, against the uninterrupted
   run; (e)-(g) the pipe and expert axes, the small model pipelined with
   MoE on expert=2, data=2 and fsdp=2 beside pipe=2 within 1e-5 of one
   device's step accumulating the same microbatches.
   Every rank's launches are held exactly; step ms and peak memory a rank
   are of ranks sharing one card, not a scaling figure.  The ring's K3
   and K4 hops get their own kernel rows (float32, B 8, 16 heads, a
   512-token shard, Dh 128);
16. serving on a mesh (``InferenceEngine(mesh=...)``): ranks sharing the
   card over gloo, each building the model from the seed and serving its
   slice, rank 0 submitting and the others following its tickets: (a)
   the flagship (all 16 layers) on tensor=2 in float32, 8 of the serve
   bench's prompts, 32 new tokens: greedy tokens equal one device's, the
   largest |logit| gap on the first decode step printed; then in bf16 for
   64 new tokens: each prompt's first-token logits within
   ``SERVE_MESH_BF16_ULPS`` bf16 ulps (at its largest |logit|) of one
   device's, first tokens equal one device's wherever one device's bf16
   logits do not tie (a first token that differs must score within that
   limit of one device's best, and is listed), tokens/s a rank and wall
   ms a chunk (not a scaling figure); rank 0's sampled K2 calls (8 query /
   4 kv heads) held to ``paged_attention_reference``; (b) tensor=2 at the
   flagship's widths, 4 layers, float32: int8 KV + prefix cache + chunked
   prefill + spec_k 4 (K3 and K2-int8 at W 5 on the rank's heads) and
   int8 weights (KE on row and column slices), tokens equal one
   device's; (c) MoE (E 8, 4 layers, float32) on expert=2 and on
   expert=2,tensor=2 (four ranks), tokens equal one device's, peak GB a
   rank; in (b)'s int8 weights and (c), every rank's sampled KE calls
   (column and row slices; a rank's E/2 experts, F/2 under tensor=2, with
   tokens routed to the other rank's experts) run again and held to
   ``expert_matmul_reference``, every foreign id's row zeros; (d) a
   one-rank NCCL tensor=1 mesh: the overlapped engine captures and
   replays, tokens equal one device's; (e) ``serve --init
   --tensor 2 --dist-backend gloo --warmup lattice`` (its compile cache a
   directory holding this run's library) answers /healthz 503 warming
   before 200 with every lattice point built on both ranks, then a
   streamed completion alone and 4 one at a time (first TTFT over the
   median of the rest, beside the unwarmed ``--tensor 1``'s) and 4
   concurrent ones, all with ``--tensor 1``'s tokens, and so does a split: ``--tensor 2
   --fleet-role prefill`` prefills each prompt and a one-device
   ``--fleet-role decode`` replica answers it with ``X-KV-Source``, every
   page shipped counted on both; all exit 0 on SIGTERM; (f) the
   disaggregated verbs on tensor=2 ((b)'s float32 model, phase 6j's engine
   shape, a float32 and an int8 pool): a one-device bundle imported and
   exported again is the same bytes; a 256-token prefix's and a 900-token
   prompt's pages cross both ways (one device adopting tensor=2's, tensor=2
   one device's), tokens equal one device's cold run, pages and hits the
   traffic's, launches exact on each adopting side (K1 none, K3 L a
   prefixed pass, K2 L x fused_steps a chunk); a stream migrated each way
   after one chunk keeps its unmigrated tokens; export, import and the
   split's first token timed (median and range of 3 after a warm-up)
   beside one device's; (g) a tensor=2 engine at L 4 (float32, max_len
   256, fused_steps 8) warms its lattice twice in a row (every point a
   ticket's task on both ranks; digests equal after each; the pool's
   pages but the scratch page unchanged; cold and warm point seconds),
   then answers with one device's unwarmed tokens.  Every rank's
   launches are exact (K1 L a plain prefill, K3 L a prefixed one, K2 L a
   decode step or verify pass, KE 7L + 1 or 3L a pass), every rank emits
   the same tokens, and a K2 row times the kernel on calls (a)'s bf16
   rank 0 gave it (8 query / 4 kv heads a rank);
17. the warm-start plane: ``serve`` at the flagship's widths (depth cut
   to 4 layers) in float32 on phase 6's engine shape, three times in its
   own process: cold on a fresh
   ``--compile-cache-dir``, warm on the same directory, and with
   ``--warmup off``.  The first two answer /healthz 503 ``{"warming":
   true}`` before 200, warm every point of the ``minimal`` lattice (8
   prefill pad lengths, 3 sampling variants x 7 table-view buckets
   captured) with no error, and capture nothing while serving 8
   completions over those variants after ready; the cold start fills the
   library's entry once, the warm one loads it (fills 0, loads 1, no
   nvcc); greedy, sampled and seeded tokens equal the replica's with no
   warm-up.  ``launcher --compile-cache`` on that directory, two ranks
   over gloo started beside the cold start once it holds the directory's
   build lock: each loads the library (fills 0, loads 1).  Logged:
   the library's build and load seconds, the warm-up's wall time,
   captures and where its host time went, reserved device memory across
   the lattice and the first request's TTFT warmed and not;
18. the node plane: the device plugin's discovery on this host against
   ``nvidia-smi`` (its source logged), Allocate's env for 100 and 50
   units of the card, a tenant process under exactly the 50-unit env
   (``launcher.main``, 2 steps at L 2 in bf16, K1 and K4 L x steps, on
   the allocated card; then 0.6 of the card's memory refused and 0.4
   allocated), ``probe_relay`` up with the card's name and down with
   ``NOT_GPU`` when the card is hidden, and the plugin over gRPC on a
   unix socket where grpc and protobuf import;
10. K1 and K4 at the train shape, K3 and K2 (dense and int8) with split
   keys, called twice, must give identical bytes; K1 and K4 not causal at
   the ViT's shape (B 64, 12, 197, 64, bf16) against ``mha_reference`` and
   ``flash_backward_reference`` (``grad_close``), read early in the run
   with non-causal SDPA as the library call;
   a ``{"kernels": [...]}`` line (K2 twice: decode, and the W = 5
   verify window of phase 6d; KE once a shape of its phase, its launches
   those of the path the shape belongs to; K1 and K4 once at the train
   shape and once at the ViT's) with each kernel's launches on its main
   path, error against its plain version, time, plain time, library
   time and lower bound, its share of the bound (``of_bound``) and its
   factor over the library call (``vs_library``).  Every row's calls
   are captured as one CUDA graph of back-to-back calls, read two ways,
   READINGS times each in turn: the replay between two CUDA events
   (``ms``, the reading of record) and torch.profiler over the same
   replay (``profiler_ms``, which also names the kernels and counts their
   launches); the run fails when either reading is below the bound or
   the two disagree beyond the limit ``check_readings`` states.  Then the
   card line and the final ``{"ok": ...}``.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import gc
import http.client
import json
import os
import re
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


# seconds each group of phases took, in run order (the run's time limit
# holds them all): mark(name) closes the group that ends there
PHASE_S: dict = {}
_PHASE_T = [time.perf_counter()]


def mark(name: str) -> None:
    now = time.perf_counter()
    PHASE_S[name] = round(now - _PHASE_T[0], 1)
    _PHASE_T[0] = now


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


def trace_kernels(prof) -> list[dict]:
    """Every device kernel of a torch.profiler run in start order: its
    name, start and duration (ms), its launch (name, grid, block and
    shared memory), its threads, shared memory and registers a thread, and
    whether it is ``replay``'s spin kernel; from the run's Chrome trace."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    out = []
    for e in events:
        if e.get("cat") != "kernel":
            continue
        a = e.get("args", {})
        out.append({"kernel": e["name"], "start": e["ts"] / 1e3, "ms": e["dur"] / 1e3,
                    "launch": f"{e['name']} grid {a.get('grid')} block {a.get('block')} "
                              f"smem {a.get('shared memory')}",
                    "threads": int(np.prod(a.get("block") or [0])),
                    "smem": a.get("shared memory"), "registers": a.get("registers per thread"),
                    "spin": "spin_kernel" in e["name"]})
    return sorted(out, key=lambda k: k["start"])


# A window whose launches are counted exactly opens with this many spin
# kernels of half SPIN_CYCLES each (~80 ms in all): late in the process the
# records a window loses at its start ran past a 4-spin lead, in one run on
# the H100 (one or two KE launches of a window of three MoE / int8 chunks)
COUNTED_LEAD_SPINS = 32

# Now and then torch.profiler hands back no device events for a window
# (one window in ~50 of one run on the card, cause not known); such a
# window runs again, up to this many times in all
PROFILE_TRIES = 3


def profiled(fn, what: str, cpu: bool = False, trace: list | None = None,
             lead_spin: bool = False) -> tuple[float, list[dict]]:
    """Run ``fn`` once under torch.profiler: (wall ms, device kernels);
    ``trace``, when given, receives the run's kernels (``trace_kernels``).
    ``lead_spin``: the window opens with COUNTED_LEAD_SPINS spins,
    synchronized before the clock starts, and closes with a short spin,
    so the records a window loses in its first milliseconds or of its last
    kernels are the spins' (left out of both results), not ``fn``'s: for
    windows whose launches are counted exactly.  The run fails if no try of
    PROFILE_TRIES saw the device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            if lead_spin:
                for _ in range(COUNTED_LEAD_SPINS):
                    torch.cuda._sleep(SPIN_CYCLES // 2)
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            if lead_spin:
                torch.cuda._sleep(SPIN_CYCLES // 10)
                torch.cuda.synchronize()
        kernels = device_kernels(prof)
        if lead_spin:
            kernels = [k for k in kernels if "spin_kernel" not in k["kernel"]]
        if kernels:
            if trace is not None:
                trace.extend(k for k in trace_kernels(prof) if not (lead_spin and k["spin"]))
            return wall_ms, kernels
        log(f"the profiler saw no device time in {what} (attempt {attempt} of {PROFILE_TRIES})")
    fail(f"the profiler saw no device time in {what} in {PROFILE_TRIES} attempts")


def device_ms(fn, reps: int, match: str = "") -> float:
    """Device time of one call (every kernel it launches whose name holds
    ``match``, summed; host launch overhead excluded), from torch.profiler
    over ``reps`` eager calls: the fuller of two windows, since a window
    now and then misses device time and never adds any.  For the plain
    versions and for library calls a graph cannot capture."""
    fn()

    def run():
        for _ in range(reps):
            fn()

    best = 0.0
    for _ in range(2):
        _, kernels = profiled(run, f"{reps} calls ({match or 'all kernels'})")
        best = max(best, sum(k["ms"] for k in kernels if match in k["kernel"]))
    check(best > 0, f"no kernel named {match!r} ran")
    return best / reps


def capture(fn, reps: int):
    """``reps`` back-to-back calls of ``fn`` captured as one CUDA graph,
    after an eager call, and replayed once to warm it."""
    import torch

    fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


# A timed replay starts behind a spin kernel of this many cycles (about
# 5 ms on the H100), which outlasts the host's launch of the graph (under
# 1 ms for 200 nodes with the profiler on, on the H100): the graph's first
# kernel then starts as the start event completes, and its kernels run
# back to back, as a decode chunk's replay runs them
SPIN_CYCLES = 10_000_000


def replay(graph) -> float:
    """One replay of ``graph`` behind the spin kernel, timed between two
    CUDA events (ms)."""
    import torch

    torch.cuda._sleep(SPIN_CYCLES)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def graph_ms(fn, reps: int) -> float:
    """A call's share of one replay of ``reps`` back-to-back calls: the
    library calls' time, read as the kernels' is."""
    graph = capture(fn, reps)
    ms = replay(graph) / reps
    del graph
    return ms


# Each kernel row is read READINGS times by each method, in turns; the
# spread of a method is (max - min) / median of its readings
READINGS = 3


def spread_of(xs) -> float:
    return (max(xs) - min(xs)) / float(np.median(xs))


# On the H100 a profiler window loses the records of the kernels that
# start in its first milliseconds, more of them the later in the process
# (up to 13 of a replay's 100 behind a 5 ms spin, in every window alike;
# the spin itself in another run).  So a window opens with a spin of this
# many SPIN_CYCLES, replays the graph twice, each behind its own spin, and
# ends with a short spin; the profiler reads the last replay that spins
# bracket on both sides (the second, unless a spin's record was lost).
LEAD_SPINS = 4


def bracketed(trace: list[dict]) -> list[list[dict]]:
    """The kernels between each two consecutive spin kernels of a
    profiled trace."""
    segs, cur = [], None
    for k in trace:
        if k["spin"]:
            if cur is not None:
                segs.append(cur)
            cur = []
        elif cur is not None:
            cur.append(k)
    return segs


def profiled_replay(graph) -> None:
    """A profiler window's work: the lead spin, two replays, a short spin."""
    import torch

    torch.cuda._sleep(LEAD_SPINS * SPIN_CYCLES)
    replay(graph)
    replay(graph)
    torch.cuda._sleep(SPIN_CYCLES // 10)


def replay_readings(fn, reps: int, matches: tuple[str, ...] = ("",), bound: float = 0.0,
                    call_bound: float = 0.0) -> dict:
    """A row's two readings of one CUDA graph of ``reps`` back-to-back
    calls, READINGS times each, in turns: the replay between CUDA events
    (``call_ms``, the reading of record), and torch.profiler over the
    same replay (``profiler_call_ms``: its kernels' span, first start to
    last end, in the last replay of a window that spins bracket; the
    kernels' names and launches).  A window whose replay holds a count of
    kernels that is not a whole number a call, or fewer than the fullest
    window's, is short: counted, and left out of the profiler's median;
    the run fails when most are short.
    ``ms[m]`` is a call's time times the share of the call's device time
    the kernels named ``m`` take (1 where the call is that kernel alone).
    ``bound`` is the row's kernel's and ``call_bound`` the whole call's
    (``bound`` when 0)."""
    graph = capture(fn, reps)
    events, windows, counts = [], [], []
    for _ in range(READINGS):
        events.append(replay(graph) / reps)
        trace = []
        profiled(lambda: profiled_replay(graph), f"2 replays of {reps} calls", trace=trace)
        segs = bracketed(trace)
        counts.append([len(sg) for sg in segs])
        windows.append(segs[-1] if segs else [])
    del graph
    whole = [w for w in windows if w and len(w) % reps == 0]
    full = max((len(w) for w in whole), default=0)
    kept = [w for w in whole if len(w) == full]
    if any(len(c) != 3 or c[1] != c[2] for c in counts):
        log(f"profiler: kernels between spins in each window of {reps} calls: {counts}")
    check(len(kept) > READINGS // 2, f"the profiler saw short replays in "
          f"{READINGS - len(kept)} of {READINGS} windows (kernels a replay {counts})")
    span = [(max(k["start"] + k["ms"] for k in w) - min(k["start"] for k in w)) / reps
            for w in kept]
    busy = [sum(k["ms"] for k in w) for w in kept]
    share = {m: float(np.median([sum(k["ms"] for k in w if m in k["kernel"]) / b
                                 for w, b in zip(kept, busy)])) for m in matches}
    g, s = float(np.median(events)), float(np.median(span))
    names, launches, attrs = {}, {m: set() for m in matches}, {}
    for k in kept[0]:
        names[k["kernel"]] = names.get(k["kernel"], 0) + 1
        for m in matches:
            if m in k["kernel"]:
                launches[m].add(k["launch"])
                attrs.setdefault(m, {a: k[a] for a in ("threads", "smem", "registers")})
    return {"call_ms": g, "profiler_call_ms": s, "bound_ms": bound,
            "call_bound_ms": call_bound or bound,
            "ms": {m: g * share[m] for m in matches},
            "profiler_ms": {m: s * share[m] for m in matches},
            "graph_spread": spread_of(events), "profiler_spread": spread_of(span),
            "kernels_a_call": full / reps, "short_windows": READINGS - len(kept),
            "kernels": names, "launches": launches, "attrs": attrs, "reps": reps}


# the per-call fields of a reading that the kernels line keeps
CALL_FIELDS = ("call_ms", "profiler_call_ms", "bound_ms", "call_bound_ms", "graph_spread",
               "profiler_spread", "kernels_a_call", "short_windows", "reps")


def reading_fields(pairs, match: str = "", bound: float | None = None) -> dict:
    """The kernels line's reading fields of a row made of one or more
    calls, as (weight, reading) pairs: ``ms`` the replay's (the kernels
    named ``match``: their share of the call), ``profiler_ms`` the
    profiler's beside it (weighted means), and each call's readings
    (``calls``, with the row's kernel ``bound`` where given), which
    ``check_readings`` holds."""
    tot = sum(w for w, _ in pairs)
    calls = [{**{k: r[k] for k in CALL_FIELDS}, "ms": r["ms"][match],
              "profiler_ms": r["profiler_ms"][match], "weight": w} for w, r in pairs]
    for c in calls:
        c["bound_ms"] = c["bound_ms"] if bound is None else bound
    return {"ms": sum(w * r["ms"][match] for w, r in pairs) / tot,
            "profiler_ms": sum(w * r["profiler_ms"][match] for w, r in pairs) / tot,
            "calls": calls}


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
    "flash_fwd_fp32_tile_kernel": "float32, register micro-tiles, 64- or 32-row query tiles",
}


def k1_kernel(kernels: list[dict]) -> str:
    """The one K1 kernel among a profiled call's device kernels."""
    names = {n for k in kernels for n in K1_KERNELS if n in k["kernel"]}
    check(len(names) == 1, f"one K1 kernel a call expected, the profiler saw {sorted(names)}")
    return names.pop()


def phase_k1(dev):
    """K1 against mha_reference: the serve-prefill shapes (1 x 16 heads),
    the train shape and edge cases on its grid, float32.  Each call runs
    under torch.profiler, which names the kernel that ran and, for
    float32, the query tile it took (checked against the grid rule, both
    tiles held); every kernel of flash_fwd.cu must be held here."""
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
        (1, 16, 512, 512, 128, torch.float32, True, 0),  # fp32 D 128: phase 17's longest
        (1, 16, 512, 512, 128, torch.float32, True, 100),  # fp32, a window ending mid-tile
        (1, 2, 129, 200, 128, torch.float32, True, 0),  # fp32, one row past two tiles
        (1, 2, 1, 65, 64, torch.float32, True, 0),  # fp32, Sq 1
        (1, 8, 200, 333, 64, torch.float32, False, 0),  # fp32, not causal at D 64
        (4, 34, 200, 300, 128, torch.float32, True, 100),  # fp32 on 64-row tiles: window, Sq < Sk
        (4, 16, 512, 512, 64, torch.float32, False, 0),  # fp32 on 64-row tiles at D 64
    ]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst, ran, tiles = 0.0, set(), set()
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
        full = next(k["kernel"] for k in kernels if kern in k["kernel"])  # template arguments
        if dt == torch.float32:
            # 32-row query tiles where 64-row tiles give under two blocks an SM
            rows = 32 if B * H * -(-sq // 64) < 2 * sms else 64
            check(f"{kern}<{D}, {rows}>" in full,
                  f"K1 float32 at {(B, H, sq, sk, D)} ran {full[:80]}, not {rows}-row tiles")
            tiles.add(rows)
        ref, ref_lse = mha_reference(q, k, v, causal, None, window)
        name = "bfloat16" if dt == torch.bfloat16 else "float32"
        e, el = maxerr(out, ref), maxerr(lse, ref_lse)
        ok = close(out, ref, name) and el <= 1e-4
        log(f"K1 B={B} H={H} Sq={sq} Sk={sk} D={D} {name} causal={causal} "
            f"window={window}: {full[:120]} ({K1_KERNELS[kern]}) max|out-ref|={e:.3g} "
            f"(tol {TOL[name]} + {RTOL[name]}|ref|) max|lse-ref|={el:.3g} (tol 1e-4)")
        check(ok, f"K1 disagrees with mha_reference at {(B, H, sq, sk, D, name, window)}")
        if B == 1 and dt == torch.bfloat16 and window == 0 and sq == sk:
            worst = max(worst, e)
    check(ran == set(K1_KERNELS), f"K1 cases ran {sorted(ran)}, not every kernel of flash_fwd.cu")
    check(tiles == {32, 64}, f"K1 float32 cases ran query tiles {sorted(tiles)}, not 32 and 64")
    return worst


def check_repeatable(q, k, v, do) -> None:
    """K1 and K4 at the train shape, K3 with its keys split (the path's
    8 queries on 1024 keys) and K2 over dense and int8 pools with their
    pages split (the engines' shapes) called twice on the same bf16 inputs
    give identical bytes (no atomics; every sum and merge in a fixed order)."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.ops.attention import (
        flash_attention,
        flash_backward,
        flash_block_stats,
    )
    from elastic_gpu_scheduler_tpu_torch.ops.paged_attention import paged_attention

    dev = q.device
    g = torch.Generator(device=dev).manual_seed(10)
    q3 = torch.randn(1, 16, 8, 128, generator=g, device=dev).to(torch.bfloat16)
    k3, v3 = (torch.randn(1, 8, 1024, 128, generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    B, NB, ps = 8, 64, 16
    n_pages = B * NB + 1
    pk, sk = int8_pool(g, n_pages, ps, 8, 128, dev)
    pv, sv = int8_pool(g, n_pages, ps, 8, 128, dev)
    dk_, dv_ = (torch.randn(n_pages, ps, 8, 128, generator=g, device=dev).to(torch.bfloat16)
                for _ in range(2))
    tables = (torch.randperm(n_pages - 1, generator=g, device=dev)[: B * NB] + 1)
    tables = tables.reshape(B, NB).to(torch.int32)
    lengths = k2_lengths(B, NB, ps, 1, dev, [0, 15, 255, 256, 511, 700, 900])
    q2 = torch.randn(B, 16, 128, generator=g, device=dev).to(torch.bfloat16)
    runs = []
    for _ in range(2):
        out, lse = flash_attention(q, k, v, True, None, 0, return_lse=True)
        runs.append((out, lse) + flash_backward(q, k, v, out, lse, do, True, None, 0)
                    + flash_block_stats(q3, k3, v3, 1016, 0)
                    + (paged_attention(q2, dk_, dv_, tables, lengths),
                       paged_attention(q2, pk, pv, tables, lengths, scales_k=sk, scales_v=sv)))
    torch.cuda.synchronize()
    names = ("K1 out", "K1 lse", "K4 dq", "K4 dk", "K4 dv", "K3 pv", "K3 m", "K3 l", "K2",
             "K2-int8")
    same = {n: bool(torch.equal(a, b)) for n, a, b in zip(names, *runs)}
    log(f"K1 + K4 at {tuple(q.shape)}, K3 (8 x 1024 keys, split) and K2 / K2-int8 (B 8, "
        f"NB 64, split) bitwise repeatable, bf16: {same}")
    check(all(same.values()), "K1 / K2 / K3 / K4 differ between two calls on the same inputs")


# -- phase 4: K2 -----------------------------------------------------------


def kernels_ran(fn, pattern: str, what: str) -> set:
    """Names matching ``pattern`` of the kernels one call of ``fn``
    launched, read from torch.profiler."""
    _, kernels = profiled(fn, what)
    return {m.group(0) for k in kernels if (m := re.search(pattern, k["kernel"]))}


K2_PATTERN = r"paged_attn_\w*kernel"


def k2_splits(q, Hkv, NB) -> int:
    """Splits of the table K2 takes for q (from the kernel's own plan)."""
    from elastic_gpu_scheduler_tpu_torch.ops import _build

    W = 1 if q.ndim == 3 else q.shape[1]
    B, Hn, Dh = q.shape[0], q.shape[-2], q.shape[-1]
    words = _build.lib().egs_paged_attention_workspace(B, W, Hn, Hkv, Dh, NB)
    return words // (B * W * Hn * (Dh + 2)) if words else 1


def k2_lengths(B, NB, ps, W, dev, lens):
    """``lens`` (clipped to the table) for the first B - 1 rows, and the
    last row at NB * ps - W, the verify window on the table's last slot."""
    import torch

    top = NB * ps - W
    return torch.tensor([min(x, top) for x in lens[:B - 1]] + [top], dtype=torch.int32,
                        device=dev)


def check_k2_call(q, pools, tables, lengths, window, scales, name, label) -> tuple[float, set]:
    """One K2 call against its plain version; the kernels that ran must be
    the split kernel, plus the combine kernel exactly when the plan splits."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_reference,
    )

    kw = dict(window=window, scales_k=scales[0], scales_v=scales[1])
    res = []
    names = kernels_ran(lambda: res.append(paged_attention(q, *pools, tables, lengths, **kw)),
                        K2_PATTERN, label)
    out = res[-1]
    torch.cuda.synchronize()
    ref = paged_attention_reference(q, *pools, tables, lengths, **kw)
    e = maxerr(out, ref)
    splits = k2_splits(q, pools[0].shape[2], tables.shape[1])
    want = {"paged_attn_kernel"} | ({"paged_attn_combine_kernel"} if splits > 1 else set())
    log(f"{label}: {splits} split(s), kernels {sorted(names)}, max|out-ref|={e:.3g} "
        f"(tol {TOL[name]} + {RTOL[name]}|ref|)")
    check(names == want, f"{label}: ran {sorted(names)}, want {sorted(want)}")
    check(close(out, ref, name), f"K2 disagrees with paged_attention_reference at {label}")
    return e, names


def phase_k2(dev):
    """Dense K2 at the engine's shapes (B 8, 16q/8kv, Dh 128, page 16): its
    table width NB 40 and the prefix engine's 64 (pages split across
    blocks) and NB 4 (one split); rows at 0, on pages, on both sides of a
    split's edge and at NB * ps - W; W 1 and 4, window 0 and 256."""
    import torch

    g = torch.Generator(device=dev).manual_seed(2)
    B, Hn, Hkv, Dh, ps = 8, 16, 8, 128, 16
    worst, routes = 0.0, set()
    for NB in (40, 64, 4):
        n_pages = B * NB + 1
        tables = (torch.randperm(n_pages - 1, generator=g, device=dev)[: B * NB] + 1)
        tables = tables.reshape(B, NB).to(torch.int32)
        for dt in (torch.bfloat16, torch.float32):
            name = "bfloat16" if dt == torch.bfloat16 else "float32"
            pk = torch.randn(n_pages, ps, Hkv, Dh, generator=g, device=dev).to(dt)
            pv = torch.randn(n_pages, ps, Hkv, Dh, generator=g, device=dev).to(dt)
            for W in (1, 4):
                lengths = k2_lengths(B, NB, ps, W, dev, [0, 16, 127, 128, 255, 256, 511])
                for window in (0, 256):
                    q = torch.randn(B, W, Hn, Dh, generator=g, device=dev).to(dt)
                    if W == 1:
                        q = q[:, 0]  # rank 3: plain decode
                    e, names = check_k2_call(q, (pk, pv), tables, lengths, window, (None, None),
                                             name, f"K2 NB={NB} W={W} window={window} {name}")
                    routes |= names
                    if dt == torch.bfloat16 and W == 1 and window == 0 and NB == 40:
                        worst = max(worst, e)
    check(routes == {"paged_attn_kernel", "paged_attn_combine_kernel"},
          f"K2 cases ran {sorted(routes)}, not both kernels of paged_attention.cu")
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
    Dh 128, page 16, 64 pages a row: max_len 1024) and at NB 41 (a last
    split of one page), W 1 and 4, window 0 and 256."""
    import torch

    g = torch.Generator(device=dev).manual_seed(8)
    B, Hn, Hkv, Dh, ps = 8, 16, 8, 128, 16
    worst = 0.0
    for NB in (64, 41):
        n_pages = B * NB + 1
        pk, sk = int8_pool(g, n_pages, ps, Hkv, Dh, dev)
        pv, sv = int8_pool(g, n_pages, ps, Hkv, Dh, dev)
        tables = (torch.randperm(n_pages - 1, generator=g, device=dev)[: B * NB] + 1)
        tables = tables.reshape(B, NB).to(torch.int32)
        for dt in (torch.bfloat16, torch.float32):
            name = "bfloat16" if dt == torch.bfloat16 else "float32"
            for W in (1, 4):
                lengths = k2_lengths(B, NB, ps, W, dev, [0, 15, 255, 256, 511, 700, 900])
                for window in (0, 256):
                    q = torch.randn(B, W, Hn, Dh, generator=g, device=dev).to(dt)
                    if W == 1:
                        q = q[:, 0]
                    e, _ = check_k2_call(q, (pk, pv), tables, lengths, window, (sk, sv), name,
                                         f"K2-int8 NB={NB} W={W} window={window} {name}")
                    if dt == torch.bfloat16 and W == 1 and window == 0 and NB == 64:
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
    (1, 4, 2, 64, 1000, 64, 0, 300, True),  # no-key rows over several splits, ragged Sk
    (1, 16, 8, 33, 700, 128, 600, 0, True),  # the diagonal mid-tile, a 1-row last tile
    (1, 32, 4, 40, 600, 64, 500, 0, True),  # n_rep 8: a warp spans two heads
    (1, 6, 2, 50, 300, 128, 200, 0, True),  # n_rep 3: a padding row in each block
    (1, 16, 8, 64, 64, 128, 0, 0, True),  # one key tile: no split
]
K3_PATTERN = r"flash_stats_kernel\w*"


def phase_k3(dev):
    """K3 at the path's shapes (bf16, 16q/8kv, Dh 128) and the edge cases
    (fp32 and bf16); returns the worst bf16 error at the path's shapes."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.ops import _build
    from elastic_gpu_scheduler_tpu_torch.ops.attention import flash_block_stats

    g = torch.Generator(device=dev).manual_seed(9)
    worst, routes = 0.0, set()
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
            names = kernels_ran(lambda: flash_block_stats(q, k, v, q_off, k_off, causal),
                                K3_PATTERN, f"K3 at {label}")
            splits = _build.lib().egs_flash_block_stats_splits(
                B, H, Hkv, sq, sk, int(dt == torch.bfloat16), int(causal), q_off, k_off)
            if dt == torch.float32:
                want = {"flash_stats_kernel"}
            else:
                want = {"flash_stats_kernel_bf16"} | (
                    {"flash_stats_kernel_combine"} if splits > 1 else set())
            log(f"K3 {label}: {splits} split(s), kernels {sorted(names)}")
            check(names == want, f"K3 at {label} ran {sorted(names)}, want {sorted(want)}")
            routes |= names
            e = check_k3(q, k, v, q_off, k_off, causal, label)
            if (B, H, Hkv, D) == (1, 16, 8, 128) and k_off == 0 and dt == torch.bfloat16:
                worst = max(worst, e)
    check(routes == {"flash_stats_kernel", "flash_stats_kernel_bf16",
                     "flash_stats_kernel_combine"},
          f"K3 cases ran {sorted(routes)}, not every kernel of flash_stats.cu")
    # the prefix engine's layout, read where it lies: (B, T, H, D) queries
    # and a (B, M, Hkv, D) cache through transposes, as bytes of a copy
    qr = torch.randn(1, 128, 16, 128, generator=g, device=dev).to(torch.bfloat16)
    kr, vr = (torch.randn(1, 512, 8, 128, generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    views = (qr.transpose(1, 2), kr.transpose(1, 2), vr.transpose(1, 2))
    got = flash_block_stats(*views, 300, 0)
    want = flash_block_stats(*(t.contiguous() for t in views), 300, 0)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "K3 on transposed views differs from K3 on their contiguous copies")
    log("K3 on the prefix engine's transposed views: identical bytes to contiguous copies")
    return worst


# -- phase 6: the engine ---------------------------------------------------


FULL = dict(vocab_size=32000, d_model=2048, n_layers=16, n_heads=16, n_kv_heads=8,
            d_ff=6912, dtype="bfloat16")
PROMPT_LENS = [64, 128, 256, 512, 64, 128, 256, 512, 96, 200, 400, 70]
NEW_TOKENS = 64
ENGINE = dict(max_batch=8, max_len=640, page_size=16, fused_steps=16)


def drive(eng, prompts, max_new, fields=None):
    """run_until_idle with host timers: (requests, prefill s, step s).
    ``fields``: each request's extra ``Request`` fields."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models.serving import Request

    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=max_new, **kw))
            for p, kw in zip(prompts, fields or [{}] * len(prompts))]
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


def full_model(dev):
    """The full-width dense model's weights (seed 0), config and the 12
    serve-bench prompts (seed 11)."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig, init_params

    cfg = TransformerConfig(**FULL)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(11)
    return params, cfg, [rng.integers(0, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]


def phase_engine(dev):
    import torch

    from elastic_gpu_scheduler_tpu_torch.models import serving
    from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine
    from elastic_gpu_scheduler_tpu_torch.models.transformer import param_count
    from elastic_gpu_scheduler_tpu_torch.ops import _build

    params, cfg, prompts = full_model(dev)
    log(f"engine: {param_count(params) / 1e9:.3f}B parameters, "
        f"{cfg.n_layers} layers, d={cfg.d_model}, {cfg.n_heads}q/{cfg.kv_heads}kv heads, "
        f"{cfg.dtype}")

    # the sequential loop, as in every run before phase 6c existed
    eng = InferenceEngine(params, cfg, paged_kernel=True, overlap=False, device=dev, **ENGINE)
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
    geng = InferenceEngine(params, cfg, paged_kernel=False, overlap=False, device=dev,
                           **ENGINE)
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
    small, sp = small_fp32()
    outs = {str(where): small_tokens(sp, small, where, SMALL_PROMPTS, overlap=False)[0]
            for where in ("cpu", dev)}
    check(outs["cpu"] == outs[str(dev)], "float32 greedy tokens differ between card and CPU")
    log(f"small float32 engine: greedy tokens identical on card and CPU "
        f"({sum(map(len, outs['cpu']))} tokens)")
    return eng, prompts, reqs, launches, sampler, perf


# -- phase 6b: the prefix-cached, chunked, int8-KV engine --------------------


PREFIX_ENGINE = dict(kv_int8=True, prefix_cache=True, prefill_chunk=128, paged_kernel=True,
                     max_batch=8, max_len=1024, page_size=16, fused_steps=16, overlap=False)
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
    # clone() keeps the strides: K3 is timed on the path's transposed views
    k3_sampler = CallSampler(lambda q, k, v, q_off, k_off, causal=True: (
        q.clone(), k.clone(), v.clone(), int(q_off), int(k_off), causal), every=67)
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
              fused_steps=8, overlap=False)
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


# -- phase 6c: the overlapped engine ------------------------------------------


# consecutive chunks in the profiled window of the overlapped engine (one
# chunk cannot show overlap)
OVERLAP_WINDOW = 6


def drive_wall(eng, prompts, max_new):
    """The engine's own loop (``run_until_idle``: no host timer and no
    synchronise between steps, so an overlapped engine keeps a chunk in
    flight): (requests, wall s, chunks run)."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models.serving import Request

    torch.cuda.synchronize()
    steps0 = eng.steps_run
    t0 = time.perf_counter()
    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=max_new)) for p in prompts]
    eng.run_until_idle(max_steps=100_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reqs:
        check(r.done.is_set() and not r.error, f"request failed: {r.error!r}")
        check(len(r.output) == max_new, f"request gave {len(r.output)} tokens, not {max_new}")
    return reqs, wall, eng.steps_run - steps0


def agreement(reqs, ref_reqs) -> dict:
    """First tokens equal (a count) and tokens equal at equal positions."""
    return {"first_tokens_equal": sum(a.output[0] == b.output[0]
                                      for a, b in zip(reqs, ref_reqs)),
            "tokens_equal": sum(x == y for a, b in zip(reqs, ref_reqs)
                                for x, y in zip(a.output, b.output)),
            "tokens": sum(len(a.output) for a in reqs),
            "common_prefix": [common_prefix(a.output, b.output)
                              for a, b in zip(reqs, ref_reqs)]}


def phase_overlap_engine(dev, seq_eng, prompts, seq_reqs) -> dict:
    """The overlapped engine (``overlap=True``, each decode chunk a CUDA
    graph replay) on phase 6's weights and prompts: a warm-up batch that
    captures the graphs, then the timed batch, beside phase 6's sequential
    engine driven the same way; exact launch counts; tokens against phase
    6's; a profiled window of consecutive chunks; one replay against one
    eager chunk from cloned state; float32 tokens against the CPU's."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine
    from elastic_gpu_scheduler_tpu_torch.ops import _build

    params, cfg = seq_eng.params, seq_eng.cfg
    L, K = cfg.n_layers, ENGINE["fused_steps"]
    eng = InferenceEngine(params, cfg, paged_kernel=True, device=dev, **ENGINE)
    check(eng.overlap, "the engine's default should be overlap=True")
    _, warm_s, warm_chunks = drive_wall(eng, prompts, NEW_TOKENS)
    captured, capture_s = eng.graphs_captured, eng.graph_capture_s
    check(captured > 0, "the warm-up batch captured no CUDA graph")
    log(f"overlap warm-up batch: {warm_chunks} chunks in {warm_s:.2f} s, {captured} graphs "
        f"captured in {capture_s:.2f} s (keys {sorted(eng.graph_keys())})")
    base = dict(warmups=eng.graph_warmups, replays=eng.graph_replays,
                uploads=eng.device_uploads, prefills=eng.prefills_run,
                discarded=eng.chunks_discarded, gaps=(eng.host_gap_ns, eng.host_gap_chunks))
    eng.drain_host_gaps()
    torch.cuda.synchronize()
    # the main path: counts at 0 just before, read just after
    _build.reset_launches()
    reqs, wall, chunks = drive_wall(eng, prompts, NEW_TOKENS)
    launches = dict(_build.LAUNCHES)
    warmups = eng.graph_warmups - base["warmups"]
    replays = eng.graph_replays - base["replays"]
    prefills = eng.prefills_run - base["prefills"]
    want_k2 = L * K * (chunks + warmups)
    log(f"overlap engine main path: {chunks} chunks ({replays} graph replays, {warmups} "
        f"captures), {prefills} prefills, launches {launches} (want paged_attention="
        f"{want_k2}, flash_fwd={L * prefills})")
    check(replays == chunks, "a decode chunk of the overlapped engine was not a graph replay")
    check(launches["paged_attention"] == want_k2 > 0,
          "K2 launches != layers x fused_steps x (chunks + captures' warm-ups)")
    check(launches["flash_fwd"] == L * prefills > 0, "K1 launches != layers x prefills")
    check(launches["paged_attention_int8"] == launches["flash_block_stats"] == 0,
          "the dense overlapped engine launched the int8 K2 or K3")
    gaps = eng.drain_host_gaps()
    gen = sum(len(r.output) for r in reqs)
    # phase 6's sequential engine, the same prompts, the same loop
    seq_gap0 = (seq_eng.host_gap_ns, seq_eng.host_gap_chunks)
    sreqs, swall, schunks = drive_wall(seq_eng, prompts, NEW_TOKENS)
    seq_gap_ms = ((seq_eng.host_gap_ns - seq_gap0[0]) / 1e6
                  / max(1, seq_eng.host_gap_chunks - seq_gap0[1]))
    agree = agreement(reqs, seq_reqs)
    check(agree["first_tokens_equal"] == len(prompts),
          "overlapped and sequential engines differ in first tokens")
    repeat = agreement(sreqs, seq_reqs)
    perf = {
        "overlap": {"wall_s": wall, "generated_tokens": gen, "tokens_per_s": gen / wall,
                    "chunks": chunks, "wall_ms_per_chunk": wall / chunks * 1e3,
                    "host_gap": eng.host_gap_stats(),
                    "host_gap_samples": {"n": len(gaps), "zero": sum(g == 0.0 for g in gaps),
                                         "mean_ms": float(np.mean(gaps)) if gaps else 0.0,
                                         "max_ms": max(gaps) if gaps else 0.0},
                    "device_uploads_per_chunk": (eng.device_uploads - base["uploads"]) / chunks,
                    "chunks_discarded": eng.chunks_discarded - base["discarded"],
                    "graphs_captured": captured, "graph_capture_s": capture_s},
        "sequential": {"wall_s": swall, "tokens_per_s": gen / swall, "chunks": schunks,
                       "wall_ms_per_chunk": swall / schunks * 1e3,
                       "host_gap_mean_ms": seq_gap_ms},
        "vs_phase6_tokens": agree,
        "sequential_rerun_vs_phase6_tokens": repeat,
    }
    log("overlap engine perf: " + json.dumps(perf))
    log(f"overlap vs sequential (same prompts, same loop): {gen / wall:.1f} vs "
        f"{gen / swall:.1f} tokens/s, {wall / chunks * 1e3:.2f} vs {swall / schunks * 1e3:.2f} "
        f"wall ms a chunk; tokens equal to phase 6's: {agree['tokens_equal']}/{agree['tokens']}")
    perf["profile"] = phase_overlap_profile(eng, prompts)
    phase_graph_vs_eager(eng, prompts)
    phase_overlap_small_fp32(dev)
    del eng
    return perf


def overlap_batch(eng, prompts, window) -> None:
    """A full batch on the overlapped engine: prefills, two steps (so a
    chunk is in flight), then ``window()``, then the rest of the batch."""
    from elastic_gpu_scheduler_tpu_torch.models.serving import Request

    n = OVERLAP_WINDOW + 2
    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=n * eng.fused_steps))
            for p in prompts[: eng.max_batch]]
    eng._admit()  # the prefills, outside the window
    eng.step()
    eng.step()
    cap0 = eng.graphs_captured
    window()
    check(eng.graphs_captured == cap0, "a graph was captured inside the measured window")
    eng.run_until_idle()
    check(all(r.done.is_set() and not r.error for r in reqs), "window requests failed")


def phase_overlap_profile(eng, prompts) -> dict:
    """OVERLAP_WINDOW consecutive steps of the overlapped engine with a
    full batch, twice: unprofiled, with host timers around the graph
    launches (``graph.replay``) and the drains (the wait for the previous
    chunk's tokens, then their emission); then under torch.profiler: the
    device's idle share over the window, device time by kernel, and the
    uploads the window made."""
    import torch

    host = {"replay": [], "drain": []}

    def timed(name, fn):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            host[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    def steps():
        for _ in range(OVERLAP_WINDOW):
            eng.step()

    span = {}

    def timed_steps():
        eng._replay_chunk = timed("replay", eng._replay_chunk)
        eng._drain_chunk = timed("drain", eng._drain_chunk)
        try:
            t0 = time.perf_counter()
            steps()
            torch.cuda.synchronize()
            span["wall_ms"] = (time.perf_counter() - t0) * 1e3
        finally:
            del eng._replay_chunk, eng._drain_chunk

    overlap_batch(eng, prompts, timed_steps)
    unprofiled = {"wall_ms_per_chunk": span["wall_ms"] / OVERLAP_WINDOW,
                  "replay_host_ms": float(np.mean(host["replay"])),
                  "drain_host_ms": float(np.mean(host["drain"]))}
    unprofiled["other_host_ms"] = (unprofiled["wall_ms_per_chunk"] - unprofiled["replay_host_ms"]
                                   - unprofiled["drain_host_ms"])
    res = {}

    def profiled_steps():
        up0 = eng.device_uploads
        res["wall_ms"], res["kernels"] = profiled(steps, f"{OVERLAP_WINDOW} overlapped chunks",
                                                  cpu=True)
        res["uploads"] = eng.device_uploads - up0

    overlap_batch(eng, prompts, profiled_steps)
    wall_ms, kernels = res["wall_ms"], res["kernels"]
    busy = sum(k["ms"] for k in kernels)
    out = {"window": f"{OVERLAP_WINDOW} consecutive overlapped steps ({eng.fused_steps} decode "
                     f"iterations each, batch {eng.max_batch})",
           "wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
           "wall_ms_per_chunk": wall_ms / OVERLAP_WINDOW,
           "busy_ms_per_chunk": busy / OVERLAP_WINDOW,
           "launches": sum(k["count"] for k in kernels), "uploads": res["uploads"],
           "unprofiled": unprofiled, "top": kernels[:25]}
    log(json.dumps({"overlap_profile": out}))
    log(f"overlap profile: {OVERLAP_WINDOW} chunks, wall {wall_ms:.2f} ms, device busy "
        f"{busy:.2f} ms (idle share {out['idle_share']:.3f}), {res['uploads']} uploads, "
        f"{out['launches']} kernel launches; unprofiled: {unprofiled['wall_ms_per_chunk']:.2f} "
        f"wall ms a chunk, of which {unprofiled['replay_host_ms']:.2f} in the graph launch, "
        f"{unprofiled['drain_host_ms']:.2f} in the drain, {unprofiled['other_host_ms']:.2f} "
        f"elsewhere on the host")
    for k in kernels[:12]:
        log(f"  {k['ms']:9.3f} ms  x{k['count']:5d}  {k['kernel']}")
    return out


def phase_graph_vs_eager(eng, prompts) -> None:
    """One graph replay of the decode chunk and one eager
    ``_chunk_in_place`` on the same inputs, from cloned identical state
    (pool and carry): identical sampled tokens, carry and pool bytes."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models import serving

    reqs = [eng.submit(serving.Request(prompt=list(p), max_new_tokens=4 * eng.fused_steps))
            for p in prompts[: eng.max_batch]]
    eng._admit()
    eng.step()
    eng._drain_pending()
    seen = []
    real = eng._replay_chunk

    def spy(key, args, static):
        seen.append((args, static, {k: v.clone() for k, v in args[1].items()},
                     args[3].clone(), args[4].clone()))
        return real(key, args, static)

    eng._replay_chunk = spy
    captured = eng.graphs_captured
    try:
        pending = eng._dispatch_chunk()
    finally:
        del eng._replay_chunk
    torch.cuda.synchronize()
    check(len(seen) == 1 and eng.graphs_captured == captured,
          "the compared dispatch was not a replay of a captured graph")
    args, static, kv0, tok0, len0 = seen[0]
    eager = list(args)
    eager[1], eager[3], eager[4] = kv0, tok0, len0
    out = serving._chunk_in_place(*eager, **static)
    torch.cuda.synchronize()
    same_pool = all(torch.equal(kv0[n], eng.kv[n]) for n in eng.kv)
    log(f"graph replay vs eager chunk (bf16, {static['n_steps']} steps, batch "
        f"{out.shape[0]}): tokens identical {torch.equal(out, pending.out)}, carry identical "
        f"{torch.equal(tok0, args[3]) and torch.equal(len0, args[4])}, pool bytes identical "
        f"{same_pool}")
    check(torch.equal(out, pending.out), "graph replay and eager chunk sampled differently")
    check(torch.equal(tok0, args[3]) and torch.equal(len0, args[4]),
          "graph replay and eager chunk left different carries")
    check(same_pool, "graph replay and eager chunk wrote different pool bytes")
    eng._drain_chunk(pending)
    eng.run_until_idle()
    check(all(r.done.is_set() and not r.error for r in reqs), "compared requests failed")


_SMALL_RNG = np.random.default_rng(5)
SMALL_PROMPTS = [_SMALL_RNG.integers(0, 512, n).tolist() for n in (1, 5, 17, 40, 9, 64)]


def small_fp32():
    """The small float32 model of the card-against-CPU checks."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )

    small = TransformerConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=4,
                              n_kv_heads=2, d_ff=512, dtype="float32")
    return small, init_params(small, torch.Generator().manual_seed(3), "cpu")


def small_tokens(sp, small, where, prompts, max_new=24, **kw):
    from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine, Request

    se = InferenceEngine(sp, small, max_batch=4, max_len=128, page_size=16, fused_steps=8,
                         paged_kernel=True, device=where, **kw)
    rs = [se.submit(Request(prompt=list(q), max_new_tokens=max_new)) for q in prompts]
    se.run_until_idle()
    for r in rs:
        check(r.done.is_set() and not r.error, f"small engine request failed: {r.error}")
    return [r.output for r in rs], se


def phase_overlap_small_fp32(dev) -> None:
    """Small float32 model: ``overlap=True`` on the card (graph replays)
    gives the tokens of ``overlap=False`` on the CPU."""
    small, sp = small_fp32()
    cpu, _ = small_tokens(sp, small, "cpu", SMALL_PROMPTS, overlap=False)
    card, se = small_tokens(sp, small, dev, SMALL_PROMPTS, overlap=True)
    check(se.graph_replays == se.steps_run > 0, "the small overlapped engine replayed no graph")
    check(card == cpu, "float32 greedy tokens: overlap on the card differ from sequential CPU")
    log(f"small float32 engine: overlap=True on the card equals overlap=False on the CPU "
        f"({sum(map(len, cpu))} tokens, {se.graphs_captured} graphs)")


# -- phase 6d: speculative decoding -------------------------------------------


SPEC_K = 4  # bench.py's spec engine: W = 5
SPEC_PATH = "serve: spec_k 4 verify (W 5)"


def repetitive_prompts():
    """bench.py's acceptance prompts: the pattern cut to L % 48 + 16 over
    the serve prompts' lengths, where prompt lookup lands."""
    rep = [7, 3, 11, 5] * 16
    return [list(rep[: n % 48 + 16]) for n in PROMPT_LENS]


class VerifyCalls:
    """Wraps ``serving._paged_attn_call``: counts the calls with a W-query
    window (q of rank 4) and samples some of them."""

    def __init__(self, real, every: int, keep: int):
        self.real, self.n = real, 0
        self.sampler = k2_sampler(every=every, keep=keep)
        self._sampled = self.sampler.wrap(real)

    def __call__(self, q, *args):
        if q.ndim == 4:
            self.n += 1
            return self._sampled(q, *args)
        return self.real(q, *args)


def check_verify_samples(calls, name, label, width=SPEC_K + 1) -> float:
    """Sampled K2 calls (``name``'s pool; a W-query window, or width 1
    for plain decode) against ``paged_attention_reference``."""
    from elastic_gpu_scheduler_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_reference,
    )

    check(calls, f"no {label} call was sampled")
    worst = 0.0
    for q, lkv, tables, lengths, cfg in calls:
        kw = dict(window=cfg.window_size, scales_k=lkv.get("ks"), scales_v=lkv.get("vs"))
        out = paged_attention(q, lkv["k"], lkv["v"], tables, lengths, **kw)
        ref = paged_attention_reference(q, lkv["k"], lkv["v"], tables, lengths, **kw)
        e = maxerr(out, ref)
        worst = max(worst, e)
        w = 1 if q.ndim == 3 else q.shape[1]
        check(w == width, f"{label}: a sampled window of width {w}, not {width}")
        check(close(out, ref, "bfloat16"), f"{label}: {name} W={w} disagrees with "
              f"paged_attention_reference (max err {e:.3g})")
    log(f"{label}: {len(calls)} sampled W={width} {name} calls within tolerance of "
        f"paged_attention_reference (max err {worst:.3g}, tol {TOL['bfloat16']} + "
        f"{RTOL['bfloat16']}|ref|)")
    return worst


def spec_counts(eng, prev) -> dict:
    return {"passes": eng.spec_passes - prev["passes"],
            "accepted": eng.spec_accepted - prev["accepted"],
            "steps": eng.steps_run - prev["steps"],
            "warmups": eng.graph_warmups - prev["warmups"]}


def spec_marks(eng) -> dict:
    return {"passes": eng.spec_passes, "accepted": eng.spec_accepted,
            "steps": eng.steps_run, "warmups": eng.graph_warmups}


def phase_spec_engine(dev, params, cfg, prompts, seq_reqs):
    """Speculative decoding (``spec_k=4``, prompt lookup, paged kernel) on
    the full-width weights: the serve prompts (the main path: exact K2
    launches, W = 5 calls sampled and held to the plain version) and
    bench.py's repetitive prompts; an int8-KV, prefix-cached, chunked run
    whose W = 5 calls go through K2-int8 beside K3; a small random-init
    draft model at full vocabulary; and the small float32 identities."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models import serving
    from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine
    from elastic_gpu_scheduler_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from elastic_gpu_scheduler_tpu_torch.ops import _build

    L, K = cfg.n_layers, ENGINE["fused_steps"]
    eng = InferenceEngine(params, cfg, paged_kernel=True, spec_k=SPEC_K, device=dev, **ENGINE)
    real = serving._paged_attn_call
    verify = VerifyCalls(real, every=97, keep=8)
    serving._paged_attn_call = verify
    torch.cuda.synchronize()
    # the main path: counts at 0 just before, read just after
    _build.reset_launches()
    marks = spec_marks(eng)
    try:
        reqs, wall, _ = drive_wall(eng, prompts, NEW_TOKENS)
    finally:
        serving._paged_attn_call = real
    launches = dict(_build.LAUNCHES)
    c = spec_counts(eng, marks)
    chunks = c["steps"] - c["passes"]
    want = L * (c["passes"] + K * (chunks + c["warmups"]))
    log(f"spec engine main path: {c['passes']} verify passes, {chunks} decode chunks, "
        f"{verify.n} W={SPEC_K + 1} calls, launches {launches} (want paged_attention={want})")
    check(c["passes"] > 0 and verify.n == L * c["passes"],
          "W-query K2 calls != layers x verify passes")
    check(launches["paged_attention"] == want, "spec engine K2 launches differ from the path")
    gen = sum(len(r.output) for r in reqs)
    agree = agreement(reqs, seq_reqs)
    check(agree["first_tokens_equal"] == len(prompts),
          "speculative and sequential engines differ in first tokens")
    perf = {"random_prompts": {"wall_s": wall, "generated_tokens": gen,
                               "tokens_per_s": gen / wall, **c,
                               "accepted_per_pass": c["accepted"] / c["passes"],
                               "tokens_per_pass": gen / c["passes"],
                               "vs_phase6_tokens": agree}}
    err = check_verify_samples(verify.sampler.calls, "paged_attention", "spec engine")
    row = kernel_k2(verify.sampler, {"paged_attention": verify.n}, err)
    row["path"] = SPEC_PATH

    marks = spec_marks(eng)
    rreqs, rwall, _ = drive_wall(eng, repetitive_prompts(), NEW_TOKENS)
    c = spec_counts(eng, marks)
    rgen = sum(len(r.output) for r in rreqs)
    perf["repetitive_prompts"] = {"wall_s": rwall, "generated_tokens": rgen,
                                  "tokens_per_s": rgen / rwall, **c,
                                  "accepted_per_pass": c["accepted"] / max(1, c["passes"]),
                                  "tokens_per_pass": rgen / max(1, c["passes"])}
    for kind in ("random_prompts", "repetitive_prompts"):
        r = perf[kind]
        log(f"spec engine, {kind.replace('_', ' ')}: {r['tokens_per_s']:.1f} tokens/s, "
            f"spec_passes {r['passes']}, spec_accepted {r['accepted']}, "
            f"{r['accepted_per_pass']:.3f} accepted drafts and {r['tokens_per_pass']:.3f} "
            f"tokens a pass")
    del eng

    perf["int8_prefix_chunked"] = phase_spec_int8(dev, params, cfg)

    # a small random-init draft model at the full vocabulary
    dcfg = TransformerConfig(vocab_size=cfg.vocab_size, d_model=512, n_layers=4, n_heads=8,
                             d_ff=1376, dtype="bfloat16")
    dparams = init_params(dcfg, torch.Generator(device=dev).manual_seed(1), dev)
    deng = InferenceEngine(params, cfg, paged_kernel=True, spec_k=SPEC_K, draft=(dparams, dcfg),
                           device=dev, **ENGINE)
    marks = spec_marks(deng)
    dreqs, dwall, _ = drive_wall(deng, prompts, NEW_TOKENS)
    c = spec_counts(deng, marks)
    dagree = agreement(dreqs, seq_reqs)
    check(dagree["first_tokens_equal"] == len(prompts),
          "the draft-model engine differs from the target's first tokens")
    dgen = sum(len(r.output) for r in dreqs)
    perf["draft_model"] = {"draft": "D 512, L 4, 8 heads, V 32000, bf16, random init",
                           "wall_s": dwall, "tokens_per_s": dgen / dwall, **c,
                           "accepted_per_pass": c["accepted"] / max(1, c["passes"]),
                           "vs_phase6_tokens": dagree}
    log(f"draft-model engine: {dgen / dwall:.1f} tokens/s, spec_passes {c['passes']}, "
        f"spec_accepted {c['accepted']} ({perf['draft_model']['accepted_per_pass']:.3f} a "
        f"pass); first tokens equal to the target's")
    del deng, dparams
    phase_spec_small_fp32(dev)
    log("spec engine perf: " + json.dumps(perf))
    return perf, row


def phase_spec_int8(dev, params, cfg) -> dict:
    """spec_k 4 with int8 KV, the prefix cache and chunked prefill: the
    verify windows read the int8 pool through K2-int8 (W = 5, sampled and
    held to the plain version) and prefixed passes run K3."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models import serving
    from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine
    from elastic_gpu_scheduler_tpu_torch.ops import _build

    L, K = cfg.n_layers, PREFIX_ENGINE["fused_steps"]
    kw = dict(PREFIX_ENGINE, overlap=True)
    eng = InferenceEngine(params, cfg, spec_k=SPEC_K, device=dev, **kw)
    wave1, wave2 = prefix_traffic(np.random.default_rng(12), cfg.vocab_size, SHARED_PREFIX,
                                  WAVE1_LENS, WAVE2_TAILS)
    real = serving._paged_attn_call
    verify = VerifyCalls(real, every=89, keep=6)
    serving._paged_attn_call = verify
    torch.cuda.synchronize()
    _build.reset_launches()
    marks = spec_marks(eng)
    t0 = time.perf_counter()
    try:
        reqs = [r for wave in (wave1, wave2) for r in drive_wall(eng, wave, NEW_TOKENS)[0]]
    finally:
        serving._paged_attn_call = real
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    c = spec_counts(eng, marks)
    chunks = c["steps"] - c["passes"]
    want = L * (c["passes"] + K * (chunks + c["warmups"]))
    log(f"int8 prefix chunked spec engine: {c['passes']} verify passes, {chunks} chunks, "
        f"{verify.n} W={SPEC_K + 1} calls, launches {launches} (want paged_attention_int8="
        f"{want}), prefix hits {eng.prefix_admission_hits}")
    check(verify.n == L * c["passes"] > 0, "int8 W-query K2 calls != layers x verify passes")
    check(launches["paged_attention_int8"] == want and launches["paged_attention"] == 0,
          "int8 spec engine K2 launches differ from the path")
    check(launches["flash_block_stats"] > 0 and eng.prefix_admission_hits == len(wave2),
          "the int8 spec engine ran no prefixed pass (K3) or missed the cache")
    err = check_verify_samples(verify.sampler.calls, "paged_attention_int8",
                               "int8 prefix chunked spec engine")
    gen = sum(len(r.output) for r in reqs)
    del eng
    return {"wall_s": wall, "generated_tokens": gen, "tokens_per_s": gen / wall, **c,
            "accepted_per_pass": c["accepted"] / max(1, c["passes"]),
            "k3_launches": launches["flash_block_stats"], "w5_max_abs_err": err}


def phase_spec_small_fp32(dev) -> None:
    """Small float32 model: spec_k 4 gives the greedy tokens of spec_k 0, on
    the card and against the CPU, dense and int8; the model as its own
    draft accepts (nearly) the full window."""
    small, sp = small_fp32()
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 512, n).tolist() for n in (2, 5, 17, 40)] + [[7, 3, 11, 5] * 8]
    for kv_int8 in (False, True):
        outs = {}
        for name, where, kw in (("cpu", "cpu", dict(spec_k=SPEC_K)),
                                ("card", dev, dict(spec_k=SPEC_K)),
                                ("plain", dev, {})):
            outs[name], se = small_tokens(sp, small, where, prompts, kv_int8=kv_int8, **kw)
            if name == "card":
                check(se.spec_passes > 0, "the small spec engine ran no verify pass")
        check(outs["card"] == outs["plain"] == outs["cpu"],
              f"float32 spec_k {SPEC_K} tokens differ (kv_int8={kv_int8})")
    plain, _ = small_tokens(sp, small, dev, prompts)
    self_draft, se = small_tokens(sp, small, dev, prompts, spec_k=SPEC_K, draft=(sp, small))
    check(self_draft == plain, "float32 self-draft tokens differ from the plain engine's")
    check(se.spec_accepted >= 1.5 * se.spec_passes,
          f"the self-draft accepted {se.spec_accepted} drafts in {se.spec_passes} passes")
    log(f"small float32 spec engine: spec_k {SPEC_K} equals spec_k 0 on the card and the CPU, "
        f"dense and int8; self-draft {se.spec_accepted} accepted in {se.spec_passes} passes "
        f"({se.spec_accepted / se.spec_passes:.2f} a pass; {len(prompts)} rows, "
        f"{SPEC_K} at most)")


# -- phase 6e: per-request controls -------------------------------------------


CONTROL_BIAS = {17: 4.0, 4242: -5.0, 31999: 2.0}
CONTROL_ALLOWED = tuple(range(1000, 1064))
CONTROL_MIN = 40  # the timed batches' floor: through the first 3 of 4 chunks
CONTROL_PENALTIES = dict(frequency_penalty=0.5, presence_penalty=0.3)
CONTROL_WINDOW = 3  # consecutive overlapped chunks in each profiled window


def control_specs(prompts, ref_reqs, min_tokens=CONTROL_MIN, penalties=False):
    """Phase 6e's batch over the serve prompts: every request asks for
    logprobs 5 and carries a logit_bias and min_tokens with two stop ids
    that its phase 6 greedy stream emits (its first and sixth tokens); the
    odd half samples (temperature 0.8) with a seed of its own; two greedy
    requests add allowed_tokens; ``penalties`` adds both penalties."""
    specs = []
    for i, (p, ref) in enumerate(zip(prompts, ref_reqs)):
        kw = dict(logprobs=5, logit_bias=CONTROL_BIAS, min_tokens=min_tokens,
                  stop_tokens=(ref.output[0], ref.output[5]))
        if i % 2:
            kw.update(temperature=0.8, seed=1000 + i)
        elif i in (0, 6):
            kw["allowed_tokens"] = CONTROL_ALLOWED
        if penalties:
            kw.update(CONTROL_PENALTIES)
        specs.append((p, kw))
    return specs


def drive_specs(eng, specs, max_new):
    """``drive_wall`` for requests with their own fields: (requests, wall
    s, chunks run).  A stream may end at a stop id past its floor."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models.serving import Request

    torch.cuda.synchronize()
    steps0 = eng.steps_run
    t0 = time.perf_counter()
    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=max_new, **kw))
            for p, kw in specs]
    eng.run_until_idle(max_steps=100_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reqs:
        check(r.done.is_set() and not r.error, f"request failed: {r.error!r}")
        check(min(max_new, r.min_tokens) <= len(r.output) <= max_new,
              f"request gave {len(r.output)} tokens (floor {r.min_tokens}, cap {max_new})")
    return reqs, wall, eng.steps_run - steps0


def check_controls(reqs, label) -> dict:
    """Every emitted token against its request's constraints, and every
    logprob row for sanity: only allowed ids; no stop id before the floor,
    and a stream that ended early ends on one; a chosen logprob <= 0 (to
    1e-6 of float32 rounding); top lists of the asked width, sorted; a
    greedy token's logprob equal to its list's first entry (ids may differ
    only where bf16 logits tie)."""
    top_id_ties = 0
    for r in reqs:
        out = r.output
        if r.allowed_tokens:
            check(set(out) <= set(r.allowed_tokens), f"{label}: a token outside allowed_tokens")
        check(not set(out[: r.min_tokens - 1]) & set(r.stop_tokens),
              f"{label}: a stop id before min_tokens")
        if len(out) < r.max_new_tokens:
            check(out[-1] in r.stop_tokens, f"{label}: a stream ended early without a stop id")
        check(len(r.token_logprobs) == len(r.top_logprobs) == len(out),
              f"{label}: logprobs not one a token")
        for tok, lp, top in zip(out, r.token_logprobs, r.top_logprobs):
            vals = [v for _, v in top]
            check(lp <= 1e-6 and len(top) == r.logprobs, f"{label}: chosen {lp} or width")
            check(all(a >= b for a, b in zip(vals, vals[1:])), f"{label}: top list not sorted")
            if r.temperature == 0:
                check(abs(lp - vals[0]) <= 1e-6, f"{label}: greedy {lp} != top {vals[0]}")
                top_id_ties += top[0][0] != tok
    return {"tokens": sum(len(r.output) for r in reqs), "greedy_top_id_ties": top_id_ties,
            "stopped_early": sum(len(r.output) < r.max_new_tokens for r in reqs)}


def run_perf(reqs, wall, chunks) -> dict:
    gen = sum(len(r.output) for r in reqs)
    return {"wall_s": wall, "generated_tokens": gen, "tokens_per_s": gen / wall,
            "chunks": chunks, "wall_ms_per_chunk": wall / chunks * 1e3 if chunks else None}


def graph_marks(eng) -> dict:
    return {"captured": eng.graphs_captured, "capture_s": eng.graph_capture_s,
            "keys": eng.graph_keys()}


def graph_delta(eng, marks) -> dict:
    return {"captured": eng.graphs_captured - marks["captured"],
            "capture_s": eng.graph_capture_s - marks["capture_s"],
            "keys": [list(k) for k in sorted(eng.graph_keys() - marks["keys"])]}


def seeded_agreement(reqs, ref_reqs) -> dict:
    rows = [(a, b) for a, b in zip(reqs, ref_reqs) if a.seed is not None]
    return {"seeded_requests": len(rows),
            "identical": sum(a.output == b.output for a, b in rows),
            "tokens_equal": sum(x == y for a, b in rows for x, y in zip(a.output, b.output)),
            "tokens": sum(len(b.output) for _, b in rows)}


def phase_controls_engine(dev, params, cfg, prompts, seq_reqs) -> dict:
    """Per-request controls on phase 6's weights and prompts (64 new
    tokens).  The overlapped engine serves the plain batch (warm-up, then
    timed) and the controls batch (logprobs 5, a logit_bias, allowed_tokens
    on two requests, min_tokens with stop ids, a seed on the sampled half;
    warm-up, then timed: the main path, exact K1 / K2 launches, every chunk
    a replay); the same batch with both penalties takes the sequential loop;
    spec_k 4 with the controls; constraints and logprob sanity on every
    token; the same seeded requests twice in one mode; device time a chunk,
    plain against controls; HTTP; the small float32 identities."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine
    from elastic_gpu_scheduler_tpu_torch.ops import _build

    L, K = cfg.n_layers, ENGINE["fused_steps"]
    eng = InferenceEngine(params, cfg, paged_kernel=True, device=dev, **ENGINE)
    perf = {}
    marks = graph_marks(eng)
    drive_wall(eng, prompts, NEW_TOKENS)
    plain_graphs = graph_delta(eng, marks)
    check(all(not any(k[3:]) for k in eng.graph_keys()), "a plain batch captured a controls graph")
    perf["plain"] = dict(run_perf(*drive_wall(eng, prompts, NEW_TOKENS)), graphs=plain_graphs)

    specs = control_specs(prompts, seq_reqs)
    marks = graph_marks(eng)
    warm, _, _ = drive_specs(eng, specs, NEW_TOKENS)
    graphs = graph_delta(eng, marks)
    check(graphs["captured"] > 0 and all(any(k[3:]) for k in graphs["keys"]),
          "the controls batch captured no controls graph")
    base = dict(warmups=eng.graph_warmups, replays=eng.graph_replays, prefills=eng.prefills_run)
    torch.cuda.synchronize()
    # the main path: counts at 0 just before, read just after
    _build.reset_launches()
    creqs, cwall, cchunks = drive_specs(eng, specs, NEW_TOKENS)
    launches = dict(_build.LAUNCHES)
    warmups = eng.graph_warmups - base["warmups"]
    replays = eng.graph_replays - base["replays"]
    prefills = eng.prefills_run - base["prefills"]
    log(f"controls engine main path: {cchunks} chunks ({replays} graph replays, {warmups} "
        f"captures), {prefills} prefills, launches {launches} (want paged_attention="
        f"{L * K * (cchunks + warmups)}, flash_fwd={L * prefills})")
    check(replays == cchunks, "a controls chunk of the overlapped engine was not a replay")
    check(launches["paged_attention"] == L * K * (cchunks + warmups) > 0,
          "controls: K2 launches != layers x fused_steps x (chunks + captures' warm-ups)")
    check(launches["flash_fwd"] == L * prefills > 0, "controls: K1 launches != layers x prefills")
    check(launches["paged_attention_int8"] == launches["flash_block_stats"] == 0,
          "the dense controls engine launched the int8 K2 or K3")
    check_controls(warm, "controls warm-up batch")
    cons = check_controls(creqs, "controls batch")
    twice = seeded_agreement(creqs, warm)
    check(twice["identical"] == twice["seeded_requests"] > 0,
          "a seeded request gave other tokens run twice in the same mode and batch")
    perf["controls"] = dict(run_perf(creqs, cwall, cchunks), graphs=graphs, constraints=cons,
                            seeded_twice=twice,
                            all_tokens_equal_twice=sum(a.output == b.output
                                                       for a, b in zip(creqs, warm)))
    log("controls engine, plain and controls batches: "
        + json.dumps({k: perf[k] for k in ("plain", "controls")}))

    # both penalties: _overlap_blocked forces the sequential loop
    pspecs = control_specs(prompts, seq_reqs, penalties=True)
    overlapped_steps = []
    real_overlapped = eng._step_chunk_overlapped
    eng._step_chunk_overlapped = lambda: overlapped_steps.append(1) or real_overlapped()
    try:
        marks = graph_marks(eng)
        pwarm, _, _ = drive_specs(eng, pspecs, NEW_TOKENS)
        pgraphs = graph_delta(eng, marks)
        preqs, pwall, pchunks = drive_specs(eng, pspecs, NEW_TOKENS)
    finally:
        del eng._step_chunk_overlapped
    check(not overlapped_steps, "a penalised batch took the overlapped step")
    check_controls(preqs, "penalised batch")
    perf["penalties_sequential"] = dict(run_perf(preqs, pwall, pchunks), graphs=pgraphs,
                                        seeded_twice=seeded_agreement(preqs, pwarm))
    log("controls engine, penalised batch: " + json.dumps(perf["penalties_sequential"]))

    # spec_k 4 with the controls
    seng = InferenceEngine(params, cfg, paged_kernel=True, spec_k=SPEC_K, device=dev, **ENGINE)
    swarm, _, _ = drive_specs(seng, specs, NEW_TOKENS)
    marks = spec_marks(seng)
    _build.reset_launches()
    sreqs, swall, _ = drive_specs(seng, specs, NEW_TOKENS)
    launches = dict(_build.LAUNCHES)
    c = spec_counts(seng, marks)
    chunks = c["steps"] - c["passes"]
    want = L * (c["passes"] + K * (chunks + c["warmups"]))
    check(c["passes"] > 0 and launches["paged_attention"] == want,
          f"spec controls: K2 launches {launches['paged_attention']} != {want}")
    check_controls(sreqs, "spec_k 4 controls batch")
    perf["spec_k4"] = dict(run_perf(sreqs, swall, chunks), **c,
                           seeded_twice=seeded_agreement(sreqs, swarm),
                           seeded_vs_overlapped=seeded_agreement(sreqs, creqs))
    del seng
    log("controls engine, spec_k 4: " + json.dumps(perf["spec_k4"]))

    plain_prof = chunk_profile(eng, [(p, {}) for p in prompts], "plain")
    ctl_prof = chunk_profile(eng, control_specs(prompts, seq_reqs, min_tokens=6 * K),
                             "all non-penalty controls")
    perf["profile"] = {"plain": plain_prof, "controls": ctl_prof,
                       "added_device_ms_per_chunk": ctl_prof["device_ms_per_chunk"]
                       - plain_prof["device_ms_per_chunk"],
                       "added_kernels_per_chunk": ctl_prof["kernels_per_chunk"]
                       - plain_prof["kernels_per_chunk"]}
    p, ctl = perf["plain"], perf["controls"]
    log(f"controls (overlapped, same engine, same prompts): {ctl['tokens_per_s']:.1f} against "
        f"{p['tokens_per_s']:.1f} tokens/s plain, {ctl['wall_ms_per_chunk']:.2f} against "
        f"{p['wall_ms_per_chunk']:.2f} wall ms a chunk; penalised (sequential loop) "
        f"{perf['penalties_sequential']['tokens_per_s']:.1f} tokens/s; spec_k 4 with controls "
        f"{perf['spec_k4']['tokens_per_s']:.1f} tokens/s; device ms a chunk "
        f"{ctl_prof['device_ms_per_chunk']:.3f} against {plain_prof['device_ms_per_chunk']:.3f} "
        f"plain (+{perf['profile']['added_kernels_per_chunk']:.0f} kernels a chunk)")
    perf["http"] = phase_controls_http(eng, params, cfg, prompts, dev)
    del eng
    perf["small_float32"] = phase_controls_small_fp32(dev)
    return perf


def prefill_tpad(n: int, max_len: int) -> int:
    """The length the engine pads an n-token prompt's prefill to: a power
    of two from 8, at most max_len."""
    t = 8
    while t < n:
        t *= 2
    return min(t, max_len)


def count_launches(trace: list[dict], match: str, per: int) -> dict:
    """Launches of the kernels named ``match`` in a profiled run's trace,
    by launch (name, grid, block, shared memory), over ``per``."""
    out = {}
    for k in trace:
        if match in k["kernel"]:
            out[k["launch"]] = out.get(k["launch"], 0) + 1
    return {s: n / per for s, n in out.items()}


def chunk_profile(eng, specs, label, ke: bool = False) -> dict:
    """CONTROL_WINDOW consecutive overlapped steps of a full batch under
    torch.profiler: device ms and kernels a chunk, and the graph keys the
    window replayed (none captured inside it).  With ``ke``, also KE's
    launches a chunk and in the batch's prefills (profiled apart), by
    launch."""
    from elastic_gpu_scheduler_tpu_torch.models.serving import Request

    K = eng.fused_steps
    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=6 * K, **kw))
            for p, kw in specs[: eng.max_batch]]
    trace, pre = [], []
    if ke:
        profiled(eng._admit, f"{label} prefills", trace=pre, lead_spin=True)
    else:
        eng._admit()  # the prefills, outside the window
    eng.step()
    eng.step()
    keys = []
    real = eng._replay_chunk

    def spy(key, args, static):
        keys.append(list(key))
        return real(key, args, static)

    def window():
        for _ in range(CONTROL_WINDOW):
            eng.step()

    eng._replay_chunk = spy
    cap0 = eng.graphs_captured
    try:
        # with ``ke`` its launches are counted exactly: a lead spin takes
        # the window's first milliseconds, whose records the profiler can
        # lose (one KE launch of 1,536 in one run on the H100)
        wall_ms, kernels = profiled(window, f"{CONTROL_WINDOW} {label} chunks", cpu=True,
                                    trace=trace if ke else None, lead_spin=ke)
    finally:
        del eng._replay_chunk
    check(eng.graphs_captured == cap0, f"{label}: a graph was captured inside the window")
    eng.run_until_idle()
    check(all(r.done.is_set() and not r.error for r in reqs), f"{label}: window requests failed")
    busy = sum(k["ms"] for k in kernels)
    ke = [k for k in kernels if "expert_matmul" in k["kernel"]]
    out = {"keys": keys, "wall_ms_per_chunk": wall_ms / CONTROL_WINDOW,
           "device_ms_per_chunk": busy / CONTROL_WINDOW,
           "ke_ms_per_chunk": sum(k["ms"] for k in ke) / CONTROL_WINDOW,
           "ke_launches_per_chunk": sum(k["count"] for k in ke) / CONTROL_WINDOW,
           "kernels_per_chunk": sum(k["count"] for k in kernels) / CONTROL_WINDOW,
           "idle_share": 1 - busy / wall_ms, "top": kernels[:10]}
    if ke:
        out.update(ke_launches=count_launches(trace, "expert_matmul", CONTROL_WINDOW),
                   ke_prefill_launches=count_launches(pre, "expert_matmul", 1),
                   prefill_tpads=[prefill_tpad(len(p), eng.max_len)
                                  for p, _ in specs[: eng.max_batch]])
    log(f"{label} chunk profile: {out['device_ms_per_chunk']:.3f} device ms and "
        f"{out['kernels_per_chunk']:.0f} kernels a chunk, keys {keys}")
    return out


def post_json(addr, body, path="/v1/completions", headers=None, timeout=300):
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), data


def get_json(addr, path):
    conn = http.client.HTTPConnection(*addr, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    return resp.status, body


def phase_controls_http(eng, params, cfg, prompts, dev) -> dict:
    """``n`` = 2 with a seed and logprobs in JSON and SSE on the
    card-resident engine (the same choices both ways: one mode, one
    batch); a flood of 16 concurrent completions against ``max_queue=1``
    must meet at least one 429; /v1/stats reports ``max_queue``."""
    import threading

    from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine
    from elastic_gpu_scheduler_tpu_torch.server.inference import serve_inference

    body = {"prompt": prompts[0], "max_tokens": 16, "n": 2, "seed": 7, "temperature": 0.8,
            "logprobs": 3}
    server, loop = serve_inference(eng, port=0, host="127.0.0.1")
    addr = server.server_address
    try:
        code, _, data = post_json(addr, body)
        check(code == 200, f"n=2 completion answered {code}")
        choices = json.loads(data)["choices"]
        check([c["index"] for c in choices] == [0, 1], "n=2: choices not indexed 0, 1")
        for c in choices:
            lp = c["logprobs"]
            check(len(c["tokens"]) == len(lp["token_logprobs"]) == 16
                  and all(len(t) == 3 for t in lp["top_logprobs"]), "n=2: logprobs malformed")
        code, ctype, data = post_json(addr, dict(body, stream=True))
        check(code == 200 and ctype == "text/event-stream", f"SSE answered {code} {ctype}")
        events = [e[len("data: "):] for e in data.decode().split("\n\n")
                  if e.startswith("data: ")]
        check(events and events[-1] == "[DONE]", "SSE stream did not end with [DONE]")
        events = [json.loads(e) for e in events[:-1]]
        check(all(len(e["top_logprobs"]) == 3 and "logprob" in e for e in events),
              "SSE events carry no logprobs")
        streamed = [[e["token"] for e in events if e["index"] == k] for k in (0, 1)]
        check([len(t) for t in streamed] == [16, 16], "SSE: not 16 tokens a choice")
        same = streamed == [c["tokens"] for c in choices]
        code, stats = get_json(addr, "/v1/stats")
        check(code == 200 and stats["max_queue"] == 0 and stats["logprobs_k"] == 5,
              "stats: max_queue / logprobs_k")
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()

    qeng = InferenceEngine(params, cfg, paged_kernel=True, device=dev, max_queue=1, **ENGINE)
    server, loop = serve_inference(qeng, port=0, host="127.0.0.1")
    addr = server.server_address
    codes = []
    try:
        def one(i):
            codes.append(post_json(addr, {"prompt": prompts[i % len(prompts)][:256],
                                          "max_tokens": 16})[0])

        threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        check(not any(t.is_alive() for t in threads), "flood requests did not finish")
        code, stats = get_json(addr, "/v1/stats")
        check(code == 200 and stats["max_queue"] == 1, "stats: max_queue")
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()
    del qeng
    res = {"n2_json_sse_equal": same, "flood": {"200": codes.count(200),
                                                "429": codes.count(429)}}
    check(codes.count(429) >= 1 and codes.count(200) + codes.count(429) == 16,
          f"flood against max_queue=1 answered {sorted(codes)}")
    log(f"controls HTTP: n=2 with seed and logprobs in JSON and SSE (choices equal both "
        f"ways: {same}); a flood of 16 "
        f"against max_queue=1: {codes.count(200)} answered 200, {codes.count(429)} 429; "
        f"/v1/stats reports max_queue")
    return res


def small_engine(sp, small, where, **kw):
    """The small float32 engine of phase 6e (``small_tokens``' geometry)."""
    from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine

    kw = dict(dict(max_batch=4, max_len=128, page_size=16, fused_steps=8, paged_kernel=True),
              **kw)
    return InferenceEngine(sp, small, device=where, **kw)


def drive_small(se, specs, max_new=24):
    """(prompt, fields) requests through ``se`` until idle."""
    from elastic_gpu_scheduler_tpu_torch.models.serving import Request

    rs = [se.submit(Request(prompt=list(q), max_new_tokens=max_new, **extra))
          for q, extra in specs]
    se.run_until_idle()
    for r in rs:
        check(r.done.is_set() and not r.error, f"small engine request failed: {r.error}")
    return rs


def small_controls(sp, small, where, specs, max_new=24, **kw):
    return drive_small(small_engine(sp, small, where, **kw), specs, max_new)


def small_spill(sp, small, where, victim):
    """``victim`` (prompt, fields) driven into page pressure, then a
    higher-priority request: it spills and resumes."""
    from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine, Request

    se = InferenceEngine(sp, small, device=where, max_batch=2, max_len=64, page_size=8,
                         n_pages=6, fused_steps=2, paged_kernel=True)
    v = se.submit(Request(prompt=list(victim[0]), max_new_tokens=30, **victim[1]))
    for _ in range(40):
        se._admit()
        se.step()
        if not se.free_pages:
            break
    se.submit(Request(prompt=[2, 4, 6, 8, 10, 12, 1, 7], max_new_tokens=8, priority=5))
    se.run_until_idle()
    check(se.spills >= 1 and v.done.is_set() and not v.error, "the small spill did not spill")
    return v


def phase_controls_small_fp32(dev) -> dict:
    """Small float32 model: greedy requests carrying each control give the
    port's CPU tokens on the card, with equal top ids and logprobs within
    1e-4, sequential, overlapped, spec_k 4 and int8 + prefix + chunked
    (there within 1e-2: the int8 pool's rounding is a step function, and a
    K/V value within float32 rounding of a half step lands on neighbouring
    int8 values on the card and the CPU; the error is reported); a
    seeded sampled request gives the same tokens alone, batched, under
    overlap, under spec_k 4 and after a spill and resume."""
    small, sp = small_fp32()
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 512, n).tolist() for n in (3, 5, 17, 40, 9)]
    plain = small_controls(sp, small, "cpu", [(prompts[3], {})], overlap=False)
    stops = (plain[0].output[0], plain[0].output[3])
    mix = [dict(logit_bias={3: 2.0, 40: -4.0, 100: 1.5}, logprobs=5),
           dict(allowed_tokens=tuple(range(200, 264)), logprobs=3),
           dict(frequency_penalty=0.7, presence_penalty=0.4, logprobs=2),
           dict(min_tokens=12, stop_tokens=stops),
           dict(logprobs=5)]
    specs = list(zip(prompts, mix))
    modes = {"sequential": dict(overlap=False), "overlapped": dict(overlap=True),
             f"spec_k {SPEC_K}": dict(spec_k=SPEC_K),
             "int8 prefix chunked": dict(kv_int8=True, prefix_cache=True, prefill_chunk=16)}
    worst = {}
    for name, kw in modes.items():
        tol = 1e-2 if kw.get("kv_int8") else 1e-4
        waves = [specs, specs[2:4]] if kw.get("prefix_cache") else [specs]
        outs = {}
        for where in ("cpu", dev):
            se = small_engine(sp, small, where, **kw)
            got = []
            for wave in waves:
                got += drive_small(se, wave)
            outs[str(where)] = got
            if kw.get("prefix_cache"):
                check(se.prefix_admission_hits >= 2, "small int8 prefix run missed the cache")
        cpu, card = outs["cpu"], outs[str(dev)]
        check([r.output for r in card] == [r.output for r in cpu],
              f"float32 controls: card tokens differ from the CPU's ({name})")
        for a, b in zip(card, cpu):
            if b.logprobs:
                check([[t for t, _ in x] for x in a.top_logprobs]
                      == [[t for t, _ in x] for x in b.top_logprobs],
                      f"float32 controls: top ids differ ({name})")
                err = max(abs(x - y) for x, y in zip(a.token_logprobs, b.token_logprobs))
                err = max([err] + [abs(u[1] - v[1]) for x, y in
                                   zip(a.top_logprobs, b.top_logprobs) for u, v in zip(x, y)])
                worst[name] = max(worst.get(name, 0.0), err)
                check(err <= tol, f"float32 controls: logprobs {err:.3g} apart ({name}, "
                      f"tol {tol})")
    seeded = ([3, 9, 14, 27, 5, 1, 2, 6], dict(temperature=0.9, seed=77, logprobs=2))
    runs = {
        "alone": small_controls(sp, small, dev, [seeded], max_new=30, overlap=False)[-1],
        "batched": small_controls(sp, small, dev, specs + [seeded], max_new=30,
                                  overlap=False)[-1],
        "overlap": small_controls(sp, small, dev, specs + [seeded], max_new=30)[-1],
        f"spec_k {SPEC_K}": small_controls(sp, small, dev, specs + [seeded], max_new=30,
                                           spec_k=SPEC_K)[-1],
        "spill and resume": small_spill(sp, small, dev, seeded),
    }
    want = runs["alone"].output
    check(len(want) == 30 and all(r.output == want for r in runs.values()),
          "float32: a seeded request's tokens differ across runs "
          + json.dumps({k: r.output for k, r in runs.items()}))
    cpu_seeded = small_controls(sp, small, "cpu", [seeded], max_new=30, overlap=False)[-1]
    log(f"small float32 controls: card tokens and top ids equal the CPU's in {len(modes)} "
        f"modes; logprob max abs error by mode {json.dumps(worst)} (tol 1e-4, int8 1e-2); "
        f"a seeded request identical in "
        f"{len(runs)} card runs ({', '.join(runs)}); card vs CPU seeded tokens equal: "
        f"{cpu_seeded.output == want}")
    return {"modes": list(modes), "logprob_max_abs_err": worst, "seeded_runs": list(runs),
            "seeded_card_equals_cpu": cpu_seeded.output == want}


# -- phase 6f: multi-LoRA serving ----------------------------------------------


ALL_FAMILIES = ("wq", "wk", "wv", "wo", "w_in", "w_gate", "w_out")
# (name, rank, targets) of the full-width adapters, B ~ N(0, 1) x LORA_B_SCALE
LORA_ADAPTERS = (("r16-all", 16, ALL_FAMILIES), ("r8-qv", 8, ("wq", "wv")),
                 ("r16-attn", 16, ("wq", "wk", "wv", "wo")),
                 ("r4-mlp", 4, ("w_gate", "w_in", "w_out")))
LORA_B_SCALE = 0.05
LORA_NAMES = ("",) + tuple(n for n, _, _ in LORA_ADAPTERS)
# the small float32 adapters, as tests/test_multilora.py builds them
SMALL_LORA = (("styleA", 4, ("wq", "wv")), ("styleB", 2, ("wq", "wk", "w_out")))


def make_adapters(params, specs, b_scale, seed, device) -> dict:
    """{name: lora_init tree} on ``params`` (A from the port's init, B
    drawn N(0, 1) x ``b_scale``: a trained look), all from ``seed``."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models.lora import lora_init

    out = {}
    for n, (name, rank, targets) in enumerate(specs):
        g = torch.Generator(device=device).manual_seed(seed + n)
        lo = lora_init(params, rank=rank, targets=targets, generator=g)
        for ab in lo["adapters"].values():
            ab["b"] = torch.randn(ab["b"].shape, generator=g, device=device) * b_scale
        out[name] = lo
    return out


def phase_lora_engine(dev, params, cfg, prompts) -> dict:
    """Multi-LoRA serving on phase 6's weights and prompts (64 new tokens)
    with four adapters: the bank-less overlapped engine and the bank
    engine with every request on "" (warm-up, then timed: identical
    tokens, the same graph keys), then the mixed batch (the 12 prompts
    round-robin over "" and the adapters; the main path: no capture, exact
    K1 / K2 launches, every chunk a replay; some adapter changes some
    prompt's tokens); each request against its adapter's batch alone
    (reported); device ms and kernels a chunk, plain / bank on "" / mixed;
    spec_k 4 and int8 + prefix + chunked with adapters; HTTP; the small
    float32 identities."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine
    from elastic_gpu_scheduler_tpu_torch.ops import _build

    L, K = cfg.n_layers, ENGINE["fused_steps"]
    adapters = make_adapters(params, LORA_ADAPTERS, LORA_B_SCALE, seed=40, device=dev)
    log(f"multi-LoRA: adapters {[(n, r, list(t)) for n, r, t in LORA_ADAPTERS]}, "
        f"B ~ N(0, 1) x {LORA_B_SCALE}, A ~ N(0, 1/d_in), alpha = rank")
    base_specs = [(p, {}) for p in prompts]
    mixed = [(p, {"adapter": LORA_NAMES[i % len(LORA_NAMES)]}) for i, p in enumerate(prompts)]
    perf = {"b_scale": LORA_B_SCALE,
            "adapters": {n: {"rank": r, "targets": list(t)} for n, r, t in LORA_ADAPTERS}}

    plain = InferenceEngine(params, cfg, paged_kernel=True, device=dev, **ENGINE)
    drive_specs(plain, base_specs, NEW_TOKENS)
    preqs, pwall, pchunks = drive_specs(plain, base_specs, NEW_TOKENS)
    plain_keys = plain.graph_keys()
    perf["bankless"] = dict(run_perf(preqs, pwall, pchunks), graphs=len(plain_keys))

    beng = InferenceEngine(params, cfg, paged_kernel=True, device=dev, adapters=adapters,
                           **ENGINE)
    check(sorted(beng.adapter_index) == sorted(LORA_NAMES), "bank ids")
    bank_mb = sum(t.numel() * t.element_size() for t in _leaves(beng.lora_bank)) / 1e6
    drive_specs(beng, base_specs, NEW_TOKENS)
    breqs, bwall, bchunks = drive_specs(beng, base_specs, NEW_TOKENS)
    check(all(a.output == b.output for a, b in zip(breqs, preqs)),
          "base rows: the bank engine's tokens on \"\" differ from the bank-less engine's")
    check(beng.graph_keys() == plain_keys, "the bank engine captured other graph keys")
    perf["bank_on_base"] = dict(run_perf(breqs, bwall, bchunks), graphs=len(beng.graph_keys()),
                                tokens_equal_bankless=True, bank_mb=bank_mb)
    marks = graph_marks(beng)
    mwarm, _, _ = drive_specs(beng, mixed, NEW_TOKENS)
    check(graph_delta(beng, marks)["captured"] == 0, "the mixed-adapter batch captured a graph")
    base = dict(warmups=beng.graph_warmups, replays=beng.graph_replays,
                prefills=beng.prefills_run)
    torch.cuda.synchronize()
    # the main path: counts at 0 just before, read just after
    _build.reset_launches()
    mreqs, mwall, mchunks = drive_specs(beng, mixed, NEW_TOKENS)
    launches = dict(_build.LAUNCHES)
    warmups = beng.graph_warmups - base["warmups"]
    replays = beng.graph_replays - base["replays"]
    prefills = beng.prefills_run - base["prefills"]
    log(f"multi-LoRA main path (mixed batch): {mchunks} chunks ({replays} graph replays, "
        f"{warmups} captures), {prefills} prefills, launches {launches} (want paged_attention="
        f"{L * K * (mchunks + warmups)}, flash_fwd={L * prefills})")
    check(warmups == 0 and replays == mchunks, "a mixed-adapter chunk was not a replay")
    check(launches["paged_attention"] == L * K * mchunks > 0,
          "multi-LoRA: K2 launches != layers x fused_steps x chunks")
    check(launches["flash_fwd"] == L * prefills > 0, "multi-LoRA: K1 launches != layers x prefills")
    check(launches["paged_attention_int8"] == launches["flash_block_stats"] == 0,
          "the dense multi-LoRA engine launched the int8 K2 or K3")
    changed = [i for i, (a, b, (_, kw)) in enumerate(zip(mreqs, preqs, mixed))
               if kw["adapter"] and a.output != b.output]
    check(changed, "no adapter changed any prompt's tokens")
    base_rows = [i for i, (_, kw) in enumerate(mixed) if not kw["adapter"]]
    iso = {}
    for name in LORA_NAMES:
        idx = [i for i, (_, kw) in enumerate(mixed) if kw["adapter"] == name]
        for i, r in zip(idx, drive_specs(beng, [mixed[i] for i in idx], NEW_TOKENS)[0]):
            iso[i] = r
    vs_iso = agreement(mreqs, [iso[i] for i in range(len(mixed))])
    perf["mixed"] = dict(run_perf(mreqs, mwall, mchunks), launches=launches,
                         adapter_requests_changed=len(changed),
                         base_rows_equal_bankless=sum(mreqs[i].output == preqs[i].output
                                                      for i in base_rows),
                         base_rows=len(base_rows), vs_isolated=vs_iso,
                         twice_equal=sum(a.output == b.output for a, b in zip(mreqs, mwarm)))
    log("multi-LoRA engine: " + json.dumps({k: perf[k] for k in
                                            ("bankless", "bank_on_base", "mixed")}))

    profs = {"bankless": chunk_profile(plain, base_specs, "bank-less"),
             "bank_on_base": chunk_profile(beng, base_specs, "bank, every request on \"\""),
             "mixed": chunk_profile(beng, mixed, "bank, mixed adapters")}
    check(profs["mixed"]["keys"] == profs["bank_on_base"]["keys"],
          "the mixed window replayed other graphs than the base window")
    perf["profile"] = dict(profs, added_device_ms_per_chunk=profs["mixed"]["device_ms_per_chunk"]
                           - profs["bankless"]["device_ms_per_chunk"],
                           added_kernels_per_chunk=profs["mixed"]["kernels_per_chunk"]
                           - profs["bankless"]["kernels_per_chunk"])
    del plain

    # spec_k 4 with the mixed batch
    seng = InferenceEngine(params, cfg, paged_kernel=True, spec_k=SPEC_K, device=dev,
                           adapters=adapters, **ENGINE)
    drive_specs(seng, mixed, NEW_TOKENS)
    smarks = spec_marks(seng)
    _build.reset_launches()
    sreqs, swall, _ = drive_specs(seng, mixed, NEW_TOKENS)
    slaunch = dict(_build.LAUNCHES)
    c = spec_counts(seng, smarks)
    chunks = c["steps"] - c["passes"]
    want = L * (c["passes"] + K * (chunks + c["warmups"]))
    check(c["passes"] > 0 and slaunch["paged_attention"] == want,
          f"multi-LoRA spec: K2 launches {slaunch['paged_attention']} != {want}")
    perf["spec_k4"] = dict(run_perf(sreqs, swall, chunks), **c,
                           vs_overlapped=agreement(sreqs, mreqs))
    del seng
    perf["prefix"] = phase_lora_prefix(dev, params, cfg, adapters)
    perf["http"] = phase_lora_http(beng, prompts)
    del beng
    perf["small_float32"] = phase_lora_small_fp32(dev)
    pr = perf["profile"]
    log(f"multi-LoRA (overlapped, same prompts, one call): bank-less "
        f"{perf['bankless']['tokens_per_s']:.1f} tokens/s, bank on \"\" "
        f"{perf['bank_on_base']['tokens_per_s']:.1f}, mixed {perf['mixed']['tokens_per_s']:.1f}; "
        f"wall ms a chunk {perf['bankless']['wall_ms_per_chunk']:.2f} / "
        f"{perf['bank_on_base']['wall_ms_per_chunk']:.2f} / "
        f"{perf['mixed']['wall_ms_per_chunk']:.2f}; device ms a chunk "
        f"{pr['bankless']['device_ms_per_chunk']:.3f} / "
        f"{pr['bank_on_base']['device_ms_per_chunk']:.3f} / "
        f"{pr['mixed']['device_ms_per_chunk']:.3f}, kernels a chunk "
        f"{pr['bankless']['kernels_per_chunk']:.0f} / {pr['bank_on_base']['kernels_per_chunk']:.0f}"
        f" / {pr['mixed']['kernels_per_chunk']:.0f}; spec_k 4 mixed "
        f"{perf['spec_k4']['tokens_per_s']:.1f} tokens/s; prefix wave-2 prefill "
        f"{perf['prefix']['wave2_prefill_ms_per_request']:.2f} ms a request; {card_line()}")
    return perf


def phase_lora_prefix(dev, params, cfg, adapters) -> dict:
    """The int8 + prefix + chunked engine with adapters: phase 6b's traffic,
    the primer on one adapter and wave 2 alternating between it (hits) and
    another (no hit: pages are never shared across adapters)."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine
    from elastic_gpu_scheduler_tpu_torch.ops import _build

    wave1, wave2 = prefix_traffic(np.random.default_rng(12), cfg.vocab_size, SHARED_PREFIX,
                                  WAVE1_LENS, WAVE2_TAILS)
    eng = InferenceEngine(params, cfg, device=dev, adapters=adapters, **PREFIX_ENGINE)
    w1 = [{"adapter": "r16-all"}, {"adapter": "r8-qv"}, {}]
    w2 = [{"adapter": "r16-all" if i % 2 == 0 else "r4-mlp"} for i in range(len(wave2))]
    torch.cuda.synchronize()
    _build.reset_launches()
    reqs1, ta1, _ = drive(eng, wave1, NEW_TOKENS, w1)
    t1 = time.perf_counter()
    reqs2, ta2, _ = drive(eng, wave2, NEW_TOKENS, w2)
    wall2 = time.perf_counter() - t1
    launches = dict(_build.LAUNCHES)
    counters = {"prefix_lookups": eng.prefix_lookups,
                "prefix_admission_hits": eng.prefix_admission_hits,
                "prefix_hit_tokens": eng.prefix_hit_tokens}
    hits = sum(1 for kw in w2 if kw["adapter"] == w1[0]["adapter"])
    want = {"prefix_lookups": len(wave1) + len(wave2), "prefix_admission_hits": hits,
            "prefix_hit_tokens": hits * SHARED_PREFIX}
    log(f"multi-LoRA prefix engine: counters {counters} (want {want}), launches {launches}")
    check(counters == want, "multi-LoRA prefix counters differ from the traffic")
    check(min(launches["flash_fwd"], launches["flash_block_stats"],
              launches["paged_attention_int8"]) > 0, "multi-LoRA prefix engine: K1, K3 or "
          "K2-int8 not launched")
    gen2 = sum(len(r.output) for r in reqs2)
    return {"counters": counters, "launches": launches,
            "wave1_prefill_ms_per_request": ta1 / len(wave1) * 1e3,
            "wave2_prefill_ms_per_request": ta2 / len(wave2) * 1e3,
            "wave2_tokens_per_s": gen2 / wall2}


def phase_lora_http(eng, prompts) -> dict:
    """HTTP on the card-resident bank engine: an adapter request answers
    200, an unknown adapter 400, ``n`` = 2 with an adapter is served (both
    greedy choices equal), /v1/stats lists the adapters."""
    from elastic_gpu_scheduler_tpu_torch.server.inference import serve_inference

    server, loop = serve_inference(eng, port=0, host="127.0.0.1")
    addr = server.server_address
    try:
        code, _, data = post_json(addr, {"prompt": prompts[1], "max_tokens": 16,
                                         "adapter": "r16-all"})
        check(code == 200 and len(json.loads(data)["tokens"]) == 16,
              f"adapter completion answered {code}")
        code, _, data = post_json(addr, {"prompt": prompts[1], "max_tokens": 4,
                                         "adapter": "no-such"})
        err = json.loads(data)["error"]
        check(code == 400 and "no-such" in err and "r4-mlp" in err,
              f"unknown adapter answered {code} {err!r}")
        code, _, data = post_json(addr, {"prompt": prompts[2], "max_tokens": 16, "n": 2,
                                         "adapter": "r8-qv"})
        choices = json.loads(data).get("choices", [])
        check(code == 200 and len(choices) == 2
              and all(len(c["tokens"]) == 16 for c in choices), f"n=2 adapter answered {code}")
        code, stats = get_json(addr, "/v1/stats")
        check(code == 200 and stats["adapters"] == sorted(LORA_NAMES[1:]),
              f"stats adapters {stats.get('adapters')}")
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()
    res = {"adapter_200": True, "unknown_400": err, "n2_choices_equal":
           choices[0]["tokens"] == choices[1]["tokens"], "stats_adapters": stats["adapters"]}
    log("multi-LoRA HTTP: " + json.dumps(res))
    return res


def _tree_to(tree, where):
    """A copy of a nested dict of tensors on ``where``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, where) for k, v in tree.items()}
    return tree.detach().clone().to(where)


def phase_lora_small_fp32(dev) -> dict:
    """Small float32 model with two adapters: greedy tokens of a mixed
    batch on the card equal the port's CPU run, sequential, overlapped,
    spec_k 4 and int8 + prefix + chunked; each adapter equals an engine on
    its merged weights; prefix hits 0, 0, 16 (A, B, A); 3 LoRA train steps
    on the card within 1e-4 of the CPU on every adapter leaf."""
    from elastic_gpu_scheduler_tpu_torch.models.lora import merge_lora

    small, sp = small_fp32()
    ads = make_adapters(sp, SMALL_LORA, 0.08, seed=50, device="cpu")
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, 512, n).tolist() for n in (3, 5, 17, 40, 9, 1)]
    names = ("",) + tuple(n for n, _, _ in SMALL_LORA)
    specs = [(p, {"adapter": names[i % len(names)]}) for i, p in enumerate(prompts)]
    modes = {"sequential": dict(overlap=False), "overlapped": dict(overlap=True),
             f"spec_k {SPEC_K}": dict(spec_k=SPEC_K),
             "int8 prefix chunked": dict(kv_int8=True, prefix_cache=True, prefill_chunk=16)}
    for name, kw in modes.items():
        outs = {str(where): [r.output for r in drive_small(
            small_engine(sp, small, where, adapters=ads, **kw), specs)] for where in ("cpu", dev)}
        check(outs["cpu"] == outs[str(dev)], f"float32 multi-LoRA: card differs from CPU ({name})")
    merged = {}
    for name in names[1:]:
        got = drive_small(small_engine(sp, small, dev, adapters=ads), [(prompts[3],
                                                                       {"adapter": name})])
        want = drive_small(small_engine(merge_lora(sp, ads[name]), small, dev), [(prompts[3], {})])
        merged[name] = got[0].output == want[0].output
        check(merged[name], f"float32: adapter {name} differs from its merged engine")
    se = small_engine(sp, small, dev, adapters=ads, max_batch=2, max_len=64, page_size=8,
                      prefix_cache=True)
    prompt = list(range(2, 20))
    hits = []
    for name in ("styleA", "styleB", "styleA"):
        drive_small(se, [(prompt, {"adapter": name})], max_new=6)
        hits.append(int(se.prefix_hit_tokens))
    check(hits == [0, 0, 16], f"float32 prefix isolation: hit tokens {hits}, want [0, 0, 16]")
    train = lora_train_cpu_vs_card(dev)
    log(f"small float32 multi-LoRA: card = CPU in {len(modes)} modes, each adapter = its "
        f"merged engine, prefix hit tokens {hits}; LoRA train " + json.dumps(train))
    return {"modes": list(modes), "merged_equal": merged, "prefix_hit_tokens": hits,
            "train_cpu_vs_card": train}


def lora_train_cpu_vs_card(dev) -> dict:
    """3 LoRA steps (rank 4 on every family, B non-zero, remat, 4 vocab
    chunks, AdamW with warmup and clipping) of a small float32 model on
    the card and on the CPU from the same weights and tokens: every
    adapter leaf within 1e-4 absolute, the base unchanged."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models.data import SyntheticTokenDataset, batches
    from elastic_gpu_scheduler_tpu_torch.models.lora import make_lora_train_step
    from elastic_gpu_scheduler_tpu_torch.models.train import make_optimizer
    from elastic_gpu_scheduler_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )

    small = TransformerConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=4,
                              n_kv_heads=2, d_ff=512, dtype="float32", remat=True,
                              xent_chunks=4)
    base = init_params(small, torch.Generator().manual_seed(3), "cpu")
    lo0 = make_adapters(base, (("t", 4, ALL_FAMILIES),), 0.02, seed=60, device="cpu")["t"]
    stream = batches(SyntheticTokenDataset(512, seed=4), 4, 128, seed=5)
    toks = [torch.from_numpy(next(stream)) for _ in range(3)]
    out = {}
    for where in ("cpu", dev):
        params = _tree_to(base, where)
        lo = dict(lo0, adapters=_tree_to(lo0["adapters"], where))
        opt = make_optimizer(lr=1e-3, warmup_steps=1, total_steps=4, grad_clip=1.0)
        state = opt.init(lo["adapters"])
        step = make_lora_train_step(small, opt)
        losses = [float(step(lo, state, params, t.to(where))[2]) for t in toks]
        same = all(torch.equal(a.cpu(), b) for a, b in zip(_leaves(params), _leaves(base)))
        check(same, f"LoRA training changed the base ({where})")
        out[str(where)] = (losses, [p.detach().cpu() for p in _leaves(lo["adapters"])])
    (lc, ac), (lg, ag) = out["cpu"], out[str(dev)]
    err = max(float((a - b).abs().max()) for a, b in zip(ac, ag))
    rel = max(float((a - b).abs().max() / a.abs().max()) for a, b in zip(ac, ag))
    check(err <= 1e-4, f"LoRA train: card adapters {err:.3g} from the CPU's (tol 1e-4)")
    return {"losses_card": lg, "losses_cpu": lc, "adapter_max_abs_err": err,
            "adapter_max_err_over_leaf_max": rel}


# -- phase KE: the expert-indexed / int8 weight product -----------------------


KE_SRC = "elastic_gpu_scheduler_tpu_torch/csrc/expert_matmul.cu"
# KE replaces no Pallas kernel: the reference's work here is XLA's, in
# _moe_ffn_serve's gather / ragged_dot forms and in the wmat fusion
KE_REPLACES = {"moe": "elastic_gpu_scheduler_tpu/models/serving.py:358",
               "int8": "elastic_gpu_scheduler_tpu/models/quantize.py:62"}
# (label, T, E, K, N, int8, fp32 output, the path whose launches it reports,
# (projections the row stands for in a layer, or 0 for the unembed; "decode"
# or "prefill")); no two rows launch alike (kernel, grid, block, shared memory)
KE_SHAPES = [
    ("MoE decode, w_gate / w_in", 8, 8, 2048, 6912, False, False, "moe", (2, "decode")),
    ("MoE decode, w_out", 8, 8, 6912, 2048, False, True, "moe", (1, "decode")),
    ("MoE grouped prefill, w_gate / w_in", 512, 8, 2048, 6912, False, False, "moe",
     (2, "prefill")),
    ("MoE + int8 decode, w_gate / w_in", 8, 8, 2048, 6912, True, False, "moe_int8",
     (2, "decode")),
    ("MoE + int8 decode, w_out", 8, 8, 6912, 2048, True, True, "moe_int8", (1, "decode")),
    ("int8 dense decode, wq / wo", 8, 1, 2048, 2048, True, False, "int8", (2, "decode")),
    ("int8 dense decode, wk / wv", 8, 1, 2048, 1024, True, False, "int8", (2, "decode")),
    ("int8 dense decode, w_gate / w_in", 8, 1, 2048, 6912, True, False, "int8", (2, "decode")),
    ("int8 dense decode, w_out", 8, 1, 6912, 2048, True, False, "int8", (1, "decode")),
    ("int8 dense decode, unembed", 8, 1, 2048, 32000, True, False, "int8", (0, "decode")),
    ("int8 dense prefill, w_gate / w_in", 512, 1, 2048, 6912, True, False, "int8",
     (2, "prefill")),
]
# the weights a timed sequence cycles through: more than the 50 MB L2 holds,
# so each call finds its weight cold, as a decode step's layers do
KE_COLD_BYTES = 128 << 20
# KE against its plain version: a float32 output within this (absolute),
# a bf16 one within bf16's TOL + RTOL|ref|
KE_F32_TOL = 1e-3


def ke_within(got, want) -> bool:
    """KE's output ``got`` within its tolerance of ``want``, and finite."""
    import torch

    if got.dtype == torch.float32:
        return maxerr(got, want) <= KE_F32_TOL and bool(torch.isfinite(got).all())
    return close(got, want, "bfloat16")


def ke_bound_ms(T, K, N, touched, x_bytes, w_bytes, out_bytes, int8,
                peak=PEAK_BF16_FLOPS) -> tuple[float, str]:
    """x, ids and the touched experts' weights (and scales) read once, y
    written once; 2 FLOPs a product at ``peak`` (bf16's, or float32's on
    the CUDA cores)."""
    byts = T * K * x_bytes + T * 4 + touched * K * N * w_bytes + T * N * out_bytes
    byts += touched * N * 4 if int8 else 0
    t_ops = 2 * T * K * N / peak * 1e3
    t_bytes = byts / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# an H100 SM: shared memory (bytes, and 1 KB the card keeps a block),
# registers (allocated 256 a warp), threads and blocks
SM_SMEM, BLOCK_SMEM_RESERVED, SM_REGISTERS, SM_THREADS, SM_BLOCKS = 233472, 1024, 65536, 2048, 32


def resident_blocks(threads: int, smem: int, registers: int) -> dict:
    """Blocks of one launch an SM can hold at once, from the launch's
    threads, shared memory and registers a thread (the profiler's), and
    the resource that sets it."""
    warps = -(-threads // 32)
    limits = {"shared memory": SM_SMEM // (smem + BLOCK_SMEM_RESERVED),
              "registers": SM_REGISTERS // (warps * -(-registers * 32 // 256) * 256),
              "threads": SM_THREADS // threads, "blocks": SM_BLOCKS}
    by = min(limits, key=limits.get)
    return {"blocks": limits[by], "limited_by": by}


def ke_row_launches(rows, profiles: dict, path_launches: dict) -> None:
    """Each KE row's launches: on its path's main path (``launches``) and,
    measured by kernel launch (name, grid, block, shared memory) in the
    profiled windows of phases 6g and 6h, in one fused chunk
    (``launches_a_chunk``) or in one prefill of its T
    (``launches_a_prefill``).  Fails unless every KE launch of a chunk
    window is some decode row's, and each row's count is what its
    projections need: L layers x fused_steps steps each (the unembed once
    a step), or L layers a prefill."""
    L, K = FULL["n_layers"], ENGINE["fused_steps"]
    sigs = [r["launch"] for r in rows]
    check(len(set(sigs)) == len(sigs), f"two KE rows launch alike: {sigs}")
    decode = {r["launch"] for r in rows if r["_per"][1] == "decode"}
    for path, prof in profiles.items():
        stray = {s: n for s, n in prof["ke_launches"].items() if s not in decode}
        check(not stray, f"{path}: KE launches in a chunk that no KE row holds: {stray}")
    for r in rows:
        path, (n, kind), T = r.pop("_launch_path"), r.pop("_per"), r.pop("_T")
        prof = profiles[path]
        r["launches"] = path_launches[path]["expert_matmul"]
        if kind == "decode":
            got, want, key = prof["ke_launches"].get(r["launch"], 0), n * L * K if n else K, \
                "launches_a_chunk"
        else:
            prefills = prof["prefill_tpads"].count(T)
            check(prefills > 0, f"KE {r['path']}: the {path} window ran no prefill of T {T}")
            got = prof["ke_prefill_launches"].get(r["launch"], 0) / prefills
            want, key = n * L, "launches_a_prefill"
        r[key] = got
        log(f"KE {r['path']}: {got:g} launches a {key.rsplit('_', 1)[1]} on the {path} path "
            f"({r['launch'][:60]}...)")
        check(got == want, f"KE {r['path']}: {got} launches measured in a "
              f"{key.rsplit('_', 1)[1]} of the {path} path, {want} expected")


def ke_registers() -> dict:
    """ptxas's registers and spill bytes of KE's kernels, from the build
    log, by kernel (its name and template arguments as ptxas mangles them)."""
    from elastic_gpu_scheduler_tpu_torch.ops import _build

    types = {"a": "int8", "f": "float", "13__nv_bfloat16": "bf16", "S1_": "bf16",
             "S0_": "float", "Lb0E": "false", "Lb1E": "true"}
    lines = _build.build_log_path().read_text().splitlines()
    out, name = {}, None
    for line in lines:
        if "Compiling entry" in line:
            m = re.search(r"\d(expert_matmul_(?:ring_|wgmma_|combine_)?kernel)I(\w+?)EEv", line)
            args = re.findall("|".join(map(re.escape, types)), m.group(2)) if m else []
            name = f"{m.group(1)}<{', '.join(types[a] for a in args)}>" if m else None
        elif name and "registers" in line:
            out.setdefault(name, {})["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
        elif name and "spill" in line:
            out.setdefault(name, {})["spill_bytes"] = max(
                int(n) for n in re.findall(r"(\d+) bytes spill", line))
    check(out, "no ptxas line for KE in the build log")
    return out


class Cycle:
    """Calls each of ``fns`` in turn (one weight copy a call)."""

    def __init__(self, fns):
        self.fns, self.i = fns, 0

    def __call__(self):
        fn = self.fns[self.i % len(self.fns)]
        self.i += 1
        return fn()


def phase_ke(dev) -> list[dict]:
    """KE against its plain version at the main paths' shapes (bf16 and
    int8): tolerance, bitwise repeatable, the plan's kernel alone and once
    a call (no combine kernel after a split: the cluster adds the splits),
    a graph replay on a new routing equal to the eager call; the two
    readings (profiler and graph replay) over calls that each find their
    weight cold in L2, plain ms, library ms and bound.  The rows' launches
    come from phases 6g and 6h."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models.quantize import quantize_tensor
    from elastic_gpu_scheduler_tpu_torch.ops.expert_matmul import (
        dequantize,
        expert_matmul,
        expert_matmul_plan,
        expert_matmul_reference,
    )

    rows = []
    for label, T, E, K, N, int8, f32, path, per in KE_SHAPES:
        g = torch.Generator(device=dev).manual_seed(T + K)  # each row's data as before
        x = torch.randn(T, K, generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn(E, K, N, generator=g, device=dev) * K ** -0.5).to(torch.bfloat16)
        sc = None
        if int8:
            qt = quantize_tensor(w)
            w, sc = qt["q8"], qt["scale"]
        ids = (torch.randint(0, E, (T,), generator=g, device=dev, dtype=torch.int32)
               if E > 1 else None)
        out_dtype = torch.float32 if f32 else torch.bfloat16
        wbytes = w.numel() * w.element_size()
        copies = [(w, sc)] + [(w.clone(), None if sc is None else sc.clone())
                              for _ in range(-(-KE_COLD_BYTES // wbytes) - 1)]

        def kern(wi=w, si=sc):
            return expert_matmul(x, wi, ids, scale=si, out_dtype=out_dtype)

        def plain():
            return expert_matmul_reference(x, w, ids, sc, out_dtype)

        got, want = kern(), plain()
        err = maxerr(got, want)
        check(ke_within(got, want),
              f"KE {label}: disagrees with expert_matmul_reference (max err {err:.3g})")
        check(torch.equal(got, kern()), f"KE {label}: not bitwise repeatable")
        plan = expert_matmul_plan(x, w, ids)
        check(plan["tensor_cores"] and not plan["combine"],
              f"KE {label}: a bf16 row off the tensor-core kernels ({plan})")
        touched = len(set(ids.tolist())) if ids is not None else 1
        bound, by = ke_bound_ms(T, K, N, touched, 2, 1 if int8 else 2, 4 if f32 else 2, int8)
        cold = Cycle([lambda wi=wi, si=si: kern(wi, si) for wi, si in copies])
        reps = max(20, 2 * len(copies))
        rd = replay_readings(cold, reps, ("expert_matmul",), bound=bound)
        seen = {n: c for n, c in rd["kernels"].items() if "expert_matmul" in n}
        launch = rd["launches"]["expert_matmul"]
        check(len(seen) == 1 and plan["route"] in next(iter(seen))
              and next(iter(seen.values())) == reps and len(launch) == 1,
              f"KE {label}: the calls launched {seen} ({launch}), not {plan['route']} once "
              f"a call")
        plain_ms = device_ms(plain, 3)
        wd = dequantize(w, sc, torch.bfloat16)
        if E == 1:
            dense = [wd[0].contiguous()] + [wd[0].clone() for _ in
                                            range(-(-KE_COLD_BYTES // (2 * K * N)) - 1)]
            lib_ms = graph_ms(Cycle([lambda d=d: torch.matmul(x, d) for d in dense]),
                              max(20, 2 * len(dense)))
            lib = "torch.matmul on the dequantised bf16 weight (cold in L2)"
            del dense
        else:
            wg = wd[ids.long()]  # the gather itself is not timed
            x3 = x[:, None, :]
            lib_ms = graph_ms(lambda: torch.bmm(x3, wg), 5)
            lib = "torch.bmm on the pre-gathered (T, K, N) weights"
            del wg
        row = {
            "name": "expert_matmul", "path": label, "route": "cuda", "source": KE_SRC,
            "replaces": KE_REPLACES["int8" if path.startswith("int8") else "moe"],
            "launches": 0, "_launch_path": path, "_per": per, "_T": T,
            "launch": launch.pop(), "resident_blocks_a_sm": resident_blocks(
                **rd["attrs"]["expert_matmul"]), "max_abs_err": err,
            **reading_fields([(1, rd)], "expert_matmul"),
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "kernel": plan["route"], "cluster": plan["cluster"],
            "ring_depth": plan["ring_depth"], "weight_copies": len(copies),
            "note": f"no Pallas kernel: XLA's work in the reference; library: {lib}; "
                    f"{touched} experts touched; {plan['route']}, {plan['splits']} K splits "
                    f"(cluster {plan['cluster']}), ring depth {plan['ring_depth']}",
        }
        log(f"KE {label} (T {T}, E {E}, K {K}, N {N}, {touched} experts touched, "
            f"{plan['route']}, cluster {plan['cluster']}): graph {row['ms']:.5f} ms, profiler "
            f"{row['profiler_ms']:.5f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.5f} ms, "
            f"bound {bound:.5f} ms ({by}), of_bound {bound / row['ms']:.3f}, spreads "
            f"{rd['graph_spread']:.4f} / {rd['profiler_spread']:.4f}, resident "
            f"{row['resident_blocks_a_sm']}, max err {err:.3g}")
        rows.append(row)
        del wd, copies
    # a graph captured on one routing replays any other, equal to eager
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(8, 2048, generator=g, device=dev).to(torch.bfloat16)
    qt = quantize_tensor((torch.randn(8, 2048, 6912, generator=g, device=dev) * 0.02)
                         .to(torch.bfloat16))
    ids = torch.zeros(8, dtype=torch.int32, device=dev)
    expert_matmul(x, qt["q8"], ids, scale=qt["scale"])
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = expert_matmul(x, qt["q8"], ids, scale=qt["scale"])
    for routing in ([3] * 8, [7, 1, 1, 3, 0, 7, 2, 2], list(range(8))):
        ids.copy_(torch.tensor(routing, dtype=torch.int32))
        graph.replay()
        eager = expert_matmul(x, qt["q8"], ids, scale=qt["scale"])
        torch.cuda.synchronize()
        check(torch.equal(out, eager), f"KE graph replay != eager on routing {routing}")
    regs = ke_registers()
    log(f"KE: bitwise repeatable at every shape; every row on its tensor-core kernel alone, "
        f"once a call; a graph captured on one routing replays three others bitwise equal "
        f"to eager; ptxas {json.dumps(regs)}")
    rows[0]["ptxas"] = regs
    return rows


# KE's float32 path (its CUDA-core kernel, and the combine kernel after a
# split): the flagship MoE decode's w_gate / w_in product in float32, as
# phase 16(c)'s float32 MoE engines run it: T 8 tokens routed over E 8
# experts, K 2048, N 6912
KE_FP32 = (8, 8, 2048, 6912)


def kernel_ke_fp32_row(dev) -> dict:
    """KE's float32 path at KE_FP32 against its plain version, bitwise
    repeatable, read as the other KE rows are (453 MB of experts: every
    call finds its weights cold in L2), with float32 ``torch.bmm`` over
    the touched experts, pre-gathered once each, as the library call.  Launches are those of
    phase 16(c)'s one-device float32 MoE engine, filled in after it."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.ops.expert_matmul import (
        expert_matmul,
        expert_matmul_plan,
        expert_matmul_reference,
    )

    T, E, K, N = KE_FP32
    g = torch.Generator(device=dev).manual_seed(T + K)
    x = torch.randn(T, K, generator=g, device=dev)
    w = torch.randn(E, K, N, generator=g, device=dev) * K ** -0.5
    ids = torch.randint(0, E, (T,), generator=g, device=dev, dtype=torch.int32)
    got, want = expert_matmul(x, w, ids), expert_matmul_reference(x, w, ids)
    err = maxerr(got, want)
    check(ke_within(got, want),
          f"KE float32: disagrees with expert_matmul_reference (max err {err:.3g})")
    check(torch.equal(got, expert_matmul(x, w, ids)), "KE float32: not bitwise repeatable")
    plan = expert_matmul_plan(x, w, ids)
    check(not plan["tensor_cores"], f"KE float32 on a tensor-core kernel ({plan})")
    touched = len(set(ids.tolist()))
    bound, by = ke_bound_ms(T, K, N, touched, 4, 4, 4, False, PEAK_FP32_FLOPS)
    rd = replay_readings(lambda: expert_matmul(x, w, ids), 20, ("expert_matmul",), bound=bound)
    plain_ms = device_ms(lambda: expert_matmul_reference(x, w, ids), 3)
    # the library call reads each touched expert once, as the kernel does:
    # every token through every touched expert, then each token's own row
    # (the experts' gather itself is not timed)
    uniq, inv = torch.unique(ids.long(), return_inverse=True)
    wu, xu = w[uniq], x[None].expand(len(uniq), T, K).contiguous()
    tok = torch.arange(T, device=dev)
    lib_ms = graph_ms(lambda: torch.bmm(xu, wu)[inv, tok], 5)
    check(torch.allclose(torch.bmm(xu, wu)[inv, tok], want, rtol=1e-4, atol=1e-4),
          "KE float32's library call computes another function")
    del wu, xu
    row = {
        "name": "expert_matmul", "path": f"float32 MoE decode, w_gate / w_in (T {T}, E {E}, "
        f"K {K}, N {N})", "route": "cuda", "source": KE_SRC, "dtype": "float32",
        "replaces": KE_REPLACES["moe"], "launches": 0, "max_abs_err": err,
        **reading_fields([(1, rd)], "expert_matmul"),
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
        "kernel": plan["route"], "splits": plan["splits"],
        "note": f"no Pallas kernel: XLA's work in the reference; library: torch.bmm in float32 "
                f"of every token through the {touched} touched experts (each pre-gathered "
                f"once), then each token's row; "
                f"{plan['route']}, {plan['splits']} K splits; launches are phase 16(c)'s "
                f"one-device float32 MoE engine's (3 L a pass)",
    }
    log(f"KE float32 (T {T}, E {E}, K {K}, N {N}, {touched} experts touched, {plan['route']}, "
        f"{plan['splits']} splits): graph {row['ms']:.5f} ms, profiler "
        f"{row['profiler_ms']:.5f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.5f} ms, bound "
        f"{bound:.5f} ms ({by}), of_bound {bound / row['ms']:.3f}, kernels a call "
        f"{rd['kernels']}, max err {err:.3g}")
    del x, w, ids, got, want
    torch.cuda.empty_cache()
    return row


# -- phase 6g: MoE serving at full width ----------------------------------------


MOE_FULL = dict(FULL, n_experts=8)


def ke_per_pass(cfg, int8: bool) -> int:
    """KE launches in one forward pass of the engine (a decode step, a
    prefill or a verify pass): the 3 expert products a MoE layer; with
    int8 weights also wq, wk, wv, wo (and the dense FFN's 3) a layer and
    the unembed."""
    L = cfg.n_layers
    return (3 * L if cfg.n_experts else 0) + (int8 * (4 * L + (0 if cfg.n_experts else 3 * L) + 1))


def overlapped_run(eng, prompts, label, int8=False) -> dict:
    """A warm-up batch (captures), then the main path with exact counts:
    every chunk a replay, K1 L a prefill, K2 L x K a step, KE per pass."""
    from elastic_gpu_scheduler_tpu_torch.ops import _build

    cfg, L, K = eng.cfg, eng.cfg.n_layers, eng.fused_steps
    _, warm_s, _ = drive_wall(eng, prompts, NEW_TOKENS)
    captured, capture_s = eng.graphs_captured, eng.graph_capture_s
    base = (eng.graph_warmups, eng.graph_replays, eng.prefills_run)
    _build.reset_launches()
    reqs, wall, chunks = drive_wall(eng, prompts, NEW_TOKENS)
    launches = dict(_build.LAUNCHES)
    warmups, replays, prefills = (eng.graph_warmups - base[0], eng.graph_replays - base[1],
                                  eng.prefills_run - base[2])
    passes = K * (chunks + warmups) + prefills
    want = dict.fromkeys(launches, 0)
    want.update(flash_fwd=L * prefills, paged_attention=L * K * (chunks + warmups),
                expert_matmul=ke_per_pass(cfg, int8) * passes)
    log(f"{label} main path: {chunks} chunks ({replays} replays, {warmups} captures), "
        f"{prefills} prefills, launches {launches} (want {want})")
    check(replays == chunks, f"{label}: a decode chunk was not a graph replay")
    check(launches == want and (want["expert_matmul"] > 0) == (ke_per_pass(cfg, int8) > 0),
          f"{label}: launches differ from the path (KE per pass x passes, K1, K2)")
    gen = sum(len(r.output) for r in reqs)
    return {"reqs": reqs, "launches": launches,
            "perf": {"wall_s": wall, "generated_tokens": gen, "tokens_per_s": gen / wall,
                     "chunks": chunks, "wall_ms_per_chunk": wall / chunks * 1e3,
                     "prefills": prefills, "graphs_captured": captured,
                     "graph_capture_s": capture_s, "warmup_batch_s": warm_s}}


def profile_chunks(eng, prompts, label) -> dict:
    """Device ms, kernels and KE's share of CONTROL_WINDOW overlapped chunks.
    Each chunk is a replay of one CUDA graph, so a window holds each KE
    launch a whole number of times a chunk; a count that is not whole means
    the profiler lost a record (one or two of 1,536 in some runs on the
    H100), and the window runs again on a fresh batch, up to PROFILE_TRIES
    times.  The counts are then held exactly (``ke_row_launches``)."""
    for attempt in range(1, PROFILE_TRIES + 1):
        out = chunk_profile(eng, [(p, {}) for p in prompts], label, ke=True)
        counts = list(out.get("ke_launches", {}).values())  # none on a model without KE
        if all(float(c).is_integer() for c in counts):
            break
        log(f"{label}: KE launches a chunk {counts} are not whole, a record lost "
            f"(attempt {attempt} of {PROFILE_TRIES})")
    out["ke_share"] = out["ke_ms_per_chunk"] / out["device_ms_per_chunk"]
    log(f"{label}: KE {out['ke_ms_per_chunk']:.3f} device ms a chunk "
        f"({out['ke_share']:.3f} of the chunk), {out['ke_launches_per_chunk']:.0f} launches")
    return out


def phase_moe_engine(dev, prompts) -> tuple:
    """The flagship width with E 8 (Switch top-1, ~5.8B parameters, bf16,
    not cut): the overlapped engine (main path, exact counts), a new
    routing mix replaying without a capture, the sequential engine beside
    it, device ms a chunk, the int8 + prefix + chunked engine, spec_k 4 and
    one HTTP completion, all on the same weights."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine
    from elastic_gpu_scheduler_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
        param_count,
    )

    cfg = TransformerConfig(**MOE_FULL)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n = param_count(params)
    log(f"MoE engine: {n / 1e9:.3f}B parameters ({cfg.n_experts} experts, {cfg.n_layers} "
        f"layers, d={cfg.d_model}, F={cfg.d_ff}), {cfg.dtype}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    eng = InferenceEngine(params, cfg, paged_kernel=True, device=dev, **ENGINE)
    run = overlapped_run(eng, prompts, "MoE overlapped")
    perf = {"params_b": n / 1e9, "overlap": run["perf"]}
    # another routing mix on the same table-view buckets: a replay
    rng = np.random.default_rng(21)
    other = [rng.integers(0, cfg.vocab_size, len(p)).tolist() for p in prompts]
    cap0 = eng.graphs_captured
    drive_wall(eng, other, NEW_TOKENS)
    check(eng.graphs_captured == cap0, "MoE: a new routing mix captured a graph")
    seng = InferenceEngine(params, cfg, paged_kernel=True, overlap=False, device=dev, **ENGINE)
    sreqs, swall, schunks = drive_wall(seng, prompts, NEW_TOKENS)
    del seng
    gen = perf["overlap"]["generated_tokens"]
    agree = agreement(run["reqs"], sreqs)
    check(agree["first_tokens_equal"] == len(prompts),
          "MoE: overlapped and sequential engines differ in first tokens")
    perf["sequential"] = {"wall_s": swall, "tokens_per_s": gen / swall, "chunks": schunks,
                          "wall_ms_per_chunk": swall / schunks * 1e3}
    perf["overlap_vs_sequential_tokens"] = agree
    perf["new_routing_mix_captures"] = eng.graphs_captured - cap0
    log(f"MoE overlapped vs sequential: {perf['overlap']['tokens_per_s']:.1f} vs "
        f"{gen / swall:.1f} tokens/s; tokens equal {agree['tokens_equal']}/{agree['tokens']}")
    perf["profile"] = profile_chunks(eng, prompts, "MoE")
    perf["http"] = phase_moe_http(eng, prompts[1])
    del eng
    perf["prefix"] = phase_moe_prefix(dev, params, cfg)
    perf["spec"] = phase_moe_spec(dev, params, cfg, prompts, sreqs)
    log("MoE engine perf: " + json.dumps(perf))
    return perf, run["launches"], params, cfg, run["reqs"]


def phase_moe_http(eng, prompt) -> dict:
    """One /v1/completions through ``serve_inference`` on the MoE engine,
    against the engine's own tokens."""
    from elastic_gpu_scheduler_tpu_torch.models.serving import Request
    from elastic_gpu_scheduler_tpu_torch.server.inference import serve_inference

    server, loop = serve_inference(eng, port=0, host="127.0.0.1")
    addr = server.server_address
    try:
        code, _, data = post_json(addr, {"prompt": prompt, "max_tokens": 16})
        check(code == 200, f"MoE completion answered {code}")
        tokens = json.loads(data)["tokens"]
        direct = eng.submit(Request(prompt=list(prompt), max_new_tokens=16))
        check(direct.done.wait(300) and not direct.error, "MoE direct request failed")
        check(tokens == direct.output, "MoE HTTP tokens differ from the engine's own")
        code, stats = get_json(addr, "/v1/stats")
        check(code == 200, f"MoE /v1/stats answered {code}")
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()
    log("MoE HTTP: a blocking completion equals the engine's 16 tokens; /v1/stats answers")
    return {"completion_tokens": len(tokens), "stats_steps_run": stats["steps_run"]}


def phase_moe_prefix(dev, params, cfg) -> dict:
    """Phase 6b's traffic on the MoE weights through the int8-KV, prefix,
    chunked engine: exact launches (K1 / K3 per pass, K2-int8 per step, KE
    3L per pass and step) and the prefix counters the traffic gives."""
    from elastic_gpu_scheduler_tpu_torch.models import serving
    from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine
    from elastic_gpu_scheduler_tpu_torch.ops import _build

    rng = np.random.default_rng(12)
    wave1, wave2 = prefix_traffic(rng, cfg.vocab_size, SHARED_PREFIX, WAVE1_LENS, WAVE2_TAILS)
    eng = InferenceEngine(params, cfg, device=dev, **PREFIX_ENGINE)
    passes = {"plain": 0, "prefixed": 0}

    def counted(fn, kind):
        def call(*args, **kw):
            passes[kind] += 1
            return fn(*args, **kw)
        return call

    real = (serving._paged_prefill, serving._paged_prefill_prefixed)
    serving._paged_prefill = counted(real[0], "plain")
    serving._paged_prefill_prefixed = counted(real[1], "prefixed")
    _build.reset_launches()
    t0 = time.perf_counter()
    try:
        reqs1, _, _ = drive(eng, wave1, NEW_TOKENS)
        t1 = time.perf_counter()
        reqs2, ta2, _ = drive(eng, wave2, NEW_TOKENS)
    finally:
        serving._paged_prefill, serving._paged_prefill_prefixed = real
    t2 = time.perf_counter()
    launches = dict(_build.LAUNCHES)
    L, K = cfg.n_layers, eng.fused_steps
    want = dict.fromkeys(launches, 0)
    want.update(flash_fwd=L * passes["plain"], flash_block_stats=L * passes["prefixed"],
                paged_attention_int8=L * K * eng.steps_run,
                expert_matmul=3 * L * (passes["plain"] + passes["prefixed"] + K * eng.steps_run))
    counters = {"prefix_lookups": eng.prefix_lookups,
                "prefix_admission_hits": eng.prefix_admission_hits,
                "prefix_hit_tokens": eng.prefix_hit_tokens}
    want_c = {"prefix_lookups": len(wave1) + len(wave2), "prefix_admission_hits": len(wave2),
              "prefix_hit_tokens": len(wave2) * SHARED_PREFIX}
    log(f"MoE prefix engine: passes {passes}, chunks {eng.steps_run}, launches {launches} "
        f"(want {want}); counters {counters} (want {want_c})")
    check(launches == want, "MoE prefix engine launches differ from the path")
    check(counters == want_c, "MoE prefix counters differ from the traffic")
    gen = sum(len(r.output) for r in reqs1 + reqs2)
    return {"wall_s": t2 - t0, "tokens_per_s": gen / (t2 - t0), "passes": passes,
            "chunks": eng.steps_run, "counters": counters,
            "wave2_prefill_ms_per_request": ta2 / len(wave2) * 1e3,
            "wave1_s": t1 - t0}


def phase_moe_spec(dev, params, cfg, prompts, seq_reqs) -> dict:
    """spec_k 4 (prompt lookup) on the MoE weights: a verify pass is 8 x 5
    tokens through KE's grouped form; greedy first tokens equal the
    sequential engine's; KE 3L per pass and decode step."""
    from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine
    from elastic_gpu_scheduler_tpu_torch.ops import _build

    eng = InferenceEngine(params, cfg, paged_kernel=True, spec_k=SPEC_K, device=dev, **ENGINE)
    marks = spec_marks(eng)
    p0 = eng.prefills_run
    _build.reset_launches()
    reqs, wall, _ = drive_wall(eng, prompts, NEW_TOKENS)
    ke = _build.LAUNCHES["expert_matmul"]
    c = spec_counts(eng, marks)
    chunks = c["steps"] - c["passes"]
    want = 3 * cfg.n_layers * (c["passes"] + eng.fused_steps * (chunks + c["warmups"])
                               + eng.prefills_run - p0)
    check(c["passes"] > 0 and ke == want, f"MoE spec: KE launches {ke} != {want}")
    agree = agreement(reqs, seq_reqs)
    check(agree["first_tokens_equal"] == len(prompts),
          "MoE spec_k 4 differs from the sequential engine in first tokens")
    gen = sum(len(r.output) for r in reqs)
    log(f"MoE spec_k {SPEC_K}: {gen / wall:.1f} tokens/s, {c['passes']} passes, "
        f"{c['accepted']} accepted; tokens equal {agree['tokens_equal']}/{agree['tokens']}")
    return {"wall_s": wall, "tokens_per_s": gen / wall, **c, "vs_sequential": agree}


# -- phase 6h: int8 weights ---------------------------------------------------------


def phase_int8_engine(dev, params, cfg, prompts, moe_params, moe_cfg,
                      moe_reqs) -> tuple[dict, dict, dict]:
    """The dense flagship after ``quantize_params``, overlapped, beside the
    bf16 engine in the same call (tokens/s, device ms a chunk, weight
    bytes); first tokens against bf16 (reported); then the MoE weights
    quantized (E 8)."""
    from elastic_gpu_scheduler_tpu_torch.models.quantize import quantize_params, quantized_bytes
    from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine

    beng = InferenceEngine(params, cfg, paged_kernel=True, device=dev, **ENGINE)
    brun = overlapped_run(beng, prompts, "bf16 overlapped (beside int8)")
    bprof = profile_chunks(beng, prompts, "bf16")
    del beng
    qparams = quantize_params(params)
    qeng = InferenceEngine(qparams, cfg, paged_kernel=True, device=dev, **ENGINE)
    qrun = overlapped_run(qeng, prompts, "int8 overlapped", int8=True)
    prof = profile_chunks(qeng, prompts, "int8")
    del qeng
    first = sum(a.output[0] == b.output[0] for a, b in zip(qrun["reqs"], brun["reqs"]))
    perf = {"bf16": brun["perf"], "int8": qrun["perf"], "int8_profile": prof,
            "bf16_profile": bprof,
            "weight_bytes": {"int8": quantized_bytes(qparams), "bf16": quantized_bytes(params)},
            "first_tokens_equal_to_bf16": first}
    log(f"int8 weights: {qrun['perf']['tokens_per_s']:.1f} vs bf16 "
        f"{brun['perf']['tokens_per_s']:.1f} tokens/s; device ms a chunk "
        f"{prof['device_ms_per_chunk']:.2f} vs bf16 {bprof['device_ms_per_chunk']:.2f}; "
        f"weight bytes "
        f"{perf['weight_bytes']['int8'] / 1e9:.3f} GB vs {perf['weight_bytes']['bf16'] / 1e9:.3f}"
        f" GB; first tokens equal to bf16 {first}/{len(prompts)} (int8 changes the model)")
    del qparams
    qmoe = quantize_params(moe_params)
    meng = InferenceEngine(qmoe, moe_cfg, paged_kernel=True, device=dev, **ENGINE)
    mrun = overlapped_run(meng, prompts, "MoE + int8 overlapped", int8=True)
    mprof = profile_chunks(meng, prompts, "MoE + int8")
    del meng
    mfirst = sum(a.output[0] == b.output[0] for a, b in zip(mrun["reqs"], moe_reqs))
    perf["moe_int8"] = {**mrun["perf"], "profile": mprof,
                        "weight_bytes": quantized_bytes(qmoe),
                        "first_tokens_equal_to_moe_bf16": mfirst}
    log(f"MoE + int8: {mrun['perf']['tokens_per_s']:.1f} tokens/s, device ms a chunk "
        f"{mprof['device_ms_per_chunk']:.2f}, weight bytes {quantized_bytes(qmoe) / 1e9:.3f} GB; "
        f"first tokens equal to MoE bf16 {mfirst}/{len(prompts)}")
    del qmoe
    log("int8 engine perf: " + json.dumps(perf))
    return perf, qrun["launches"], mrun["launches"]


# -- phase 6i: small float32 MoE and int8 engines, card against CPU -----------


def phase_moe_int8_small_fp32(dev) -> dict:
    """Small float32 MoE (E 4, router sharpened so tokens spread), int8
    dense and MoE + int8 engines: greedy tokens on the card equal the
    port's CPU run, sequential, overlapped, int8 KV + prefix + chunked and
    spec_k 4."""
    from elastic_gpu_scheduler_tpu_torch.models.quantize import quantize_params
    from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig, init_params
    import torch

    small_moe = TransformerConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=4,
                                  n_kv_heads=2, d_ff=512, dtype="float32", n_experts=4)
    mp = init_params(small_moe, torch.Generator().manual_seed(3), "cpu")
    mp["layers"]["moe_gate"] = mp["layers"]["moe_gate"] * 8.0
    small, sp = small_fp32()
    models = {"MoE": (small_moe, mp), "int8": (small, quantize_params(sp)),
              "MoE + int8": (small_moe, quantize_params(mp))}
    modes = {"sequential": dict(overlap=False), "overlapped": dict(overlap=True),
             "int8 KV prefix chunked": dict(kv_int8=True, prefix_cache=True, prefill_chunk=16),
             f"spec_k {SPEC_K}": dict(spec_k=SPEC_K)}
    rng = np.random.default_rng(16)
    specs = [(rng.integers(0, 512, n).tolist(), {}) for n in (3, 5, 17, 40, 9, 1)]
    for name, (c, p) in models.items():
        for mode, kw in modes.items():
            outs = {str(where): [r.output for r in drive_small(small_engine(p, c, where, **kw),
                                                                  specs)]
                    for where in ("cpu", dev)}
            check(outs["cpu"] == outs[str(dev)], f"float32 {name}: card differs from CPU ({mode})")
    log(f"small float32 MoE / int8 / MoE + int8 engines: card = CPU in {len(modes)} modes each")
    return {"models": list(models), "modes": list(modes)}


# -- phase 6j: disaggregated serving ---------------------------------------------


DISAGG_NEW = 32  # tokens each adopted (and each single-engine) completion generates
MIGRATE_NEW = 128  # tokens of a migrated stream
# client tokens before the move: the prefill's and one decode chunk's
MIGRATE_AFTER = 1 + PREFIX_ENGINE["fused_steps"]


def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def sse(addr, path, body, headers=None, on_token=None):
    """One streamed POST: (tokens, each token's arrival time, error events);
    ``on_token(count)`` runs after each token event."""
    conn = http.client.HTTPConnection(*addr, timeout=300)
    conn.request("POST", path, json.dumps(dict(body, stream=True)),
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    check(resp.status == 200, f"{path} stream answered {resp.status}")
    toks, times, errors = [], [], []
    while True:
        line = resp.readline()
        if not line:
            break
        line = line.strip()
        if not line.startswith(b"data: "):
            continue
        if line[6:] == b"[DONE]":
            resp.read()  # the chunked body's end: the connection closes clean
            break
        ev = json.loads(line[6:])
        if "error" in ev:
            errors.append(ev)
        if "token" in ev:
            toks.append(ev["token"])
            times.append(time.perf_counter())
            if on_token is not None:
                on_token(len(toks))
    conn.close()
    return toks, times, errors


def closed_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def timed_calls(eng, name: str, dev, record: list) -> None:
    """Time each call of ``eng.<name>`` (on the engine thread, through
    ``run_task``) to the end of its device work; record (ms, result), the
    result kept only when it is a bundle or a dict."""
    real = getattr(eng, name)

    def call(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        sync(dev)
        record.append(((time.perf_counter() - t0) * 1e3,
                       out if isinstance(out, (bytes, dict)) else None))
        return out

    setattr(eng, name, call)


def migrate_stream(addr_src, dest, prompt, max_new):
    """Stream ``prompt`` from the source and move it to ``dest`` once
    MIGRATE_AFTER tokens reached the client: (tokens, arrival times,
    errors, migrate status, migrate body, migrate start time)."""
    import threading

    box = {}

    def move():
        box["t0"] = time.perf_counter()
        box["status"], _, data = post_json(addr_src, {"dest": dest}, path="/v1/migrate/out")
        box["body"] = json.loads(data)

    mover = threading.Thread(target=move, daemon=True)
    toks, times, errors = sse(addr_src, "/v1/completions", {"prompt": prompt, "max_tokens": max_new},
                              on_token=lambda n: n == MIGRATE_AFTER and mover.start())
    mover.join(timeout=120)
    check(not mover.is_alive() and "status" in box, "the migration request did not finish")
    return toks, times, errors, box["status"], box["body"], box["t0"]


SPLIT_REPEATS = 5  # timed rounds of the split and the cold run, fresh prompts each
MIGRATE_REPEATS = 4  # timed migrations after the checked one, fresh prompts each


def spread(xs) -> dict:
    """The median and the range of repeated readings."""
    return {"median": float(np.median(xs)), "min": float(min(xs)), "max": float(max(xs)),
            "n": len(xs)}


def decode_bundles(record, decode_ms) -> None:
    """Time each recorded bundle's decode (on the host, between rounds)
    and keep only its size."""
    from elastic_gpu_scheduler_tpu_torch.utils import kvwire

    for n, (ms, out) in enumerate(record):
        if isinstance(out, bytes):
            t0 = time.perf_counter()
            kvwire.decode_bundle(out)
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            record[n] = (ms, len(out))


def phase_disagg(dev, params, cfg, kv_int8: bool) -> dict:
    """The disaggregated data plane at full width, on 6b's options with a
    bf16 or an int8 pool.  Two ``serve_inference`` servers on one card, P
    (role prefill) and D (role decode), sharing the weight tensors: 6b's
    shared prefix and its 700- and 900-token prompts go to P's
    /v1/prefill, then to D's /v1/completions with ``X-KV-Source: P``.
    Checked: D's imported pages and prefix hits equal the traffic; D's
    launches are exact (K1 none, K3 L x passes, K2 L x fused_steps x
    chunks); sampled K2 and K3 calls of D's path agree with their plain
    versions; D's tokens equal a single engine's local warm hit on every
    token and its cold run on the first.  Then a stream on an overlapped
    engine A moved to B by /v1/migrate/out after one chunk (at most one
    chunk discarded), a refused handoff resumed locally, and a captured
    decode graph on B replayed over freshly imported pages equal to the
    eager chunk, with no new capture.  Numbers, each the median and range
    of repeats on fresh prompts after a warm-up of every shape: bundle
    bytes and pages, export and import ms as engine tasks, /v1/prefill +
    adoption against a cold prefill, the migration's wall to its first
    relayed token."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models import generate, serving
    from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine, Request
    from elastic_gpu_scheduler_tpu_torch.ops import _build
    from elastic_gpu_scheduler_tpu_torch.server.inference import serve_inference
    from elastic_gpu_scheduler_tpu_torch.utils import kvwire

    label = "int8 KV" if kv_int8 else "bf16 KV"
    opts = dict(PREFIX_ENGINE, kv_int8=kv_int8)
    ps, L = opts["page_size"], cfg.n_layers
    wave1, _ = prefix_traffic(np.random.default_rng(12), cfg.vocab_size, SHARED_PREFIX,
                              WAVE1_LENS, WAVE2_TAILS)
    prompts = [wave1[0][:SHARED_PREFIX], wave1[1], wave1[2]]  # 256, 700 and 900 tokens
    shapes = [len(p) for p in prompts]
    mrng = np.random.default_rng(16)
    moved, refused = (mrng.integers(0, cfg.vocab_size, WAVE1_LENS[1]).tolist() for _ in range(2))

    def fresh(n):
        return mrng.integers(0, cfg.vocab_size, n).tolist()

    engines = {
        "P": InferenceEngine(params, cfg, device=dev, **opts),
        "D": InferenceEngine(params, cfg, device=dev, **opts),
        "C": InferenceEngine(params, cfg, device=dev, **opts),  # one engine: no shipping
        "A": InferenceEngine(params, cfg, device=dev, **dict(opts, overlap=True)),
        "B": InferenceEngine(params, cfg, device=dev, **dict(opts, overlap=True)),
    }
    check(all(e.params["embed"] is engines["P"].params["embed"] for e in engines.values()),
          "the engines do not share the weight tensors")
    P, D, C, A, B = (engines[n] for n in "PDCAB")
    P.replica_name, P.fleet_role = "P", "prefill"
    D.replica_name, D.fleet_role = "D", "decode"
    t_start = time.perf_counter()
    # first use outside the measurements: one prompt of each shape through
    # the split and a cold run; the counters checked below are deltas past it
    with torch.inference_mode():
        for n in shapes:
            first_use = fresh(n)
            for e in (P, C):
                e.submit(Request(prompt=first_use, max_new_tokens=2))
                e.run_until_idle()
            D.import_pages(*kvwire.decode_bundle(P.export_prefix_pages(first_use)))
            D.submit(Request(prompt=first_use, max_new_tokens=2))
            D.run_until_idle()
    names = ("kv_pages_exported", "kv_exports", "kv_pages_imported", "kv_imports",
             "prefix_lookups", "prefix_admission_hits", "prefix_hit_tokens")
    base = {e: {n: getattr(e, n) for n in names} for e in (P, D)}

    def delta(e):
        return {n: getattr(e, n) - base[e][n] for n in names}

    servers = {n: serve_inference(e, port=0, host="127.0.0.1") for n, e in engines.items()}
    addr = {n: s[0].server_address for n, s in servers.items()}
    source = {kvwire.KV_SOURCE_HEADER: "%s:%d" % addr["P"]}
    exports, payloads, imports = [], [], []
    timed_calls(P, "_export", dev, exports)  # the export task, as the route runs it
    timed_calls(P, "_page_payloads", dev, payloads)  # the gather and copy out, within export
    timed_calls(D, "_import", dev, imports)
    passes = {"plain": 0, "prefixed": 0}
    real = (serving._paged_prefill, serving._paged_prefill_prefixed,
            generate.flash_block_stats, serving._paged_attn_call)

    def counted(fn, kind):
        def call(*args, **kw):
            passes[kind] += 1
            return fn(*args, **kw)
        return call

    serving._paged_prefill = counted(real[0], "plain")
    serving._paged_prefill_prefixed = counted(real[1], "prefixed")
    res = {"pool": label}
    try:
        # the split's first half: P prefills (its own launches exact)
        _build.reset_launches()
        for p in prompts:
            code, _, data = post_json(addr["P"], {"prompt": p}, path="/v1/prefill")
            check(code == 200 and json.loads(data)["pages"] == (len(p) - 1) // ps,
                  f"/v1/prefill answered {code}: {data[:200]!r}")
        sync(dev)
        lp = dict(_build.LAUNCHES)
        want = dict.fromkeys(lp, 0)
        want.update(flash_fwd=L * passes["plain"], flash_block_stats=L * passes["prefixed"])
        check(lp == want, f"{label}: P's prefill launches {lp} differ from {want}")
        p_passes = dict(passes)

        # the split's second half: D adopts from P, then decodes; the main
        # path of this phase, its counts at 0 just before.  K3 and K2 calls
        # are sampled (K2's split plan follows the table view: 32 and 64
        # pages here, the 900-token prompt's 64 beyond 6's 40)
        k3s = CallSampler(lambda q, k, v, q_off, k_off, causal=True: (
            q.clone(), k.clone(), v.clone(), int(q_off), int(k_off), causal), every=13, keep=4)
        k2s = k2_sampler(every=193, keep=8)
        generate.flash_block_stats = k3s.wrap(real[2])
        serving._paged_attn_call = k2s.wrap(real[3])
        passes.update(plain=0, prefixed=0)
        steps0 = D.steps_run
        sync(dev)
        _build.reset_launches()
        adopted = []
        for p in prompts:
            toks, _, errors = sse(addr["D"], "/v1/completions",
                                  {"prompt": p, "max_tokens": DISAGG_NEW}, headers=source)
            check(len(toks) == DISAGG_NEW and not errors, f"{label}: D's stream {errors}")
            adopted.append(toks)
        sync(dev)
        launches = dict(_build.LAUNCHES)
        generate.flash_block_stats, serving._paged_attn_call = real[2], real[3]
        chunks = D.steps_run - steps0
        k2 = "paged_attention_int8" if kv_int8 else "paged_attention"
        want = dict.fromkeys(launches, 0)
        want.update({"flash_block_stats": L * passes["prefixed"], k2: L * D.fused_steps * chunks})
        log(f"{label}: D's main path: passes {passes}, chunks {chunks}, launches {launches} "
            f"(want {want})")
        check(launches == want and passes == {"plain": 0, "prefixed": len(prompts)} and chunks > 0,
              f"{label}: D's launches differ from K1 0, K3 L x passes, K2 L x fused_steps x chunks")
        # D's path's kernels against their plain versions, on the sampled inputs
        k2_err = check_verify_samples(k2s.calls, k2, f"{label} D's adopted decode", width=1)
        plans = sorted({(int(c[2].shape[1]), k2_splits(c[0], c[1]["k"].shape[2], c[2].shape[1]))
                        for c in k2s.calls})
        log(f"{label}: D's sampled {k2} calls: (table pages, splits) {plans}")
        check(k3s.calls, f"{label}: no K3 call of D's adopted prefill was sampled")
        k3_err = max(check_k3(*c, label=f"{label} D's adopted prefill (t0 {c[3]}, "
                              f"{c[0].shape[2]} rows)") for c in k3s.calls)
        res["kernels_checked"] = {
            k2: {"calls": len(k2s.calls), "max_abs_err": k2_err,
                 "table_pages_and_splits": plans},
            "flash_block_stats": {"calls": len(k3s.calls), "max_abs_err": k3_err}}
        n_pages = sum((len(p) - 1) // ps for p in prompts)
        dp, dd = delta(P), delta(D)
        check(dd["kv_pages_imported"] == dp["kv_pages_exported"] == n_pages
              and dd["kv_imports"] == dp["kv_exports"] == len(prompts),
              f"{label}: pages shipped {dp} / imported {dd}, not {n_pages}")
        check(dd["prefix_lookups"] == dd["prefix_admission_hits"] == len(prompts)
              and dd["prefix_hit_tokens"] == n_pages * ps,
              f"{label}: D's prefix counters {dd} differ from the traffic")
        _, stats = get_json(addr["D"], "/v1/stats")
        check(stats["role"] == "decode" and stats["replica"] == "D"
              and stats["kv"]["pages_imported"] == D.kv_pages_imported,
              f"{label}: D's /v1/stats off")
        bundle_bytes = [len(out) for _, out in exports]

        # the single engine: cold, then its own warm hit
        cold, warm = [], []
        for p in prompts:
            cold.append(sse(addr["C"], "/v1/completions", {"prompt": p, "max_tokens": DISAGG_NEW})[0])
        for p in prompts:
            warm.append(sse(addr["C"], "/v1/completions", {"prompt": p, "max_tokens": DISAGG_NEW})[0])
        check(adopted == warm, f"{label}: adopted tokens differ from the single engine's warm hit")
        firsts = sum(a[0] == c[0] for a, c in zip(adopted, cold))
        check(firsts == len(prompts), f"{label}: first tokens after adoption differ from the "
              f"single engine's cold run ({firsts}/{len(prompts)})")
        # P's bundle of the 700-token prompt, for the graph check below
        code, _, graph_bundle = post_json(addr["P"], {"tokens": prompts[1]}, path="/v1/kv/export")
        check(code == 200, f"{label}: /v1/kv/export answered {code}")
        t_split = time.perf_counter()

        # the timed rounds: each shape's fresh prompt through the split
        # (P's /v1/prefill, then D's first token with adoption) and cold on C
        for record in (exports, payloads, imports):
            record.clear()
        decode_ms = []
        rounds = {k: [[] for _ in shapes] for k in ("prefill", "adopt", "split", "cold")}
        for _ in range(SPLIT_REPEATS):
            for s, n in enumerate(shapes):
                p = fresh(n)
                t0 = time.perf_counter()
                code, _, data = post_json(addr["P"], {"prompt": p}, path="/v1/prefill")
                t1 = time.perf_counter()
                check(code == 200, f"/v1/prefill answered {code}: {data[:200]!r}")
                toks, times, errors = sse(addr["D"], "/v1/completions",
                                          {"prompt": p, "max_tokens": 1}, headers=source)
                check(len(toks) == 1 and not errors, f"{label}: D's stream {errors}")
                rounds["prefill"][s].append((t1 - t0) * 1e3)
                rounds["adopt"][s].append((times[0] - t1) * 1e3)
                rounds["split"][s].append((times[0] - t0) * 1e3)
                t0 = time.perf_counter()
                toks, times, _ = sse(addr["C"], "/v1/completions", {"prompt": p, "max_tokens": 1})
                rounds["cold"][s].append((times[0] - t0) * 1e3)
            decode_bundles(exports, decode_ms)
        check(len(exports) == len(imports) == len(payloads) == SPLIT_REPEATS * len(shapes),
              f"{label}: {len(exports)} exports and {len(imports)} imports in the timed rounds")
        check(all(r["imported"] == (n - 1) // ps
                  for (_, r), n in zip(imports, shapes * SPLIT_REPEATS)),
              f"{label}: a timed round did not adopt every page")

        def per_shape(values):
            return [spread(values[s::len(shapes)]) for s in range(len(shapes))]

        sizes = [b for _, b in exports]
        res.update({
            "prompts": shapes, "pages": [(n - 1) // ps for n in shapes],
            "bundle_bytes": bundle_bytes,
            "bytes_per_page": bundle_bytes[-1] / ((shapes[-1] - 1) // ps),
            "repeats": SPLIT_REPEATS,
            "export_ms": per_shape([ms for ms, _ in exports]),
            "export_gather_copy_ms": per_shape([ms for ms, _ in payloads]),
            "decode_ms": per_shape(decode_ms),
            "import_ms": per_shape([ms for ms, _ in imports]),
            "export_gb_s": per_shape([b / ms / 1e6 for b, (ms, _) in zip(sizes, exports)]),
            "import_gb_s": per_shape([b / ms / 1e6 for b, (ms, _) in zip(sizes, imports)]),
            "prefill_route_ms": [spread(x) for x in rounds["prefill"]],
            "adopt_ttft_ms": [spread(x) for x in rounds["adopt"]],
            "split_ttft_ms": [spread(x) for x in rounds["split"]],
            "cold_ttft_ms": [spread(x) for x in rounds["cold"]],
            # each round's split over the same round's cold first token
            "split_over_cold": [spread([a / b for a, b in zip(x, y)])
                                for x, y in zip(rounds["split"], rounds["cold"])],
            "p_passes": p_passes, "d_launches": {k: v for k, v in launches.items() if v},
            "d_chunks": chunks, "first_tokens_vs_cold": firsts,
            "common_prefix_vs_cold": [common_prefix(a, c) for a, c in zip(adopted, cold)],
        })

        # live migration: A's stream moves to B after one chunk (checked
        # once, then timed on fresh prompts)
        ref_moved = sse(addr["C"], "/v1/completions", {"prompt": moved, "max_tokens": MIGRATE_NEW})[0]
        ref_refused = sse(addr["C"], "/v1/completions",
                          {"prompt": refused, "max_tokens": MIGRATE_NEW})[0]
        walls, dones, lost_l, shipped = [], [], [], []
        for r in range(1 + MIGRATE_REPEATS):
            prompt = moved if r == 0 else fresh(len(moved))
            lost0 = A.chunks_discarded
            toks, times, errors, code, body, t_move = migrate_stream(
                addr["A"], "%s:%d" % addr["B"], prompt, MIGRATE_NEW)
            check(code == 200 and body["ok"], f"{label}: /v1/migrate/out answered {code} {body}")
            lost = A.chunks_discarded - lost0
            done = body["tokens_done"]
            check(len(toks) == MIGRATE_NEW and not errors and done >= MIGRATE_AFTER,
                  f"{label}: the migrated stream gave {len(toks)} tokens, errors {errors}")
            check(lost <= 1, f"{label}: the migration discarded {lost} chunks")
            check(A.sessions_migrated_out == B.sessions_migrated_in == r + 1,
                  f"{label}: migration counters off")
            if r == 0:
                first = toks
            walls.append((times[done] - t_move) * 1e3)
            dones.append(done)
            lost_l.append(lost)
            shipped.append(body["pages_shipped"])
        res["migration"] = {
            "tokens_before_move": dones, "pages_shipped": shipped, "chunks_discarded": lost_l,
            "wall_ms_to_first_relayed_token": {"first": walls[0], **spread(walls[1:])},
            "tokens_equal_unmigrated": sum(a == b for a, b in zip(first, ref_moved)),
            "common_prefix_unmigrated": common_prefix(first, ref_moved),
            "a_graphs": A.graphs_captured, "b_graphs": B.graphs_captured,
        }
        migrated = A.sessions_migrated_out
        toks, _, errors, code, body, _ = migrate_stream(
            addr["A"], "127.0.0.1:%d" % closed_port(), refused, MIGRATE_NEW)
        check(code == 502 and body.get("resumed_local") is True,
              f"{label}: a refused handoff answered {code} {body}")
        check(len(toks) == MIGRATE_NEW and not errors, f"{label}: the resumed stream {errors}")
        check(A.sessions_migrated_out == migrated, f"{label}: the refused hop was not rolled back")
        res["refused"] = {"tokens_equal_unmigrated": sum(a == b for a, b in zip(toks, ref_refused)),
                          "common_prefix_unmigrated": common_prefix(toks, ref_refused)}
        mig = res["migration"]
        log(f"{label}: migrations after {dones} tokens ({shipped} pages, {lost_l} chunks "
            f"discarded): first relayed token {walls[0]:.1f} ms after /v1/migrate/out the "
            f"first time, then median {mig['wall_ms_to_first_relayed_token']['median']:.1f} "
            f"ms (range {min(walls[1:]):.1f}-{max(walls[1:]):.1f}, {MIGRATE_REPEATS} runs); "
            f"{mig['tokens_equal_unmigrated']}/{MIGRATE_NEW} tokens equal the "
            f"unmigrated stream; refused handoff resumed locally "
            f"({res['refused']['tokens_equal_unmigrated']}/{MIGRATE_NEW} equal)")
    finally:
        (serving._paged_prefill, serving._paged_prefill_prefixed,
         generate.flash_block_stats, serving._paged_attn_call) = real
        for server, loop in servers.values():
            server.shutdown()
            server.server_close()
            loop.stop()

    # a captured decode graph across an import, driven here (B's loop is
    # stopped): the replay reads the new pages, equal to the eager chunk
    check(B.graphs_captured > 0, f"{label}: B captured no graph")
    captured = B.graphs_captured
    hdr, pages = kvwire.decode_bundle(graph_bundle)
    ptrs = {k: t.data_ptr() for k, t in B.kv.items()}
    got = B.import_pages(hdr, pages)
    check(got["imported"] == len(pages) and ptrs == {k: t.data_ptr() for k, t in B.kv.items()},
          f"{label}: the import into B did not land in place ({got})")
    seen = []
    replay = B._replay_chunk

    def spy(key, args, static):
        seen.append((args, static, {k: v.clone() for k, v in args[1].items()},
                     args[3].clone(), args[4].clone()))
        return replay(key, args, static)

    # the engine's state was made under inference mode, as its loop runs
    with torch.inference_mode():
        req = B.submit(Request(prompt=list(prompts[1]), max_new_tokens=DISAGG_NEW))
        B._admit()
        check(B.matched_toks[0] == len(pages) * ps, f"{label}: B did not match the imported pages")
        B._replay_chunk = spy
        pending = B._dispatch_chunk()
        B._replay_chunk = replay
        args, static, kv0, tok0, len0 = seen[0]
        eager_args = list(args)
        eager_args[1], eager_args[3], eager_args[4] = kv0, tok0, len0
        out = serving._chunk_in_place(*eager_args, **static)
        sync(dev)
        same = torch.equal(out, pending.out) and all(torch.equal(kv0[k], B.kv[k]) for k in B.kv)
        check(same, f"{label}: the replay over imported pages differs from the eager chunk")
        B._drain_chunk(pending)
        B.run_until_idle()
    check(B.graphs_captured == captured, f"{label}: the import cost a graph capture")
    check(req.output == adopted[1], f"{label}: B's replayed tokens over the imported pages "
          "differ from D's eager ones")
    res["graph_across_import"] = {"graphs": captured, "replay_equals_eager": same}
    res["phase_s"] = {"split": t_split - t_start, "all": time.perf_counter() - t_start}

    def med(key):
        return [round(x["median"], 2) for x in res[key]]

    def rng(key):
        return [f"{x['min']:.1f}-{x['max']:.1f}" for x in res[key]]

    log(f"{label}: split of {shapes} tokens: pages {res['pages']}, bundles {bundle_bytes} B "
        f"({res['bytes_per_page']:.0f} B a page); medians of {SPLIT_REPEATS} rounds on fresh "
        f"prompts: export {med('export_ms')} ms, import {med('import_ms')} ms; /v1/prefill "
        f"{med('prefill_route_ms')} + adopted first token {med('adopt_ttft_ms')} = split "
        f"{med('split_ttft_ms')} ms (ranges {rng('split_ttft_ms')}) against a cold first token "
        f"{med('cold_ttft_ms')} ms (ranges {rng('cold_ttft_ms')}); split / cold "
        f"{med('split_over_cold')} (ranges {rng('split_over_cold')}); D launches "
        f"{res['d_launches']} exact; tokens equal the local warm hit; a graph replayed over "
        f"imported pages = eager")
    del engines, P, D, C, A, B, kv0, out, pending, seen, k2s, k3s
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_disagg_small_fp32(dev) -> dict:
    """A small float32 model through the split (export, import, adopted
    admission) and a migration (overlapped source and destination): greedy
    tokens identical on the card and the CPU, and to an engine that
    neither ships nor migrates."""
    from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine, Request
    from elastic_gpu_scheduler_tpu_torch.utils import kvwire

    small, sp = small_fp32()
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, 512, n).tolist() for n in (40, 70, 100)]
    kw = dict(prefix_cache=True, prefill_chunk=32, max_batch=4, max_len=256, page_size=16,
              fused_steps=8, paged_kernel=True)
    outs = {}
    for where in ("cpu", dev):
        def engine(**more):
            return InferenceEngine(sp, small, device=where, **dict(kw, **more))

        plain = []
        for p in prompts:
            e = engine(overlap=False)
            r = e.submit(Request(prompt=p, max_new_tokens=24))
            e.run_until_idle()
            plain.append(r.output)
        pe, de = engine(overlap=False), engine(overlap=where != "cpu")
        split = []
        for p in prompts:
            r = pe.submit(Request(prompt=p, max_new_tokens=1))
            pe.run_until_idle()
            de.import_pages(*kvwire.decode_bundle(pe.export_prefix_pages(p)))
            r = de.submit(Request(prompt=p, max_new_tokens=24))
            de.run_until_idle()
            split.append(r.output)
        check(de.prefix_admission_hits == len(prompts), "small split: no adoption hit")
        moved = []
        for p in prompts:
            src, dst = engine(overlap=where != "cpu"), engine(overlap=where != "cpu")
            src.submit(Request(prompt=p, max_new_tokens=24))
            src._admit()
            src.step()
            src.step()
            hdr, pages = kvwire.decode_bundle(src.migrate_out_bundle(0))
            dst.import_pages(hdr, pages)
            r = dst.resume_session(hdr["request"])
            dst.run_until_idle()
            moved.append(r.output)
        check(split == plain and moved == plain,
              f"small float32 on {where}: shipped or migrated tokens differ from the plain engine's")
        outs[str(where)] = plain
    check(outs["cpu"] == outs[str(dev)], "small float32 disagg: card tokens differ from the CPU's")
    log(f"small float32 split and migration: card = CPU = plain engine "
        f"({sum(map(len, outs['cpu']))} tokens a path)")
    return {"tokens": sum(map(len, outs["cpu"]))}


# -- phase 9c: MoE training ----------------------------------------------------------


MOE_TRAIN_LAYERS = 4  # the depth cut: fp32 masters and AdamW moments


def phase_moe_train(dev) -> dict:
    """MoE training at the flagship width with E 8 (depth cut to 4 layers:
    fp32 masters and AdamW moments of ~1.5B parameters), B 8, S 1024,
    remat, 8 vocab chunks: 1 warm-up and TRAIN_STEPS timed steps on one
    batch.  The loss falls, the aux is finite and in the loss, K1 2L and
    K4 L a step, no KE; then a small float32 MoE model card vs CPU."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models.data import SyntheticTokenDataset, batches
    from elastic_gpu_scheduler_tpu_torch.models.train import (
        init_state,
        loss_fn,
        make_optimizer,
        make_train_step,
    )
    from elastic_gpu_scheduler_tpu_torch.models.transformer import (
        TransformerConfig,
        hidden_with_aux,
        param_count,
        torch_dtype,
    )
    from elastic_gpu_scheduler_tpu_torch.ops import _build
    from elastic_gpu_scheduler_tpu_torch.ops.xent import chunked_softmax_xent
    from elastic_gpu_scheduler_tpu_torch.models.quantize import wmat

    cfg = TransformerConfig(**dict(TRAIN, n_experts=8, n_layers=MOE_TRAIN_LAYERS))
    opt = make_optimizer(mu_dtype="bfloat16")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    params, state = init_state(cfg, opt, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = param_count(params)
    step = make_train_step(cfg, opt)
    batch = next(batches(SyntheticTokenDataset(cfg.vocab_size, seed=0), TRAIN_B, TRAIN_S, seed=1))
    tok = torch.from_numpy(batch).to(dev)
    log(f"MoE train: {n_params / 1e9:.3f}B parameters (E {cfg.n_experts}, L {cfg.n_layers}), "
        f"B={TRAIN_B} S={TRAIN_S}, remat, xent_chunks={cfg.xent_chunks}")
    _build.reset_launches()
    losses, times = [], []
    for _ in range(TRAIN_STEPS + 1):
        t0 = time.perf_counter()
        _, _, loss = step(params, state, tok)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    launches = dict(_build.LAUNCHES)
    n = TRAIN_STEPS + 1
    L = cfg.n_layers
    want = dict.fromkeys(launches, 0)
    want.update(flash_fwd=2 * L * n, flash_bwd_dq=L * n, flash_bwd_dkv=L * n)
    log(f"MoE train main path: losses {[round(x, 4) for x in losses]}, launches {launches} "
        f"(want {want})")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], "MoE train loss did not fall")
    check(launches == want, "MoE train launches differ from 2L / L a step")
    with torch.no_grad():
        inputs, targets = tok[:, :-1], tok[:, 1:]
        hidden, aux = hidden_with_aux(params, inputs, cfg)
        ce = chunked_softmax_xent(hidden, wmat(params["unembed"], torch_dtype(cfg.dtype)),
                                  targets, cfg.xent_chunks)
        whole = loss_fn(params, tok, cfg)
    aux_v, ce_v, whole_v = float(aux), float(ce), float(whole)
    gap = abs(whole_v - (ce_v + cfg.aux_loss_weight * aux_v))
    log(f"MoE train loss parts: cross-entropy {ce_v:.6f} + {cfg.aux_loss_weight} x aux "
        f"{aux_v:.6f} vs loss {whole_v:.6f} (gap {gap:.3g})")
    check(np.isfinite(aux_v) and aux_v > 0 and gap <= 1e-4 * abs(whole_v),
          "MoE train: the aux is not finite or not in the loss")
    step_ms = float(np.mean(times[1:])) * 1e3
    perf = {"step_ms": step_ms, "step_ms_each": [x * 1e3 for x in times],
            "tokens_per_s": TRAIN_B * TRAIN_S / (step_ms / 1e3),
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "params_b": n_params / 1e9, "losses": losses, "aux": aux_v,
            "depth_cut": f"L {cfg.n_layers} of 16 (fp32 masters and AdamW moments)"}
    perf["profile"] = phase_train_profile(step, params, state, tok, label="MoE train")
    del params, state, step
    perf["cpu_vs_card"] = phase_train_cpu_vs_card(dev, n_experts=4)
    log("MoE train perf: " + json.dumps({k: v for k, v in perf.items() if k != "profile"}))
    return perf


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


# -- phase 7b: the observability plane ---------------------------------------


# objectives for the replica's own journeys; windows longer than the run,
# so every journey of a batch stays in them
OBS_SLO = {"classes": {"serve": {"ttft_p95_ms": 2000, "e2e_p99_ms": 10000}},
           "window_short_s": 600, "window_long_s": 1800}
# rounds of the same HTTP batch with every plane on and every plane off,
# in pairs ordered off-on, on-off, off-on, ...; a round times OBS_BATCHES
# batches back to back, so host noise averages within it.  6 pairs, so
# that the run's time limit also holds phase 16(f) and (e)'s split
OBS_PAIRS = 6
OBS_BATCHES = 3
OBS_ROUNDS = tuple(bool((i + i // 2) % 2) for i in range(2 * OBS_PAIRS))
# the device's idle share is read under torch.profiler, on separate
# batches in the order off, on, on, off
OBS_PROFILED = (False, True, True, False)


def set_planes(on: bool) -> None:
    """Every observability plane of the port on (tracing and profiling at
    1.0, the SLO objectives loaded) or off, and emptied."""
    from elastic_gpu_scheduler_tpu_torch.profile import PROFILER
    from elastic_gpu_scheduler_tpu_torch.slo import SLO
    from elastic_gpu_scheduler_tpu_torch.tracing import TRACER

    TRACER.configure(1.0 if on else 0.0)
    TRACER.reset()
    PROFILER.configure(sample=1.0 if on else 0.0)
    PROFILER.reset()
    SLO.reset()
    if on:
        SLO.load_config(OBS_SLO)
        SLO.default_class = "serve"


def nearest_rank(xs, q: float) -> float:
    """The nearest-rank quantile, the rule the SLO plane's percentiles use."""
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, int(q * len(s) + 0.5) - 1))]


def sse_completion(addr, body, traceparent: str) -> dict:
    """One streamed completion, read line by line on the client's clock:
    its tokens, the ``: slo`` comments (and whether the first came before
    the first token), and the times of the request, the first and last
    token and the end."""
    conn = http.client.HTTPConnection(*addr, timeout=300)
    out = {"tokens": [], "slo": [], "slo_before_first": False, "t_first": None,
           "t_last": None, "done": False, "errors": []}
    out["t0"] = time.perf_counter()
    conn.request("POST", "/v1/completions", json.dumps(dict(body, stream=True)),
                  {"Content-Type": "application/json", "traceparent": traceparent})
    resp = conn.getresponse()
    out["status"] = resp.status
    while True:
        line = resp.readline()
        if not line:
            break
        line = line.strip()
        if line.startswith(b": slo "):
            out["slo"].append(json.loads(line[len(b": slo "):])["queue_ms"])
            out["slo_before_first"] = out["t_first"] is None and len(out["slo"]) == 1
        elif line.startswith(b"data: "):
            payload = line[len(b"data: "):]
            if payload == b"[DONE]":
                out["done"] = True
                break
            ev = json.loads(payload)
            if "token" not in ev:
                out["errors"].append(ev)
                continue
            now = time.perf_counter()
            if out["t_first"] is None:
                out["t_first"] = now
            out["t_last"] = now
            out["tokens"].append(ev["token"])
    out["t_end"] = time.perf_counter()
    resp.read()
    conn.close()
    return out


def http_batch(addr, prompts, tps, max_new, resets_allowed: bool = False) -> dict:
    """``len(prompts)`` concurrent streams, each with its traceparent,
    released together.  Returns the streams and the wall from the release
    to the last stream's end.  ``resets_allowed``: a connection the server
    reset is recorded (``{"reset": ...}``) and left out, not a failure."""
    import threading

    n = len(prompts)
    results = [None] * n
    barrier = threading.Barrier(n + 1)

    def client(i):
        barrier.wait()
        try:
            results[i] = sse_completion(addr, {"prompt": list(prompts[i]),
                                               "max_tokens": max_new}, tps[i])
        except ConnectionResetError as e:
            if not resets_allowed:
                raise
            results[i] = {"reset": str(e)}

    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=300)
        check(not t.is_alive(), "a streaming client did not finish")
    resets = sum(1 for r in results if r is not None and "reset" in r)
    results = [r for r in results if r is not None and "reset" not in r]
    check(len(results) + resets == n, "a streaming client failed")
    wall = max(r["t_end"] for r in results) - t0
    for r in results:
        check(r["status"] == 200 and r["done"] and not r["errors"]
              and len(r["tokens"]) == max_new, f"a stream failed: {r['status']} {r['errors']}")
    return {"streams": results, "wall_s": wall, "resets": resets}


def wait_parked(loop) -> None:
    """Until the engine loop has drained and parked (its last step's
    profile sample and spans are then recorded)."""
    eng = loop.engine
    deadline = time.monotonic() + 60
    while not (loop.parked.is_set() and eng.queue.empty()
               and all(s is None for s in eng.slots)):
        check(time.monotonic() < deadline, "the engine loop did not park")
        time.sleep(0.005)


def scrape(addr) -> dict:
    """``/metrics`` as {(sample name, labels): value}."""
    conn = http.client.HTTPConnection(*addr, timeout=30)
    conn.request("GET", "/metrics")
    resp = conn.getresponse()
    text = resp.read().decode()
    conn.close()
    check(resp.status == 200, f"/metrics answered {resp.status}")
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def client_latency(streams) -> dict:
    """Client-side p50 / p99 of TTFT, e2e and the time a token after the
    first (a stream's mean), and the queue wait its ``: slo`` comment
    reported (p50 and max), in ms."""
    ttft = [(s["t_first"] - s["t0"]) * 1e3 for s in streams]
    e2e = [(s["t_end"] - s["t0"]) * 1e3 for s in streams]
    tpot = [(s["t_last"] - s["t_first"]) * 1e3 / (len(s["tokens"]) - 1) for s in streams]
    queue = [s["slo"][0] for s in streams]
    return {"ttft_ms": {"p50": nearest_rank(ttft, 0.5), "p99": nearest_rank(ttft, 0.99)},
            "e2e_ms": {"p50": nearest_rank(e2e, 0.5), "p99": nearest_rank(e2e, 0.99)},
            "tpot_ms": {"p50": nearest_rank(tpot, 0.5), "p99": nearest_rank(tpot, 0.99)},
            "queue_ms": {"p50": nearest_rank(queue, 0.5), "max": max(queue)}}


def device_busy(fn, what: str) -> tuple[float, float, int]:
    """``fn()`` once under torch.profiler (device activity): (wall ms,
    summed ms of the device's kernels and copies, their count), read from
    the raw kineto events, which reads a run of ~10^5 kernels in seconds
    where ``key_averages`` takes far longer.  Fails if no try of
    PROFILE_TRIES saw the device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
              if "cuda" in str(e.device_type()).lower()]
        if ns:
            return wall_ms, sum(ns) / 1e6, len(ns)
        log(f"the profiler saw no device time in {what} (attempt {attempt} of {PROFILE_TRIES})")
    fail(f"the profiler saw no device time in {what} in {PROFILE_TRIES} attempts")


def task_batch(loop, prompts, max_new, ctx) -> dict:
    """The batch submitted by one engine task, so every run admits alike;
    ``ctx`` (a span context or None) goes on each request.  Returns the
    engine's upload, capture and chunk counts it took."""
    from elastic_gpu_scheduler_tpu_torch.models.serving import Request

    eng = loop.engine
    base = (eng.device_uploads, eng.graphs_captured, eng.steps_run)
    reqs = [Request(prompt=list(p), max_new_tokens=max_new, trace_ctx=ctx) for p in prompts]
    eng.run_task(lambda: [eng.submit(r) for r in reqs], timeout=120)
    for r in reqs:
        check(r.done.wait(300) and not r.error and len(r.output) == max_new,
              f"a task-batch request failed: {r.error!r}")
    wait_parked(loop)
    return {"uploads": eng.device_uploads - base[0], "graphs_captured": eng.graphs_captured
            - base[1], "chunks": eng.steps_run - base[2]}


def phase_observability(dev, params, cfg, prompts) -> dict:
    """The observability plane on the overlapped full-width engine behind
    HTTP (every plane on): 12 concurrent SSE streams, each with its own
    traceparent, into 8 slots; then the same batch in rounds with the
    planes on and off."""
    import threading

    import torch

    from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine
    from elastic_gpu_scheduler_tpu_torch.ops import _build
    from elastic_gpu_scheduler_tpu_torch.profile import PROFILER
    from elastic_gpu_scheduler_tpu_torch.serve import device_generation
    from elastic_gpu_scheduler_tpu_torch.server.inference import STEP_SPAN_EVERY, serve_inference
    from elastic_gpu_scheduler_tpu_torch.slo import SLO
    from elastic_gpu_scheduler_tpu_torch.tracing import TRACER

    t_phase = time.perf_counter()
    card = card_line()
    generation = device_generation(dev)
    PROFILER.set_identity(pod="chip-smoke/serve-0", wclass="serve", generation=generation,
                          chips=1)
    L, K = cfg.n_layers, ENGINE["fused_steps"]
    rng = np.random.default_rng(17)
    tps = [f"00-{rng.bytes(16).hex()}-{rng.bytes(8).hex()}-01" for _ in prompts]

    # the planes add no upload and no capture: the same batch, one engine
    # task each, on two fresh engines, planes off then on
    fresh = {}
    for on in (False, True):
        set_planes(on)
        eng = InferenceEngine(params, cfg, paged_kernel=True, device=dev, **ENGINE)
        server, loop = serve_inference(eng, port=0, host="127.0.0.1")
        # a root span's context (None with tracing off) on each request
        ctx = TRACER.point("chip-smoke.task-batch").context()
        fresh[on] = (eng, task_batch(loop, prompts, NEW_TOKENS, ctx))
        server.shutdown()
        server.server_close()
        loop.stop()
    same = {k: (fresh[False][1][k], fresh[True][1][k]) for k in fresh[True][1]}
    log(f"observability: a cold batch with the planes off / on: {same} "
        f"({time.perf_counter() - t_phase:.1f} s into the phase)")
    check(same["uploads"][0] == same["uploads"][1] > 0,
          "the planes changed the engine's host-to-device uploads")
    check(same["graphs_captured"][0] == same["graphs_captured"][1] > 0,
          "the planes changed the CUDA graph captures")
    # the warm planes-on engine behind a new loop: the engine.step pacing
    # starts at 0 with the main path's first traced step
    eng = fresh[True][0]
    del fresh
    gc.collect()
    torch.cuda.empty_cache()
    # the greedy decode graph at every table-view bucket, as a replica's
    # warm-up captures it (here, on this thread under inference mode, as
    # the loop's thread runs: no loop runs the engine yet): which buckets
    # 12 streams visit depends on when each arrives over HTTP, and the main
    # path must capture nothing
    captured = eng.graphs_captured
    with torch.inference_mode():
        for label, build in eng.aot_signatures():
            if label.startswith("serve_chunk:000000:"):
                build()
    log(f"observability: {eng.graphs_captured - captured} greedy decode graphs captured "
        f"before the main path (buckets the cold batch did not visit)")
    server, loop = serve_inference(eng, port=0, host="127.0.0.1")
    addr = server.server_address
    try:
        # the main path: every plane on, counts at 0 just before, read after
        set_planes(True)
        m0 = scrape(addr)
        wait_parked(loop)
        torch.cuda.synchronize()
        base = dict(emitted=eng.tokens_emitted, prefills=eng.prefills_run, chunks=eng.steps_run,
                    warmups=eng.graph_warmups, captured=eng.graphs_captured)
        _build.reset_launches()
        main = http_batch(addr, prompts, tps, NEW_TOKENS)
        wait_parked(loop)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        m1 = scrape(addr)
        emitted = eng.tokens_emitted - base["emitted"]
        prefills = eng.prefills_run - base["prefills"]
        chunks = eng.steps_run - base["chunks"]
        warmups = eng.graph_warmups - base["warmups"]
        log(f"observability main path: 12 streams, {prefills} prefills, {chunks} chunks, "
            f"{warmups} capture warm-ups, launches {launches}")
        check(eng.graphs_captured == base["captured"], "the warm engine captured a graph")
        check(launches["flash_fwd"] == L * prefills > 0, "K1 launches != layers x prefills")
        check(launches["paged_attention"] == L * K * (chunks + warmups) > 0,
              "K2 launches != layers x fused_steps x chunks")
        check(launches["paged_attention_int8"] == launches["flash_block_stats"] == 0,
              "the dense engine launched the int8 K2 or K3")
        streams = main["streams"]
        check(all(len(s["slo"]) == 1 and s["slo_before_first"] for s in streams),
              "a stream did not carry exactly one ': slo' comment before its first token")

        def delta(key):
            return m1.get(key, 0.0) - m0.get(key, 0.0)

        n_tokens = len(prompts) * NEW_TOKENS
        counts = {"ok": delta('tpu_serve_requests_total{result="ok"}'),
                  "tokens": delta("tpu_serve_tokens_total"),
                  "latency_count": delta("tpu_serve_request_seconds_count")}
        pages = {k: m1[f'tpu_kv_pages_resident{{kind="{k}"}}'] for k in ("active", "cached", "free")}
        log(f"observability /metrics: {counts}, pages resident {pages}")
        check(counts == {"ok": len(prompts), "tokens": n_tokens, "latency_count": len(prompts)},
              "/metrics does not count the batch")
        check(sum(pages.values()) == eng.n_pages - 1, "resident page gauges do not add up")

        # traces: serve.request (the client's child) -> engine.queued ->
        # engine.admitted, in causal order; engine.step spans paced one per
        # 32 steps of the traced batch, each in a trace live at its step
        steps, live = [], {}
        for t in tps:
            tid, client_span = t[3:35], t[36:52]
            _, tr = get_json(addr, f"/traces?trace={tid}")
            by = {}
            for s in tr["spans"]:
                by.setdefault(s["name"], []).append(s)
            req = by.get("serve.request", [])
            check(len(req) == 1 and req[0]["parent_id"] == client_span,
                  f"trace {tid}: no serve.request under the client's span")
            rid = req[0]["span_id"]
            for name in ("engine.queued", "engine.admitted"):
                check(len(by.get(name, [])) == 1 and by[name][0]["parent_id"] == rid,
                      f"trace {tid}: no {name} under serve.request")
            steps += [(rid, s) for s in by.get("engine.step", [])]
            live[rid] = (by["engine.admitted"][0]["start_unix"],
                         req[0]["start_unix"] + req[0]["duration_ms"] / 1e3)
            check(all(s["parent_id"] == rid for s in by.get("engine.step", [])),
                  f"trace {tid}: an engine.step outside serve.request")
            _, causal = get_json(addr, f"/debug/trace/{tid}")
            order = [s["name"] for s in causal["spans"]]
            check(causal["processes"] == 1 and order[:3] == ["serve.request", "engine.queued",
                                                             "engine.admitted"],
                  f"trace {tid}: /debug/trace order {order}")
        all_steps = sum(1 for s in TRACER.finished() if s.name == "engine.step")
        check(len(steps) == all_steps,
              f"engine.step spans: {len(steps)} in the batch's traces, {all_steps} in the ring")
        check(all({"step", "slots", "host_gap_ms", "overlap", "tokens_per_sec"}
                  <= set(s["attrs"]) and s["attrs"]["overlap"] for _, s in steps),
              "an engine.step span lacks its attributes")
        # every loop step of the batch was traced and profiled (the profiler
        # samples each one at 1.0), so the pacing predicts the spans exactly
        _, prof = get_json(addr, "/debug/profiles")
        traced_steps = prof["folded"]["step"]
        paced = list(range(0, traced_steps, STEP_SPAN_EVERY))
        check(prof["pending"] == 0 and PROFILER.dropped_steps == 0,
              "the profiler did not fold every step")
        check(sorted(s["attrs"]["step"] for _, s in steps) == paced and paced,
              f"engine.step spans at steps {sorted(s['attrs']['step'] for _, s in steps)}, "
              f"the pacing over {traced_steps} traced steps gives {paced}")
        check(all(live[rid][0] <= s["start_unix"] <= live[rid][1] for rid, s in steps),
              "an engine.step span lies outside its trace's admission and response")
        _, slo = get_json(addr, "/debug/slo")
        check(slo["folded"]["replica"] == len(prompts)
              and slo["windows"]["serve"]["samples"] == len(prompts),
              f"/debug/slo holds {slo['folded']} journeys")
        ptoks = prof["profiles"]["serve"]["tokens"]
        check(prof["identity"]["generation"] == generation, "/debug/profiles lacks the card")
        # each request's first token comes from its admission's prefill,
        # outside the step bracket the profiler samples
        check(ptoks == emitted - prefills and emitted == n_tokens,
              f"profile tokens {ptoks}, tokens emitted {emitted}, prefills {prefills}")

        client = client_latency(streams)
        win = slo["windows"]["serve"]
        server_side = {k: win[k] for k in ("ttft_ms", "e2e_ms", "tpot_ms", "queue_ms")}
        log(f"observability latency, client: {json.dumps(client)}; server: "
            f"{json.dumps(server_side)} ({time.perf_counter() - t_phase:.1f} s into the phase)")

        # rounds of the same batch, planes on and off: tokens/s unprofiled
        # (OBS_BATCHES batches a round), then the idle share on profiled
        # batches of their own
        rounds = {True: [], False: []}
        t_rounds = time.perf_counter()
        for on in OBS_ROUNDS:
            set_planes(on)
            wait_parked(loop)
            # the last round's garbage is collected here, not in a timed batch
            gc.collect()
            walls = []
            for _ in range(OBS_BATCHES):
                walls.append(http_batch(addr, prompts, tps, NEW_TOKENS)["wall_s"])
                wait_parked(loop)
            rounds[on].append({"tokens_per_s": OBS_BATCHES * n_tokens / sum(walls),
                               "walls_s": walls})
            log(f"observability round, planes {'on' if on else 'off'}: {rounds[on][-1]} "
                f"({time.perf_counter() - t_rounds:.1f} s into the rounds)")
        profiled = {True: [], False: []}
        for on in OBS_PROFILED:
            set_planes(on)
            wait_parked(loop)
            gc.collect()

            def profiled_batch():
                http_batch(addr, prompts, tps, NEW_TOKENS)
                wait_parked(loop)

            wall_ms, busy, _ = device_busy(profiled_batch, f"the HTTP batch, planes {on}")
            profiled[on].append({"idle_share_profiled": 1 - busy / wall_ms,
                                 "profiled_wall_ms": wall_ms, "device_busy_ms": busy})
            log(f"observability profiled batch, planes {'on' if on else 'off'}: "
                f"{profiled[on][-1]}")
        # the same batch behind the stdlib's server (its listen backlog of 5)
        # around the same loop, planes on: what the port's backlog of 128 buys
        from http.server import ThreadingHTTPServer

        from elastic_gpu_scheduler_tpu_torch.server.inference import make_handler

        set_planes(True)
        wait_parked(loop)
        stdlib = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(loop))
        threading.Thread(target=stdlib.serve_forever, daemon=True).start()
        try:
            b5 = http_batch(stdlib.server_address, prompts, tps, NEW_TOKENS, resets_allowed=True)
            backlog5 = {**client_latency(b5["streams"]), "streams": len(b5["streams"]),
                        "connections_reset": b5["resets"]}
        finally:
            stdlib.shutdown()
            stdlib.server_close()
        wait_parked(loop)
        log(f"observability latency behind a listen backlog of 5: {json.dumps(backlog5)}")
        summary = {}
        for on, rs in rounds.items():
            tok = [r["tokens_per_s"] for r in rs]
            idle = [r["idle_share_profiled"] for r in profiled[on]]
            q1, med, q3 = (float(x) for x in np.percentile(tok, [25, 50, 75]))
            summary["on" if on else "off"] = {
                "tokens_per_s_median": med,
                "tokens_per_s_spread": (max(tok) - min(tok)) / med,
                "tokens_per_s_quartile_spread": (q3 - q1) / med,
                "idle_share_profiled_median": float(np.median(idle)),
                "idle_share_profiled_range": [min(idle), max(idle)], "rounds": rs,
                "profiled": profiled[on]}
        on_s, off_s = summary["on"], summary["off"]
        # each pair's on round over its off round: the planes' cost with
        # the drift between pairs taken out.  Resolved when the medians
        # differ by more than the off rounds' quartile spread
        ratios = [a["tokens_per_s"] / b["tokens_per_s"]
                  for a, b in zip(rounds[True], rounds[False])]
        cost = 1 - on_s["tokens_per_s_median"] / off_s["tokens_per_s_median"]
        r1, rmed, r3 = (float(x) for x in np.percentile(ratios, [25, 50, 75]))
        summary["cost"] = {"median_ratio": 1 - cost, "paired_ratio_median": rmed,
                           "paired_ratio_quartiles": [r1, r3],
                           "paired_ratio_range": [min(ratios), max(ratios)],
                           "resolved": abs(cost) > off_s["tokens_per_s_quartile_spread"]}
        log(f"observability planes on / off ({OBS_PAIRS} rounds each of {OBS_BATCHES} batches): "
            f"{on_s['tokens_per_s_median']:.1f} / {off_s['tokens_per_s_median']:.1f} tokens/s "
            f"(quartile spreads {on_s['tokens_per_s_quartile_spread']:.4f} / "
            f"{off_s['tokens_per_s_quartile_spread']:.4f}, ranges "
            f"{on_s['tokens_per_s_spread']:.4f} / {off_s['tokens_per_s_spread']:.4f}; paired "
            f"on/off median {rmed:.4f}, quartiles {r1:.4f}-{r3:.4f}, range "
            f"{min(ratios):.4f}-{max(ratios):.4f}; resolved {summary['cost']['resolved']}), "
            f"idle share under the profiler {on_s['idle_share_profiled_median']:.3f} / "
            f"{off_s['idle_share_profiled_median']:.3f}")
        out = {"card": card, "generation": generation, "launches": launches,
               "prefills": prefills, "chunks": chunks, "tokens_emitted": emitted,
               "profile_tokens": ptoks, "engine_step_spans": len(steps),
               "metrics": counts, "pages_resident": pages, "cold_batch_off_on": same,
               "latency_client": client, "latency_server": server_side,
               "latency_client_backlog_5": backlog5,
               "main_wall_s": main["wall_s"], "main_tokens_per_s": n_tokens / main["wall_s"],
               "planes": summary}
        log(json.dumps({"observability": out}))
        return out
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()
        set_planes(True)
        SLO.reset()


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
    tpads = [prefill_tpad(len(p), eng.max_len) for p in prompts]
    for t in sorted(set(tpads)):
        q, k, v = (torch.randn(1, cfg.n_heads, t, cfg.head_dim, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        out = flash_attention(q, k, v, True, None, 0)
        ref = mha_reference(q, k, v, True, None, 0)[0]
        err = max(err, maxerr(out, ref))
        bound, by = k1_bound_ms(1, cfg.n_heads, t, t, cfg.head_dim, True, 0, 2)
        rd = replay_readings(lambda: flash_attention(q, k, v, True, None, 0), 100, bound=bound)
        ms = rd["ms"][""]
        plain = device_ms(lambda: mha_reference(q, k, v, True, None, 0), 20)
        lib = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 100)
        n = tpads.count(t)
        rows.append((n, ms, plain, lib, bound, by, rd))
        log(f"K1 timing Tpad={t} (x{n} prompts): kernel {ms:.4f} ms (profiler "
            f"{rd['profiler_ms']['']:.4f}), plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
            f"{bound:.5f} ms ({by})")
    tot = sum(r[0] for r in rows)
    mean = [sum(r[0] * r[i] for r in rows) / tot for i in (2, 3, 4)]
    return {**reading_fields([(r[0], r[6]) for r in rows]),
        "name": "flash_fwd", "route": "cuda",
        "source": "elastic_gpu_scheduler_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "elastic_gpu_scheduler_tpu/ops/attention.py:290",
        "launches": launches["flash_fwd"], "max_abs_err": err,
        "plain_ms": mean[0], "bound_ms": mean[2],
        "bound_by": max(rows, key=lambda r: r[0] * r[4])[5],
        "library_ms": mean[1],
    }


def kernel_k2(sampler, launches, worst, name="paged_attention"):
    """K2 on inputs the main path gave it (sampled calls, plain decode or
    a W-query verify window); ``name`` is ``paged_attention_int8`` for the
    int8-pool variant."""
    from elastic_gpu_scheduler_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_reference,
    )

    check(sampler.calls, f"no {name} call was sampled on the main path")
    plain_l, bound_l, rds, err = [], [], [], worst
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
        # bytes this call must move: q, out, tables, lengths, and each
        # distinct live (page, kv-head) K and V tile once (up to the last
        # query's position: lengths + W - 1)
        B, W, Dh = q.shape[0], 1 if q.ndim == 3 else q.shape[1], q.shape[-1]
        ps, Hkv = pk.shape[1], pk.shape[2]
        NB = tables.shape[1]
        ln = lengths.cpu().numpy()
        tb = tables.cpu().numpy()
        live = set()
        for b in range(B):
            for j in range(min(NB, (int(ln[b]) + W - 1) // ps + 1)):
                live.add(int(tb[b, j]))
        # an int8 page also carries its fp32 scales, one a (token, kv-head)
        page_bytes = ps * Hkv * (Dh * pk.element_size() + (4 if kw["scales_k"] is not None
                                                            else 0))
        byts = (len(live) * page_bytes * 2 + 2 * q.numel() * q.element_size()
                + tables.numel() * 4 + lengths.numel() * 4)
        bound_l.append(byts / PEAK_BYTES * 1e3)
        rds.append((1, replay_readings(kern, 50, bound=bound_l[-1])))
        plain_l.append(device_ms(plain, 10))
    row = {
        **reading_fields(rds),
        "name": name, "route": "cuda",
        "source": "elastic_gpu_scheduler_tpu_torch/csrc/paged_attention.cu",
        "replaces": "elastic_gpu_scheduler_tpu/ops/paged_attention.py:204",
        "launches": launches[name], "max_abs_err": err,
        "plain_ms": float(np.mean(plain_l)),
        "bound_ms": float(np.mean(bound_l)), "bound_by": "bytes", "library_ms": None,
    }
    log(f"{name} timing over {len(rds)} main-path calls: kernel {row['ms']:.4f} ms (profiler "
        f"{row['profiler_ms']:.4f}), plain {row['plain_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.5f} ms (bytes)")
    return row


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
        bound, by = k3_bound_ms(B, H, Hkv, sq, sk, D, q_off, k_off, causal, q.element_size())
        rd = replay_readings(lambda: flash_block_stats(q, k, v, q_off, k_off, causal), 50,
                             matches=("flash_stats_kernel",), bound=bound)
        ms = rd["ms"]["flash_stats_kernel"]
        plain = device_ms(lambda: flash_block_stats_reference(q, k, v, q_off, k_off, causal), 10)
        lib = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                              enable_gqa=True), 50)
        rows.append((ms, plain, lib, bound, by, rd))
        log(f"K3 timing T={sq} M={sk} start={q_off}: kernel {ms:.4f} ms (call "
            f"{rd['call_ms']:.4f}), plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
            f"{bound:.5f} ms ({by})")
    mean = [float(np.mean([r[i] for r in rows])) for i in range(4)]
    return {
        **reading_fields([(1, r[5]) for r in rows], "flash_stats_kernel"),
        "name": "flash_block_stats", "route": "cuda",
        "source": "elastic_gpu_scheduler_tpu_torch/csrc/flash_stats.cu",
        "replaces": "elastic_gpu_scheduler_tpu/ops/attention.py:902",
        "launches": launches["flash_block_stats"], "max_abs_err": err,
        "plain_ms": mean[1], "bound_ms": mean[3],
        "bound_by": max(set(r[4] for r in rows), key=[r[4] for r in rows].count),
        "library_ms": mean[2],
        "note": "max_abs_err is on pv / l; library_ms is SDPA (enable_gqa, the same "
                "causal offsets as a mask), which returns normalised output; ms is "
                "flash_stats_kernel's share of its call's replay (the call adds a combine "
                "where it splits)",
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


def phase_train_profile(step, params, state, tokens, label="train") -> dict:
    """One full-width train step under torch.profiler: device busy time,
    idle share, top kernels and K4's share."""
    wall_ms, kernels = profiled(lambda: float(step(params, state, tokens)[2]),
                                f"a {label} step", cpu=True)
    busy = sum(k["ms"] for k in kernels)

    def share(sub):
        return sum(k["ms"] for k in kernels if sub in k["kernel"]) / busy

    res = {"window": f"one full-width {label} step", "wall_ms": wall_ms,
           "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
           "launches": sum(k["count"] for k in kernels),
           "k4_share": share("flash_bwd"), "k1_share": share("flash_fwd"),
           "top": kernels[:25]}
    log(json.dumps({f"{label}_profile": res}))
    log(f"{label} profile: step wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
        f"(idle share {res['idle_share']:.3f}), K4 {res['k4_share']:.3f} and K1 "
        f"{res['k1_share']:.3f} of device time, {res['launches']} kernel launches")
    for k in kernels[:12]:
        log(f"  {k['ms']:9.3f} ms  x{k['count']:5d}  {k['kernel']}")
    return res


def phase_train_cpu_vs_card(dev, **over) -> dict:
    """A small float32 model (``over``: config fields, e.g. n_experts), 3
    steps on the card and 3 on the CPU from the same weights and tokens:
    losses and final parameters within 1e-4 relative (of the loss; of each
    leaf's largest magnitude)."""
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

    small = TransformerConfig(**dict(dict(
        vocab_size=512, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=512,
        dtype="float32", remat=True, xent_chunks=4), **over))
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
    label = f" {over}" if over else ""
    log(f"small float32 train{label}, card vs CPU: losses {lg} vs {lc}; max loss rel "
        f"diff {loss_rel:.3g}, max param diff / leaf max {param_rel:.3g} (tol 1e-4)")
    check(loss_rel <= 1e-4 and param_rel <= 1e-4, "float32 training differs between card and CPU")
    return {"losses_card": lg, "losses_cpu": lc, "loss_rel": loss_rel, "param_rel": param_rel}


LORA_TRAIN_RANK, LORA_TRAIN_LR = 16, 1e-3


def phase_lora_train(dev, full) -> dict:
    """LoRA fine-tuning at phase 9's shape (B 8, S 1024, remat, 8 vocab
    chunks): rank 16 on all 7 families over the bf16 base, frozen; AdamW
    over the adapters.  One warm-up step and TRAIN_STEPS timed steps on
    one batch: the loss falls, the base keeps its bits, K1 launches 2L
    and K4 L times a step.  ``full``: phase 9's figures, printed beside."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models.data import SyntheticTokenDataset, batches
    from elastic_gpu_scheduler_tpu_torch.models.lora import (
        lora_init,
        lora_param_count,
        make_lora_train_step,
    )
    from elastic_gpu_scheduler_tpu_torch.models.train import make_optimizer
    from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig, init_params
    from elastic_gpu_scheduler_tpu_torch.ops import _build

    cfg = TransformerConfig(**TRAIN)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    frozen = [p.cpu() for p in _leaves(params)]
    lo = lora_init(params, rank=LORA_TRAIN_RANK, targets=ALL_FAMILIES,
                   generator=torch.Generator(device=dev).manual_seed(7))
    opt = make_optimizer(lr=LORA_TRAIN_LR)
    state = opt.init(lo["adapters"])
    step = make_lora_train_step(cfg, opt)
    batch = next(batches(SyntheticTokenDataset(cfg.vocab_size, seed=0), TRAIN_B, TRAIN_S, seed=1))
    toks = torch.from_numpy(batch).to(dev)
    n_train = lora_param_count(lo)
    log(f"LoRA train: rank {LORA_TRAIN_RANK} on {list(ALL_FAMILIES)}, {n_train / 1e6:.2f}M "
        f"trainable over a frozen bf16 base, B={TRAIN_B} S={TRAIN_S}, remat, "
        f"xent_chunks={cfg.xent_chunks}, AdamW lr {LORA_TRAIN_LR}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    # the main path: counts at 0 just before, read just after
    _build.reset_launches()
    losses, times = [], []
    for _ in range(TRAIN_STEPS + 1):
        t0 = time.perf_counter()
        _, _, loss = step(lo, state, params, toks)
        losses.append(float(loss))  # synchronizes
        times.append(time.perf_counter() - t0)
    launches = dict(_build.LAUNCHES)
    n_steps, L = len(times), cfg.n_layers
    want = dict.fromkeys(launches, 0)
    want.update(flash_fwd=2 * L * n_steps, flash_bwd_dq=L * n_steps, flash_bwd_dkv=L * n_steps)
    log(f"LoRA train main path: {n_steps} steps, losses {[round(x, 4) for x in losses]}, "
        f"launches {launches} (want {want})")
    check(all(np.isfinite(losses)), "LoRA train loss not finite")
    check(losses[-1] < losses[0], "LoRA train loss did not fall")
    check(launches == want, "LoRA train-path launches differ from 2L / L per step")
    check(all(torch.equal(p.cpu(), f) for p, f in zip(_leaves(params), frozen)),
          "LoRA training changed the base")
    step_ms = float(np.mean(times[1:])) * 1e3
    mem_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    prof = phase_train_profile(lambda p, s, t: step(lo, s, p, t), params, state, toks,
                               label="lora_train")
    perf = {"step_ms": step_ms, "step_ms_each": [x * 1e3 for x in times],
            "tokens_per_s": TRAIN_B * TRAIN_S / (step_ms / 1e3),
            "max_memory_allocated_gb": mem_gb, "trainable_params": n_train, "losses": losses,
            "profile": {k: prof[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                             "launches", "k4_share", "k1_share")},
            "full_finetune": {k: full[k] for k in ("step_ms", "tokens_per_s",
                                                   "max_memory_allocated_gb", "params_b")}}
    log("LoRA train perf: " + json.dumps(perf))
    log(f"LoRA vs full fine-tune (one call): step {step_ms:.2f} vs {full['step_ms']:.2f} ms, "
        f"{perf['tokens_per_s']:.0f} vs {full['tokens_per_s']:.0f} tokens/s, "
        f"max_memory_allocated {perf['max_memory_allocated_gb']:.2f} vs "
        f"{full['max_memory_allocated_gb']:.2f} GB, trainable {n_train / 1e6:.2f}M vs "
        f"{full['params_b'] * 1e3:.0f}M parameters; {card_line()}")
    return perf


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
    # the same job with the reference's model on 4 experts
    moe = launcher.JobSpec(steps=3, model=launcher.TransformerConfig(n_experts=4))
    t0 = time.perf_counter()
    moe_losses = launcher.run_job(moe, device=dev)
    moe_wall = time.perf_counter() - t0
    log(f"launcher.run_job MoE JobSpec (E 4): losses {moe_losses} in {moe_wall:.2f} s")
    check(len(moe_losses) == 3 and all(np.isfinite(moe_losses)), "MoE run_job losses")
    return {"losses": losses, "wall_s": wall, "moe_losses": moe_losses, "moe_wall_s": moe_wall}


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


def kernel_train_rows(dev, k4_err) -> list[dict]:
    """K1 and K4 at the train path's attention shape (bf16, causal); the
    rows' launches are the training path's, filled in after phase 9."""
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
    k1_bound, k1_by = k1_bound_ms(B, H, S, S, D, True, 0, 2)
    k1_rd = replay_readings(lambda: flash_attention(q, k, v, True, None, 0), 20, bound=k1_bound)
    k1_ms = k1_rd["ms"][""]
    k1_plain = device_ms(lambda: mha_reference(q, k, v, True, None, 0), 5)
    k1_lib = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 20)
    k4_bound, k4_by = k4_bound_ms(B, H, S, S, D, True, 0, 2)

    # K4: one replay of the whole backward (delta, dq and dkv), each
    # kernel's time its share of the call
    def bwd():
        return flash_backward(q, k, v, out, lse, do, True, None, 0)

    bwd_rd = replay_readings(bwd, 10, matches=("flash_bwd_dq", "flash_bwd_dkv"),
                             call_bound=k4_bound)
    dq_ms, dkv_ms = bwd_rd["ms"]["flash_bwd_dq"], bwd_rd["ms"]["flash_bwd_dkv"]
    plain_ms = device_ms(lambda: flash_backward_reference(q, k, v, ref, ref_lse, do, True,
                                                          None, 0), 3)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves, is_causal=True)
        return torch.autograd.grad(o, leaves, do)

    # autograd's calls stay eager: the profiler reads both
    lib_bwd = device_ms(sdpa_fwd_bwd, 10) - device_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 20)
    log(f"K1 at the train shape, both readings: graph replay {k1_ms:.5f} ms, profiler "
        f"{k1_rd['profiler_ms']['']:.5f} ms; the backward call: graph {bwd_rd['call_ms']:.5f} "
        f"ms, profiler {bwd_rd['profiler_call_ms']:.5f} ms, kernels a call "
        f"{json.dumps(bwd_rd['kernels'])}")
    log(f"train-shape timing (B={B} H={H} S={S} D={D} bf16 causal): K1 {k1_ms:.4f} ms "
        f"(plain {k1_plain:.4f}, sdpa {k1_lib:.4f}, bound {k1_bound:.5f} {k1_by}); "
        f"K4 dq {dq_ms:.4f} ms + dkv {dkv_ms:.4f} ms (plain backward {plain_ms:.4f}, "
        f"sdpa backward {lib_bwd:.4f})")
    rows = [{
        **reading_fields([(1, k1_rd)]),
        "name": "flash_fwd", "path": "train", "route": "cuda",
        "source": "elastic_gpu_scheduler_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "elastic_gpu_scheduler_tpu/ops/attention.py:290",
        "launches": 0, "max_abs_err": k1_err,
        "plain_ms": k1_plain, "bound_ms": k1_bound, "bound_by": k1_by,
        "library_ms": k1_lib,
    }]
    log(f"K4 bound (the whole backward): {k4_bound:.5f} ms ({k4_by}); dq + dkv "
        f"{dq_ms + dkv_ms:.4f} ms, {(dq_ms + dkv_ms) / k4_bound:.1f}x")
    for which in ("dq", "dkv"):
        bound, by = K4_SHARE[which] * k4_bound, k4_by
        rows.append({
            **reading_fields([(1, bwd_rd)], f"flash_bwd_{which}", bound),
            "name": f"flash_bwd_{which}", "path": "train", "route": "cuda",
            "source": "elastic_gpu_scheduler_tpu_torch/csrc/flash_bwd.cu",
            "replaces": "elastic_gpu_scheduler_tpu/ops/attention.py:633",
            "launches": 0, "max_abs_err": k4_err[which],
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_bwd,
            "note": "plain_ms and library_ms are the whole backward (dq, dk and dv): "
                    "flash_backward_reference, and SDPA forward+backward minus forward "
                    "(both profiler, eager); bound_ms is this kernel's share (dq 1/5, dkv "
                    "4/5) of the whole backward's bound; ms is this kernel's share of the "
                    "whole backward call's replay (delta, dq and dkv), which calls[0] holds "
                    "against the whole backward's bound (call_bound_ms)",
        })
    return rows


# -- phases 11-14: HF import, --draft-hf, checkpoint and resume, the ViT ------


# TinyLlama-1.1B's published config.json (TinyLlama/TinyLlama-1.1B-
# intermediate-step-1431k-3T): the widths, depth and vocabulary of phase 11
TINYLLAMA = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama", "hidden_act": "silu",
    "hidden_size": 2048, "intermediate_size": 5632, "num_hidden_layers": 22,
    "num_attention_heads": 32, "num_key_value_heads": 4, "vocab_size": 32000,
    "rope_theta": 10000.0, "rms_norm_eps": 1e-05, "max_position_embeddings": 2048,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
}
HF_DRAFT_LAYERS = 2
HF_SPEC_K = 4
HF_PROMPT_LENS = [32, 64, 128, 256]
HF_NEW = 48
HF_ENGINE = dict(max_batch=4, max_len=512, page_size=16, fused_steps=16, paged_kernel=True)
HF_SERVE_FLAGS = ["--max-batch", "4", "--max-len", "512", "--page-size", "16",
                  "--fused-steps", "16", "--paged-kernel"]
# logits of unit scale through 22 float32 layers, summed in another order
# (K1's FMA kernel and cuBLAS against einsum and matmul of the plain forward)
HF_LOGIT_TOL = 1e-3


def hf_state_dict(hf: dict, layers: int, dev, seed: int) -> dict:
    """An HF Llama state dict at ``hf``'s widths with ``layers`` layers:
    random bf16 weights (normal / sqrt(fan_in); embedding rows N(0, 1); unit
    norms), drawn on the card from ``seed``, returned on the host."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    D, F, V = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"]
    KV = hf["num_key_value_heads"] * D // hf["num_attention_heads"]

    def w(out_f, in_f, scale=None):
        t = torch.randn(out_f, in_f, generator=g, device=dev)
        return t.mul_(in_f ** -0.5 if scale is None else scale).to(torch.bfloat16).cpu()

    def ones():
        return torch.ones(D, dtype=torch.bfloat16)

    sd = {"model.embed_tokens.weight": w(V, D, 1.0), "model.norm.weight": ones(),
          "lm_head.weight": w(V, D)}
    for i in range(layers):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": ones(),
                   p + "post_attention_layernorm.weight": ones(),
                   p + "self_attn.q_proj.weight": w(D, D), p + "self_attn.k_proj.weight": w(KV, D),
                   p + "self_attn.v_proj.weight": w(KV, D), p + "self_attn.o_proj.weight": w(D, D),
                   p + "mlp.gate_proj.weight": w(F, D), p + "mlp.up_proj.weight": w(F, D),
                   p + "mlp.down_proj.weight": w(D, F)})
    return sd


def write_hf_dir(path: str, hf: dict, sd: dict) -> dict:
    """``config.json`` and ``model.safetensors`` (the port's writer):
    bytes and seconds."""
    from elastic_gpu_scheduler_tpu_torch.utils.safetensors import save_file

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    t0 = time.perf_counter()
    n = save_file(sd, os.path.join(path, "model.safetensors"), metadata={"format": "pt"})
    return {"bytes": n, "write_s": time.perf_counter() - t0}


def plain_llama_logits(sd: dict, hf: dict, tokens, dev):
    """The last position's logits of an HF Llama state dict, in plain
    float32 tensor code on ``dev`` (HF's layout and rotate-half RoPE, GQA by
    repeating the kv heads, softmax over the whole causal score matrix).
    RMSNorm's epsilon is 1e-6, the port's and the reference's: their
    converters do not carry ``rms_norm_eps``."""
    import torch
    import torch.nn.functional as F

    def W(name):
        return sd[name].to(dev, torch.float32)

    H, KV = hf["num_attention_heads"], hf["num_key_value_heads"]
    D = hf["hidden_size"]
    Dh = D // H
    t = torch.as_tensor(tokens, device=dev).long()
    S = t.shape[0]
    x = W("model.embed_tokens.weight")[t]
    inv = 1.0 / (hf["rope_theta"] ** (torch.arange(0, Dh, 2, device=dev).float() / Dh))
    ang = torch.arange(S, device=dev).float()[:, None] * inv[None]
    cos, sin = torch.cat([ang.cos()] * 2, -1)[:, None], torch.cat([ang.sin()] * 2, -1)[:, None]

    def rms(v, wname):
        return v * torch.rsqrt(v.pow(2).mean(-1, keepdim=True) + 1e-6) * W(wname)

    def rot(v):
        return torch.cat([-v[..., Dh // 2:], v[..., : Dh // 2]], -1)

    mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        h = rms(x, p + "input_layernorm.weight")
        q = (h @ W(p + "self_attn.q_proj.weight").t()).view(S, H, Dh)
        k = (h @ W(p + "self_attn.k_proj.weight").t()).view(S, KV, Dh)
        v = (h @ W(p + "self_attn.v_proj.weight").t()).view(S, KV, Dh)
        q, k = q * cos + rot(q) * sin, k * cos + rot(k) * sin
        k, v = k.repeat_interleave(H // KV, 1), v.repeat_interleave(H // KV, 1)
        s = torch.einsum("qhd,khd->hqk", q, k) * Dh ** -0.5
        a = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
        o = torch.einsum("hqk,khd->qhd", a, v).reshape(S, D)
        x = x + o @ W(p + "self_attn.o_proj.weight").t()
        h = rms(x, p + "post_attention_layernorm.weight")
        x = x + (F.silu(h @ W(p + "mlp.gate_proj.weight").t())
                 * (h @ W(p + "mlp.up_proj.weight").t())) @ W(p + "mlp.down_proj.weight").t()
    return rms(x[-1], "model.norm.weight") @ W("lm_head.weight").t()


class ServeProcess:
    """``python -m elastic_gpu_scheduler_tpu_torch.serve`` with ``args`` in
    its own process, as a pod starts it: its log in a file, the seconds
    until /healthz answered 200, SIGTERM (drain) at the end, a kill if it
    does not exit."""

    def __init__(self, args: list, log_path: str):
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            self.port = s.getsockname()[1]
        self.addr = ("127.0.0.1", self.port)
        self.log_path = log_path
        self.log = open(log_path, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "elastic_gpu_scheduler_tpu_torch.serve", "--port",
             str(self.port), "--host", "127.0.0.1", *args],
            cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE), stdout=self.log,
            stderr=subprocess.STDOUT)

    def tail(self) -> str:
        with open(self.log_path) as f:
            return "".join(f.readlines()[-30:])

    def wait_ready(self, timeout: float) -> float:
        deadline = time.monotonic() + timeout
        while True:
            try:
                if get_json(self.addr, "/healthz")[0] == 200:
                    return time.perf_counter() - self.t0
            except OSError:
                pass
            if self.proc.poll() is not None:
                fail(f"serve exited with {self.proc.returncode}:\n{self.tail()}")
            if time.monotonic() > deadline:
                fail(f"serve did not answer /healthz in {timeout} s:\n{self.tail()}")
            time.sleep(0.25)

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(__import__("signal").SIGTERM)
            try:
                self.proc.wait(timeout=90)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.log.close()
        return self.proc.returncode


def http_completions(addr, prompts, max_new) -> tuple[list, float]:
    """The prompts as concurrent blocking completions: (tokens each, wall s)."""
    import threading

    out, errs = [None] * len(prompts), []

    def one(i):
        try:
            code, _, data = post_json(addr, {"prompt": list(prompts[i]), "max_tokens": max_new})
            check(code == 200, f"completion {i}: HTTP {code} {data[:200]!r}")
            out[i] = json.loads(data)["tokens"]
        except Exception as e:  # noqa: BLE001 - re-raised by the caller's check
            errs.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    check(not errs, f"HTTP completions failed: {errs}")
    return out, wall


def phase_hf(dev) -> dict:
    """11. ``serve --hf`` on a Llama-layout checkpoint at TinyLlama-1.1B's
    widths (random bf16 weights from a seed, written as safetensors by the
    port's writer), served as a pod starts it, four concurrent completions
    over HTTP; the same engine built in this process from the same state
    dict (the main path: K1 and K2 launches exact) must give the same
    greedy tokens, and the port's forward the plain float32 forward's
    first-token logits.  12. ``--draft-hf`` with a 2-layer draft (the
    checkpoint's embedding, first two layers and head) and ``--spec-k 4``:
    the greedy streams equal the unspeculated ones, over HTTP and in this
    process (K2's W = 5 launches exact)."""
    import tempfile

    import torch

    from elastic_gpu_scheduler_tpu_torch.models.convert import load_hf
    from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine
    from elastic_gpu_scheduler_tpu_torch.models.transformer import forward, param_count
    from elastic_gpu_scheduler_tpu_torch.ops import _build

    res: dict = {"config": "TinyLlama-1.1B widths (config.json), random bf16 weights, seed 13"}
    work = tempfile.mkdtemp(prefix="hf_")
    try:
        sd = hf_state_dict(TINYLLAMA, TINYLLAMA["num_hidden_layers"], dev, seed=13)
        base_dir, draft_dir = os.path.join(work, "base"), os.path.join(work, "draft")
        res["checkpoint"] = write_hf_dir(base_dir, TINYLLAMA, sd)
        draft_hf = dict(TINYLLAMA, num_hidden_layers=HF_DRAFT_LAYERS)
        keep = ("model.embed_tokens.", "model.norm.", "lm_head.") + tuple(
            f"model.layers.{i}." for i in range(HF_DRAFT_LAYERS))
        res["draft_checkpoint"] = write_hf_dir(
            draft_dir, draft_hf, {k: v for k, v in sd.items() if k.startswith(keep)})
        log(f"hf: wrote {res['checkpoint']['bytes'] / 1e9:.3f} GB base and "
            f"{res['draft_checkpoint']['bytes'] / 1e9:.3f} GB draft safetensors")
        srv = ServeProcess(["--hf", base_dir, *HF_SERVE_FLAGS], os.path.join(work, "serve.log"))
        try:
            # the in-memory engine while the server loads
            t0 = time.perf_counter()
            params, cfg = load_hf(base_dir)
            res["load_s"] = time.perf_counter() - t0
            n_params = param_count(params)
            res["weights_gb"] = n_params * 4 / 1e9
            log(f"hf: load_hf (read + convert on the host) {res['load_s']:.2f} s: "
                f"{n_params / 1e9:.3f}B parameters, {res['weights_gb']:.2f} GB float32, "
                f"{cfg.n_heads}q/{cfg.kv_heads}kv heads, Dh {cfg.head_dim}")
            check(cfg.dtype == "float32" and cfg.kv_heads == 4 and cfg.n_layers == 22,
                  f"converted config {cfg}")
            t0 = time.perf_counter()
            eng = InferenceEngine(params, cfg, device=dev, **HF_ENGINE)
            torch.cuda.synchronize()
            res["to_device_s"] = time.perf_counter() - t0
            del params
            rng = np.random.default_rng(17)
            prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in HF_PROMPT_LENS]
            drive_wall(eng, prompts[:1], 4)  # captures the decode graphs
            # the main path: counts at 0 just before, read just after
            warm0, steps0, pre0 = eng.graph_warmups, eng.steps_run, eng.prefills_run
            _build.reset_launches()
            reqs, wall, chunks = drive_wall(eng, prompts, HF_NEW)
            launches = dict(_build.LAUNCHES)
            L, K = cfg.n_layers, eng.fused_steps
            warm, pre = eng.graph_warmups - warm0, eng.prefills_run - pre0
            want = dict.fromkeys(launches, 0)
            want.update(flash_fwd=L * pre, paged_attention=L * K * (chunks + warm))
            log(f"hf engine main path: {pre} prefills, {chunks} chunks, launches {launches} "
                f"(want {want})")
            check(launches == want and pre == len(prompts), "--hf engine launches differ")
            mem_tokens = [r.output for r in reqs]
            res["engine_tokens_per_s"] = len(prompts) * HF_NEW / wall
            res["engine_launches"] = launches
            # where a float32 chunk's time goes
            prof = chunk_profile(eng, [(p, {}) for p in prompts], "hf float32")
            res["chunk_profile"] = {k: prof[k] for k in (
                "wall_ms_per_chunk", "device_ms_per_chunk", "kernels_per_chunk", "idle_share")}
            res["chunk_profile"]["top"] = [
                {"kernel": k["kernel"][:80], "ms_per_chunk": k["ms"] / CONTROL_WINDOW,
                 "count_per_chunk": k["count"] / CONTROL_WINDOW} for k in prof["top"][:6]]
            for k in res["chunk_profile"]["top"]:
                log(f"  hf chunk: {k['ms_per_chunk']:9.3f} ms  x{k['count_per_chunk']:6.0f}  "
                    f"{k['kernel']}")
            # first-token logits against the plain float32 forward on the card
            p0 = prompts[1]
            with torch.no_grad():
                got = forward(eng.params, torch.tensor([p0], device=dev), cfg)[0, -1]
                want_l = plain_llama_logits(sd, TINYLLAMA, p0, dev)
            err = maxerr(got, want_l)
            top2 = torch.topk(want_l, 2).values
            margin = float(top2[0] - top2[1])
            res["first_logits"] = {"max_abs_err": err, "tolerance": HF_LOGIT_TOL,
                                   "max_abs_logit": float(want_l.abs().max()),
                                   "top2_margin": margin}
            log(f"hf first-token logits, port forward (K1) vs plain float32 forward: max|d| "
                f"{err:.3g} (tol {HF_LOGIT_TOL}), max|logit| {float(want_l.abs().max()):.3g}, "
                f"top-2 margin {margin:.3g}")
            check(err <= HF_LOGIT_TOL, "--hf logits disagree with the plain forward")
            if margin > 2 * HF_LOGIT_TOL:
                check(mem_tokens[1][0] == int(torch.argmax(want_l)),
                      "the first token is not the plain forward's argmax")
            # the server: the same tokens over HTTP
            res["serve_ready_s"] = srv.wait_ready(600)
            http_completions(srv.addr, prompts[:1], 4)  # its graphs
            got_t, wall = http_completions(srv.addr, prompts, HF_NEW)
            res["http_tokens_per_s"] = len(prompts) * HF_NEW / wall
            res["http_wall_s"] = wall
            check(got_t == mem_tokens, "serve --hf tokens differ from the in-memory engine's")
            stats = get_json(srv.addr, "/v1/stats")[1]
            log(f"serve --hf: ready in {res['serve_ready_s']:.1f} s, 4 concurrent completions "
                f"x {HF_NEW} tokens in {wall:.2f} s ({res['http_tokens_per_s']:.1f} tokens/s; "
                f"in memory {res['engine_tokens_per_s']:.1f}), greedy tokens identical to the "
                f"in-memory engine's")
            check(stats["spec_k"] == 0, "serve --hf stats")
        finally:
            rc = srv.stop()
        check(rc == 0, f"serve --hf exited {rc}:\n{srv.tail()}")
        check("serving hf-imported model (22 layers, d=2048)" in open(srv.log_path).read(),
              "serve --hf did not log its hf-imported model")
        # 12. --draft-hf
        srv = ServeProcess(["--hf", base_dir, "--draft-hf", draft_dir, "--spec-k",
                            str(HF_SPEC_K), *HF_SERVE_FLAGS], os.path.join(work, "draft.log"))
        try:
            dparams, dcfg = load_hf(draft_dir)
            seng = InferenceEngine(eng.params, cfg, device=dev, spec_k=HF_SPEC_K,
                                   draft=(dparams, dcfg), **HF_ENGINE)
            del dparams
            drive_wall(seng, prompts[:1], 4)
            marks = spec_marks(seng)
            _build.reset_launches()
            sreqs, swall, _ = drive_wall(seng, prompts, HF_NEW)
            launches = dict(_build.LAUNCHES)
            c = spec_counts(seng, marks)
            chunks = c["steps"] - c["passes"]
            want_k2 = cfg.n_layers * (c["passes"] + seng.fused_steps * (chunks + c["warmups"]))
            log(f"hf draft engine main path: {c['passes']} verify passes ({c['accepted']} "
                f"drafts accepted), {chunks} chunks, launches {launches} (want "
                f"paged_attention={want_k2})")
            check(c["passes"] > 0 and launches["paged_attention"] == want_k2,
                  "--draft-hf engine K2 launches differ from the path")
            check([r.output for r in sreqs] == mem_tokens,
                  "the draft engine's greedy tokens differ from the unspeculated ones")
            res["draft_engine"] = {"tokens_per_s": len(prompts) * HF_NEW / swall,
                                   "passes": c["passes"], "accepted": c["accepted"],
                                   "accepted_a_pass": c["accepted"] / c["passes"],
                                   "launches": launches}
            del seng
            res["draft_serve_ready_s"] = srv.wait_ready(600)
            http_completions(srv.addr, prompts[:1], 4)
            got_t, wall = http_completions(srv.addr, prompts, HF_NEW)
            stats = get_json(srv.addr, "/v1/stats")[1]
            res["draft_http_tokens_per_s"] = len(prompts) * HF_NEW / wall
            log(f"serve --hf --draft-hf --spec-k {HF_SPEC_K}: ready in "
                f"{res['draft_serve_ready_s']:.1f} s, {res['draft_http_tokens_per_s']:.1f} "
                f"tokens/s over HTTP, {stats['spec_passes']} passes, {stats['spec_accepted']} "
                f"accepted; streams equal to the unspeculated ones")
            check(got_t == mem_tokens, "--draft-hf streams differ from the unspeculated ones")
            check(stats["spec_k"] == HF_SPEC_K and stats["spec_passes"] > 0,
                  "serve --draft-hf ran no verify pass")
        finally:
            rc = srv.stop()
        check(rc == 0, f"serve --draft-hf exited {rc}:\n{srv.tail()}")
        del eng
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    log("hf: " + json.dumps(res))
    return res


# 13. checkpoint and resume: the dense flagship's width, depth cut to 2
# layers (its checkpoint holds bf16 params, fp32 masters and both fp32
# moments: ~3.5 GB a step at L 2), phase 9's batch and sequence
RESUME_MODEL = dict(TRAIN, n_layers=2)
RESUME_JOB = dict(steps=6, batch_size=TRAIN_B, seq_len=TRAIN_S, lr=3e-4, checkpoint_every=2)
RESUME_KILL_AT = 5  # the child dies as it starts step 5: saves of 2 and 4 dispatched


def resume_child(ckpt_dir: str) -> None:
    """The interrupted job, run in its own process: ``launcher.run_job``
    with a save every 2 steps, SIGKILLed as its train step is called for
    step RESUME_KILL_AT (no clean-up, a save possibly mid-write)."""
    import signal

    import torch

    from elastic_gpu_scheduler_tpu_torch import launcher
    from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    real = launcher.make_train_step

    def make(*a, **k):
        fn, calls = real(*a, **k), [0]

        def step(*args):
            if calls[0] == RESUME_KILL_AT:
                print(f"killed at step {calls[0]}", flush=True)
                os.kill(os.getpid(), signal.SIGKILL)
            calls[0] += 1
            return fn(*args)

        return step

    launcher.make_train_step = make
    spec = launcher.JobSpec(model=TransformerConfig(**RESUME_MODEL), checkpoint_dir=ckpt_dir,
                            **RESUME_JOB)
    launcher.run_job(spec, device="cuda")


def _flat_file(step_dir: str) -> list:
    import torch

    payload = torch.load(os.path.join(step_dir, "state.pt"), map_location="cpu",
                         weights_only=True)
    return payload["params"] + payload["opt_state"]


def phase_resume(dev) -> dict:
    """13. ``launcher.run_job`` with checkpoints at the dense flagship's
    width (L 2): uninterrupted (the main path); killed in a child process
    after its saves of steps 2 and 4 were dispatched, then resumed here
    from the latest complete step; the resumed losses and the final
    checkpoint against the uninterrupted run's (bitwise, else the largest
    difference); the manager's save (the host copy), write and restore
    times and bytes."""
    import shutil
    import tempfile

    import torch

    from elastic_gpu_scheduler_tpu_torch import launcher
    from elastic_gpu_scheduler_tpu_torch.models.checkpoint import CheckpointManager
    from elastic_gpu_scheduler_tpu_torch.models.train import init_state, make_optimizer
    from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig
    from elastic_gpu_scheduler_tpu_torch.ops import _build

    cfg = TransformerConfig(**RESUME_MODEL)
    work = tempfile.mkdtemp(prefix="resume_")
    res: dict = {"model": f"dense flagship widths, L {cfg.n_layers} (cut from 16), "
                          f"B {TRAIN_B}, S {TRAIN_S}", "steps": RESUME_JOB["steps"]}
    try:
        whole_dir, cut_dir = os.path.join(work, "whole"), os.path.join(work, "cut")
        # the main path: counts at 0 just before, read just after
        _build.reset_launches()
        t0 = time.perf_counter()
        whole = launcher.run_job(launcher.JobSpec(
            model=cfg, checkpoint_dir=whole_dir, **dict(RESUME_JOB, checkpoint_every=6)),
            device=dev)
        res["whole_s"] = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        L, n = cfg.n_layers, RESUME_JOB["steps"]
        want = dict.fromkeys(launches, 0)
        want.update(flash_fwd=2 * L * n, flash_bwd_dq=L * n, flash_bwd_dkv=L * n)
        log(f"resume: uninterrupted run_job, {n} steps in {res['whole_s']:.2f} s, losses "
            f"{whole}, launches {launches} (want {want})")
        check(launches == want, "run_job with checkpoints: K1 / K4 launches differ")
        # the killed child
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
             "import chip_smoke; chip_smoke.resume_child(sys.argv[2])", HERE, cut_dir],
            cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE), capture_output=True, text=True,
            timeout=600)
        res["child_s"] = time.perf_counter() - t0
        check(child.returncode == -9, f"the child was to die by SIGKILL, exit "
              f"{child.returncode}: {child.stderr[-2000:]}")
        left = sorted(os.listdir(cut_dir))
        res["left_on_disk"] = left
        log(f"resume: child killed at step {RESUME_KILL_AT} after {res['child_s']:.1f} s; on "
            f"disk: {left}")
        t0 = time.perf_counter()
        resumed = launcher.run_job(launcher.JobSpec(model=cfg, checkpoint_dir=cut_dir,
                                                    **RESUME_JOB), device=dev)
        res["resume_run_s"] = time.perf_counter() - t0
        start = n - len(resumed)
        res["resumed_from"] = start
        check(start in (2, 4), f"resumed from step {start}, not a saved step")
        loss_diff = max(abs(a - b) for a, b in zip(resumed, whole[start:]))
        a_leaves = _flat_file(os.path.join(whole_dir, f"step_{n:08d}"))
        b_leaves = _flat_file(os.path.join(cut_dir, f"step_{n:08d}"))
        check(len(a_leaves) == len(b_leaves), "the final checkpoints differ in leaves")
        bitwise = resumed == whole[start:] and all(
            torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
            for a, b in zip(a_leaves, b_leaves))
        state_diff = max(float((a.float() - b.float()).abs().max()) if isinstance(
            a, torch.Tensor) else abs(a - b) for a, b in zip(a_leaves, b_leaves))
        res.update(losses_whole=whole, losses_resumed=resumed, bitwise=bitwise,
                   max_loss_diff=loss_diff, max_state_diff=state_diff)
        log(f"resume: resumed from step {start}: losses {resumed} against {whole[start:]}; "
            f"final params and optimizer state {'bitwise equal' if bitwise else 'differ'} "
            f"(largest loss difference {loss_diff:.3g}, state {state_diff:.3g})")
        check(loss_diff <= 1e-3 and state_diff <= 1e-2,
              "the resumed run is far from the uninterrupted one")
        del a_leaves, b_leaves
        # the manager alone: save (host copy), write, restore, bytes
        opt = make_optimizer(lr=RESUME_JOB["lr"], grad_clip=1.0)
        params, state = init_state(cfg, opt, torch.Generator(device=dev).manual_seed(0), dev)
        mgr = CheckpointManager(os.path.join(work, "timed"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(params, state, 1)
        res["save_call_ms"] = (time.perf_counter() - t0) * 1e3
        mgr.wait()
        res["save_total_ms"] = (time.perf_counter() - t0) * 1e3
        res["bytes"] = os.path.getsize(os.path.join(mgr.step_dir(1), "state.pt"))
        t0 = time.perf_counter()
        out = mgr.restore(params, state)
        torch.cuda.synchronize()
        res["restore_ms"] = (time.perf_counter() - t0) * 1e3
        check(out is not None and out[2] == 1, "restore of the timed save")
        log(f"checkpoint manager at L {cfg.n_layers}: {res['bytes'] / 1e9:.3f} GB; save call "
            f"(device-to-host copy) {res['save_call_ms']:.1f} ms, save with the write "
            f"{res['save_total_ms']:.1f} ms, restore {res['restore_ms']:.1f} ms")
        del params, state, out
    finally:
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    log("resume: " + json.dumps({k: v for k, v in res.items()
                                 if k not in ("losses_whole", "losses_resumed")}))
    return res


# 14. the ViT at ViT-B/16's widths (image 224, patch 16, D 768, 12 heads,
# d_ff 3072, 1000 classes, bf16 compute, fp32 weights); all 12 layers
VIT_B16 = dict(image_size=224, patch_size=16, channels=3, n_classes=1000, d_model=768,
               n_layers=12, n_heads=12, d_ff=3072, dtype="bfloat16")
VIT_B, VIT_STEPS = 64, 5
VIT_ATTN = (VIT_B, 12, 197, 197, 64)  # B, H, Sq, Sk, Dh: 196 patches + CLS


def vit_matmul_flops_fwd(cfg, batch: int) -> float:
    """Matmul forward FLOPs of the ViT: patch embedding, projections, the
    FFN, both attention products over all S x S pairs, the head."""
    S, D, F, L = cfg.n_patches + 1, cfg.d_model, cfg.d_ff, cfg.n_layers
    patch = cfg.n_patches * 2 * cfg.patch_size ** 2 * cfg.channels * D
    layer = S * (8 * D * D + 6 * D * F) + 4 * S * S * D
    return float(batch * (patch + L * layer + 2 * D * cfg.n_classes))


def phase_vit(dev) -> dict:
    """14. ViT training at ViT-B/16's widths: one warm-up and VIT_STEPS
    timed steps on one batch of random images; the loss finite and
    falling, K1 L a step and K4 L a step, all non-causal."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models.train import make_optimizer
    from elastic_gpu_scheduler_tpu_torch.models.transformer import param_count
    from elastic_gpu_scheduler_tpu_torch.models.vit import (
        ViTConfig,
        init_vit_params,
        make_vit_train_step,
    )
    from elastic_gpu_scheduler_tpu_torch.ops import _build

    cfg = ViTConfig(**VIT_B16)
    params = init_vit_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = make_optimizer(lr=1e-4)
    state = opt.init(params)
    step = make_vit_train_step(cfg, opt)
    g = torch.Generator(device=dev).manual_seed(1)
    images = torch.randn(VIT_B, 224, 224, 3, generator=g, device=dev)
    labels = torch.randint(0, cfg.n_classes, (VIT_B,), generator=g, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    # the main path: counts at 0 just before, read just after
    _build.reset_launches()
    losses, times = [], []
    for _ in range(VIT_STEPS + 1):
        t0 = time.perf_counter()
        loss = step(params, state, images, labels)[2]
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    launches = dict(_build.LAUNCHES)
    L, n = cfg.n_layers, VIT_STEPS + 1
    want = dict.fromkeys(launches, 0)
    want.update(flash_fwd=L * n, flash_bwd_dq=L * n, flash_bwd_dkv=L * n)
    log(f"vit main path: {param_count(params) / 1e6:.1f}M parameters, B {VIT_B}, {n} steps, "
        f"losses {[round(x, 4) for x in losses]}, launches {launches} (want {want})")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], "ViT loss not finite or not falling")
    check(launches == want, "ViT launches differ from L (K1) and L (K4) a step")
    step_ms = float(np.mean(times[1:])) * 1e3
    flops = 3 * vit_matmul_flops_fwd(cfg, VIT_B)
    perf = {"config": "ViT-B/16 widths, 12 layers (not cut)", "batch": VIT_B,
            "params_m": param_count(params) / 1e6, "step_ms": step_ms,
            "step_ms_each": [x * 1e3 for x in times],
            "images_per_s": VIT_B / (step_ms / 1e3),
            "model_tflops": flops / (step_ms / 1e3) / 1e12,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "losses": losses, "launches": launches}
    log("vit perf: " + json.dumps(perf))
    del params, state, step, images
    gc.collect()
    torch.cuda.empty_cache()
    return perf


def kernel_vit_rows(dev) -> list[dict]:
    """K1 and K4 at the ViT's attention shape (B, 12, 197, 64), bf16, not
    causal: held to ``mha_reference`` and ``flash_backward_reference``
    (``grad_close``), read as the train rows are, with non-causal SDPA
    forward and backward as the library calls; launches filled in from
    phase 14."""
    import torch
    import torch.nn.functional as F

    from elastic_gpu_scheduler_tpu_torch.ops.attention import (
        flash_attention,
        flash_backward,
        flash_backward_reference,
        grad_close,
        mha_reference,
    )

    B, H, S, _, D = VIT_ATTN
    g = torch.Generator(device=dev).manual_seed(19)
    q, k, v, do = (torch.randn(B, H, S, D, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    out, lse = flash_attention(q, k, v, False, None, 0, return_lse=True)
    ref, ref_lse = mha_reference(q, k, v, False, None, 0)
    k1_err, lse_err = maxerr(out, ref), maxerr(lse, ref_lse)
    log(f"K1 at the ViT shape (not causal): max|out-ref|={k1_err:.3g} max|lse-ref|={lse_err:.3g}")
    check(close(out, ref, "bfloat16") and lse_err <= 1e-4,
          "K1 disagrees with mha_reference at the ViT shape")
    got = flash_backward(q, k, v, out, lse, do, False, None, 0)
    want = flash_backward_reference(q, k, v, out, lse, do, False, None, 0,
                                    round_like_kernel=True)
    k4_err = {}
    for nm, a, b in zip(("dq", "dk", "dv"), got, want):
        use, text = tol_use(a, b)
        log(f"K4 at the ViT shape (not causal) {nm}: {text}")
        check(grad_close(a, b), f"K4 {nm} disagrees with flash_backward_reference at the ViT shape")
        k4_err[nm] = maxerr(a, b)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(flash_attention(*leaves, False, None, 0), leaves, do)
    plain = torch.autograd.grad(mha_reference(*leaves, False, None, 0)[0], leaves, do)
    for nm, a, b in zip(("dq", "dk", "dv"), auto, plain):
        use, text = tol_use(a, b, rounded=False)
        log(f"FlashAttention at the ViT shape {nm} against autograd of mha_reference: {text}")
        check(grad_close(a, b, rounded=False), "ViT-shape gradients disagree with autograd")
    del got, want, auto, plain, leaves
    k1_bound, k1_by = k1_bound_ms(B, H, S, S, D, False, 0, 2)
    k1_rd = replay_readings(lambda: flash_attention(q, k, v, False, None, 0), 20,
                            bound=k1_bound)
    k1_plain = device_ms(lambda: mha_reference(q, k, v, False, None, 0), 5)
    k1_lib = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
    k4_bound, k4_by = k4_bound_ms(B, H, S, S, D, False, 0, 2)

    def bwd():
        return flash_backward(q, k, v, out, lse, do, False, None, 0)

    bwd_rd = replay_readings(bwd, 10, matches=("flash_bwd_dq", "flash_bwd_dkv"),
                             call_bound=k4_bound)
    plain_bwd = device_ms(lambda: flash_backward_reference(q, k, v, ref, ref_lse, do, False,
                                                           None, 0), 3)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def sdpa_fwd_bwd():
        return torch.autograd.grad(F.scaled_dot_product_attention(*leaves), leaves, do)

    lib_bwd = device_ms(sdpa_fwd_bwd, 10) - device_ms(
        lambda: F.scaled_dot_product_attention(q, k, v), 20)
    dq_ms, dkv_ms = bwd_rd["ms"]["flash_bwd_dq"], bwd_rd["ms"]["flash_bwd_dkv"]
    log(f"ViT-shape timing (B={B} H={H} S={S} D={D} bf16, not causal): K1 {k1_rd['ms']['']:.5f} "
        f"ms (profiler {k1_rd['profiler_ms']['']:.5f}; plain {k1_plain:.4f}, sdpa {k1_lib:.5f}, "
        f"bound {k1_bound:.5f} {k1_by}); K4 dq {dq_ms:.5f} + dkv {dkv_ms:.5f} ms (call "
        f"{bwd_rd['call_ms']:.5f}, profiler {bwd_rd['profiler_call_ms']:.5f}; plain backward "
        f"{plain_bwd:.4f}, sdpa backward {lib_bwd:.5f}, bound {k4_bound:.5f} {k4_by})")
    src = "elastic_gpu_scheduler_tpu_torch/csrc/"
    rows = [{
        **reading_fields([(1, k1_rd)]),
        "name": "flash_fwd", "path": "vit", "route": "cuda", "source": src + "flash_fwd.cu",
        "replaces": "elastic_gpu_scheduler_tpu/ops/attention.py:290",
        "launches": 0, "max_abs_err": k1_err, "plain_ms": k1_plain, "bound_ms": k1_bound,
        "bound_by": k1_by, "library_ms": k1_lib,
        "note": "not causal, S 197; library_ms is non-causal SDPA",
    }]
    errs = {"dq": k4_err["dq"], "dkv": max(k4_err["dk"], k4_err["dv"])}
    for which in ("dq", "dkv"):
        bound = K4_SHARE[which] * k4_bound
        rows.append({
            **reading_fields([(1, bwd_rd)], f"flash_bwd_{which}", bound),
            "name": f"flash_bwd_{which}", "path": "vit", "route": "cuda",
            "source": src + "flash_bwd.cu",
            "replaces": "elastic_gpu_scheduler_tpu/ops/attention.py:633",
            "launches": 0, "max_abs_err": errs[which], "plain_ms": plain_bwd,
            "bound_ms": bound, "bound_by": k4_by, "library_ms": lib_bwd,
            "note": "not causal, S 197; plain_ms and library_ms are the whole backward "
                    "(flash_backward_reference; non-causal SDPA forward+backward minus "
                    "forward), bound_ms this kernel's share of the whole backward's bound",
        })
    del q, k, v, do, out, lse, ref, ref_lse, leaves
    torch.cuda.empty_cache()
    return rows


# -- phase 15: training on a mesh -----------------------------------------------

MESH_STEPS = 3
# the ranks of (b) to (g) share the one card over gloo, which stages every
# collective through the host: (label, mesh axes, config fields); one world
# of ranks a mesh size, each mesh over its whole world
MESH_GLOO = [("tensor=2", dict(tensor=2), {}),
             ("seq=2 ring", dict(seq=2), dict(use_ring_attention=True)),
             ("fsdp=2,tensor=2", dict(fsdp=2, tensor=2), {})]
MESH_OPT = dict(mu_dtype="bfloat16", grad_clip=1.0)
# (b)'s depth cut, for time and memory: every collective of a rank crosses
# the host (gloo); at 2 layers a step takes 1.6-4.5 s a mesh and the three
# meshes' runs ~80 s, 16 layers would take about 8x that, and each seq=2
# rank holds the whole model's state and moments beside the other's
MESH_LAYERS = 2
# (c): a small float32 model on the same meshes, held to the card's
# single-device run within MESH_F32_TOL
MESH_SMALL = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=512,
                  dtype="float32", remat=True, xent_chunks=4)
MESH_SMALL_B, MESH_SMALL_S = 4, 128
MESH_F32_TOL = 1e-5
# (b), (e), (f): the flagship in bf16 against its single-device run: a
# row-parallel product sums two bf16-rounded partial outputs where one
# device rounds once, and the ring runs attention in float32; the losses of
# 3 steps stay within this (absolute, of losses from 10.8 to 3.1)
MESH_BF16_TOL = 1e-3
# (e): the pipe axis at the flagship's widths, depth cut to 4 layers (2 a
# stage), 4 microbatches of 2 rows
MESH_PIPE = dict(n_layers=4, n_microbatches=4)
# (f): the expert axis at the flagship's widths with 8 experts, depth cut to
# 2 layers (4 experts a rank)
MESH_MOE = dict(n_layers=2, n_experts=8)
# (g): the small float32 model on the new axes, at 4 layers where pipe is in
# the mesh; MoE with 4 experts.  Pipelined MoE routes each global
# microbatch on its own, as the reference does (over data or fsdp too): its
# one-device run is the step that accumulates the same microbatches
# (grad_accum = n_microbatches)
SMALL_PIPE = dict(n_layers=4, n_microbatches=2)
SMALL_MOE = dict(n_experts=4)
MESH_NEW = [
    ("pipe=2,seq=2 ring", dict(pipe=2, seq=2), dict(SMALL_PIPE, use_ring_attention=True), 1),
    ("pipe=2,tensor=2", dict(pipe=2, tensor=2), SMALL_PIPE, 1),
    ("data=2,expert=2", dict(data=2, expert=2), SMALL_MOE, 1),
    ("expert=2,pipe=2", dict(expert=2, pipe=2), dict(SMALL_PIPE, **SMALL_MOE), 2),
    # the batch cut over data or fsdp: each rank pipelines its share of every
    # global microbatch, which routes over the row ranks as one
    ("data=2,pipe=2 MoE", dict(data=2, pipe=2), dict(SMALL_PIPE, **SMALL_MOE), 2),
    ("fsdp=2,pipe=2 MoE", dict(fsdp=2, pipe=2), dict(SMALL_PIPE, **SMALL_MOE), 2),
]
# (d): float32 jobs saved at step 2 of 4 on tensor=2, pipe=2 (pipelined) and
# expert=2 (MoE), resumed on one device
MESH_RESUME = dict(steps=4, batch_size=MESH_SMALL_B, seq_len=MESH_SMALL_S, lr=1e-3)
MESH_RESUME_JOBS = [("tensor=2", dict(tensor=2), {}),
                    ("pipe=2", dict(pipe=2), SMALL_PIPE),
                    ("expert=2", dict(expert=2), SMALL_MOE)]


def mesh_want(cfg, kw, seq_index: int, steps: int) -> dict:
    """A rank's exact launches: K1 2L and K4 L a step (remat) off the ring;
    on the ring K3 and K4 once a kept hop a layer, and rank i of the seq
    axis keeps i + 1 hops (the later shards' hops keep no key), K3 twice
    (the forward and its recomputation).  Pipelined, a rank runs its
    stage's L/pipe layers once a microbatch."""
    L, reps = cfg["n_layers"], 1
    if cfg.get("n_microbatches", 0) > 0 and kw.get("pipe", 1) > 1:
        L, reps = L // kw["pipe"], cfg["n_microbatches"]
    n = L * reps * steps
    if kw.get("seq", 1) > 1 and cfg.get("use_ring_attention"):
        hops = seq_index + 1
        return dict(flash_block_stats=2 * n * hops, flash_bwd_dq=n * hops,
                    flash_bwd_dkv=n * hops)
    return dict(flash_fwd=2 * n, flash_bwd_dq=n, flash_bwd_dkv=n)


def mesh_step_profile(step, params, state, tok) -> dict:
    """One more step of rank 0 under torch.profiler (the other ranks run it
    plainly beside): its wall ms, the device's busy share of it, the shares
    of the device time in gloo's host staging copies, the ring's K3 / K4
    and K1, and the top kernels by device time."""
    wall_ms, kernels = profiled(lambda: float(step(params, state, tok)[2]),
                                "a mesh step", cpu=True)
    busy = sum(k["ms"] for k in kernels)

    def share(*subs):
        return sum(k["ms"] for k in kernels if any(s in k["kernel"] for s in subs)) / busy

    return {"wall_ms": wall_ms, "device_busy_ms": busy, "busy_share": busy / wall_ms,
            "copy_share": share("Memcpy"), "k3_share": share("flash_stats"), "k4_fp32_share": share("fp32_kernel"),
            "k4_share": share("flash_bwd"), "k1_share": share("flash_fwd"),
            "launches": sum(k["count"] for k in kernels), "top": kernels[:10]}


def mesh_rank(rank, world, rendezvous, runs, resume_dir):
    """One rank of a phase-15 gloo world (a spawned process): each run in
    ``runs`` trains MESH_STEPS steps on its slices and rows over the whole
    world; a run marked ``profile`` then takes one more step, rank 0's
    under torch.profiler.  With ``resume_dir``, then (d)'s jobs through
    ``launcher.run_job``.  Returns losses, step ms, peak memory and launch
    counts a run."""
    import torch

    from elastic_gpu_scheduler_tpu_torch import launcher
    from elastic_gpu_scheduler_tpu_torch.models.train import (
        init_sharded_state,
        make_optimizer,
        make_train_step,
    )
    from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig
    from elastic_gpu_scheduler_tpu_torch.ops import _build
    from elastic_gpu_scheduler_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
    )
    from elastic_gpu_scheduler_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from elastic_gpu_scheduler_tpu_torch.parallel.sharding import local_batch

    # the ranks share the card: segments that grow keep fragments small
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    torch.backends.cuda.matmul.allow_tf32 = False
    maybe_initialize_distributed(rendezvous, world, rank, backend="gloo", local_rank=rank,
                                 local_ranks=world)
    dev = torch.device("cuda", torch.cuda.current_device())
    _build.lib()  # built by the parent before the spawn
    out = {}
    for run in runs:
        name = run["name"]
        mesh = make_mesh(MeshSpec(**run["kw"])).connect()
        cfg = TransformerConfig(**run["cfg"])
        opt = make_optimizer(**run["opt"])
        params, state = init_sharded_state(cfg, opt, torch.Generator(device=dev).manual_seed(0),
                                           dev, mesh)
        step = make_train_step(cfg, opt, mesh)
        tok = local_batch(torch.from_numpy(run["tokens"]).to(dev), mesh)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        # the main path: counts at 0 just before, read just after
        _build.reset_launches()
        losses, times = [], []
        for _ in range(MESH_STEPS):
            t0 = time.perf_counter()
            losses.append(float(step(params, state, tok)[2]))  # synchronizes
            times.append((time.perf_counter() - t0) * 1e3)
            print(f"mesh rank {rank} {name}: step {len(times)} loss {losses[-1]:.5f} in "
                  f"{times[-1]:.1f} ms", file=sys.stderr, flush=True)
        out[name] = {"losses": losses, "step_ms": times, "seq_index": mesh.axis_index("seq"),
                     "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                     "launches": dict(_build.LAUNCHES)}
        if run.get("profile"):
            if rank == 0:
                out[name]["profile"] = mesh_step_profile(step, params, state, tok)
            else:
                float(step(params, state, tok)[2])
        del params, state, step, tok
        gc.collect()
        torch.cuda.empty_cache()
    if resume_dir:  # (d): each job uninterrupted, and once saved at step 2
        for label, kw, extra in MESH_RESUME_JOBS:
            model = TransformerConfig(**dict(MESH_SMALL, **extra))
            spec = launcher.MeshSpec(**kw)
            out[f"resume {label}"] = launcher.run_job(
                launcher.JobSpec(model=model, mesh=spec, **MESH_RESUME))
            launcher.run_job(launcher.JobSpec(
                model=model, mesh=spec, checkpoint_dir=os.path.join(resume_dir, label),
                checkpoint_every=2, **dict(MESH_RESUME, steps=2)))
    return out


def mesh_nccl_rank(rank, world, rendezvous, job):
    """(a)'s one rank: a real NCCL process group of one, ``run_job`` on it."""
    import torch
    import torch.distributed as dist

    from elastic_gpu_scheduler_tpu_torch import launcher
    from elastic_gpu_scheduler_tpu_torch.ops import _build
    from elastic_gpu_scheduler_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    maybe_initialize_distributed(rendezvous, world, rank, local_rank=rank, local_ranks=world)
    _build.lib()
    _build.reset_launches()
    losses = launcher.run_job(job)
    return {"losses": losses, "backend": str(dist.get_backend()),
            "world": dist.get_world_size(), "launches": dict(_build.LAUNCHES)}


def single_device_losses(dev, cfg_kw, opt_kw, tokens, grad_accum: int = 1) -> list[float]:
    """The same steps on one device with no process group: the baseline."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models.train import (
        init_state,
        make_optimizer,
        make_train_step,
    )
    from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig

    cfg, opt = TransformerConfig(**cfg_kw), make_optimizer(**opt_kw)
    params, state = init_state(cfg, opt, torch.Generator(device=dev).manual_seed(0), dev)
    step = make_train_step(cfg, opt, grad_accum=grad_accum)
    tok = torch.from_numpy(tokens).to(dev)
    losses = [float(step(params, state, tok)[2]) for _ in range(MESH_STEPS)]
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return losses


# -- phase 16: serving on a mesh ---------------------------------------------


SERVE_MESH_ENGINE = dict(ENGINE, paged_kernel=True)
SERVE_MESH_SMALL = dict(FULL, n_layers=4, dtype="float32")  # (b)-(d): depth cut for time
# (g)'s engine: ENGINE's batch and page with max_len and fused_steps cut for
# time (a lattice of 6 pad lengths and 5 x 3 decode points)
SERVE_MESH_WARM_ENGINE = dict(max_len=256, fused_steps=8)
SERVE_MESH_K2_EVERY = 97  # rank 0 of (a) bf16 keeps every 97th K2 call's inputs
# (b) int8 weights and (c): every rank keeps every 37th KE call's inputs
# (of 3L or 7L + 1 a pass: prefills and decode steps, several projections)
SERVE_MESH_KE_EVERY = 37
# (a) bf16: a mesh's first-token logits stay within this many bf16 ulps
# (at the prompt's largest |logit|) of one device's; the H100 read 0.0645 to
# 0.0781, 2 to 2.5 ulps of 1/32 (PERF.md §6)
SERVE_MESH_BF16_ULPS = 4


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def serve_mesh_plan():
    """Phase 16's runs by world: (backend, [run, ...]).  A run names its
    mesh axes, model, engine options, traffic (waves of prompts) and new
    tokens; the traffic is 8 of the serve bench's prompts, or for the
    prefix-cached run a primer then four prompts on its 256-token prefix."""
    rng = np.random.default_rng(11)
    V = FULL["vocab_size"]
    main = [rng.integers(0, V, n).tolist() for n in PROMPT_LENS[:8]]
    r2 = np.random.default_rng(16)
    wave1, wave2 = prefix_traffic(r2, V, SHARED_PREFIX, (8,), (16, 48, 80, 129))
    t2, e2 = dict(tensor=2), dict(expert=2)

    def run(name, kw, cfg, new, waves=(main,), **more):
        return dict(name=name, kw=kw, cfg=cfg, new=new, waves=[list(w) for w in waves],
                    engine=dict(SERVE_MESH_ENGINE, **more.pop("engine", {})), **more)

    return {
        (2, "gloo"): [
            # first: its first warm-up pass is the ranks' first work (cold)
            run("(g) warm-up twice", t2, SERVE_MESH_SMALL, 16,
                waves=([main[i] for i in (0, 1, 4, 5)],), warm=True,
                engine=SERVE_MESH_WARM_ENGINE),
            run("(a) float32", t2, dict(FULL, dtype="float32"), 32, logits=True),
            run("(a) bf16", t2, FULL, 64, sample_k2=True, logits=True),
            run("(b) int8 KV, prefix, chunked, spec_k 4", t2, SERVE_MESH_SMALL, 16,
                waves=(wave1, wave2),
                engine=dict(kv_int8=True, prefix_cache=True, prefill_chunk=128, spec_k=4)),
            run("(b) int8 weights", t2, SERVE_MESH_SMALL, 16, int8=True, sample_ke=True),
            run("(c) MoE expert=2", e2, dict(SERVE_MESH_SMALL, n_experts=8), 16,
                sample_ke=True),
            run("(f) disaggregated verbs, float32 pool", t2, SERVE_MESH_SMALL, DISAGG_NEW,
                disagg=True, engine=DISAGG_MESH_ENGINE),
            run("(f) disaggregated verbs, int8 pool", t2, SERVE_MESH_SMALL, DISAGG_NEW,
                disagg=True, engine=dict(DISAGG_MESH_ENGINE, kv_int8=True)),
        ],
        (4, "gloo"): [run("(c) MoE expert=2,tensor=2", dict(expert=2, tensor=2),
                          dict(SERVE_MESH_SMALL, n_experts=8), 16, sample_ke=True)],
        (1, "nccl"): [run("(d) NCCL tensor=1", dict(tensor=1), SERVE_MESH_SMALL, 32,
                          captured=True)],
    }


def serve_mesh_run(dev, mesh, run) -> dict:
    """One run of phase 16 on this process's device: the model from seed 0
    (int8 when asked), the engine on ``mesh`` (None: one device, the
    sequential reference) cut to this rank's slice, the traffic in waves
    (rank 0 submits; a follower follows).  Counts at 0 just before the
    main path, read just after; the serving passes are counted by kind, so
    each kernel's launches are held to them."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models import serving
    from elastic_gpu_scheduler_tpu_torch.models.quantize import quantize_params
    from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine, Request
    from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig, init_params
    from elastic_gpu_scheduler_tpu_torch.ops import _build

    cfg = TransformerConfig(**run["cfg"])
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    if run.get("int8"):
        params = quantize_params(params)
    kw = dict(run["engine"])
    if mesh is None:
        kw["overlap"] = False
    eng = InferenceEngine(params, cfg, device=dev, mesh=mesh, **kw)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    resident = torch.cuda.memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    calls = dict.fromkeys(("_paged_prefill", "_paged_prefill_prefixed", "_paged_decode_step",
                           "_fused_verify_chunk"), 0)
    real = {n: getattr(serving, n) for n in calls}
    first, prefill_logits = [], []

    def counted(name):
        def call(*args, **k):
            calls[name] += 1
            out = real[name](*args, **k)
            if name == "_paged_decode_step" and run.get("logits") and not first:
                first.append(out[0].float().cpu())
            if name == "_paged_prefill" and run.get("logits"):
                prefill_logits.append(out[0].float().cpu())  # each prompt's first token's
            return out
        return call

    log_ = []
    emit = eng._emit

    def logged(req, tok, *a, **k):
        log_.append(int(tok))
        emit(req, tok, *a, **k)

    eng._emit = logged
    sampler = None
    if run.get("sample_k2") and eng.leader and mesh is not None:
        sampler = CallSampler(lambda q, lkv, tables, lengths, cfg, dtype: (
            q.cpu(), {k: v.cpu() for k, v in lkv.items()}, tables.cpu(), lengths.cpu(), cfg),
            every=SERVE_MESH_K2_EVERY, keep=3)
        real_attn = serving._paged_attn_call
        serving._paged_attn_call = sampler.wrap(real_attn)
    ke = None
    if run.get("sample_ke") and mesh is not None:
        from elastic_gpu_scheduler_tpu_torch.models import quantize

        # the weights are the engine's own, never overwritten
        ke = CallSampler(lambda x, w, ids, scale=None, out_dtype=None: (
            x.clone(), w, None if ids is None else ids.clone(), scale, out_dtype),
            every=SERVE_MESH_KE_EVERY)
        real_ke = {m: m.expert_matmul for m in (serving, quantize)}
        for m, fn in real_ke.items():
            m.expert_matmul = ke.wrap(fn)
    for n in calls:
        setattr(serving, n, counted(n))
    torch.cuda.synchronize(dev)
    # the main path: counts at 0 just before, read just after
    _build.reset_launches()
    t0 = time.perf_counter()
    reqs = []
    try:
        if eng.leader:
            for wave in run["waves"]:
                reqs += [eng.submit(Request(prompt=list(p), max_new_tokens=run["new"]))
                         for p in wave]
                eng.run_until_idle(max_steps=100_000)
            eng.stop_followers()
        else:
            eng.follow()
        torch.cuda.synchronize(dev)
    finally:
        for n in calls:
            setattr(serving, n, real[n])
        if sampler is not None:
            serving._paged_attn_call = real_attn
        if ke is not None:
            for m, fn in real_ke.items():
                m.expert_matmul = fn
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    L = cfg.n_layers
    passes = sum(calls.values())
    want = dict.fromkeys(launches, 0)
    k2 = "paged_attention_int8" if eng.kv_int8 else "paged_attention"
    if run.get("captured"):  # graph replays: the engine's counters
        want.update({"flash_fwd": L * eng.prefills_run,
                     k2: L * eng.fused_steps * (eng.steps_run + eng.graph_warmups)})
    else:
        want.update({"flash_fwd": L * calls["_paged_prefill"],
                     "flash_block_stats": L * calls["_paged_prefill_prefixed"],
                     k2: L * (calls["_paged_decode_step"] + calls["_fused_verify_chunk"])})
        if cfg.n_experts:
            want["expert_matmul"] = 3 * L * passes
        elif run.get("int8"):
            want["expert_matmul"] = (7 * L + 1) * passes
    want = {k: v for k, v in want.items() if v or k in launches}
    out = {"launches": launches, "want": want, "calls": calls, "wall_s": wall,
           "log": log_, "resident_gb": resident,
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "counters": {c: int(getattr(eng, c)) for c in (
               "prefills_run", "steps_run", "spec_passes", "spec_accepted",
               "prefix_admission_hits", "graphs_captured", "graph_replays", "graph_warmups",
               "tickets")}}
    if ke is not None:
        out["ke"] = ke_samples_check(ke.calls)
    if eng.leader:
        for r in reqs:
            check(r.done.is_set() and not r.error, f"{run['name']}: request failed: {r.error!r}")
        out["tokens"] = [r.output for r in reqs]
        out["generated"] = sum(len(r.output) for r in reqs)
        if first:
            out["first_logits"] = first[0].numpy()
        if prefill_logits:
            out["prefill_logits"] = torch.stack(prefill_logits).numpy()
        if sampler is not None:
            # as bytes: a tensor on the result queue travels by a file
            # descriptor that dies with this process
            import io

            buf = io.BytesIO()
            torch.save(sampler.calls, buf)
            out["k2_calls"] = buf.getvalue()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ke_samples_check(calls) -> dict:
    """KE calls a serving rank's main path made (sampled), each run again
    through the kernel and held to ``expert_matmul_reference``: within
    ``ke_within``, and a zero row for every token whose local id lies
    outside [0, E) (routed to another rank's experts).  The output block
    is filled with NaNs first, so a row the kernel left unwritten shows."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.ops.expert_matmul import (
        expert_matmul,
        expert_matmul_reference,
    )

    res = {"samples": len(calls), "max_abs_err": 0.0, "within": bool(calls),
           "foreign_rows": 0, "foreign_nonzero": 0, "shapes": []}
    for x, w, ids, scale, out_dtype in calls:
        T, N = x.shape[0], w.shape[-1]
        torch.full((T, N), float("nan"), dtype=out_dtype or x.dtype, device=x.device)
        got = expert_matmul(x, w, ids, scale=scale, out_dtype=out_dtype)
        want = expert_matmul_reference(x, w, ids, scale, out_dtype)
        res["max_abs_err"] = max(res["max_abs_err"], maxerr(got, want))
        res["within"] &= ke_within(got, want)
        if ids is not None:
            foreign = (ids < 0) | (ids >= w.shape[0])
            res["foreign_rows"] += int(foreign.sum())
            res["foreign_nonzero"] += int((got[foreign] != 0).any(dim=-1).sum())
        res["shapes"].append([T, w.shape[0], w.shape[1], N, str(w.dtype).split(".")[-1]])
    torch.cuda.synchronize()
    return res


# (f): the disaggregated verbs on tensor=2, on (b)'s float32 flagship at L 4
# with the prefix cache, on phase 6j's engine shape (prefix cache, chunked
# prefill of 128, page 16, 16 fused steps, sequential), over a float32 and
# an int8 pool; against one device in this process.  Its timings are the
# median and range of DISAGG_MESH_REPEATS fresh 900-token prompts after one
# warm-up; its migrated streams generate DISAGG_MESH_MIG_NEW tokens.
DISAGG_MESH_ENGINE = dict(prefix_cache=True, prefill_chunk=128, paged_kernel=True,
                          max_batch=8, max_len=1024, page_size=16, fused_steps=16)
DISAGG_MESH_REPEATS = 3
DISAGG_MESH_MIG_NEW = 48


def disagg_mesh_prompts(vocab: int) -> dict:
    """(f)'s prompts: P a 256-token prefix and a 900-token prompt that
    tensor=2 exports and one device adopts, Q the same shapes the other
    way, R 900-token prompts for the timed splits (the first a warm-up), M
    two streams to migrate (one each way)."""
    rng = np.random.default_rng(19)

    def fresh(n):
        return rng.integers(0, vocab, n).tolist()

    big = WAVE1_LENS[2]
    return {"P": [fresh(SHARED_PREFIX), fresh(big)], "Q": [fresh(SHARED_PREFIX), fresh(big)],
            "R": [fresh(big) for _ in range(1 + DISAGG_MESH_REPEATS)],
            "M": [fresh(128), fresh(128)]}


def disagg_mesh_engine(dev, run, mesh=None):
    import torch

    from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine
    from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig, init_params

    cfg = TransformerConfig(**run["cfg"])
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    return InferenceEngine(params, cfg, device=dev, mesh=mesh, **dict(run["engine"],
                                                                      overlap=False))


@contextlib.contextmanager
def prefill_passes():
    """The serving prefill passes by kind while the block runs: plain (K1)
    and prefixed (K3), in the dict it yields."""
    from elastic_gpu_scheduler_tpu_torch.models import serving

    passes = {"plain": 0, "prefixed": 0}
    real = (serving._paged_prefill, serving._paged_prefill_prefixed)

    def counted(fn, kind):
        def call(*args, **kw):
            passes[kind] += 1
            return fn(*args, **kw)
        return call

    serving._paged_prefill = counted(real[0], "plain")
    serving._paged_prefill_prefixed = counted(real[1], "prefixed")
    try:
        yield passes
    finally:
        serving._paged_prefill, serving._paged_prefill_prefixed = real


def disagg_greedy(eng, prompt, new):
    """One greedy request through ``eng``: its tokens."""
    from elastic_gpu_scheduler_tpu_torch.models.serving import Request

    req = eng.submit(Request(prompt=list(prompt), max_new_tokens=new))
    eng.run_until_idle(max_steps=100_000)
    check(req.done.is_set() and not req.error, f"(f): a request failed: {req.error!r}")
    return req.output


def disagg_mesh_inputs(dev, run, work: str) -> dict:
    """(f)'s one-device side before the spawn: every prompt's cold greedy
    tokens; the bundles of Q and of R (each R primed as /v1/prefill
    primes, its prefill and export timed); R's bundles imported into a
    fresh engine (timed); a stream of M detached after one chunk.  The
    bundles the ranks read are files under ``work``; returns the
    readings."""
    import torch

    pr = disagg_mesh_prompts(run["cfg"]["vocab_size"])
    new = run["new"]
    out = {"prompts": pr, "files": {}}
    with torch.inference_mode():
        eng = disagg_mesh_engine(dev, run)
        out["cold"] = {k: [disagg_greedy(eng, p, new) for p in pr[k]] for k in ("P", "Q")}
        out["cold"]["M"] = [disagg_greedy(eng, p, DISAGG_MESH_MIG_NEW) for p in pr["M"]]
        out["files"]["Q"] = [os.path.join(work, f"q{i}.bundle") for i in range(2)]
        for p, path in zip(pr["Q"], out["files"]["Q"]):
            with open(path, "wb") as f:
                f.write(eng.export_prefix_pages(p))
        exports, prefill_ms, out["files"]["R"] = [], [], []
        timed_calls(eng, "_export", dev, exports)
        for i, p in enumerate(pr["R"]):
            t0 = time.perf_counter()
            disagg_greedy(eng, p, 1)
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
            data = eng.export_prefix_pages(p)
            out["files"]["R"].append(os.path.join(work, f"r{i}.bundle"))
            with open(out["files"]["R"][-1], "wb") as f:
                f.write(data)
        out["prefill_ms"] = prefill_ms
        out["export_ms"] = [ms for ms, _ in exports]
        out["bundle_bytes"] = [len(b) for _, b in exports]
        from elastic_gpu_scheduler_tpu_torch.utils import kvwire

        del eng
        imp, imports = disagg_mesh_engine(dev, run), []
        timed_calls(imp, "_import", dev, imports)
        for path in out["files"]["R"]:
            with open(path, "rb") as f:
                imp.import_pages(*kvwire.decode_bundle(f.read()))
        out["import_ms"] = [ms for ms, _ in imports]
        del imp
        from elastic_gpu_scheduler_tpu_torch.models.serving import Request

        src = disagg_mesh_engine(dev, run)
        src.submit(Request(prompt=list(pr["M"][1]), max_new_tokens=DISAGG_MESH_MIG_NEW))
        src._admit()
        src.step()
        lost = src.chunks_discarded
        out["files"]["M"] = os.path.join(work, "m1.session")
        with open(out["files"]["M"], "wb") as f:
            f.write(src.migrate_out_bundle(0))
        out["source_lost"] = src.chunks_discarded - lost
        del src
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_mesh_disagg(dev, mesh, run) -> dict:
    """(f) on one rank: rank 0 calls every verb (each goes to the ranks in
    a ticket of its own), the others follow, in three segments a stop
    ticket apart: (1) Q's one-device bundles imported and exported again;
    (2) the main path, counts at 0 just before: Q's prompts on the
    imported pages, the passes counted by kind; (3) P primed and exported
    (timed, the 900-token export again REPEATS times), the timed splits
    over R's bundles (import, then the first token), a stream of M
    detached after one chunk, and the one-device stream of M resumed."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.models.serving import Request
    from elastic_gpu_scheduler_tpu_torch.ops import _build
    from elastic_gpu_scheduler_tpu_torch.utils import kvwire

    pr, files, new = run["prompts"], run["files"], run["new"]
    eng = disagg_mesh_engine(dev, run, mesh)
    L = eng.cfg.n_layers
    log_ = []
    emit = eng._emit

    def logged(req, tok, *a, **k):
        log_.append(int(tok))
        emit(req, tok, *a, **k)

    eng._emit = logged
    exports, imports = [], []
    timed_calls(eng, "_export", dev, exports)
    timed_calls(eng, "_import", dev, imports)

    def segment(fn):
        with torch.inference_mode():
            if not eng.leader:
                eng.follow()
                return None
            got = fn()
            eng.stop_followers()
            return got

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    out = {}

    def round_trip():
        same = []
        for p, path in zip(pr["Q"], files["Q"]):
            data = read(path)
            eng.import_pages(*kvwire.decode_bundle(data))
            same.append(eng.export_prefix_pages(p) == data)
        return same

    out["round_trip"] = segment(round_trip)
    base = {n: getattr(eng, n) for n in ("prefix_hit_tokens", "steps_run",
                                         "prefix_admission_hits")}
    sync(dev)
    # the main path: counts at 0 just before, read just after
    _build.reset_launches()
    with prefill_passes() as passes:
        out["adopted"] = segment(lambda: [disagg_greedy(eng, p, new) for p in pr["Q"]])
        sync(dev)
    launches = dict(_build.LAUNCHES)
    chunks = eng.steps_run - base["steps_run"]
    k2 = "paged_attention_int8" if eng.kv_int8 else "paged_attention"
    want = dict.fromkeys(launches, 0)
    want.update({"flash_block_stats": L * passes["prefixed"], k2: L * eng.fused_steps * chunks})
    out.update(launches=launches, want=want, passes=dict(passes), chunks=chunks,
               hit_tokens=eng.prefix_hit_tokens - base["prefix_hit_tokens"],
               hits=eng.prefix_admission_hits - base["prefix_admission_hits"],
               pages_imported=eng.kv_pages_imported)
    exports.clear()
    imports.clear()

    def the_rest():
        got = {"prefill_ms": [], "files": [], "split": []}
        for i, p in enumerate(pr["P"]):  # tensor=2 as the prefill replica
            t0 = time.perf_counter()
            disagg_greedy(eng, p, 1)
            got["prefill_ms"].append((time.perf_counter() - t0) * 1e3)
            path = os.path.join(run["work"], f"p{i}.{mesh.rank}.bundle")
            with open(path, "wb") as f:
                f.write(eng.export_prefix_pages(p))
            got["files"].append(path)
        for _ in range(DISAGG_MESH_REPEATS):
            eng.export_prefix_pages(pr["P"][1])
        for p, path in zip(pr["R"], files["R"]):  # tensor=2 as the decode replica
            t0 = time.perf_counter()
            eng.import_pages(*kvwire.decode_bundle(read(path)))
            disagg_greedy(eng, p, 1)
            got["split"].append((time.perf_counter() - t0) * 1e3)
        req = eng.submit(Request(prompt=list(pr["M"][0]), max_new_tokens=DISAGG_MESH_MIG_NEW))
        eng.exchange_ticket()
        eng.round()
        lost = eng.chunks_discarded
        got["m0"] = os.path.join(run["work"], f"m0.{mesh.rank}.session")
        with open(got["m0"], "wb") as f:
            f.write(eng.migrate_out_bundle(0))
        got["lost"] = eng.chunks_discarded - lost
        got["m0_before"] = len(req.output)
        hdr, pages = kvwire.decode_bundle(read(files["M"]))
        eng.import_pages(hdr, pages)
        resumed = eng.resume_session(hdr["request"])
        eng.run_until_idle(max_steps=100_000)
        check(resumed.done.is_set() and not resumed.error, f"(f): resumed {resumed.error!r}")
        got["m1"] = resumed.output
        return got

    out["rest"] = segment(the_rest)
    out["export_ms"] = [ms for ms, _ in exports]
    out["import_ms"] = [ms for ms, _ in imports]
    out["bundle_bytes"] = [len(b) if b else 0 for _, b in exports]
    out["log"] = log_
    out["digest"] = eng._mirror_digest().hex()
    out["counters"] = {c: int(getattr(eng, c)) for c in (
        "kv_pages_exported", "kv_pages_imported", "kv_exports", "kv_imports",
        "sessions_migrated_out", "sessions_migrated_in", "tickets")}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def disagg_mesh_check(dev, run, ref, per) -> dict:
    """(f) after the spawn: every rank's launches exact on the main path
    (K1 none, K3 L a prefixed pass, K2 L x fused_steps a chunk), its
    emissions, counters and mirror digest rank 0's; Q's round trip the
    same bytes, its adopted tokens one device's cold ones, pages and hits
    the traffic's; tensor=2's P bundles adopted by a fresh one-device
    engine (its launches exact too): one device's cold tokens; M's streams
    migrated each way: their unmigrated tokens, at most one chunk lost.
    Returns the readings beside one device's."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.ops import _build
    from elastic_gpu_scheduler_tpu_torch.utils import kvwire

    name, lead = run["name"], per[0]
    pr, ps, L = ref["prompts"], run["engine"]["page_size"], run["cfg"]["n_layers"]
    n_pages = sum((len(p) - 1) // ps for p in pr["Q"])
    for r, p in enumerate(per):
        check(p["launches"] == p["want"] and p["passes"] == {"plain": 0, "prefixed": 2}
              and p["chunks"] > 0,
              f"{name} rank {r}: launches {p['launches']} (want {p['want']}), passes "
              f"{p['passes']}, chunks {p['chunks']}")
        check(p["log"] == lead["log"] and p["digest"] == lead["digest"]
              and p["counters"] == lead["counters"],
              f"{name}: rank {r}'s mirror parted from rank 0's")
    check(lead["round_trip"] == [True, True],
          f"{name}: a bundle imported into tensor=2 and exported again changed")
    check(lead["adopted"] == ref["cold"]["Q"], f"{name}: tensor=2's tokens over one device's "
                                               "pages differ from one device's cold run")
    check(lead["hits"] == 2 and lead["hit_tokens"] == n_pages * ps,
          f"{name}: tensor=2 hit {lead['hits']} prompts, {lead['hit_tokens']} tokens")
    rest = lead["rest"]
    # one device adopts tensor=2's bundles of P, its launches exact
    with torch.inference_mode():
        eng = disagg_mesh_engine(dev, run)
        sync(dev)
        _build.reset_launches()
        with prefill_passes() as passes:
            for path in rest["files"]:
                with open(path, "rb") as f:
                    eng.import_pages(*kvwire.decode_bundle(f.read()))
            adopted = [disagg_greedy(eng, p, run["new"]) for p in pr["P"]]
            sync(dev)
        launches = dict(_build.LAUNCHES)
        k2 = "paged_attention_int8" if eng.kv_int8 else "paged_attention"
        want = dict.fromkeys(launches, 0)
        want.update({"flash_block_stats": L * passes["prefixed"],
                     k2: L * eng.fused_steps * eng.steps_run})
        p_pages = sum((len(p) - 1) // ps for p in pr["P"])
        check(adopted == ref["cold"]["P"], f"{name}: one device's tokens over tensor=2's pages "
                                           "differ from its cold run")
        check(launches == want and passes == {"plain": 0, "prefixed": 2},
              f"{name}: one device adopting launched {launches} (want {want}), passes {passes}")
        check(eng.kv_pages_imported == p_pages and eng.prefix_hit_tokens == p_pages * ps,
              f"{name}: one device imported {eng.kv_pages_imported} pages, hit "
              f"{eng.prefix_hit_tokens} tokens (the traffic: {p_pages} pages)")
        del eng
        # tensor=2's stream of M resumed on one device
        dst = disagg_mesh_engine(dev, run)
        with open(rest["m0"], "rb") as f:
            hdr, pages = kvwire.decode_bundle(f.read())
        dst.import_pages(hdr, pages)
        moved = dst.resume_session(hdr["request"])
        dst.run_until_idle(max_steps=100_000)
        del dst
    check(moved.output == ref["cold"]["M"][0] and rest["m1"] == ref["cold"]["M"][1],
          f"{name}: a migrated stream's tokens differ from its unmigrated run")
    check(rest["lost"] <= 1 and ref["source_lost"] <= 1, f"{name}: a migration lost "
          f"{rest['lost']} / {ref['source_lost']} chunks")
    gc.collect()
    torch.cuda.empty_cache()
    warm = slice(1, None)  # each series after its warm-up
    res = {
        "pool": "int8" if run["engine"].get("kv_int8") else "float32",
        "layers": L, "round_trip_identical": True, "adopted_equal_cold": True,
        "pages_adopted_tensor2": n_pages, "pages_adopted_one_device": p_pages,
        "bundle_mb_900": lead["bundle_bytes"][1] / 2 ** 20,
        "tensor2_export_ms_900": spread(lead["export_ms"][2:]),
        "one_device_export_ms_900": spread(ref["export_ms"][warm]),
        "tensor2_import_ms_900": spread(lead["import_ms"][1:1 + DISAGG_MESH_REPEATS]),
        "one_device_import_ms_900": spread(ref["import_ms"][warm]),
        "tensor2_prefill_ms": rest["prefill_ms"],
        # one device primes and exports, tensor=2 imports and answers
        "split_first_token_ms_900": spread([a + b + c for a, b, c in zip(
            ref["prefill_ms"][warm], ref["export_ms"][warm], rest["split"][warm])]),
        "tensor2_import_and_first_token_ms_900": spread(rest["split"][warm]),
        "migrated_before": rest["m0_before"], "chunks_lost": [rest["lost"], ref["source_lost"]],
        "one_device_adopting_launches": {k: v for k, v in launches.items() if v},
        "tensor2_launches": {k: v for k, v in lead["launches"].items() if v},
    }
    res["export_ratio"] = (res["tensor2_export_ms_900"]["median"]
                           / res["one_device_export_ms_900"]["median"])
    log(f"serve mesh {name} (tensor=2, L {L}, {res['pool']} pool): a bundle round trip "
        f"identical; Q's {n_pages} pages adopted, tokens = one device's cold run; P's "
        f"{p_pages} tensor=2 pages adopted on one device, tokens = its cold run; migrated "
        f"streams = unmigrated, {res['chunks_lost']} chunks lost; launches exact on both ranks "
        f"{res['tensor2_launches']} and on one device {res['one_device_adopting_launches']}; "
        f"900-token bundle {res['bundle_mb_900']:.2f} MiB: export tensor=2 "
        f"{res['tensor2_export_ms_900']['median']:.2f} ms (range "
        f"{res['tensor2_export_ms_900']['min']:.2f}-{res['tensor2_export_ms_900']['max']:.2f}) "
        f"vs one device {res['one_device_export_ms_900']['median']:.2f} ms "
        f"(x{res['export_ratio']:.2f}); import tensor=2 "
        f"{res['tensor2_import_ms_900']['median']:.2f} ms vs one device "
        f"{res['one_device_import_ms_900']['median']:.2f} ms; split first token (one device "
        f"prefill + export, tensor=2 import + first token) "
        f"{res['split_first_token_ms_900']['median']:.1f} ms (range "
        f"{res['split_first_token_ms_900']['min']:.1f}-"
        f"{res['split_first_token_ms_900']['max']:.1f}, {DISAGG_MESH_REPEATS} runs); "
        f"tensor=2 prefill of P {[round(x, 1) for x in rest['prefill_ms']]} ms")
    return res


def serve_mesh_warm(dev, mesh, run) -> dict:
    """(g) on one rank: the engine (memory-only compile cache) warms its
    ``minimal`` lattice twice in a row (``warmup_engine`` on rank 0: each
    point a tasks-only ticket that every rank runs), then serves four
    prompts.  Each rank records every point it ran with its
    seconds to the end of its device work (the first pass cold, the
    second warm), its mirror digest after each point, and whether the
    pool's pages but the scratch page kept their bytes from before the
    first point to after the last."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.compilecache import CompileCache, warmup_engine
    from elastic_gpu_scheduler_tpu_torch.models.serving import (
        SCRATCH_PAGE,
        InferenceEngine,
        Request,
    )
    from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig, init_params

    cfg = TransformerConfig(**run["cfg"])
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = InferenceEngine(params, cfg, device=dev, mesh=mesh, compile_cache=CompileCache(None),
                          **run["engine"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    seen = {"points": [], "digests": []}
    warm, task = eng._warm, eng._warm_task

    def pages():
        return [v[:, SCRATCH_PAGE + 1:].clone() for _, v in sorted(eng.kv.items())]

    def timed(**point):
        sync(dev)
        t0 = time.perf_counter()
        warm(**point)
        sync(dev)
        flags = "".join(str(int(f)) for f in point["flags"])
        seen["points"].append((f"{point['kind']}:t{point['tpad']}:p{point['width']}:{flags}",
                               time.perf_counter() - t0))

    def task_digest(t):
        if "before" not in seen:
            seen["before"] = pages()
        got = task(t)
        seen["digests"].append(eng._mirror_digest().hex())
        seen["after"] = pages()
        return got

    eng._warm, eng._warm_task = timed, task_digest
    t0 = time.perf_counter()
    out = {}
    with torch.inference_mode():
        if eng.leader:
            out["states"] = [warmup_engine(eng).to_dict() for _ in range(2)]
            reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=run["new"]))
                    for p in run["waves"][0]]
            eng.run_until_idle(max_steps=100_000)
            eng.stop_followers()
            for r in reqs:
                check(r.done.is_set() and not r.error, f"(g): a request failed: {r.error!r}")
            out["tokens"] = [r.output for r in reqs]
        else:
            eng.follow()
    sync(dev)
    out.update(points=seen["points"], digests=seen["digests"], wall_s=time.perf_counter() - t0,
               pages_kept=all(torch.equal(a, b) for a, b in zip(seen["before"], seen["after"])))
    del eng, seen
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_mesh_warm_check(run, ref, per) -> dict:
    """(g) after the spawn: both passes ready with every point built on
    both ranks; every rank ran rank 0's points in its order, twice, its
    digests rank 0's and its pool's pages kept; the tokens after the
    warm-ups one device's (an engine never warmed).  Returns the cold and
    warm point seconds (rank 0's) in summary."""
    name, lead = run["name"], per[0]
    first, second = lead["states"]
    n = first["lattice_size"]
    for st in lead["states"]:
        check(st["state"] == "ready" and st["errors"] == 0 and st["built"] == n > 0
              and st["mesh"] == {"tensor": 2}, f"{name}: a warm-up pass ended {st}")
        check(sorted(st["ranks"]) == ["0", "1"]
              and all(v["built"] == n for v in st["ranks"].values()),
              f"{name}: not every rank ran every point: {st['ranks']}")
    labels = [label for label, _ in lead["points"]]
    check(len(labels) == 2 * n and labels[:n] == labels[n:], f"{name}: rank 0 ran {labels}")
    for r, p in enumerate(per):
        check([label for label, _ in p["points"]] == labels,
              f"{name}: rank {r} ran other points than rank 0")
        check(p["digests"] == lead["digests"] and len(p["digests"]) == 2 * n,
              f"{name}: rank {r}'s mirror parted from rank 0's during the warm-up")
        check(p["pages_kept"], f"{name}: rank {r}'s pool pages changed outside the scratch page")
    check(lead["tokens"] == ref["tokens"],
          f"{name}: tokens after the warm-up differ from one device's unwarmed engine's")
    cold = {label: sec for label, sec in lead["points"][:n]}
    warm = {label: sec for label, sec in lead["points"][n:]}

    def by_kind(secs):
        kinds = {}
        for label, sec in secs.items():
            kinds.setdefault(label.split(":")[0], []).append(sec)
        return {k: {"n": len(v), "sum_s": float(sum(v)), "median_s": float(np.median(v))}
                for k, v in sorted(kinds.items())}

    slowest = sorted(cold, key=cold.get, reverse=True)[:3]
    res = {"lattice_size": n, "layers": run["cfg"]["n_layers"],
           "cold_s": float(sum(cold.values())), "warm_s": float(sum(warm.values())),
           "cold_by_kind": by_kind(cold), "warm_by_kind": by_kind(warm),
           "slowest_cold": [(label, cold[label], warm[label]) for label in slowest],
           "wall_s": [first["wall_s"], second["wall_s"]],
           "library_s_a_rank": {r: v["library_s"] for r, v in first["ranks"].items()},
           "tokens_equal_unwarmed": True, "pages_kept": True}
    log(f"serve mesh {name} (tensor=2, L {res['layers']}, float32): {n} points a pass, run on "
        f"both ranks with equal digests and the pool's pages kept; cold pass "
        f"{res['cold_s']:.2f} s of point time ({first['wall_s']:.2f} s wall), warm pass "
        f"{res['warm_s']:.2f} s ({second['wall_s']:.2f} s wall); by kind cold "
        f"{res['cold_by_kind']}, warm {res['warm_by_kind']}; slowest cold points (cold s, warm "
        f"s) {res['slowest_cold']}; tokens after the warm-ups = one device's unwarmed engine's "
        f"(ranks sharing one card over host-staged gloo: not a scaling figure)")
    return res


def serve_mesh_rank(rank, world, rendezvous, runs, backend):
    """One rank of a phase-16 world (a spawned process): each run on its
    mesh, on this rank's share of the card."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.ops import _build
    from elastic_gpu_scheduler_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
    )
    from elastic_gpu_scheduler_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    torch.backends.cuda.matmul.allow_tf32 = False
    maybe_initialize_distributed(rendezvous, world, rank, backend=backend, local_rank=rank,
                                 local_ranks=world)
    dev = torch.device("cuda", torch.cuda.current_device())
    _build.lib()  # built by the parent before the spawn
    out = {}
    for run in runs:
        t0 = time.perf_counter()
        mesh = make_mesh(MeshSpec(**run["kw"])).connect()
        body = (serve_mesh_disagg if run.get("disagg")
                else serve_mesh_warm if run.get("warm") else serve_mesh_run)
        out[run["name"]] = body(dev, mesh, run)
        print(f"serve mesh rank {rank} {run['name']}: "
              f"{out[run['name']].get('wall_s', time.perf_counter() - t0):.1f} s",
              file=sys.stderr, flush=True)
    return out


def phase_serve_mesh(dev) -> dict:
    """16. Serving on a mesh (see the module docstring): the one-device
    references first, then each world of ranks sharing the card, then
    ``serve --tensor`` over HTTP.  Returns the readings and the K2 row at
    a rank's local heads (``k2_row``)."""
    import shutil
    import tempfile

    res: dict = {"card": card_line(), "runs": {},
                 "note": "ranks sharing one card over host-staged gloo: not a scaling figure"}
    plan = serve_mesh_plan()
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="serve_mesh_")
    try:
        return serve_mesh_worlds(dev, plan, res, work, t_phase)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def serve_mesh_worlds(dev, plan, res, work, t_phase) -> dict:
    """Phase 16's body: the one-device side of every run, each world's
    spawn, the checks; ``work`` holds (f)'s bundles."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.parallel.distributed import spawn_ranks

    refs, by_setup = {}, {}
    t_disagg = 0.0
    for runs in plan.values():
        for run in runs:  # one reference a setup: (c)'s two meshes share one
            if run.get("disagg"):  # (f): its one-device side, its bundles in files
                t0 = time.perf_counter()
                d = os.path.join(work, f"disagg{len(refs)}")
                os.makedirs(d)
                refs[run["name"]] = disagg_mesh_inputs(dev, run, d)
                run.update(prompts=refs[run["name"]]["prompts"],
                           files=refs[run["name"]]["files"], work=d)
                t_disagg += time.perf_counter() - t0
                continue
            key = json.dumps([run[k] for k in ("cfg", "engine", "waves", "new")]
                             + [run.get("int8", False)], sort_keys=True)
            if key not in by_setup:
                by_setup[key] = serve_mesh_run(dev, None, run)
            refs[run["name"]] = by_setup[key]
    del by_setup
    gc.collect()
    torch.cuda.empty_cache()  # the spawned ranks share the card with this process
    out = {}
    for (n, backend), runs in plan.items():
        t0 = time.perf_counter()
        out[n] = spawn_ranks(serve_mesh_rank, n, (runs, backend),
                             rendezvous=f"file://{work}/{backend}{n}", timeout_s=900)
        res[f"spawn_{n}_{backend}_s"] = time.perf_counter() - t0
        log(f"serve mesh: {n} {backend} rank(s) ran {[r['name'] for r in runs]} in "
            f"{res[f'spawn_{n}_{backend}_s']:.1f} s")
    k2_row = None
    res["disagg"] = {}
    for (n, backend), runs in plan.items():
        for run in runs:
            name = run["name"]
            ref, per = refs[name], [out[n][r][name] for r in range(n)]
            lead = per[0]
            if run.get("disagg"):
                t0 = time.perf_counter()
                res["disagg"][name] = disagg_mesh_check(dev, run, ref, per)
                t_disagg += time.perf_counter() - t0
                continue
            if run.get("warm"):
                res["warm"] = serve_mesh_warm_check(run, ref, per)
                continue
            entry = {"axes": run["kw"], "ranks": n, "backend": backend,
                     "layers": run["cfg"]["n_layers"], "dtype": run["cfg"]["dtype"],
                     "wall_s_rank0": lead["wall_s"], "one_device_wall_s": ref["wall_s"],
                     "chunks": lead["counters"]["steps_run"],
                     "wall_ms_per_chunk": lead["wall_s"] / max(1, lead["counters"]["steps_run"])
                     * 1e3,
                     "tokens_per_s_rank0": lead["generated"] / lead["wall_s"],
                     "resident_gb_a_rank": [p["resident_gb"] for p in per],
                     "peak_gb_a_rank": [p["peak_gb"] for p in per],
                     "one_device_peak_gb": ref["peak_gb"],
                     "counters": lead["counters"], "launches_a_rank": [p["launches"] for p in per],
                     "one_device_launches": ref["launches"]}
            firsts = [a[0] == b[0] for a, b in zip(lead["tokens"], ref["tokens"])]
            entry["first_tokens_equal"] = sum(firsts)
            entry["tokens_equal"] = sum(a == b for a, b in zip(lead["tokens"], ref["tokens"]))
            if "first_logits" in lead:
                entry["first_step_max_logit_gap"] = float(np.abs(
                    lead["first_logits"] - ref["first_logits"]).max())
            if "prefill_logits" in lead:
                # each prompt's first-token logits: the largest gap, and one
                # device's margin between its two best tokens
                gap = np.abs(lead["prefill_logits"] - ref["prefill_logits"]).max(axis=1)
                top2 = np.sort(ref["prefill_logits"], axis=1)[:, -2:]
                entry["prefill_max_logit_gap"] = gap.tolist()
                entry["one_device_top2_margin"] = (top2[:, 1] - top2[:, 0]).tolist()
            res["runs"][name] = entry
            log(f"serve mesh {name} on {run['kw']} ({n} {backend} rank(s), L "
                f"{run['cfg']['n_layers']}, {run['cfg']['dtype']}): tokens equal one device's "
                f"{entry['tokens_equal']}/{len(ref['tokens'])}, first tokens "
                f"{entry['first_tokens_equal']}/{len(ref['tokens'])}"
                + (f", first decode step's largest |logit| gap "
                   f"{entry['first_step_max_logit_gap']:.3g}"
                   if "first_step_max_logit_gap" in entry else "")
                + (f"; first-token logits' largest gap a prompt "
                   f"{[round(x, 4) for x in entry['prefill_max_logit_gap']]} against one "
                   f"device's top-2 margins "
                   f"{[round(x, 4) for x in entry['one_device_top2_margin']]}"
                   if "prefill_max_logit_gap" in entry else "")
                + f"; rank 0 {entry['tokens_per_s_rank0']:.1f} tokens/s, "
                f"{entry['wall_ms_per_chunk']:.1f} ms wall a chunk over {entry['chunks']} "
                f"chunks (one device: {ref['wall_s']:.2f} s); peak GB a rank "
                f"{[round(x, 2) for x in entry['peak_gb_a_rank']]} (one device "
                f"{ref['peak_gb']:.2f}); counters {lead['counters']} (ranks sharing one card "
                f"over host-staged gloo: not a scaling figure)")
            for r, p in enumerate(per):
                check(p["launches"] == p["want"], f"{name} rank {r}: launches {p['launches']}, "
                                                  f"want {p['want']}")
                check(p["log"] == lead["log"], f"{name}: rank {r} emitted other tokens")
                check(p["counters"] == lead["counters"] or r == 0,
                      f"{name}: rank {r}'s counters {p['counters']} differ from rank 0's")
            check(min(v for v in lead["want"].values() if v) > 0, f"{name}: no kernel ran")
            if run.get("sample_ke"):
                for r, p in enumerate(per):
                    k = p["ke"]
                    check(k["within"], f"{name} rank {r}: a sampled KE call disagrees with "
                                       f"expert_matmul_reference (max err "
                                       f"{k['max_abs_err']:.3g})")
                    check(k["foreign_nonzero"] == 0,
                          f"{name} rank {r}: KE wrote {k['foreign_nonzero']} non-zero rows "
                          "for tokens routed to another rank's experts")
                    check(not run["cfg"].get("n_experts") or k["foreign_rows"] > 0,
                          f"{name} rank {r}: no sampled KE call held a foreign id")
                entry["ke_samples_a_rank"] = [p["ke"] for p in per]
                log(f"serve mesh {name}: sampled KE calls a rank against "
                    f"expert_matmul_reference (tol {KE_F32_TOL} for a float32 output): "
                    + "; ".join(f"rank {r} {p['ke']['samples']} calls at (T, E, K, N, w) "
                                f"{p['ke']['shapes']}, max err {p['ke']['max_abs_err']:.3g}"
                                + (f", {p['ke']['foreign_rows']} foreign rows all zero"
                                   if run["cfg"].get("n_experts") else "")
                                for r, p in enumerate(per)))
            if run["cfg"]["dtype"] == "float32":
                check(lead["tokens"] == ref["tokens"], f"{name}: tokens differ from one device's")
            else:
                # bf16: the mesh rounds its row-parallel sums once in fp32
                # where one device rounds each bf16 product, so its logits
                # differ by a few ulps, within SERVE_MESH_BF16_ULPS; a first
                # token may differ only where one device's logit for it lies
                # within that limit of its best (a tie bf16 cannot break)
                ties, limits = [], []
                for i, ok in enumerate(firsts):
                    lg = ref["prefill_logits"][i]
                    lim = float(SERVE_MESH_BF16_ULPS * bf16_ulp(float(np.abs(lg).max())))
                    limits.append(lim)
                    check(entry["prefill_max_logit_gap"][i] <= lim,
                          f"{name}: prompt {i}'s first-token logits differ from one device's "
                          f"by {entry['prefill_max_logit_gap'][i]:.4g}, past "
                          f"{SERVE_MESH_BF16_ULPS} bf16 ulps ({lim:.4g})")
                    ours = lead["tokens"][i][0]
                    if not ok:
                        ties.append({"prompt": i, "one_device": ref["tokens"][i][0],
                                     "mesh": ours, "below_best": float(lg.max() - lg[ours])})
                    check(ok or lg.max() - lg[ours] <= lim,
                          f"{name}: prompt {i}'s first token differs from one device's "
                          "beyond a tie")
                entry["prefill_gap_limit"] = limits
                entry["first_token_ties"] = ties
                log(f"serve mesh {name}: first-token logit gaps within "
                    f"{SERVE_MESH_BF16_ULPS} bf16 ulps of one device's (limits "
                    f"{[round(x, 4) for x in limits]}); first tokens that differ, each a "
                    f"tie within that limit of one device's best: {ties}")
            if run.get("captured"):
                check(lead["counters"]["graph_replays"] > 0, f"{name}: no graph replay")
            elif n > 1:
                check(lead["counters"]["graph_replays"] == lead["counters"]["graph_warmups"]
                      == 0, f"{name}: a gloo mesh ran a captured chunk")
            if "k2_calls" in lead:
                import io

                sampler = CallSampler(None, 1)
                calls = torch.load(io.BytesIO(lead.pop("k2_calls")), weights_only=False)
                sampler.calls = [(q.to(dev), {k: v.to(dev) for k, v in lkv.items()},
                                  t.to(dev), ln.to(dev), c) for q, lkv, t, ln, c in calls]
                err = check_verify_samples(sampler.calls, "paged_attention",
                                           f"{name} rank 0", width=1)
                k2_row = kernel_k2(sampler, lead["launches"], err)
                k2_row["path"] = (f"serve on tensor=2, {run['cfg']['dtype']}: a rank's "
                                  f"{run['cfg']['n_heads'] // 2} query / "
                                  f"{run['cfg']['n_kv_heads'] // 2} kv heads")
                del sampler
    gc.collect()
    torch.cuda.empty_cache()
    res["http"] = phase_serve_mesh_http()
    res["phase_s"] = time.perf_counter() - t_phase
    # (f)'s one-device side and checks in this process (its ranks' time is in
    # the 2-rank spawn's, beside the other runs')
    res["disagg_one_device_s"] = t_disagg
    res["k2_row"] = k2_row
    check(k2_row is not None, "(a) bf16 sampled no K2 call on rank 0")
    return res


def healthz_until_ready(sp, timeout: float) -> tuple[float, list]:
    """/healthz polled from the process start until 200: (the seconds to
    ready, the 503 bodies seen on the way)."""
    deadline, seen = time.monotonic() + timeout, []
    while True:
        try:
            code, body = get_json(sp.addr, "/healthz")
        except OSError:
            code, body = None, None
        if code == 200:
            return time.perf_counter() - sp.t0, seen
        if code == 503:
            seen.append(body)
        if sp.proc.poll() is not None:
            fail(f"serve exited with {sp.proc.returncode}:\n{sp.tail()}")
        check(time.monotonic() < deadline, f"serve not ready in {timeout} s:\n{sp.tail()}")
        # a readiness probe's pace (a kubelet's is 1-10 s): polled every
        # 0.1 s, one card run's lattice took 44 s against 23 s at 0.5 s in
        # another (PERF.md)
        time.sleep(WARM_POLL_S)


def first_then_rest_ttft(addr, first, prompts, max_new) -> dict:
    """One streamed completion alone, then each of ``prompts`` streamed one
    at a time: every TTFT, and the first's over the median of the rest."""
    ttft, tokens = [], []
    for p in [first] + list(prompts):
        t0 = time.perf_counter()
        toks, times, errors = sse(addr, "/v1/completions", {"prompt": p, "max_tokens": max_new})
        check(not errors and len(toks) == max_new, f"streamed completion: {errors}")
        ttft.append((times[0] - t0) * 1e3)
        tokens.append(toks)
    return {"first_ttft_ms": ttft[0], "later_ttft_ms": ttft[1:],
            "ratio": ttft[0] / float(np.median(ttft[1:])), "tokens": tokens}


def phase_serve_mesh_http() -> dict:
    """(e) ``serve --init --tensor 2 --dist-backend gloo --warmup lattice``
    (its compile cache a temporary directory holding the library's entry)
    and ``--tensor 1`` (no warm-up) on the same seed.  The mesh replica
    answers /healthz 503 ``{"warming": true}`` before 200, and its
    /v1/stats ``warmup`` shows every point built on both ranks.  Each
    replica streams one completion alone, then 4 one at a time (the first
    TTFT against the median of the rest), then answers the 4 as concurrent
    completions: the same tokens on both; /v1/stats shows the mesh.  Then
    a split on the same seed: ``--tensor 2 --fleet-role prefill
    --prefix-cache`` as P prefills each prompt (/v1/prefill), and
    ``--fleet-role decode --prefix-cache`` as D answers it with
    ``X-KV-Source: P``: ``--tensor 1``'s tokens, every page shipped counted
    on both sides.  SIGTERM drains and all four exit 0."""
    import shutil
    import tempfile

    from elastic_gpu_scheduler_tpu_torch.ops import _build
    from elastic_gpu_scheduler_tpu_torch.utils.kvwire import KV_SOURCE_HEADER

    args = ["--init", "--dtype", "float32", "--paged-kernel", "--max-batch", "4",
            "--max-len", "256", "--page-size", "16", "--fused-steps", "8"]
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, 32000, n).tolist() for n in (24, 64, 100, 7)]
    alone = rng.integers(0, 32000, 48).tolist()
    work = tempfile.mkdtemp(prefix="serve_tensor_")
    # the mesh replica's compile cache: a directory of its own that holds
    # the library this run built, so the ranks load it (no nvcc) and the
    # warm-up is the lattice
    cache_dir = os.path.join(work, "cache")
    os.makedirs(cache_dir)
    entry = _build.library_key() + ".aotx"
    shutil.copy(_build.library_cache().path(_build.library_key(), ".aotx"),
                os.path.join(cache_dir, entry))
    gloo = ["--dist-backend", "gloo"]
    warm = ["--warmup", "lattice", "--compile-cache-dir", cache_dir]
    roles = {"P": args + ["--prefix-cache", "--tensor", "2", *gloo, "--fleet-role", "prefill"],
             "D": args + ["--prefix-cache", "--fleet-role", "decode"]}
    procs = {t: ServeProcess(args + ["--tensor", str(t)] + (gloo + warm if t > 1 else []),
                             os.path.join(work, f"tensor{t}.log")) for t in (1, 2)}
    procs.update({r: ServeProcess(a, os.path.join(work, f"{r}.log")) for r, a in roles.items()})
    out = {}
    try:
        for t in (1, 2):
            sp = procs[t]
            ready, warming = healthz_until_ready(sp, 300)
            code, at_ready = get_json(sp.addr, "/v1/stats")
            check(code == 200, f"--tensor {t}: /v1/stats {code}")
            ttft = first_then_rest_ttft(sp.addr, alone, prompts, 16)
            toks, wall = http_completions(sp.addr, prompts, 16)
            code, stats = get_json(sp.addr, "/v1/stats")
            check(code == 200, f"--tensor {t}: /v1/stats {code}")
            out[t] = {"ready_s": ready, "tokens": toks, "wall_s": wall, "mesh": stats["mesh"],
                      "warming": warming, "warmup": at_ready["warmup"], "ttft": ttft}
        P, D = procs["P"], procs["D"]
        split = {"ready_s": {"P": P.wait_ready(300), "D": D.wait_ready(300)}, "tokens": []}
        source = {KV_SOURCE_HEADER: "%s:%d" % P.addr}
        t0 = time.perf_counter()
        for p in prompts:
            code, _, data = post_json(P.addr, {"prompt": p}, path="/v1/prefill")
            check(code == 200, f"P's /v1/prefill answered {code}: {data[:200]!r}")
            code, _, data = post_json(D.addr, {"prompt": p, "max_tokens": 16}, headers=source)
            check(code == 200, f"D's completion answered {code}: {data[:200]!r}")
            split["tokens"].append(json.loads(data)["tokens"])
        split["wall_s"] = time.perf_counter() - t0
        split["P"], split["D"] = (get_json(sp.addr, "/v1/stats")[1] for sp in (P, D))
        codes = {t: sp.stop() for t, sp in procs.items()}
        tails = {t: sp.tail() for t, sp in procs.items()}
    finally:
        for sp in procs.values():
            if sp.proc.poll() is None:
                sp.proc.kill()
                sp.proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    wu = out[2]["warmup"]
    res = {"tokens_equal": out[1]["tokens"] == out[2]["tokens"], "exit_codes": codes,
           "ready_s": {t: o["ready_s"] for t, o in out.items()},
           "wall_s": {t: o["wall_s"] for t, o in out.items()}, "mesh": out[2]["mesh"],
           "streamed_tokens_equal": out[1]["ttft"]["tokens"] == out[2]["ttft"]["tokens"],
           "warming_503s": len(out[2]["warming"]),
           "warmup": {k: wu[k] for k in ("state", "lattice_size", "built", "errors", "wall_s",
                                         "library_s", "slowest", "mesh", "ranks", "loads",
                                         "fills")},
           "first_ttft_ms": {t: o["ttft"]["first_ttft_ms"] for t, o in out.items()},
           "later_ttft_ms": {t: o["ttft"]["later_ttft_ms"] for t, o in out.items()},
           "first_over_median_ttft": {t: o["ttft"]["ratio"] for t, o in out.items()}}
    log(f"serve mesh (e): serve --init --tensor 2 --dist-backend gloo --warmup lattice against "
        f"--tensor 1 (no warm-up): 4 completions equal {res['tokens_equal']} (streamed one at "
        f"a time too: {res['streamed_tokens_equal']}), ready in {res['ready_s']} s after "
        f"{res['warming_503s']} warming 503s, warm-up {wu['state']}: {wu['built']}/"
        f"{wu['lattice_size']} points on ranks {wu['ranks']} in {wu['wall_s']:.2f} s "
        f"(library {wu['library_s']:.2f} s: {wu['fills']} built, {wu['loads']} loaded; slowest "
        f"{wu['slowest']}); first TTFT {res['first_ttft_ms']} ms against the median of the 4 "
        f"after it {dict((t, float(np.median(v))) for t, v in res['later_ttft_ms'].items())} "
        f"ms: first / median {res['first_over_median_ttft']}; wall {res['wall_s']} s, mesh "
        f"{res['mesh']}, exit codes {codes}")
    check(res["tokens_equal"] and res["streamed_tokens_equal"],
          f"serve --tensor 2 answered other tokens than --tensor 1: "
          f"{out[1]['tokens']} vs {out[2]['tokens']}")
    check(res["mesh"] == {"shape": {"tensor": 2}, "ranks": 2}, "serve --tensor 2: no mesh")
    check(out[2]["warming"] and all(b.get("warming") is True for b in out[2]["warming"]),
          f"serve --tensor 2 --warmup lattice answered no 503 warming before 200: "
          f"{out[2]['warming'][:3]}")
    check(wu["state"] == "ready" and wu["lattice_size"] > 0 and wu["errors"] == 0
          and wu["built"] == wu["lattice_size"] and wu["mesh"] == {"tensor": 2}
          and sorted(wu["ranks"]) == ["0", "1"]
          and all(v["built"] == wu["lattice_size"] for v in wu["ranks"].values()),
          f"serve --tensor 2's warm-up: {wu}")
    check((wu["fills"], wu["loads"]) == (0, 1), f"serve --tensor 2 built the library: {wu}")
    pages = sum((len(p) - 1) // 16 for p in prompts)
    kv_p, kv_d = split["P"]["kv"], split["D"]["kv"]
    res["split"] = {"tokens_equal": split["tokens"] == out[1]["tokens"], "pages": pages,
                    "ready_s": split["ready_s"], "wall_s": split["wall_s"],
                    "p_mesh": split["P"]["mesh"], "p_role": split["P"]["role"],
                    "p_pages_exported": kv_p["pages_exported"],
                    "d_role": split["D"]["role"], "d_pages_imported": kv_d["pages_imported"],
                    "d_prefix_hits": kv_d["prefix_hits"]}
    log(f"serve mesh (e) split: P = serve --tensor 2 --fleet-role prefill, D = --fleet-role "
        f"decode, 4 prompts through P's /v1/prefill then D with X-KV-Source: P: tokens equal "
        f"--tensor 1's {res['split']['tokens_equal']}, pages exported by P "
        f"{kv_p['pages_exported']}, imported by D {kv_d['pages_imported']} (the prompts hold "
        f"{pages}), D's prefix hits {kv_d['prefix_hits']}, wall {split['wall_s']:.2f} s")
    check(res["split"]["tokens_equal"], f"the split answered other tokens than --tensor 1: "
                                        f"{split['tokens']} vs {out[1]['tokens']}")
    check(split["P"]["mesh"] == {"shape": {"tensor": 2}, "ranks": 2}
          and split["P"]["role"] == "prefill" and split["D"]["role"] == "decode",
          f"the split's replicas: P {split['P']['mesh']} {split['P']['role']}, D "
          f"{split['D']['role']}")
    check(kv_p["pages_exported"] == kv_d["pages_imported"] == pages,
          f"the split shipped {kv_p['pages_exported']} pages and D imported "
          f"{kv_d['pages_imported']}, not the prompts' {pages}")
    check(all(c == 0 for c in codes.values()), f"serve exit codes {codes}:\n{tails}")
    return res


# the flagship's widths, float32 (the replicas' tokens are compared), on
# phase 6's engine shape: 7 table-view buckets, 8 prefill pad lengths;
# depth cut for time, as phase 16's (b)-(d) (PERF.md §6 has the figures at L 16)
WARM_LAYERS = 4
WARM_ARGS = ["--init", "--dtype", "float32", "--vocab-size", str(FULL["vocab_size"]),
             "--d-model", str(FULL["d_model"]), "--n-layers", str(WARM_LAYERS),
             "--n-heads", str(FULL["n_heads"]), "--n-kv-heads", str(FULL["n_kv_heads"]),
             "--d-ff", str(FULL["d_ff"]), "--paged-kernel",
             "--max-batch", str(ENGINE["max_batch"]), "--max-len", str(ENGINE["max_len"]),
             "--page-size", str(ENGINE["page_size"]), "--fused-steps", str(ENGINE["fused_steps"])]
WARM_NEW = 32
WARM_POLL_S = 0.5


def warm_bodies() -> tuple[list, list]:
    """8 completions over the ``minimal`` variants (3 greedy, 3 sampled, 2
    top-k / top-p sampled, none seeded) and 2 seeded sampled ones."""
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, FULL["vocab_size"], n).tolist()
               for n in (64, 200, 96, 400, 70, 128, 256, 33, 150, 300)]
    sampled = {"temperature": 0.8}
    filtered = {"temperature": 0.8, "top_k": 40, "top_p": 0.9}
    kinds = [{}, {}, sampled, filtered, {}, sampled, filtered, sampled]
    bodies = [dict(prompt=p, max_tokens=WARM_NEW, **k) for p, k in zip(prompts, kinds)]
    seeded = [dict(prompt=p, max_tokens=WARM_NEW, temperature=0.8, seed=1234 + i)
              for i, p in enumerate(prompts[8:])]
    return bodies, seeded


def warm_start_run(sp, bodies, seeded) -> dict:
    """One replica: /healthz polled from the process start to 200 (the
    503 bodies seen), /v1/stats at ready; the first completion streamed
    (TTFT and time to its second token), the other 7 one at a time, then
    the seeded 2, /v1/stats after each group."""
    ready_s, warming = healthz_until_ready(sp, 400)
    _, at_ready = get_json(sp.addr, "/v1/stats")
    t0 = time.perf_counter()
    first, times, errors = sse(sp.addr, "/v1/completions", bodies[0])
    check(not errors and len(first) == WARM_NEW, f"first completion: {errors}")
    tokens = [first]
    for b in bodies[1:]:
        code, _, data = post_json(sp.addr, b)
        check(code == 200, f"completion: HTTP {code} {data[:200]!r}")
        tokens.append(json.loads(data)["tokens"])
    _, after = get_json(sp.addr, "/v1/stats")
    seeded_tokens = []
    for b in seeded:
        code, _, data = post_json(sp.addr, b)
        check(code == 200, f"seeded completion: HTTP {code} {data[:200]!r}")
        seeded_tokens.append(json.loads(data)["tokens"])
    _, after_seeded = get_json(sp.addr, "/v1/stats")
    keys = ("compile_cache", "graphs_captured", "graph_replays", "kernel_launches",
            "prefills_run")
    return {"ready_s": ready_s, "warming_503s": len(warming),
            "warming_body": warming[0] if warming else None,
            "at_ready": {k: at_ready[k] for k in ("warmup", *keys)},
            "after": {k: after[k] for k in keys},
            "after_seeded": {k: after_seeded[k] for k in keys},
            "first_ttft_ms": (times[0] - t0) * 1e3, "first_second_token_ms": (times[1] - t0) * 1e3,
            "first_e2e_ms": (times[-1] - t0) * 1e3, "tokens": tokens, "seeded": seeded_tokens}


def start_launcher(cache_dir: str, log_path: str) -> subprocess.Popen:
    """``launcher --compile-cache`` on ``cache_dir``: two local ranks over
    gloo on the card, 2 steps of the default model at B 4, S 64; its
    output in ``log_path`` (.out and .err)."""
    with open(log_path + ".out", "w") as out, open(log_path + ".err", "w") as err:
        return subprocess.Popen(
            [sys.executable, "-m", "elastic_gpu_scheduler_tpu_torch.launcher", "--steps", "2",
             "--batch-size", "4", "--seq-len", "64", "--mesh", "tensor=2", "--dist-backend",
             "gloo", "--compile-cache", cache_dir],
            cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE), stdout=out, stderr=err)


def launcher_caches(proc: subprocess.Popen, cache_dir: str, log_path: str) -> list:
    """The launcher's exit checked, and each rank's cache counters (its
    last line)."""
    try:
        proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(log_path + ".out") as f:
        out = f.read()
    with open(log_path + ".err") as f:
        err = f.read()[-3000:]
    check(proc.returncode == 0, f"launcher --compile-cache exited {proc.returncode}:\n{err}")
    check(out.strip(), f"launcher --compile-cache printed nothing:\n{err}")
    last = out.strip().splitlines()[-1]
    check(last.startswith(f"compile cache {cache_dir}: "),
          f"launcher --compile-cache printed no cache counters: {out[-500:]}")
    return json.loads(last.split(": ", 1)[1])


def wait_for_build(sp, cache_dir: str) -> None:
    """Until the cold start holds (or has held) the directory's build lock."""
    deadline = time.monotonic() + 300
    while not os.path.exists(os.path.join(cache_dir, "build.lock")):
        if sp.proc.poll() is not None:
            fail(f"serve exited with {sp.proc.returncode}:\n{sp.tail()}")
        check(time.monotonic() < deadline, f"the cold start took no build lock:\n{sp.tail()}")
        time.sleep(0.1)


def phase_warm_start() -> dict:
    """17. The warm-start plane: ``serve`` at the flagship's widths (at
    WARM_LAYERS) in float32 on phase 6's engine shape, in its own process
    three times: (a)
    cold on a fresh ``--compile-cache-dir`` (``--warmup auto``: lattice),
    (b) warm on the same directory, (c) ``--warmup off`` with no directory.
    (a) and (b) answer /healthz 503 ``{"warming": true}`` before 200;
    (a) fills the library once, (b) loads it (fills 0, loads 1), and both
    warm every lattice point with no error and capture nothing after ready
    while serving the 8 ``minimal`` completions; every replica's greedy,
    sampled and seeded tokens are equal.  ``launcher --compile-cache`` on
    the same directory starts once the cold start has taken the
    directory's build lock, beside it (its seconds include the launcher's
    host work): each of its two ranks takes the lock after the cold start
    and loads the library (fills 0, loads 1).  Logged: the library's build
    and load seconds, warm-up wall time and captures, where the lattice's
    host time went, the allocator's reserved memory across the lattice,
    and each replica's first TTFT."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="warm_start_")
    cache_dir = os.path.join(work, "cache")
    bodies, seeded = warm_bodies()
    runs = {}
    t_phase = time.perf_counter()
    launcher_log = os.path.join(work, "launcher.log")
    launcher = None
    try:
        for name, args in (("cold", ["--compile-cache-dir", cache_dir]),
                           ("warm", ["--compile-cache-dir", cache_dir]),
                           ("off", ["--warmup", "off"])):
            sp = ServeProcess(WARM_ARGS + args, os.path.join(work, f"{name}.log"))
            try:
                if name == "cold":
                    wait_for_build(sp, cache_dir)
                    launcher = start_launcher(cache_dir, launcher_log)
                runs[name] = warm_start_run(sp, bodies, seeded)
                runs[name]["exit_code"] = sp.stop()
            finally:
                if sp.proc.poll() is None:
                    sp.proc.kill()
                    sp.proc.wait()
        ranks = launcher_caches(launcher, cache_dir, launcher_log)
        from elastic_gpu_scheduler_tpu_torch.ops import _build

        check(os.path.exists(os.path.join(cache_dir, _build.library_key() + ".aotx")),
              f"the library's entry is not in {cache_dir}")
    finally:
        if launcher is not None and launcher.poll() is None:
            launcher.kill()
            launcher.wait()
        shutil.rmtree(work, ignore_errors=True)
    cold, warm, off = runs["cold"], runs["warm"], runs["off"]
    check(len(ranks) == 2 and all(
        (c["fills"], c["loads"], c["misses"]) == (0, 1, 0) for c in ranks),
        f"launcher --compile-cache beside the cold start: {ranks}")
    for name in ("cold", "warm"):
        r = runs[name]
        wu, cc = r["at_ready"]["warmup"], r["at_ready"]["compile_cache"]
        check(r["warming_503s"] > 0 and r["warming_body"].get("warming") is True,
              f"{name}: /healthz never answered 503 warming before 200")
        check(wu["state"] == "ready" and wu["errors"] == 0 and wu["built"] == wu["lattice_size"]
              and wu["lattice_size"] > 0, f"{name}: warm-up {wu}")
        check(wu["captures"] == r["at_ready"]["graphs_captured"] == wu["lattice_size"] - 8,
              f"{name}: {wu['captures']} captures for {wu['lattice_size']} points")
        check(r["after"]["graphs_captured"] == r["at_ready"]["graphs_captured"]
              and r["after"]["graph_replays"] > r["at_ready"]["graph_replays"]
              and r["after"]["compile_cache"]["misses"] == cc["misses"],
              f"{name}: a capture after ready: {r['at_ready']} -> {r['after']}")
        check(r["exit_code"] == 0, f"{name}: serve exit code {r['exit_code']}")
    check((cold["at_ready"]["compile_cache"]["fills"], cold["at_ready"]["compile_cache"]["loads"])
          == (1, 0), f"cold start: {cold['at_ready']['compile_cache']}")
    check((warm["at_ready"]["compile_cache"]["fills"], warm["at_ready"]["compile_cache"]["loads"])
          == (0, 1), f"warm start: {warm['at_ready']['compile_cache']}")
    check(warm["at_ready"]["warmup"]["lattice_size"] == cold["at_ready"]["warmup"]["lattice_size"],
          "the warm start's lattice differs from the cold start's")
    check(off["warming_503s"] == 0 and off["at_ready"]["warmup"] == {"state": "none"}
          and off["exit_code"] == 0, f"--warmup off: {off['at_ready']}")
    greedy = [i for i, b in enumerate(bodies) if "temperature" not in b]
    same = {k: {"greedy": all(runs[k]["tokens"][i] == off["tokens"][i] for i in greedy),
                "sampled": runs[k]["tokens"] == off["tokens"],
                "seeded": runs[k]["seeded"] == off["seeded"]} for k in ("cold", "warm")}
    for k, eq in same.items():
        check(eq["greedy"] and eq["seeded"] and eq["sampled"],
              f"{k} start against --warmup off: tokens equal {eq}")
    res = {"card": card_line(), "args": " ".join(WARM_ARGS), "tokens_equal": same,
           "layers": WARM_LAYERS, "launcher_caches": ranks,
           "phase_s": time.perf_counter() - t_phase}
    for name, r in runs.items():
        wu = r["at_ready"]["warmup"]
        # the main path's K1 launches: the server's counts from ready to the
        # last completion, L a prefill (each completion one prefill)
        k1 = (r["after_seeded"]["kernel_launches"]["flash_fwd"]
              - r["at_ready"]["kernel_launches"]["flash_fwd"])
        pre = r["after_seeded"]["prefills_run"] - r["at_ready"]["prefills_run"]
        check(pre == len(bodies) + len(seeded) and k1 == WARM_LAYERS * pre,
              f"{name}: {k1} K1 launches over {pre} prefills of {len(bodies) + len(seeded)} "
              f"completions at L {WARM_LAYERS}")
        res[name] = {
            "k1_launches": k1, "prefills": pre,
            "ready_s": r["ready_s"], "warming_503s": r["warming_503s"],
            "library_s": wu.get("library_s"), "warmup_wall_s": wu.get("wall_s"),
            "lattice_size": wu.get("lattice_size"), "captures": wu.get("captures"),
            "reserved_gb": (wu.get("reserved_before", 0) / 1e9,
                            wu.get("reserved_after", 0) / 1e9),
            "graphs_captured": (r["at_ready"]["graphs_captured"], r["after"]["graphs_captured"],
                                r["after_seeded"]["graphs_captured"]),
            "compile_cache": r["after_seeded"]["compile_cache"],
            "first_ttft_ms": r["first_ttft_ms"],
            "first_second_token_ms": r["first_second_token_ms"],
            "first_e2e_ms": r["first_e2e_ms"],
            "lattice_host": {k: wu.get(k) for k in ("queue_s", "run_s", "run_cpu_s",
                                                   "process_cpu_s", "scratch_s", "capture_s",
                                                   "slowest")},
        }
    for name in ("cold", "warm"):
        h = res[name]["lattice_host"]
        log(f"warm start, {name} lattice's host time: {res[name]['warmup_wall_s']} s wall "
            f"(library {res[name]['library_s']} s); points waited {h['queue_s']} s for the "
            f"engine thread and ran {h['run_s']} s there on {h['run_cpu_s']} s of its CPU; "
            f"process CPU {h['process_cpu_s']} s; scratch chunks {h['scratch_s']} s, "
            f"captures (with them) {h['capture_s']} s; slowest point {h['slowest']}")
    log(f"warm start: launcher --compile-cache beside the cold start, each rank {ranks}")
    log(f"warm start: library built in {res['cold']['library_s']} s (cold), loaded in "
        f"{res['warm']['library_s']} s (warm); warm-up {res['cold']['warmup_wall_s']} / "
        f"{res['warm']['warmup_wall_s']} s with {res['cold']['captures']} / "
        f"{res['warm']['captures']} captures of {res['cold']['lattice_size']} points; reserved "
        f"GB before/after the lattice {res['cold']['reserved_gb']} / {res['warm']['reserved_gb']}; "
        f"first TTFT {res['cold']['first_ttft_ms']:.1f} / {res['warm']['first_ttft_ms']:.1f} ms "
        f"warmed, {res['off']['first_ttft_ms']:.1f} ms with no warm-up (second token "
        f"{res['warm']['first_second_token_ms']:.1f} vs {res['off']['first_second_token_ms']:.1f}"
        f" ms); graphs at ready / after 8 / after seeded {res['cold']['graphs_captured']} "
        f"{res['warm']['graphs_captured']} {res['off']['graphs_captured']}; ready in "
        f"{res['cold']['ready_s']:.1f} / {res['warm']['ready_s']:.1f} / "
        f"{res['off']['ready_s']:.1f} s; tokens equal {same}; {res['phase_s']:.1f} s")
    return res


# phase 18's tenant: the launcher's model cut to 2 layers (its widths,
# bf16), 2 steps; then allocations of these shares of the card
NODE_TENANT_LAYERS = 2
NODE_TENANT_STEPS = 2
NODE_TENANT_SHARES = (0.6, 0.4)
NODE_TENANT = r"""
import functools, json, sys
import torch
from elastic_gpu_scheduler_tpu_torch import launcher
from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig
from elastic_gpu_scheduler_tpu_torch.ops import _build

layers, steps, shares = json.loads(sys.argv[1])
launcher.TransformerConfig = functools.partial(TransformerConfig, n_layers=layers)
_build.reset_launches()
rc = launcher.main(["--steps", str(steps)])
launches = dict(_build.LAUNCHES)
props = torch.cuda.get_device_properties(0)
torch.cuda.empty_cache()
tries = {}
for share in shares:
    try:
        x = torch.empty(int(share * props.total_memory), dtype=torch.uint8, device="cuda")
        del x
        tries[str(share)] = "allocated"
    except torch.OutOfMemoryError:
        tries[str(share)] = "OutOfMemoryError"
    torch.cuda.empty_cache()
print(json.dumps({"rc": rc, "launches": launches, "uuid": str(props.uuid),
                  "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
                  "total_gb": props.total_memory / 2 ** 30, "tries": tries}))
"""


def _bare_uuid(u: str) -> str:
    u = u.strip().lower()
    return u[4:] if u.startswith("gpu-") else u


def node_plane_grpc(gpus) -> dict:
    """18(5): the plugin served on a unix socket in a temporary directory;
    GetDevicePluginOptions, ListAndWatch (its first response),
    GetPreferredAllocation and Allocate over a channel, each answer held
    to the plain functions'.  None where grpc or protobuf do not import."""
    import shutil
    import tempfile

    try:
        import grpc

        from elastic_gpu_scheduler_tpu_torch.deviceplugin import deviceplugin_pb2 as pb
    except ImportError as e:
        log(f"node plane: the gRPC wiring is not served here ({e}); the CPU tests cover it")
        return None
    from elastic_gpu_scheduler_tpu_torch.deviceplugin.plugin import (
        GPUDevicePlugin,
        allocation_envs,
        preferred_allocation,
    )

    work = tempfile.mkdtemp(prefix="dp")
    plugin = GPUDevicePlugin(gpus=gpus)
    try:
        sock = os.path.join(work, "plugin.sock")
        plugin.serve(sock)
        with grpc.insecure_channel(f"unix://{sock}") as ch:
            def call(method, req, resp):
                return ch.unary_unary(f"/v1beta1.DevicePlugin/{method}",
                                      request_serializer=type(req).SerializeToString,
                                      response_deserializer=resp.FromString)(req, timeout=10)

            opts = call("GetDevicePluginOptions", pb.Empty(), pb.DevicePluginOptions)
            stream = ch.unary_stream("/v1beta1.DevicePlugin/ListAndWatch",
                                     request_serializer=pb.Empty.SerializeToString,
                                     response_deserializer=pb.ListAndWatchResponse.FromString)
            first = next(iter(stream(pb.Empty(), timeout=10)))
            c0 = gpus[0].coord
            avail = [f"{g.coord}/{u}" for g in gpus for u in range(100)]
            pref = call("GetPreferredAllocation", pb.PreferredAllocationRequest(
                container_requests=[pb.ContainerPreferredAllocationRequest(
                    available_device_i_ds=avail, must_include_device_i_ds=[f"{c0}/0"],
                    allocation_size=50)]), pb.PreferredAllocationResponse)
            ids = [f"{c0}/{u}" for u in range(50)]
            alloc = call("Allocate", pb.AllocateRequest(container_requests=[
                pb.ContainerAllocateRequest(devices_i_ds=ids)]), pb.AllocateResponse)
    finally:
        plugin.stop()
        shutil.rmtree(work, ignore_errors=True)
    cresp = alloc.container_responses[0]
    envs, specs = allocation_envs(ids, gpus)
    got = {"options": opts.get_preferred_allocation_available and not opts.pre_start_required,
           "devices": sorted(d.ID for d in first.devices) == sorted(avail)
           and all(d.health == "Healthy" for d in first.devices),
           "preferred": list(pref.container_responses[0].device_i_ds)
           == preferred_allocation(avail, [f"{c0}/0"], 50),
           "allocate_envs": dict(cresp.envs) == envs,
           "allocate_specs": [(d.container_path, d.host_path, d.permissions)
                              for d in cresp.devices] == specs}
    check(all(got.values()), f"node plane: the gRPC answers differ from the plain functions': "
                             f"{got}")
    log(f"node plane: the plugin over gRPC (grpc {grpc.__version__}) on a unix socket: options, "
        f"ListAndWatch's {len(first.devices)} devices, GetPreferredAllocation and Allocate "
        f"equal the plain functions' answers")
    return {"grpc": grpc.__version__, **got}


def phase_node_plane() -> dict:
    """18. The node plane: (1) ``discover_gpus()`` on this host finds the
    cards ``nvidia-smi`` lists (UUIDs equal where its source gave them),
    logging its source; (2) ``allocation_envs`` for 100 and for 50 units
    of card 0; (3) the tenant: one ``python -c`` process under exactly the
    50-unit allocation's env runs ``launcher.main`` for 2 steps of a 2-layer
    bf16 model (K1 and K4 launches L x steps) on the allocated card, then
    fails to allocate 0.6 of the card's memory and allocates 0.4; (4)
    ``probe_relay`` up with the card's name, and down with ``NOT_GPU`` when
    the child's ``CUDA_VISIBLE_DEVICES`` is empty; (5) the plugin over
    gRPC where grpc and protobuf import (``node_plane_grpc``)."""
    import torch

    from elastic_gpu_scheduler_tpu_torch.deviceplugin.plugin import (
        allocation_envs,
        discover_gpus,
        discovery_source,
    )
    from elastic_gpu_scheduler_tpu_torch.utils.tpuprobe import probe_relay

    t_phase = time.perf_counter()
    res: dict = {"card": card_line()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=index,uuid,name", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=True).stdout
    cards = [[f.strip() for f in line.split(",")] for line in smi.strip().splitlines()]
    # (1) discovery
    gpus = discover_gpus()
    source = discovery_source()
    dev_only = discover_gpus(proc_root="/nonexistent", smi="")
    res["discovery"] = {"source": source, "cards": len(gpus), "smi_cards": len(cards),
                        "minors": [g.minor for g in gpus], "coords": [g.coord for g in gpus],
                        "dev_nodes_alone": [g.minor for g in dev_only],
                        "proc_gpus": os.path.isdir("/proc/driver/nvidia/gpus")}
    log(f"node plane: discover_gpus read {source}: {len(gpus)} card(s), minors "
        f"{res['discovery']['minors']}, coordinates {res['discovery']['coords']}; nvidia-smi "
        f"lists {len(cards)}; /proc/driver/nvidia/gpus present "
        f"{res['discovery']['proc_gpus']}; the /dev nodes alone name minors "
        f"{res['discovery']['dev_nodes_alone']}")
    check(len(gpus) == len(cards), f"node plane: discover_gpus found {len(gpus)} cards "
                                   f"({source}), nvidia-smi lists {len(cards)}")
    if source in ("proc", "smi"):
        check(sorted(_bare_uuid(g.uuid) for g in gpus) == sorted(_bare_uuid(c[1]) for c in cards),
              "node plane: discovery's UUIDs differ from nvidia-smi's")
    # (2) Allocate's contract for card 0: the whole card and half of it
    card = gpus[0]
    envs = {units: allocation_envs([f"{card.coord}/{u}" for u in range(units)], gpus)[0]
            for units in (100, 50)}
    res["envs"] = {u: {k: ("<uuid>" if k == "CUDA_VISIBLE_DEVICES" and card.uuid else v)
                       for k, v in e.items()} for u, e in envs.items()}
    log(f"node plane: Allocate's env for 100 / 50 units of card {card.coord}: {res['envs']}")
    for units, e in envs.items():
        check(e["CUDA_VISIBLE_DEVICES"] == (card.uuid or str(card.minor))
              and e["TPU_CORE_PERCENT"] == str(units) and e["TPU_VISIBLE_CHIPS"] == card.coord,
              f"node plane: {units} units' env {e}")
    # (3) the tenant under the 50-unit env, in its own process
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "CUDA_VISIBLE", "XLA_PYTHON"))}
    env.update(envs[50], PYTHONPATH=HERE)
    gc.collect()
    torch.cuda.empty_cache()
    # the tenant's 0.6 must fit in the card's free memory, so that only its
    # share can refuse it
    free, total = torch.cuda.mem_get_info()
    res["free_gb_before_tenant"] = free / 2 ** 30
    check(free > 0.65 * total, f"node plane: {free / 2 ** 30:.1f} GiB free of "
                               f"{total / 2 ** 30:.1f}: too little to tell the share's refusal")
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", NODE_TENANT, json.dumps(
        [NODE_TENANT_LAYERS, NODE_TENANT_STEPS, list(NODE_TENANT_SHARES)])], cwd=HERE, env=env,
        capture_output=True, text=True, timeout=300)
    tenant_s = time.perf_counter() - t0
    check(p.returncode == 0, f"node plane: the tenant exited {p.returncode}:\n{p.stderr[-3000:]}")
    lines = p.stdout.strip().splitlines()
    check(lines and lines[-1].startswith("{"), f"node plane: the tenant printed no result: "
                                                f"{p.stdout[-500:]}")
    tenant = json.loads(lines[-1])
    L, steps = NODE_TENANT_LAYERS, NODE_TENANT_STEPS
    smi_uuid = dict((c[0], c[1]) for c in cards).get("0", "")
    want_uuid = card.uuid or smi_uuid
    res["tenant"] = {"rc": tenant["rc"], "launches": {k: v for k, v in
                                                      tenant["launches"].items() if v},
                     "count": tenant["count"], "same_card": _bare_uuid(tenant["uuid"])
                     == _bare_uuid(want_uuid), "tries": tenant["tries"],
                     "total_gb": tenant["total_gb"], "wall_s": tenant_s,
                     "trained": lines[-2] if len(lines) > 1 else ""}
    log(f"node plane: the tenant under the 50-unit env ({tenant_s:.1f} s): launcher.main "
        f"{steps} steps at L {L}: {res['tenant']['trained']}; launches "
        f"{res['tenant']['launches']}; {tenant['count']} card(s) visible, the allocated one "
        f"{res['tenant']['same_card']}; allocations of {list(NODE_TENANT_SHARES)} of "
        f"{tenant['total_gb']:.1f} GiB: {tenant['tries']}")
    lc = tenant["launches"]
    check(tenant["rc"] == 0 and lc.get("flash_fwd") == L * steps
          and lc.get("flash_bwd_dq") == lc.get("flash_bwd_dkv") == L * steps,
          f"node plane: the tenant's launches {lc} (K1 and K4 want {L * steps})")
    check(tenant["count"] == 1 and res["tenant"]["same_card"],
          f"node plane: the tenant ran on {tenant['count']} card(s), {tenant['uuid']!r}")
    check(tenant["tries"] == {"0.6": "OutOfMemoryError", "0.4": "allocated"},
          f"node plane: the tenant's allocations under its 50% share: {tenant['tries']}")
    # (4) the device probe, up and with the card hidden (two children at once)
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        up, down = pool.map(lambda env: probe_relay(timeout=120, env=env),
                            (None, dict(os.environ, CUDA_VISIBLE_DEVICES="")))
    res["probe"] = {"up": up, "down": [down[0], down[1][-120:]],
                    "s": time.perf_counter() - t0}
    log(f"node plane: probe_relay {up}; with CUDA_VISIBLE_DEVICES='' {res['probe']['down']} "
        f"({res['probe']['s']:.1f} s for both)")
    check(up == (True, torch.cuda.get_device_name(0)), f"node plane: probe_relay {up}")
    check(down[0] is False and "NOT_GPU" in down[1], f"node plane: hidden card probe {down}")
    # (5) the gRPC wiring
    res["grpc"] = node_plane_grpc(gpus)
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def phase_mesh(dev) -> dict:
    """15. Training on a mesh.  (a) ``launcher.run_job`` at phase 9's model
    and batch through a one-rank NCCL process group, against the same job
    on one device with no process group: bitwise.  (b) ranks sharing the
    card over gloo at the flagship's width, depth cut to MESH_LAYERS:
    tensor=2 (K1 / K4 on 8 query / 4 KV heads a rank, the TP loss), seq=2
    with the ring (K3 forward hops, K4 backward hops) and fsdp=2,tensor=2,
    3 steps each against the single-device run within MESH_BF16_TOL; (c)
    the same meshes with a small float32 model within MESH_F32_TOL; (e)
    pipe=2 at the flagship's widths (MESH_PIPE: 2 layers a stage, 4
    microbatches) and (f) expert=2 (MESH_MOE: 8 experts, 4 a rank) within
    MESH_BF16_TOL; (g) the small float32 model on pipe=2,seq=2 (the ring
    inside the stages), pipe=2,tensor=2, data=2,expert=2 and MoE pipelined
    on expert=2,pipe=2, data=2,pipe=2 and fsdp=2,pipe=2 (each held to one
    device's step accumulating the microbatches) within MESH_F32_TOL; (d)
    float32 jobs saved on tensor=2, pipe=2 and expert=2 and resumed on one
    device against the uninterrupted mesh runs within MESH_F32_TOL.  Each rank's launches are held exactly; (b)'s
    seq=2 and (e)'s pipe=2 runs take one more step, rank 0's under
    torch.profiler.  Step ms and peak memory a rank are of ranks sharing
    one card over host-staged gloo: not a scaling figure."""
    import shutil
    import tempfile

    import torch

    from elastic_gpu_scheduler_tpu_torch import launcher
    from elastic_gpu_scheduler_tpu_torch.models.data import SyntheticTokenDataset, batches
    from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig
    from elastic_gpu_scheduler_tpu_torch.parallel.distributed import spawn_ranks
    from elastic_gpu_scheduler_tpu_torch.parallel.mesh import MeshSpec

    res: dict = {"card": card_line(), "steps": MESH_STEPS}
    work = tempfile.mkdtemp(prefix="mesh_")
    gc.collect()
    torch.cuda.empty_cache()
    try:
        # (a) one rank, NCCL, phase 9's model and batch
        job = launcher.JobSpec(model=TransformerConfig(**TRAIN), batch_size=TRAIN_B,
                               seq_len=TRAIN_S, steps=MESH_STEPS)
        t0 = time.perf_counter()
        one = spawn_ranks(mesh_nccl_rank, 1, (job,), rendezvous=f"file://{work}/nccl",
                          timeout_s=600)[0]
        res["nccl_wall_s"] = time.perf_counter() - t0
        single = launcher.run_job(job, device=dev)
        gc.collect()
        torch.cuda.empty_cache()  # the spawned ranks share the card with this process
        want = dict.fromkeys(one["launches"], 0)
        want.update(mesh_want(TRAIN, {}, 0, MESH_STEPS))
        res["nccl"] = {"backend": one["backend"], "world": one["world"],
                       "losses": one["losses"], "single_device_losses": single,
                       "bitwise": one["losses"] == single, "launches": one["launches"]}
        log(f"mesh (a): run_job on a one-rank {one['backend']} process group: losses "
            f"{one['losses']}; on one device with no process group: {single}; launches "
            f"{one['launches']} (want {want})")
        check(one["backend"] == "nccl" and one["world"] == 1, "(a) ran on no NCCL group of one")
        check(one["losses"] == single, "the one-rank NCCL run differs from one device")
        check(one["launches"] == want, "the one-rank run's launches differ from 2L / L a step")

        # (b), (c), (e), (f), (g): the same batch as phase 9 for the flagship
        tokens = next(batches(SyntheticTokenDataset(TRAIN["vocab_size"], seed=0), TRAIN_B,
                              TRAIN_S, seed=1))
        small_tok = next(batches(SyntheticTokenDataset(MESH_SMALL["vocab_size"], seed=4),
                                 MESH_SMALL_B, MESH_SMALL_S, seed=5))

        def small(label, kw, extra, accum=1):
            cfg = dict(MESH_SMALL, **extra)
            return dict(name=f"small {label}", kw=kw, cfg=cfg, opt={}, tokens=small_tok,
                        tol=MESH_F32_TOL, base=(cfg, {}, small_tok, accum))

        def flagship(label, kw, extra, profile=False):
            cfg = dict(dict(TRAIN, n_layers=MESH_LAYERS), **extra)
            return dict(name=label, kw=kw, cfg=cfg, opt=MESH_OPT, tokens=tokens,
                        tol=MESH_BF16_TOL, base=(cfg, MESH_OPT, tokens, 1), profile=profile)

        runs = []
        for label, kw, extra in MESH_GLOO:
            runs.append(small(label, kw, extra))
            runs.append(flagship(label, kw, extra, profile=label == "seq=2 ring"))
        runs.append(flagship("pipe=2", dict(pipe=2), MESH_PIPE, profile=True))
        runs.append(flagship("expert=2", dict(expert=2), MESH_MOE))
        runs += [small(label, kw, extra, accum) for label, kw, extra, accum in MESH_NEW]
        worlds: dict = {}
        for r in runs:
            worlds.setdefault(MeshSpec(**r["kw"]).num_devices, []).append(r)
        resume_dir = os.path.join(work, "resume")
        out = {}
        res["gloo_wall_s"] = {}
        for n, wruns in worlds.items():
            t0 = time.perf_counter()
            out[n] = spawn_ranks(mesh_rank, n, (wruns, resume_dir if n == 2 else ""),
                                 rendezvous=f"file://{work}/gloo{n}", timeout_s=900)
            res["gloo_wall_s"][n] = time.perf_counter() - t0
            log(f"mesh: {n} gloo ranks on one card ran {[r['name'] for r in wruns]} in "
                f"{res['gloo_wall_s'][n]:.1f} s")
        bases: dict = {}
        res["meshes"] = {}
        res["profiles"] = {}
        for r in runs:
            name, kw, cfg_kw = r["name"], r["kw"], r["cfg"]
            key = json.dumps(r["base"][0], sort_keys=True) + str(r["base"][3])
            if key not in bases:
                bases[key] = single_device_losses(dev, *r["base"])
            ref, tol = bases[key], r["tol"]
            members = range(MeshSpec(**kw).num_devices)
            per = [out[len(members)][m][name] for m in members]
            diff = max(abs(a - b) for p in per for a, b in zip(p["losses"], ref))
            entry = {"losses": per[0]["losses"], "single_device_losses": ref,
                     "max_loss_diff": diff, "tol": tol,
                     "step_ms_a_rank": [p["step_ms"] for p in per],
                     "peak_gb_a_rank": [p["peak_gb"] for p in per],
                     "launches_a_rank": [p["launches"] for p in per]}
            res["meshes"][name] = entry
            log(f"mesh {name} ({len(members)} gloo ranks on one card): losses "
                f"{per[0]['losses']} against one device {ref}"
                f"{' (grad_accum %d)' % r['base'][3] if r['base'][3] > 1 else ''}: max diff "
                f"{diff:.3g} (tol {tol}); step ms a rank "
                f"{[[round(x, 1) for x in p['step_ms']] for p in per]}; peak GB a rank "
                f"{[round(p['peak_gb'], 2) for p in per]} (ranks sharing one card over "
                f"host-staged gloo, not a scaling figure)")
            check(all(p["losses"] == per[0]["losses"] for p in per),
                  f"{name}: the ranks report different losses")
            check(diff <= tol, f"{name}: the mesh's losses differ from one device's")
            for m, p in zip(members, per):
                want = dict.fromkeys(p["launches"], 0)
                want.update(mesh_want(cfg_kw, kw, p["seq_index"], MESH_STEPS))
                check(p["launches"] == want, f"{name} rank {m}: launches {p['launches']}, "
                                             f"want {want}")
            if r.get("profile"):
                prof = per[0]["profile"]
                res["profiles"][name] = prof
                log(f"mesh {name} profile (rank 0, one step): wall {prof['wall_ms']:.1f} ms, "
                    f"device busy {prof['device_busy_ms']:.1f} ms (busy share "
                    f"{prof['busy_share']:.3f}); host-staging copies {prof['copy_share']:.3f}, "
                    f"K3 {prof['k3_share']:.3f}, K4 "
                    f"{prof['k4_share']:.3f} (float32 {prof['k4_fp32_share']:.3f}), K1 "
                    f"{prof['k1_share']:.3f} of device time; {prof['launches']} launches")
                for k in prof["top"]:
                    log(f"  {k['ms']:9.3f} ms  x{k['count']:5d}  {k['kernel']}")
                check(prof["device_busy_ms"] > 0, f"{name}: the profiler saw no device time")
        # (d) resumed on one device
        res["resume"] = {}
        for label, _, extra in MESH_RESUME_JOBS:
            whole = out[2][0][f"resume {label}"]
            resumed = launcher.run_job(launcher.JobSpec(
                model=TransformerConfig(**dict(MESH_SMALL, **extra)),
                checkpoint_dir=os.path.join(resume_dir, label), **MESH_RESUME), device=dev)
            diff = max(abs(a - b) for a, b in zip(resumed, whole[2:]))
            res["resume"][label] = {"resumed_on": "one device", "losses_whole": whole,
                                    "losses_resumed": resumed, "max_diff": diff}
            log(f"mesh (d): saved on {label} at step 2, resumed on one device: losses "
                f"{resumed} against the uninterrupted {label} run's {whole[2:]}: max diff "
                f"{diff:.3g} (tol {MESH_F32_TOL})")
            check(len(resumed) == 2 and diff <= MESH_F32_TOL,
                  f"the job saved on {label} and resumed on one device left the "
                  "uninterrupted trajectory")
        ring = res["meshes"]["seq=2 ring"]["launches_a_rank"]
        res["ring_launches"] = {k: sum(r[k] for r in ring)
                                for k in ("flash_block_stats", "flash_bwd_dq", "flash_bwd_dkv")}
    finally:
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    log("mesh: " + json.dumps({k: v for k, v in res.items() if k not in ("meshes", "profiles")}))
    return res


# the ring's hop shape at phase 15's seq=2 mesh: B, H (after repeat_kv),
# S a shard, Dh; float32, as the ring casts
RING_HOP = (TRAIN_B, 16, TRAIN_S // 2, 128)


def kernel_ring_rows(dev) -> list[dict]:
    """K3 and K4 at the ring's hops (float32, 16 heads, a 512-token shard
    of S 1024, Dh 128): the diagonal hop (causal, aligned) and the hop on
    the earlier shard (every key kept), each held to its plain version,
    read as the other rows are; SDPA in float32 as the library call (its
    forward for K3, forward+backward minus forward for K4).  Launches are
    phase 15's seq=2 run's, filled in after it."""
    import torch
    import torch.nn.functional as F

    from elastic_gpu_scheduler_tpu_torch.ops.attention import (
        flash_attention,
        flash_backward,
        flash_backward_reference,
        flash_block_stats,
        flash_block_stats_reference,
        grad_close,
    )

    B, H, S, D = RING_HOP
    g = torch.Generator(device=dev).manual_seed(23)
    q, k, v, do = (torch.randn(B, H, S, D, generator=g, device=dev) for _ in range(4))
    # rank 1's two hops: its own shard (the diagonal) and rank 0's; K3
    # takes both causal at their offsets, as the ring calls it, K4 the
    # diagonal causal and the earlier shard not
    hops = [("diagonal", S, S, True), ("earlier shard", S, 0, False)]
    k3, k4, errs = [], [], {"k3": 0.0, "dq": 0.0, "dkv": 0.0}
    for label, q_off, k_off, causal in hops:
        errs["k3"] = max(errs["k3"], check_k3(q, k, v, q_off, k_off, True, f"ring {label} hop"))
        bound, by = k3_bound_ms(B, H, H, S, S, D, q_off, k_off, True, 4)
        rd = replay_readings(lambda: flash_block_stats(q, k, v, q_off, k_off, True), 5,
                             matches=("flash_stats_kernel",), bound=bound)
        plain = device_ms(lambda: flash_block_stats_reference(q, k, v, q_off, k_off, True), 3)
        lib = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal), 5)
        k3.append((rd, plain, lib, bound, by))
        # K4 on the hop, from the forward's out and lse over this shard
        out, lse = flash_attention(q, k, v, causal, None, 0, return_lse=True)
        got = flash_backward(q, k, v, out, lse, do, causal, None, 0)
        want = flash_backward_reference(q, k, v, out, lse, do, causal, None, 0)
        for nm, a, b in zip(("dq", "dk", "dv"), got, want):
            check(grad_close(a, b), f"K4 {nm} disagrees with its plain version at the ring "
                                    f"{label} hop")
            key = "dq" if nm == "dq" else "dkv"
            errs[key] = max(errs[key], maxerr(a, b))
        del got, want
        k4_bound, k4_by = k4_bound_ms(B, H, S, S, D, causal, 0, 4)
        bwd_rd = replay_readings(lambda: flash_backward(q, k, v, out, lse, do, causal, None, 0),
                                 3, matches=("flash_bwd_dq", "flash_bwd_dkv"),
                                 call_bound=k4_bound)
        plain_bwd = device_ms(lambda: flash_backward_reference(q, k, v, out, lse, do, causal,
                                                               None, 0), 3)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

        def sdpa_fwd_bwd(causal=causal, leaves=leaves):
            o = F.scaled_dot_product_attention(*leaves, is_causal=causal)
            return torch.autograd.grad(o, leaves, do)

        lib_bwd = device_ms(sdpa_fwd_bwd, 3) - device_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal), 5)
        k4.append((bwd_rd, plain_bwd, lib_bwd, k4_bound, k4_by))
        log(f"ring {label} hop (B={B} H={H} S={S} D={D} float32): K3 {rd['ms']['flash_stats_kernel']:.4f} "
            f"ms (plain {plain:.4f}, sdpa {lib:.4f}, bound {bound:.5f} {by}); K4 dq "
            f"{bwd_rd['ms']['flash_bwd_dq']:.4f} + dkv {bwd_rd['ms']['flash_bwd_dkv']:.4f} ms "
            f"(plain {plain_bwd:.4f}, sdpa backward {lib_bwd:.4f}, bound {k4_bound:.5f} {k4_by})")
        del out, lse, leaves

    def mean(rows, i):
        return float(np.mean([r[i] for r in rows]))

    src = "elastic_gpu_scheduler_tpu_torch/csrc/"
    note = ("float32 ring hops at phase 15's seq=2 shard (the mean of the diagonal and the "
            "earlier-shard hop); launches are the seq=2 run's, both ranks, 3 steps")
    rows = [{
        **reading_fields([(1, r[0]) for r in k3], "flash_stats_kernel"),
        "name": "flash_block_stats", "path": "train: ring (seq=2)", "route": "cuda",
        "redesigned": "float32 register micro-tiles (fp32_tile.cuh)",
        "source": src + "flash_stats.cu", "replaces": "elastic_gpu_scheduler_tpu/ops/attention.py:902",
        "launches": 0, "max_abs_err": errs["k3"], "plain_ms": mean(k3, 1),
        "bound_ms": mean(k3, 3), "bound_by": k3[0][4], "library_ms": mean(k3, 2),
        "note": note + "; max_abs_err is on pv / l; library_ms is float32 SDPA, normalised",
    }]
    for which in ("dq", "dkv"):
        share = K4_SHARE[which]
        rows.append({
            **reading_fields([(1, r[0]) for r in k4], f"flash_bwd_{which}",
                             share * mean(k4, 3)),
            "name": f"flash_bwd_{which}", "path": "train: ring hop backward (seq=2)",
            "route": "cuda", "source": src + "flash_bwd.cu",
            "redesigned": "float32 register micro-tiles (fp32_tile.cuh)",
            "replaces": "elastic_gpu_scheduler_tpu/ops/attention.py:633",
            "launches": 0, "max_abs_err": errs[which], "plain_ms": mean(k4, 1),
            "bound_ms": share * mean(k4, 3), "bound_by": k4[0][4], "library_ms": mean(k4, 2),
            "note": note + "; plain_ms and library_ms are the whole hop backward, bound_ms "
                    "this kernel's share of its bound",
        })
    for r in rows:  # each call's bound is its own hop's share
        for c, hop in zip(r["calls"], (k3 if r["name"] == "flash_block_stats" else k4)):
            c["bound_ms"] = hop[3] * (1.0 if r["name"] == "flash_block_stats"
                                      else K4_SHARE[r["name"][len("flash_bwd_"):]])
    del q, k, v, do
    torch.cuda.empty_cache()
    return rows


# the float32 K1 rows' shapes (B, H after repeat_kv, S, Dh), causal: the
# longest prefill of phase 11's engine (TinyLlama's widths, float32 as
# converted: 32 query heads, Dh 64, its 256-token prompt), and of phase 17's
# (the flagship's widths in float32: 16 query heads, Dh 128, its 400-token
# prompt padded to 512)
HF_K1 = (1, TINYLLAMA["num_attention_heads"], max(HF_PROMPT_LENS),
         TINYLLAMA["hidden_size"] // TINYLLAMA["num_attention_heads"])
WARM_K1 = (1, FULL["n_heads"], 512, FULL["d_model"] // FULL["n_heads"])


def kernel_fp32_k1_rows(dev) -> list[dict]:
    """K1's float32 kernel at the shapes of phase 11's and phase 17's
    longest float32 prefills (causal), each held to ``mha_reference``,
    read as the other rows are, with float32 SDPA as the library call.
    Launches are those phases' main paths' (every prompt's prefill),
    filled in after them."""
    import torch
    import torch.nn.functional as F

    from elastic_gpu_scheduler_tpu_torch.ops.attention import flash_attention, mha_reference

    check(prefill_tpad(max(len(b["prompt"]) for b in sum(warm_bodies(), [])),
                       ENGINE["max_len"]) == WARM_K1[2],
          "phase 17's longest prefill is not the float32 K1 row's")
    rows = []
    for (B, H, S, D), path, phase in ((HF_K1, "serve --hf float32 prefill", "11"),
                                      (WARM_K1, "serve --init float32 prefill, flagship widths",
                                       "17")):
        g = torch.Generator(device=dev).manual_seed(29)
        q, k, v = (torch.randn(B, H, S, D, generator=g, device=dev) for _ in range(3))
        out, lse = flash_attention(q, k, v, True, None, 0, return_lse=True)
        ref, ref_lse = mha_reference(q, k, v, True, None, 0)
        err, lse_err = maxerr(out, ref), maxerr(lse, ref_lse)
        check(close(out, ref, "float32") and lse_err <= 1e-4,
              f"K1 float32 disagrees with mha_reference at {(B, H, S, D)} (out {err:.3g}, "
              f"lse {lse_err:.3g})")
        bound, by = k1_bound_ms(B, H, S, S, D, True, 0, 4)
        rd = replay_readings(lambda: flash_attention(q, k, v, True, None, 0), 20, bound=bound)
        plain = device_ms(lambda: mha_reference(q, k, v, True, None, 0), 5)
        lib = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 20)
        log(f"K1 float32 at phase {phase}'s longest prefill (B={B} H={H} S={S} D={D} causal): "
            f"{rd['ms']['']:.5f} ms (profiler {rd['profiler_ms']['']:.5f}; plain {plain:.4f}, "
            f"sdpa {lib:.5f}, bound {bound:.5f} {by}), max|out-ref|={err:.3g} "
            f"max|lse-ref|={lse_err:.3g}")
        rows.append({
            **reading_fields([(1, rd)]),
            "name": "flash_fwd", "path": f"{path} {(B, H, S, D)}, causal", "route": "cuda",
            "dtype": "float32", "source": "elastic_gpu_scheduler_tpu_torch/csrc/flash_fwd.cu",
            "redesigned": "float32 register micro-tiles (fp32_tile.cuh), 32- or 64-row "
                          "query tiles by grid",
            "replaces": "elastic_gpu_scheduler_tpu/ops/attention.py:290",
            "launches": 0, "max_abs_err": err, "plain_ms": plain, "bound_ms": bound,
            "bound_by": by, "library_ms": lib,
            "note": f"float32 kernel (flash_fwd_fp32_tile_kernel) at phase {phase}'s longest "
                    f"prefill; launches are that phase's prefills of every prompt",
        })
        del q, k, v, out, lse, ref, ref_lse
    torch.cuda.empty_cache()
    return rows


# the PR that last rebuilt each kernel's bf16 path for Hopper
REDESIGNED = {"flash_fwd": "PR 4", "flash_bwd_dq": "PR 4", "flash_bwd_dkv": "PR 4",
              "paged_attention": "PR 5", "paged_attention_int8": "PR 5",
              "flash_block_stats": "PR 5"}

# The two readings of a call time the same replay of the same graph, so
# they differ by noise and by what the profiler adds to each kernel it
# traces.  That cost is measured in the run (``profiler_cost``), and a
# call's limit is its kernels' share of it plus three times the sum of the
# two readings' own spreads over their READINGS repeats, or AGREE_FLOOR
# where that is more: on the H100 every call read within 0.028 of its
# replay (K3's calls the most), where that sum came to 0.013-0.037, so the
# floor keeps a call whose spreads happen to be tiny from failing on a
# difference that small (PERF.md §6).
AGREE_FLOOR = 0.05


def profiler_cost() -> dict:
    """What torch.profiler adds to one kernel in a replay: a graph of 200
    one-element additions read both ways (profiled span less the replay's
    time, a kernel's share)."""
    import torch

    t = torch.zeros(1, device="cuda")
    rd = replay_readings(lambda: t.add_(1), 200)
    out = {"ms": abs(rd["profiler_call_ms"] - rd["call_ms"]), "kernel_ms": rd["call_ms"],
           "graph_spread": rd["graph_spread"], "profiler_spread": rd["profiler_spread"],
           "short_windows": rd["short_windows"]}
    log("the profiler's cost a kernel in a replay: " + json.dumps(out))
    return out


def check_readings(kernels: list[dict], cost: dict) -> dict:
    """Fail when either reading of a call puts its kernel below the row's
    bound or the whole call below the call's, or the two disagree beyond
    the call's limit: its kernels x the profiler's cost a kernel over its
    time, plus 3 x (replay spread + profiler spread), at least
    AGREE_FLOOR.  Each call's disagreement and limit go into its row's
    ``calls``."""
    worst, short = None, 0
    for k in kernels:
        what = f"{k['name']} ({k.get('path', '')})"
        for c in k["calls"]:
            d = abs(c["call_ms"] - c["profiler_call_ms"]) / c["call_ms"]
            lim = max(AGREE_FLOOR, c["kernels_a_call"] * cost["ms"] / c["call_ms"]
                      + 3 * (c["graph_spread"] + c["profiler_spread"]))
            c["disagreement"], c["limit"] = d, lim
            short += c["short_windows"]
            check(c["bound_ms"] <= min(c["ms"], c["profiler_ms"]),
                  f"{what} reads below its bound: graph {c['ms']:.5f}, profiler "
                  f"{c['profiler_ms']:.5f}, bound {c['bound_ms']:.5f} ms")
            check(c["call_bound_ms"] <= min(c["call_ms"], c["profiler_call_ms"]),
                  f"{what}: its call reads below the call's bound: graph {c['call_ms']:.5f}, "
                  f"profiler {c['profiler_call_ms']:.5f}, bound {c['call_bound_ms']:.5f} ms")
            check(d <= lim, f"{what}: the readings disagree by {d:.4f} (graph "
                  f"{c['call_ms']:.5f}, profiler {c['profiler_call_ms']:.5f} ms), limit {lim:.4f}")
            if worst is None or d / lim > worst[0]:
                worst = (d / lim, d, lim, what)
    res = {"readings": READINGS, "profiler_cost_ms": cost["ms"], "agree_floor": AGREE_FLOOR,
           "largest_disagreement": max(c["disagreement"] for k in kernels for c in k["calls"]),
           "worst_disagreement_over_limit": worst[0], "worst_disagreement": worst[1],
           "its_limit": worst[2], "worst_row": worst[3], "short_windows": short,
           "calls": sum(len(k["calls"]) for k in kernels)}
    log("kernel readings: " + json.dumps(res))
    return res


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

    # 2. build (the library's compile-cache entry in the package's directory)
    t0 = time.perf_counter()
    _build.lib()
    cache = _build.library_cache()
    log(f"build: kernel library {_build.library_key()} in {cache.cache_dir} in "
        f"{time.perf_counter() - t0:.1f} s (cache {cache.stats()})")
    for line in _build.build_log_path().read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())
    mark("1-2 toolchain, build")

    # 3. to 5. the kernels against their plain versions; KE
    cost = profiler_cost()
    k1_err = phase_k1(dev)
    k2_err = phase_k2(dev)
    k2i_err = phase_k2_int8(dev)
    k3_err = phase_k3(dev)
    k4_err = phase_k4(dev)
    ke_rows = phase_ke(dev)
    # the train-shape and ViT-shape rows early, before the run's many
    # profiler sessions
    train_rows = kernel_train_rows(dev, k4_err)
    vit_rows = kernel_vit_rows(dev)
    ring_rows = kernel_ring_rows(dev)
    fp32_k1_rows = kernel_fp32_k1_rows(dev)
    ke_fp32_row = kernel_ke_fp32_row(dev)
    gc.collect()
    torch.cuda.empty_cache()
    mark("3-5 kernels, train/ViT/ring rows")

    # 6. the engine, 7. HTTP
    eng, prompts, reqs, launches, sampler, perf = phase_engine(dev)
    phase_http(eng, prompts[0])

    # 8. where a fused chunk's time goes; the engine's kernel rows
    phase_profile(eng, prompts)
    kernels = [kernel_k1(eng, prompts, launches, k1_err), kernel_k2(sampler, launches, k2_err)]
    kernels[0]["path"] = kernels[1]["path"] = "serve"
    mark("6-8 engine, HTTP, profile")

    # 6c. the overlapped engine, 6d. speculative decoding, on the same weights
    operf = phase_overlap_engine(dev, eng, prompts, reqs)
    gc.collect()
    torch.cuda.empty_cache()
    sperf, verify_row = phase_spec_engine(dev, eng.params, eng.cfg, prompts, reqs)
    kernels.append(verify_row)
    gc.collect()
    torch.cuda.empty_cache()

    # 6e. per-request controls on the same weights
    cperf = phase_controls_engine(dev, eng.params, eng.cfg, prompts, reqs)
    gc.collect()
    torch.cuda.empty_cache()

    # 6f. multi-LoRA serving on the same weights
    lperf = phase_lora_engine(dev, eng.params, eng.cfg, prompts)
    gc.collect()
    torch.cuda.empty_cache()

    # 6b. the prefix-cached, chunked, int8-KV engine on the same weights
    peng, plaunches, k3_sampler, k2i_sampler, pperf = phase_prefix_engine(
        dev, eng.params, eng.cfg)
    prefix_rows = [kernel_k2(k2i_sampler, plaunches, k2i_err, name="paged_attention_int8"),
                   kernel_k3(k3_sampler, plaunches, k3_err)]
    for r in prefix_rows:
        r["path"] = "serve: prefix cache, prefill_chunk 128, int8 KV"
    kernels += prefix_rows
    mark("6b-6f overlap, spec, controls, LoRA, prefix")
    dense_params, dense_cfg = eng.params, eng.cfg
    del eng, reqs, sampler, peng, k3_sampler, k2i_sampler
    gc.collect()
    torch.cuda.empty_cache()

    # 6j. disaggregated serving on the same weights: a bf16 and an int8 pool
    dperf = {"bf16": phase_disagg(dev, dense_params, dense_cfg, kv_int8=False),
             "int8": phase_disagg(dev, dense_params, dense_cfg, kv_int8=True),
             "small_float32": phase_disagg_small_fp32(dev)}
    mark("6j disagg")

    # 6g. MoE serving at full width, 6h. int8 weights, 6i. small float32
    mperf, moe_launches, moe_params, moe_cfg, moe_reqs = phase_moe_engine(dev, prompts)
    gc.collect()
    torch.cuda.empty_cache()
    iperf, int8_launches, moe_int8_launches = phase_int8_engine(
        dev, dense_params, dense_cfg, prompts, moe_params, moe_cfg, moe_reqs)
    del dense_params, moe_params, moe_reqs, prompts
    gc.collect()
    torch.cuda.empty_cache()
    small_perf = phase_moe_int8_small_fp32(dev)
    ke_row_launches(ke_rows, {"moe": mperf["profile"], "int8": iperf["int8_profile"],
                              "moe_int8": iperf["moe_int8"]["profile"]},
                    {"moe": moe_launches, "int8": int8_launches, "moe_int8": moe_int8_launches})
    kernels += ke_rows
    mark("6g-6i MoE, int8")

    # 9. the training path, card against CPU, the launcher, a profiled step
    cfg, params, state, step, tokens, train_launches, train_perf = phase_train(dev)
    train_prof = phase_train_profile(step, params, state, tokens)
    del cfg, params, state, step, tokens
    gc.collect()
    torch.cuda.empty_cache()
    # 9b. LoRA fine-tuning at the same shape
    lora_train = phase_lora_train(dev, train_perf)
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_cpu_vs_card(dev)
    # 9c. MoE training
    moe_train = phase_moe_train(dev)
    gc.collect()
    torch.cuda.empty_cache()
    launcher_res = phase_launcher(dev)
    mark("9 training, launcher")
    # 7b. the observability plane on the overlapped engine behind HTTP, on
    # the same weights made again; last, so every phase before it opens its
    # profiler windows as early in the process as it did without 7b (a
    # window loses more of its first records the later it opens)
    obs = phase_observability(dev, *full_model(dev))
    mark("7b observability")
    gc.collect()
    torch.cuda.empty_cache()
    # 11, 12. serve --hf and --draft-hf; 13. checkpoint and resume; 14. the
    # ViT (after 7b, whose profiler windows keep their place in the run)
    hf = phase_hf(dev)
    resume = phase_resume(dev)
    vit = phase_vit(dev)
    mark("11-14 hf, resume, ViT")
    # 15. training on a mesh
    mesh = phase_mesh(dev)
    mark("15 training mesh")
    # 16. serving on a mesh
    serve_mesh = phase_serve_mesh(dev)
    kernels.append(serve_mesh.pop("k2_row"))
    mark("16 serving mesh")
    # 17. the warm-start plane: serve cold, warm and without a warm-up
    warm_start = phase_warm_start()
    mark("17 warm start")
    # 18. the node plane: the device plugin, a tenant under its share, the probe
    node_plane = phase_node_plane()
    mark("18 node plane")

    # 10. the kernels line
    for r in train_rows:
        r["launches"] = train_launches[r["name"]]
    for r in vit_rows:
        r["launches"] = vit["launches"][r["name"]]
    for r in ring_rows:
        r["launches"] = mesh["ring_launches"][r["name"]]
    fp32_k1_rows[0]["launches"] = hf["engine_launches"]["flash_fwd"]
    fp32_k1_rows[1]["launches"] = warm_start["warm"]["k1_launches"]
    ke_fp32_row["launches"] = (serve_mesh["runs"]["(c) MoE expert=2"]["one_device_launches"]
                               ["expert_matmul"])
    kernels += train_rows + vit_rows + ring_rows + fp32_k1_rows + [ke_fp32_row]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was not launched on its main path")
        k["of_bound"] = k["bound_ms"] / k["ms"]
        k["vs_library"] = k["ms"] / k["library_ms"] if k["library_ms"] else None
        if k["name"] in REDESIGNED and "redesigned" not in k:
            k["redesigned"] = REDESIGNED[k["name"]]
    readings = check_readings(kernels, cost)
    log(json.dumps({"engine": perf}))
    log(json.dumps({"overlap_engine": operf}))
    log(json.dumps({"spec_engine": sperf}))
    log(json.dumps({"controls_engine": cperf}))
    log(json.dumps({"lora_engine": lperf}))
    log(json.dumps({"prefix_engine": pperf}))
    log(json.dumps({"disagg_engine": dperf}))
    log(json.dumps({"moe_engine": mperf}))
    log(json.dumps({"int8_engine": iperf, "small_float32": small_perf}))
    log(json.dumps({"moe_train": {k: v for k, v in moe_train.items() if k != "profile"},
                    "moe_train_profile_idle_share": moe_train["profile"]["idle_share"]}))
    log(json.dumps({"train": train_perf, "train_profile_idle_share": train_prof["idle_share"],
                    "launcher": launcher_res, "lora_train": lora_train}))
    log(json.dumps({"kernel_readings": readings}))
    log(json.dumps({"observability": obs}))
    log(json.dumps({"hf": hf, "resume": resume, "vit": vit}))
    log(json.dumps({"mesh": mesh}))
    log(json.dumps({"serve_mesh": serve_mesh}))
    log(json.dumps({"warm_start": warm_start}))
    log(json.dumps({"node_plane": node_plane}))
    log(json.dumps({"phase_s": PHASE_S, "total_s": round(sum(PHASE_S.values()), 1)}))
    log(card)
    print(json.dumps({"kernels": kernels}))
    # the one card this script drives (cuda:0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
