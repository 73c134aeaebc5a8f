"""``python -m elastic_gpu_scheduler_tpu_torch.serve`` — the inference
HTTP server around the port's paged serving engine.

Counterpart of ``elastic_gpu_scheduler_tpu/serve.py`` with the flags the
port serves, under the reference's names.  Model sources, one of the two
required:

- ``--hf DIR``: an HF Llama / Mistral checkpoint directory (its
  ``config.json`` and ``*.safetensors``, else ``pytorch_model*.bin``),
  converted by ``models/convert.py`` on the host into a float32 model;
- ``--init``: random weights from the model flags (seed 0).

``--draft-hf DIR`` adds a draft model for speculative decoding (it needs
``--spec-k`` > 0, checked before any weight is read).  ``--int8``
quantizes the base after it is built or imported (weight-only int8,
``models/quantize``).  ``--serve-overlap`` (default ``on``) and
``--spec-k`` (prompt-lookup drafts unless ``--draft-hf``) select the
engine's modes;
``--logprobs-k`` sets the top-k width of per-token logprobs and
``--max-queue`` bounds the admission queue (429 beyond it).
``--fleet-role`` (``TPU_FLEET_ROLE``) and ``--replica-name`` (``POD_NAME``)
place the replica in a disaggregated fleet: a ``prefill`` replica serves
``/v1/prefill`` and ``/v1/kv/export`` for ``decode`` replicas that adopt
its pages (both need ``--prefix-cache``).  The observability plane takes
the reference's knobs: ``--trace-sample`` (``TPU_TRACE_SAMPLE``),
``--profile-sample`` (``TPU_PROFILE_SAMPLE``), ``--workload-class``
(``TPU_WORKLOAD_CLASS``; co-tenants from ``TPU_COTENANT_CLASSES``) and
``--slo-config`` (``TPU_SLO_CONFIG``).  The engine runs on the CUDA
device unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading

log = logging.getLogger("tpu-scheduler")


def build_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="0.0.0.0")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--hf", default="", help="HF checkpoint dir to import")
    src.add_argument("--init", action="store_true",
                     help="random init from the model flags")
    p.add_argument("--vocab-size", type=int, default=32000)
    p.add_argument("--d-model", type=int, default=512)
    p.add_argument("--n-layers", type=int, default=4)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--d-ff", type=int, default=1376)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--int8", action="store_true",
                   help="weight-only int8 quantization after load")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-len", type=int, default=2048)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--n-pages", type=int, default=0,
                   help="KV pool pages (0 = slot-contiguous equivalent)")
    p.add_argument("--fused-steps", type=int, default=16)
    p.add_argument("--paged-kernel", action="store_true",
                   help="decode attention reads the page pool in place "
                        "through the CUDA paged-attention kernel")
    p.add_argument("--kv-int8", action="store_true",
                   help="int8 KV pool with per-(token, kv-head) scales")
    p.add_argument("--prefix-cache", action="store_true",
                   help="keep full prompt pages cached for later prompts "
                        "that share them")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="ingest long prompts this many tokens per engine "
                        "step, between decode chunks (0 = one pass)")
    p.add_argument("--spec-k", type=int, default=0,
                   help=">0 enables speculative decoding (this many draft "
                        "tokens per verify pass; prompt-lookup drafting "
                        "unless --draft-hf)")
    p.add_argument("--draft-hf", default="",
                   help="HF checkpoint dir for a DRAFT model "
                        "(draft-model speculation; requires --spec-k)")
    p.add_argument("--logprobs-k", type=int, default=5,
                   help="top-k width for per-token logprobs (0 disables; "
                        "requests asking more are clamped)")
    p.add_argument("--max-queue", type=int, default=0,
                   help=">0: bound the admission queue; excess requests get "
                        "429 instead of unbounded tail latency")
    p.add_argument("--serve-overlap", choices=["on", "off"], default="on",
                   help="double-buffered decode dispatch: the next fused "
                        "chunk is dispatched off device-resident state (a "
                        "CUDA graph replay) before the previous one's tokens "
                        "drain; 'off' is the exact sequential loop")
    p.add_argument("--fleet-role", choices=["both", "prefill", "decode"], default="",
                   help="disaggregated-serving role (default from TPU_FLEET_ROLE, else "
                        "'both'): 'prefill' replicas prefill long prompts and export "
                        "the pages (/v1/prefill, /v1/kv/export; the fleet router "
                        "keeps them out of completion rotation), 'decode' replicas "
                        "adopt shipped pages and run the token loop, 'both' serves "
                        "everything.  A role other than 'both' needs --prefix-cache")
    p.add_argument("--replica-name", default="",
                   help="fleet identity reported on /v1/stats (default from POD_NAME)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU with the plain PyTorch paths (tests/dev)")
    p.add_argument("--trace-sample", type=float, default=None,
                   help="request-trace sampling rate (1.0 = every request, "
                        "0 = off; default from TPU_TRACE_SAMPLE, else 1.0); "
                        "GET /traces serves the result")
    p.add_argument("--profile-sample", type=float, default=None,
                   help="workload-profile sampling rate (1.0 = every "
                        "engine step, 0.25 = every 4th, 0 = off; default "
                        "from TPU_PROFILE_SAMPLE, else 1.0).  GET "
                        "/debug/profiles and the tpu_workload_* metrics "
                        "serve the result; cost per sampled step is one "
                        "ring-buffer append off the device path")
    p.add_argument("--workload-class", default="",
                   help="profile class this pod's measured behavior "
                        "aggregates under (default from "
                        "TPU_WORKLOAD_CLASS, else the "
                        "elasticgpu.io/workload-class annotation's "
                        "default class).  The scheduler keys interference "
                        "and throughput tables by it")
    p.add_argument("--slo-config", default="",
                   help="replica-side SLO plane: per-class objectives "
                        "as inline JSON or @file (default from "
                        "TPU_SLO_CONFIG).  Enables this pod's own "
                        "request-journey window (vantage=replica) at "
                        "/debug/slo and the queue-wait/TTFT telemetry "
                        "the fleet router folds into the client-"
                        "perceived journey records")
    p.add_argument("--drain-timeout", type=float, default=30.0,
                   help="graceful-drain window on SIGTERM/SIGINT; a second "
                        "signal hard-stops")
    return p.parse_args(argv)


def fleet_role(args) -> str:
    """The flag, else ``TPU_FLEET_ROLE``, else "both".  An invalid role
    from the environment exits (the flag's choices guard only the flag),
    and so does a role other than "both" without the prefix cache: the
    pages a replica ships or adopts are cached prefix pages."""
    role = args.fleet_role or os.environ.get("TPU_FLEET_ROLE", "").strip().lower() or "both"
    if role not in ("both", "prefill", "decode"):
        raise SystemExit(f"TPU_FLEET_ROLE={role!r} invalid (want both|prefill|decode)")
    if role != "both" and not args.prefix_cache:
        raise SystemExit(
            f"--fleet-role {role} requires --prefix-cache (KV pages are cached prefix pages)"
        )
    return role


def device_generation(device) -> str:
    """The profile plane's generation key: the accelerator's kind,
    lowercased with spaces as hyphens (``nvidia-h100-80gb-hbm3``), or
    ``cpu``."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    return torch.cuda.get_device_name(device).lower().replace(" ", "-")


def configure_planes(args, device) -> None:
    """Apply the observability flags: the trace and profile rates, the
    profile identity (pod from ``POD_NAMESPACE`` / ``POD_NAME``, class,
    generation, one chip, co-tenant classes) and the SLO objectives, whose
    class defaults to the workload class.  A bad ``--slo-config`` exits."""
    from .profile import DEFAULT_WORKLOAD_CLASS, PROFILER
    from .slo import SLO, load_config_source
    from .tracing import TRACER

    if args.trace_sample is not None:
        TRACER.configure(args.trace_sample)
    if args.profile_sample is not None:
        PROFILER.configure(sample=args.profile_sample)
    wclass = (args.workload_class or os.environ.get("TPU_WORKLOAD_CLASS", "")
              or DEFAULT_WORKLOAD_CLASS)
    PROFILER.set_identity(
        pod="/".join(p for p in (os.environ.get("POD_NAMESPACE", ""),
                                 os.environ.get("POD_NAME", "")) if p),
        wclass=wclass,
        generation=device_generation(device),
        chips=1,
        neighbors=tuple(c for c in os.environ.get("TPU_COTENANT_CLASSES", "").split(",")
                        if c),
    )
    if args.slo_config:
        try:
            SLO.load_config(load_config_source(args.slo_config))
        except (ValueError, TypeError, OSError) as e:
            raise SystemExit(f"--slo-config: {e}")
    SLO.default_class = wclass


def main(argv=None) -> int:
    args = build_args(argv)
    if args.draft_hf and args.spec_k <= 0:
        # before any weight is read: a wrong flag pair must not cost a
        # checkpoint read first
        raise SystemExit("--draft-hf requires --spec-k > 0")
    role = fleet_role(args)
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s"
    )
    import torch

    from .models.convert import load_hf
    from .models.serving import InferenceEngine
    from .models.transformer import TransformerConfig, init_params, resolve_device
    from .server.inference import drain, serve_inference

    device = resolve_device("cpu" if args.cpu else None)
    configure_planes(args, device)
    if args.hf:
        # converted on the host; the engine moves the params once
        params, cfg = load_hf(args.hf)
    else:
        cfg = TransformerConfig(
            vocab_size=args.vocab_size, d_model=args.d_model, n_layers=args.n_layers,
            n_heads=args.n_heads, d_ff=args.d_ff,
            dtype=args.dtype,
        )
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params = init_params(cfg, gen, device)
    if args.int8:
        from .models.quantize import quantize_params

        params = quantize_params(params)
    draft = load_hf(args.draft_hf) if args.draft_hf else None
    engine = InferenceEngine(
        params, cfg, max_batch=args.max_batch, max_len=args.max_len,
        page_size=args.page_size, n_pages=args.n_pages,
        fused_steps=args.fused_steps, kv_int8=args.kv_int8,
        prefix_cache=args.prefix_cache, paged_kernel=args.paged_kernel,
        prefill_chunk=args.prefill_chunk, spec_k=args.spec_k, draft=draft,
        overlap=args.serve_overlap == "on", logprobs_k=args.logprobs_k,
        max_queue=args.max_queue, device=device,
    )
    engine.replica_name = args.replica_name or os.environ.get("POD_NAME", "")
    engine.fleet_role = role
    server, loop = serve_inference(engine, port=args.port, host=args.host)
    log.info(
        "serving %s model (%d layers, d=%d) on %s, %s:%d",
        "hf-imported" if args.hf else "random-init",
        cfg.n_layers, cfg.d_model, device, args.host, server.server_address[1],
    )
    stop = threading.Event()
    signals_seen = []

    def on_signal(signum, frame):
        signals_seen.append(signum)
        if len(signals_seen) > 1:
            log.info("second signal: hard stop")
            stop.set()
            return
        log.info("signal %d: draining (second signal hard-stops)", signum)

        def _drain():
            ok = drain(loop, timeout=args.drain_timeout)
            log.info("drain %s", "complete" if ok else "timed out")
            stop.set()

        threading.Thread(target=_drain, name="drain", daemon=True).start()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    stop.wait()
    server.shutdown()
    loop.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
