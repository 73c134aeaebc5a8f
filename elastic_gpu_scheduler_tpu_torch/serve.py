"""``python -m elastic_gpu_scheduler_tpu_torch.serve`` — the inference
HTTP server around the port's paged serving engine.

Counterpart of ``elastic_gpu_scheduler_tpu/serve.py`` with the flags the
port serves, under the reference's names.  Model sources, one of the two
required:

- ``--hf DIR``: an HF Llama / Mistral checkpoint directory (its
  ``config.json`` and ``*.safetensors``, else ``pytorch_model*.bin``),
  converted by ``models/convert.py`` on the host into a float32 model;
- ``--init``: random weights from the model flags (seed 0), drawn on the
  host, so every ``--tensor`` serves the same model.

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

The warm-start plane takes the reference's flags: ``--compile-cache-dir``
(``TPU_COMPILE_CACHE_DIR``) puts the kernel library in a CRC-checked
compile-cache entry there (a second start on the directory loads it and
runs no ``nvcc``), and ``--warmup`` walks the engine's shape lattice before
the replica is ready (``compilecache/lattice``: the library, every prefill
shape once, every decode graph captured): ``lattice`` the default traffic's
three sampling variants, ``full`` all 64 control sets, ``auto`` (default)
``lattice`` when a directory is set and ``off`` otherwise.  The HTTP server
comes up first and ``/healthz`` answers 503 ``{"warming": true}`` until
the lattice is warm.  ``--n-kv-heads`` (port-only) gives the random-init
model grouped-query attention.

``--tensor N`` serves tensor-parallel over N local ranks (checkpoints too
big for one card): the weights are built or imported (and quantized) on
the host, cut there into each rank's slice (``sharding.serving_specs``),
and ranks 1..N-1 start as processes of their own (``parallel/distributed
.start_ranks``) that are sent only their slice and follow rank 0's
tickets; this process is rank 0, the HTTP front end.  ``--dist-backend``
picks the transport as the launcher's does (NCCL, one rank a card, by
default on cards; gloo on ``--cpu``, or on cards to let ranks share one).
Fewer cards than N without gloo exits.  Every ``--fleet-role`` serves on
such a mesh: the data-plane routes reach the engine's verbs through rank
0's tickets, and a bundle holds whole heads, as one device's does.
``--warmup`` warms such a mesh too: each lattice point rides a ticket and
runs on every rank (each follower loads the kernel library before it
follows), and ``/healthz`` answers 200 once every rank has run every
point; a point that fails on any rank stops the replica.

Every process of the replica applies the device plugin's allocation
before its first CUDA allocation (``utils/devicecontract``: a fractional
``TPU_CORE_PERCENT`` caps its caching allocator at that share of the card).
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
    p.add_argument("--n-kv-heads", type=int, default=0,
                   help="key/value heads of the --init model (0: --n-heads)")
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
    p.add_argument("--tensor", type=int, default=1,
                   help="serve tensor-parallel over this many local ranks "
                        "(checkpoints bigger than one card's memory); needs "
                        ">= that many cards unless --dist-backend gloo")
    p.add_argument("--dist-backend", default="", choices=["", "nccl", "gloo"],
                   help="collective transport with --tensor: nccl (default on "
                        "cards; one rank a card) or gloo (the CPU; on cards, "
                        "ranks may share one)")
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
    p.add_argument("--compile-cache-dir", default="",
                   help="persistent compile-cache directory (default from "
                        "TPU_COMPILE_CACHE_DIR): the kernel library is a CRC-checked "
                        "entry here, and a later start on the same dir loads it "
                        "instead of running nvcc")
    p.add_argument("--warmup", choices=["auto", "off", "lattice", "full"], default="auto",
                   help="shape-lattice warm-up at start: the kernel library, every "
                        "prefill shape once and every decode-chunk graph captured "
                        "BEFORE /healthz reports ready (503 {warming:true} meanwhile). "
                        "'lattice' = the default-traffic sampling variants, 'full' = "
                        "all 64 control sets, 'auto' = lattice when a compile cache "
                        "dir is set, else off")
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


def configure_planes(args, device, chips: int = 1) -> None:
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
        chips=chips,
        neighbors=tuple(c for c in os.environ.get("TPU_COTENANT_CLASSES", "").split(",")
                        if c),
    )
    if args.slo_config:
        try:
            SLO.load_config(load_config_source(args.slo_config))
        except (ValueError, TypeError, OSError) as e:
            raise SystemExit(f"--slo-config: {e}")
    SLO.default_class = wclass


def start_checks(args) -> str:
    """The flag checks ``main`` makes before any weight is read (a wrong
    flag must not cost a checkpoint read first); exits on a bad one and
    returns the fleet role.  Every role runs on a mesh: ``--tensor N``
    with ``--fleet-role prefill|decode`` ships and adopts whole-head pages
    as one device does."""
    if args.draft_hf and args.spec_k <= 0:
        raise SystemExit("--draft-hf requires --spec-k > 0")
    role = fleet_role(args)
    if args.tensor < 1:
        raise SystemExit(f"--tensor {args.tensor} must be at least 1")
    if args.tensor > 1:
        check_tensor_devices(args)
    return role


def main(argv=None) -> int:
    args = build_args(argv)
    role = start_checks(args)
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s"
    )
    import torch

    from .models.convert import load_hf
    from .models.serving import InferenceEngine
    from .models.transformer import TransformerConfig, init_params, resolve_device
    from .server.inference import drain, serve_inference
    from .utils.devicecontract import apply_allocation

    device = resolve_device("cpu" if args.cpu else None)
    # the device plugin's share of the card, before the first allocation
    apply_allocation(device)
    configure_planes(args, device, chips=args.tensor)
    if args.hf:
        # converted on the host; the engine moves the params once
        params, cfg = load_hf(args.hf)
    else:
        cfg = TransformerConfig(
            vocab_size=args.vocab_size, d_model=args.d_model, n_layers=args.n_layers,
            n_heads=args.n_heads, n_kv_heads=args.n_kv_heads, d_ff=args.d_ff,
            dtype=args.dtype,
        )
        gen = torch.Generator()
        gen.manual_seed(0)
        params = init_params(cfg, gen, "cpu")
    if args.int8:
        from .models.quantize import quantize_params

        params = quantize_params(params)
    draft = load_hf(args.draft_hf) if args.draft_hf else None
    engine_kw = dict(
        max_batch=args.max_batch, max_len=args.max_len,
        page_size=args.page_size, n_pages=args.n_pages,
        fused_steps=args.fused_steps, kv_int8=args.kv_int8,
        prefix_cache=args.prefix_cache, paged_kernel=args.paged_kernel,
        prefill_chunk=args.prefill_chunk, spec_k=args.spec_k, draft=draft,
        overlap=args.serve_overlap == "on", logprobs_k=args.logprobs_k,
        max_queue=args.max_queue,
    )
    # the warm-start plane: a persistent cache when a dir is set, an
    # in-memory one when only the warm-up is asked (its graphs then live
    # for this process, the library in the default dir)
    cache_dir = args.compile_cache_dir or os.environ.get("TPU_COMPILE_CACHE_DIR", "")
    warmup = args.warmup
    if warmup == "auto":
        warmup = "lattice" if cache_dir else "off"
    compile_cache = None
    if cache_dir or warmup != "off":
        from .compilecache import CompileCache

        compile_cache = CompileCache(cache_dir or None)
    followers = None
    if args.tensor > 1:
        engine, followers = start_mesh(args, params, cfg, engine_kw, compile_cache)
        device = engine.device
        del params
    else:
        engine = InferenceEngine(params, cfg, device=device, compile_cache=compile_cache,
                                 **engine_kw)
    engine.replica_name = args.replica_name or os.environ.get("POD_NAME", "")
    engine.fleet_role = role
    state = None
    if warmup != "off":
        from .compilecache import WarmupState

        state = WarmupState()
        state.state = "warming"
    server, loop = serve_inference(engine, port=args.port, host=args.host, warmup=state)
    if state is not None:
        # the HTTP server is up: /healthz answers 503 {"warming": true}
        # while the lattice warms; requests that arrive anyway are served
        # between its points
        from .compilecache import start_warmup_thread

        start_warmup_thread(engine, state, variants="full" if warmup == "full" else "minimal")
    log.info(
        "serving %s model (%d layers, d=%d) on %s%s, %s:%d",
        "hf-imported" if args.hf else "random-init",
        cfg.n_layers, cfg.d_model, device,
        f" (rank 0 of tensor={args.tensor})" if args.tensor > 1 else "",
        args.host, server.server_address[1],
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
    # a mesh engine's fault stops its loop: exit non-zero, so the replica
    # is restarted (a lone engine's loop fails the requests and serves on)
    while not stop.wait(1.0) and not loop.failed.is_set():
        pass
    server.shutdown()
    loop.stop()  # on a mesh its thread sends the followers' stop ticket
    failed = loop.failed.is_set()
    if followers is not None:
        # after a fault no stop ticket comes: end the followers at once
        stop_mesh(followers, timeout=0.0 if failed else 60.0)
    if failed:
        log.error("the engine on the mesh failed; exiting")
        return 1
    return 0


def check_tensor_devices(args) -> None:
    """``--tensor N`` on cards needs N of them unless gloo lets ranks share."""
    if args.cpu or args.dist_backend == "gloo":
        return
    import torch

    cards = torch.cuda.device_count()
    if cards < args.tensor:
        raise SystemExit(f"--tensor {args.tensor} needs that many devices, have {cards}")


def start_mesh(args, params, cfg, engine_kw, compile_cache=None):
    """Cut ``params`` (whole, on the host) into each rank's slice, start
    ranks 1..N-1 (each sent only its slice) and build rank 0's engine in
    this process (with ``compile_cache``; each follower has a cache on the
    same directory, so the ranks build the kernel library once between
    them).  Returns (the engine, what ``stop_mesh`` ends)."""
    import tempfile

    from .models.serving import InferenceEngine
    from .parallel.distributed import (
        maybe_initialize_distributed,
        rank_device,
        resolve_backend,
        start_ranks,
    )
    from .parallel.mesh import MeshSpec, RankDevice, make_mesh
    from .parallel.sharding import serving_specs, slice_tree

    N = args.tensor
    try:
        backend = resolve_backend(args.dist_backend, N, args.cpu)
    except ValueError as e:
        raise SystemExit(str(e))
    layout = make_mesh(MeshSpec(tensor=N), [RankDevice(r) for r in range(N)])
    specs = serving_specs(params, cfg, layout)
    slices = {r: slice_tree(params, specs, layout, r) for r in range(N)}
    tmp = tempfile.TemporaryDirectory(prefix="torch-serve-")
    rendezvous = "file://" + os.path.join(tmp.name, "rendezvous")
    log.info("starting %d local ranks over %s", N, backend)
    procs, results = start_ranks(
        follow_rank, range(1, N), N,
        lambda r: (slices.pop(r), cfg, engine_kw, backend, args.cpu,
                   compile_cache.cache_dir if compile_cache is not None else None),
        rendezvous=rendezvous)
    maybe_initialize_distributed(rendezvous, N, 0, backend=backend, local_rank=0,
                                 local_ranks=N, cpu=args.cpu)
    mesh = make_mesh(MeshSpec(tensor=N)).connect()
    engine = InferenceEngine(slices.pop(0), cfg, mesh=mesh, sliced=True,
                             device=rank_device(0, args.cpu), compile_cache=compile_cache,
                             **engine_kw)
    return engine, (procs, results, tmp)


def follow_rank(rank, world, rendezvous, params, cfg, engine_kw, backend, cpu,
                cache_dir=None) -> int:
    """A follower of ``serve --tensor``: its slice's engine follows rank
    0's tickets until the stop ticket.  It applies the device plugin's
    share of the card first, and loads (or builds) the kernel library
    before it follows, through a cache on ``cache_dir`` when rank 0 has
    one: no ticket's work, a warm-up point included, starts with a build.
    It leaves the signals to rank 0, which ends it."""
    from .compilecache import CompileCache
    from .models.serving import InferenceEngine
    from .parallel.distributed import maybe_initialize_distributed, rank_device
    from .parallel.mesh import MeshSpec, make_mesh
    from .utils.devicecontract import apply_allocation

    signal.signal(signal.SIGINT, signal.SIG_IGN)
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    device = rank_device(rank, cpu)
    apply_allocation(device)
    maybe_initialize_distributed(rendezvous, world, rank, backend=backend, local_rank=rank,
                                 local_ranks=world, cpu=cpu)
    mesh = make_mesh(MeshSpec(tensor=world)).connect()
    cache = CompileCache(cache_dir) if cache_dir else None
    engine = InferenceEngine(params, cfg, mesh=mesh, sliced=True, device=device,
                             compile_cache=cache, **engine_kw)
    del params
    if device.type == "cuda":
        import time

        from .ops import _build

        t0 = time.perf_counter()
        _build.lib(cache)
        engine.library_s = time.perf_counter() - t0
    engine.follow()
    return 0


def stop_mesh(followers, timeout: float = 60.0) -> None:
    """Wait for the followers (the stop ticket ends them): their results
    first (a process is joined only after its queue is read), then the
    processes; kill any that outlive ``timeout`` (0: kill them now, after
    a fault), and leave the process group."""
    import queue

    import torch.distributed as dist

    procs, results, tmp = followers
    for _ in procs:
        try:
            rank, ok, val = results.get(timeout=timeout)
        except queue.Empty:
            break
        if not ok:
            log.error("rank %d failed:\n%s", rank, val)
    for p in procs:
        p.join(timeout)
        if p.is_alive():
            log.warning("rank process %d is still running; killing it", p.pid)
            p.kill()
            p.join()
    if dist.is_initialized():
        dist.destroy_process_group()
    tmp.cleanup()


if __name__ == "__main__":
    raise SystemExit(main())
