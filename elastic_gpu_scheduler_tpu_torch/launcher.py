"""Workload launcher: from a bound pod's annotations to a running
training job, on one device or on a mesh of ranks.

Counterpart of ``elastic_gpu_scheduler_tpu/launcher.py``.  Inside the pod
the launcher reads the scheduler's chip-coordinate annotation (or the
device plugin's ``TPU_VISIBLE_CHIPS``), joins the job's process group
(``parallel/distributed``: from the environment, or from a gang's bind
annotations), builds the mesh (``parallel/mesh``: the hierarchical mesh
when a gang straddles slices and the data axis can hold the boundary, else
the flat mesh from the allocation) and trains (``models/train``).  One
process is one rank on one device.

``main`` with a mesh of N ranks in a process that is not already a rank of
a world starts N local ranks (``parallel/distributed.spawn_ranks``), one a
card; ``--dist-backend`` picks the transport (``nccl`` by default on cards,
``gloo`` on ``--cpu``; gloo on cards lets ranks share a card).  Rank 0
prints the losses and writes the metrics log.  Every mesh axis trains:
``--mesh pipe=2`` with ``--n-microbatches M`` runs the layers in the GPipe
schedule (without it the pipe ranks hold the layers whole), and
``--n-experts E`` makes the model a Switch MoE whose experts split over
``--mesh expert=N``; these two flags set ``TransformerConfig``'s fields of
the same names (a ``JobSpec`` carries them in its ``model``).  Refused by
name, and exit 2 from ``main``: MoE in the pipeline schedule on a batch cut
over data or fsdp.

``--compile-cache DIR`` builds or loads the
kernel library of the job's ranks through a compile cache in DIR
(``compilecache/``, ``ops/_build``): a restarted job, or the ranks of one,
run ``nvcc`` once between them; the last line printed holds each local
rank's cache counters (a restart on the directory: fills 0, loads 1).
The reference points JAX's compilation cache there; training captures
no graph, so the library is the whole of what the port compiles.

``--checkpoint-dir`` with ``--checkpoint-every N`` saves the params and
optimizer state every N steps and once more, blocking, at the end
(``models/checkpoint``), as whole leaves whatever the mesh; a job started on
a directory that holds a checkpoint resumes from its latest step on
whatever mesh it now has, its batch stream fast-forwarded to that step.
``--profile-dir`` writes a ``torch.profiler`` trace (rank 0's),
``--metrics-log`` appends per-step ``{step, loss}`` JSON lines.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from dataclasses import dataclass, field
from typing import Optional

import torch

from .models.data import MemmapTokenDataset, SyntheticTokenDataset, batches
from .models.train import init_sharded_state, make_optimizer, make_train_step
from .models.transformer import (
    TransformerConfig,
    check_mesh_model,
    pipelined,
    resolve_device,
)
from .parallel.mesh import (
    ANNOTATION_CONTAINER_PREFIX,
    MeshSpec,
    coords_from_annotations,
    format_coord,
    gang_slices_from_annotations,
    hierarchical_mesh,
    mesh_from_allocation,
    parse_coord,
    parse_mesh,
)
from .utils.devicecontract import apply_allocation

log = logging.getLogger("torch-launcher")


@dataclass
class JobSpec:
    model: TransformerConfig = field(default_factory=TransformerConfig)
    mesh: MeshSpec = field(default_factory=MeshSpec)
    steps: int = 10
    batch_size: int = 8  # global batch (cut across the data and fsdp ranks)
    seq_len: int = 128
    lr: float = 3e-4
    seed: int = 0
    checkpoint_dir: str = ""
    checkpoint_every: int = 0
    dataset_path: str = ""  # memmap token file; empty → synthetic motifs
    warmup_steps: int = 0
    grad_clip: float = 1.0


class Unported(NotImplementedError):
    """A job asks for something this slice of the port does not run."""


def coords_for_container(annotations: Optional[dict[str, str]], container: str) -> list:
    """Scheduler annotation first, device-plugin env as on-node fallback."""
    coords = coords_from_annotations(annotations or {}, container)
    if coords:
        return coords
    env = os.environ.get("TPU_VISIBLE_CHIPS", "")
    return [parse_coord(p) for p in env.split(",") if p]


def check_mesh_job(spec: JobSpec) -> None:
    """``check_mesh_model`` on the job's model and mesh, before any rank
    starts: ``Unported`` names what this slice cannot run on a mesh, a
    ValueError a mesh the model cannot be cut over."""
    try:
        check_mesh_model(spec.model, spec.mesh)
    except NotImplementedError as e:
        raise Unported(str(e)) from None


def build_mesh(spec: JobSpec, annotations: Optional[dict[str, str]], container: str,
               devices=None):
    """The job's mesh (reference ``run_job``'s choice): hierarchical when a
    gang straddles slices and the data axis can hold the boundary, else
    the flat mesh from the allocation, with the reference's warning."""
    ann = dict(annotations or {})
    coords = coords_for_container(ann, container)
    if coords:  # the annotation shape mesh_from_allocation reads
        ann[ANNOTATION_CONTAINER_PREFIX + container] = ",".join(format_coord(c) for c in coords)
    slices = gang_slices_from_annotations(ann)
    if len(slices) > 1 and spec.mesh.data % len(slices) == 0:
        from .parallel.mesh import _world_devices

        devs = list(devices) if devices is not None else _world_devices()
        mesh = hierarchical_mesh(spec.mesh, len(slices), devices=devs[:spec.mesh.num_devices])
        log.info("hierarchical mesh: %s across %d slices (the data axis spans them) over "
                 "%d ranks", spec.mesh.sizes, len(slices), spec.mesh.num_devices)
        return mesh
    if len(slices) > 1:
        log.warning(
            "gang spans %d slices but mesh data axis %d is not divisible by the slice "
            "count; building a FLAT mesh — intra-slice collectives will cross the slice "
            "boundary. Set MeshSpec(data=k*%d, ...) to get the hierarchical layout.",
            len(slices), spec.mesh.data, len(slices))
    mesh = mesh_from_allocation(ann, container, spec.mesh, devices=devices)
    log.info("mesh: %s over %d ranks", spec.mesh.sizes, spec.mesh.num_devices)
    return mesh


def run_job(spec: JobSpec, pod_annotations: Optional[dict[str, str]] = None,
            container: str = "main", device=None, devices=None) -> list[float]:
    """Train for ``spec.steps``; returns per-step losses (the global mean
    on every rank).  A mesh of more than one rank needs this process to be
    a rank of a world of that size (``parallel/distributed``); a process
    in a world of one rank trains through the mesh path on a one-rank mesh."""
    from .parallel.collectives import barrier
    from .parallel.distributed import (
        gang_info_from_annotations,
        initialize_for_gang,
        maybe_initialize_distributed,
    )

    check_mesh_job(spec)
    cpu = device is not None and torch.device(device).type == "cpu"
    if not maybe_initialize_distributed(cpu=cpu):
        if gang_info_from_annotations(pod_annotations or {})[1] > 1:
            initialize_for_gang(pod_annotations, cpu=cpu)
    import torch.distributed as dist

    mesh = None
    if dist.is_initialized() or spec.mesh.num_devices > 1:
        mesh = build_mesh(spec, pod_annotations, container, devices).connect()
    dev = resolve_device(device)
    opt = make_optimizer(
        lr=spec.lr,
        warmup_steps=spec.warmup_steps,
        total_steps=spec.steps if spec.warmup_steps else 0,
        grad_clip=spec.grad_clip,
    )
    gen = torch.Generator(device=dev).manual_seed(spec.seed)
    params, opt_state = init_sharded_state(spec.model, opt, gen, dev, mesh)
    piped = pipelined(spec.model, mesh)
    step_fn = make_train_step(spec.model, opt, mesh)
    source = (
        MemmapTokenDataset(spec.dataset_path)
        if spec.dataset_path
        else SyntheticTokenDataset(spec.model.vocab_size, seed=spec.seed)
    )
    start_step = 0
    ckpt = None
    if spec.checkpoint_dir:
        from .models.checkpoint import CheckpointManager

        ckpt = CheckpointManager(spec.checkpoint_dir)
        restored = ckpt.restore(params, opt_state, mesh=mesh, pipeline=piped)
        if restored is not None:
            params, opt_state, start_step = restored
            log.info("resumed from step %d", start_step)
    # the global batch of the seeded stream, cut by this rank's (data, fsdp)
    # index; built after the restore, so a resumed run continues the stream
    dp_index, dp_count = 0, 1
    if mesh is not None:
        dp_index, dp_count = mesh.axes_index(("data", "fsdp")), mesh.axes_size(("data", "fsdp"))
    batch_iter = batches(source, batch_size=spec.batch_size, seq_len=spec.seq_len,
                         seed=spec.seed + 1, process_index=dp_index, process_count=dp_count,
                         start_batch=start_step)
    log.info("training on %s (mesh %s): %s", dev, mesh, spec.model)
    losses = []
    for step in range(start_step, spec.steps):
        tokens = torch.from_numpy(next(batch_iter)).to(dev)
        params, opt_state, loss = step_fn(params, opt_state, tokens)
        losses.append(float(loss))
        if ckpt and spec.checkpoint_every and (step + 1) % spec.checkpoint_every == 0:
            ckpt.save(params, opt_state, step + 1, mesh=mesh, pipeline=piped)
    if ckpt and spec.checkpoint_every:
        # the job's final save is on disk before the pod exits
        ckpt.save(params, opt_state, spec.steps, block=True, mesh=mesh, pipeline=piped)
    if ckpt:
        ckpt.close()
    if mesh is not None:
        barrier(mesh)
    return losses


def _read_annotations(path: str) -> dict[str, str]:
    """Downward-API format: one ``key="value"`` per line."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or "=" not in line:
                continue
            k, _, v = line.partition("=")
            out[k] = json.loads(v) if v.startswith('"') else v
    return out


def _device_count(annotations: dict, container: str, cpu: bool, mesh: Optional[MeshSpec]
                  ) -> int:
    """The ranks a job has (the reference's ``len(jax.devices())``): the
    world it is a rank of, else the chips its allocation names, else the
    ranks ``--mesh`` names, else the local cards (one on the CPU)."""
    from .parallel.distributed import _env_int

    world = _env_int("TPU_NUM_PROCESSES", "WORLD_SIZE", default=0)
    if world > 0:
        return world
    coords = coords_for_container(annotations, container)
    if coords:
        return len(coords)
    if mesh is not None:
        return mesh.num_devices
    return 1 if cpu else max(1, torch.cuda.device_count())


def _in_world() -> bool:
    from .parallel.distributed import _env_int

    return _env_int("TPU_NUM_PROCESSES", "WORLD_SIZE", default=0) > 0


def _train(job: JobSpec, annotations: dict, container: str, device, profile_dir: str,
           cpu: bool, compile_cache: str = "") -> tuple[list[float], Optional[dict]]:
    """The job's losses, and the compile cache's counters when the kernel
    library went through one (``--compile-cache`` on a card)."""
    # the device plugin's share of the card, before the first allocation
    apply_allocation(resolve_device(device))
    cache = None
    if compile_cache and not cpu:
        from .compilecache import CompileCache
        from .ops import _build

        cache = CompileCache(compile_cache)
        _build.use_cache(cache)
    if not profile_dir:
        losses = run_job(job, annotations, container, device)
    else:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([] if cpu else [ProfilerActivity.CUDA])
        with profile(activities=acts) as prof:
            losses = run_job(job, annotations, container, device)
        os.makedirs(profile_dir, exist_ok=True)
        trace = os.path.join(profile_dir, "trace.json")
        prof.export_chrome_trace(trace)
        log.info("profiler trace written to %s", trace)
    return losses, cache.stats() if cache is not None else None


def _launch_rank(rank: int, world: int, rendezvous: str, job: JobSpec, annotations: dict,
                 container: str, backend: str, cpu: bool, profile_dir: str,
                 compile_cache: str) -> tuple[list[float], Optional[dict]]:
    """One local rank of ``main``'s spawn: join the world, train."""
    from .parallel.distributed import maybe_initialize_distributed

    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING)
    maybe_initialize_distributed(rendezvous, world, rank, backend=backend, local_rank=rank,
                                 local_ranks=world, cpu=cpu)
    return _train(job, annotations, container, "cpu" if cpu else None,
                  profile_dir if rank == 0 else "", cpu, compile_cache)


def main(argv=None) -> int:
    """In-pod entrypoint: ``python -m elastic_gpu_scheduler_tpu_torch.launcher``."""
    import argparse

    p = argparse.ArgumentParser("torch-launcher")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--data", default="", help="memmap token file (else synthetic)")
    p.add_argument("--checkpoint-dir", default="",
                   help="save here, and resume from the latest step found here")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save every this many steps, and at the end (0: never save)")
    p.add_argument("--container", default="main")
    p.add_argument("--mesh", default="",
                   help="axis sizes, e.g. 'tensor=2,seq=2' (the rest of the ranks go to data)")
    p.add_argument("--annotations", default="",
                   help="downward-API file with pod annotations (key=\"value\" lines)")
    p.add_argument("--dist-backend", default="", choices=["", "nccl", "gloo"],
                   help="collective transport: nccl (default on cards; one rank a card) "
                        "or gloo (the CPU; on cards, ranks may share one)")
    p.add_argument("--profile-dir", default="", help="write a torch.profiler trace")
    p.add_argument("--n-microbatches", type=int, default=0,
                   help="microbatches of the pipeline schedule over --mesh pipe=N "
                        "(0: no schedule; the pipe ranks hold the layers whole)")
    p.add_argument("--n-experts", type=int, default=0,
                   help="a Switch MoE model of this many experts, split over --mesh expert=N")
    p.add_argument("--compile-cache", default="",
                   help="compile-cache dir of the kernel library (fast pod restarts; "
                        "without it TPU_COMPILE_CACHE_DIR, else the package's)")
    p.add_argument("--metrics-log", default="",
                   help="append per-step {step, loss} JSONL records to this file")
    p.add_argument("--cpu", action="store_true", help="train on the CPU (plain versions)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    def refuse(msg: str) -> int:
        print(f"error: {msg}", file=sys.stderr)
        return 2

    annotations = {}
    if args.annotations and os.path.exists(args.annotations):
        annotations = _read_annotations(args.annotations)
    try:
        named = parse_mesh(args.mesh) if args.mesh else None
    except ValueError as e:
        return refuse(str(e))
    mesh = named or MeshSpec()
    n_dev = _device_count(annotations, args.container, args.cpu, named)
    sizes = mesh.sizes
    prod = mesh.num_devices
    if prod != n_dev:  # the remainder goes to data parallelism, as the reference's
        if n_dev % prod:
            return refuse(f"mesh product {prod} incompatible with {n_dev} devices")
        sizes["data"] *= n_dev // prod
        mesh = MeshSpec(**sizes)
    job = JobSpec(
        model=TransformerConfig(n_microbatches=args.n_microbatches, n_experts=args.n_experts),
        mesh=mesh, steps=args.steps, batch_size=args.batch_size, seq_len=args.seq_len,
        lr=args.lr, dataset_path=args.data, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
    )
    try:
        check_mesh_job(job)
    except (Unported, ValueError) as e:
        return refuse(str(e))
    dp = mesh.data * mesh.fsdp
    if args.batch_size % dp:
        return refuse(f"global batch {args.batch_size} not divisible by data*fsdp={dp}")
    if args.seq_len % mesh.seq:
        return refuse(f"--seq-len {args.seq_len} not divisible by seq={mesh.seq}")
    if pipelined(job.model, mesh) and (args.batch_size // dp) % args.n_microbatches:
        return refuse(f"batch {args.batch_size // dp} not divisible by {args.n_microbatches} "
                      f"microbatches (a rank's rows: --batch-size over data*fsdp={dp})")
    device = "cpu" if args.cpu else None
    if mesh.num_devices > 1 and not _in_world():
        from .parallel.distributed import resolve_backend, spawn_ranks

        try:
            backend = resolve_backend(args.dist_backend, mesh.num_devices, args.cpu)
        except ValueError as e:
            return refuse(str(e))
        import tempfile

        with tempfile.TemporaryDirectory(prefix="torch-launcher-") as tmp:
            log.info("starting %d local ranks over %s", mesh.num_devices, backend)
            results = spawn_ranks(
                _launch_rank, mesh.num_devices,
                (job, annotations, args.container, backend, args.cpu, args.profile_dir,
                 args.compile_cache),
                rendezvous="file://" + os.path.join(tmp, "rendezvous"))
        losses = results[0][0]
        caches = [r[1] for r in results]
    else:
        from .parallel.distributed import maybe_initialize_distributed, process_info

        try:
            maybe_initialize_distributed(backend=args.dist_backend, cpu=args.cpu)
        except ValueError as e:
            return refuse(str(e))
        if process_info()[0] != 0:  # rank 0 reports
            _train(job, annotations, args.container, device, "", args.cpu, args.compile_cache)
            return 0
        losses, stats = _train(job, annotations, args.container, device, args.profile_dir,
                               args.cpu, args.compile_cache)
        caches = [stats]
    if args.metrics_log:
        with open(args.metrics_log, "a") as f:
            start = job.steps - len(losses)  # past the resumed steps
            for i, loss in enumerate(losses):
                f.write(json.dumps({"step": start + i, "loss": loss}) + "\n")
    if losses:
        print(f"trained {len(losses)} steps; final loss {losses[-1]:.4f}")
    else:
        print("no steps to run (already complete or --steps 0)")
    if any(caches):
        # each local rank's: a restart on the same dir shows fills 0
        print(f"compile cache {args.compile_cache}: {json.dumps(caches)}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
