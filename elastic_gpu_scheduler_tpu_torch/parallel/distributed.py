"""Joining the job's process group: one call a rank before building a mesh.

Counterpart of ``elastic_gpu_scheduler_tpu/parallel/distributed.py`` on
``torch.distributed.init_process_group``.  One process is one rank on one
device.  The world comes from the arguments, else from the environment:

    TPU_COORDINATOR_ADDRESS  host:port of rank 0 (or MASTER_ADDR / MASTER_PORT)
    TPU_NUM_PROCESSES        world size (or WORLD_SIZE, as torchrun sets it)
    TPU_PROCESS_ID           this rank (or RANK)
    LOCAL_RANK               this rank's index on its host (default 0)
    LOCAL_WORLD_SIZE         the ranks on this host (default 1)

A coordinator given as a URL (``file:///path``, ``tcp://host:port``) is the
rendezvous itself; a bare ``host:port`` means ``tcp://host:port``.

The backend is NCCL when each local rank has a card of its own and gloo on
the CPU.  More local ranks than cards is an error unless the caller names
``backend="gloo"``: ranks then share ``cuda:(local_rank % cards)`` and the
collectives stage CUDA tensors through the host (``collectives.py``).  The
transport is chosen by name and logged; it is never picked because NCCL
failed.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta

from .mesh import ANNOTATION_GANG_PEERS, ANNOTATION_GANG_RANK, ANNOTATION_GANG_SIZE

log = logging.getLogger("torch-launcher")

DEFAULT_COORDINATOR_PORT = 8476
BACKENDS = ("nccl", "gloo")


def _env_int(*names: str, default: int) -> int:
    for n in names:
        v = os.environ.get(n, "")
        if v:
            return int(v)
    return default


def resolve_backend(backend: str, local_ranks: int, cpu: bool) -> str:
    """The transport for ``local_ranks`` ranks on this host: ``backend``
    when named, else NCCL on cards and gloo on the CPU.  NCCL with more
    local ranks than cards raises, naming ``--dist-backend gloo``."""
    import torch

    if backend and backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: choose from {list(BACKENDS)}")
    if cpu:
        if backend == "nccl":
            raise ValueError("the NCCL backend needs CUDA devices; the CPU takes gloo")
        return "gloo"
    backend = backend or "nccl"
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if local_ranks > cards:
            raise ValueError(
                f"{local_ranks} local ranks over {cards} CUDA device(s): NCCL takes one "
                "rank a card; name the gloo backend (--dist-backend gloo) to share cards")
    return backend


def rank_device(local_rank: int, cpu: bool):
    """The device of a local rank: the CPU, or ``cuda:(local_rank % cards)``."""
    import torch

    if cpu:
        return torch.device("cpu")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda", local_rank % cards)


def maybe_initialize_distributed(coordinator: str = "", num_processes: int = 0,
                                 process_id: int = -1, backend: str = "",
                                 local_rank: int = -1, local_ranks: int = 0,
                                 cpu: bool = False, timeout_s: float = 600.0) -> bool:
    """Initialize ``torch.distributed`` when a multi-rank world is
    configured.  Returns True if it is active (already, or now); a no-op
    returning False for a single process with no coordinator."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    if not coordinator:
        coordinator = os.environ.get("TPU_COORDINATOR_ADDRESS", "")
    if not coordinator and os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"):
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes <= 0:
        num_processes = _env_int("TPU_NUM_PROCESSES", "WORLD_SIZE", default=0)
    if process_id < 0:
        process_id = _env_int("TPU_PROCESS_ID", "RANK", default=-1)
    if num_processes <= 1 and not coordinator:
        return False
    if not coordinator:
        raise ValueError(f"a world of {num_processes} needs a coordinator address")
    if process_id < 0:
        raise ValueError("a multi-rank world needs this process's rank")
    num_processes = max(1, num_processes)
    if local_rank < 0:
        local_rank = _env_int("LOCAL_RANK", default=0)
    if local_ranks <= 0:
        local_ranks = _env_int("LOCAL_WORLD_SIZE", default=1)
    backend = resolve_backend(backend, local_ranks, cpu)
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    if backend == "nccl":
        torch.cuda.set_device(rank_device(local_rank, cpu))
    elif not cpu:
        torch.cuda.set_device(rank_device(local_rank, cpu))
        log.info("gloo over CUDA tensors: %d local ranks share %d card(s), "
                 "collectives staged through the host", local_ranks,
                 torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id, timeout=timedelta(seconds=timeout_s))
    log.info("torch.distributed: rank %d/%d, backend %s, rendezvous %s",
             process_id, num_processes, backend, init.split("://")[0])
    return True


def process_info() -> tuple[int, int]:
    """(rank, world size) — (0, 1) when not distributed."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def gang_info_from_annotations(annotations: dict) -> tuple[int, int, list[str]]:
    """(rank, size, ordered peer keys) from the gang commit's bind
    annotations.  The peer list is authoritative for size when present;
    rank defaults to 0 and size to the ``gang-size`` annotation (or 1)."""
    ann = annotations or {}
    peers = [p for p in ann.get(ANNOTATION_GANG_PEERS, "").split(",") if p]
    try:
        rank = int(ann.get(ANNOTATION_GANG_RANK, "0"))
    except ValueError:
        rank = 0
    if peers:
        size = len(peers)
    else:
        try:
            size = int(ann.get(ANNOTATION_GANG_SIZE, "1") or 1)
        except ValueError:
            size = 1
    return rank, max(1, size), peers


def initialize_for_gang(annotations: dict, coordinator: str = "", coordinator_port: int = 0,
                        local_ranks: int = 1, local_rank: int = 0, backend: str = "",
                        cpu: bool = False) -> bool:
    """Join the process group as a scheduler-bound gang member: a member
    runs ``local_ranks`` ranks (one a local card), this one at
    ``local_rank``, so its rank is ``gang_rank × local_ranks +
    local_rank`` of a world of ``gang size × local_ranks``.

    Rendezvous: ``coordinator`` → ``TPU_COORDINATOR_ADDRESS`` → peer 0's pod
    name (in a headless-Service deployment the pod name is its DNS host)
    on ``coordinator_port`` (default ``TPU_COORDINATOR_PORT`` or 8476).  A
    gang of one is a no-op.  Returns True when the process group is active."""
    rank, size, peers = gang_info_from_annotations(annotations)
    if size <= 1:
        return False
    if not coordinator:
        coordinator = os.environ.get("TPU_COORDINATOR_ADDRESS", "")
    if not coordinator and peers:
        host = peers[0].rsplit("/", 1)[-1]  # "ns/name" → name
        port = coordinator_port or int(os.environ.get("TPU_COORDINATOR_PORT", "0")
                                       or DEFAULT_COORDINATOR_PORT)
        coordinator = f"{host}:{port}"
    if not coordinator:
        raise ValueError(f"gang of {size} needs a coordinator address (no gang-peers "
                         "annotation, no TPU_COORDINATOR_ADDRESS)")
    return maybe_initialize_distributed(
        coordinator=coordinator, num_processes=size * local_ranks,
        process_id=rank * local_ranks + local_rank, backend=backend,
        local_rank=local_rank, local_ranks=local_ranks, cpu=cpu)


def start_ranks(fn, ranks, world_size: int, args_of, *, rendezvous: str):
    """Start ``fn(rank, world_size, rendezvous, *args_of(rank))`` for each
    of ``ranks`` in a fresh process (the spawn start method), so each rank
    is sent only its own arguments.  Returns (the processes, the queue each
    puts (rank, ok, result or traceback) on when ``fn`` ends)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, rendezvous, args_of(r), results),
                         daemon=False) for r in ranks]
    for p in procs:
        p.start()
    return procs, results


def spawn_ranks(fn, world_size: int, args: tuple = (), *, rendezvous: str,
                timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, world_size, rendezvous, *args)`` in ``world_size``
    fresh processes (the spawn start method) and return their results in
    rank order.  ``fn`` must be importable by name and joins the process
    group itself.  A rank that fails, or a world that outlives
    ``timeout_s``, kills the others and raises."""
    import queue
    import time

    procs, results = start_ranks(fn, range(world_size), world_size, lambda r: args,
                                 rendezvous=rendezvous)
    out: dict[int, object] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(out))} "
                                   f"did not finish within {timeout_s:.0f} s")
            try:
                r, ok, val = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if p.exitcode is not None and p.exitcode != 0 and i not in out]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode}") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {r} failed:\n{val}")
            out[r] = val
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world_size)]


def _rank_main(fn, rank, world_size, rendezvous, args, results) -> None:
    import traceback

    try:
        val = fn(rank, world_size, rendezvous, *args)
        results.put((rank, True, val))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
