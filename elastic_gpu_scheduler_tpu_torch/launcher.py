"""Workload launcher on one device: from a bound pod's annotations to a
running training job.

Counterpart of ``elastic_gpu_scheduler_tpu/launcher.py`` for a single
device.  The reference reads the scheduler's chip-coordinate annotation
(or the device plugin's ``TPU_VISIBLE_CHIPS``), builds a mesh over those
chips and trains; this slice of the port trains on one device (``cuda``
unless asked otherwise, ``--cpu`` on the command line).  What needs more
than one device or a module not ported yet is refused by name, and
``main`` exits 2 for it:

- a mesh whose axis sizes multiply past 1 (``--mesh``);
- an allocation (annotation, ``TPU_VISIBLE_CHIPS`` or a straddling gang's
  slice list) naming more than one chip;
- the compile cache (``--compile-cache``).

``--checkpoint-dir`` with ``--checkpoint-every N`` saves the params and
optimizer state every N steps and once more, blocking, at the end
(``models/checkpoint``); a job started on a directory that holds a
checkpoint resumes from its latest step, its batch stream fast-forwarded
to that step.  ``--profile-dir`` writes a ``torch.profiler`` trace,
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
from .models.train import init_state, make_optimizer, make_train_step
from .models.transformer import TransformerConfig, resolve_device

log = logging.getLogger("torch-launcher")

# the scheduler's annotations (own copies of the reference's utils/consts)
ANNOTATION_CONTAINER_PREFIX = "elasticgpu.io/container-"  # + name → "x.y.z,..."
ANNOTATION_GANG_SLICES = "elasticgpu.io/gang-slices"  # "sliceA,sliceB,..."

AXES = ("data", "fsdp", "expert", "pipe", "tensor", "seq")


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape (the reference's ``parallel/mesh.MeshSpec``);
    this slice runs only the one-device mesh."""

    data: int = 1
    fsdp: int = 1
    expert: int = 1
    pipe: int = 1
    tensor: int = 1
    seq: int = 1

    @property
    def sizes(self) -> dict[str, int]:
        return {a: getattr(self, a) for a in AXES}

    @property
    def num_devices(self) -> int:
        n = 1
        for v in self.sizes.values():
            n *= v
        return n


@dataclass
class JobSpec:
    model: TransformerConfig = field(default_factory=TransformerConfig)
    mesh: MeshSpec = field(default_factory=MeshSpec)
    steps: int = 10
    batch_size: int = 8
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
    raw = (annotations or {}).get(ANNOTATION_CONTAINER_PREFIX + container, "")
    if not raw:
        raw = os.environ.get("TPU_VISIBLE_CHIPS", "")
    return [tuple(int(v) for v in p.split(".")) for p in raw.split(",") if p]


def check_one_device(spec: JobSpec, annotations: Optional[dict[str, str]] = None,
                     container: str = "main") -> None:
    """Raise ``Unported``, naming the field, for what this slice cannot run."""
    if spec.mesh.num_devices > 1:
        raise Unported(
            f"mesh {spec.mesh.sizes} spans {spec.mesh.num_devices} devices: "
            "--mesh past one device needs parallel/, a later slice of the port"
        )
    coords = coords_for_container(annotations, container)
    if len(coords) > 1:
        raise Unported(
            f"the allocation names {len(coords)} chips (annotation "
            f"{ANNOTATION_CONTAINER_PREFIX + container} or TPU_VISIBLE_CHIPS): "
            "this slice of the port trains on one device"
        )
    slices = [s for s in (annotations or {}).get(ANNOTATION_GANG_SLICES, "").split(",") if s]
    if len(slices) > 1:
        raise Unported(
            f"a gang across {len(slices)} slices ({ANNOTATION_GANG_SLICES}) "
            "needs parallel/, a later slice of the port"
        )


def run_job(spec: JobSpec, pod_annotations: Optional[dict[str, str]] = None,
            container: str = "main", device=None) -> list[float]:
    """Train for ``spec.steps`` on one device; returns per-step losses."""
    check_one_device(spec, pod_annotations, container)
    dev = resolve_device(device)
    opt = make_optimizer(
        lr=spec.lr,
        warmup_steps=spec.warmup_steps,
        total_steps=spec.steps if spec.warmup_steps else 0,
        grad_clip=spec.grad_clip,
    )
    gen = torch.Generator(device=dev).manual_seed(spec.seed)
    params, opt_state = init_state(spec.model, opt, gen, dev)
    step_fn = make_train_step(spec.model, opt)
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
        restored = ckpt.restore(params, opt_state)
        if restored is not None:
            params, opt_state, start_step = restored
            log.info("resumed from step %d", start_step)
    # built after the restore: a resumed run continues the stream, not replays it
    batch_iter = batches(source, batch_size=spec.batch_size, seq_len=spec.seq_len,
                         seed=spec.seed + 1, start_batch=start_step)
    log.info("training on %s: %s", dev, spec.model)
    losses = []
    for step in range(start_step, spec.steps):
        tokens = torch.from_numpy(next(batch_iter)).to(dev)
        params, opt_state, loss = step_fn(params, opt_state, tokens)
        losses.append(float(loss))
        if ckpt and spec.checkpoint_every and (step + 1) % spec.checkpoint_every == 0:
            ckpt.save(params, opt_state, step + 1)
    if ckpt and spec.checkpoint_every:
        # the job's final save is on disk before the pod exits
        ckpt.save(params, opt_state, spec.steps, block=True)
    if ckpt:
        ckpt.close()
    return losses


def _parse_mesh(text: str) -> MeshSpec:
    sizes = {a: 1 for a in AXES}
    for part in text.split(","):
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in sizes:
            raise ValueError(f"unknown mesh axis {k!r}; choose from {list(AXES)}")
        try:
            sizes[k] = int(v)
        except ValueError:
            raise ValueError(f"mesh axis {k}={v!r} is not an integer") from None
    return MeshSpec(**sizes)


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
                   help="axis sizes, e.g. 'tensor=2' (this slice: product 1)")
    p.add_argument("--annotations", default="",
                   help="downward-API file with pod annotations (key=\"value\" lines)")
    p.add_argument("--profile-dir", default="", help="write a torch.profiler trace")
    p.add_argument("--compile-cache", default="", help="not ported yet: exits 2")
    p.add_argument("--metrics-log", default="",
                   help="append per-step {step, loss} JSONL records to this file")
    p.add_argument("--cpu", action="store_true", help="train on the CPU (plain versions)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    def refuse(msg: str) -> int:
        print(f"error: {msg}", file=sys.stderr)
        return 2

    if args.compile_cache:
        return refuse("--compile-cache: the compile cache is a later slice of the port")
    try:
        mesh = _parse_mesh(args.mesh) if args.mesh else MeshSpec()
    except ValueError as e:
        return refuse(str(e))
    annotations = {}
    if args.annotations and os.path.exists(args.annotations):
        annotations = _read_annotations(args.annotations)
    job = JobSpec(
        mesh=mesh, steps=args.steps, batch_size=args.batch_size, seq_len=args.seq_len,
        lr=args.lr, dataset_path=args.data, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
    )
    try:
        check_one_device(job, annotations, args.container)
    except Unported as e:
        return refuse(str(e))
    device = "cpu" if args.cpu else None
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if not args.cpu:
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            losses = run_job(job, annotations, args.container, device)
        os.makedirs(args.profile_dir, exist_ok=True)
        trace = os.path.join(args.profile_dir, "trace.json")
        prof.export_chrome_trace(trace)
        log.info("profiler trace written to %s", trace)
    else:
        losses = run_job(job, annotations, args.container, device)
    if args.metrics_log:
        with open(args.metrics_log, "a") as f:
            start = job.steps - len(losses)  # past the resumed steps
            for i, loss in enumerate(losses):
                f.write(json.dumps({"step": start + i, "loss": loss}) + "\n")
    if losses:
        print(f"trained {len(losses)} steps; final loss {losses[-1]:.4f}")
    else:
        print("no steps to run (already complete or --steps 0)")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
