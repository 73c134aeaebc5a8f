"""Checkpoint / resume for training jobs, in PyTorch's own format.

Counterpart of ``elastic_gpu_scheduler_tpu/models/checkpoint.py`` (which
saves through orbax) with its surface and semantics: a rescheduled or
preempted training pod resumes where it left off.

Layout: one directory a step, ``<dir>/step_<step>/state.pt``, a
``torch.save`` of plain containers only: the step, and the flat leaves of
the params and of the optimizer state (dict keys in sorted order, so a
tree built in another key order, such as one carried over from the JAX
package, reads back the same; an ``AdamWState``'s count goes first, a
``MasterState`` is its masters then its inner state).  ``torch.load(weights_only=True)`` therefore reads
every file, and ``restore`` rebuilds the trees, ``AdamWState`` and
``MasterState`` included, from the caller's templates.

``save`` copies every leaf to host memory before it returns (the train
step updates tensors in place afterwards) and writes in a background
thread: into a temporary directory, fsynced, then renamed into place with
``os.replace``, so a crash never leaves a half-written step that
``restore`` would pick.  A second ``save`` joins the first; ``restore``
and ``close`` join any save in flight.  At most ``keep`` steps stay on
disk.  As with orbax, a step at or below the last one saved is skipped.

On a mesh (``mesh=`` a connected ``parallel/mesh.Mesh``) the file holds
whole leaves, so a checkpoint does not depend on the mesh that wrote it:
``save`` gathers each leaf from the ranks' slices (a collective call, every
rank makes it), the mesh's first rank writes, and the others wait on a barrier;
``restore`` reads the file on every rank and keeps each rank's slice under
the sharding rules of the mesh it is given.  A job saved on one mesh so
resumes on another, or on one device.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import threading
from typing import Any, Optional

import torch

from .train import AdamWState, MasterState

log = logging.getLogger("torch-launcher")

_STEP_DIR = re.compile(r"^step_(\d+)$")
_TMP_PREFIX = ".tmp_step_"
_FILE = "state.pt"


def _flat(tree) -> list:
    """The leaves of a params or optimizer-state tree, in the order
    ``_rebuild`` reads them."""
    if isinstance(tree, MasterState):
        return _flat(tree.master) + _flat(tree.inner)
    if isinstance(tree, AdamWState):
        return [tree.count] + _flat(tree.mu) + _flat(tree.nu)
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


def _place(saved, like):
    """A saved leaf as the template's: a tensor on its device, in its dtype,
    requiring grad when it does; any other leaf as saved."""
    if not isinstance(like, torch.Tensor):
        return saved
    if not isinstance(saved, torch.Tensor) or tuple(saved.shape) != tuple(like.shape):
        got = tuple(saved.shape) if isinstance(saved, torch.Tensor) else type(saved).__name__
        raise ValueError(f"checkpoint leaf {got} does not fit the template's "
                         f"{tuple(like.shape)}")
    out = saved.to(device=like.device, dtype=like.dtype)
    if like.requires_grad:
        out.requires_grad_(True)
    return out


def _rebuild(template, it):
    if isinstance(template, MasterState):
        master = _rebuild(template.master, it)
        return MasterState(master, _rebuild(template.inner, it))
    if isinstance(template, AdamWState):
        count = int(next(it))
        mu = _rebuild(template.mu, it)
        return AdamWState(count=count, mu=mu, nu=_rebuild(template.nu, it))
    if isinstance(template, dict):
        got = {k: _rebuild(template[k], it) for k in sorted(template)}
        return {k: got[k] for k in template}  # the template's key order
    return _place(next(it), template)


def _flat_specs(tree, mesh, pipeline: bool) -> list:
    """Each leaf's spec on ``mesh`` in ``_flat`` order (None for a count):
    moments and masters follow their params'.  ``pipeline``: the layer
    leaves are pipe-sharded (``transformer.pipelined``)."""
    from ..parallel.sharding import leaf_specs

    if isinstance(tree, MasterState):
        return (_flat_specs(tree.master, mesh, pipeline)
                + _flat_specs(tree.inner, mesh, pipeline))
    if isinstance(tree, AdamWState):
        return ([None] + _flat_specs(tree.mu, mesh, pipeline)
                + _flat_specs(tree.nu, mesh, pipeline))
    return _flat(leaf_specs(tree, mesh, pipeline))


def _gathered(tree, mesh, keep: bool, pipeline: bool) -> list:
    """Host copies of the whole leaves of a tree of slices, in ``_flat``
    order, gathered one leaf at a time (a collective call).  Only a rank
    that ``keep``s them copies them to the host; the others let each leaf
    go once it has passed through the gather, and get an empty list."""
    from ..parallel.sharding import full_leaf

    out = []
    for x, s in zip(_flat(tree), _flat_specs(tree, mesh, pipeline)):
        whole = full_leaf(x, s, mesh) if s is not None else x
        if keep:
            out.append(whole.to("cpu", copy=True) if s is not None else whole)
    return out


def _sliced(saved: list, template, mesh, pipeline: bool) -> list:
    from ..parallel.sharding import local_slice

    return [local_slice(x, s, mesh) if s is not None else x
            for x, s in zip(saved, _flat_specs(template, mesh, pipeline))]


def _snapshot(leaves: list) -> list:
    """Host copies of the tensor leaves, taken now (blocking)."""
    return [x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x
            for x in leaves]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = max(1, keep)
        os.makedirs(self.directory, exist_ok=True)
        # a writer killed mid-write leaves its temporary directory behind
        for name in os.listdir(self.directory):
            if name.startswith(_TMP_PREFIX):
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._last = self.latest_step()

    # -- disk ----------------------------------------------------------------

    def steps(self) -> list[int]:
        """The complete steps on disk, ascending."""
        found = []
        for name in os.listdir(self.directory):
            m = _STEP_DIR.match(name)
            if m and os.path.exists(os.path.join(self.directory, name, _FILE)):
                found.append(int(m.group(1)))
        return sorted(found)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def _write(self, step: int, payload: dict) -> None:
        tmp = os.path.join(self.directory, f"{_TMP_PREFIX}{step:08d}")
        try:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            with open(os.path.join(tmp, _FILE), "wb") as f:
                torch.save(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.step_dir(step))
            fd = os.open(self.directory, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
            for old in self.steps()[:-self.keep]:
                shutil.rmtree(self.step_dir(old), ignore_errors=True)
            log.info("checkpoint written at step %d", step)
        except BaseException as e:  # re-raised by the next join
            self._error = e
            shutil.rmtree(tmp, ignore_errors=True)

    # -- the reference's surface ----------------------------------------------

    def wait(self) -> None:
        """Join the save in flight; re-raise its failure, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def save(self, params: Any, opt_state: Any, step: int, block: bool = False,
             mesh=None, pipeline: bool = False) -> None:
        """Asynchronous by default: the leaves are copied to the host now,
        and the write runs in a background thread while training goes on
        (the train loop pays the device-to-host copy, not the disk).
        ``block=True`` for a job's final save.  On a mesh of more than one
        rank, every rank calls it: the mesh's first rank writes the gathered
        leaves.  ``pipeline``: the layer leaves are pipe-sharded, each
        stage holding its block of the stack (``transformer.pipelined``)."""
        self.wait()
        if self._last is not None and step <= self._last:
            log.info("checkpoint save skipped at step %d (last saved %d)", step, self._last)
            return
        if mesh is not None and mesh.size > 1:
            from ..parallel.collectives import barrier

            writer = mesh.rank == int(mesh.ranks.flat[0])  # the mesh's first rank writes
            p_leaves = _gathered(params, mesh, writer, pipeline)
            o_leaves = _gathered(opt_state, mesh, writer, pipeline)
            self._last = step
            if writer:
                self._dispatch(step, p_leaves, o_leaves, block)
            barrier(mesh)
            return
        self._dispatch(step, _snapshot(_flat(params)), _snapshot(_flat(opt_state)), block)

    def _dispatch(self, step: int, p_leaves: list, o_leaves: list, block: bool) -> None:
        """Write host copies ``p_leaves`` / ``o_leaves`` in the background."""
        payload = {"step": int(step), "params": p_leaves, "opt_state": o_leaves}
        self._last = step
        self._thread = threading.Thread(target=self._write, args=(step, payload),
                                        name=f"checkpoint-{step}", daemon=False)
        self._thread.start()
        log.info("checkpoint save dispatched at step %d (block=%s)", step, block)
        if block:
            self.wait()

    def restore(self, params_template: Any, opt_state_template: Any, mesh=None,
                pipeline: bool = False) -> Optional[tuple[Any, Any, int]]:
        """(params, opt_state, step) of the latest checkpoint, each leaf on
        its template's device in its template's dtype, or None when there is
        none.  Joins any save in flight first.  On a mesh the templates are
        this rank's slices, and so is what comes back, cut for ``mesh`` and
        ``pipeline`` whatever mesh wrote the file."""
        self.wait()
        step = self.latest_step()
        if step is None:
            return None
        payload = torch.load(os.path.join(self.step_dir(step), _FILE), map_location="cpu",
                             weights_only=True)
        p_saved, o_saved = payload["params"], payload["opt_state"]
        if mesh is not None and mesh.size > 1:
            if (len(p_saved) != len(_flat(params_template))
                    or len(o_saved) != len(_flat(opt_state_template))):
                raise ValueError(f"checkpoint step {step}: leaves do not match the template")
            p_saved = _sliced(p_saved, params_template, mesh, pipeline)
            o_saved = _sliced(o_saved, opt_state_template, mesh, pipeline)
        params_it, opt_it = iter(p_saved), iter(o_saved)
        try:
            params = _rebuild(params_template, params_it)
            opt_state = _rebuild(opt_state_template, opt_it)
        except StopIteration:
            raise ValueError(f"checkpoint step {step}: fewer leaves than the template") from None
        for name, it in (("params", params_it), ("opt_state", opt_it)):
            if next(it, None) is not None:
                raise ValueError(f"checkpoint step {step}: more {name} leaves than the template")
        return params, opt_state, int(payload["step"])

    def close(self) -> None:
        self.wait()
