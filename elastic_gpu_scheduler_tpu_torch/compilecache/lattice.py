"""Shape-lattice warm-up: capture the decode graphs, and run every other
serving shape once, BEFORE the pod reports Ready.

Own copy of ``elastic_gpu_scheduler_tpu/compilecache/lattice.py``.  The
engine buckets its dispatch shapes (prefill pad lengths and page-table
widths round up to powers of two), so the set of shapes admission can
demand is a small, enumerable lattice: ``InferenceEngine.aot_signatures``.
``warmup_engine`` first loads (or builds) the kernel library through the
engine's compile cache, then walks that lattice, publishing progress
through a :class:`WarmupState` the HTTP plane surfaces:

- ``/healthz`` answers ``503 {"warming": true}`` while the lattice builds,
  so the fleet router holds the replica in ``warming`` and routes it no
  traffic;
- ``/v1/stats`` carries the state and the cache's counters, which is what
  shows a second start on the same cache dir runs no ``nvcc``.

Each point runs on the ENGINE's thread (``run``: ``engine.run_task`` under
a running ``EngineLoop``), one task a point, so requests already queued
are served between points and no capture ever runs beside a dispatch.
A point that fails is counted, logged and skipped: its shape is captured
at first use, which raises if it fails again.  The library is not a
point: if it cannot be built the state is ``error``, and ``/healthz``
answers 503 ``{"warmup_failed": true}`` for good (the port has no
fallback: every request would fail at its first kernel call).

An engine on a mesh of several ranks (``engine.mirrored``) warms the same
lattice, each point a task of rank 0's next ticket (``engine.run_verb
("warm", ...)``; ``engine.warm_point`` when the caller drives the engine),
which every rank runs in the same round: its followers loaded the library
before they began to follow (``serve.follow_rank``).  There a failed point
is not skipped, since the ranks would part: it ends the warm-up on every
rank in state ``error`` (the task raises on every rank, as a round's fault
does, and rank 0's loop stops serving).  The state then holds the mesh's
shape and, a rank, its library seconds, the points it ran and their
seconds.

Where the lattice's time goes is in the state too: the seconds points
waited for the engine's thread, ran on it, and spent there on its CPU, the
process's CPU over the lattice (every thread), and the engine's eager
scratch chunks and captures.

The reference's ``warmup`` journal record is not written: the port has no
journal.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from ..metrics import WARMUP_SECONDS

log = logging.getLogger("tpu-scheduler")

# a point waits this long for the engine thread (a loop busy with a long
# batch) before it counts as failed
POINT_TIMEOUT_S = 600.0


class WarmupState:
    """Mutable warm-up progress (``state``: none, warming, ready or error),
    written by the warm-up thread and read by HTTP handler threads
    (GIL-atomic attribute loads, advisory state).
    Beside the reference's fields: the library's load or build seconds,
    the graphs captured, the device memory the allocator held before and
    after the lattice (CUDA only), and the lattice's host time: summed
    over the points, the seconds each waited for the engine's thread
    (``queue_s``), ran there (``run_s``) and used its CPU (``run_cpu_s``);
    the process's CPU seconds over the lattice (``process_cpu_s``); the
    engine's scratch chunks' and captures' seconds (``scratch_s``,
    ``capture_s``, the latter including the former) and the slowest
    point.  On a mesh: its shape (``mesh``) and each rank's library
    seconds, points built and their seconds (``ranks``)."""

    def __init__(self):
        self.state = "none"
        self.lattice_size = 0
        self.built = 0
        self.fills = 0
        self.loads = 0
        self.errors = 0
        self.wall_s = 0.0
        self.started_at = 0.0
        self.detail = ""
        self.library_s = 0.0
        self.captures = 0
        self.reserved_before = 0
        self.reserved_after = 0
        self.queue_s = 0.0
        self.run_s = 0.0
        self.run_cpu_s = 0.0
        self.process_cpu_s = 0.0
        self.scratch_s = 0.0
        self.capture_s = 0.0
        self.slowest = ("", 0.0)
        self.mesh: Optional[dict] = None
        self.ranks: dict[int, dict] = {}

    @property
    def warming(self) -> bool:
        return self.state == "warming"

    @property
    def failed(self) -> bool:
        return self.state == "error"

    def to_dict(self) -> dict:
        return {
            "state": self.state,
            "lattice_size": self.lattice_size,
            "built": self.built,
            "fills": self.fills,
            "loads": self.loads,
            "errors": self.errors,
            "wall_s": round(self.wall_s, 3),
            "detail": self.detail,
            "library_s": round(self.library_s, 3),
            "captures": self.captures,
            "reserved_before": self.reserved_before,
            "reserved_after": self.reserved_after,
            "queue_s": round(self.queue_s, 3),
            "run_s": round(self.run_s, 3),
            "run_cpu_s": round(self.run_cpu_s, 3),
            "process_cpu_s": round(self.process_cpu_s, 3),
            "scratch_s": round(self.scratch_s, 3),
            "capture_s": round(self.capture_s, 3),
            "slowest": [self.slowest[0], round(self.slowest[1], 3)],
            "mesh": self.mesh,
            "ranks": {str(r): {"library_s": round(v["library_s"], 3), "built": v["built"],
                               "run_s": round(v["run_s"], 3)}
                      for r, v in sorted(self.ranks.items())},
        }


def _reserved(engine) -> int:
    if engine.device.type != "cuda":
        return 0
    import torch

    return int(torch.cuda.memory_reserved(engine.device))


def _timed(build: Callable) -> Callable:
    """``build`` returning when it started and the CPU seconds its thread
    used."""
    def point():
        t, cpu = time.perf_counter(), time.thread_time()
        build()
        return t, time.thread_time() - cpu

    return point


def _point_runner(engine, run: Optional[Callable]) -> Callable:
    """``build -> (started, thread CPU seconds[, each rank's readings])``:
    one point on one device (``build()`` through ``run``, or here), or on
    every rank of a mirrored engine (rank 0's ticket), whose ranks'
    readings the caller folds into the state's ``ranks``."""
    if not engine.mirrored:
        return lambda build: _timed(build)() if run is None else run(_timed(build),
                                                                        timeout=POINT_TIMEOUT_S)

    def on_mesh(build):
        got = (build() if run is None
               else engine.run_verb("warm", timeout=POINT_TIMEOUT_S, **build.keywords))
        return got["started"], got["cpu_s"], got["ranks"]

    return on_mesh


def warmup_engine(
    engine,
    state: Optional[WarmupState] = None,
    variants: str = "minimal",
    run: Optional[Callable] = None,
) -> WarmupState:
    """Load the kernel library and warm the engine's shape lattice through
    its compile cache.  ``run(fn)`` runs one point on the engine's thread
    (``engine.run_task``; on a mirrored engine each point then goes through
    ``engine.run_verb``); None runs it here, for a caller that drives the
    engine itself.  Returns the (possibly caller-provided) WarmupState,
    ``state.state`` in ready | error."""
    st = state if state is not None else WarmupState()
    cache = engine.compile_cache
    if cache is None:
        st.state = "ready"
        st.detail = "no compile cache attached; nothing to warm"
        return st
    t0 = time.perf_counter()
    st.state = "warming"
    st.started_at = time.time()
    if engine.mirrored:
        st.mesh = {a: n for a, n in engine.mesh.shape.items() if n > 1}
    fills0, loads0 = cache.fills, cache.loads
    if engine.device.type == "cuda":
        from ..ops import _build

        try:
            _build.lib(cache)
        except Exception as e:  # noqa: BLE001 - reported as the state; a kernel call raises again
            st.state = "error"
            st.detail = f"kernel library: {e}"[:300]
            st.wall_s = time.perf_counter() - t0
            log.exception("warm-up: the kernel library could not be built")
            return st
        st.library_s = engine.library_s = time.perf_counter() - t0
    st.fills = cache.fills - fills0
    st.loads = cache.loads - loads0
    try:
        sigs = engine.aot_signatures(variants=variants)
    except Exception as e:  # noqa: BLE001 - a broken lattice must not keep the pod unready
        st.state = "error"
        st.detail = f"lattice enumeration failed: {e}"[:300]
        log.exception("warm-up: lattice enumeration failed")
        return st
    st.lattice_size = len(sigs)
    st.reserved_before = _reserved(engine)
    captured0 = engine.graphs_captured
    scratch0, capture0 = engine.graph_warmup_s, engine.graph_capture_s
    cpu0 = time.process_time()
    run_point = _point_runner(engine, run)
    for label, build in sigs:
        t = time.perf_counter()
        try:
            started, cpu, *ranks = run_point(build)
            ran = time.perf_counter() - started
            st.queue_s += started - t
            st.run_s += ran
            st.run_cpu_s += cpu
            if ran > st.slowest[1]:
                st.slowest = (label, ran)
            st.built += 1
            for r, got in (ranks[0] if ranks else {}).items():
                rs = st.ranks.setdefault(int(r), {"library_s": 0.0, "built": 0, "run_s": 0.0})
                rs["library_s"] = got["library_s"]
                rs["built"] += 1
                rs["run_s"] += got["run_s"]
        except Exception as e:  # noqa: BLE001 - one device: skipped, built at first use
            st.errors += 1
            log.warning("warm-up: %s failed: %s", label, e)
            if engine.mirrored:  # the ranks' warm-up ended with it (``_warm_task``)
                st.state = "error"
                st.detail = f"{label}: {e}"[:300]
                st.wall_s = time.perf_counter() - t0
                return st
        log.debug("warm-up: %s in %.3f s", label, time.perf_counter() - t)
        st.captures = engine.graphs_captured - captured0
        st.wall_s = time.perf_counter() - t0
    st.process_cpu_s = time.process_time() - cpu0
    st.scratch_s = engine.graph_warmup_s - scratch0
    st.capture_s = engine.graph_capture_s - capture0
    st.reserved_after = _reserved(engine)
    st.wall_s = time.perf_counter() - t0
    st.state = "ready"
    st.detail = (f"{st.built}/{st.lattice_size} lattice points warm "
                 + (f"on every rank of {st.mesh} " if st.mesh else "")
                 + f"({st.captures} graphs captured; library: {st.fills} built, "
                 f"{st.loads} loaded) in {st.wall_s:.2f}s")
    WARMUP_SECONDS.set(value=st.wall_s)
    log.info("warm-up: %s", st.detail)
    return st


def start_warmup_thread(engine, state: WarmupState, variants: str = "minimal"
                        ) -> threading.Thread:
    """Run ``warmup_engine`` on a daemon thread, each point on the engine
    loop's thread: the HTTP server is already up and answering ``/healthz``
    503 {warming} while the lattice builds, which is the whole
    readiness-gating contract."""
    state.state = "warming"  # visible before the thread's first slice
    t = threading.Thread(
        target=warmup_engine,
        args=(engine, state),
        kwargs={"variants": variants, "run": engine.run_task},
        name="compile-warmup",
        daemon=True,
    )
    t.start()
    return t
