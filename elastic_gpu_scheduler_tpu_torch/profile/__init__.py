"""Workload profiles of a serving replica.

Own copy of the part of ``elastic_gpu_scheduler_tpu/profile`` that a
serving replica runs, with the reference's knob (``--profile-sample`` /
``TPU_PROFILE_SAMPLE``, default on), identity (``--workload-class`` /
``TPU_WORKLOAD_CLASS``, ``TPU_COTENANT_CLASSES``), series and
``/debug/profiles`` shape:

- **Samples.**  The engine loop brackets each engine step with host
  counters only (a clock read and ``tokens_emitted``) and calls
  :meth:`WorkloadProfiler.record_step`: a stride check and one list
  append.  Nothing here touches the device.
- **Profiles.**  On a reader thread (scrape, ``/debug/profiles``) samples
  fold into per-class profiles: EWMA tokens/s per chip keyed by the
  accelerator generation, reservoir-sampled step latency quantiles,
  occupancy, host gap, queue depth and KV-page means.
- **Interference.**  A replica that knows its co-tenants' classes
  (``TPU_COTENANT_CLASSES``) folds its throughput into a (class,
  neighbour) matrix against its solo throughput.
- **Chip occupancy.**  The device plugin's ``Allocate`` records one
  sample a card (:meth:`WorkloadProfiler.record_chip`: the core units the
  container got of it, keyed by the caller's trace id), folded into
  per-card utilization (``chip_occupancy`` on ``/debug/profiles``).

The scheduler's co-tenancy map and journal records are control-plane code
and stay in the reference.
"""

from __future__ import annotations

import os
import random
import threading
from typing import Optional

from ..metrics import REGISTRY, Counter, Histogram, LazyGauge, _exact_quantile

__all__ = ["DEFAULT_WORKLOAD_CLASS", "PROFILER", "WorkloadProfiler", "configure_from_env"]

# pods without the elasticgpu.io/workload-class annotation profile here
DEFAULT_WORKLOAD_CLASS = "default"

PROFILE_TOKENS = REGISTRY.register(
    LazyGauge(
        "tpu_workload_tokens_per_sec",
        "Measured per-class decode throughput in tokens/s per chip, EWMA "
        "over profiled engine steps, keyed by workload class (the "
        "elasticgpu.io/workload-class pod annotation) and TPU generation "
        "— the Gavel-style throughput-per-accelerator-type table, "
        "refreshed at scrape time from the profile buffers",
        ("wclass", "generation"),
    )
)
INTERFERENCE_RATIO = REGISTRY.register(
    LazyGauge(
        "tpu_interference_slowdown_ratio",
        "Co-located vs solo throughput ratio per (class, neighbor-class) "
        "pair for fractional tenants sharing a chip (1.0 = no measured "
        "contention, 0.5 = this class runs at half speed next to that "
        "neighbor) — the contention matrix a profile-aware rater "
        "consumes",
        ("wclass", "neighbor"),
    )
)
PROFILE_STEP_SECONDS = REGISTRY.register(
    Histogram(
        "tpu_workload_step_seconds",
        "Profiled engine step wall time per workload class (folded from "
        "the sample ring at scrape time)",
        ("wclass",),
    )
)
PROFILE_SAMPLES = REGISTRY.register(
    Counter(
        "tpu_profile_samples_total",
        "Profile samples folded into aggregates, by kind (step = engine "
        "step samples, chip = device-plugin occupancy samples)",
        ("kind",),
    )
)
PROFILE_DROPPED = REGISTRY.register(
    Counter(
        "tpu_profile_dropped_samples_total",
        "Profile samples discarded because the raw ring buffer hit its "
        "cap with no reader folding it — non-zero means profiles "
        "UNDERSTATE activity by that many samples",
        ("kind",),
    )
)


class _Ewma:
    """Exponentially weighted moving average; the first observation seeds."""

    __slots__ = ("value", "n")

    def __init__(self):
        self.value = 0.0
        self.n = 0

    def update(self, x: float, alpha: float) -> None:
        self.n += 1
        if self.n == 1:
            self.value = float(x)
        else:
            self.value += alpha * (float(x) - self.value)


class _Reservoir:
    """Algorithm-R reservoir: a bounded uniform sample of a stream, with a
    fixed seed so profiles are reproducible."""

    __slots__ = ("k", "n", "samples", "_rng")

    def __init__(self, k: int, seed: int = 0xC0FFEE):
        self.k = k
        self.n = 0
        self.samples: list[float] = []
        self._rng = random.Random(seed)

    def add(self, x: float) -> None:
        self.n += 1
        if len(self.samples) < self.k:
            self.samples.append(float(x))
            return
        j = self._rng.randrange(self.n)
        if j < self.k:
            self.samples[j] = float(x)

    def quantiles(self, qs=(0.5, 0.95, 0.99)) -> list[float]:
        s = sorted(self.samples)
        return [_exact_quantile(s, q) for q in qs]


class _ClassProfile:
    """One workload class's aggregates (mutated under the fold lock)."""

    __slots__ = ("tput", "latency", "occupancy", "host_gap_ms", "queue_depth", "hbm_pages",
                 "samples", "tokens")

    def __init__(self, reservoir_k: int):
        self.tput: dict[str, _Ewma] = {}  # generation → tokens/s per chip
        self.latency = _Reservoir(reservoir_k)
        self.occupancy = _Ewma()  # active slots / max_batch
        self.host_gap_ms = _Ewma()
        self.queue_depth = _Ewma()
        self.hbm_pages = _Ewma()  # KV pages in use
        self.samples = 0
        self.tokens = 0

    def as_dict(self) -> dict:
        p50, p95, p99 = self.latency.quantiles()
        return {
            "tokens_per_sec_per_chip": {gen: round(e.value, 3)
                                        for gen, e in sorted(self.tput.items())},
            "step_ms": {"p50": round(p50 * 1e3, 3), "p95": round(p95 * 1e3, 3),
                        "p99": round(p99 * 1e3, 3)},
            "slot_occupancy": round(self.occupancy.value, 4),
            "host_gap_ms": round(self.host_gap_ms.value, 4),
            "queue_depth": round(self.queue_depth.value, 3),
            "hbm_pages": round(self.hbm_pages.value, 2),
            "samples": self.samples,
            "tokens": self.tokens,
        }


class WorkloadProfiler:
    """Per-class profiles of this replica's engine steps.  The hot path
    (:meth:`record_step`) is a stride check and one append; folding runs
    under ``_fold_lock`` on reader threads."""

    def __init__(self):
        self.enabled = False
        self.sample = 0.0
        self.stride = 1
        self.ewma_alpha = 0.2
        self.reservoir_k = 512
        self._cap = 20000  # the raw ring's bound
        # who this process's engine is (serve sets it); a sample without
        # its own identity takes this one
        self._id_pod = ""
        self._id_class = DEFAULT_WORKLOAD_CLASS
        self._id_generation = "unknown"
        self._id_chips = 1
        self._id_neighbors: tuple[str, ...] = ()
        self._step_buf: list[tuple] = []
        self._chip_buf: list[tuple] = []
        self._step_n = 0  # the stride counter
        self.dropped_steps = 0
        self.dropped_chips = 0
        self._fold_lock = threading.Lock()
        self._profiles: dict[str, _ClassProfile] = {}
        self._solo: dict[str, _Ewma] = {}  # class → solo tokens/s per chip
        self._pairs: dict[tuple[str, str], _Ewma] = {}  # (class, neighbour) → co-located
        self._chip_occ: dict[tuple[str, str], dict] = {}  # (node, coord)
        self._folded = {"step": 0, "chip": 0}
        # one gauge carries the refresher: one run rebuilds both series sets
        PROFILE_TOKENS.refresher = self._refresh_gauges

    # -- lifecycle -----------------------------------------------------------

    def configure(self, sample: float = 1.0, ewma_alpha: float = 0.2,
                  reservoir_k: int = 512) -> None:
        """Enable (sample > 0) or disable profiling.  ``sample`` is a step
        rate: 1.0 profiles every engine step, 0.25 every 4th (a stride, so
        the hot path draws no random number)."""
        self.sample = max(0.0, min(1.0, float(sample)))
        self.stride = max(1, round(1.0 / self.sample)) if self.sample else 1
        self.ewma_alpha = min(1.0, max(0.001, float(ewma_alpha)))
        self.reservoir_k = max(16, int(reservoir_k))
        self.enabled = self.sample > 0.0

    def set_identity(self, pod: str = "", wclass: str = DEFAULT_WORKLOAD_CLASS,
                     generation: str = "unknown", chips: int = 1,
                     neighbors: tuple[str, ...] = ()) -> None:
        """Who this process's serving engine is: pod key, workload class,
        accelerator generation, chip count, and the classes of its
        co-tenants when it knows them (``TPU_COTENANT_CLASSES``)."""
        self._id_pod = pod
        self._id_class = wclass or DEFAULT_WORKLOAD_CLASS
        self._id_generation = generation or "unknown"
        self._id_chips = max(1, int(chips))
        self._id_neighbors = tuple(neighbors)

    def reset(self) -> None:
        """Drop every buffer and aggregate (tests)."""
        with self._fold_lock:
            del self._step_buf[:]
            del self._chip_buf[:]
            self._step_n = 0
            self.dropped_steps = self.dropped_chips = 0
            self._profiles.clear()
            self._solo.clear()
            self._pairs.clear()
            self._chip_occ.clear()
            self._folded = {"step": 0, "chip": 0}

    # -- hot path ------------------------------------------------------------

    def record_step(
        self,
        tokens: int,
        wall_s: float,
        slots_active: int = 0,
        slots_total: int = 1,
        host_gap_ms: float = 0.0,
        queue_depth: int = 0,
        hbm_pages: int = 0,
        pod: Optional[str] = None,
        wclass: Optional[str] = None,
        generation: Optional[str] = None,
        chips: Optional[int] = None,
        neighbors: Optional[tuple] = None,
    ) -> bool:
        """One engine-step sample; True when captured (else stride-skipped).
        Callers pass host counters only, so decode makes no extra
        host-to-device upload for it."""
        if not self.enabled:
            return False
        self._step_n += 1
        if self._step_n % self.stride:
            return False
        if neighbors is None:
            neighbors = self._id_neighbors
        buf = self._step_buf
        buf.append((
            pod if pod is not None else self._id_pod,
            wclass if wclass is not None else self._id_class,
            generation if generation is not None else self._id_generation,
            chips if chips is not None else self._id_chips,
            tuple(neighbors),
            int(tokens), float(wall_s), int(slots_active), max(1, int(slots_total)),
            float(host_gap_ms), int(queue_depth), int(hbm_pages),
        ))
        if len(buf) > self._cap and self._fold_lock.acquire(blocking=False):
            # nothing is folding: trim, and count the drop
            try:
                n = self._cap // 2
                del buf[:n]
                self.dropped_steps += n
            finally:
                self._fold_lock.release()
        return True

    def record_chip(self, node: str, coord: str, core_units: int, core_total: int,
                    tenant: str = "") -> None:
        """Per-chip occupancy sample from the device-plugin path (one
        append; folded into per-chip utilization for /debug/profiles)."""
        if not self.enabled:
            return
        buf = self._chip_buf
        buf.append((node, coord, int(core_units), max(1, int(core_total)), tenant or ""))
        if len(buf) > self._cap and self._fold_lock.acquire(blocking=False):
            try:
                n = self._cap // 2
                del buf[:n]
                self.dropped_chips += n
            finally:
                self._fold_lock.release()

    # -- fold path (reader threads) ------------------------------------------

    def _fold(self) -> None:
        """Drain the raw ring into the aggregates (slice-then-del is safe
        against appends at the tail)."""
        with self._fold_lock:
            n = len(self._step_buf)
            steps = self._step_buf[:n]
            del self._step_buf[:n]
            m = len(self._chip_buf)
            chips = self._chip_buf[:m]
            del self._chip_buf[:m]
            alpha = self.ewma_alpha
            lat_batches: dict[str, list[float]] = {}
            for (_pod, wclass, gen, nchips, neighbors, tokens, wall_s, active, total, gap_ms,
                 qdepth, pages) in steps:
                prof = self._profiles.get(wclass)
                if prof is None:
                    prof = self._profiles[wclass] = _ClassProfile(self.reservoir_k)
                tps = (tokens / wall_s / max(1, nchips)) if wall_s > 0 else 0.0
                prof.tput.setdefault(gen, _Ewma()).update(tps, alpha)
                prof.latency.add(wall_s)
                prof.occupancy.update(active / total, alpha)
                prof.host_gap_ms.update(gap_ms, alpha)
                prof.queue_depth.update(qdepth, alpha)
                prof.hbm_pages.update(pages, alpha)
                prof.samples += 1
                prof.tokens += tokens
                lat_batches.setdefault(wclass, []).append(wall_s)
                # interference: solo throughput, or co-located with each
                # known neighbour class
                if tokens or wall_s:
                    if not neighbors:
                        self._solo.setdefault(wclass, _Ewma()).update(tps, alpha)
                    for nc in neighbors:
                        self._pairs.setdefault((wclass, nc), _Ewma()).update(tps, alpha)
            for (node, coord, units, total, tenant) in chips:
                occ = self._chip_occ.setdefault(
                    (node, coord), {"util": _Ewma(), "samples": 0, "tenants": set()})
                occ["util"].update(units / total, alpha)
                occ["samples"] += 1
                if tenant:
                    occ["tenants"].add(tenant)
                    if len(occ["tenants"]) > 16:
                        occ["tenants"].pop()
            self._folded["step"] += n
            self._folded["chip"] += m
            dropped, self.dropped_steps = self.dropped_steps, 0
            dropped_chips, self.dropped_chips = self.dropped_chips, 0
        # the metric series outside the fold lock (their own locks suffice)
        if n:
            PROFILE_SAMPLES.inc("step", value=float(n))
        if m:
            PROFILE_SAMPLES.inc("chip", value=float(m))
        for wclass, vals in lat_batches.items():
            PROFILE_STEP_SECONDS.observe_batch(wclass, values=vals)
        if dropped:
            PROFILE_DROPPED.inc("step", value=float(dropped))
        if dropped_chips:
            PROFILE_DROPPED.inc("chip", value=float(dropped_chips))

    # -- read APIs -----------------------------------------------------------

    def profiles(self) -> dict:
        """Per-class profiles (folds first)."""
        self._fold()
        with self._fold_lock:
            return self._profiles_locked()

    def _profiles_locked(self) -> dict:
        return {cls: prof.as_dict() for cls, prof in sorted(self._profiles.items())}

    def interference_matrix(self) -> dict:
        """{class: {neighbour: ratio}}: co-located over solo tokens/s per
        chip, once both regimes were seen (below 1 is a slowdown)."""
        self._fold()
        with self._fold_lock:
            return self._matrix_locked()

    def _matrix_locked(self) -> dict:
        out: dict[str, dict[str, float]] = {}
        for (cls, ncls), co in sorted(self._pairs.items()):
            solo = self._solo.get(cls)
            if solo is None or solo.value <= 0 or co.n == 0:
                continue
            out.setdefault(cls, {})[ncls] = round(co.value / solo.value, 4)
        return out

    def debug_state(self) -> dict:
        """The ``/debug/profiles`` payload (folds first).  ``tenancy`` is
        the scheduler's and stays empty here."""
        self._fold()
        with self._fold_lock:
            profiles = self._profiles_locked()
            matrix = self._matrix_locked()
            chip_occ = {
                f"{node}/{coord}": {"core_util": round(occ["util"].value, 4),
                                    "samples": occ["samples"],
                                    "tenants": sorted(occ["tenants"])}
                for (node, coord), occ in sorted(self._chip_occ.items())
            }
            folded = dict(self._folded)
            pending = len(self._step_buf) + len(self._chip_buf)
            solo = {cls: round(e.value, 3) for cls, e in sorted(self._solo.items())}
        return {
            "enabled": self.enabled,
            "sample": self.sample,
            "identity": {"pod": self._id_pod, "class": self._id_class,
                         "generation": self._id_generation, "chips": self._id_chips},
            "folded": folded,
            "pending": pending,
            "journal_records": 0,  # a replica writes no journal
            "profiles": profiles,
            "solo_tokens_per_sec_per_chip": solo,
            "interference": matrix,
            "chip_occupancy": chip_occ,
            "tenancy": {},
        }

    # -- metrics export (the LazyGauge refresher; scrape time only) ----------

    def _refresh_gauges(self) -> None:
        self._fold()
        with self._fold_lock:
            profiles = self._profiles_locked()
            matrix = self._matrix_locked()
        tokens = {(cls, gen): tps for cls, p in profiles.items()
                  for gen, tps in p["tokens_per_sec_per_chip"].items()}
        ratios = {(cls, ncls): ratio for cls, row in matrix.items()
                  for ncls, ratio in row.items()}
        PROFILE_TOKENS.replace(tokens)
        INTERFERENCE_RATIO.replace(ratios)


def configure_from_env() -> None:
    """Apply ``TPU_PROFILE_SAMPLE``: unset means 1.0 (a sample costs one
    append), 0 disables."""
    raw = os.environ.get("TPU_PROFILE_SAMPLE", "1")
    try:
        PROFILER.configure(sample=float(raw))
    except ValueError:
        PROFILER.configure(sample=1.0)


PROFILER = WorkloadProfiler()
configure_from_env()
