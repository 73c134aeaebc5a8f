"""Prometheus-style metrics for a serving replica (text exposition,
stdlib only).

Own copy of the part of ``elastic_gpu_scheduler_tpu/metrics`` that a
serving replica uses: the metric types, the registry behind ``/metrics``
and the series a replica exports, under the reference's names, help texts
and label sets, so the reference's dashboards and fleet tooling read a port
replica as a JAX one.  The serving series (``tpu_serve_*``) are registered
by ``server/inference.py`` and the SLO and profile series by ``slo/`` and
``profile/``, as in the reference; the warm-start plane's two series
(``compilecache/``) are here, as they are there.  The scheduler's series and its
lock-wait instrumentation are control-plane code and stay there.
"""

from __future__ import annotations

import threading
from typing import Iterable


class Counter:
    def __init__(self, name: str, help_: str, label_names: tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._values: dict[tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def inc(self, *labels: str, value: float = 1.0) -> None:
        with self._lock:
            self._values[labels] = self._values.get(labels, 0.0) + value

    def reset(self) -> None:
        """Drop every label series (a scrape-time gauge rebuilt each scrape
        must not keep a vanished label at a stale value)."""
        with self._lock:
            self._values.clear()

    def collect(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} counter"
        with self._lock:
            for labels, v in sorted(self._values.items()):
                yield f"{self.name}{_fmt_labels(self.label_names, labels)} {v}"


class Gauge(Counter):
    def set(self, *labels: str, value: float) -> None:
        with self._lock:
            self._values[labels] = value

    def replace(self, values: dict[tuple[str, ...], float]) -> None:
        """Swap the whole series set under one lock: a racing collect sees
        the old set or the new one, never a cleared, unfilled one."""
        with self._lock:
            self._values = dict(values)

    def collect(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} gauge"
        with self._lock:
            for labels, v in sorted(self._values.items()):
                yield f"{self.name}{_fmt_labels(self.label_names, labels)} {v}"


def _exact_quantile(sorted_samples: list, q: float) -> float:
    """Nearest-rank quantile over an ascending list."""
    if not sorted_samples:
        return 0.0
    n = len(sorted_samples)
    return sorted_samples[min(n - 1, max(0, int(q * n + 0.5) - 1))]


DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
)


class Histogram:
    def __init__(self, name: str, help_: str, label_names: tuple[str, ...] = (),
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple[str, ...], list[int]] = {}
        self._sums: dict[tuple[str, ...], float] = {}
        self._totals: dict[tuple[str, ...], int] = {}
        self._lock = threading.Lock()

    def observe(self, *labels: str, value: float) -> None:
        self.observe_batch(*labels, values=[value])

    def observe_batch(self, *labels: str, values: list) -> None:
        """Fold many observations under one lock acquisition."""
        if not values:
            return
        with self._lock:
            counts = self._counts.setdefault(labels, [0] * len(self.buckets))
            for v in values:
                for i, b in enumerate(self.buckets):
                    if v <= b:
                        counts[i] += 1
            self._sums[labels] = self._sums.get(labels, 0.0) + sum(values)
            self._totals[labels] = self._totals.get(labels, 0) + len(values)

    def collect(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} histogram"
        with self._lock:
            for labels in sorted(self._counts):
                le = self.label_names + ("le",)
                for b, c in zip(self.buckets, self._counts[labels]):
                    yield f"{self.name}_bucket{_fmt_labels(le, labels + (repr(float(b)),))} {c}"
                yield (f"{self.name}_bucket{_fmt_labels(le, labels + ('+Inf',))} "
                       f"{self._totals[labels]}")
                yield (f"{self.name}_sum{_fmt_labels(self.label_names, labels)} "
                       f"{self._sums[labels]}")
                yield (f"{self.name}_count{_fmt_labels(self.label_names, labels)} "
                       f"{self._totals[labels]}")


def _fmt_labels(names: tuple[str, ...], values: tuple[str, ...]) -> str:
    if not names:
        return ""
    return "{" + ",".join(f'{n}="{v}"' for n, v in zip(names, values)) + "}"


class LazyGauge(Gauge):
    """A gauge its ``refresher`` recomputes at collect time, so the scraper
    pays the computation, never the serving path.  Refreshes are single
    flight: a scraper that waited for a running refresh exports its values
    without running the refresher again."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.refresher = None
        self._refresh_lock = threading.Lock()
        self._refresh_gen = 0

    def collect(self):
        r = self.refresher
        if r is not None:
            gen0 = self._refresh_gen
            with self._refresh_lock:
                if self._refresh_gen == gen0:
                    try:
                        r()
                    except Exception:
                        pass  # a broken refresher must not break /metrics
                    self._refresh_gen = gen0 + 1
        yield from super().collect()


class Registry:
    def __init__(self):
        self._metrics: list = []
        self._lock = threading.Lock()

    def register(self, m):
        with self._lock:
            self._metrics.append(m)
        return m

    def expose(self) -> str:
        lines = []
        with self._lock:
            for m in self._metrics:
                lines.extend(m.collect())
        return "\n".join(lines) + "\n"


REGISTRY = Registry()

METRICS_DROPPED = REGISTRY.register(
    Counter(
        "tpu_metrics_dropped_samples_total",
        "Samples discarded by bounded buffers, by reason: waits_cap = a "
        "TimedLock's wait buffer trimmed with nothing scraping "
        "LOCK_WAIT; orphan_cap = a dying lock's parked waits dropped at "
        "the 4096-entry orphan-list cap; trace_pin_cap = a pinned "
        "trace's parked span evicted at the tracer's pinned-span cap "
        "(an open pod trace or pinned stream outgrew the protected "
        "store).  Non-zero values mean the corresponding histograms/"
        "traces UNDERSTATE reality by that many samples",
        ("reason",),
    )
)
KV_PAGES_RESIDENT = REGISTRY.register(
    Gauge(
        "tpu_kv_pages_resident",
        "Serving-engine KV page pool residency by kind, set at scrape "
        "time from live engine state: active (referenced by live "
        "slots), cached (prefix-cache registered, LRU-evictable), free",
        ("kind",),
    )
)
KV_PAGES_SHIPPED = REGISTRY.register(
    Gauge(
        "tpu_kv_pages_shipped",
        "Monotonic count of KV pages shipped replica-to-replica over "
        "the disaggregated data plane, by direction (exported/"
        "imported); exposed at scrape time from the engine's counters "
        "(the tpu_serve_spills stance)",
        ("direction",),
    )
)
KV_PREFIX_ADMISSIONS = REGISTRY.register(
    Gauge(
        "tpu_kv_prefix_admissions",
        "Monotonic admission-level prefix-cache outcomes (hit = at "
        "least one full cached page attached at admission, incl. "
        "adopted pages; miss = prefill from scratch), set at scrape "
        "time from engine counters",
        ("result",),
    )
)
KV_MIGRATIONS = REGISTRY.register(
    Counter(
        "tpu_kv_migrations_total",
        "Live KV session migrations by outcome: out (handoff accepted, "
        "continuation relayed), out_refused (destination refused — "
        "session resumed locally, exact), in (session adopted from a "
        "peer), shed (autoscaler-commanded rebalance executed), "
        "shed_failed",
        ("result",),
    )
)
POLICY_EVALS = REGISTRY.register(
    Counter(
        "tpu_policy_evals_total",
        "Hot-loaded policy evaluations by verb (score/filter/preempt/"
        "defrag/kv) and outcome: ok, fault (budget trip / deadline / "
        "math fault → fell back to the incumbent built-in), or — for "
        "canary score decisions — the arm that decided (candidate/"
        "incumbent)",
        ("verb", "outcome"),
    )
)
POLICY_EVENTS = REGISTRY.register(
    Counter(
        "tpu_policy_events_total",
        "Policy-plane lifecycle events: load, gate_pass, gate_block "
        "(replay gate refused a worse candidate), promote, rollback "
        "(operator or automatic SLO rollback), fault",
        ("event",),
    )
)
# the reference's help texts (dashboards key on them); in the port a "hit"
# is a decode graph replayed, a "miss" a graph captured or the kernel
# library built, "load" / "fill" the library's entry, and "fallback" is 0
COMPILE_CACHE_EVENTS = REGISTRY.register(
    Counter(
        "tpu_compile_cache_events_total",
        "Warm-start compile cache events: hit (in-memory executable "
        "reused), load (persistent entry deserialized — no lowering), "
        "miss (lower+compile paid), fill (entry persisted to the cache "
        "dir), coalesced (concurrent miss parked behind the "
        "single-flight winner), quarantined (corrupt entry moved aside, "
        "recompiled), persist_error (serialize/write failed — compile "
        "still served), fallback (AOT path error → jit dispatch)",
        ("event",),
    )
)
WARMUP_SECONDS = REGISTRY.register(
    Gauge(
        "tpu_warmup_seconds",
        "Wall time of the shape-lattice pre-lowering phase at pod start "
        "(0 until a warm-up has completed); the window the pod reports "
        "healthz 503 {warming:true} and the fleet router keeps it out "
        "of rotation",
    )
)
