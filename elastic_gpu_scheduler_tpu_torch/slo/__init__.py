"""The replica side of the SLO plane: request journeys, error budgets,
burn rate.

Own copy of the part of ``elastic_gpu_scheduler_tpu/slo`` that a serving
replica runs, with the reference's config format (``--slo-config`` /
``TPU_SLO_CONFIG``), ``tpu_slo_*`` series and ``/debug/slo`` shape:

- **Journeys.**  The HTTP front end records each request's own vantage
  (``vantage="replica"``: queue wait, TTFT, time per token, e2e) with
  :meth:`SloPlane.record_journey`: one list append behind an ``enabled``
  check, the raw ring capped with the drop counted
  (``tpu_slo_dropped_samples_total``).  Folding into per-class sliding
  windows happens on reader threads (scrape, ``/debug/slo``).
- **Objectives and burn rate.**  Per class, ``<metric>_p<NN>_ms`` declares
  that NN% of journeys see <metric> at most that many ms, and
  ``availability`` the ok fraction.  The error budget is ``1 - target``;
  the burn rate over a window is the violating fraction over the budget.
  Burn counts only the router vantage (one journey must not count twice
  when both vantages record it), so a bare replica shows its percentiles
  and journey counts, and burn 0.  A breach needs both windows past
  ``burn_threshold`` with ``min_samples`` journeys in the short one.

The reference's journal records of loads and breaches, its breach hooks,
the background evaluation ticker and the autoscaler's scaling input are
control-plane code and stay there.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional

from ..metrics import REGISTRY, Counter, LazyGauge, _exact_quantile

__all__ = [
    "SLO",
    "SloObjective",
    "SloPlane",
    "configure_from_env",
    "load_config_source",
    "parse_objectives",
]

# latency metrics a journey can carry (availability is derived from ok)
LATENCY_METRICS = ("ttft", "tpot", "e2e", "queue", "hop")

SLO_LATENCY = REGISTRY.register(
    LazyGauge(
        "tpu_slo_latency_ms",
        "Per-class request-journey latency percentiles over the short "
        "SLO window, in ms, by metric (ttft/tpot/e2e/queue/hop) and "
        "quantile (p50/p95/p99) — folded from the journey ring at "
        "scrape time, the client-perceived numbers the declared "
        "objectives are judged against",
        ("wclass", "metric", "quantile"),
    )
)
SLO_BURN = REGISTRY.register(
    LazyGauge(
        "tpu_slo_burn_rate",
        "Error-budget burn rate per declared objective and window "
        "(short/long): violating fraction over the window divided by "
        "the objective's error budget (1 - target).  1.0 = consuming "
        "budget exactly as fast as sustainable; a breach journals when "
        "BOTH windows exceed the configured threshold",
        ("wclass", "objective", "window"),
    )
)
SLO_BREACHED = REGISTRY.register(
    LazyGauge(
        "tpu_slo_breached",
        "1 while the (class, objective) pair is in a journaled breach "
        "(multi-window burn above threshold), 0 once recovered — the "
        "alerting surface; the journaled `slo` record carries the "
        "exemplar trace ids",
        ("wclass", "objective"),
    )
)
SLO_EVENTS = REGISTRY.register(
    Counter(
        "tpu_slo_events_total",
        "SLO-plane lifecycle events: breach (burn alert tripped, "
        "journaled with exemplars), recover, objectives_loaded",
        ("event",),
    )
)
SLO_RECORDS = REGISTRY.register(
    Counter(
        "tpu_slo_records_total",
        "Request-journey records folded into the SLO windows, by "
        "vantage (router = client-perceived, replica = server-side)",
        ("vantage",),
    )
)
SLO_DROPPED = REGISTRY.register(
    Counter(
        "tpu_slo_dropped_samples_total",
        "Journey records discarded because the raw ring hit its cap "
        "with no reader folding it — non-zero means the SLO windows "
        "UNDERSTATE traffic by that many requests",
        ("reason",),
    )
)


def _num(val, what: str) -> float:
    """A config value as a float, any bad value as ValueError (float(None)
    raises TypeError, which would escape the config error handlers)."""
    try:
        return float(val)
    except (TypeError, ValueError):
        raise ValueError(f"{what} must be a number, got {val!r}") from None


class SloObjective:
    """One declared objective: ``target`` fraction of journeys must be
    good.  ``key`` is the config spelling (``ttft_p95_ms``,
    ``availability``), kept verbatim in labels and ``/debug/slo``."""

    __slots__ = ("metric", "target", "threshold_ms", "key")

    def __init__(self, metric: str, target: float, threshold_ms: Optional[float] = None,
                 key: Optional[str] = None):
        if metric != "availability" and metric not in LATENCY_METRICS:
            raise ValueError(f"unknown SLO metric {metric!r}")
        target = _num(target, "SLO target")
        if not 0.0 < target < 1.0:
            raise ValueError(
                f"SLO target must be in (0, 1), got {target} — a target "
                "of 1.0 has zero error budget and every request is a page"
            )
        if metric != "availability":
            threshold_ms = _num(threshold_ms, f"latency objective {metric!r} threshold")
            if threshold_ms <= 0:
                raise ValueError(f"latency objective {metric!r} needs a positive threshold_ms")
            self.key = key or f"{metric}_p{target * 100:g}_ms"
        else:
            self.key = key or "availability"
        self.metric = metric
        self.target = target
        self.threshold_ms = float(threshold_ms) if threshold_ms is not None else None

    @property
    def budget(self) -> float:
        return 1.0 - self.target

    def violated(self, journey: tuple) -> Optional[bool]:
        """The verdict on one journey, or None when it carries no value for
        this metric (a blocking completion has no time per token)."""
        if self.metric == "availability":
            return not journey[_J_OK]
        v = journey[_J_METRIC_IDX[self.metric]]
        if v is None:
            return None
        return v > self.threshold_ms

    def to_dict(self) -> dict:
        return {"metric": self.metric, "target": self.target,
                "threshold_ms": self.threshold_ms}


def parse_objectives(spec: dict) -> list[SloObjective]:
    """One class's config dict → objectives; an unknown key is an error (a
    typo'd objective that never alerts is the worst outcome)."""
    out: list[SloObjective] = []
    for key, val in sorted(spec.items()):
        if key == "availability":
            out.append(SloObjective("availability", _num(val, key)))
            continue
        parts = key.split("_")
        if (len(parts) == 3 and parts[0] in LATENCY_METRICS and parts[1].startswith("p")
                and parts[2] == "ms"):
            try:
                pct = float(parts[1][1:])
            except ValueError:
                raise ValueError(f"bad SLO objective key {key!r}")
            # the declared spelling is the objective's identity (p99.5
            # stays p99.5)
            out.append(SloObjective(parts[0], pct / 100.0, _num(val, key), key=key))
            continue
        raise ValueError(
            f"unknown SLO objective key {key!r} (want "
            "<ttft|tpot|e2e|queue|hop>_p<NN>_ms or availability)"
        )
    if not out:
        raise ValueError("SLO class config declares no objectives")
    return out


# journey tuple layout (the hot path appends tuples, not objects)
_J_T = 0
_J_VANTAGE = 1
_J_CLASS = 2
_J_OK = 3
_J_TTFT = 4
_J_TPOT = 5
_J_E2E = 6
_J_QUEUE = 7
_J_HOP = 8
_J_TOKENS = 9
_J_TRACE = 10
_J_REPLICA = 11
_J_KIND = 12
_J_TENANT = 13
_J_EVENTS = 14
_J_METRIC_IDX = {"ttft": _J_TTFT, "tpot": _J_TPOT, "e2e": _J_E2E, "queue": _J_QUEUE,
                 "hop": _J_HOP}


class _ClassWindow:
    """One class's sliding journey window (mutated under the fold lock).
    Raw journeys feed percentiles and exemplars, bounded by age and count;
    burn reads time-bucketed (total, bad) counters per objective instead,
    exact at any rate."""

    __slots__ = ("journeys", "exemplars", "buckets")

    def __init__(self, cap: int):
        self.journeys: deque = deque(maxlen=cap)
        # objective key → recent violating (time, trace id)
        self.exemplars: dict[str, deque] = {}
        # bucket index (t // bucket_s) → {objective key: [total, bad]}
        self.buckets: dict[int, dict[str, list]] = {}

    def fresh_exemplars(self, key: str, horizon: float) -> list:
        """Violating trace ids recorded at or after ``horizon``."""
        return [tid for t, tid in self.exemplars.get(key, ()) if t >= horizon]


class SloPlane:
    """Declared objectives, journey windows and burn-rate alerting.
    :meth:`record_journey` is one append behind an ``enabled`` check;
    folding, percentiles and burn run under ``_fold_lock`` on reader
    threads.  ``clock`` stamps journeys and buckets (tests fix it)."""

    def __init__(self, clock=time.monotonic):
        self.enabled = False
        self.clock = clock
        self.default_class = "default"
        self.window_short_s = 60.0
        self.window_long_s = 300.0
        self.burn_threshold = 1.0
        self.min_samples = 5
        self._cap = 20000  # the raw ring's bound
        self._window_cap = 4096  # raw journeys kept a class
        self.bucket_s = 2.0  # burn bucket width, set again by load_config
        self._exemplar_cap = 8
        self._buf: list[tuple] = []
        self.dropped = 0
        self._fold_lock = threading.Lock()
        self._classes: dict[str, _ClassWindow] = {}
        self._objectives: dict[str, list[SloObjective]] = {}
        self._breached: dict[tuple[str, str], dict] = {}
        self._recent: deque = deque(maxlen=64)  # journey dicts for /debug/slo
        self._folded = {"router": 0, "replica": 0}
        self.breaches = 0
        self.recoveries = 0
        self._eval_lock = threading.Lock()
        self._eval_at = 0.0
        self.min_eval_interval_s = 0.5
        SLO_LATENCY.refresher = self._refresh_gauges

    # -- configuration -------------------------------------------------------

    def load_config(self, spec: dict) -> dict:
        """Install objectives from a config dict::

            {"window_short_s": 60, "window_long_s": 300,
             "burn_threshold": 1.0, "min_samples": 5,
             "default_class": "default",
             "classes": {"serve": {"ttft_p95_ms": 200,
                                   "e2e_p99_ms": 2000,
                                   "availability": 0.99}}}

        Replaces every objective; raises ValueError on any malformed
        entry, installing nothing.  Returns the objectives summary."""
        if not isinstance(spec, dict):
            raise ValueError("SLO config must be a JSON object")
        classes = spec.get("classes")
        if not isinstance(classes, dict) or not classes:
            raise ValueError('SLO config needs a non-empty "classes" map')
        parsed = {str(cls): parse_objectives(objs) for cls, objs in classes.items()}
        short = _num(spec.get("window_short_s", self.window_short_s), "window_short_s")
        long_ = _num(spec.get("window_long_s", self.window_long_s), "window_long_s")
        burn_thr = _num(spec.get("burn_threshold", self.burn_threshold), "burn_threshold")
        min_samples = int(_num(spec.get("min_samples", self.min_samples), "min_samples"))
        if not 0 < short < long_:
            raise ValueError(f"need 0 < window_short_s ({short}) < window_long_s ({long_})")
        with self._fold_lock:
            self._objectives = parsed
            self.window_short_s = short
            self.window_long_s = long_
            # at most ~3% boundary slop on the short window; a new bucket
            # scale makes the old bucket indices meaningless
            self.bucket_s = max(0.05, short / 30.0)
            for win in self._classes.values():
                win.buckets.clear()
                # exemplars judged under the old objectives go too
                win.exemplars.clear()
            self.burn_threshold = max(0.01, burn_thr)
            self.min_samples = max(1, min_samples)
            if spec.get("default_class"):
                self.default_class = str(spec["default_class"])
            self._breached.clear()
            self.enabled = True
        SLO_EVENTS.inc("objectives_loaded")
        return self.objectives_dict()

    def objectives_dict(self) -> dict:
        return {cls: {o.key: o.to_dict() for o in objs}
                for cls, objs in sorted(self._objectives.items())}

    def reset(self) -> None:
        """Drop every buffer and aggregate and disable (tests)."""
        with self._fold_lock:
            del self._buf[:]
            self.dropped = 0
            self._classes.clear()
            self._objectives = {}
            self._breached.clear()
            self._recent.clear()
            self._folded = {"router": 0, "replica": 0}
            self.breaches = self.recoveries = 0
            self.enabled = False
            self.clock = time.monotonic

    # -- hot path ------------------------------------------------------------

    def record_journey(
        self,
        wclass: str = "",
        ok: bool = True,
        ttft_ms: Optional[float] = None,
        tpot_ms: Optional[float] = None,
        e2e_ms: Optional[float] = None,
        queue_ms: Optional[float] = None,
        hop_ms: Optional[float] = None,
        tokens: int = 0,
        trace_id: str = "",
        replica: str = "",
        kind: str = "",
        tenant: str = "",
        vantage: str = "router",
        events: Optional[list] = None,
    ) -> bool:
        """One request journey: one tuple append; False when disabled."""
        if not self.enabled:
            return False
        buf = self._buf
        buf.append((
            self.clock(), vantage, wclass or self.default_class, bool(ok),
            ttft_ms, tpot_ms, e2e_ms, queue_ms, hop_ms,
            int(tokens), trace_id, replica, kind, tenant,
            tuple(events) if events else (),
        ))
        if len(buf) > self._cap and self._fold_lock.acquire(blocking=False):
            # nothing is folding: trim, and count the drop
            try:
                n = self._cap // 2
                del buf[:n]
                self.dropped += n
            finally:
                self._fold_lock.release()
        return True

    # -- fold path (reader threads) ------------------------------------------

    def _fold_locked(self, now: float) -> None:
        """Drain the raw ring into the class windows (the caller holds
        ``_fold_lock``; slice-then-del is safe against appends at the
        tail)."""
        n = len(self._buf)
        rows = self._buf[:n]
        del self._buf[:n]
        folded = {"router": 0, "replica": 0}
        recent_rows: list[tuple] = []
        for row in rows:
            vantage = row[_J_VANTAGE]
            folded[vantage] = folded.get(vantage, 0) + 1
            cls = row[_J_CLASS]
            if cls not in self._objectives:
                # the class comes from the client: undeclared names fold
                # into the default class, so labels stay bounded by config
                cls = self.default_class
            win = self._classes.get(cls)
            if win is None:
                win = self._classes[cls] = _ClassWindow(self._window_cap)
            win.journeys.append(row)
            # burn counts and exemplars: the router vantage only (one
            # journey must not count twice when both vantages record it)
            if vantage == "router":
                objs = self._objectives.get(cls, ())
                bucket = None
                if objs:
                    bidx = int(row[_J_T] / self.bucket_s)
                    bucket = win.buckets.get(bidx)
                    if bucket is None:
                        bucket = win.buckets[bidx] = {}
                for obj in objs:
                    verdict = obj.violated(row)
                    if verdict is None:
                        continue
                    cell = bucket.get(obj.key)
                    if cell is None:
                        cell = bucket[obj.key] = [0, 0]
                    cell[0] += 1
                    cell[1] += verdict
                    if verdict:
                        if row[_J_TRACE]:
                            ex = win.exemplars.get(obj.key)
                            if ex is None:
                                ex = win.exemplars[obj.key] = deque(maxlen=self._exemplar_cap)
                            ex.append((row[_J_T], row[_J_TRACE]))
                recent_rows.append(row)
        # only the tail can survive the recent deque: build dicts for it only
        for row in recent_rows[-(self._recent.maxlen or 64):]:
            self._recent.append(self._journey_dict(row))
        # journeys and buckets older than the long window carry no signal
        horizon = now - self.window_long_s
        for win in self._classes.values():
            while win.journeys and win.journeys[0][_J_T] < horizon:
                win.journeys.popleft()
            if win.buckets:
                for b in [b for b in win.buckets if (b + 1) * self.bucket_s < horizon]:
                    del win.buckets[b]
        for k, v in folded.items():
            self._folded[k] = self._folded.get(k, 0) + v
        dropped, self.dropped = self.dropped, 0
        for k, v in folded.items():
            if v:
                SLO_RECORDS.inc(k, value=float(v))
        if dropped:
            SLO_DROPPED.inc("journey_cap", value=float(dropped))

    @staticmethod
    def _journey_dict(row: tuple) -> dict:
        return {
            "t_mono": round(row[_J_T], 3),
            "vantage": row[_J_VANTAGE],
            "wclass": row[_J_CLASS],
            "tenant": row[_J_TENANT],
            "ok": row[_J_OK],
            "ttft_ms": row[_J_TTFT],
            "tpot_ms": row[_J_TPOT],
            "e2e_ms": row[_J_E2E],
            "queue_ms": row[_J_QUEUE],
            "hop_ms": row[_J_HOP],
            "tokens": row[_J_TOKENS],
            "trace_id": row[_J_TRACE],
            "replica": row[_J_REPLICA],
            "kind": row[_J_KIND],
            "events": list(row[_J_EVENTS]),
        }

    def _burn_locked(self, now: float) -> dict:
        """Per class and objective, burn over both windows from the
        bucketed counters (the caller holds ``_fold_lock``)."""
        out: dict[str, dict] = {}
        t_short = now - self.window_short_s
        t_long = now - self.window_long_s
        for cls, objs in sorted(self._objectives.items()):
            win = self._classes.get(cls)
            entry = out[cls] = {}
            counts = {obj.key: [0, 0, 0, 0] for obj in objs}  # tot_s, bad_s, tot_l, bad_l
            if win is not None:
                for bidx, bucket in win.buckets.items():
                    b_end = (bidx + 1) * self.bucket_s
                    if b_end <= t_long:
                        continue
                    in_short = b_end > t_short
                    for key, (tot, bad) in bucket.items():
                        c = counts.get(key)
                        if c is None:
                            continue  # a key of a replaced config
                        c[2] += tot
                        c[3] += bad
                        if in_short:
                            c[0] += tot
                            c[1] += bad
            for obj in objs:
                tot_s, bad_s, tot_l, bad_l = counts[obj.key]
                budget = obj.budget
                entry[obj.key] = {
                    "burn_short": round((bad_s / tot_s / budget) if tot_s else 0.0, 4),
                    "burn_long": round((bad_l / tot_l / budget) if tot_l else 0.0, 4),
                    "bad_short": bad_s,
                    "total_short": tot_s,
                    "bad_long": bad_l,
                    "total_long": tot_l,
                    "target": obj.target,
                    "threshold_ms": obj.threshold_ms,
                }
        return out

    # -- evaluation (the alerting tick) --------------------------------------

    def evaluate(self, now: Optional[float] = None, force: bool = False) -> dict:
        """Fold, compute burn, record breach and recovery transitions
        (``tpu_slo_events_total``).  Rate-limited by
        ``min_eval_interval_s``; returns :meth:`posture`."""
        now = self.clock() if now is None else now
        if not self.enabled:
            return {"burning": False, "breached": []}
        with self._eval_lock:
            if not force and now - self._eval_at < self.min_eval_interval_s:
                return self.posture()
            self._eval_at = now
            transitions: list[str] = []
            with self._fold_lock:
                self._fold_locked(now)
                burn = self._burn_locked(now)
                thr = self.burn_threshold
                for cls, objs in burn.items():
                    win = self._classes.get(cls)
                    for key, b in objs.items():
                        pair = (cls, key)
                        burning = (b["burn_short"] >= thr and b["burn_long"] >= thr
                                   and b["total_short"] >= self.min_samples)
                        was = pair in self._breached
                        if burning and not was:
                            exemplars = (win.fresh_exemplars(key, now - self.window_long_s)
                                         if win is not None else [])
                            self._breached[pair] = {
                                "action": "breach", "wclass": cls, "objective": key, **b,
                                "burn_threshold": thr,
                                "window_short_s": self.window_short_s,
                                "window_long_s": self.window_long_s,
                                "exemplars": exemplars,
                            }
                            self.breaches += 1
                            transitions.append("breach")
                        elif was and not burning and (b["burn_short"] < thr
                                                      and b["burn_long"] < thr):
                            self._breached.pop(pair, None)
                            self.recoveries += 1
                            transitions.append("recover")
        for action in transitions:
            SLO_EVENTS.inc(action)
        return self.posture()

    def posture(self) -> dict:
        """Compact burn posture: the breached (class, objective) pairs."""
        with self._fold_lock:
            breached = [
                {"wclass": cls, "objective": key, "burn_short": rec.get("burn_short"),
                 "burn_long": rec.get("burn_long")}
                for (cls, key), rec in sorted(self._breached.items())
            ][:8]
        return {"burning": bool(breached), "breached": breached}

    # -- read APIs -----------------------------------------------------------

    def _percentiles_locked(self, now: float) -> dict:
        t_short = now - self.window_short_s
        out: dict[str, dict] = {}
        for cls, win in sorted(self._classes.items()):
            rows = [r for r in win.journeys if r[_J_T] >= t_short]
            if not rows:
                continue
            entry: dict = {"samples": len(rows)}
            entry["ok_frac"] = round(sum(1 for r in rows if r[_J_OK]) / len(rows), 4)
            for metric, idx in _J_METRIC_IDX.items():
                vals = sorted(r[idx] for r in rows if r[idx] is not None)
                if not vals:
                    continue
                entry[metric + "_ms"] = {
                    "p50": round(_exact_quantile(vals, 0.5), 3),
                    "p95": round(_exact_quantile(vals, 0.95), 3),
                    "p99": round(_exact_quantile(vals, 0.99), 3),
                }
            out[cls] = entry
        return out

    def debug_state(self) -> dict:
        """The ``/debug/slo`` payload (folds first)."""
        now = self.clock()
        with self._fold_lock:
            if self.enabled:
                self._fold_locked(now)
            burn = self._burn_locked(now) if self.enabled else {}
            pct = self._percentiles_locked(now)
            breached = {f"{cls}:{key}": dict(rec)
                        for (cls, key), rec in sorted(self._breached.items())}
            ex_horizon = now - self.window_long_s
            exemplars = {}
            for cls, win in sorted(self._classes.items()):
                fresh = {k: win.fresh_exemplars(k, ex_horizon) for k in sorted(win.exemplars)}
                fresh = {k: v for k, v in fresh.items() if v}
                if fresh:
                    exemplars[cls] = fresh
            recent = list(self._recent)[-16:]
            folded = dict(self._folded)
            pending = len(self._buf)
        return {
            "enabled": self.enabled,
            "default_class": self.default_class,
            "window_short_s": self.window_short_s,
            "window_long_s": self.window_long_s,
            "burn_threshold": self.burn_threshold,
            "min_samples": self.min_samples,
            "objectives": self.objectives_dict(),
            "windows": pct,
            "burn": burn,
            "breached": breached,
            "breaches": self.breaches,
            "recoveries": self.recoveries,
            "journal_records": 0,  # a replica writes no journal
            "exemplars": exemplars,
            "recent": recent,
            "folded": folded,
            "pending": pending,
        }

    # -- metrics export (the LazyGauge refresher; scrape time only) ----------

    def _refresh_gauges(self) -> None:
        if not self.enabled:
            return
        now = self.clock()
        with self._fold_lock:
            self._fold_locked(now)
            burn = self._burn_locked(now)
            pct = self._percentiles_locked(now)
            breached = set(self._breached)
        lat: dict[tuple[str, ...], float] = {}
        for cls, entry in pct.items():
            for metric in LATENCY_METRICS:
                for qk, v in (entry.get(metric + "_ms") or {}).items():
                    lat[(cls, metric, qk)] = v
        burns: dict[tuple[str, ...], float] = {}
        states: dict[tuple[str, ...], float] = {}
        for cls, objs in burn.items():
            for key, b in objs.items():
                burns[(cls, key, "short")] = b["burn_short"]
                burns[(cls, key, "long")] = b["burn_long"]
                states[(cls, key)] = 1.0 if (cls, key) in breached else 0.0
        SLO_LATENCY.replace(lat)
        SLO_BURN.replace(burns)
        SLO_BREACHED.replace(states)


def load_config_source(raw: str) -> dict:
    """``--slo-config`` / ``TPU_SLO_CONFIG`` → config dict: inline JSON, or
    ``@path`` to a JSON file."""
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            raw = f.read()
    spec = json.loads(raw)
    if not isinstance(spec, dict):
        raise ValueError("SLO config must be a JSON object")
    return spec


def configure_from_env() -> None:
    """Apply ``TPU_SLO_CONFIG`` when set.  A malformed value leaves the
    plane off here; ``serve --slo-config`` surfaces the error instead."""
    raw = os.environ.get("TPU_SLO_CONFIG", "")
    if not raw:
        return
    try:
        SLO.load_config(load_config_source(raw))
    except (ValueError, TypeError, OSError, json.JSONDecodeError):
        pass


SLO = SloPlane()
configure_from_env()
