"""The port's metrics against the reference's.

``elastic_gpu_scheduler_tpu_torch.metrics`` is an own copy of the
reference's metric types and the series a serving replica exports.  The
same observations into a metric of each package must give expositions
equal series by series (HELP, TYPE and every sample); every series the
port registers has the reference's name, help text, type and labels; and
``_exact_quantile`` agrees on seeded data.  A registry collects in
registration order, so expositions are compared series by series, never
as one text.
"""

import re

import numpy as np
import pytest

from elastic_gpu_scheduler_tpu import metrics as ref_metrics
from elastic_gpu_scheduler_tpu_torch import metrics as port_metrics

_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$")


def series(text: str) -> dict:
    """Prometheus text → {family: {"help", "type", "samples": {(sample
    name, labels): value}}}."""
    out: dict = {}
    fam = None
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# HELP "):
            fam, _, help_ = line[7:].partition(" ")
            out.setdefault(fam, {"samples": {}})["help"] = help_
            continue
        if line.startswith("# TYPE "):
            name, _, typ = line[7:].partition(" ")
            out.setdefault(name, {"samples": {}})["type"] = typ
            fam = name
            continue
        m = _SAMPLE.match(line)
        assert m, f"malformed sample line {line!r}"
        name, labels, value = m.groups()
        out[fam]["samples"][(name, labels or "")] = float(value)
    return out


def _both(fn):
    """fn(metrics module) for each package; returns (ref, port)."""
    return fn(ref_metrics), fn(port_metrics)


def _observe_all(m, rng_seed: int = 0) -> list[str]:
    rng = np.random.default_rng(rng_seed)
    reg = m.Registry()
    c = reg.register(m.Counter("t_requests_total", "requests by result", ("result",)))
    g = reg.register(m.Gauge("t_queue_depth", "queued per priority", ("priority",)))
    plain = reg.register(m.Gauge("t_spills", "spills"))
    h = reg.register(m.Histogram("t_latency_seconds", "latency", ("verb",)))
    hb = reg.register(m.Histogram("t_gap_ms", "gap", buckets=(0.05, 0.5, 5.0, 50.0)))
    lazy = reg.register(m.LazyGauge("t_tokens_per_sec", "tps", ("wclass", "generation")))
    runs = []

    def refresh():
        runs.append(1)
        lazy.replace({("serve", "gen-a"): 12.5 * len(runs), ("batch", "gen-b"): 3.0})

    lazy.refresher = refresh
    for r, v in zip(rng.choice(["ok", "error", "timeout"], 40), rng.integers(1, 4, 40)):
        c.inc(str(r), value=float(v))
    for p in range(3):
        g.set(str(p), value=float(rng.integers(0, 9)))
    plain.set(value=4.0)
    for verb in ("filter", "bind"):
        for v in rng.exponential(0.05, 25):
            h.observe(verb, value=float(v))
    h.observe_batch("bind", values=[float(v) for v in rng.exponential(0.3, 30)])
    hb.observe_batch(values=[float(v) for v in rng.exponential(2.0, 200)])
    hb.observe_batch(values=[])
    return [reg.expose(), reg.expose()]  # the lazy gauge refreshes each scrape


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_observations_give_series_equal_expositions(seed):
    ref, port = _both(lambda m: _observe_all(m, seed))
    for r, p in zip(ref, port):
        assert series(p) == series(r)
    final = series(port[1])
    assert final["t_tokens_per_sec"]["samples"][
        ("t_tokens_per_sec", '{wclass="serve",generation="gen-a"}')] == 25.0
    assert final["t_gap_ms"]["samples"][("t_gap_ms_count", "")] == 200.0
    assert final["t_latency_seconds"]["type"] == "histogram"


def test_histogram_observe_and_observe_batch_match():
    def reads(m):
        rng = np.random.default_rng(7)
        h = m.Histogram("t_h", "h", ("k",), buckets=(2.5, 0.1, 1.0))  # sorted on init
        vals = [float(v) for v in rng.exponential(1.0, 12000)]
        h.observe_batch("a", values=vals[:6000])
        for v in vals[6000:]:
            h.observe("a", value=v)
        h.observe_batch("b", values=[0.1, 1.0, 2.5, 7.0])  # the bounds count as <=
        return list(h.collect())
    ref, port = _both(reads)
    assert port == ref
    assert 't_h_bucket{k="b",le="0.1"} 1' in port


def test_lazy_gauge_single_flight_and_broken_refresher_match():
    def run(m):
        g = m.LazyGauge("t_lazy", "t")
        g.set(value=7.0)

        def boom():
            raise RuntimeError("refresher fault")

        g.refresher = boom
        lines = list(g.collect())  # must not raise
        g2 = m.LazyGauge("t_seq", "t")
        runs = []
        g2.refresher = lambda: (runs.append(1), g2.set(value=float(len(runs))))
        return lines, list(g2.collect()), list(g2.collect()), len(runs)
    ref, port = _both(run)
    assert port == ref
    assert port[3] == 2


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_exact_quantile_matches(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 2, 7, 100, 1001):
        xs = sorted(float(v) for v in rng.normal(0.0, 1.0, n))
        for q in (0.0, 0.01, 0.5, 0.95, 0.99, 0.999, 1.0):
            assert port_metrics._exact_quantile(xs, q) == ref_metrics._exact_quantile(xs, q)


def test_registered_series_match_the_references():
    """Every series the port registers (its own module, the serving
    series, the SLO and profile planes) carries the reference's name,
    help text, type and label names."""
    import elastic_gpu_scheduler_tpu.profile  # noqa: F401
    import elastic_gpu_scheduler_tpu.server.inference  # noqa: F401
    import elastic_gpu_scheduler_tpu.slo  # noqa: F401
    import elastic_gpu_scheduler_tpu_torch.profile  # noqa: F401
    import elastic_gpu_scheduler_tpu_torch.server.inference  # noqa: F401
    import elastic_gpu_scheduler_tpu_torch.slo  # noqa: F401

    ref = {m.name: m for m in ref_metrics.REGISTRY._metrics}
    port = {m.name: m for m in port_metrics.REGISTRY._metrics}
    assert len(port) == len(port_metrics.REGISTRY._metrics)  # no name twice
    for name, m in port.items():
        r = ref[name]
        assert (m.help, m.label_names) == (r.help, r.label_names), name
        # the HELP and TYPE lines
        assert list(m.collect())[:2] == list(r.collect())[:2], name
        if hasattr(r, "buckets"):
            assert m.buckets == r.buckets, name
    assert {n for n in port if n.startswith(("tpu_serve_", "tpu_kv_"))} == {
        "tpu_serve_requests_total", "tpu_serve_tokens_total", "tpu_serve_queue_depth",
        "tpu_serve_spills", "tpu_serve_request_seconds", "tpu_serve_host_gap_ms",
        "tpu_kv_pages_resident", "tpu_kv_pages_shipped", "tpu_kv_prefix_admissions",
        "tpu_kv_migrations_total"}
