"""The port's replica-side SLO plane against the reference's.

``elastic_gpu_scheduler_tpu_torch.slo`` is an own copy of the part of the
reference's SLO plane a serving replica runs.  Under a fixed clock, the
same config and the same seeded journeys (both vantages, declared and
undeclared classes, failures, journeys without a TTFT) must give an equal
``debug_state``, equal ``evaluate`` postures through breach and recovery,
and series-equal ``tpu_slo_*`` gauges; bad configs are refused with the
reference's error, installing nothing.  The reference's journal is off in
these tests, so its loads and breaches write nothing either.
"""

import json

import numpy as np
import pytest

from elastic_gpu_scheduler_tpu import slo as ref_slo
from elastic_gpu_scheduler_tpu_torch import slo as port_slo

from test_torch_metrics import series

PACKAGES = {"ref": ref_slo, "port": port_slo}
CONFIG = {
    "window_short_s": 30, "window_long_s": 120, "burn_threshold": 1.0, "min_samples": 4,
    "classes": {
        "serve": {"ttft_p95_ms": 200, "e2e_p99_ms": 2000, "availability": 0.9},
        "batch": {"e2e_p99.5_ms": 9000, "queue_p90_ms": 50},
    },
}


@pytest.fixture(autouse=True)
def _restore_gauge_refreshers():
    """A new SloPlane takes the gauges' refresher: hand it back to each
    package's process-global plane."""
    yield
    for m in PACKAGES.values():
        m.SLO_LATENCY.refresher = m.SLO._refresh_gauges


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _load(m, plane, spec):
    if m is ref_slo:
        return plane.load_config(spec, journal=False)
    return plane.load_config(spec)


def _journeys(seed: int, n: int) -> list[tuple[float, dict]]:
    """(time step, journey kwargs) from a seeded stream."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kw = {
            "wclass": str(rng.choice(["serve", "batch", "unknown", ""])),
            "ok": bool(rng.random() > 0.15),
            "ttft_ms": None if rng.random() < 0.2 else float(rng.exponential(150.0)),
            "tpot_ms": None if rng.random() < 0.3 else float(rng.exponential(20.0)),
            "e2e_ms": float(rng.exponential(1500.0)),
            "queue_ms": float(rng.exponential(30.0)),
            "tokens": int(rng.integers(0, 128)),
            "trace_id": f"{i:032x}" if rng.random() < 0.8 else "",
            "replica": "rep-0",
            "vantage": str(rng.choice(["router", "replica"])),
        }
        if kw["vantage"] == "router":
            kw["hop_ms"] = float(rng.exponential(2.0))
            kw["events"] = [{"status": 200}]
        out.append((float(rng.exponential(0.7)), kw))
    return out


def _drive(m, seed: int, n: int = 300):
    clock = Clock()
    plane = m.SloPlane(clock=clock)
    summary = _load(m, plane, CONFIG)
    states, postures = [], []
    for i, (dt, kw) in enumerate(_journeys(seed, n)):
        clock.t += dt
        plane.record_journey(**kw)
        if i % 50 == 49:
            postures.append(plane.evaluate(force=True))
            states.append(plane.debug_state())
    # traffic stops: the windows age out and breaches recover
    for _ in range(3):
        clock.t += 100.0
        postures.append(plane.evaluate(force=True))
    states.append(plane.debug_state())
    plane._refresh_gauges()
    gauges = "\n".join(line for g in (m.SLO_LATENCY, m.SLO_BURN, m.SLO_BREACHED)
                       for line in super(type(g), g).collect()) + "\n"
    return summary, states, postures, series(gauges), (plane.breaches, plane.recoveries)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_debug_state_and_evaluate_match(seed):
    ref = _drive(ref_slo, seed)
    port = _drive(port_slo, seed)
    assert port == ref
    summary, states, postures, gauges, (breaches, recoveries) = port
    assert states[0]["folded"]["router"] + states[0]["folded"]["replica"] == 50
    assert breaches >= 1 and recoveries == breaches  # the stream breaches, then recovers
    assert any(p["burning"] for p in postures) and not postures[-1]["burning"]
    assert "tpu_slo_latency_ms" in gauges and summary["batch"]["e2e_p99.5_ms"]["target"] == 0.995


def test_replica_vantage_gives_windows_without_burn():
    """A bare replica records only its own vantage: percentiles and
    journey counts, and no burn (burn counts the router vantage)."""
    out = {}
    for name, m in PACKAGES.items():
        clock = Clock()
        plane = m.SloPlane(clock=clock)
        _load(m, plane, {"classes": {"serve": {"ttft_p95_ms": 1, "availability": 0.5}}})
        plane.default_class = "serve"
        for i in range(12):
            clock.t += 0.5
            plane.record_journey(vantage="replica", ok=i % 3 != 0, ttft_ms=50.0 + i,
                                 e2e_ms=900.0, queue_ms=float(i), tokens=64,
                                 trace_id=f"{i:032x}", replica="rep-0")
        out[name] = plane.debug_state()
    assert out["port"] == out["ref"]
    st = out["port"]
    assert st["folded"] == {"router": 0, "replica": 12}
    assert st["windows"]["serve"]["samples"] == 12
    assert st["windows"]["serve"]["queue_ms"] == {"p50": 5.0, "p95": 10.0, "p99": 11.0}
    assert st["burn"]["serve"]["ttft_p95_ms"]["total_short"] == 0 and not st["breached"]


def test_disabled_plane_and_ring_cap_match():
    out = {}
    for name, m in PACKAGES.items():
        plane = m.SloPlane(clock=Clock())
        off = plane.record_journey(wclass="x")
        _load(m, plane, {"classes": {"serve": {"availability": 0.9}}})
        plane._cap = 10
        for i in range(25):
            plane.record_journey(wclass="serve", ok=bool(i % 2))
        out[name] = (off, plane.dropped, len(plane._buf), plane.debug_state())
    assert out["port"] == out["ref"]
    assert out["port"][:3] == (False, 15, 10)


@pytest.mark.parametrize("bad", [
    "not a dict",
    {},
    {"classes": {}},
    {"classes": {"a": {"nope_p95_ms": 1}}},
    {"classes": {"a": {"ttft_p95": 200}}},
    {"classes": {"a": {"latency_p95_ms": 200}}},
    {"classes": {"a": {"availability": 1.0}}},
    {"classes": {"a": {"ttft_p95_ms": 0}}},
    {"classes": {"a": {"ttft_pxx_ms": 5}}},
    {"classes": {"a": {"ttft_p95_ms": None}}},
    {"classes": {"a": {"availability": [0.9]}}},
    {"classes": {"a": {}}},
    {"classes": {"a": {"availability": 0.9}}, "window_short_s": 300, "window_long_s": 60},
    {"classes": {"a": {"availability": 0.9}}, "min_samples": "many"},
])
def test_bad_configs_are_refused_alike(bad):
    errors = {}
    for name, m in PACKAGES.items():
        plane = m.SloPlane(clock=Clock())
        with pytest.raises(ValueError) as e:
            _load(m, plane, bad)
        errors[name] = (str(e.value), plane.enabled, plane.objectives_dict())
    assert errors["port"] == errors["ref"]
    assert errors["port"][1:] == (False, {})


def test_config_sources_and_env_match(tmp_path, monkeypatch):
    path = tmp_path / "slo.json"
    path.write_text(json.dumps(CONFIG))
    for raw in (json.dumps(CONFIG), f"@{path}"):
        assert port_slo.load_config_source(raw) == ref_slo.load_config_source(raw) == CONFIG
    for m in PACKAGES.values():
        with pytest.raises(ValueError):
            m.load_config_source("[1, 2]")
        with pytest.raises(json.JSONDecodeError):
            m.load_config_source("{bad")
    monkeypatch.setattr(port_slo, "SLO", port_slo.SloPlane())
    monkeypatch.setenv("TPU_SLO_CONFIG", "{bad json")
    port_slo.configure_from_env()  # a malformed env value leaves the plane off
    assert not port_slo.SLO.enabled
    monkeypatch.setenv("TPU_SLO_CONFIG", f"@{path}")
    port_slo.configure_from_env()
    assert port_slo.SLO.enabled and port_slo.SLO.window_short_s == 30.0
