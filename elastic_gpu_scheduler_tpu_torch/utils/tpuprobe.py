"""Live device health signal: the ``tpu_relay_up`` gauge.

Counterpart of ``elastic_gpu_scheduler_tpu/utils/tpuprobe.py``, under the
reference's module, names, metric and ``debug_state`` payload, so an
operator's alert on ``tpu_relay_up == 0`` reads the same on either node.
The probe asks for the card instead of a TPU backend: a child process
runs ``torch.cuda.is_available()`` and prints the card's name, with a hard
timeout (``TPU_RELAY_PROBE_TIMEOUT``, default 20 s).  The child is the
reference's reason too: a hung driver hangs an in-process probe forever,
and only a child can be killed.  :class:`RelayMonitor` probes on a slow
interval on its own daemon thread and publishes:

    tpu_relay_up  1 = the last probe reached a CUDA device
                  0 = the probe failed, timed out or saw no device

The monitor is off until something starts it (no subprocess in tests).
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

from ..metrics import REGISTRY, Gauge

__all__ = ["RELAY_UP", "RELAY_MONITOR", "RelayMonitor", "probe_relay"]

# the reference's series, help text and all (the port's series carry the
# reference's names and help; on this node "a TPU backend" reads "a CUDA
# device")
RELAY_UP = REGISTRY.register(
    Gauge(
        "tpu_relay_up",
        "TPU probe-relay reachability from this process: 1 = the last "
        "periodic probe reached a TPU backend, 0 = it failed or timed "
        "out (bench on-chip sections will fail-fast; alert on 0).  "
        "Absent until a RelayMonitor runs (--relay-probe-interval)",
    )
)

_PROBE = ("import torch; "
          "assert torch.cuda.is_available(), "
          "'NOT_GPU:' + str(torch.cuda.device_count()) + ' devices'; "
          "print(torch.cuda.get_device_name(0))")


def probe_relay(timeout: float = 20.0, env: Optional[dict] = None) -> tuple[bool, str]:
    """(up, detail): probe the card in a SUBPROCESS (``env``: the child's
    environment, this process's by default), so the timeout bounds a
    child that can be killed.  ``detail`` is the card's name when up, the
    failure otherwise."""
    try:
        p = subprocess.run([sys.executable, "-c", _PROBE], timeout=timeout,
                           capture_output=True, env=env)
    except subprocess.TimeoutExpired:
        return False, f"probe timed out after {timeout:.0f}s (driver hung?)"
    except OSError as e:
        return False, f"probe spawn failed: {e}"
    if p.returncode == 0:
        return True, p.stdout.decode().strip()
    return False, p.stderr.decode(errors="replace")[-200:]


class RelayMonitor:
    """Background prober feeding ``tpu_relay_up``.

    Probes on its OWN daemon thread every ``interval_s``, never on the
    scrape path (a scrape-time probe would add seconds to /metrics and
    start a child a scraper).  ``probe`` is injectable for tests."""

    def __init__(
        self,
        interval_s: float = 300.0,
        timeout_s: Optional[float] = None,
        probe: Callable[[float], tuple[bool, str]] = probe_relay,
    ):
        self.interval_s = max(5.0, float(interval_s))
        self.timeout_s = (
            float(timeout_s)
            if timeout_s is not None
            else float(os.environ.get("TPU_RELAY_PROBE_TIMEOUT", "20"))
        )
        self.probe = probe
        self.up: Optional[bool] = None  # None = never probed
        self.detail = ""
        self.probes = 0
        self.last_probe_at = 0.0  # time.time of the last completed probe
        self.last_probe_ms = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def probe_once(self) -> bool:
        t0 = time.perf_counter()
        up, detail = self.probe(self.timeout_s)
        self.last_probe_ms = round((time.perf_counter() - t0) * 1e3, 1)
        self.up, self.detail = up, detail
        self.probes += 1
        self.last_probe_at = time.time()
        RELAY_UP.set(value=1.0 if up else 0.0)
        return up

    def start(self) -> "RelayMonitor":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.probe_once()
                except Exception:  # noqa: BLE001 - the monitor must outlive any probe bug
                    RELAY_UP.set(value=0.0)
                if self._stop.wait(self.interval_s):
                    return

        self._thread = threading.Thread(target=loop, name="tpu-relay-probe", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2)

    def debug_state(self) -> dict:
        """The /debug/relay payload."""
        return {
            "running": self._thread is not None,
            "up": self.up,
            "detail": self.detail,
            "probes": self.probes,
            "interval_s": self.interval_s,
            "timeout_s": self.timeout_s,
            "last_probe_at": round(self.last_probe_at, 3),
            "last_probe_ms": self.last_probe_ms,
        }


# process-global instance (as TRACER / PROFILER): whoever runs the monitor
# starts it; its state reads the same whether or not it ever ran
RELAY_MONITOR = RelayMonitor()
