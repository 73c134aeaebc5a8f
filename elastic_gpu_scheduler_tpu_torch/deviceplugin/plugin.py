"""The kubelet device plugin of an NVIDIA GPU node.

Counterpart of ``elastic_gpu_scheduler_tpu/deviceplugin/plugin.py``.  The
scheduler is the same on either node, so the wire contract is the
reference's: the plugin serves the kubelet DevicePlugin v1beta1 gRPC API
over a unix socket, registers with the kubelet's Registration service and
advertises ``elasticgpu.io/tpu-chip`` in core units (100 devices a card,
IDs ``"<coord>/<unit>"``); coordinates come from ``TPU_HOST_TOPOLOGY`` /
``TPU_HOST_OFFSET`` (the node labels the scheduler reads), else a 1-D
mesh; ``GetPreferredAllocation`` binpacks core units onto the cards
already chosen; a kubelet restart is followed by a re-registration; an
``Allocate`` joins the pod's scheduling trace from its ``traceparent``
metadata (span ``deviceplugin.allocate``) and records one occupancy sample
a card in the profile plane.  Only the device side is NVIDIA's:

- **Discovery** (``discover_gpus``), in this order: the driver's
  ``/proc/driver/nvidia/gpus/*/information`` (each card's ``Device Minor``
  and ``GPU UUID``, no NVML needed); else ``nvidia-smi -q`` where the
  tool exists (the same two fields a card, for the cards the driver
  exposes to this container, which may hold no ``/proc`` tree and may
  hold ``/dev`` nodes of cards it cannot use); else the ``/dev/nvidia<N>``
  nodes (the minor from the name; ``nvidiactl``, ``nvidia-uvm*`` and
  ``nvidia-caps`` are not cards); else the reference's ``TPU_CHIP_COUNT``
  simulation.  Cards take coordinates in minor order.
- **Allocate's contract** (``allocation_envs``): every env key the
  reference writes, with its value (``TPU_VISIBLE_CHIPS``,
  ``TPU_CHIP_CORE_UNITS``, ``TPU_CHIP_SHARES``, ``TPU_CORE_PERCENT``, and
  ``XLA_PYTHON_CLIENT_MEM_FRACTION`` for a fractional tenant: a JAX tenant
  may run on the node too), plus ``CUDA_VISIBLE_DEVICES``: the allocated
  cards in ``TPU_VISIBLE_CHIPS``'s order, by UUID where the driver gave
  one, else by minor (a minor is the card's CUDA index only where CUDA
  enumerates in the driver's order).  The device specs are the cards'
  ``/dev/nvidia<minor>`` plus the control nodes every CUDA process opens
  (``/dev/nvidiactl``, ``/dev/nvidia-uvm``, and ``/dev/nvidia-uvm-tools``
  where the node has it).  The port's entry points honour
  ``TPU_CORE_PERCENT`` as a cap on the CUDA caching allocator
  (``utils/devicecontract``), where JAX honours its memory fraction by
  itself.
- **Health**: a card's device node present at start that then vanishes
  marks the card Unhealthy; its return restores it.

The device model is plain functions on plain data (``discover_gpus``,
``allocation_envs``, ``preferred_allocation``), which import neither
``grpc`` nor ``google.protobuf``: a GPU host may have neither.  Only
``GPUDevicePlugin``'s gRPC wiring imports them, when it runs.  The
messages are the reference's generated module, copied byte for byte
(``deviceplugin_pb2``: two copies of one serialized descriptor share one
entry of protobuf's default pool, so one process may import both).

    python -m elastic_gpu_scheduler_tpu_torch.deviceplugin.plugin [--chip-count N] [--no-register]
"""

from __future__ import annotations

import glob
import logging
import os
import re
import shutil
import subprocess
import threading
import time
from collections import Counter
from typing import NamedTuple, Optional, Sequence

from ..profile import PROFILER
from ..tracing import TRACEPARENT_HEADER, TRACER
from .topology import coords, parse_coord, parse_topology

log = logging.getLogger("gpu-device-plugin")

API_VERSION = "v1beta1"
KUBELET_SOCKET = "/var/lib/kubelet/device-plugins/kubelet.sock"
PLUGIN_SOCKET_NAME = "elasticgpu-tpu.sock"
HEALTHY = "Healthy"
# the scheduler's resource model (own copies of the reference's utils/consts)
RESOURCE_TPU_CORE = "elasticgpu.io/tpu-chip"  # 100 units = 1 physical card
CORE_PER_CHIP = 100
# the device nodes every CUDA process opens besides its cards'; the last
# only where the node has it
CONTROL_NODES = ("nvidiactl", "nvidia-uvm")
OPTIONAL_CONTROL_NODES = ("nvidia-uvm-tools",)

_SVC = "v1beta1.DevicePlugin"
_REG_SVC = "v1beta1.Registration"
_CARD_NODE = re.compile(r"nvidia(\d+)$")


class GPU(NamedTuple):
    """One card: its coordinate, its device node, the driver's minor and
    its UUID ("" where neither the driver's ``/proc`` tree nor
    ``nvidia-smi`` gave it)."""

    coord: str
    path: str
    minor: int
    uuid: str = ""


def _proc_cards(proc_root: str) -> list[tuple[int, str]]:
    """(minor, UUID) of each card the driver lists under ``proc_root``."""
    out = []
    for info in glob.glob(os.path.join(proc_root, "gpus", "*", "information")):
        fields = {}
        try:
            with open(info) as f:
                for line in f:
                    k, sep, v = line.partition(":")
                    if sep:
                        fields[k.strip()] = v.strip()
        except OSError:
            continue
        if fields.get("Device Minor", "").isdigit():
            out.append((int(fields["Device Minor"]), fields.get("GPU UUID", "")))
    return sorted(out)


def _smi_cards(smi: str) -> list[tuple[int, str]]:
    """(minor, UUID) of each card ``smi -q`` (``nvidia-smi``) reports; none
    where the tool is missing or fails."""
    if not smi or shutil.which(smi) is None:
        return []
    try:
        out = subprocess.run([smi, "-q"], capture_output=True, text=True, timeout=30,
                             check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    cards, uuid = [], ""
    for line in out.splitlines():
        k, sep, v = line.partition(":")
        k, v = k.strip(), v.strip()
        if not sep:
            continue
        if k == "GPU UUID":
            uuid = v
        elif k == "Minor Number" and v.isdigit():
            cards.append((int(v), uuid))
            uuid = ""
    return sorted(cards)


def _dev_cards(dev_root: str) -> list[int]:
    """The minors of the card nodes ``/dev/nvidia<N>`` under ``dev_root``."""
    out = []
    for path in glob.glob(os.path.join(dev_root, "nvidia*")):
        m = _CARD_NODE.match(os.path.basename(path))
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def _found(dev_root: str, proc_root: str, smi: str) -> tuple[str, list[tuple[int, str]]]:
    """(the source, each card's (minor, UUID)) in ``discover_gpus``' order."""
    for source, cards in (("proc", lambda: _proc_cards(proc_root)),
                          ("smi", lambda: _smi_cards(smi)),
                          ("dev", lambda: [(m, "") for m in _dev_cards(dev_root)])):
        found = cards()
        if found:
            return source, found
    return "env", []


def discovery_source(dev_root: str = "/dev", proc_root: str = "/proc/driver/nvidia",
                     smi: str = "nvidia-smi") -> str:
    """Which source ``discover_gpus`` reads on this node: ``proc``,
    ``smi``, ``dev`` or ``env``."""
    return _found(dev_root, proc_root, smi)[0]


def discover_gpus(chip_count: int = 0, host_topology: str = "", host_offset: str = "",
                  dev_root: str = "/dev", proc_root: str = "/proc/driver/nvidia",
                  smi: str = "nvidia-smi") -> list[GPU]:
    """The node's cards in minor order, each with its coordinate.  The
    driver's ``/proc`` tree first, else ``smi -q`` (``""``: not asked),
    else the ``/dev`` card nodes, else ``TPU_CHIP_COUNT`` simulated cards;
    ``chip_count`` > 0 overrides the count, as in the reference (cards past
    those found are simulated)."""
    found = _found(dev_root, proc_root, smi)[1]
    if chip_count <= 0:
        chip_count = len(found) if found else int(os.environ.get("TPU_CHIP_COUNT", "0") or 0)
    if chip_count <= 0:
        return []
    host_topology = host_topology or os.environ.get("TPU_HOST_TOPOLOGY", "")
    host_offset = host_offset or os.environ.get("TPU_HOST_OFFSET", "")
    if host_topology:
        dims = parse_topology(host_topology)
        offset = parse_coord(host_offset) if host_offset else (0,) * len(dims)
        cs = [".".join(str(o + v) for o, v in zip(offset, local))
              for local in coords(dims)][:chip_count]
    else:
        cs = [str(i) for i in range(chip_count)]
    out = []
    for i, c in enumerate(cs):
        minor, uuid = found[i] if i < len(found) else (i, "")
        out.append(GPU(c, os.path.join(dev_root, f"nvidia{minor}"), minor, uuid))
    return out


def chip_of_device(device_id: str) -> str:
    return device_id.split("/", 1)[0]


def allocation_envs(device_ids: Sequence[str], gpus: Sequence[GPU],
                    core_units: int = CORE_PER_CHIP, dev_root: str = "/dev"
                    ) -> tuple[dict[str, str], list[tuple[str, str, str]]]:
    """One container's ``Allocate`` answer as plain data: (its env, its
    device specs as (container path, host path, permissions)).  The env
    is the reference's, key for key, plus ``CUDA_VISIBLE_DEVICES``.

    The shares come from the actual spread of the device IDs over the
    cards: the kubelet treats core units as fungible, so an allocation may
    split unevenly (40 on A + 10 on B), and ``TPU_CORE_PERCENT`` is the
    smallest card's share (a process-wide cap must hold on every card)."""
    by_coord = {g.coord: g for g in gpus}
    by_chip = Counter(map(chip_of_device, device_ids))
    chip_coords = sorted(by_chip)
    envs = {
        "TPU_VISIBLE_CHIPS": ",".join(chip_coords),
        "TPU_CHIP_CORE_UNITS": str(len(device_ids)),
        "TPU_CHIP_SHARES": ",".join(f"{c}={u}" for c, u in sorted(by_chip.items())),
    }
    min_units = min(by_chip.values()) if by_chip else 0
    envs["TPU_CORE_PERCENT"] = str(round(100 * min_units / core_units))
    if by_chip and min_units < core_units:
        envs["XLA_PYTHON_CLIENT_MEM_FRACTION"] = f"{min_units / core_units:.2f}"
    cards = [by_coord[c] for c in chip_coords if c in by_coord]
    envs["CUDA_VISIBLE_DEVICES"] = ",".join(g.uuid or str(g.minor) for g in cards)
    specs = [(f"/dev/nvidia{g.minor}", g.path, "rw") for g in cards]
    if cards:
        nodes = list(CONTROL_NODES) + [n for n in OPTIONAL_CONTROL_NODES
                                       if os.path.exists(os.path.join(dev_root, n))]
        specs += [(f"/dev/{n}", os.path.join(dev_root, n), "rw") for n in nodes]
    return envs, specs


def preferred_allocation(available: Sequence[str], must_include: Sequence[str],
                         size: int) -> list[str]:
    """Prefer filling already-chosen cards (must-include first), then the
    fewest additional cards: core-unit binpacking within the node, so
    fractional tenants consolidate and whole cards stay free."""
    chosen = list(must_include)[:size]
    taken = set(chosen)
    by_chip: dict[str, list[str]] = {}
    for d in available:
        if d not in taken:
            by_chip.setdefault(chip_of_device(d), []).append(d)
    chosen_chips = {chip_of_device(d) for d in chosen}
    order = sorted(by_chip.items(),
                   key=lambda kv: (kv[0] not in chosen_chips, len(kv[1]), kv[0]))
    for _chip, devs in order:
        for d in sorted(devs):
            if len(chosen) >= size:
                break
            chosen.append(d)
        if len(chosen) >= size:
            break
    return chosen


def _pb():
    """The generated messages (``google.protobuf``), imported at first use."""
    from . import deviceplugin_pb2

    return deviceplugin_pb2


def _grpc_traceparent(context) -> str:
    """W3C trace context from gRPC invocation metadata (the DevicePlugin
    API carries no pod identity, so a tracing-aware caller passes the
    pod's ``elasticgpu.io/traceparent`` annotation as ``traceparent``
    metadata).  Best-effort: the kubelet sends none."""
    try:
        for k, v in context.invocation_metadata() or ():
            if k.lower() == TRACEPARENT_HEADER:
                return v
    except Exception:  # noqa: BLE001 - a context without metadata joins no trace
        pass
    return ""


class GPUDevicePlugin:
    """The DevicePlugin service: the functions above wrapped into its
    protobuf messages, and the gRPC server and registration around them."""

    def __init__(self, gpus: Optional[list[GPU]] = None,
                 core_units_per_chip: int = CORE_PER_CHIP,
                 resource_name: str = RESOURCE_TPU_CORE, dev_root: str = "/dev"):
        self.gpus = gpus if gpus is not None else discover_gpus(dev_root=dev_root)
        self.core_units = core_units_per_chip
        self.resource_name = resource_name
        self.dev_root = dev_root
        self._stop = threading.Event()
        self._server = None
        self._health: dict[str, bool] = {g.coord: True for g in self.gpus}
        self._health_event = threading.Event()  # set → re-announce now
        # card nodes present at start: the probe set of check_devices
        self._probe_paths = {g.coord: g.path for g in self.gpus if os.path.exists(g.path)}

    # -- device model --------------------------------------------------------

    def device_list(self) -> list:
        """One device per core unit: ID "<coord>/<unit>" (100 a card)."""
        pb = _pb()
        devs = []
        for g in self.gpus:
            health = HEALTHY if self._health.get(g.coord, True) else "Unhealthy"
            devs += [pb.Device(ID=f"{g.coord}/{u}", health=health)
                     for u in range(self.core_units)]
        return devs

    def set_health(self, coord: str, healthy: bool) -> None:
        """Mark a card (un)healthy and re-announce: the kubelet then shrinks
        or restores the node's allocatable.  Signals only on a transition
        (an unconditional signal would make ListAndWatch's heartbeat a busy
        loop)."""
        if self._health.get(coord, True) != healthy:
            self._health[coord] = healthy
            self._health_event.set()

    def check_devices(self) -> None:
        """Re-probe the card nodes that existed at start: a vanished one
        marks its card Unhealthy, its return restores it.  Simulated cards
        (no node at start) are never probed."""
        for coord, path in self._probe_paths.items():
            self.set_health(coord, os.path.exists(path))

    # -- rpc implementations -------------------------------------------------

    def GetDevicePluginOptions(self, request, context):
        return _pb().DevicePluginOptions(pre_start_required=False,
                                         get_preferred_allocation_available=True)

    def ListAndWatch(self, request, context):
        pb = _pb()
        yield pb.ListAndWatchResponse(devices=self.device_list())
        # re-announce on a health change at once, else a slow heartbeat
        while not self._stop.is_set():
            self._health_event.wait(timeout=10.0)
            if self._stop.is_set():
                break
            self._health_event.clear()
            self.check_devices()
            yield pb.ListAndWatchResponse(devices=self.device_list())

    def GetPreferredAllocation(self, request, context):
        pb = _pb()
        resp = pb.PreferredAllocationResponse()
        for creq in request.container_requests:
            chosen = preferred_allocation(creq.available_device_i_ds,
                                          creq.must_include_device_i_ds, creq.allocation_size)
            resp.container_responses.append(
                pb.ContainerPreferredAllocationResponse(device_i_ds=chosen))
        return resp

    def Allocate(self, request, context):
        with TRACER.span("deviceplugin.allocate", parent=_grpc_traceparent(context) or None,
                         containers=len(request.container_requests)) as sp:
            return self._allocate(request, sp)

    def _profile_chips(self, by_chip: dict[str, int], tenant: str) -> None:
        """One occupancy sample a card into the profile plane, keyed by the
        tenant when the caller's trace context names one; nothing unless
        profiling is on."""
        if not PROFILER.enabled:
            return
        node = os.environ.get("NODE_NAME", "") or "local"
        for coord, units in by_chip.items():
            PROFILER.record_chip(node, coord, units, self.core_units, tenant=tenant)

    def _allocate(self, request, sp):
        pb = _pb()
        resp = pb.AllocateResponse()
        all_chips: list[str] = []
        total_units = 0
        for creq in request.container_requests:
            ids = list(creq.devices_i_ds)
            envs, specs = allocation_envs(ids, self.gpus, self.core_units, self.dev_root)
            by_chip = Counter(map(chip_of_device, ids))
            self._profile_chips(by_chip, sp.trace_id if sp is not None else "")
            cresp = pb.ContainerAllocateResponse()
            cresp.envs.update(envs)
            for container_path, host_path, perms in specs:
                cresp.devices.append(pb.DeviceSpec(container_path=container_path,
                                                   host_path=host_path, permissions=perms))
            resp.container_responses.append(cresp)
            all_chips += sorted(by_chip)
            total_units += len(ids)
        sp.set_attr("chips", sorted(set(all_chips)))
        sp.set_attr("core_units", total_units)
        return resp

    def PreStartContainer(self, request, context):
        return _pb().PreStartContainerResponse()

    # -- server wiring -------------------------------------------------------

    def _generic_handler(self):
        import grpc

        pb = _pb()

        def unary(fn, req, resp):
            return grpc.unary_unary_rpc_method_handler(
                fn, request_deserializer=req.FromString,
                response_serializer=resp.SerializeToString)

        rpcs = {
            "GetDevicePluginOptions": unary(self.GetDevicePluginOptions, pb.Empty,
                                            pb.DevicePluginOptions),
            "ListAndWatch": grpc.unary_stream_rpc_method_handler(
                self.ListAndWatch, request_deserializer=pb.Empty.FromString,
                response_serializer=pb.ListAndWatchResponse.SerializeToString),
            "GetPreferredAllocation": unary(self.GetPreferredAllocation,
                                            pb.PreferredAllocationRequest,
                                            pb.PreferredAllocationResponse),
            "Allocate": unary(self.Allocate, pb.AllocateRequest, pb.AllocateResponse),
            "PreStartContainer": unary(self.PreStartContainer, pb.PreStartContainerRequest,
                                       pb.PreStartContainerResponse),
        }
        return grpc.method_handlers_generic_handler(_SVC, rpcs)

    def serve(self, socket_path: str):
        from concurrent import futures

        import grpc

        if os.path.exists(socket_path):
            os.unlink(socket_path)
        server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        server.add_generic_rpc_handlers((self._generic_handler(),))
        server.add_insecure_port(f"unix://{socket_path}")
        server.start()
        self._server = server
        log.info("device plugin serving %d cards (%d devices) on %s", len(self.gpus),
                 len(self.gpus) * self.core_units, socket_path)
        return server

    def stop(self):
        self._stop.set()
        self._health_event.set()  # wake ListAndWatch at once
        if self._server is not None:
            self._server.stop(grace=1)

    @staticmethod
    def _sock_ino(path: str):
        """Socket identity: (inode, ctime_ns); a recreated socket can reuse
        the inode on tmpfs, but not the creation stamp."""
        try:
            st = os.stat(path)
            return (st.st_ino, st.st_ctime_ns)
        except OSError:
            return None

    def start_kubelet_watch(self, plugin_dir: str, endpoint: str = PLUGIN_SOCKET_NAME,
                            interval: float = 1.0) -> threading.Thread:
        """The kubelet-restart contract: a restarted kubelet forgets every
        plugin and recreates kubelet.sock (a new inode).  Poll it; on a
        change, serve our socket again if the restart removed it, then
        register again (with bounded retries: the kubelet may not accept
        yet).  Returns the watcher thread (a daemon)."""
        ksock = os.path.join(plugin_dir, "kubelet.sock")
        own = os.path.join(plugin_dir, endpoint)

        def loop():
            last = self._sock_ino(ksock)
            while not self._stop.wait(interval):
                try:
                    last = tick(last)
                except Exception:  # noqa: BLE001 - a dead watcher would end restart recovery
                    log.exception("kubelet watch iteration failed")
                    last = None

        def tick(last):
            cur = self._sock_ino(ksock)
            if cur is None:
                return None  # kubelet down: any reappearance is new
            if cur == last:
                return last
            log.info("kubelet.sock changed (kubelet restart); re-registering %s",
                     self.resource_name)
            if not os.path.exists(own):
                # some kubelets empty the plugin dir on restart: serve again first
                if self._server is not None:
                    self._server.stop(grace=0.5)
                self.serve(own)
            for attempt in range(5):
                try:
                    self.register(kubelet_socket=ksock, endpoint=endpoint)
                    return cur
                except Exception as e:  # noqa: BLE001 - retried, then the next poll retries
                    log.warning("re-register attempt %d failed: %s", attempt + 1, e)
                    if self._stop.wait(0.5 * (attempt + 1)):
                        return None
            # forget the socket, so the next poll retries: giving up would
            # leave the node advertising no card until another restart
            return None

        t = threading.Thread(target=loop, name="kubelet-watch", daemon=True)
        t.start()
        return t

    def register(self, kubelet_socket: str = KUBELET_SOCKET,
                 endpoint: str = PLUGIN_SOCKET_NAME) -> None:
        """Register with the kubelet's Registration service."""
        import grpc

        pb = _pb()
        with grpc.insecure_channel(f"unix://{kubelet_socket}") as ch:
            register = ch.unary_unary(f"/{_REG_SVC}/Register",
                                      request_serializer=pb.RegisterRequest.SerializeToString,
                                      response_deserializer=pb.Empty.FromString)
            # the kubelet keeps the options of THIS message, and calls
            # GetPreferredAllocation only when they advertise it
            register(pb.RegisterRequest(version=API_VERSION, endpoint=endpoint,
                                        resource_name=self.resource_name,
                                        options=self.GetDevicePluginOptions(pb.Empty(), None)),
                     timeout=10)
        log.info("registered %s with kubelet", self.resource_name)


def main(argv=None) -> int:  # pragma: no cover - thin wrapper
    import argparse

    p = argparse.ArgumentParser("gpu-device-plugin")
    p.add_argument("--plugin-dir", default="/var/lib/kubelet/device-plugins")
    p.add_argument("--chip-count", type=int, default=0)
    p.add_argument("--no-register", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    gpus = discover_gpus(chip_count=args.chip_count)
    log.info("cards from %s: %s", discovery_source(), [g._asdict() for g in gpus])
    plugin = GPUDevicePlugin(gpus=gpus)
    plugin.serve(os.path.join(args.plugin_dir, PLUGIN_SOCKET_NAME))
    if not args.no_register:
        plugin.register(kubelet_socket=os.path.join(args.plugin_dir, "kubelet.sock"))
        plugin.start_kubelet_watch(args.plugin_dir)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        plugin.stop()
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
