"""The node plane of a GPU node against the reference's TPU node plane, on
the CPU.

The port's device plugin (``deviceplugin/plugin.py``) keeps the
reference's wire contract and changes only the device side, so every test
here drives both plugins on the same inputs, each behind a fake kubelet
over a unix socket in ``tmp_path`` (the reference's ``FakeKubelet``):

- discovery on a fake driver tree (``/proc/driver/nvidia`` + ``/dev``: two
  cards, minors out of the tree's order, control nodes), on a fake
  ``nvidia-smi -q`` beside ``/dev`` nodes of a card it does not report, on
  ``/dev`` alone and on ``TPU_CHIP_COUNT``: the coordinates are the
  reference's ``discover_chips`` under the same count and topology env;
- ``Allocate`` whole, fractional and split unevenly over cards: every env
  key the reference writes has the reference's value; the port adds
  ``CUDA_VISIBLE_DEVICES`` and the NVIDIA device specs (control nodes too);
- ``GetPreferredAllocation`` equals the reference's on seeded random
  requests;
- registration, options, ListAndWatch, health transitions and device
  nodes that vanish, a kubelet restart, a health flap during
  ``Allocate``, the ``deviceplugin.allocate`` span joined from the
  ``traceparent`` metadata and ``chip_occupancy`` after ``Allocate``;
- the allocation's share: ``apply_allocation`` caps the caching allocator
  of a CUDA device only, and ``serve.main``, ``serve.follow_rank`` and
  ``launcher.main`` apply it before they build anything on the device;
- the device probe: ``probe_relay`` in a real child that sees no card
  reports down with ``NOT_GPU``, a hung child times out, and
  ``RelayMonitor`` publishes ``tpu_relay_up`` on the port's ``/metrics``
  with the reference's ``debug_state`` keys.
"""

import os
import pathlib
import queue
import tempfile
from concurrent import futures

import grpc
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.deviceplugin import deviceplugin_pb2 as ref_pb
from elastic_gpu_scheduler_tpu.deviceplugin.plugin import TPUDevicePlugin, discover_chips
from elastic_gpu_scheduler_tpu.utils import consts
from elastic_gpu_scheduler_tpu.utils.tpuprobe import RELAY_UP as REF_RELAY_UP
from elastic_gpu_scheduler_tpu.utils.tpuprobe import RelayMonitor as RefRelayMonitor
from elastic_gpu_scheduler_tpu_torch.deviceplugin import deviceplugin_pb2 as pb
from elastic_gpu_scheduler_tpu_torch.deviceplugin import plugin as gp
from elastic_gpu_scheduler_tpu_torch.deviceplugin.plugin import (
    API_VERSION,
    GPU,
    PLUGIN_SOCKET_NAME,
    GPUDevicePlugin,
    allocation_envs,
    discover_gpus,
    discovery_source,
    preferred_allocation,
)
from elastic_gpu_scheduler_tpu_torch.utils import devicecontract, tpuprobe

UUIDS = {1: "GPU-11111111-aaaa-bbbb-cccc-000000000001",
         3: "GPU-33333333-aaaa-bbbb-cccc-000000000003"}
# (TPU_HOST_TOPOLOGY, TPU_HOST_OFFSET, the count asked for: 0 = the cards found)
LAYOUTS = [("", "", 0), ("2x1", "1.2", 0), ("1x2", "0.4", 0), ("2x2", "0.2", 4), ("", "", 3)]


def fake_smi(root, minors=(3, 1)) -> str:
    """An executable that prints ``nvidia-smi -q``'s fields for ``minors``."""
    blocks = "".join(
        f"GPU 00000000:{18 + i:02X}:00.0\n    Product Name : NVIDIA H100 80GB HBM3\n"
        f"    GPU UUID : {UUIDS[m]}\n    Minor Number : {m}\n    Bus Id : 00000000:18:00.0\n"
        for i, m in enumerate(minors))
    path = root / "nvidia-smi"
    path.write_text(f"#!/bin/sh\nprintf '%s' '{blocks}'\n")
    path.chmod(0o755)
    return str(path)


def fake_node(root, proc=True, uvm_tools=True):
    """A driver tree under ``root``: cards of minors 3 and 1 (the PCI
    order lists minor 3 first), their /dev nodes and the control nodes,
    and a node of minor 6 that no driver source reports."""
    dev = root / "dev"
    dev.mkdir()
    names = ["nvidia3", "nvidia1", "nvidiactl", "nvidia-uvm", "nvidia-modeset"]
    names += ["nvidia-uvm-tools"] if uvm_tools else []
    for n in names:
        (dev / n).write_text("")
    (dev / "nvidia-caps").mkdir()
    proc_root = root / "proc"
    if proc:
        for bus, minor in (("0000:18:00.0", 3), ("0000:3b:00.0", 1)):
            d = proc_root / "gpus" / bus
            d.mkdir(parents=True)
            (d / "information").write_text(
                f"Model: \t\t NVIDIA H100 80GB HBM3\nIRQ:   \t\t 42\n"
                f"GPU UUID: \t {UUIDS[minor]}\nBus Location: \t {bus}\n"
                f"Device Minor: \t {minor}\nGPU Excluded:\t No\n")
    return str(dev), str(proc_root)


@pytest.fixture()
def topology_env(monkeypatch):
    for k in ("TPU_CHIP_COUNT", "TPU_HOST_TOPOLOGY", "TPU_HOST_OFFSET"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.mark.parametrize("source", ["proc", "smi", "dev"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: ",".join(map(str, x)) or "flat")
def test_discovery_on_a_driver_tree_takes_the_reference_coordinates(tmp_path, topology_env,
                                                                    source, layout):
    topo, offset, count = layout
    dev, proc = fake_node(tmp_path, proc=source == "proc")
    smi = fake_smi(tmp_path) if source != "dev" else ""
    if source == "smi":  # a node of a card the driver gives this container no access to
        open(os.path.join(dev, "nvidia6"), "w").close()
    gpus = discover_gpus(count, topo, offset, dev_root=dev, proc_root=proc, smi=smi)
    assert discovery_source(dev, proc, smi) == source
    want = discover_chips(count or 2, topo, offset)
    assert [g.coord for g in gpus] == [c for c, _ in want]
    # the found cards in minor order, then simulated ones past them
    assert [g.minor for g in gpus][:2] == [1, 3]
    assert [g.path for g in gpus][:2] == [os.path.join(dev, "nvidia1"),
                                          os.path.join(dev, "nvidia3")]
    uuids = ["", ""] if source == "dev" else [UUIDS[1], UUIDS[3]]
    assert [g.uuid for g in gpus][:2] == uuids
    assert all(g.uuid == "" and g.minor == i for i, g in enumerate(gpus) if i >= 2)


@pytest.mark.parametrize("layout", LAYOUTS + [("2x2", "", 0), ("", "", -1)],
                         ids=lambda x: ",".join(map(str, x)))
def test_discovery_from_the_env_takes_the_reference_coordinates(tmp_path, topology_env, layout):
    topo, offset, count = layout
    topology_env.setenv("TPU_CHIP_COUNT", "3")
    if topo:
        topology_env.setenv("TPU_HOST_TOPOLOGY", topo)
    if offset:
        topology_env.setenv("TPU_HOST_OFFSET", offset)
    roots = dict(dev_root=str(tmp_path), proc_root=str(tmp_path), smi="")
    gpus = discover_gpus(max(count, 0), **roots)
    want = discover_chips(max(count, 0))
    assert discovery_source(**roots) == "env"
    assert [g.coord for g in gpus] == [c for c, _ in want]
    assert [g.minor for g in gpus] == list(range(len(want)))
    topology_env.setenv("TPU_CHIP_COUNT", "0")
    assert discover_gpus(**roots) == discover_chips() == []


# -- the gRPC surface, both plugins behind fake kubelets -------------------------------


class FakeKubelet:
    """The Registration service end of the contract (the reference test's)."""

    def __init__(self, socket_path, pb_mod=pb):
        self.requests = queue.Queue()
        handler = grpc.method_handlers_generic_handler("v1beta1.Registration", {
            "Register": grpc.unary_unary_rpc_method_handler(
                self._register, request_deserializer=pb_mod.RegisterRequest.FromString,
                response_serializer=pb_mod.Empty.SerializeToString)})
        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        self.server.add_generic_rpc_handlers((handler,))
        self.server.add_insecure_port(f"unix://{socket_path}")
        self.server.start()
        self.pb = pb_mod

    def _register(self, request, context):
        self.requests.put(request)
        return self.pb.Empty()

    def stop(self):
        self.server.stop(grace=1)


class Side:
    """One plugin behind its fake kubelet in a directory of its own."""

    def __init__(self, d, plugin, pb_mod):
        d.mkdir()
        self.dir, self.plugin, self.pb = str(d), plugin, pb_mod
        self.kubelet_sock = os.path.join(self.dir, "kubelet.sock")
        self.sock = os.path.join(self.dir, PLUGIN_SOCKET_NAME)
        self.kubelet = FakeKubelet(self.kubelet_sock, pb_mod)
        plugin.serve(self.sock)

    def call(self, method, request, response, timeout=5):
        with grpc.insecure_channel(f"unix://{self.sock}") as ch:
            return ch.unary_unary(f"/v1beta1.DevicePlugin/{method}",
                                  request_serializer=type(request).SerializeToString,
                                  response_deserializer=response.FromString)(request,
                                                                             timeout=timeout)

    def allocate(self, *containers):
        req = self.pb.AllocateRequest(container_requests=[
            self.pb.ContainerAllocateRequest(devices_i_ds=ids) for ids in containers])
        return self.call("Allocate", req, self.pb.AllocateResponse).container_responses

    def stream(self, timeout=15):
        ch = grpc.insecure_channel(f"unix://{self.sock}")
        watch = ch.unary_stream("/v1beta1.DevicePlugin/ListAndWatch",
                                request_serializer=self.pb.Empty.SerializeToString,
                                response_deserializer=self.pb.ListAndWatchResponse.FromString)
        return ch, iter(watch(self.pb.Empty(), timeout=timeout))

    def stop(self):
        self.plugin.stop()
        self.kubelet.stop()


@pytest.fixture()
def sides(tmp_path, topology_env):
    # the sockets in a short directory: a unix socket's path has ~107 bytes
    with tempfile.TemporaryDirectory(prefix="dp") as d:
        yield from _sides(tmp_path, pathlib.Path(d))


def _sides(tmp_path, sock_dir):
    """The reference's plugin on 4 chips of a 2x2 host at offset 0.2, and
    the port's on a node of 4 cards (minors 0-3, UUIDs from the driver's
    tree) under the same topology."""
    root = tmp_path / "node"
    root.mkdir()
    dev, proc = root / "dev", root / "proc"
    dev.mkdir()
    for n in ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools"):
        (dev / n).write_text("")
    for minor in range(4):
        (dev / f"nvidia{minor}").write_text("")
        d = proc / "gpus" / f"0000:{minor:02x}:00.0"
        d.mkdir(parents=True)
        (d / "information").write_text(f"GPU UUID: \t GPU-{minor}\nDevice Minor: \t {minor}\n")
    gpus = discover_gpus(0, "2x2", "0.2", dev_root=str(dev), proc_root=str(proc), smi="")
    ref = Side(sock_dir / "ref", TPUDevicePlugin(chips=discover_chips(4, "2x2", "0.2")), ref_pb)
    port = Side(sock_dir / "port", GPUDevicePlugin(gpus=gpus, dev_root=str(dev)), pb)
    port.dev = str(dev)
    yield ref, port
    ref.stop()
    port.stop()


ALLOCATIONS = {
    "whole": [[f"0.3/{u}" for u in range(100)]],
    "fractional": [[f"0.2/{u}" for u in range(12)]],
    "fractional_and_whole": [[f"0.2/{u}" for u in range(50)] + [f"0.3/{u}" for u in range(100)]],
    "uneven_split": [[f"1.2/{u}" for u in range(40)] + [f"0.3/{u}" for u in range(10)]],
    "two_whole": [[f"0.2/{u}" for u in range(100)] + [f"1.3/{u}" for u in range(100)]],
    "three_containers": [[f"0.2/{u}" for u in range(12)], [f"0.3/{u}" for u in range(100)],
                         [f"1.2/{u}" for u in range(30)] + [f"1.3/{u}" for u in range(70)]],
}
MINOR = {"0.2": 0, "0.3": 1, "1.2": 2, "1.3": 3}  # row-major over the 2x2 box


@pytest.mark.parametrize("name", sorted(ALLOCATIONS))
def test_allocate_writes_the_reference_env_plus_the_cuda_contract(sides, name):
    ref, port = sides
    got = port.allocate(*ALLOCATIONS[name])
    want = ref.allocate(*ALLOCATIONS[name])
    assert len(got) == len(want) == len(ALLOCATIONS[name])
    for g, w, ids in zip(got, want, ALLOCATIONS[name]):
        envs = dict(g.envs)
        cuda = envs.pop("CUDA_VISIBLE_DEVICES")
        assert envs == dict(w.envs)
        coords = envs["TPU_VISIBLE_CHIPS"].split(",")
        assert cuda == ",".join(f"GPU-{MINOR[c]}" for c in coords)
        specs = [(d.container_path, d.host_path, d.permissions) for d in g.devices]
        cards = [(f"/dev/nvidia{MINOR[c]}", os.path.join(port.dev, f"nvidia{MINOR[c]}"), "rw")
                 for c in coords]
        control = [(f"/dev/{n}", os.path.join(port.dev, n), "rw")
                   for n in ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools")]
        assert specs == cards + control
        # the plain function gives the same answer
        assert allocation_envs(ids, port.plugin.gpus, dev_root=port.dev) == (dict(g.envs), specs)


def test_allocation_envs_by_minor_and_without_uvm_tools(tmp_path):
    """No driver tree: CUDA_VISIBLE_DEVICES names the minors; a node
    without ``nvidia-uvm-tools`` gets no spec for it; no card, no spec."""
    dev, _ = fake_node(tmp_path, proc=False, uvm_tools=False)
    gpus = discover_gpus(dev_root=dev, proc_root=str(tmp_path / "none"), smi="")
    envs, specs = allocation_envs([f"1/{u}" for u in range(50)], gpus, dev_root=dev)
    assert envs["CUDA_VISIBLE_DEVICES"] == "3" and envs["TPU_CORE_PERCENT"] == "50"
    assert envs["XLA_PYTHON_CLIENT_MEM_FRACTION"] == "0.50"
    assert [s[0] for s in specs] == ["/dev/nvidia3", "/dev/nvidiactl", "/dev/nvidia-uvm"]
    assert allocation_envs([], gpus, dev_root=dev) == (
        {"TPU_VISIBLE_CHIPS": "", "TPU_CHIP_CORE_UNITS": "0", "TPU_CHIP_SHARES": "",
         "TPU_CORE_PERCENT": "0", "CUDA_VISIBLE_DEVICES": ""}, [])


def test_preferred_allocation_equals_the_reference_on_seeded_requests(sides):
    ref, port = sides
    rng = np.random.default_rng(21)
    coords = ["0.2", "0.3", "1.2", "1.3"]
    reqs = []
    for _ in range(60):
        avail = [f"{c}/{u}" for c in coords for u in range(100) if rng.random() < 0.4]
        rng.shuffle(avail)
        must = list(rng.choice(avail, size=int(rng.integers(0, 4)), replace=False))
        size = int(rng.integers(1, len(avail) + 1))
        reqs.append((avail, must, size))
    want = ref.plugin.GetPreferredAllocation(ref_pb.PreferredAllocationRequest(
        container_requests=[ref_pb.ContainerPreferredAllocationRequest(
            available_device_i_ds=a, must_include_device_i_ds=m, allocation_size=n)
            for a, m, n in reqs]), None)
    for (a, m, n), w in zip(reqs, want.container_responses):
        assert preferred_allocation(a, m, n) == list(w.device_i_ds)
    # over the wire, the reference test's request: the 25 stay on 0.2
    avail = [f"0.2/{u}" for u in range(30)] + [f"0.3/{u}" for u in range(100)]
    resp = port.call("GetPreferredAllocation", pb.PreferredAllocationRequest(
        container_requests=[pb.ContainerPreferredAllocationRequest(
            available_device_i_ds=avail, must_include_device_i_ds=["0.2/0"],
            allocation_size=25)]), pb.PreferredAllocationResponse)
    ids = list(resp.container_responses[0].device_i_ds)
    assert len(ids) == 25 and all(i.startswith("0.2/") for i in ids) and "0.2/0" in ids


def test_register_options_and_prestart(sides):
    for side, resource in zip(sides, (consts.RESOURCE_TPU_CORE, gp.RESOURCE_TPU_CORE)):
        side.plugin.register(kubelet_socket=side.kubelet_sock)
        req = side.kubelet.requests.get(timeout=5)
        assert (req.version, req.endpoint, req.resource_name) == (API_VERSION, PLUGIN_SOCKET_NAME,
                                                                  resource)
        assert req.options.get_preferred_allocation_available
        opts = side.call("GetDevicePluginOptions", side.pb.Empty(), side.pb.DevicePluginOptions)
        assert opts.pre_start_required is False
        assert side.call("PreStartContainer", side.pb.PreStartContainerRequest(
            devices_i_ds=["0.2/0"]), side.pb.PreStartContainerResponse) is not None
    assert consts.RESOURCE_TPU_CORE == gp.RESOURCE_TPU_CORE
    assert consts.CORE_PER_CHIP == gp.CORE_PER_CHIP


def _mark(side, healthy: bool) -> None:
    """Card 0.2 (un)healthy: the reference's chips are simulated (no device
    file to probe), so its hook is the signal; the port's card node goes
    away (or comes back) first, as a card lost by the driver does, since
    each re-announce re-probes the nodes."""
    if side.pb is pb:
        path = os.path.join(side.dev, "nvidia0")
        if healthy:
            open(path, "w").close()
        else:
            os.unlink(path)
    side.plugin.set_health("0.2", healthy)


def test_list_and_watch_and_health_transitions(sides):
    """Both advertise the same devices; a card gone unhealthy is pushed as
    100 Unhealthy units, its recovery restores them."""
    firsts = []
    for side in sides:
        ch, it = side.stream()
        with ch:
            first = next(it)
            firsts.append(sorted((d.ID, d.health) for d in first.devices))
            _mark(side, False)
            sick = {d.ID for d in next(it).devices if d.health == "Unhealthy"}
            assert sick == {f"0.2/{u}" for u in range(100)}
            _mark(side, True)
            assert all(d.health == "Healthy" for d in next(it).devices)
    assert firsts[0] == firsts[1] and len(firsts[1]) == 400


def test_a_card_node_that_vanishes_marks_the_card_unhealthy(sides):
    _, port = sides
    path = os.path.join(port.dev, "nvidia2")
    os.unlink(path)
    port.plugin.check_devices()
    sick = {d.ID.split("/")[0] for d in port.plugin.device_list() if d.health != "Healthy"}
    assert sick == {"1.2"}
    open(path, "w").close()
    port.plugin.check_devices()
    assert all(d.health == "Healthy" for d in port.plugin.device_list())


def test_health_flap_during_allocate(sides):
    """A card going unhealthy while an Allocate is in flight: the Allocate
    still answers for the devices named, the same as the reference, and
    the flap is announced."""
    answers = []
    for side in sides:
        ch, it = side.stream(timeout=None)
        with ch:
            next(it)
            _mark(side, False)
            (resp,) = side.allocate([f"0.2/{u}" for u in range(100)])
            answers.append({k: v for k, v in resp.envs.items() if k != "CUDA_VISIBLE_DEVICES"})
            unhealthy = [d.ID for d in next(it).devices if d.health != "Healthy"]
            assert unhealthy and all(i.startswith("0.2/") for i in unhealthy)
            _mark(side, True)
            assert all(d.health == "Healthy" for d in next(it).devices)
    assert answers[0] == answers[1] and answers[1]["TPU_VISIBLE_CHIPS"] == "0.2"


def test_kubelet_restart_reregisters(sides):
    """A restarted kubelet forgets every plugin and recreates kubelet.sock;
    each plugin's watcher registers again without a restart of its own."""
    for side in sides:
        side.plugin.register(kubelet_socket=side.kubelet_sock)
        side.kubelet.requests.get(timeout=5)
        watcher = side.plugin.start_kubelet_watch(side.dir, interval=0.05)
        side.kubelet.stop()
        if os.path.exists(side.kubelet_sock):
            os.unlink(side.kubelet_sock)
        side.kubelet = FakeKubelet(side.kubelet_sock, side.pb)
        req = side.kubelet.requests.get(timeout=10)
        assert req.endpoint == PLUGIN_SOCKET_NAME and watcher.is_alive()
        assert req.resource_name == consts.RESOURCE_TPU_CORE


def test_allocate_joins_the_trace_and_records_chip_occupancy():
    """``traceparent`` metadata joins the Allocate to the pod's scheduling
    trace; one occupancy sample a card lands in ``chip_occupancy`` under
    the trace id, as in the reference's profile plane."""
    from elastic_gpu_scheduler_tpu.profile import PROFILER as REF_PROFILER
    from elastic_gpu_scheduler_tpu.tracing import TRACER as REF_TRACER
    from elastic_gpu_scheduler_tpu_torch.profile import PROFILER
    from elastic_gpu_scheduler_tpu_torch.tracing import TRACER

    tp = "00-" + "a" * 32 + "-" + "b" * 16 + "-01"

    class Ctx:
        def invocation_metadata(self):
            return (("traceparent", tp),)

    gpus = [GPU("0", "/dev/nvidia0", 0, "GPU-0"), GPU("1", "/dev/nvidia1", 1, "GPU-1")]
    ids = [f"0/{u}" for u in range(40)] + [f"1/{u}" for u in range(100)]
    out = {}
    for name, (plugin, pbm, tracer, profiler) in {
            "ref": (TPUDevicePlugin(chips=[("0", "/dev/accel0"), ("1", "/dev/accel1")]), ref_pb,
                    REF_TRACER, REF_PROFILER),
            "port": (GPUDevicePlugin(gpus=gpus), pb, TRACER, PROFILER)}.items():
        sample, enabled = tracer.sample, profiler.sample
        tracer.configure(1.0)
        tracer.reset()
        profiler.configure(sample=1.0)
        profiler.reset()
        try:
            resp = plugin.Allocate(pbm.AllocateRequest(container_requests=[
                pbm.ContainerAllocateRequest(devices_i_ds=ids)]), Ctx())
            span = [s for s in tracer.finished() if s.name == "deviceplugin.allocate"][-1]
            out[name] = (span.trace_id, span.attrs["chips"], span.attrs["core_units"],
                         profiler.debug_state()["chip_occupancy"],
                         resp.container_responses[0].envs["TPU_CHIP_SHARES"])
        finally:
            profiler.reset()
            profiler.configure(sample=enabled)
            tracer.configure(sample)
            tracer.reset()
    assert out["port"] == out["ref"]
    trace_id, chips, units, occ, _ = out["port"]
    assert trace_id == "a" * 32 and chips == ["0", "1"] and units == 140
    assert occ["local/0"] == {"core_util": 0.4, "samples": 1, "tenants": ["a" * 32]}
    assert occ["local/1"]["core_util"] == 1.0


# -- the allocation's share, honoured by the entry points --------------------------------


def test_apply_allocation_caps_a_cuda_device_only(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "set_per_process_memory_fraction",
                        lambda f, d=None: calls.append((f, d)))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.delenv("TPU_CORE_PERCENT", raising=False)
    assert devicecontract.apply_allocation("cuda:0") == 1.0  # no plugin: the whole card
    monkeypatch.setenv("TPU_CORE_PERCENT", "100")
    assert devicecontract.apply_allocation("cuda:0") == 1.0
    monkeypatch.setenv("TPU_CORE_PERCENT", "50")
    assert devicecontract.apply_allocation("cpu") == 1.0
    assert calls == []
    assert devicecontract.apply_allocation("cuda:1") == 0.5
    assert devicecontract.apply_allocation("cuda") == 0.5  # the current device's index
    assert calls == [(0.5, 1), (0.5, 3)]
    monkeypatch.setenv("TPU_CORE_PERCENT", "0")
    with pytest.raises(ValueError, match="TPU_CORE_PERCENT=0"):
        devicecontract.apply_allocation("cuda:0")


class _Stop(Exception):
    pass


def _recorder(monkeypatch, events):
    monkeypatch.setattr(devicecontract, "apply_allocation",
                        lambda device: events.append(("share", torch.device(device).type)))

    def engine(*a, **k):
        events.append(("engine", str(k.get("device"))))
        raise _Stop

    from elastic_gpu_scheduler_tpu_torch.models import serving

    monkeypatch.setattr(serving, "InferenceEngine", engine)


def test_serve_main_applies_the_share_before_the_engine(monkeypatch):
    from elastic_gpu_scheduler_tpu_torch import serve

    events = []
    _recorder(monkeypatch, events)
    with pytest.raises(_Stop):
        serve.main(["--init", "--cpu", "--vocab-size", "97", "--d-model", "32", "--n-layers",
                    "1", "--n-heads", "2", "--d-ff", "64", "--dtype", "float32"])
    assert events == [("share", "cpu"), ("engine", "cpu")]


def test_follow_rank_applies_the_share_before_it_joins(monkeypatch):
    from types import SimpleNamespace

    from elastic_gpu_scheduler_tpu_torch import serve
    from elastic_gpu_scheduler_tpu_torch.parallel import distributed, mesh

    events = []
    _recorder(monkeypatch, events)
    monkeypatch.setattr(serve.signal, "signal", lambda *a: None)
    monkeypatch.setattr(distributed, "maybe_initialize_distributed",
                        lambda *a, **k: events.append(("join", k["backend"])))
    monkeypatch.setattr(mesh, "make_mesh", lambda spec: SimpleNamespace(connect=lambda: None))
    with pytest.raises(_Stop):
        serve.follow_rank(1, 2, "file:///nowhere", {}, None, {}, "gloo", True)
    assert events == [("share", "cpu"), ("join", "gloo"), ("engine", "cpu")]


def test_launcher_main_applies_the_share_before_it_trains(monkeypatch, capsys):
    from elastic_gpu_scheduler_tpu_torch import launcher

    events = []
    monkeypatch.setattr(launcher, "apply_allocation",
                        lambda device: events.append(("share", torch.device(device).type)))

    def run_job(job, annotations, container, device):
        events.append(("train", device))
        return [1.5]

    monkeypatch.setattr(launcher, "run_job", run_job)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("TPU_NUM_PROCESSES", raising=False)
    assert launcher.main(["--cpu", "--steps", "1"]) == 0
    assert events == [("share", "cpu"), ("train", "cpu")]
    assert "final loss 1.5000" in capsys.readouterr().out


# -- the device probe ---------------------------------------------------------------------


def _gauge() -> float:
    from elastic_gpu_scheduler_tpu_torch.metrics import REGISTRY

    for line in REGISTRY.expose().splitlines():
        if line.startswith("tpu_relay_up "):
            return float(line.split()[-1])
    return float("nan")


def test_probe_in_a_child_that_sees_no_card_reports_down():
    up, detail = tpuprobe.probe_relay(timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert up is False and "NOT_GPU:0 devices" in detail
    up, detail = tpuprobe.probe_relay(timeout=0.01)
    assert up is False and "timed out" in detail


def test_relay_monitor_publishes_the_gauge_with_the_reference_payload():
    states = iter([(True, "NVIDIA H100 80GB HBM3"), (False, "NOT_GPU:0 devices"),
                   (True, "NVIDIA H100 80GB HBM3")])
    mon = tpuprobe.RelayMonitor(probe=lambda timeout: next(states))
    assert mon.probe_once() is True and _gauge() == 1.0
    assert mon.probe_once() is False and _gauge() == 0.0
    assert mon.debug_state()["detail"] == "NOT_GPU:0 devices"
    assert mon.probe_once() is True and _gauge() == 1.0 and mon.probes == 3
    assert sorted(mon.debug_state()) == sorted(RefRelayMonitor().debug_state())
    # the reference's series: name, help text and type
    assert list(tpuprobe.RELAY_UP.collect())[:2] == list(REF_RELAY_UP.collect())[:2]
    assert tpuprobe.RELAY_MONITOR.debug_state()["running"] is False


def test_relay_monitor_thread_survives_a_probe_crash():
    import threading

    calls, done = [], threading.Event()

    def probe(timeout):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("boom")
        done.set()
        return True, "ok"

    mon = tpuprobe.RelayMonitor(interval_s=5.0, probe=probe)
    mon.interval_s = 0.01
    mon.start()
    try:
        assert done.wait(5.0)
    finally:
        mon.stop()
    assert len(calls) >= 2
