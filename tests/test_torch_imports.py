"""The port imports neither JAX nor any module of the JAX package.

A fresh interpreter imports every module of the port and then lists
``sys.modules``.  The port's package name BEGINS with the JAX package's,
so names are compared whole (``m == pkg or m.startswith(pkg + ".")``),
never as bare prefixes.  The same run checks that importing starts no
kernel build (a CPU-only machine has no nvcc).  Only ``deviceplugin/``
imports ``grpc`` and ``google.protobuf`` (a GPU host may have neither):
every other module imports without them, and the plugin's plain
functions import and run where importing them raises.
"""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import elastic_gpu_scheduler_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, json, pkgutil, sys
import elastic_gpu_scheduler_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for n in names:
    importlib.import_module(n)
from elastic_gpu_scheduler_tpu_torch.ops import _build
print(json.dumps({"imported": names, "modules": sorted(sys.modules),
                  "built": _build._lib is not None}))
"""


def _is_jax_package(m: str) -> bool:
    return any(m == p or m.startswith(p + ".")
               for p in ("jax", "jaxlib", "elastic_gpu_scheduler_tpu"))


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120, check=True,
    )
    res = json.loads(out.stdout.strip().splitlines()[-1])
    expected = {m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")}
    assert set(res["imported"]) == expected
    assert {"elastic_gpu_scheduler_tpu_torch.models.serving",
            "elastic_gpu_scheduler_tpu_torch.server.inference",
            "elastic_gpu_scheduler_tpu_torch.ops.paged_attention",
            "elastic_gpu_scheduler_tpu_torch.ops.xent",
            "elastic_gpu_scheduler_tpu_torch.models.train",
            "elastic_gpu_scheduler_tpu_torch.models.data",
            "elastic_gpu_scheduler_tpu_torch.models.generate",
            "elastic_gpu_scheduler_tpu_torch.models.speculative",
            "elastic_gpu_scheduler_tpu_torch.models.sampling",
            "elastic_gpu_scheduler_tpu_torch.models.lora",
            "elastic_gpu_scheduler_tpu_torch.models.moe",
            "elastic_gpu_scheduler_tpu_torch.models.quantize",
            "elastic_gpu_scheduler_tpu_torch.ops.expert_matmul",
            "elastic_gpu_scheduler_tpu_torch.serve",
            "elastic_gpu_scheduler_tpu_torch.utils.prefixdigest",
            "elastic_gpu_scheduler_tpu_torch.utils.kvwire",
            "elastic_gpu_scheduler_tpu_torch.launcher",
            "elastic_gpu_scheduler_tpu_torch.tracing",
            "elastic_gpu_scheduler_tpu_torch.metrics",
            "elastic_gpu_scheduler_tpu_torch.slo",
            "elastic_gpu_scheduler_tpu_torch.slo.assembly",
            "elastic_gpu_scheduler_tpu_torch.profile",
            "elastic_gpu_scheduler_tpu_torch.policy",
            "elastic_gpu_scheduler_tpu_torch.policy.lang",
            "elastic_gpu_scheduler_tpu_torch.policy.vm",
            "elastic_gpu_scheduler_tpu_torch.policy.registry",
            "elastic_gpu_scheduler_tpu_torch.models.convert",
            "elastic_gpu_scheduler_tpu_torch.models.checkpoint",
            "elastic_gpu_scheduler_tpu_torch.models.vit",
            "elastic_gpu_scheduler_tpu_torch.utils.safetensors",
            "elastic_gpu_scheduler_tpu_torch.parallel",
            "elastic_gpu_scheduler_tpu_torch.parallel.mesh",
            "elastic_gpu_scheduler_tpu_torch.parallel.distributed",
            "elastic_gpu_scheduler_tpu_torch.parallel.collectives",
            "elastic_gpu_scheduler_tpu_torch.parallel.sharding",
            "elastic_gpu_scheduler_tpu_torch.parallel.ring",
            "elastic_gpu_scheduler_tpu_torch.deviceplugin.plugin",
            "elastic_gpu_scheduler_tpu_torch.deviceplugin.deviceplugin_pb2",
            "elastic_gpu_scheduler_tpu_torch.deviceplugin.topology",
            "elastic_gpu_scheduler_tpu_torch.utils.tpuprobe",
            "elastic_gpu_scheduler_tpu_torch.utils.devicecontract"} <= expected
    bad = [m for m in res["modules"] if _is_jax_package(m)]
    assert not bad, bad
    # the HF import reads checkpoints with its own code: the card's machine
    # has neither package
    assert not [m for m in res["modules"]
                if m.split(".")[0] in ("transformers", "safetensors", "orbax")]
    assert "elastic_gpu_scheduler_tpu_torch" in res["modules"]
    assert not res["built"]


_OUTSIDE_DEVICEPLUGIN = r"""
import importlib, json, pkgutil, sys
import elastic_gpu_scheduler_tpu_torch as port
plane = port.__name__ + ".deviceplugin"
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")
         if not (m.name == plane or m.name.startswith(plane + "."))]
for n in names:
    importlib.import_module(n)
print(json.dumps({"imported": names, "modules": sorted(sys.modules)}))
"""

_GRPC_BLOCKED = r"""
import importlib.abc, json, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] == "grpc" or name.startswith("google.protobuf"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, Block())
from elastic_gpu_scheduler_tpu_torch.deviceplugin.plugin import (
    allocation_envs, discover_gpus, preferred_allocation)
gpus = discover_gpus(chip_count=2, host_topology="", host_offset="", dev_root="/nonexistent",
                     proc_root="/nonexistent", smi="")
envs, specs = allocation_envs(["1/%d" % u for u in range(50)], gpus)
pref = preferred_allocation(["0/1", "1/0", "1/1"], ["1/0"], 2)
try:
    import grpc
    blocked = False
except ImportError:
    blocked = True
print(json.dumps({"envs": envs, "specs": specs, "pref": pref, "blocked": blocked,
                  "modules": sorted(sys.modules)}))
"""


def _mentions_grpc(modules) -> list:
    return [m for m in modules if m == "grpc" or m.startswith("grpc.")
            or m == "google.protobuf" or m.startswith("google.protobuf.")]


def test_only_the_device_plugin_imports_grpc_and_protobuf():
    """Every module of the port outside ``deviceplugin/`` imports, and
    leaves ``grpc`` and ``google.protobuf`` out of ``sys.modules``: a GPU
    host may have neither package."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _OUTSIDE_DEVICEPLUGIN], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120, check=True,
    )
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "elastic_gpu_scheduler_tpu_torch.serve" in res["imported"]
    assert "elastic_gpu_scheduler_tpu_torch.utils.tpuprobe" in res["imported"]
    assert not _mentions_grpc(res["modules"]), _mentions_grpc(res["modules"])


def test_device_plugin_functions_import_with_grpc_blocked():
    """``deviceplugin.plugin``'s plain functions (discovery, Allocate's
    contract, the preferred allocation) import and run where importing
    ``grpc`` or ``google.protobuf`` raises."""
    env = dict(os.environ, PYTHONPATH=REPO, TPU_CHIP_COUNT="0")
    out = subprocess.run(
        [sys.executable, "-c", _GRPC_BLOCKED], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120, check=True,
    )
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["blocked"] and not _mentions_grpc(res["modules"])
    assert res["envs"]["TPU_VISIBLE_CHIPS"] == "1" and res["envs"]["TPU_CORE_PERCENT"] == "50"
    assert res["envs"]["CUDA_VISIBLE_DEVICES"] == "1"
    assert [s[0] for s in res["specs"]] == ["/dev/nvidia1", "/dev/nvidiactl", "/dev/nvidia-uvm"]
    assert res["pref"] == ["1/0", "1/1"]


def test_whole_name_check_tells_the_packages_apart():
    assert _is_jax_package("elastic_gpu_scheduler_tpu.models.serving")
    assert _is_jax_package("jax.numpy")
    assert not _is_jax_package("elastic_gpu_scheduler_tpu_torch.models.serving")
    assert not _is_jax_package("jaxtyping")


def test_chip_smoke_imports_no_jax():
    """``chip_smoke.py`` (every phase, request controls included) names
    no JAX module and no module of the JAX package in any import."""
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert "elastic_gpu_scheduler_tpu_torch.server.inference" in names
    assert not [m for m in names if _is_jax_package(m)]


def test_package_data_ships_every_kernel_source_and_header():
    """An installed copy of the port builds its kernels from its own
    ``csrc/`` at first use, so the package data in ``pyproject.toml``
    matches every CUDA source there and every header they include."""
    import fnmatch
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"][port.__name__]
    pkg = os.path.dirname(port.__file__)
    files = sorted(os.path.join("csrc", n) for n in os.listdir(os.path.join(pkg, "csrc"))
                   if n.endswith((".cu", ".cuh")))
    assert any(f.endswith(".cuh") for f in files)
    assert [f for f in files if not any(fnmatch.fnmatch(f, p) for p in data)] == []
