"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` (one
process per source, all started together), and the objects link into one
shared library with a plain C interface, loaded through ``ctypes``.  No
PyTorch header is compiled, so a build takes seconds.  The sources share
``csrc/*.cuh`` headers.

The library is one entry of a compile cache (``compilecache/cache``),
keyed by a digest of the sources, headers and flags, ``nvcc``'s release,
PyTorch's CUDA version and the device's capability: an edited source
rebuilds, an unchanged tree loads.  The entry's payload is the linked
``.so``: a load checks its CRC, writes it out as ``<key>.so`` by atomic
rename and loads that, so a torn or bit-flipped library is quarantined and
rebuilt, never loaded.  The cache lives in ``_torch_kernels_build/``
inside the package (listed in ``.gitignore``) unless
``TPU_COMPILE_CACHE_DIR`` names another directory, or an engine's or the
launcher's cache is handed over (``use_cache``, or ``lib(cache)``) before
the first kernel call.  A file lock in the directory serializes builders
across processes, so a mesh's ranks or replicas sharing one directory
build once between them.  Each build leaves the per-source ``nvcc`` output
in ``<key>.log`` (registers, shared memory and spills by kernel), its
objects under ``<key>.build/``.  Nothing here runs at import: the CPU
tests import every module of the port on a machine with no ``nvcc``.

Each C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on anything but 0, so a launch the card refuses (too many
threads, too much shared memory) never passes silently.

``LAUNCHES`` counts kernel launches by name.  Each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..compilecache.cache import Codec, CompileCache, cache_key

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_torch_kernels_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, per kernel
)

LAUNCHES: dict[str, int] = {
    "flash_fwd": 0, "paged_attention": 0, "paged_attention_int8": 0,
    "flash_block_stats": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "expert_matmul": 0,
}

CACHE_DIR_ENV = "TPU_COMPILE_CACHE_DIR"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_cache: CompileCache | None = None  # handed over by an engine or the launcher
_default_cache: CompileCache | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_SIGNATURES = {
    # q, k, v, o, lse, B, H, Sq, Sk, D, dtype, causal, window, scale, stream
    "egs_flash_fwd": ([_P] * 5 + [_I] * 8 + [_F, _P], ctypes.c_int),
    # q, pool_k, pool_v, tables, lengths, out, part, B, W, Hn, Hkv, Dh, ps,
    # NB, dtype, window, scale, stream
    "egs_paged_attention": ([_P] * 7 + [_I] * 9 + [_F, _P], ctypes.c_int),
    # q, pool_k, pool_v (int8), scales_k, scales_v, tables, lengths, out,
    # part, then as egs_paged_attention
    "egs_paged_attention_int8": ([_P] * 9 + [_I] * 9 + [_F, _P], ctypes.c_int),
    # Dh, pool element bytes
    "egs_paged_attention_smem": ([_I] * 2, ctypes.c_longlong),
    # B, W, Hn, Hkv, Dh, NB
    "egs_paged_attention_workspace": ([_I] * 6, ctypes.c_longlong),
    # q, k, v, pv, m, l, part, B, H, Hkv, Sq, Sk, D, the row and head
    # strides of q, k and v (elements), the batch strides, dtype, causal,
    # q_offset, k_offset, scale, stream
    "egs_flash_block_stats": ([_P] * 7 + [_I] * 6 + [_LL] * 9 + [_I] * 4 + [_F, _P],
                              ctypes.c_int),
    # B, H, Hkv, Sq, Sk, dtype, causal, q_offset, k_offset
    "egs_flash_block_stats_splits": ([_I] * 9, ctypes.c_int),
    # q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, D, dtype, causal, window,
    # scale, stream
    "egs_flash_bwd_dq": ([_P] * 7 + [_I] * 8 + [_F, _P], ctypes.c_int),
    # q, k, v, dout, lse, delta, dk, dv, then as egs_flash_bwd_dq
    "egs_flash_bwd_dkv": ([_P] * 8 + [_I] * 8 + [_F, _P], ctypes.c_int),
    # x, w, scale, ids, out, part, T, K, N, E, dtype, w_int8, out_f32, aligned, stream
    "egs_expert_matmul": ([_P] * 6 + [_I] * 8 + [_P], ctypes.c_int),
    # T, K, N, E, dense, dtype, w_int8, aligned
    "egs_expert_matmul_workspace": ([_I] * 8, ctypes.c_longlong),
    "egs_expert_matmul_plan": ([_I] * 8, ctypes.c_int),
    "egs_error_string": ([_I], ctypes.c_char_p),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    """The toolkit's ``nvcc``: ``$CUDA_HOME/bin`` as PyTorch resolves it,
    else the one on ``PATH``.  Raises when there is none."""
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from csrc/ at first use"
    )


def _digest(files: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in files:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def nvcc_release() -> str:
    """``nvcc --version``'s release line."""
    out = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True,
                         check=True).stdout
    return next((ln.strip() for ln in out.splitlines() if "release" in ln), out.strip())


def library_key() -> str:
    """The library's cache key: what it was built from and for."""
    import torch

    files = sources() + sorted(CSRC_DIR.glob("*.cuh"))
    return cache_key("kernels", _digest(files), nvcc_release(), torch.version.cuda,
                     torch.cuda.get_device_capability())


def use_cache(cache: CompileCache) -> None:
    """Build or load the library through ``cache`` (one with a directory)
    at the first kernel call of this process."""
    global _cache
    if cache.cache_dir:
        _cache = cache


def library_cache(cache: CompileCache | None = None) -> CompileCache:
    """``cache`` if it has a directory, else the one handed to
    ``use_cache``, else ``TPU_COMPILE_CACHE_DIR``'s or the package's."""
    global _default_cache
    for c in (cache, _cache):
        if c is not None and c.cache_dir:
            return c
    if _default_cache is None:
        _default_cache = CompileCache(os.environ.get(CACHE_DIR_ENV) or str(BUILD_DIR))
    return _default_cache


def build_log_path() -> Path:
    """The nvcc output of the library's build in ``library_cache()``."""
    return Path(library_cache().path(library_key(), ".log"))


def _compile_and_link(root: Path, key: str) -> Path:
    """Compile and link the kernels into ``<root>/<key>.so``."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    nvcc = nvcc_path()
    work = root / f"{key}.build"
    work.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for s in srcs:
        obj = work / f"{s.stem}.o"
        objs.append(obj)
        procs.append((s, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    log = []
    failed = []
    for s, p in procs:
        out, _ = p.communicate()
        log.append(f"== nvcc {s.name} (rc={p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(s.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    lib_path = root / f"{key}.so"
    tmp = work / "link.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    log.append(f"== link (rc={link.returncode})\n{link.stdout}")
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
    (root / f"{key}.log").write_text("\n".join(log))
    os.replace(tmp, lib_path)
    return lib_path


def _open(path: Path) -> ctypes.CDLL:
    handle = ctypes.CDLL(str(path))
    for name, (args, res) in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = args
        fn.restype = res
    return handle


def _unpack(root: Path, key: str, payload: bytes) -> ctypes.CDLL:
    """A CRC-checked payload written out as ``<key>.so`` (atomic rename)
    and loaded."""
    path = root / f"{key}.so"
    tmp = root / f"{key}.so.tmp{os.getpid()}"
    tmp.write_bytes(payload)
    os.replace(tmp, path)
    return _open(path)


def open_library(cache: CompileCache) -> ctypes.CDLL:
    """The library through ``cache`` (which has a directory): loaded from
    its entry, else built and persisted there, under the directory's file
    lock (builders in other processes wait, then load)."""
    root = Path(cache.cache_dir)
    key = library_key()
    codec = Codec(serialize=lambda h: Path(h._name).read_bytes(),
                  deserialize=lambda b: _unpack(root, key, b))
    with open(root / "build.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        return cache.get_or_compile(
            key, lambda: _open(_compile_and_link(root, key)),
            meta=lambda: {"tag": "kernels", "sources": [s.name for s in sources()],
                          "nvcc": nvcc_release()},
            codec=codec)


def lib(cache: CompileCache | None = None) -> ctypes.CDLL:
    """The loaded kernel library (built or loaded through
    ``library_cache(cache)`` on the first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = open_library(library_cache(cache))
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib().egs_error_string(err)
        raise RuntimeError(
            f"{what}: CUDA error {err} "
            f"({msg.decode() if msg else 'unknown'})"
        )


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer value."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
