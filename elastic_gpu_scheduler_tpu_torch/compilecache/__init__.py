"""Warm-start plane: a replica never builds a kernel or captures a decode
graph on the serving path.

Own copy of ``elastic_gpu_scheduler_tpu/compilecache``, for the port's two
kinds of compiled artifact:

- :mod:`.cache`: the persistent compile cache, CRC-checked entries under
  ``--compile-cache-dir`` with single-flight builds and the reference's
  counters (``tpu_compile_cache_events_total``).  The kernel library
  (``ops/_build``) is one persistent entry: a second start on the same
  directory loads it and runs no ``nvcc``.
- :mod:`.aot`: :class:`AotFunction`, the engine's graph capture routed
  through a cache, so the decode chunk's CUDA graphs are found there (a
  memory-only cache of the engine's own: a graph replays one engine's
  tensors and cannot outlive its process).
- :mod:`.lattice`: the shape-lattice warm-up that loads the library and
  captures every decode graph of the engine's lattice BEFORE the pod
  reports Ready (``tpu_warmup_seconds``); ``/healthz`` answers 503
  ``{"warming": true}`` meanwhile.
"""

from .aot import AotFunction
from .cache import Codec, CompileCache, cache_key
from .lattice import (
    WarmupState,
    start_warmup_thread,
    warmup_engine,
)

__all__ = [
    "AotFunction",
    "Codec",
    "CompileCache",
    "WarmupState",
    "cache_key",
    "start_warmup_thread",
    "warmup_engine",
]
