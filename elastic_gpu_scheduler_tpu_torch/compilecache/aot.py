"""The decode chunk's CUDA graphs through a compile cache.

Counterpart of ``elastic_gpu_scheduler_tpu/compilecache/aot.py``.  There,
``AotFunction`` routes a jitted function's calls through the cache, keyed
by the call's input shapes, so a shape lowered at warm-up never compiles
on the serving path.  The port's counterpart of "lower + compile" is a
CUDA graph capture, and a graph is keyed by the engine's dispatch key (the
table-view bucket and the six control flags), not by tensor shapes: the
port's ``AotFunction`` wraps the engine's capture and finds each graph
through ``CompileCache.get_or_compile``, so a replay of a graph already
captured counts a ``hit`` and a capture a ``miss``.

A graph reads and writes the very tensors it was captured on (the
engine's pool, carry and batch-state mirrors): it cannot be serialized and
belongs to one engine.  So every capturing engine owns a memory-only
cache of its own for its graphs (``InferenceEngine.graph_cache``); the
graphs go when the engine goes.

No fallback: a capture that fails raises to the caller.
"""

from __future__ import annotations

from typing import Callable, Sequence

from .cache import CompileCache, cache_key


class AotFunction:
    """``capture(key, *args)`` routed through a :class:`CompileCache`, one
    memory-only entry per dispatch key.

    ``fingerprint_parts`` must capture everything static that changes a
    captured graph (engine and model config, mesh shape, device); the
    per-call dispatch key is appended."""

    def __init__(self, capture: Callable, cache: CompileCache, fingerprint_parts: Sequence,
                 tag: str = ""):
        self._capture = capture
        self.cache = cache
        self.tag = tag or "aot"
        # digested once: a dispatch hashes only this and its own key
        self._fp = cache_key(self.tag, *fingerprint_parts)
        self.keys: set = set()  # the dispatch keys whose entry is built

    def build(self, key: tuple, *args):
        """The entry for ``key``: the one already captured (a hit), or
        ``capture(key, *args)``'s (a miss)."""
        entry = self.cache.get_or_compile(cache_key(self._fp, key),
                                          lambda: self._capture(key, *args))
        self.keys.add(key)
        return entry
