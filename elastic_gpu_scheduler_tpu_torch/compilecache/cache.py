"""Persistent compile cache: the port's compiled artifacts, keyed by what
built them, CRC-checked on disk, built once however many threads ask.

Own copy of ``elastic_gpu_scheduler_tpu/compilecache/cache.py``.  The
entry container, the quarantine, the single flight and the counters are
the reference's; only the way a payload becomes a live object differs.
The reference pickles an XLA executable; the port's entries are handed a
``Codec`` (serialize / deserialize) each, or none:

- **the kernel library** (``ops/_build``): its payload is the linked
  ``.so``'s bytes, persisted and loaded back by the next process, so a
  second start on the same directory runs no ``nvcc``;
- **a decode chunk's CUDA graph** (``compilecache/aot``): bound to its
  process and its engine's tensors, it has no codec and lives in memory
  only; a replay of one already captured is a ``hit``, a capture a
  ``miss``.

- **Entry format.**  ``<dir>/<key>.aotx``: an 8-byte magic, a
  length-prefixed JSON header carrying the key, a CRC32 of the payload
  and human-auditable metadata, then the payload.  Writes are atomic
  (tmp + rename); a torn or bit-flipped entry fails the CRC and is
  QUARANTINED (renamed ``.bad``) and rebuilt, never fatal.
- **Single-flight.**  Concurrent misses on one key build ONCE: the first
  caller owns the build, the rest park on an event and adopt the winner's
  object (``coalesced``).  A builder that fails hands the build to a
  waiter.
- **Counters.**  hits / loads / misses / fills / coalesced / quarantined /
  persist_errors / fallbacks, exported as ``tpu_compile_cache_events_total``
  and surfaced on ``/v1/stats``.  Nothing in the port falls back, so
  ``fallbacks`` stays 0; it is kept so the stats read as the reference's.

Trust model: the cache dir is operator-owned state, the same trust domain
as a model checkpoint dir: the CRC detects corruption, not tampering.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import threading
import zlib
from hashlib import blake2b
from typing import Any, Callable, NamedTuple, Optional

from ..metrics import COMPILE_CACHE_EVENTS

log = logging.getLogger("tpu-scheduler")

_MAGIC = b"TPUAOTC1"
_SUFFIX = ".aotx"


class Codec(NamedTuple):
    """How an entry's live object becomes payload bytes and back."""

    serialize: Callable[[Any], bytes]
    deserialize: Callable[[bytes], Any]


def cache_key(*parts) -> str:
    """Stable hex digest over the fingerprint parts (stringified in
    order).  Callers include everything that changes the built artifact:
    tag, sources or engine config, shapes, toolchain and device."""
    h = blake2b(digest_size=16)
    for p in parts:
        h.update(repr(p).encode())
        h.update(b"\x00")
    return h.hexdigest()


class CompileCache:
    """In-memory + optional on-disk cache with single-flight builds.
    ``cache_dir=None`` keeps the single-flight memo and counters but
    persists nothing (the warm-up still works; its warmth just does not
    survive the process)."""

    def __init__(self, cache_dir: Optional[str] = None):
        self.cache_dir = cache_dir or None
        if self.cache_dir:
            try:
                os.makedirs(self.cache_dir, exist_ok=True)
            except OSError as e:
                # the cache can only ADD warmth, never take down serving:
                # an unwritable dir degrades to in-memory only
                log.warning(
                    "compile cache: cannot create %s (%s); running "
                    "without persistence", self.cache_dir, e,
                )
                self.cache_dir = None
        self._mem: dict[str, object] = {}  # key → live object
        self._lock = threading.Lock()  # memo + inflight bookkeeping
        self._inflight: dict[str, threading.Event] = {}
        self.hits = 0
        self.loads = 0
        self.misses = 0
        self.fills = 0
        self.coalesced = 0
        self.quarantined = 0
        self.persist_errors = 0
        self.fallbacks = 0

    # -- events --------------------------------------------------------------

    _EVENT_ATTR = {
        "hit": "hits",
        "load": "loads",
        "miss": "misses",
        "fill": "fills",
        "coalesced": "coalesced",
        "quarantined": "quarantined",
        "persist_error": "persist_errors",
        "fallback": "fallbacks",
    }

    def _event(self, name: str) -> None:
        attr = self._EVENT_ATTR[name]
        setattr(self, attr, getattr(self, attr) + 1)
        COMPILE_CACHE_EVENTS.inc(name)

    # -- disk format ---------------------------------------------------------

    def path(self, key: str, suffix: str = _SUFFIX) -> str:
        """``<dir>/<key><suffix>``: the entry, or a file derived from it."""
        return os.path.join(self.cache_dir, key + suffix)

    def _write_entry(self, key: str, payload: bytes, meta: dict) -> None:
        header = json.dumps({
            "key": key,
            "crc": zlib.crc32(payload) & 0xFFFFFFFF,
            "len": len(payload),
            "meta": meta,
        }, sort_keys=True).encode()
        path = self.path(key)
        tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<I", len(header)))
            f.write(header)
            f.write(payload)
        os.replace(tmp, path)  # atomic: readers see whole entries only

    def _quarantine(self, key: str, why) -> None:
        self._event("quarantined")
        path = self.path(key)
        try:
            os.replace(path, path + ".bad")
        except OSError:
            try:
                os.remove(path)
            except OSError:
                pass
        log.warning("compile cache: quarantined corrupt entry %s (%s)", path, why)

    def _read_entry(self, key: str) -> Optional[bytes]:
        """Payload bytes for a valid entry, None for absent, and a
        QUARANTINE (rename to .bad + None) for anything corrupt: a bad
        entry must cost one rebuild, never a crash loop."""
        path = self.path(key)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            return None
        except OSError as e:
            log.warning("compile cache: unreadable entry %s: %s", path, e)
            return None
        try:
            if blob[: len(_MAGIC)] != _MAGIC:
                raise ValueError("bad magic")
            off = len(_MAGIC)
            (hlen,) = struct.unpack_from("<I", blob, off)
            off += 4
            header = json.loads(blob[off: off + hlen])
            off += hlen
            payload = blob[off:]
            if header.get("key") != key:
                raise ValueError("key mismatch")
            if len(payload) != int(header.get("len", -1)):
                raise ValueError("truncated payload")
            if (zlib.crc32(payload) & 0xFFFFFFFF) != int(header["crc"]):
                raise ValueError("CRC mismatch")
            return payload
        except (ValueError, KeyError, struct.error, json.JSONDecodeError) as e:
            self._quarantine(key, e)
            return None

    def _load(self, key: str, codec: Optional[Codec]):
        """The live object of a persistent entry, or None.  An entry that
        passes its CRC but does not deserialize (a library the loader
        refuses) is quarantined like a CRC failure."""
        if not self.cache_dir or codec is None:
            return None
        payload = self._read_entry(key)
        if payload is None:
            return None
        try:
            return codec.deserialize(payload)
        except (OSError, ValueError) as e:
            self._quarantine(key, f"failed to deserialize: {e}")
            return None

    def _persist(self, key: str, obj, meta, codec: Optional[Codec]) -> None:
        if not self.cache_dir or codec is None:
            return
        try:
            # meta may be a thunk: computed only on this (rare) path
            self._write_entry(key, codec.serialize(obj),
                              meta() if callable(meta) else (meta or {}))
        except OSError as e:  # persistence is best-effort
            self._event("persist_error")
            log.warning("compile cache: could not persist %s (%s); serving the "
                        "in-process object", key, e)
            return
        self._event("fill")

    # -- the one entry point -------------------------------------------------

    def get_or_compile(self, key: str, build: Callable[[], object], meta=None,
                       codec: Optional[Codec] = None):
        """The object for ``key``: in-memory hit, else persistent load
        (entries with a ``codec``), else ``build()`` + persist.  Concurrent
        callers for one key coalesce behind a single builder.  ``meta``
        (dict or zero-arg thunk) lands in the entry header."""
        with self._lock:
            obj = self._mem.get(key)
            if obj is not None:
                self._event("hit")
                return obj
            ev = self._inflight.get(key)
            if ev is None:
                self._inflight[key] = threading.Event()
            # else: someone is building; fall through to wait
        if ev is not None:
            self._event("coalesced")
            ev.wait()
            with self._lock:
                obj = self._mem.get(key)
            if obj is not None:
                return obj
            # the builder failed: take over the build
            return self.get_or_compile(key, build, meta, codec)
        try:
            obj = self._load(key, codec)
            if obj is not None:
                self._event("load")
            else:
                self._event("miss")
                obj = build()
                self._persist(key, obj, meta or {}, codec)
            with self._lock:
                self._mem[key] = obj
            return obj
        finally:
            with self._lock:
                ev2 = self._inflight.pop(key, None)
            if ev2 is not None:
                ev2.set()

    # -- introspection -------------------------------------------------------

    def entries(self) -> int:
        with self._lock:
            return len(self._mem)

    def disk_entries(self) -> int:
        if not self.cache_dir:
            return 0
        try:
            return sum(1 for n in os.listdir(self.cache_dir) if n.endswith(_SUFFIX))
        except OSError:
            return 0

    def stats(self) -> dict:
        return {
            "dir": self.cache_dir or "",
            "entries": self.entries(),
            "disk_entries": self.disk_entries(),
            "hits": self.hits,
            "loads": self.loads,
            "misses": self.misses,
            "fills": self.fills,
            "coalesced": self.coalesced,
            "quarantined": self.quarantined,
            "persist_errors": self.persist_errors,
            "fallbacks": self.fallbacks,
        }
