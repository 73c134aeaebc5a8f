"""Rolling BLAKE2b prefix-digest chain: the prefix cache's content address.

The port's own copy of ``elastic_gpu_scheduler_tpu/utils/prefixdigest.py``
(the port imports nothing of the JAX package).  The serving engine's
prefix cache (``models/serving.py``) keys cached K/V pages by this chain,
and the reference's fleet router computes the same chain over incoming
prompts to route a conversation to the replica holding its prefix, so the
digests must stay byte-identical to the reference's: each link is a
16-byte BLAKE2b digest over (previous link, the page's raw native int32
token bytes), seeded by the adapter id.
"""

from __future__ import annotations

import hashlib
from array import array
from typing import Iterable

__all__ = ["prefix_seed", "prefix_page_key", "page_digests"]


def prefix_seed(adapter_id: int) -> bytes:
    """Chain seed: K/V content depends on the adapter (wk/wv deltas), so
    pages cached under one adapter must never match another's prompts."""
    return b"lora:" + int(adapter_id).to_bytes(4, "little")


def prefix_page_key(prev: bytes, toks_bytes: bytes) -> bytes:
    """One link of the chain: a 16-byte BLAKE2b digest over (previous
    link, this page's raw int32 token bytes)."""
    return hashlib.blake2b(prev + toks_bytes, digest_size=16).digest()


def token_bytes(tokens: Iterable[int]) -> bytes:
    """Native int32 byte layout, identical to an ``np.int32`` row's
    ``tobytes()``."""
    return array("i", tokens).tobytes()


def page_digests(
    tokens, page_size: int, adapter_id: int = 0, max_pages: int = 0,
    seed: bytes = b"",
) -> list[bytes]:
    """The digest chain for a token sequence: one digest per FULL page
    (a partial trailing page is never cacheable).  ``max_pages`` > 0
    bounds the work; ``seed`` overrides the adapter-id seed."""
    ps = int(page_size)
    if ps <= 0:
        return []
    toks = list(tokens)
    n_pages = len(toks) // ps
    if max_pages > 0:
        n_pages = min(n_pages, max_pages)
    key = seed or prefix_seed(adapter_id)
    out: list[bytes] = []
    for j in range(n_pages):
        key = prefix_page_key(key, token_bytes(toks[j * ps:(j + 1) * ps]))
        out.append(key)
    return out
