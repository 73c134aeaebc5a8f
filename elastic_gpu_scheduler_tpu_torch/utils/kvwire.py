"""KV-page wire format: replica-to-replica shipping of paged K/V content.

The port's own copy of ``elastic_gpu_scheduler_tpu/utils/kvwire.py`` (the
port imports nothing of the JAX package).  A bundle must be byte-identical
to the reference's for the same header, pages and seed, so the two
implementations exchange pages in a mixed fleet.

One bundle carries an ordered run of FULL pages, each the raw token ids it
covers plus the engine's serialized K/V payload for those positions,
framed with the journal's conventions: length-prefixed records, a CRC32
per record, and a 16-byte BLAKE2b digest-chain link per page
(``utils/prefixdigest``, the chain the prefix cache and the fleet router
key by).  Three consumers:

- ``/v1/kv/export`` / ``/v1/kv/adopt``: a replica pulls another replica's
  cached prefix pages instead of re-prefilling;
- ``/v1/migrate/out`` → ``/v1/migrate/in``: live session migration, a
  ``kind="session"`` bundle whose header adds the request's state (prompt,
  output so far, sampling parameters, seed);
- the prefill/decode split: a prefill-role replica exports the pages its
  prefill wrote and a decode-role replica imports them before admission.

The payload bytes are opaque here; the engine produces and consumes them
(``models/serving.py`` ``export_prefix_pages`` / ``import_pages``) and
checks the header's geometry.  The receiver re-derives the digest chain
from the shipped token bytes and the header's seed, so a flipped token
byte, a reordered page or a truncated run fails before any K/V lands; a
corrupt payload fails its page's CRC32.
"""

from __future__ import annotations

import json
import struct
import zlib

from . import prefixdigest

__all__ = [
    "KV_SOURCE_HEADER", "MAGIC", "WireError",
    "decode_bundle", "encode_bundle",
]

MAGIC = b"TPUKV1\n"
# router → backend HTTP header naming the replica to pull this prompt's
# prefix pages from before admission (the adoption path)
KV_SOURCE_HEADER = "X-KV-Source"
_U32 = struct.Struct("<I")


class WireError(ValueError):
    """A malformed, corrupt or truncated KV bundle.  Safe to answer as a
    400: nothing was imported when this raises."""


def _u32(data: bytes, off: int) -> tuple[int, int]:
    if off + 4 > len(data):
        raise WireError("truncated bundle (length field)")
    return _U32.unpack_from(data, off)[0], off + 4


def encode_bundle(
    header: dict, pages: list[tuple[list, bytes]], seed: bytes
) -> bytes:
    """Frame ``pages`` ([(token_ids, payload_bytes), ...], chain order)
    under ``header`` (JSON-serializable geometry and request state).
    ``seed`` roots the digest chain and ships in the header (hex); the
    receiver re-derives its registration keys under its own adapter seed,
    so the wire seed needs equality semantics only."""
    hdr = dict(header)
    hdr["v"] = 1
    hdr["pages"] = len(pages)
    hdr["seed"] = seed.hex()
    hjson = json.dumps(hdr, sort_keys=True).encode()
    out = [MAGIC, _U32.pack(len(hjson)), hjson,
           _U32.pack(zlib.crc32(hjson))]
    key = seed
    for toks, payload in pages:
        tb = prefixdigest.token_bytes(toks)
        key = prefixdigest.prefix_page_key(key, tb)
        out.append(_U32.pack(len(tb)))
        out.append(tb)
        out.append(key)  # 16-byte chain link
        out.append(_U32.pack(len(payload)))
        out.append(payload)
        out.append(_U32.pack(zlib.crc32(tb + key + payload)))
    return b"".join(out)


def decode_bundle(data: bytes) -> tuple[dict, list[tuple[list, bytes]]]:
    """→ (header, [(token_ids, payload_bytes), ...]) after checking the
    magic, every CRC and the digest chain.  Raises WireError on any
    integrity failure; partial results are never returned."""
    if not data.startswith(MAGIC):
        raise WireError("bad magic (not a KV bundle)")
    off = len(MAGIC)
    hlen, off = _u32(data, off)
    if off + hlen + 4 > len(data):
        raise WireError("truncated bundle (header)")
    hjson = data[off:off + hlen]
    off += hlen
    hcrc, off = _u32(data, off)
    if zlib.crc32(hjson) != hcrc:
        raise WireError("header CRC mismatch")
    try:
        header = json.loads(hjson)
    except ValueError as e:
        raise WireError(f"header not JSON: {e}") from None
    if header.get("v") != 1:
        raise WireError(f"unsupported bundle version {header.get('v')!r}")
    try:
        key = bytes.fromhex(header.get("seed", ""))
    except ValueError:
        raise WireError("malformed chain seed") from None
    n_pages = int(header.get("pages", 0))
    pages: list[tuple[list, bytes]] = []
    for j in range(n_pages):
        tlen, off = _u32(data, off)
        if off + tlen + 16 > len(data):
            raise WireError(f"truncated bundle (page {j} tokens)")
        tb = data[off:off + tlen]
        off += tlen
        link = data[off:off + 16]
        off += 16
        plen, off = _u32(data, off)
        if off + plen + 4 > len(data):
            raise WireError(f"truncated bundle (page {j} payload)")
        payload = data[off:off + plen]
        off += plen
        crc, off = _u32(data, off)
        if zlib.crc32(tb + link + payload) != crc:
            raise WireError(f"page {j} CRC mismatch")
        key = prefixdigest.prefix_page_key(key, tb)
        if key != link:
            raise WireError(
                f"page {j} digest-chain break (corrupt or reordered)"
            )
        if tlen % 4:
            raise WireError(f"page {j} token bytes not int32-aligned")
        toks = list(struct.unpack(f"<{tlen // 4}i", tb))
        pages.append((toks, payload))
    if off != len(data):
        raise WireError(f"{len(data) - off} trailing bytes after last page")
    return header, pages
