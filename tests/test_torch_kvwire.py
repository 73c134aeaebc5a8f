"""The port's KV-page wire format against the reference's.

``elastic_gpu_scheduler_tpu_torch/utils/kvwire.py`` is an own copy of
``elastic_gpu_scheduler_tpu/utils/kvwire.py``: for the same header, pages
and seed the bundle must be byte-identical (the same ``sort_keys`` JSON,
CRC framing and 16-byte chain links), each side must decode the other's
bundles, and every corruption must raise ``WireError`` with the
reference's message.  Headers, pages and seeds are drawn from seeded
numpy generators; the corruptions are every truncation and every
single-byte flip of a bundle, plus crafted frames (a bad magic, trailing
bytes, a version, a malformed seed, a header that is not JSON, tokens not
int32-aligned, a page grafted from another chain).
"""

import json
import struct
import zlib

import numpy as np
import pytest

from elastic_gpu_scheduler_tpu.utils import kvwire as ref_kvwire
from elastic_gpu_scheduler_tpu.utils import prefixdigest as ref_prefixdigest
from elastic_gpu_scheduler_tpu_torch.utils import kvwire, prefixdigest


def _random_header(rng, session: bool) -> dict:
    hdr = {
        "kind": "session" if session else "prefix",
        "page_size": int(rng.integers(1, 64)),
        "n_layers": int(rng.integers(1, 48)),
        "kv_heads": int(rng.integers(1, 16)),
        "head_dim": int(rng.choice([32, 64, 128])),
        "dtype": str(rng.choice(["float32", "bfloat16", "int8"])),
        "kv_int8": bool(rng.integers(2)),
        "adapter": str(rng.choice(["", "a", "tenant-é"])),
    }
    if session:
        n_out = int(rng.integers(0, 6))
        hdr["request"] = {
            "prompt": rng.integers(0, 32000, int(rng.integers(1, 40))).tolist(),
            "output": rng.integers(0, 32000, n_out).tolist(),
            "max_new_tokens": int(rng.integers(1, 512)),
            "temperature": float(rng.random()),
            "top_k": int(rng.integers(0, 50)),
            "top_p": float(rng.random()),
            "adapter": hdr["adapter"],
            "stop_tokens": rng.integers(0, 32000, 2).tolist(),
            "logprobs": 2,
            "token_logprobs": [float(-x) for x in rng.random(n_out)],
            "top_logprobs": [[[int(t), float(-lp)] for t, lp in
                              zip(rng.integers(0, 32000, 2), rng.random(2))]
                             for _ in range(n_out)],
            "logit_bias": {str(int(k)): float(v) for k, v in
                           zip(rng.integers(0, 32000, 3), rng.standard_normal(3))},
            "frequency_penalty": float(rng.random()),
            "presence_penalty": 0.0,
            "min_tokens": int(rng.integers(0, 4)),
            "priority": int(rng.integers(-2, 3)),
            "seed": int(rng.integers(0, 2**32)),
            "allowed_tokens": [],
            "pool_spills": 0,
        }
    return hdr


def _random_bundle(seed: int, session: bool):
    rng = np.random.default_rng(seed)
    hdr = _random_header(rng, session)
    ps = int(rng.integers(1, 17))
    pages = [
        (rng.integers(-2**31, 2**31 - 1, ps).tolist(),
         rng.integers(0, 256, int(rng.integers(0, 200)), dtype=np.uint8).tobytes())
        for _ in range(int(rng.integers(0, 6)))
    ]
    chain_seed = rng.integers(0, 256, int(rng.integers(0, 24)), dtype=np.uint8).tobytes()
    return hdr, pages, chain_seed


def _small_bundle() -> bytes:
    hdr, pages, chain_seed = _random_bundle(7, session=True)
    pages = [(list(range(4 * j, 4 * j + 4)), bytes([j]) * (9 + j)) for j in range(3)]
    return kvwire.encode_bundle(hdr, pages, chain_seed)


def _decode_error(mod, data: bytes):
    """The WireError message ``mod.decode_bundle`` raises on ``data``, or
    None when it decodes."""
    try:
        mod.decode_bundle(data)
    except mod.WireError as e:
        return str(e)
    return None


def test_constants_match_reference():
    assert kvwire.MAGIC == ref_kvwire.MAGIC
    assert kvwire.KV_SOURCE_HEADER == ref_kvwire.KV_SOURCE_HEADER
    assert sorted(kvwire.__all__) == sorted(ref_kvwire.__all__)
    assert issubclass(kvwire.WireError, ValueError)


@pytest.mark.parametrize("seed", range(6))
def test_bundle_bytes_identical_to_reference(seed):
    hdr, pages, chain_seed = _random_bundle(seed, session=seed % 2 == 1)
    data = kvwire.encode_bundle(hdr, pages, chain_seed)
    assert data == ref_kvwire.encode_bundle(hdr, pages, chain_seed)
    # the caller's header is not mutated, on either side
    assert "v" not in hdr and "pages" not in hdr


@pytest.mark.parametrize("seed", range(4))
def test_each_side_decodes_the_others_bundles(seed):
    hdr, pages, chain_seed = _random_bundle(100 + seed, session=True)
    mine = kvwire.encode_bundle(hdr, pages, chain_seed)
    theirs = ref_kvwire.encode_bundle(hdr, pages, chain_seed)
    got_h, got_p = kvwire.decode_bundle(theirs)
    want_h, want_p = ref_kvwire.decode_bundle(mine)
    assert got_h == want_h and got_p == want_p == pages
    assert got_h["pages"] == len(pages) and got_h["v"] == 1
    assert got_h["seed"] == chain_seed.hex()
    assert {k: v for k, v in got_h.items() if k not in ("v", "pages", "seed")} == \
        json.loads(json.dumps(hdr))


def test_every_truncation_raises_the_reference_error():
    data = _small_bundle()
    for n in range(len(data)):
        want = _decode_error(ref_kvwire, data[:n])
        assert want is not None, n
        assert _decode_error(kvwire, data[:n]) == want, n


def test_every_byte_flip_raises_the_reference_error():
    data = _small_bundle()
    for off in range(len(data)):
        bad = bytearray(data)
        bad[off] ^= 0xFF
        want = _decode_error(ref_kvwire, bytes(bad))
        assert want is not None, off
        assert _decode_error(kvwire, bytes(bad)) == want, off


def _reframe(data: bytes, hjson: bytes) -> bytes:
    """``data`` with its header JSON replaced (length and CRC redone)."""
    off = len(kvwire.MAGIC)
    (hlen,) = struct.unpack_from("<I", data, off)
    rest = data[off + 4 + hlen + 4:]
    return (kvwire.MAGIC + struct.pack("<I", len(hjson)) + hjson
            + struct.pack("<I", zlib.crc32(hjson)) + rest)


def _header_json(data: bytes) -> dict:
    off = len(kvwire.MAGIC)
    (hlen,) = struct.unpack_from("<I", data, off)
    return json.loads(data[off + 4:off + 4 + hlen])


def _unaligned_page_bundle() -> bytes:
    """A one-page bundle, every frame valid, whose token bytes are 5 long."""
    chain_seed = b"seed"
    hjson = json.dumps({"pages": 1, "seed": chain_seed.hex(), "v": 1},
                       sort_keys=True).encode()
    tb, payload = b"\x01\x00\x00\x00\x02", b"xyz"
    link = prefixdigest.prefix_page_key(chain_seed, tb)
    return (kvwire.MAGIC + struct.pack("<I", len(hjson)) + hjson
            + struct.pack("<I", zlib.crc32(hjson)) + struct.pack("<I", len(tb)) + tb
            + link + struct.pack("<I", len(payload)) + payload
            + struct.pack("<I", zlib.crc32(tb + link + payload)))


def _grafted_bundle() -> bytes:
    """Two pages whose second record was framed under another chain."""
    hdr = {"kind": "prefix"}
    pages = [([1, 2, 3, 4], b"p0" * 5), ([5, 6, 7, 8], b"p1" * 5)]
    two = kvwire.encode_bundle(hdr, pages, b"seed")
    alone = kvwire.encode_bundle(hdr, pages[1:], b"seed")
    rec = 4 + 16 + 16 + 4 + 10 + 4  # one page record's bytes
    return two[:-rec] + alone[-rec:]


CRAFTED = {
    "bad magic": lambda d: b"TPUKV2\n" + d[len(kvwire.MAGIC):],
    "not a bundle": lambda d: b"",
    "trailing bytes": lambda d: d + b"\x00\x01",
    "version 2": lambda d: _reframe(d, json.dumps(dict(_header_json(d), v=2)).encode()),
    "no version": lambda d: _reframe(d, json.dumps(
        {k: v for k, v in _header_json(d).items() if k != "v"}).encode()),
    "malformed seed": lambda d: _reframe(d, json.dumps(dict(_header_json(d), seed="zz")).encode()),
    "header not JSON": lambda d: _reframe(d, b"{not json"),
    "more pages than shipped": lambda d: _reframe(
        d, json.dumps(dict(_header_json(d), pages=_header_json(d)["pages"] + 1)).encode()),
    "tokens not int32-aligned": lambda d: _unaligned_page_bundle(),
    "grafted page": lambda d: _grafted_bundle(),
}


@pytest.mark.parametrize("case", sorted(CRAFTED))
def test_crafted_faults_raise_the_reference_error(case):
    bad = CRAFTED[case](_small_bundle())
    want = _decode_error(ref_kvwire, bad)
    assert want is not None
    assert _decode_error(kvwire, bad) == want


def test_roundtrip_and_corruption():
    """The reference's own wire test, on the port's copy."""
    pages = [
        (list(range(8)), b"payload-zero" * 7),
        (list(range(8, 16)), b"payload-one-" * 7),
        (list(range(16, 24)), b"payload-two-" * 7),
    ]
    hdr = {"kind": "prefix", "page_size": 8, "adapter": ""}
    data = kvwire.encode_bundle(hdr, pages, b"seed")
    out_hdr, out_pages = kvwire.decode_bundle(data)
    assert out_hdr["kind"] == "prefix" and out_hdr["pages"] == 3
    assert out_pages == pages
    for off in (len(kvwire.MAGIC) + 2, len(data) // 2, len(data) - 3):
        bad = bytearray(data)
        bad[off] ^= 0xFF
        with pytest.raises(kvwire.WireError):
            kvwire.decode_bundle(bytes(bad))
    with pytest.raises(kvwire.WireError):
        kvwire.decode_bundle(data[:-10])
    # a reordered run is self-consistent: its chain is rebuilt in order
    swapped = kvwire.encode_bundle(hdr, [pages[1], pages[0]], b"seed")
    assert kvwire.decode_bundle(swapped)[1] == [pages[1], pages[0]]


def test_prefixdigest_matches_reference():
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 32000, 70).tolist()
    assert prefixdigest.token_bytes(toks) == ref_prefixdigest.token_bytes(toks)
    assert prefixdigest.token_bytes(toks) == np.asarray(toks, np.int32).tobytes()
    for adapter_id in (0, 3):
        assert prefixdigest.prefix_seed(adapter_id) == ref_prefixdigest.prefix_seed(adapter_id)
        assert prefixdigest.page_digests(toks, 16, adapter_id) == \
            ref_prefixdigest.page_digests(toks, 16, adapter_id)
    assert prefixdigest.prefix_page_key(b"x", b"abcd") == \
        ref_prefixdigest.prefix_page_key(b"x", b"abcd")
