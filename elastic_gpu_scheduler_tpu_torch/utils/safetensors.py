"""Read and write ``.safetensors`` files without the ``safetensors`` package.

The format: an 8-byte little-endian header length N, then N bytes of
JSON mapping each tensor name to ``{"dtype", "shape", "data_offsets":
[begin, end]}`` (offsets into the byte buffer after the header; an
optional ``"__metadata__"`` entry of strings), then the raw little-endian
tensor bytes.  ``load_file`` reads ``F32``, ``F16`` and ``BF16`` (the
dtypes Llama checkpoints are published in) and refuses any other;
``save_file`` writes the same three, with the header padded by spaces to
a multiple of 8 bytes as the reference writer pads it.
"""

from __future__ import annotations

import json
import struct
from typing import Optional

import torch

_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}
_NAMES = {v: k for k, v in _DTYPES.items()}


def load_file(path) -> dict[str, torch.Tensor]:
    """{name: CPU tensor} of one ``.safetensors`` file.  The tensors are
    views of one buffer read whole from disk."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: shorter than a safetensors header")
        (n,) = struct.unpack("<Q", raw)
        header = json.loads(f.read(n))
        buf = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, "
                             f"not one of {sorted(_DTYPES)}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = 1
        for s in shape:
            count *= s
        itemsize = torch.tensor([], dtype=dtype).element_size()
        if end - begin != count * itemsize or end > len(buf):
            raise ValueError(f"{path}: tensor {name!r} has offsets {begin}..{end}, "
                             f"which do not fit {shape} {info['dtype']}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(buf, dtype=dtype, count=count, offset=begin).reshape(shape)
    return out


def save_file(tensors: dict[str, torch.Tensor], path,
              metadata: Optional[dict[str, str]] = None) -> int:
    """Write ``tensors`` (any device; F32, F16 or BF16) to ``path`` in name
    order; returns the bytes written."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    names = sorted(tensors)
    for name in names:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} not in {sorted(_DTYPES)}")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in names:
            t = tensors[name].detach().contiguous().cpu()
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
    return 8 + len(blob) + offset
