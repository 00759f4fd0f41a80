"""The safetensors file format, read and written with torch and numpy alone.

A file is an 8-byte little-endian header length n, a JSON header of n bytes
``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{str: str}}`` (offsets relative to the end of the header), then the raw
little-endian bytes of every tensor.

``load_file`` memory-maps the file and returns CPU tensors in their stored
dtype that share its pages, so bf16 is never widened and only the bytes a
caller touches are read. ``save_file`` lays tensors out as the safetensors
package does (sorted by element size, largest first, then by name; the header
padded with spaces to a multiple of 8), so its files load there too.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, Mapping, Union

import numpy as np
import torch

DTYPES: Dict[str, torch.dtype] = {
    "BOOL": torch.bool,
    "U8": torch.uint8,
    "I8": torch.int8,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
    "I16": torch.int16,
    "U16": torch.uint16,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I32": torch.int32,
    "U32": torch.uint32,
    "F32": torch.float32,
    "F64": torch.float64,
    "I64": torch.int64,
    "U64": torch.uint64,
}
NAMES = {v: k for k, v in DTYPES.items()}


def load_file(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """Every tensor of the file, on the CPU in its stored dtype, backed by a
    copy-on-write map of the file (writing to one never reaches the disk)."""
    path = Path(path)
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    base = 8 + n
    if path.stat().st_size == base:
        raw = torch.zeros(0, dtype=torch.uint8)
    else:
        raw = torch.from_numpy(np.memmap(path, dtype=np.uint8, mode="c"))
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        size = dtype.itemsize
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * size:
            raise ValueError(f"{path}: tensor {name!r} holds {end - begin} bytes, "
                             f"its shape and dtype need {count * size}")
        data = raw[base + begin : base + end]
        if (base + begin) % size:  # a view needs its dtype's alignment
            data = data.clone()
        out[name] = data.view(dtype).reshape(shape)
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: Union[str, Path]) -> None:
    """Write ``tensors`` (any device; each is copied to the host in turn)."""
    order = sorted(tensors, key=lambda k: (-tensors[k].dtype.itemsize, k))
    header: Dict[str, object] = {}
    offset = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in NAMES:
            raise ValueError(f"tensor {name!r} has unsupported dtype {t.dtype}")
        nbytes = t.numel() * t.dtype.itemsize
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach().to("cpu").contiguous()
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)
