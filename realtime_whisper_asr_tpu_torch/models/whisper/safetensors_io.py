"""A reader and a writer of the safetensors format, in torch and numpy only.

The format (https://github.com/huggingface/safetensors, "Format"):

- 8 bytes: the header's length N, an unsigned little-endian 64-bit integer;
- N bytes: a UTF-8 JSON object mapping each tensor's name to
  ``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets into the
  data that follows the header), plus an optional ``"__metadata__"`` object
  of strings;
- the tensors' bytes, little-endian, row-major, back to back.

The reader maps the file (``np.memmap``, copy-on-write) and hands out views
of it, so a multi-GB checkpoint is not held twice in host memory; the pages
are read when a tensor is used. bf16 has no numpy dtype: its bytes are read
as int16 and reinterpreted by torch. The writer streams one tensor at a time
into the file. Host byte order is assumed little-endian, as on every
platform the port runs on.
"""

from __future__ import annotations

import json
import struct
import sys
from typing import Mapping

import numpy as np
import torch

#: the format's dtype names the port reads and writes
DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "I32": torch.int32,
    "I64": torch.int64,
}
_NAMES = {v: k for k, v in DTYPES.items()}
#: numpy dtype holding each format dtype's bytes (bf16 as int16)
_NP = {"F32": np.float32, "F16": np.float16, "BF16": np.int16, "I8": np.int8, "U8": np.uint8,
       "I32": np.int32, "I64": np.int64}

assert sys.byteorder == "little", "safetensors_io assumes a little-endian host"


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, as CPU tensors that view a
    copy-on-write map of the file (a tensor whose bytes are not aligned to
    its element size is copied). Raises ``ValueError`` for a dtype outside
    ``DTYPES``."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    start = 8 + n
    mm = np.memmap(path, dtype=np.uint8, mode="c")
    out = {}
    for name, info in header.items():
        fmt = info["dtype"]
        if fmt not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {fmt}, not one of "
                             f"{sorted(DTYPES)}")
        begin, end = info["data_offsets"]
        raw = mm[start + begin : start + end]
        itemsize = np.dtype(_NP[fmt]).itemsize
        if (start + begin) % itemsize:
            raw = np.array(raw)  # an aligned copy
        arr = raw.view(_NP[fmt]).reshape(info["shape"])
        t = torch.from_numpy(arr)
        out[name] = t.view(torch.bfloat16) if fmt == "BF16" else t
    return out


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor]) -> int:
    """Write ``tensors`` (any device; copied to the host one at a time) as a
    safetensors file. The format allows no gap between tensors, so they are
    laid out by element size, largest first (stable in the mapping's order),
    and the header is padded with spaces to a multiple of 8: every tensor's
    bytes then start at a multiple of its element size. Returns the file's
    size in bytes."""
    order = sorted(tensors, key=lambda name: -tensors[name].element_size())
    entries, offset = {}, 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}, not one of "
                             f"{sorted(str(d) for d in _NAMES)}")
        nbytes = t.numel() * t.element_size()
        entries[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                         "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    header = json.dumps(entries, separators=(",", ":")).encode()
    header += b" " * ((-len(header)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        for name in order:
            t = tensors[name].detach().to("cpu").contiguous()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            f.write(t.numpy().reshape(-1).view(np.uint8).data)
        return f.tell()
