"""``model.safetensors`` reader and writer in numpy.

The format (the ``safetensors`` package's, which the JAX package calls as
``safetensors.numpy``): a little-endian u64 header length, a JSON header
mapping each tensor name to ``{"dtype", "shape", "data_offsets": [begin,
end]}`` (offsets into the data block) plus an optional ``"__metadata__"``
dict of strings, the header padded with spaces to 8 bytes, then the raw
little-endian bytes of every tensor. The port's hub reads and writes it
itself because the machines that serve the port need not have that package.

:func:`load_file` maps the file with ``np.memmap`` (copy-on-write), so a
tensor's bytes are read only when it is used, for example while it is
copied to the card. BF16 has no numpy dtype: it is kept as its 16-bit
pattern and viewed as ``torch.bfloat16`` on the way out.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional

import numpy as np
import torch

# safetensors dtype name -> (numpy dtype of the stored bytes, torch dtype).
DTYPES = {
    "F64": (np.dtype("<f8"), torch.float64),
    "F32": (np.dtype("<f4"), torch.float32),
    "F16": (np.dtype("<f2"), torch.float16),
    "BF16": (np.dtype("<u2"), torch.bfloat16),
    "I64": (np.dtype("<i8"), torch.int64),
    "I32": (np.dtype("<i4"), torch.int32),
    "I16": (np.dtype("<i2"), torch.int16),
    "I8": (np.dtype("i1"), torch.int8),
    "U8": (np.dtype("u1"), torch.uint8),
    "BOOL": (np.dtype("?"), torch.bool),
}
_BY_TORCH = {td: name for name, (_, td) in DTYPES.items()}
_BY_NUMPY = {nd: name for name, (nd, td) in DTYPES.items() if td is not torch.bfloat16}


def _as_bytes(value) -> tuple[str, tuple, np.ndarray]:
    """``(dtype name, shape, little-endian C-order array)`` of a tensor or array."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype not in _BY_TORCH:
            raise TypeError(f"safetensors: unsupported dtype {t.dtype}")
        name = _BY_TORCH[t.dtype]
        arr = t.view(torch.uint16).numpy() if t.dtype is torch.bfloat16 else t.numpy()
        return name, tuple(t.shape), arr
    arr = np.asarray(value)
    key = arr.dtype.newbyteorder("<")
    if key not in _BY_NUMPY:
        raise TypeError(f"safetensors: unsupported dtype {arr.dtype}")
    name = _BY_NUMPY[key]
    return name, arr.shape, np.ascontiguousarray(arr, DTYPES[name][0])


def save_file(
    tensors: Mapping[str, object], path: str, metadata: Optional[Mapping[str, str]] = None
) -> int:
    """Write ``tensors`` (torch tensors or numpy arrays) to ``path``; returns the bytes written.

    Tensors are stored in the mapping's order; ``metadata`` defaults to
    ``{"format": "pt"}``, the torch writer's.
    """
    header: Dict[str, object] = {"__metadata__": dict(metadata or {"format": "pt"})}
    arrays = []
    offset = 0
    for name, value in tensors.items():
        dtype, shape, arr = _as_bytes(value)
        header[name] = {
            "dtype": dtype,
            "shape": list(shape),
            "data_offsets": [offset, offset + arr.nbytes],
        }
        arrays.append(arr)
        offset += arr.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    # Write aside and rename: tensors that load_file mapped from an older
    # file at ``path`` keep reading that file, never a truncated one.
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for arr in arrays:
            f.write(arr.tobytes())
    os.replace(tmp, path)
    return 8 + len(blob) + offset


def read_header(path: str) -> tuple[int, Dict[str, dict], Dict[str, str]]:
    """``(data offset in the file, {name: entry}, metadata)`` of a safetensors file."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (no header length)")
        (n,) = struct.unpack("<Q", raw)
        if n > os.path.getsize(path) - 8:
            raise ValueError(f"{path}: header length {n} exceeds the file")
        header = json.loads(f.read(n))
    metadata = header.pop("__metadata__", None) or {}
    return 8 + n, header, metadata


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, as CPU tensors over a copy-on-write map of it."""
    start, header, _ = read_header(path)
    size = os.path.getsize(path) - start
    data = np.memmap(path, np.uint8, mode="c", offset=start, shape=(size,)) if size else None
    out: Dict[str, torch.Tensor] = {}
    for name, entry in header.items():
        if entry["dtype"] not in DTYPES:
            raise TypeError(f"{path}: tensor {name!r} has unsupported dtype {entry['dtype']}")
        np_dtype, torch_dtype = DTYPES[entry["dtype"]]
        begin, end = entry["data_offsets"]
        shape = tuple(entry["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * np_dtype.itemsize or not 0 <= begin <= end <= size:
            raise ValueError(
                f"{path}: tensor {name!r} has bad data_offsets {entry['data_offsets']}"
            )
        arr = (data[begin:end] if count else np.empty(0, np.uint8)).view(np_dtype).reshape(shape)
        t = torch.from_numpy(arr)
        out[name] = t.view(torch.bfloat16) if torch_dtype is torch.bfloat16 else t
    return out
