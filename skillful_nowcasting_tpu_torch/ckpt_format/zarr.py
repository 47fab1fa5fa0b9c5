"""zarr v2 arrays as Orbax writes them into its OCDBT store: ``<name>/.zarray`` and chunks.

A chunk's key is ``<name>/<i>.<j>...`` (``<name>/0`` for a scalar, whose
``chunks`` is ``[]``); chunks tile the array in C order, and a missing chunk
holds the fill value (``null``: zeros). Chunks are zstd frames or raw bytes
(``"compressor": null``). Only C order, no filters and the dtypes below are
read; anything else raises and names the array.

bfloat16 arrays come back as ``torch.bfloat16`` tensors (by their raw bits),
every other dtype as a numpy array. :func:`encode` writes one chunk holding
the whole array, as Orbax does for an unsharded array, declared as zstd and
stored as a raw-block frame.
"""

from __future__ import annotations

import itertools
import json
import math
from typing import Dict, Mapping

import numpy as np
import torch

from . import zstd

DTYPES = {
    "<f4": np.dtype("<f4"), "<f8": np.dtype("<f8"), "<i4": np.dtype("<i4"),
    "<i8": np.dtype("<i8"), "<u4": np.dtype("<u4"), "|b1": np.dtype("bool"),
    "bfloat16": np.dtype("<u2"),  # held as its raw bits, then viewed as torch.bfloat16
}
_FILLS = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}


def parse_zarray(name: str, raw: bytes) -> dict:
    """The checked ``.zarray`` of array ``name``."""
    try:
        meta = json.loads(raw)
    except ValueError as e:
        raise ValueError(f"zarr array {name!r}: .zarray is not JSON ({e})") from None

    def bad(what):
        return ValueError(f"zarr array {name!r}: unsupported {what}")

    if meta.get("zarr_format") != 2:
        raise bad(f"zarr_format {meta.get('zarr_format')!r}")
    if meta.get("dtype") not in DTYPES:
        raise bad(f"dtype {meta.get('dtype')!r}")
    if meta.get("order", "C") != "C":
        raise bad(f"order {meta.get('order')!r}")
    if meta.get("filters"):
        raise bad(f"filters {meta.get('filters')!r}")
    if meta.get("dimension_separator", ".") != ".":
        raise bad(f"dimension_separator {meta.get('dimension_separator')!r}")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise bad(f"compressor {compressor!r}")
    shape, chunks = meta.get("shape"), meta.get("chunks")
    if (not isinstance(shape, list) or not isinstance(chunks, list) or len(shape) != len(chunks)
            or any(c <= 0 for c in chunks)):
        raise bad(f"shape {shape!r} / chunks {chunks!r}")
    return meta


def _decode_chunk(name: str, key: str, raw, meta: dict, out: np.ndarray) -> None:
    """Decode chunk ``raw`` into the C-contiguous ``out`` (one chunk's elements)."""
    buf = out.reshape(-1).view(np.uint8)
    if meta.get("compressor") is None:
        if len(raw) != buf.size:
            raise ValueError(f"zarr array {name!r}: chunk {key!r} holds {len(raw)} bytes, "
                             f"expected {buf.size}")
        buf[:] = np.frombuffer(raw, np.uint8)
        return
    try:
        n = zstd.decompress_into(raw, buf)
    except ValueError as e:
        raise ValueError(f"zarr array {name!r}: chunk {key!r}: {e}") from None
    if n != buf.size:
        raise ValueError(f"zarr array {name!r}: chunk {key!r} decodes to {n} bytes, "
                         f"expected {buf.size}")


def _fill(meta: dict, dtype: np.dtype):
    value = meta.get("fill_value")
    if value is None:
        return 0
    value = _FILLS.get(value, value)
    if meta["dtype"] == "bfloat16":  # the fill value's bits, rounded to bfloat16
        return int(torch.tensor(float(value)).to(torch.bfloat16).view(torch.int16)) & 0xFFFF
    return np.array(value).astype(dtype)


def decode(name: str, kv: Mapping[str, bytes]):
    """Array ``name`` of the store ``kv``: a numpy array, or a ``torch.bfloat16`` tensor."""
    key = f"{name}/.zarray"
    if key not in kv:
        raise KeyError(f"zarr array {name!r}: no {key!r} in the store")
    meta = parse_zarray(name, kv[key])
    dtype = DTYPES[meta["dtype"]]
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    out = np.empty(shape, dtype)
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    if all(g == 1 for g in grid) and shape == chunks:
        # One chunk holding the whole array (what Orbax writes): decode in place.
        ckey = f"{name}/{'.'.join('0' * len(shape)) or '0'}"
        if ckey in kv:
            _decode_chunk(name, ckey, kv[ckey], meta, out)
        else:
            out.fill(_fill(meta, dtype))
    else:
        chunk = np.empty(chunks, dtype)
        for idx in itertools.product(*(range(g) for g in grid)):
            ckey = f"{name}/{'.'.join(map(str, idx))}"
            region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
            if ckey not in kv:
                out[region] = _fill(meta, dtype)
                continue
            _decode_chunk(name, ckey, kv[ckey], meta, chunk)
            out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


def _dtype_name(dtype: np.dtype) -> str:
    for name, d in DTYPES.items():
        if name != "bfloat16" and d == dtype.newbyteorder("<"):
            return name
    raise ValueError(f"no zarr dtype for {dtype}")


def encode(name: str, value) -> Dict[str, bytes]:
    """``{name/.zarray: ..., name/<chunk>: ...}`` for one array (numpy, or a tensor anywhere)."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        bf16 = t.dtype == torch.bfloat16
        array = (t.view(torch.int16) if bf16 else t).numpy()
    else:
        bf16, array = False, np.asarray(value)
    array = np.asarray(array, dtype=array.dtype.newbyteorder("<"), order="C")  # 0-d stays 0-d
    shape = list(array.shape)
    meta = {
        "chunks": shape, "compressor": {"id": "zstd", "level": 1}, "dimension_separator": ".",
        "dtype": "bfloat16" if bf16 else _dtype_name(array.dtype), "fill_value": None,
        "filters": None, "order": "C", "shape": shape, "zarr_format": 2,
    }
    out = {f"{name}/.zarray": json.dumps(meta, sort_keys=True, separators=(",", ":")).encode()}
    ckey = ".".join("0" * len(shape)) or "0"
    out[f"{name}/{ckey}"] = zstd.compress_raw(array.reshape(-1).view(np.uint8))
    return out
