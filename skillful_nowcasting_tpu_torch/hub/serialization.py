"""The JAX package's native model format: ``config.json`` + ``flax_model.msgpack``.

Port of ``skillful_nowcasting_tpu/hub/serialization.py``, which writes a
variable tree with ``flax.serialization.msgpack_serialize``. The port imports
neither flax nor msgpack; it writes and reads the same bytes with
:mod:`.msgpack`, following flax's encoding:

* every map goes out with its keys sorted, at every level (flax copies the
  tree with ``jax.tree_util.tree_map`` first, which sorts dict keys), and
  tuples and lists go out as ``{"0": .., "1": ..}`` maps;
* an array is ext 1 holding the msgpack of ``(shape, dtype name, C-order
  bytes)``; a numpy scalar is ext 3 holding the same for its 0-d array; a
  complex number is ext 2 holding ``(real, imag)``;
* an array above :data:`MAX_CHUNK_SIZE` bytes goes out as
  ``{"__msgpack_chunked_array__": True, "shape": {..}, "chunks": {..}}`` of
  flat pieces, in that key order, and is joined again on the way in;
* a ``torch.bfloat16`` tensor goes out under the name ``"bfloat16"`` with
  its raw bits; numpy has no bfloat16, so a bfloat16 leaf comes back as
  float32, its bits widened (exact).

:func:`load_checkpoint` turns the ``{"0": .., "1": ..}`` maps back into
tuples, so each spectral-norm ``uv`` leaf is a ``(u, v)`` tuple again, as the
JAX package's does. An ext code other than 1-3, an unknown dtype name or a
malformed file raises ``ValueError``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from . import msgpack

CONFIG_NAME = "config.json"
FLAX_WEIGHTS_NAME = "flax_model.msgpack"

# flax's limit: msgpack holds at most 2**31 - 1 bytes in one object.
MAX_CHUNK_SIZE = 2**30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


def _array_payload(x) -> bytes:
    """The msgpack of ``(shape, dtype name, C-order bytes)`` of an array or tensor."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy().tobytes()
            return msgpack.packb((tuple(t.shape), "bfloat16", bits))
        x = t.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError(f"cannot serialize an array of dtype {x.dtype}")
    return msgpack.packb((x.shape, x.dtype.name, x.tobytes("C")))


def _ext(x) -> msgpack.ExtType:
    """flax's ``_msgpack_ext_pack``: the ext object of an array, a numpy scalar or a complex."""
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return msgpack.ExtType(_EXT_NDARRAY, _array_payload(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _array_payload(np.asarray(x)))
    return msgpack.ExtType(_EXT_COMPLEX, msgpack.packb((x.real, x.imag)))


def _nbytes(x) -> Tuple[int, int]:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size(), x.element_size()
    return x.size * x.dtype.itemsize, x.dtype.itemsize


def _chunk(x) -> Dict[str, Any]:
    """flax's ``_chunk``: flat pieces of at most :data:`MAX_CHUNK_SIZE` bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / _nbytes(x)[1]))
    flat = x.reshape(-1)
    pieces = [flat[i : i + size] for i in range(0, flat.shape[0], size)]
    return {_CHUNKED: True, "shape": {str(i): int(n) for i, n in enumerate(x.shape)},
            "chunks": {str(i): _ext(p) for i, p in enumerate(pieces)}}


def _wire_tree(tree: Any) -> Any:
    """The tree as flax hands it to msgpack: maps sorted, sequences as maps, leaves as ext.

    flax packs with ``strict_types``, so a numpy scalar goes to ext 3 even
    where it subclasses a msgpack type (``np.float64`` is a ``float``).
    """
    if isinstance(tree, Mapping):
        return {str(k): _wire_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return _wire_tree({str(i): v for i, v in enumerate(tree)})
    if isinstance(tree, (np.ndarray, torch.Tensor)) and _nbytes(tree)[0] > MAX_CHUNK_SIZE:
        return _chunk(tree)
    if isinstance(tree, (np.ndarray, torch.Tensor, np.generic, complex)):
        return _ext(tree)
    return tree


def msgpack_serialize(tree: Any) -> bytes:
    """The bytes of ``flax.serialization.msgpack_serialize(to_state_dict(tree))``."""
    return msgpack.packb(_wire_tree(tree))


def _ndarray(data: memoryview) -> np.ndarray:
    shape, name, buf = msgpack.unpackb(data)
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"unknown array dtype {name!r} in a msgpack file") from e
    return np.frombuffer(buf, dtype).reshape(shape)


def _ext_hook(code: int, data: memoryview):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == _EXT_COMPLEX:
        real, imag = msgpack.unpackb(data)
        return complex(real, imag)
    raise ValueError(f"unknown msgpack ext code {code} (flax writes 1, 2 and 3)")


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            pieces = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(pieces).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data) -> Any:
    """The tree that ``flax.serialization.msgpack_restore`` reads from ``data``.

    Arrays are numpy views of ``data`` (writable when ``data`` is).
    """
    return _unchunk(msgpack.unpackb(data, ext_hook=_ext_hook))


def _tuplify_spectral(tree: Any) -> Any:
    """Restore tuple leaves: serialization maps tuples to ``{"0": .., "1": ..}``."""
    if isinstance(tree, Mapping):
        if tree and all(isinstance(k, str) and k.isdigit() for k in tree):
            return tuple(_tuplify_spectral(tree[k]) for k in sorted(tree, key=int))
        return {k: _tuplify_spectral(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_tuplify_spectral(v) for v in tree)
    return tree


def _host_tree(tree: Any) -> Any:
    """Every leaf as an array (the JAX package's ``np_tree``); tensors stay tensors, on the host."""
    if isinstance(tree, Mapping):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_host_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return np.asarray(tree)


def save_checkpoint(path: str, config: Dict[str, Any], variables: Mapping[str, Any]) -> int:
    """Write ``config.json`` + ``flax_model.msgpack`` to the directory ``path``.

    ``variables`` is a ``{params, batch_stats, spectral}`` tree of numpy
    arrays or CPU tensors (:func:`~.convert.convert_torch_state_dict` makes
    one from a state dict). Returns the bytes of the weight file.
    """
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, CONFIG_NAME), "w") as f:
        json.dump(config, f, indent=2, sort_keys=True)
    data = msgpack_serialize(_host_tree(variables))
    with open(os.path.join(path, FLAX_WEIGHTS_NAME), "wb") as f:
        f.write(data)
    return len(data)


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Read ``(config, variables)`` from a native checkpoint directory; leaves are numpy arrays."""
    with open(os.path.join(path, CONFIG_NAME)) as f:
        config = json.load(f)
    weights = os.path.join(path, FLAX_WEIGHTS_NAME)
    with open(weights, "rb") as f:
        data = bytearray(os.path.getsize(weights))
        if f.readinto(data) != len(data):
            raise ValueError(f"{weights}: the file changed size while it was read")
    return config, _tuplify_spectral(msgpack_restore(data))
