"""An Orbax ``StandardSave`` step directory as a nested tree of arrays, and back.

The layout that orbax-checkpoint 0.11 writes (and reads)::

    <step>/_CHECKPOINT_METADATA          JSON: item handlers, timestamps, custom metadata
    <step>/metrics/metrics               JSON: the step's metrics (a best-tracking manager's)
    <step>/default/_METADATA             JSON: "tree_metadata", one entry per leaf
    <step>/default/_sharding             JSON: each array's sharding
    <step>/default/array_metadatas/process_0
    <step>/default/manifest.ocdbt, d/... the OCDBT store of zarr v2 arrays

A leaf's entry in ``tree_metadata`` is keyed by the repr of its key tuple and
lists each key with its type: 2 for a dict key or a field (of a dataclass or
named tuple), 1 for a sequence index. Its array is the zarr array named by
the keys joined with ``.``. A leaf with ``"skip_deserialize": true`` is an
empty node (optax's ``EmptyState``) and holds no array.

:func:`read_tree` returns dicts and lists (by key type) with numpy leaves
(``torch.bfloat16`` tensors for bfloat16) and ``None`` for empty nodes;
:func:`write_tree` takes the same, with :class:`Fields` for a struct whose
field order is kept (a plain dict's keys are sorted, as JAX flattens it).
"""

from __future__ import annotations

import base64
import json
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from . import ocdbt, zarr

ITEM = "default"
METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
METRICS = os.path.join("metrics", "metrics")
STANDARD_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
                    "StandardCheckpointHandler")
JSON_HANDLER = "orbax.checkpoint._src.handlers.json_checkpoint_handler.JsonCheckpointHandler"
DICT_KEY, SEQUENCE_KEY = 2, 1
# The sharding _sharding records for each array: one device of the host.
SHARDING = json.dumps({"sharding_type": "SingleDeviceSharding", "device_str": "TFRT_CPU_0"})


class Fields(dict):
    """A struct's fields (a ``TrainState``, optax's named tuples): written in this order."""


def is_step(step_dir: str) -> bool:
    """Whether ``step_dir`` holds an Orbax checkpoint."""
    return (os.path.isfile(os.path.join(step_dir, CHECKPOINT_METADATA))
            and os.path.isdir(os.path.join(step_dir, ITEM)))


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def read_metrics(step_dir: str) -> Dict[str, float]:
    """The step's metrics: ``metrics/metrics``, else those in ``_CHECKPOINT_METADATA``."""
    path = os.path.join(step_dir, METRICS)
    if os.path.isfile(path):
        return _read_json(path)
    return _read_json(os.path.join(step_dir, CHECKPOINT_METADATA)).get("metrics") or {}


def read_custom_metadata(step_dir: str) -> dict:
    return _read_json(os.path.join(step_dir, CHECKPOINT_METADATA)).get("custom_metadata") or {}


def _build(entries: List[Tuple[List[dict], Any]], path: Tuple[str, ...] = ()):
    """Nested dicts / lists from (key metadata, leaf) pairs that share ``path``."""
    if len(entries) == 1 and len(entries[0][0]) == len(path):
        return entries[0][1]
    children: Dict[str, List] = {}
    types = set()
    for keys, leaf in entries:
        if len(keys) == len(path):
            raise ValueError(f"Orbax tree: {'/'.join(path)} is both a leaf and a node")
        km = keys[len(path)]
        types.add(km["key_type"])
        children.setdefault(str(km["key"]), []).append((keys, leaf))
    if len(types) != 1 or types - {DICT_KEY, SEQUENCE_KEY}:
        raise ValueError(f"Orbax tree: keys of types {sorted(types)} under {'/'.join(path)}")
    built = {k: _build(v, (*path, k)) for k, v in children.items()}
    if types == {SEQUENCE_KEY}:
        order = sorted(built, key=int)
        if [int(k) for k in order] != list(range(len(order))):
            raise ValueError(f"Orbax tree: indices {order} under {'/'.join(path)}")
        return [built[k] for k in order]
    return built


def read_tree(step_dir: str):
    """The tree of the Orbax step in ``step_dir``, its arrays decoded on up to 8 threads."""
    item = os.path.join(step_dir, ITEM)
    meta = _read_json(os.path.join(item, METADATA))
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{item}: only OCDBT stores of zarr v2 arrays are read "
                         f"(use_ocdbt={meta.get('use_ocdbt')}, use_zarr3={meta.get('use_zarr3')})")
    kv = ocdbt.read_kv(item)
    leaves = []
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        skip = entry["value_metadata"].get("skip_deserialize", False)
        leaves.append((keys, None if skip else ".".join(str(k["key"]) for k in keys)))
    names = [n for _, n in leaves if n is not None]
    stored = {k[: -len("/.zarray")] for k in kv if k.endswith("/.zarray")}
    extra = sorted(stored - set(names))
    if extra:
        raise ValueError(f"{item}: arrays {extra} are in the store but not in {METADATA}")
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        arrays = dict(zip(names, pool.map(lambda n: zarr.decode(n, kv), names)))
    return _build([(keys, None if n is None else arrays[n]) for keys, n in leaves])


def _flatten(node, path: Tuple[Tuple[str, int], ...], out: List) -> None:
    if isinstance(node, dict):
        keys = node if isinstance(node, Fields) else sorted(node)
        for k in keys:
            _flatten(node[k], (*path, (str(k), DICT_KEY)), out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(v, (*path, (str(i), SEQUENCE_KEY)), out)
    else:
        out.append((path, node))


def _write_json(path: str, value) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(value, f)


def write_tree(step_dir: str, tree, *, metrics: Optional[Dict[str, float]] = None,
               custom_metadata: Optional[dict] = None) -> int:
    """Write ``tree`` as an Orbax step at ``step_dir`` (which must not exist); returns its bytes.

    The step is written in a temporary directory beside it and renamed into
    place, so a reader never sees a partial step.
    """
    if os.path.exists(step_dir):
        raise FileExistsError(f"{step_dir} exists")
    started = time.time_ns()
    tmp = f"{step_dir}.orbax-checkpoint-tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    item = os.path.join(tmp, ITEM)
    try:
        os.makedirs(item)
        leaves: List = []
        _flatten(tree, (), leaves)
        tree_metadata, kv, shardings, arrays = {}, {}, {}, []
        for path, value in leaves:
            key = str(tuple(k for k, _ in path))
            keys = [{"key": k, "key_type": t} for k, t in path]
            if value is None:
                tree_metadata[key] = {"key_metadata": keys, "value_metadata": {
                    "value_type": "None", "skip_deserialize": True}}
                continue
            name = ".".join(k for k, _ in path)
            encoded = zarr.encode(name, value)
            shape = json.loads(encoded[f"{name}/.zarray"])["shape"]
            kv.update(encoded)
            tree_metadata[key] = {"key_metadata": keys, "value_metadata": {
                "value_type": "jax.Array", "skip_deserialize": False, "write_shape": shape}}
            shardings[base64.b64encode(name.encode()).decode()] = SHARDING
            arrays.append({"array_metadata": {"param_name": name, "write_shape": shape,
                                              "chunk_shape": shape, "ext_metadata": None}})
        ocdbt.write_kv(item, kv)
        _write_json(os.path.join(item, METADATA), {
            "tree_metadata": tree_metadata, "use_ocdbt": True, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True, "custom_metadata": None})
        _write_json(os.path.join(item, "_sharding"), shardings)
        _write_json(os.path.join(item, "array_metadatas", "process_0"), {"array_metadatas": arrays})
        handlers = {ITEM: STANDARD_HANDLER}
        if metrics is not None:
            handlers["metrics"] = JSON_HANDLER
            _write_json(os.path.join(tmp, METRICS), {k: float(v) for k, v in metrics.items()})
        _write_json(os.path.join(tmp, CHECKPOINT_METADATA), {
            "item_handlers": handlers, "metrics": {}, "performance_metrics": {},
            "init_timestamp_nsecs": started, "commit_timestamp_nsecs": time.time_ns(),
            "custom_metadata": custom_metadata or {}})
        size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(tmp) for f in fs)
        os.rename(tmp, step_dir)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return size
