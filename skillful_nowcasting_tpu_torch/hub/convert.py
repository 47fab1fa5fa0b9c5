"""Carry weights of the JAX package across into the port.

:func:`state_dict_from_variables` is the numpy-only logic of
``skillful_nowcasting_tpu/hub/export.py:export_torch_state_dict``: it turns a
``{params, batch_stats, spectral}`` tree of arrays into the reference torch
state-dict schema (HWIO -> OIHW, ``(in, out)`` -> ``(out, in)``, spectral-norm
``parametrizations.weight.original`` / ``.0._u`` / ``.0._v`` keys, BatchNorm
running statistics). Any array type that ``numpy.asarray`` reads will do, so
this module needs no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def _invert_weight(w: np.ndarray) -> np.ndarray:
    if w.ndim == 4:  # HWIO -> OIHW
        return np.transpose(w, (3, 2, 0, 1))
    if w.ndim == 5:  # DHWIO -> OIDHW
        return np.transpose(w, (4, 3, 0, 1, 2))
    if w.ndim == 2:  # (in, out) -> (out, in)
        return np.transpose(w, (1, 0))
    return w


def _walk(tree: Mapping[str, Any], prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping):
            yield from _walk(v, path)
        else:
            yield path, v


def _split(path: str) -> Tuple[str, str]:
    """``"a.b.leaf"`` -> ``("a.b.", "leaf")``; a root leaf has an empty prefix."""
    mod, _, leaf = path.rpartition(".")
    return (f"{mod}." if mod else ""), leaf


def state_dict_from_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert a ``{params, batch_stats, spectral}`` tree to a torch state dict."""
    params = variables.get("params", {})
    batch_stats = variables.get("batch_stats", {})
    spectral = variables.get("spectral", {})

    spectral_mods = {_split(path)[0] for path, _ in _walk(spectral)}
    out: Dict[str, np.ndarray] = {}
    for path, value in _walk(params):
        mod, leaf = _split(path)
        if leaf == "kernel":
            w = _invert_weight(np.asarray(value, np.float32))
            key = "parametrizations.weight.original" if mod in spectral_mods else "weight"
            out[f"{mod}{key}"] = w
        elif leaf == "scale":  # BatchNorm
            out[f"{mod}weight"] = np.asarray(value, np.float32)
        elif leaf in ("bias", "gamma"):
            out[f"{mod}{leaf}"] = np.asarray(value, np.float32)
        else:
            raise ValueError(f"unconvertible param leaf: {path}")

    bn_stats: Dict[str, Dict[str, Any]] = {}
    for path, value in _walk(batch_stats):
        mod, leaf = _split(path)
        bn_stats.setdefault(mod, {})[leaf] = value
    for mod, stats in bn_stats.items():
        out[f"{mod}running_mean"] = np.asarray(stats["mean"], np.float32)
        out[f"{mod}running_var"] = np.asarray(stats["var"], np.float32)
        out[f"{mod}num_batches_tracked"] = np.asarray(0, np.int64)

    for path, (u, v) in _walk(spectral):
        mod = _split(path)[0]  # strip the trailing "uv"
        out[f"{mod}parametrizations.weight.0._u"] = np.asarray(u, np.float32)
        out[f"{mod}parametrizations.weight.0._v"] = np.asarray(v, np.float32)

    # np.array copies: torch.from_numpy would alias the caller's buffers.
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def load_variables(model: nn.Module, variables: Mapping[str, Any]) -> int:
    """Load a JAX variable tree into ``model`` with ``strict=True``.

    The port has no discriminator yet, so a whole-DGMR tree's
    ``discriminator.*`` keys are dropped by name; every other key must match.
    Returns the number dropped.
    """
    sd = state_dict_from_variables(variables)
    kept = {k: v for k, v in sd.items() if not k.startswith("discriminator.")}
    model.load_state_dict(kept, strict=True)
    return len(sd) - len(kept)
