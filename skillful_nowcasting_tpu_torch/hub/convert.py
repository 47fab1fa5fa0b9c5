"""Map weights into the port's state dict: from the JAX package, and from the reference's dialects.

:func:`state_dict_from_variables` is the numpy-only logic of
``skillful_nowcasting_tpu/hub/export.py:export_torch_state_dict``: it turns a
``{params, batch_stats, spectral}`` tree of arrays into the reference torch
state-dict schema (HWIO -> OIHW, ``(in, out)`` -> ``(out, in)``, spectral-norm
``parametrizations.weight.original`` / ``.0._u`` / ``.0._v`` keys, BatchNorm
running statistics). Any array type that ``numpy.asarray`` reads will do, so
this module needs no JAX.

:func:`convert_reference_state_dict` maps a reference torch state dict onto
the port's keys (SURVEY.md quirk Q10, the torch side of
``skillful_nowcasting_tpu/hub/convert.py``):

* parametrization spectral-norm keys are the port's own and pass through;
* old-style spectral-norm keys of ``torch.nn.utils.spectral_norm``
  (``X.weight_orig`` / ``X.weight_u`` / ``X.weight_v``) become
  ``X.parametrizations.weight.original`` / ``.0._u`` / ``.0._v``, and a
  derived ``X.weight`` beside ``weight_orig`` is dropped;
* the ``generator.*`` copies of the three shared stacks that the reference
  DGMR's state dict repeats are dropped
  (``skillful_nowcasting_tpu/hub/pretrained.py:180-198``);
* ``num_batches_tracked`` is kept (the port's BatchNorms have it);
* leaves that the JAX converter ignores (no weight, bias, BN statistic,
  ``gamma`` or spectral-norm key) are dropped.
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


def param_paths(model: nn.Module) -> Dict[str, Tuple[str, ...]]:
    """Each parameter's path in the JAX param tree: the inverse of the ``params`` keys above.

    ``X.parametrizations.weight.original`` and a conv's or linear layer's
    ``X.weight`` are ``X/kernel``, a BatchNorm's ``X.weight`` is ``X/scale``;
    ``bias`` and ``gamma`` keep their names. A ``ModuleList`` entry is one
    JAX module named ``list.i`` (``intermediate_dblocks.0``).
    """
    sn_tail = ".parametrizations.weight.original"
    out = {}
    for name, _ in model.named_parameters():
        if name.endswith(sn_tail):
            mod, leaf = name[: -len(sn_tail)], "kernel"
        else:
            mod, _, leaf = name.rpartition(".")
            if leaf == "weight":
                bn = isinstance(model.get_submodule(mod), nn.modules.batchnorm._BatchNorm)
                leaf = "scale" if bn else "kernel"
        path = []
        for part in mod.split(".") if mod else ():
            if part.isdigit():
                path[-1] = f"{path[-1]}.{part}"
            else:
                path.append(part)
        out[name] = (*path, leaf)
    return out


def load_variables(model: nn.Module, variables: Mapping[str, Any]) -> int:
    """Load a JAX variable tree into ``model`` with ``strict=True``.

    Every key must match, ``discriminator.*`` included: nothing is dropped,
    and the return value (the number of keys dropped) is 0.
    """
    model.load_state_dict(state_dict_from_variables(variables), strict=True)
    return 0


# Leaf names that carry weights or state in either implementation.
_KNOWN_LEAVES = {
    "weight", "bias", "gamma", "running_mean", "running_var", "num_batches_tracked",
    "weight_orig", "weight_u", "weight_v",
}
_OLD_SN = {
    "weight_orig": "parametrizations.weight.original",
    "weight_u": "parametrizations.weight.0._u",
    "weight_v": "parametrizations.weight.0._v",
}


def _strip_duplicate_generator_keys(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop the reference DGMR's ``generator.*`` duplicates of the shared stacks.

    The reference registers ``conditioning_stack``, ``latent_stack`` and
    ``sampler`` both on DGMR and on its ``generator`` (``dgmr.py:108-123``),
    so its state dict holds each twice; the port keeps the top-level copies.
    A state dict with only one of the two (a standalone Generator) passes.
    """
    has_dup = any(k.startswith("generator.") for k in sd) and any(
        not k.startswith(("generator.", "discriminator.")) for k in sd
    )
    if not has_dup:
        return dict(sd)
    return {k: v for k, v in sd.items() if not k.startswith("generator.")}


def convert_reference_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A reference torch state dict (any dialect above) under the port's keys; values unchanged."""
    sd = _strip_duplicate_generator_keys(sd)
    out: Dict[str, Any] = {}
    for key, value in sd.items():
        mod, _, leaf = key.rpartition(".")
        prefix = f"{mod}." if mod else ""
        if "parametrizations" in key.split("."):
            out[key] = value
        elif leaf in _OLD_SN:
            out[prefix + _OLD_SN[leaf]] = value
        elif leaf == "weight" and f"{prefix}weight_orig" in sd:
            continue  # derived W / sigma of the old-style spectral norm
        elif leaf in _KNOWN_LEAVES:
            out[key] = value
    return out
