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

:func:`convert_torch_state_dict` is the other direction, the counterpart of
``skillful_nowcasting_tpu/hub/convert.py:convert_torch_state_dict``: a state
dict in any of those dialects becomes a ``{params, batch_stats, spectral}``
tree, the inverse of :func:`state_dict_from_variables`.
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
        for leaf in ("mean", "var"):  # a missing one is left for the strict load to name
            if leaf in stats:
                out[f"{mod}running_{leaf}"] = np.asarray(stats[leaf], np.float32)
        out[f"{mod}num_batches_tracked"] = np.asarray(0, np.int64)

    for path, (u, v) in _walk(spectral):
        mod = _split(path)[0]  # strip the trailing "uv"
        out[f"{mod}parametrizations.weight.0._u"] = np.asarray(u, np.float32)
        out[f"{mod}parametrizations.weight.0._v"] = np.asarray(v, np.float32)

    # np.array copies (torch.from_numpy would alias the caller's buffers), in C order, so a
    # transposed kernel is contiguous on the module it is assigned to.
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}


def _module_path(mod: str) -> Tuple[str, ...]:
    """``"intermediate_dblocks.0.conv"`` -> ``("intermediate_dblocks.0", "conv")``."""
    path = []
    for part in mod.split(".") if mod else ():
        if part.isdigit() and path:
            path[-1] = f"{path[-1]}.{part}"
        else:
            path.append(part)
    return tuple(path)


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
        out[name] = (*_module_path(mod), leaf)
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


def _to_jax_layout(w: torch.Tensor) -> torch.Tensor:
    if w.ndim == 4:  # OIHW -> HWIO
        return w.permute(2, 3, 1, 0)
    if w.ndim == 5:  # OIDHW -> DHWIO
        return w.permute(2, 3, 4, 1, 0)
    if w.ndim == 2:  # (out, in) -> (in, out)
        return w.permute(1, 0)
    if w.ndim == 1:
        return w
    raise ValueError(f"unsupported weight ndim: {w.ndim}")


def _leaf(w: torch.Tensor):
    """A numpy copy of ``w``; a bfloat16 tensor, which numpy cannot hold, stays a CPU tensor."""
    w = w.detach().cpu()
    return w.contiguous() if w.dtype == torch.bfloat16 else np.array(w.numpy())


def convert_torch_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """A torch state dict (any dialect above) as ``{params, batch_stats, spectral}``.

    The ``generator.*`` copies are stripped first and old-style spectral-norm
    keys are mapped (:func:`convert_reference_state_dict`). Kernels go OIHW ->
    HWIO, OIDHW -> DHWIO and ``(out, in)`` -> ``(in, out)``; a BatchNorm's
    ``weight`` is its ``scale``, its running statistics are ``batch_stats``
    ``mean`` / ``var``; each ``_u`` / ``_v`` pair is a ``uv`` tuple;
    ``num_batches_tracked`` is dropped, as in the JAX package. Leaves are
    numpy copies (bfloat16: CPU tensors); the collections without a leaf are
    left out.
    """
    sd = {k: torch.as_tensor(v) for k, v in convert_reference_state_dict(state_dict).items()}
    trees: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}, "spectral": {}}
    uv: Dict[str, Dict[str, Any]] = {}
    sn_tail = ".parametrizations.weight."

    def put(collection: str, mod: str, leaf: str, value) -> None:
        node = trees[collection]
        for part in _module_path(mod):
            node = node.setdefault(part, {})
        node[leaf] = value

    for key, value in sd.items():
        if sn_tail in key:
            mod, _, tail = key.partition(sn_tail)
            if tail == "original":
                put("params", mod, "kernel", _leaf(_to_jax_layout(value)))
            else:  # "0._u" / "0._v"
                uv.setdefault(mod, {})[tail[-1]] = _leaf(value)
            continue
        mod, _, leaf = key.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        if leaf in ("running_mean", "running_var"):
            put("batch_stats", mod, leaf[len("running_"):], _leaf(value))
        elif leaf == "weight":
            bn = f"{mod}.running_mean" in sd  # as the JAX converter tells a BatchNorm
            put("params", mod, "scale" if bn else "kernel",
                _leaf(value if bn else _to_jax_layout(value)))
        else:  # bias, gamma
            put("params", mod, leaf, _leaf(value))

    for mod, pair in uv.items():
        put("spectral", mod, "uv", (pair["u"], pair["v"]))
    return {name: tree for name, tree in trees.items() if tree or name == "params"}
