"""The reference's Lightning ``.ckpt``: weights, hyperparameters and both Adam states.

Port of ``skillful_nowcasting_tpu/hub/lightning.py``. The reference's own
training writes a pickled dict (``train/run.py:221-231``) with

* ``state_dict``: the DGMR state dict, with the ``generator.*`` copies of
  the shared stacks (``dgmr.py:108-123``);
* ``hyper_parameters``: the ``save_hyperparameters()`` config;
* ``optimizer_states``: ``[opt_g, opt_d]`` torch Adam state dicts
  (``dgmr.py:292-300``), over ``generator.parameters()`` and
  ``discriminator.parameters()``;
* ``global_step`` and ``epoch``.

Torch keys an optimizer's state by the position of each parameter in the
module's ``parameters()``, which is the order of the parameter entries of
its state dict (the same pre-order walk). The position -> name map is
therefore read from the checkpoint's own key order
(:func:`ordered_param_keys`), never from the port's parameter order, which
need not match the reference's.

Reading a ``.ckpt`` unpickles it (``weights_only=False``): load only files
that the reference's training or this package wrote.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import torch

from .convert import convert_reference_state_dict

_PARAM_LEAVES = ("original", "weight_orig", "weight", "bias", "gamma")


def load_lightning_checkpoint(path: str) -> Dict[str, Any]:
    """``torch.load`` a Lightning ``.ckpt`` file onto the CPU."""
    return torch.load(path, map_location="cpu", weights_only=False)


def convert_lightning_checkpoint(ckpt) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A Lightning ckpt (path or loaded dict) -> ``(hyper_parameters, state dict)``.

    The state dict keeps the reference's keys; :func:`~.pretrained.load_into`
    maps and loads it.
    """
    if isinstance(ckpt, (str, os.PathLike)):
        ckpt = load_lightning_checkpoint(str(ckpt))
    return dict(ckpt.get("hyper_parameters", {})), dict(ckpt["state_dict"])


def ordered_param_keys(state_dict_keys: Sequence[str], prefix: str) -> List[str]:
    """The ``parameters()`` order of the submodule at ``prefix``, from the state-dict key order.

    Buffers (BN statistics, spectral-norm ``u``/``v``, ``num_batches_tracked``)
    and the derived ``weight`` beside an old-style ``weight_orig`` are left out.
    """
    keyset = set(state_dict_keys)
    pfx = prefix + "." if prefix else ""
    out = []
    for k in state_dict_keys:
        mod, _, leaf = k.rpartition(".")
        if not k.startswith(pfx) or leaf not in _PARAM_LEAVES:
            continue
        if leaf == "weight" and f"{mod}.weight_orig" in keyset:
            continue
        out.append(k)
    return out


def _port_name(key: str, strip_prefix: str) -> str:
    """A reference parameter key under the port's name."""
    if strip_prefix and key.startswith(strip_prefix + "."):
        key = key[len(strip_prefix) + 1:]
    (name,) = convert_reference_state_dict({key: None})
    return name


def load_adam_state(
    opt: torch.optim.Optimizer,
    names: Sequence[str],
    opt_state: Mapping[str, Any],
    ordered_keys: Sequence[str],
    strip_prefix: str = "",
) -> None:
    """Load a reference Adam ``state_dict``'s moments and step counts into ``opt``.

    ``names`` are the port's parameter names in ``opt``'s order;
    ``ordered_keys`` the reference parameter keys in the reference
    optimizer's order. The port's param groups (learning rates, betas) stay.
    """
    index = {name: i for i, name in enumerate(names)}
    params = opt.param_groups[0]["params"]
    state = {}
    for idx, entry in opt_state.get("state", {}).items():
        i = int(idx)
        if i >= len(ordered_keys):
            raise KeyError(f"optimizer state index {i} out of range ({len(ordered_keys)} params)")
        name = _port_name(ordered_keys[i], strip_prefix)
        if name not in index:
            raise KeyError(f"optimizer state for {ordered_keys[i]!r}: no parameter {name!r} here")
        p = params[index[name]]
        for moment in ("exp_avg", "exp_avg_sq"):
            if tuple(entry[moment].shape) != tuple(p.shape):
                raise ValueError(
                    f"{moment} of {name}: shape {tuple(entry[moment].shape)} != {tuple(p.shape)}"
                )
        state[index[name]] = dict(entry)
    sd = opt.state_dict()
    sd["state"] = state
    opt.load_state_dict(sd)


def train_state_from_lightning(model, ckpt):
    """A :class:`~..training.TrainState` resumed from a reference Lightning ``.ckpt``.

    Loads the parameters, BN statistics and spectral-norm vectors into
    ``model`` (strictly, on the model's device), both Adam optimizers'
    ``exp_avg``, ``exp_avg_sq`` and ``step``, and sets the state's ``step``
    to ``global_step``: the reference's ``pl.Trainer(ckpt_path=...)`` resume.
    Returns ``(state, hyper_parameters)``.
    """
    from ..training import init_train_state, split_params
    from .pretrained import map_state_dict

    if isinstance(ckpt, (str, os.PathLike)):
        ckpt = load_lightning_checkpoint(str(ckpt))
    config, state_dict = convert_lightning_checkpoint(ckpt)
    model.load_state_dict(map_state_dict(state_dict, model.state_dict()), strict=True)
    state = init_train_state(model)

    opt_states = ckpt.get("optimizer_states")
    if opt_states:
        keys = list(state_dict)
        g_keys = ordered_param_keys(keys, "generator")
        prefix = "generator"
        if not g_keys:  # saved without the generator.* copies
            g_keys = [k for k in ordered_param_keys(keys, "") if not k.startswith("discriminator.")]
            prefix = ""
        g_names, d_names = (list(group) for group in split_params(model))
        load_adam_state(state.g_opt, g_names, opt_states[0], g_keys, prefix)
        d_keys = ordered_param_keys(keys, "discriminator")
        load_adam_state(state.d_opt, d_names, opt_states[1], d_keys)
    state.step = int(ckpt.get("global_step", 0))
    return state, config

