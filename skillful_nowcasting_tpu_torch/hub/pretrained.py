"""``from_pretrained`` / ``save_pretrained``: the hub weight contract of the port.

Port of ``skillful_nowcasting_tpu/hub/pretrained.py``. Every public model
class mixes in :class:`HubMixin`, the reference's ``PyTorchModelHubMixin``
contract: a directory holds ``config.json`` (the constructor's arguments;
unknown keys are ignored) and the weights in the reference torch state-dict
schema, as ``model.safetensors`` or ``pytorch_model.bin``. A Lightning
``.ckpt`` file of the reference's training loads too (:mod:`.lightning`).

The port's own state dict already has the reference keys, so its native
format is the reference's: :meth:`HubMixin.save_pretrained` writes
``config.json`` + ``model.safetensors``, which the JAX package reads as a
torch checkpoint. Loading maps the other reference dialects first
(:func:`~.convert.convert_reference_state_dict`) and then loads with
``strict=True``: a missing, extra or misshapen tensor raises and names it.

The module is built on the ``meta`` device (no memory, no init compute) and
each tensor goes from the file straight to ``device``, so no full CPU model
is built first. ``device`` defaults to the card and raises without CUDA, as
``DGMR()`` does; the model comes back in eval mode. Hub repo ids are not
resolved (no network): a path that is not a directory raises
``FileNotFoundError``.
"""

from __future__ import annotations

import inspect
import json
import os
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from .convert import convert_reference_state_dict
from .safetensors import load_file, save_file

CONFIG_NAME = "config.json"
SAFETENSORS_NAME = "model.safetensors"
TORCH_WEIGHTS_NAME = "pytorch_model.bin"
SHARED_STACKS = ("conditioning_stack", "latent_stack", "sampler")


def _init_parameters(cls) -> list:
    return [
        p for p in inspect.signature(cls.__init__).parameters.values()
        if p.name not in ("self", "device") and p.kind is p.POSITIONAL_OR_KEYWORD
    ]


def module_config(module: nn.Module) -> Dict[str, Any]:
    """The hub config of a module: its ``config`` if it has one, else its constructor's arguments.

    A Generator's config nests its three stacks' configs, as in the JAX package.
    """
    if hasattr(module, "config"):
        return dict(module.config)
    cfg: Dict[str, Any] = {}
    for p in _init_parameters(type(module)):
        value = getattr(module, p.name)
        cfg[p.name] = module_config(value) if isinstance(value, nn.Module) else (
            list(value) if isinstance(value, tuple) else value)
    return cfg


def build_module(cls, config: Mapping[str, Any], **overrides) -> nn.Module:
    """Construct ``cls`` from a hub config dict (unknown keys ignored) on the ``meta`` device."""
    if cls.__name__ == "Generator":
        raise ValueError(
            "Generator is composed from pretrained components; use "
            "compose_generator(conditioning_stack, latent_stack, sampler)"
        )
    names = {p.name for p in _init_parameters(cls)}
    kwargs = {k: v for k, v in {**config, **overrides}.items() if k in names}
    if isinstance(kwargs.get("shape"), list):
        kwargs["shape"] = tuple(kwargs["shape"])
    if "device" in inspect.signature(cls.__init__).parameters:
        kwargs["device"] = "meta"
    with torch.device("meta"):
        return cls(**kwargs)


def _target_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"from_pretrained(device={str(device)!r}): CUDA is not available; pass "
            "device='cpu' to load the model on the CPU"
        )
    return device


def map_state_dict(
    state_dict: Mapping[str, torch.Tensor], expected: Mapping[str, torch.Tensor], device=None
) -> Dict[str, torch.Tensor]:
    """A reference-schema state dict under the keys and dtypes of ``expected``, a state dict.

    Each tensor is copied once, from where it lies (for example a mapped
    file) to ``device`` (``None``: where it lies). Keys that ``expected``
    lacks pass unchanged, so a strict load names them.
    """
    sd = convert_reference_state_dict(state_dict)
    for key, value in expected.items():  # JAX keeps no such counter; torch's is never read
        if key.endswith("num_batches_tracked") and key not in sd:
            sd[key] = torch.zeros((), dtype=value.dtype)
    return {k: v.to(device=device, dtype=expected[k].dtype, copy=True) if k in expected else v
            for k, v in sd.items()}


def load_into(module: nn.Module, state_dict: Mapping[str, torch.Tensor], device) -> nn.Module:
    """Load a reference-schema state dict into a ``meta``-built module, strictly, on ``device``.

    Returns the module in eval mode.
    """
    sd = map_state_dict(state_dict, module.state_dict(), device)
    module.load_state_dict(sd, strict=True, assign=True)
    left = [n for n, t in (*module.named_parameters(), *module.named_buffers()) if t.is_meta]
    if left:
        raise RuntimeError(f"tensors without a value after loading: {left[:5]}")
    return module.eval()


def _resolve_dir(pretrained: str) -> str:
    if os.path.isdir(pretrained):
        return pretrained
    raise FileNotFoundError(
        f"'{pretrained}' is not a local checkpoint directory; hub repo ids are not "
        "resolved (no network): download the repository and pass its directory"
    )


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint directory's state dict: ``model.safetensors``, else ``pytorch_model.bin``."""
    st_path = os.path.join(path, SAFETENSORS_NAME)
    if os.path.exists(st_path):
        return load_file(st_path)
    bin_path = os.path.join(path, TORCH_WEIGHTS_NAME)
    if os.path.exists(bin_path):  # weights_only: no pickled code runs
        return dict(torch.load(bin_path, map_location="cpu", weights_only=True))
    raise FileNotFoundError(
        f"no weight file ({SAFETENSORS_NAME} or {TORCH_WEIGHTS_NAME}) in {path}"
    )


def from_pretrained(cls, pretrained: str, *, device="cuda", **config_overrides) -> nn.Module:
    """Load ``cls`` from a checkpoint directory or a Lightning ``.ckpt`` file, on ``device``."""
    device = _target_device(device)
    if os.path.isfile(pretrained) and pretrained.endswith(".ckpt"):
        from .lightning import convert_lightning_checkpoint

        config, state_dict = convert_lightning_checkpoint(pretrained)
    else:
        path = _resolve_dir(pretrained)
        config = {}
        if os.path.exists(os.path.join(path, CONFIG_NAME)):
            with open(os.path.join(path, CONFIG_NAME)) as f:
                config = json.load(f)
        state_dict = read_state_dict(path)
    return load_into(build_module(cls, config, **config_overrides), state_dict, device)


def reference_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` in the reference's key set.

    The reference DGMR also registers its three stacks under ``generator``
    (``dgmr.py:108-123``), so its state dict repeats them as ``generator.*``
    before ``discriminator.*``; the port's DGMR adds those copies here.
    """
    sd = module.state_dict()
    if not hasattr(module, "discriminator") or not hasattr(module, "sampler"):
        return sd
    shared = {k: v for k, v in sd.items() if k.split(".", 1)[0] in SHARED_STACKS}
    rest = {k: v for k, v in sd.items() if k not in shared}
    return {**shared, **{f"generator.{k}": v for k, v in shared.items()}, **rest}


def save_pretrained(module: nn.Module, save_directory: str) -> int:
    """Write ``config.json`` + ``model.safetensors``; returns the bytes of the weight file."""
    os.makedirs(save_directory, exist_ok=True)
    with open(os.path.join(save_directory, CONFIG_NAME), "w") as f:
        json.dump(module_config(module), f, indent=2, sort_keys=True)
    return save_file(reference_state_dict(module), os.path.join(save_directory, SAFETENSORS_NAME))


def compose_generator(conditioning_stack: nn.Module, latent_stack: nn.Module, sampler: nn.Module):
    """Recompose a Generator from separately loaded stacks (eval mode, their device).

    Mirrors ``Generator(conditioning_stack=ctz, latent_stack=lat, sampler=sam)``
    of the reference README.
    """
    from ..models.generators import Generator

    parts = (conditioning_stack, latent_stack, sampler)
    devices = {p.device for part in parts for p in part.parameters()}
    if len(devices) != 1:
        raise ValueError(f"compose_generator: the stacks lie on several devices: {devices}")
    return Generator(*parts).eval()


class HubMixin:
    """``from_pretrained`` / ``save_pretrained`` / ``model_card`` for the port's model classes."""

    @classmethod
    def from_pretrained(cls, pretrained: str, *, device="cuda", **config_overrides):
        return from_pretrained(cls, pretrained, device=device, **config_overrides)

    def save_pretrained(self, save_directory: str) -> int:
        return save_pretrained(self, save_directory)

    def model_card(self, repo_id: Optional[str] = None) -> str:
        """A model card with the reference mixin's ``library_name`` / ``tags`` frontmatter."""
        name = type(self).__name__
        return "\n".join([
            "---",
            "library_name: skillful_nowcasting_tpu_torch",
            "tags:",
            *(f"- {tag}" for tag in
              ("nowcasting", "forecasting", "timeseries", "remote-sensing", "gan", "pytorch")),
            "---",
            "",
            f"# {name}",
            "",
            f"PyTorch `{name}` weights in the reference torch state-dict schema, for the "
            "PyTorch/CUDA DGMR port (skillful_nowcasting_tpu_torch), a reimplementation of "
            "Skillful Precipitation Nowcasting using Deep Generative Models of Radar "
            "(Ravuri et al., Nature 597, 2021).",
            "",
            "```python",
            f"from skillful_nowcasting_tpu_torch import {name}",
            "",
            f'model = {name}.from_pretrained("{repo_id or "<checkpoint-dir>"}")',
            "```",
            "",
            "## Config",
            "",
            "```json",
            json.dumps(module_config(self), indent=2, sort_keys=True),
            "```",
            "",
        ])
