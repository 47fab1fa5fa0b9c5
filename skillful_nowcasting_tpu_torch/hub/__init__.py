"""Weight exchange of the PyTorch port: hub directories, Lightning checkpoints, JAX trees.

``save_checkpoint(path, config, variables)`` / ``load_checkpoint(path)``
write and read the JAX package's native format, as that package's functions
of those names do; :func:`.pretrained.save_checkpoint` writes a module in it.
"""

from .convert import (
    convert_reference_state_dict,
    convert_torch_state_dict,
    load_variables,
    state_dict_from_variables,
)
from .lightning import (
    convert_lightning_checkpoint,
    load_lightning_checkpoint,
    train_state_from_lightning,
)
from .pretrained import (
    HubMixin,
    build_module,
    compose_generator,
    from_pretrained,
    module_config,
    save_pretrained,
)
from .serialization import load_checkpoint, save_checkpoint

__all__ = [
    "HubMixin",
    "build_module",
    "compose_generator",
    "convert_lightning_checkpoint",
    "convert_reference_state_dict",
    "convert_torch_state_dict",
    "from_pretrained",
    "load_checkpoint",
    "load_lightning_checkpoint",
    "load_variables",
    "module_config",
    "save_checkpoint",
    "save_pretrained",
    "state_dict_from_variables",
    "train_state_from_lightning",
]
