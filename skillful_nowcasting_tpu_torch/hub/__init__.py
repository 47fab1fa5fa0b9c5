"""Weight exchange of the PyTorch port."""

from .convert import load_variables, state_dict_from_variables

__all__ = ["load_variables", "state_dict_from_variables"]
