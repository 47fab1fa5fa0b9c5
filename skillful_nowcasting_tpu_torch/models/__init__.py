"""Model blocks and stacks of the PyTorch port."""

from .common import (
    ContextConditioningStack,
    DBlock,
    GBlock,
    LatentConditioningStack,
    LBlock,
    UpsampleGBlock,
)
from .generators import Generator, Sampler, ensemble_forward

__all__ = [
    "ContextConditioningStack",
    "DBlock",
    "GBlock",
    "Generator",
    "LBlock",
    "LatentConditioningStack",
    "Sampler",
    "UpsampleGBlock",
    "ensemble_forward",
]
