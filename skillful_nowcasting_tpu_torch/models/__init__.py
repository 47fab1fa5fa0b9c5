"""Model blocks and stacks of the PyTorch port."""

from .common import (
    ContextConditioningStack,
    DBlock,
    GBlock,
    LatentConditioningStack,
    LBlock,
    UpsampleGBlock,
)
from .discriminators import Discriminator, SpatialDiscriminator, TemporalDiscriminator
from .generators import Generator, Sampler, ensemble_forward

__all__ = [
    "ContextConditioningStack",
    "DBlock",
    "Discriminator",
    "GBlock",
    "Generator",
    "LBlock",
    "LatentConditioningStack",
    "Sampler",
    "SpatialDiscriminator",
    "TemporalDiscriminator",
    "UpsampleGBlock",
    "ensemble_forward",
]
