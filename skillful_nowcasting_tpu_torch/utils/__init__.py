"""Utilities of the PyTorch port."""

from .init import random_fill

__all__ = ["random_fill"]
