"""Layers of the PyTorch port: attention, ConvGRU, conv factory."""

from .attention import AttentionLayer
from .convgru import ConvGRU, ConvGRUCell
from .utils import get_conv_layer

__all__ = ["AttentionLayer", "ConvGRU", "ConvGRUCell", "get_conv_layer"]
