"""Layers of the PyTorch port: attention, ConvGRU, coord conv, conv factory."""

from .attention import AttentionLayer
from .convgru import ConvGRU, ConvGRUCell
from .coord_conv import CoordConv, add_coords, coord_conv2d
from .utils import get_conv_layer

__all__ = ["AttentionLayer", "ConvGRU", "ConvGRUCell", "CoordConv", "add_coords",
           "coord_conv2d", "get_conv_layer"]
