"""Plain reference of a tiled field nowcast: which tiles, what each sees, where its interior goes.

The field is cut into ``tile`` squares at stride ``tile - overlap``. The
domain is extended by ``overlap / 2`` at the top and left, and at the bottom
and right up to whole strides, by repeating the edge pixels; the tile whose
top-left corner lies at extended ``(i, j)`` writes its central ``stride``
square (clipped to the field) at field ``(i, j)``. So every field pixel
comes from the one tile whose interior holds it, seeing ``overlap / 2`` of
context on each side.

Tiles are cut here by clamped indices (an edge pixel repeated is an index
clamped to the field), from the host array the benchmark made.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def padded_extent(n: int, tile: int, overlap: int) -> int:
    """The extended length: ``n + overlap`` rounded up to whole strides past one tile."""
    stride = tile - overlap
    n2 = n + overlap
    return tile if n2 <= tile else tile + -(-(n2 - tile) // stride) * stride


def tile_corners(h: int, w: int, tile: int, overlap: int) -> List[Tuple[int, int]]:
    """Top-left corners (extended coordinates) of every tile, row-major."""
    stride = tile - overlap
    rows = range(0, padded_extent(h, tile, overlap) - tile + 1, stride)
    cols = range(0, padded_extent(w, tile, overlap) - tile + 1, stride)
    return [(i, j) for i in rows for j in cols]


def cut_tile(frames: np.ndarray, i: int, j: int, tile: int, overlap: int) -> np.ndarray:
    """The tile at extended ``(i, j)`` of ``frames`` ``(T, C, H, W)``, edges repeated outside."""
    m = overlap // 2
    h, w = frames.shape[-2:]
    ys = np.clip(np.arange(i - m, i - m + tile), 0, h - 1)
    xs = np.clip(np.arange(j - m, j - m + tile), 0, w - 1)
    return frames[:, :, ys][:, :, :, xs]


def interior(i: int, j: int, h: int, w: int, tile: int, overlap: int):
    """Where the tile at ``(i, j)`` writes: field rows, field cols, tile rows, tile cols."""
    m, stride = overlap // 2, tile - overlap
    ny, nx = min(stride, h - i), min(stride, w - j)
    return slice(i, i + ny), slice(j, j + nx), slice(m, m + ny), slice(m, m + nx)
