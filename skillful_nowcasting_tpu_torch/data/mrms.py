"""MRMS CONUS radar: Zarr-backed training sequences and the tiled-inference context window.

Port of ``skillful_nowcasting_tpu/data/mrms.py``, with the same draws:

* :class:`MRMSSequences`: random crop batches of (4 context + ``num_target``)
  windows from a ``(T, H, W)`` or ``(T, H, W, C)`` array (a Zarr array, or
  any array-protocol object: numpy, h5py, ``xarray.DataArray.data``), read a
  time chunk at a time and packed by the native path; per-process chunks
  are disjoint;
* :func:`mrms_tiles`: the ``(num_input_frames, C, H, W)`` context window for
  :func:`skillful_nowcasting_tpu_torch.inference.tiled_nowcast`.

``zarr`` is optional: :func:`open_zarr` raises a clear ``ImportError``
without it, and everything takes plain arrays.
"""

from __future__ import annotations

import sys
from typing import Iterator, Optional, Tuple

import numpy as np

from ._process import process_index_and_count
from .crops import random_crop_batches


def open_zarr(path: str, variable: Optional[str] = None):
    """Open an MRMS Zarr store; returns the (T, H, W[, C]) array object."""
    try:
        import zarr
    except ImportError as e:
        raise ImportError(
            "zarr is not installed; pass a numpy/array-protocol object to "
            "MRMSSequences / mrms_tiles instead"
        ) from e
    root = zarr.open(path, mode="r")
    if variable is not None:
        return root[variable]
    if hasattr(root, "shape"):
        return root
    keys = list(root.array_keys())  # a group: its first array
    if not keys:
        raise ValueError(f"no arrays in zarr store {path}")
    return root[keys[0]]


def _as_tchw(a: np.ndarray) -> np.ndarray:
    """A stored ``(T, H, W)`` or ``(T, H, W, C)`` chunk as TCHW (no copy for one channel)."""
    if a.ndim == 3:
        return a[:, None]
    if a.ndim == 4:
        return np.moveaxis(a, -1, 1)
    raise ValueError(f"expected (T,H,W[,C]) array, got shape {a.shape}")


class MRMSSequences:
    """Random-crop training sequences from a CONUS-scale radar array.

    Reads ``frames_per_chunk`` frames into host memory at a time, then serves
    ``batches_per_chunk`` random crop batches from them. The process index
    and count come from the arguments, else from ``torch.distributed``
    (0 of 1 without it).
    """

    def __init__(
        self,
        array,
        *,
        batch_size: int = 16,
        crop: int = 256,
        num_input_frames: int = 4,
        num_target_frames: int = 18,
        frames_per_chunk: int = 96,
        batches_per_chunk: int = 64,
        scale: float = 1.0,
        offset: float = 0.0,
        nan_fill: float = 0.0,
        seed: int = 0,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        self.array = array
        self.batch_size = batch_size
        self.crop = crop
        self.n_in = num_input_frames
        self.n_tgt = num_target_frames
        self.frames_per_chunk = max(frames_per_chunk, num_input_frames + num_target_frames)
        self.batches_per_chunk = batches_per_chunk
        self.scale, self.offset, self.nan_fill = scale, offset, nan_fill
        self.seed = seed
        self.process_index, self.process_count = process_index_and_count(
            process_index, process_count)
        self._warned_overlap = False

    def _next_chunk_start(self, rng: np.random.Generator, t_total: int, phase: int = 0) -> int:
        """A chunk start in this process's slots: chunk-aligned, strided by process index.

        ``phase`` shifts the whole slot grid (every process uses the same
        phase sequence, so the shifted chunks stay pairwise disjoint); without
        it no window would cross the fixed chunk boundaries. When the array
        is too short to give every process a slot, the start is drawn
        uniformly and processes may overlap (warned once).
        """
        max_start = t_total - self.frames_per_chunk
        if max_start <= 0:
            return 0
        phase = min(phase, max_start)
        n_slots = (max_start - phase) // self.frames_per_chunk + 1
        slots = np.arange(n_slots)[self.process_index :: self.process_count]
        if slots.size:
            return phase + int(rng.choice(slots)) * self.frames_per_chunk
        if not self._warned_overlap:
            self._warned_overlap = True
            print(f"MRMSSequences: {self.process_count} hosts > {n_slots} chunk slots — falling "
                  "back to independent uniform chunk starts (hosts may sample overlapping data)",
                  file=sys.stderr)
        return int(rng.integers(0, max_start + 1))

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        t_total = self.array.shape[0]
        rng = np.random.default_rng(self.seed + 7919 * self.process_index)
        # The same phase sequence on every process (seeded by ``seed`` alone).
        phase_rng = np.random.default_rng(self.seed ^ 0x5EED)
        while True:
            phase = int(phase_rng.integers(0, self.frames_per_chunk))
            start = self._next_chunk_start(rng, t_total, phase)
            pool = _as_tchw(np.asarray(self.array[start : start + self.frames_per_chunk],
                                       np.float32))
            it = random_crop_batches(
                pool, self.batch_size, crop=self.crop,
                num_input_frames=self.n_in, num_target_frames=self.n_tgt,
                scale=self.scale, offset=self.offset, nan_fill=self.nan_fill,
                seed=int(rng.integers(0, 2**31 - 1)),
            )
            for _ in range(self.batches_per_chunk):
                yield next(it)


def mrms_tiles(
    array,
    t_index: int,
    *,
    num_input_frames: int = 4,
    scale: float = 1.0,
    offset: float = 0.0,
    nan_fill: float = 0.0,
) -> np.ndarray:
    """The ``(num_input_frames, C, H, W)`` context window ending at ``t_index``, normalized."""
    if t_index + 1 < num_input_frames:
        raise ValueError("not enough history before t_index")
    window = _as_tchw(np.asarray(array[t_index + 1 - num_input_frames : t_index + 1], np.float32))
    return np.nan_to_num(window, nan=nan_fill) * scale + offset
