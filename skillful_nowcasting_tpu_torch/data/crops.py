"""Random-crop window sampling from a frame pool (port of ``skillful_nowcasting_tpu/data/crops.py``).

The paper trains on 256x256 crops of larger radar fields with 4 + 18-frame
windows. Each batch picks a window start and a crop corner per element
(numpy's ``default_rng``, the same draws as the JAX package), then gathers,
normalizes and packs in one OpenMP pass of the native library
(:mod:`.native`).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from .native import pack_windows
from .windows import NUM_INPUT_FRAMES, NUM_TARGET_FRAMES


def random_crop_batches(
    frame_pool: np.ndarray,
    batch_size: int,
    *,
    crop: int = 256,
    num_input_frames: int = NUM_INPUT_FRAMES,
    num_target_frames: int = NUM_TARGET_FRAMES,
    scale: float = 1.0,
    offset: float = 0.0,
    nan_fill: float = 0.0,
    seed: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield NTCHW ``(inputs, targets)`` batches of random crops of a ``(T, C, H, W)`` pool."""
    pool = np.asarray(frame_pool, np.float32)
    t, _, h, w = pool.shape
    total = num_input_frames + num_target_frames
    if t < total or h < crop or w < crop:
        raise ValueError(f"pool {pool.shape} too small for {total}-frame {crop}^2 windows")
    rng = np.random.default_rng(seed)
    while True:
        starts = rng.integers(0, t - total + 1, batch_size).astype(np.int64)
        crop_y = rng.integers(0, h - crop + 1, batch_size).astype(np.int64)
        crop_x = rng.integers(0, w - crop + 1, batch_size).astype(np.int64)
        yield pack_windows(
            pool, starts, crop_y, crop_x,
            n_in=num_input_frames, n_tgt=num_target_frames, crop_h=crop, crop_w=crop,
            scale=scale, offset=offset, nan_fill=nan_fill,
        )
