"""Radar window extraction (port of ``skillful_nowcasting_tpu/data/windows.py``; reference ``train/run.py:114-123``).

Only the time axis is sliced, so a window may be TCHW (the port's layout) or
any other layout with time first.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

NUM_INPUT_FRAMES = 4
NUM_TARGET_FRAMES = 18


def extract_input_and_target_frames(
    radar_frames: np.ndarray,
    num_input_frames: int = NUM_INPUT_FRAMES,
    num_target_frames: int = NUM_TARGET_FRAMES,
) -> Tuple[np.ndarray, np.ndarray]:
    """Split a >= (input+target)-frame window into (context, target).

    The reference's slicing: inputs are frames ``[-(input+target) : -target]``,
    targets the final ``target`` frames.
    """
    total = num_input_frames + num_target_frames
    if radar_frames.shape[0] < total:
        raise ValueError(f"window has {radar_frames.shape[0]} frames, need >= {total}")
    return radar_frames[-total:-num_target_frames], radar_frames[-num_target_frames:]
