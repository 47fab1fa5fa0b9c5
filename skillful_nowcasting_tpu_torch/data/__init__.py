"""The data pipeline of the port: windows, crops, Nimrod and MRMS streams, synthetic radar, prefetch.

Every batch is NTCHW ``(B, T, C, H, W)``. The numpy modules are copies of
``skillful_nowcasting_tpu/data`` with the same arithmetic (the same seed gives
the same arrays, moved to NTCHW); :func:`synthetic_radar_batches_device`
renders on the card, and :func:`prefetch_to_device` stages host batches
there through pinned memory on a side stream. ``datasets`` (Nimrod) and
``zarr`` (MRMS stores) are optional imports.
"""

from .crops import random_crop_batches
from .mrms import MRMSSequences, mrms_tiles, open_zarr
from .nimrod import DGMRDataModule, NimrodStream, batch_windows
from .prefetch import prefetch_to_device
from .synthetic import (
    blob_fields,
    synthetic_batches,
    synthetic_radar_batches,
    synthetic_radar_batches_device,
)
from .windows import NUM_INPUT_FRAMES, NUM_TARGET_FRAMES, extract_input_and_target_frames

__all__ = [
    "DGMRDataModule",
    "MRMSSequences",
    "NUM_INPUT_FRAMES",
    "NUM_TARGET_FRAMES",
    "NimrodStream",
    "batch_windows",
    "blob_fields",
    "extract_input_and_target_frames",
    "mrms_tiles",
    "open_zarr",
    "prefetch_to_device",
    "random_crop_batches",
    "synthetic_batches",
    "synthetic_radar_batches",
    "synthetic_radar_batches_device",
]
