"""nimrod-uk-1km streaming pipeline (port of ``skillful_nowcasting_tpu/data/nimrod.py``; reference ``train/run.py:126-215``).

* The stream is sharded per process first
  (``datasets.distributed.split_dataset_by_node``), then shuffled with a
  seed derived from the epoch, so processes read disjoint data and an
  identical stream replays the identical sequence. The process index and
  count come from the arguments, else from ``torch.distributed`` (0 of 1
  without it).
* Rows are THWC in the dataset; windows are split [-22:-18] context /
  [-18:] target and moved to TCHW; batches are NTCHW numpy, for
  :func:`~.prefetch.prefetch_to_device`.

``datasets`` is an optional import, needed only when a stream is read. The
hub dataset needs the network; a local copy streams through the same code
with ``dataset_name="parquet"`` and ``load_kwargs={"data_files": ...}``.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from ._process import process_index_and_count
from .windows import NUM_INPUT_FRAMES, NUM_TARGET_FRAMES, extract_input_and_target_frames


class NimrodStream:
    """Per-process sharded, reshuffling stream of TCHW ``(context, target)`` windows."""

    def __init__(
        self,
        split: str = "train",
        num_input_frames: int = NUM_INPUT_FRAMES,
        num_target_frames: int = NUM_TARGET_FRAMES,
        seed: int = 0,
        shuffle_buffer: int = 1000,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        dataset_name: str = "openclimatefix/nimrod-uk-1km",
        config_name: Optional[str] = "sample",
        load_kwargs: Optional[dict] = None,
    ):
        self.split = split
        self.num_input_frames = num_input_frames
        self.num_target_frames = num_target_frames
        self.seed = seed
        self.shuffle_buffer = shuffle_buffer
        self.process_index, self.process_count = process_index_and_count(
            process_index, process_count)
        self.dataset_name = dataset_name
        self.config_name = config_name
        self.load_kwargs = dict(load_kwargs or {})
        self._epoch = 0
        self._iter = None

    def _open(self):
        try:
            from datasets import load_dataset
        except ImportError as e:
            raise ImportError("NimrodStream reads through the `datasets` package, which is "
                              "not installed") from e

        args = (self.dataset_name,) if self.config_name is None else (
            self.dataset_name, self.config_name)
        ds = load_dataset(*args, split=self.split, streaming=True, **self.load_kwargs)
        # Shard first, then shuffle within the shard: shuffling first would
        # buffer the unsharded stream.
        if self.process_count > 1:
            from datasets.distributed import split_dataset_by_node

            ds = split_dataset_by_node(ds, rank=self.process_index, world_size=self.process_count)
        ds = ds.shuffle(seed=self.seed + self._epoch, buffer_size=self.shuffle_buffer)
        return iter(ds)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._iter is None:
            self._iter = self._open()
        try:
            row = next(self._iter)
        except StopIteration:  # epoch boundary: reshuffle with the next epoch's seed
            self._epoch += 1
            self._iter = self._open()
            row = next(self._iter)
        frames = np.moveaxis(np.asarray(row["radar_frames"], np.float32), -1, 1)  # THWC -> TCHW
        return extract_input_and_target_frames(
            frames, self.num_input_frames, self.num_target_frames)


def batch_windows(
    stream: Iterator[Tuple[np.ndarray, np.ndarray]], batch_size: int
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Stack per-sample windows into batches."""
    while True:
        inputs, targets = [], []
        for _ in range(batch_size):
            i, t = next(stream)
            inputs.append(i)
            targets.append(t)
        yield np.stack(inputs), np.stack(targets)


class DGMRDataModule:
    """Train / validation batch iterators (reference ``train/run.py:161-215``)."""

    def __init__(
        self,
        batch_size: int = 16,
        num_input_frames: int = NUM_INPUT_FRAMES,
        num_target_frames: int = NUM_TARGET_FRAMES,
        seed: int = 0,
        **stream_kwargs,
    ):
        self.batch_size = batch_size
        self.num_input_frames = num_input_frames
        self.num_target_frames = num_target_frames
        self.seed = seed
        self.stream_kwargs = stream_kwargs

    def _loader(self, split: str, seed: int):
        stream = NimrodStream(
            split=split, num_input_frames=self.num_input_frames,
            num_target_frames=self.num_target_frames, seed=seed, **self.stream_kwargs,
        )
        return batch_windows(stream, self.batch_size)

    def train_dataloader(self):
        return self._loader("train", self.seed)

    def val_dataloader(self):
        return self._loader("validation", self.seed + 10_000)
