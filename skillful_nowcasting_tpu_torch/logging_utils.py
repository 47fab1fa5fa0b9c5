"""Metrics logging (port of ``skillful_nowcasting_tpu/logging_utils.py``).

:class:`MetricsLogger` writes every scalar to stdout and, given a
``log_dir``, as one JSON line per log step to ``log_dir/metrics.jsonl``;
TensorBoard (``torch.utils.tensorboard``, which needs the ``tensorboard``
package) and wandb are added only where they import. Histograms come
pre-binned from the train step (``watch_histograms``) over the fixed symlog
bins of :func:`hist_bucket_edges`, so only their counts and four scalars
leave the device.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Mapping, Optional

import numpy as np

# Fixed symlog10 bins of the train step's histograms (``wandb.watch(log="all")``
# of the reference). y = arcsinh(x / SCALE) / ln(10) is linear below about
# SCALE and one unit per decade beyond; Y_MAX = 28 covers |x| up to about 1e16.
HIST_BINS = 64
HIST_SYMLOG_SCALE = 1e-12
HIST_Y_MAX = 28.0

JSONL_NAME = "metrics.jsonl"


def hist_bucket_edges(bins: int = HIST_BINS) -> np.ndarray:
    """Original-domain bucket edges ``(bins + 1,)`` of the symlog histogram."""
    y = np.linspace(-HIST_Y_MAX, HIST_Y_MAX, bins + 1)
    return np.sinh(y * np.log(10.0)) * HIST_SYMLOG_SCALE


class MetricsLogger:
    """Scalars to stdout and JSONL; TensorBoard and wandb where they import."""

    def __init__(self, log_dir: Optional[str] = None, use_wandb: bool = False, wandb_kwargs=None):
        self._tb = None
        self._wandb = None
        self._jsonl = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, JSONL_NAME), "a")
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except ImportError:
                print("tensorboard unavailable; logging to stdout and JSONL", file=sys.stderr)
        if use_wandb:
            try:
                import wandb

                wandb.init(**(wandb_kwargs or {}))
                self._wandb = wandb
            except ImportError:
                print("wandb unavailable; skipping", file=sys.stderr)

    def log_scalars(self, metrics: Mapping[str, float], step: int) -> None:
        scalars = {k: float(v) for k, v in metrics.items() if np.ndim(v) == 0}
        print(f"step {step}: " + " ".join(f"{k}={v:.5g}" for k, v in scalars.items()), flush=True)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"step": int(step), **scalars}) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)

    def log_histograms(self, hists: Mapping[str, Mapping[str, np.ndarray]], step: int) -> None:
        """Write per-layer histograms computed on the device by the train step.

        ``hists`` maps a tag (``train/hist/grads/sampler/...``) to
        ``{"counts", "min", "max", "sum", "sumsq"}``; only the static bucket
        edges are added here. TensorBoard gets ``add_histogram_raw``, wandb a
        pre-binned ``wandb.Histogram``.
        """
        if self._tb is None and self._wandb is None:
            return
        edges = hist_bucket_edges()
        for tag, h in hists.items():
            counts = np.asarray(h["counts"], dtype=np.float64)
            n = float(counts.sum())
            if n <= 0:
                continue
            if self._tb is not None:
                self._tb.add_histogram_raw(
                    tag, min=float(h["min"]), max=float(h["max"]), num=int(round(n)),
                    sum=float(h["sum"]), sum_squares=float(h["sumsq"]),
                    bucket_limits=edges[1:].tolist(), bucket_counts=counts.tolist(),
                    global_step=step,
                )
            if self._wandb is not None:
                self._wandb.log({tag: self._wandb.Histogram(np_histogram=(counts, edges))},
                                step=step)

    def log_video_frames(self, tag: str, video: np.ndarray, step: int, max_frames: int = 18) -> None:
        """Per-frame images of an NTCHW video's first batch element (``dgmr.py:302-327``)."""
        if self._tb is None and self._wandb is None:
            return
        for i, frame in enumerate(np.asarray(video[0])[:max_frames]):  # (C, H, W)
            img = _normalize_image(frame)
            if self._tb is not None:
                self._tb.add_image(f"{tag}_Frame_{i}", img, step, dataformats="CHW")
            if self._wandb is not None:
                self._wandb.log({f"{tag}_Frame_{i}": self._wandb.Image(np.moveaxis(img, 0, -1))},
                                step=step)

    def flush(self) -> None:
        if self._jsonl is not None:
            self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


def make_wandb_checkpoint_uploader(
    artifact_name: str = "experiment-ckpts",
    artifact_type: str = "checkpoints",
    upload_best_only: bool = False,
):
    """``on_checkpoint(step, ckpt_dir)`` that logs the checkpoint directory as a wandb artifact.

    The reference's ``UploadCheckpointsAsArtifact``: the step directories
    under ``ckpt_dir`` (or, with ``upload_best_only``, only the saved step's)
    as an artifact aliased ``latest`` and ``step-N``. A no-op without wandb,
    without an active run, and on every rank but 0 of ``torch.distributed``.
    """

    def upload(step: int, ckpt_dir) -> None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and dist.get_rank() != 0:
            return
        try:
            import wandb
        except ImportError:
            return
        if wandb.run is None:
            return
        art = wandb.Artifact(artifact_name, type=artifact_type, metadata={"step": int(step)})
        root = str(ckpt_dir)
        step_dir = os.path.join(root, str(int(step)))
        if upload_best_only or not os.path.isdir(root):
            if os.path.isdir(step_dir):
                art.add_dir(step_dir, name=str(int(step)))
        else:
            for entry in sorted(os.listdir(root)):
                full = os.path.join(root, entry)
                if os.path.isdir(full):
                    art.add_dir(full, name=entry)
        wandb.run.log_artifact(art, aliases=["latest", f"step-{int(step)}"])

    return upload


def _normalize_image(frame: np.ndarray) -> np.ndarray:
    lo, hi = float(frame.min()), float(frame.max())
    if hi > lo:
        frame = (frame - lo) / (hi - lo)
    return frame.astype(np.float32)
