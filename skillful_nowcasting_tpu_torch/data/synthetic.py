"""Synthetic radar batches for tests, smoke training and measurements (port of ``skillful_nowcasting_tpu/data/synthetic.py``).

The numpy generators are copies: the same seed gives the JAX package's
arrays, moved to NTCHW. :func:`blob_fields` and
:func:`synthetic_radar_batches_device` render the same advecting-blob
model in torch, on the card by default, from an explicit
``torch.Generator`` (its draws are not numpy's).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch


def _ntchw(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(a, -1, 2))


def synthetic_batches(
    batch_size: int = 1,
    input_frames: int = 4,
    target_frames: int = 18,
    size: int = 256,
    channels: int = 1,
    seed: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield uniform-noise ``(images, future_images)`` NTCHW float32 batches forever."""
    rng = np.random.default_rng(seed)
    while True:
        images = rng.random((batch_size, input_frames, size, size, channels), np.float32)
        future = rng.random((batch_size, target_frames, size, size, channels), np.float32)
        yield _ntchw(images), _ntchw(future)


def synthetic_radar_batches(
    batch_size: int = 1,
    input_frames: int = 4,
    target_frames: int = 18,
    size: int = 256,
    channels: int = 1,
    seed: int = 0,
    n_blobs: int = 8,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Advecting-Gaussian-blob sequences: structured, learnable synthetic radar, NTCHW.

    Each sample is ``n_blobs`` Gaussian rain cells translating with constant
    per-sample velocity (the advection model nowcasting baselines assume),
    so future frames are predictable from the context. Intensities of 2-12
    sit in the flat region of the grid loss's ``max(y + 1, 24)`` weights.
    Channel 0 holds the field, any others stay 0.
    """
    rng = np.random.default_rng(seed)
    t_total = input_frames + target_frames
    t_col = np.arange(t_total, dtype=np.float64)[:, None]  # (T, 1)
    while True:
        seq = np.zeros((batch_size, t_total, channels, size, size), np.float32)
        for b in range(batch_size):
            pos = rng.uniform(0, size, (n_blobs, 2))
            vel = rng.uniform(-3.0, 3.0, (n_blobs, 2))
            sigma = rng.uniform(size / 32, size / 8, n_blobs)
            amp = rng.uniform(2.0, 12.0, n_blobs)
            # The Gaussian is separable: an outer product of two (T, S) axis profiles.
            field = np.zeros((t_total, size, size), np.float32)
            axis = np.arange(size, dtype=np.float64)
            for k in range(n_blobs):
                cy = (pos[k, 0] + vel[k, 0] * t_col) % size  # (T, 1)
                cx = (pos[k, 1] + vel[k, 1] * t_col) % size
                # Wrap-around distance keeps blobs continuous at the edges.
                dy = np.minimum(np.abs(axis - cy), size - np.abs(axis - cy))
                dx = np.minimum(np.abs(axis - cx), size - np.abs(axis - cx))
                inv = 1.0 / (2 * sigma[k] ** 2)
                ey = np.exp(-(dy * dy) * inv)  # (T, S)
                ex = np.exp(-(dx * dx) * inv)
                field += (amp[k] * ey[:, :, None] * ex[:, None, :]).astype(np.float32)
            seq[b, :, 0] = field
        yield seq[:, :input_frames], seq[:, input_frames:]


def blob_fields(pos, vel, sigma, amp, t_total: int, size: int) -> torch.Tensor:
    """The advecting-blob model in torch: ``(B, T, 1, S, S)`` float32, where the inputs live.

    ``pos`` / ``vel`` are ``(B, K, 2)``, ``sigma`` / ``amp`` ``(B, K)``; the
    same math as the host generator (wrap-around separable Gaussians). The
    sum over the K blobs is a plain f32 product and sum, not a matmul, so it
    runs at full precision on the card whatever the TF32 settings.
    """
    pos, vel, sigma, amp = (torch.as_tensor(a, dtype=torch.float32) for a in (pos, vel, sigma, amp))
    t = torch.arange(t_total, dtype=torch.float32, device=pos.device)
    axis = torch.arange(size, dtype=torch.float32, device=pos.device)
    cy = (pos[..., 0:1] + vel[..., 0:1] * t) % size  # (B, K, T)
    cx = (pos[..., 1:2] + vel[..., 1:2] * t) % size
    dy = (axis - cy[..., None]).abs()  # (B, K, T, S)
    dy = torch.minimum(dy, size - dy)
    dx = (axis - cx[..., None]).abs()
    dx = torch.minimum(dx, size - dx)
    inv = (1.0 / (2.0 * sigma * sigma))[:, :, None, None]
    ey = amp[:, :, None, None] * torch.exp(-(dy * dy) * inv)
    ex = torch.exp(-(dx * dx) * inv)
    field = (ey[..., :, None] * ex[..., None, :]).sum(dim=1)  # (B, T, S, S)
    return field[:, :, None]


def synthetic_radar_batches_device(
    batch_size: int = 1,
    input_frames: int = 4,
    target_frames: int = 18,
    size: int = 256,
    channels: int = 1,
    seed: int = 0,
    n_blobs: int = 8,
    device: torch.device | str = "cuda",
    generator: Optional[torch.Generator] = None,
) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Advecting-blob batches rendered on ``device`` (the card by default): no host traffic.

    The parameter distributions of :func:`synthetic_radar_batches`; the draws
    come from ``generator`` (default: a generator on ``device`` seeded with
    ``seed``), so they are not numpy's. Yields NTCHW float32 tensors.
    """
    if channels != 1:
        raise ValueError("the device generator renders single-channel fields")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("synthetic_radar_batches_device: CUDA is not available; "
                           "pass device='cpu' to render on the CPU")
    if generator is None:
        generator = torch.Generator(device).manual_seed(seed)
    t_total = input_frames + target_frames

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=generator.device)
        return (lo + (hi - lo) * u).to(device)

    while True:
        pos = uniform((batch_size, n_blobs, 2), 0.0, float(size))
        vel = uniform((batch_size, n_blobs, 2), -3.0, 3.0)
        sigma = uniform((batch_size, n_blobs), size / 32, size / 8)
        amp = uniform((batch_size, n_blobs), 2.0, 12.0)
        seq = blob_fields(pos, vel, sigma, amp, t_total, size)
        yield seq[:, :input_frames], seq[:, input_frames:]
