"""Radar-like inputs drawn from the seed on the device: advecting Gaussian rain cells.

:func:`blob_fields` is a frozen copy of the port's
``data/synthetic.py:blob_fields`` (wrap-around separable Gaussians on a
square crop), so that a later change to the program's generator cannot move
the benchmark's inputs. :func:`composite` draws the same cell model on a
rectangular grid without wrap-around (a radar composite such as MRMS
CONUS); its sum over cells is a matmul per frame, computed with TF32 off.
Intensities of 2-12 (mm/h) are those of the program's synthetic radar.
"""

from __future__ import annotations

import numpy as np
import torch


def blob_fields(pos, vel, sigma, amp, t_total: int, size: int) -> torch.Tensor:
    """The advecting-blob model: ``(B, T, 1, S, S)`` float32, where the inputs live.

    ``pos`` / ``vel`` are ``(B, K, 2)``, ``sigma`` / ``amp`` ``(B, K)``.
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


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


@torch.no_grad()
def crops(seed: int, n: int, frames: int, size: int, blobs: int, device) -> np.ndarray:
    """``n`` crops ``(n, frames, 1, size, size)`` float32 on the host, drawn on ``device``."""
    gen = torch.Generator(torch.device(device)).manual_seed(seed)
    pos = _uniform(gen, (n, blobs, 2), 0.0, float(size))
    vel = _uniform(gen, (n, blobs, 2), -3.0, 3.0)
    sigma = _uniform(gen, (n, blobs), size / 32, size / 8)
    amp = _uniform(gen, (n, blobs), 2.0, 12.0)
    return blob_fields(pos, vel, sigma, amp, frames, size).cpu().numpy()


@torch.no_grad()
def composite(seed: int, frames: int, height: int, width: int, cells: int,
              sigma_px: tuple, device) -> np.ndarray:
    """One composite ``(frames, 1, height, width)`` float32 on the host, drawn on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(seed)
    pos = _uniform(gen, (cells, 2), 0.0, 1.0) * torch.tensor([height, width], device=device)
    vel = _uniform(gen, (cells, 2), -3.0, 3.0)
    sigma = _uniform(gen, (cells,), *sigma_px)
    amp = _uniform(gen, (cells,), 2.0, 12.0)
    t = torch.arange(frames, dtype=torch.float32, device=device)
    cy = pos[:, 0:1] + vel[:, 0:1] * t  # (K, T)
    cx = pos[:, 1:2] + vel[:, 1:2] * t
    inv = (1.0 / (2.0 * sigma * sigma))[:, None, None]
    ys = torch.arange(height, dtype=torch.float32, device=device)
    xs = torch.arange(width, dtype=torch.float32, device=device)
    ey = amp[:, None, None] * torch.exp(-((ys - cy[..., None]) ** 2) * inv)  # (K, T, H)
    ex = torch.exp(-((xs - cx[..., None]) ** 2) * inv)  # (K, T, W)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        field = torch.bmm(ey.permute(1, 2, 0), ex.permute(1, 0, 2))  # (T, H, W)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return field[:, None].cpu().numpy()
