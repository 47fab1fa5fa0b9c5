"""Nowcast verification metrics: ensemble CRPS, CSI and their pooled variants.

Port of ``skillful_nowcasting_tpu/metrics.py``: the evaluation of Ravuri et
al. (Nature 597, 2021), CRPS at the grid and at pooled scales and CSI at
rain-rate thresholds, as torch functions that run on the tensors' device.
Layouts are the port's: ``samples`` is an ensemble ``(S, ...)`` stacked on
its first axis, observations broadcast against one member, and the spatial
axes of the pooled variants are the last two, ``(..., H, W)`` (the JAX
functions take ``(..., H, W, C)``). Every reduction runs in float32.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F

Thresholds = Union[float, Sequence[float]]


def crps_ensemble(
    samples: torch.Tensor, observation: torch.Tensor, *, fair: bool = True
) -> torch.Tensor:
    """Per-point ensemble CRPS, ``E|X - y| - 0.5 E|X - X'|``, of shape ``samples.shape[1:]``.

    ``fair=True`` normalises the spread over the ``S(S-1)`` ordered member
    pairs (the fair CRPS of Ferro 2014, for small ensembles such as DGMR's
    S=6); ``fair=False`` over ``S^2``. Up to 16 members the spread is a sum
    over member pairs with one field-sized accumulator, as in JAX; larger
    ensembles use the order-statistics identity
    ``sum_ij |x_i - x_j| = 2 sum_k (2k - S + 1) x_(k)``.
    """
    x = samples.float()
    y = observation.to(device=x.device, dtype=torch.float32)
    s = x.shape[0]
    skill = (x - y[None]).abs().mean(dim=0)
    if s <= 16:
        acc = torch.zeros(x.shape[1:], dtype=torch.float32, device=x.device)
        for i in range(s):
            for j in range(i + 1, s):
                acc = acc + (x[i] - x[j]).abs()
        spread = 2.0 * acc
    else:
        xs = x.reshape(s, -1).sort(dim=0).values
        w = (2.0 * torch.arange(s, dtype=torch.float32, device=x.device) - s + 1.0)[:, None]
        spread = (2.0 * (w * xs).sum(dim=0)).reshape(x.shape[1:])
    denom = s * (s - 1) if (fair and s > 1) else s * s
    return skill - 0.5 * spread / denom


def _pool2d(v: torch.Tensor, pool: int, op) -> torch.Tensor:
    """``op`` (a 2-D pooling) with window = stride = ``pool``, VALID, over the last two axes."""
    flat = v.reshape(-1, 1, *v.shape[-2:])
    out = op(flat, pool, pool)
    return out.reshape(*v.shape[:-2], *out.shape[-2:])


def pooled_crps(
    samples: torch.Tensor, observation: torch.Tensor, pool: int, *, fair: bool = True
) -> torch.Tensor:
    """CRPS of ``pool x pool`` average-pooled fields (the paper's pooled CRPS)."""
    if pool <= 1:
        return crps_ensemble(samples, observation, fair=fair)
    return crps_ensemble(
        _pool2d(samples.float(), pool, F.avg_pool2d),
        _pool2d(observation.float(), pool, F.avg_pool2d),
        fair=fair,
    )


def _thresholds(threshold: Thresholds, device) -> torch.Tensor:
    return torch.atleast_1d(torch.as_tensor(threshold, dtype=torch.float32, device=device))


def _counts(pe: torch.Tensor, oe: torch.Tensor) -> torch.Tensor:
    """``(n_thresholds, 3)`` hits, misses, false alarms of ``(n_thresholds, N)`` event masks."""
    hits = (pe & oe).sum(dim=1)
    misses = (~pe & oe).sum(dim=1)
    false_alarms = (pe & ~oe).sum(dim=1)
    return torch.stack([hits, misses, false_alarms], dim=1).float()


def csi_counts(
    prediction: torch.Tensor, observation: torch.Tensor, threshold: Thresholds
) -> torch.Tensor:
    """Contingency counts ``(n_thresholds, 3)``: hits, misses, false alarms of ``>= threshold``.

    CSI is a ratio of event counts, so a dataset's score pools these counts
    over its batches and divides once: the mean of per-batch CSIs is biased
    (a batch without events at a threshold would add 0).
    """
    thr = _thresholds(threshold, prediction.device)
    p = prediction.float().reshape(-1)
    o = observation.to(device=p.device, dtype=torch.float32).reshape(-1)
    return _counts(p[None, :] >= thr[:, None], o[None, :] >= thr[:, None])


def csi(
    prediction: torch.Tensor,
    observation: torch.Tensor,
    threshold: Thresholds,
    *,
    eps: float = 1e-12,
) -> torch.Tensor:
    """Critical Success Index ``hits / (hits + misses + false alarms)``, one per threshold.

    A scalar ``threshold`` gives a scalar; all other axes are reduced.
    """
    c = csi_counts(prediction, observation, threshold)
    out = c[:, 0] / c.sum(dim=1).clamp_min(eps)
    return out[0] if torch.as_tensor(threshold).ndim == 0 else out


def pooled_csi(
    prediction: torch.Tensor, observation: torch.Tensor, threshold: Thresholds, pool: int
) -> torch.Tensor:
    """CSI of ``pool x pool`` max-pooled event fields (neighbourhood CSI).

    Max-pooling the binary exceedance field credits a forecast that puts an
    event within ``pool`` grid lengths of where it was observed.
    """
    thr = _thresholds(threshold, prediction.device)

    def events(v: torch.Tensor) -> torch.Tensor:
        f = v.to(device=thr.device, dtype=torch.float32)
        ev = (f[None] >= thr.reshape((-1,) + (1,) * f.ndim)).float()
        if pool > 1:
            ev = _pool2d(ev, pool, F.max_pool2d)
        return ev.reshape(thr.shape[0], -1) > 0.5

    c = _counts(events(prediction), events(observation))
    out = c[:, 0] / c.sum(dim=1).clamp_min(1e-12)
    return out[0] if torch.as_tensor(threshold).ndim == 0 else out


def ensemble_mean_mse(samples: torch.Tensor, observation: torch.Tensor) -> torch.Tensor:
    """MSE of the ensemble mean (a deterministic-skill summary)."""
    mean = samples.float().mean(dim=0)
    return (mean - observation.to(device=mean.device, dtype=torch.float32)).square().mean()
