"""Loss functions (port of ``skillful_nowcasting_tpu/losses.py``).

Images are NCHW ``(B, C, H, W)``, videos NTCHW ``(B, T, C, H, W)`` and an
ensemble of samples ``(S, B, T, C, H, W)``; the JAX package's NHWC / NTHWC
axes map onto these, and every value is the same.

Training-critical:

* :func:`loss_hinge_disc` / :func:`loss_hinge_gen`: the GAN hinge losses.
* :func:`weight_fn`: quirk Q4, ``max(y + 1, cap)``, a floor at ``cap``
  rather than the paper's ceiling; reproduced exactly.
* :class:`GridCellLoss`: quirk Q3, the reference normalization
  ``diff.norm(p=1) / T * H * W`` evaluates left to right as
  ``(||diff||_1 / T) * H * W``; ``grid_lambda = 20`` was tuned against that
  scale, so it is reproduced exactly.

Public extras: :func:`grid_cell_regularizer` (the paper-style clip),
SSIM / MS-SSIM / dynamic SSIM (the ``pytorch_msssim`` algorithm: Gaussian
window 11 / 1.5, VALID depthwise convolution, per-scale cs product), total
variation, gradient difference, focal loss and the :func:`get_loss` factory.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F


def loss_hinge_disc(score_generated: torch.Tensor, score_real: torch.Tensor) -> torch.Tensor:
    """Discriminator hinge loss: ``mean(relu(1 - real)) + mean(relu(1 + generated))``."""
    return torch.relu(1.0 - score_real).mean() + torch.relu(1.0 + score_generated).mean()


def loss_hinge_gen(score_generated: torch.Tensor) -> torch.Tensor:
    """Generator hinge loss: ``-mean(generated)``."""
    return -score_generated.mean()


def weight_fn(y: torch.Tensor, precip_weight_cap: float = 24.0) -> torch.Tensor:
    """Grid-cell loss weights: ``max(y + 1, cap)`` (quirk Q4)."""
    return torch.clamp(y + 1.0, min=precip_weight_cap)


class GridCellLoss:
    """Weighted L1 between the mean generated sample and the target, ``(||d||_1 / T) * H * W``."""

    def __init__(self, weight_fn: Optional[Callable] = None, precip_weight_cap: float = 24.0):
        self.weight_fn = (lambda y: weight_fn(y, precip_weight_cap)) if weight_fn else None

    def __call__(self, generated_images: torch.Tensor, targets: torch.Tensor,
                 field_height: Optional[int] = None) -> torch.Tensor:
        """The loss of NTCHW videos; ``field_height`` is the field's H where they hold a stripe of it.

        On a stripe the sum is the stripe's share: the stripes' losses add up
        to the whole field's.
        """
        difference = generated_images - targets
        if self.weight_fn is not None:
            difference = difference * self.weight_fn(targets)
        t, w = targets.shape[1], targets.shape[4]
        h = targets.shape[3] if field_height is None else field_height
        return difference.abs().sum() / t * h * w


class NowcastingLoss:
    """Hinge loss helper: ``mean(relu(1 + x))``, with ``x`` negated only when ``real_flag is True``."""

    def __call__(self, x: torch.Tensor, real_flag: bool) -> torch.Tensor:
        if real_flag is True:
            x = -x
        return torch.relu(1.0 + x).mean()


def grid_cell_regularizer(
    generated_samples: torch.Tensor, batch_targets: torch.Tensor
) -> torch.Tensor:
    """Paper-style grid cell regularizer: ``mean(|mean_S(samples) - y| * clip(y, 0, 24))``.

    Args:
        generated_samples: ``(S, B, T, C, H, W)``.
        batch_targets: ``(B, T, C, H, W)``.
    """
    gen_mean = generated_samples.mean(dim=0)
    weights = torch.clamp(batch_targets, 0.0, 24.0)
    return ((gen_mean - batch_targets).abs() * weights).mean()


# ---------------------------------------------------------------------------
# SSIM family (the pytorch_msssim algorithm)
# ---------------------------------------------------------------------------


def _gaussian_window(win_size: int, sigma: float) -> torch.Tensor:
    """The normalized 1-D Gaussian in float32, as JAX builds it; the filter casts it to the input's dtype."""
    coords = torch.arange(win_size, dtype=torch.float32) - win_size // 2
    g = torch.exp(-(coords**2) / (2.0 * sigma**2))
    return g / g.sum()


def _gaussian_filter(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable depthwise Gaussian blur of NCHW ``x``, VALID padding: H first, then W."""
    c, n = x.shape[1], win.shape[0]
    win = win.to(device=x.device, dtype=x.dtype)
    x = F.conv2d(x, win.view(1, 1, n, 1).repeat(c, 1, 1, 1), groups=c)
    return F.conv2d(x, win.view(1, 1, 1, n).repeat(c, 1, 1, 1), groups=c)


def _ssim_per_channel(x, y, data_range, win_size, sigma, k1, k2):
    """Mean SSIM and contrast-structure (cs) per (batch, channel): two ``(N, C)`` tensors."""
    win = _gaussian_window(win_size, sigma)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu_x = _gaussian_filter(x, win)
    mu_y = _gaussian_filter(y, win)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_xx = _gaussian_filter(x * x, win) - mu_xx
    sigma_yy = _gaussian_filter(y * y, win) - mu_yy
    sigma_xy = _gaussian_filter(x * y, win) - mu_xy

    cs_map = (2.0 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    ssim_map = ((2.0 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs_map
    return ssim_map.mean(dim=(2, 3)), cs_map.mean(dim=(2, 3))


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    """Fold the time axis of NTCHW video into the batch, B-major: ``(B*T, C, H, W)``."""
    return x.flatten(0, 1) if x.dim() == 5 else x


def ssim(
    x: torch.Tensor,
    y: torch.Tensor,
    data_range: float = 1.0,
    win_size: int = 11,
    win_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
    size_average: bool = True,
) -> torch.Tensor:
    """Structural similarity of NCHW images / NTCHW videos (``pytorch_msssim`` semantics).

    ``size_average=False`` gives one value per image, ``(B,)``, or per frame
    of a video, ``(B*T,)`` in B-major order.
    """
    x, y = _to_nchw(x), _to_nchw(y)
    s, _ = _ssim_per_channel(x, y, data_range, win_size, win_sigma, k1, k2)
    return s.mean() if size_average else s.mean(dim=1)


def _msssim_downsample(x: torch.Tensor) -> torch.Tensor:
    """``pytorch_msssim``'s 2x downsample, ``avg_pool2d(k=2, padding=side % 2)``.

    The pad is on both sides, but the last window of an odd side never reaches
    the far pad element: in effect one top / left zero pad, divided by 4.
    """
    return F.avg_pool2d(x, 2, padding=(x.shape[2] % 2, x.shape[3] % 2), count_include_pad=True)


def ms_ssim(
    x: torch.Tensor,
    y: torch.Tensor,
    data_range: float = 1.0,
    win_size: int = 11,
    win_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
    weights: Sequence[float] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    size_average: bool = True,
) -> torch.Tensor:
    """Multi-scale SSIM: the product over scales of ``relu(cs) ** w``, the last scale's SSIM for cs.

    Raises ``ValueError`` unless the shorter side exceeds
    ``(win_size - 1) * 2 ** (levels - 1)``.
    """
    x, y = _to_nchw(x), _to_nchw(y)
    levels = len(weights)
    min_side = min(x.shape[2], x.shape[3])
    if min_side <= (win_size - 1) * (2 ** (levels - 1)):
        raise ValueError(
            f"image side {min_side} too small for {levels}-level MS-SSIM with win {win_size}"
        )

    mcs = []
    for i in range(levels):
        s, cs = _ssim_per_channel(x, y, data_range, win_size, win_sigma, k1, k2)
        if i < levels - 1:
            mcs.append(torch.relu(cs))
            x = _msssim_downsample(x)
            y = _msssim_downsample(y)

    stacked = torch.stack(mcs + [torch.relu(s)], dim=0)  # (levels, N, C)
    w = torch.tensor(weights, dtype=stacked.dtype, device=stacked.device)
    out = (stacked ** w[:, None, None]).prod(dim=0)
    return out.mean() if size_average else out.mean(dim=1)


def _unit_range(*tensors: torch.Tensor):
    """[-1, 1] -> [0, 1]."""
    return tuple((t + 1.0) / 2.0 for t in tensors)


class SSIMLoss:
    """``1 - ssim(x, y, **kwargs)``, the inputs first mapped [-1, 1] -> [0, 1] if ``convert_range``."""

    def __init__(self, convert_range: bool = False, **kwargs):
        self.convert_range = convert_range
        self.kwargs = kwargs

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.convert_range:
            x, y = _unit_range(x, y)
        return 1.0 - ssim(x, y, **self.kwargs)


class MS_SSIMLoss:
    """``1 - ms_ssim(x, y, **kwargs)``, the inputs first mapped [-1, 1] -> [0, 1] if ``convert_range``."""

    def __init__(self, convert_range: bool = False, **kwargs):
        self.convert_range = convert_range
        self.kwargs = kwargs

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.convert_range:
            x, y = _unit_range(x, y)
        return 1.0 - ms_ssim(x, y, **self.kwargs)


class SSIMLossDynamic:
    """MS-SSIM loss of the change from the current frame: ``1 - ms_ssim(x - curr, y - curr)``.

    ``curr_image`` broadcasts against both, e.g. ``(B, 1, C, H, W)`` against
    ``(B, T, C, H, W)``; ``convert_range`` maps all three.
    """

    def __init__(self, convert_range: bool = False, **kwargs):
        self.convert_range = convert_range
        self.kwargs = kwargs

    def __call__(
        self, curr_image: torch.Tensor, x: torch.Tensor, y: torch.Tensor
    ) -> torch.Tensor:
        if self.convert_range:
            curr_image, x, y = _unit_range(curr_image, x, y)
        return 1.0 - ms_ssim(x - curr_image, y - curr_image, **self.kwargs)


# ---------------------------------------------------------------------------
# Other public extras
# ---------------------------------------------------------------------------


def tv_loss(img: torch.Tensor, tv_weight: float) -> torch.Tensor:
    """Total variation of NCHW images: ``tv_weight`` times the summed squared H and W differences."""
    w_var = ((img[:, :, :, :-1] - img[:, :, :, 1:]) ** 2).sum()
    h_var = ((img[:, :, :-1, :] - img[:, :, 1:, :]) ** 2).sum()
    return tv_weight * (h_var + w_var)


class TotalVariationLoss:
    """:func:`tv_loss` with a fixed weight."""

    def __init__(self, tv_weight: float = 1.0):
        self.tv_weight = tv_weight

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return tv_loss(x, self.tv_weight)


class GradientDifferenceLoss:
    """Gradient difference loss of NTCHW videos.

    The reference adds its H and W terms elementwise, which cannot broadcast
    (``(..., H-1, W)`` against ``(..., H, W-1)``); as in the JAX package each
    term is mean-reduced first, giving the intended scalar.
    """

    def __init__(self, alpha: Union[int, float] = 2):
        self.alpha = alpha

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        t1 = (
            (x[:, :, :, 1:, :] - x[:, :, :, :-1, :]).abs()
            - (y[:, :, :, 1:, :] - y[:, :, :, :-1, :]).abs()
        ).abs() ** self.alpha
        t2 = (
            (x[:, :, :, :, 1:] - x[:, :, :, :, :-1]).abs()
            - (y[:, :, :, :, 1:] - y[:, :, :, :, :-1]).abs()
        ).abs() ** self.alpha
        return t1.mean() + t2.mean()


class FocalLoss:
    """Focal cross-entropy of class probabilities, the reference's ``FocalLoss``.

    ``logit`` is ``(B, num_class, ...)`` probabilities (after ``apply_nonlin``
    if given), the class axis 1 as in the reference; ``target`` holds integer
    class ids. ``alpha``: ``None`` weighs every class 1; a sequence (anything
    with ``__len__``) is normalized to sum 1; a ``float`` is ``alpha`` at
    ``balance_index`` and ``1 - alpha`` elsewhere; any other type (an ``int``
    too) raises ``TypeError``. The class weights are float32, as in JAX.
    """

    def __init__(
        self,
        apply_nonlin: Optional[Callable] = None,
        alpha=None,
        gamma: float = 2.0,
        balance_index: int = 0,
        smooth: float = 1e-5,
        size_average: bool = True,
    ):
        if smooth is not None and (smooth < 0 or smooth > 1.0):
            raise ValueError("smooth value should be in [0,1]")
        self.apply_nonlin = apply_nonlin
        self.alpha = alpha
        self.gamma = gamma
        self.balance_index = balance_index
        self.smooth = smooth
        self.size_average = size_average

    def __call__(self, logit: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if self.apply_nonlin is not None:
            logit = self.apply_nonlin(logit)
        num_class = logit.shape[1]

        if logit.dim() > 2:  # (B, C, d1, d2, ...) -> (B*m, C)
            logit = logit.reshape(logit.shape[0], num_class, -1)
            logit = logit.transpose(1, 2).reshape(-1, num_class)
        target = target.reshape(-1).long()

        alpha = self.alpha
        if alpha is None:
            alpha = torch.ones(num_class, dtype=torch.float32)
        elif isinstance(alpha, (list, tuple)) or (
            hasattr(alpha, "__len__") and not isinstance(alpha, (int, float))
        ):
            alpha = torch.as_tensor(alpha, dtype=torch.float32)
            assert alpha.shape[0] == num_class
            alpha = alpha / alpha.sum()
        elif isinstance(alpha, float):
            alpha = torch.full((num_class,), 1.0 - alpha, dtype=torch.float32)
            alpha[self.balance_index] = self.alpha
        else:
            raise TypeError("Not support alpha type")
        alpha = alpha.to(logit.device)

        one_hot = F.one_hot(target, num_class).to(logit.dtype)
        if self.smooth:
            one_hot = torch.clamp(one_hot, self.smooth / (num_class - 1), 1.0 - self.smooth)
        pt = (one_hot * logit).sum(dim=1) + self.smooth
        logpt = torch.log(pt)
        loss = -alpha[target] * (1.0 - pt) ** self.gamma * logpt
        return loss.mean() if self.size_average else loss.sum()


LOSS_NAMES = (
    "mse",
    "bce",
    "binary_crossentropy",
    "crossentropy",
    "focal",
    "ssim",
    "ms_ssim",
    "l1",
    "tv",
    "total_variation",
    "ssim_dynamic",
    "gdl",
    "gradient_difference_loss",
)


def _nll(log_probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``F.nll_loss``'s mean: minus the mean ``(N, C)`` log-probability at integer targets."""
    return -log_probs.gather(1, target.long()[:, None]).mean()


def get_loss(loss: Union[str, Callable] = "mse", **kwargs) -> Callable:
    """The criterion of a name in :data:`LOSS_NAMES`; a callable passes through.

    ``"ssim"`` / ``"ms_ssim"`` / ``"ssim_dynamic"`` pass ``data_range=1.0,
    size_average=True`` and ``kwargs`` (so a ``data_range`` in ``kwargs``
    raises); ``"tv"`` reads ``tv_weight`` and ``"gdl"`` ``alpha`` from
    ``kwargs``.
    """
    if callable(loss):
        return loss
    assert loss in LOSS_NAMES
    if loss == "mse":
        return lambda x, y: ((x - y) ** 2).mean()
    if loss in ("bce", "binary_crossentropy", "crossentropy"):
        return _nll
    if loss == "focal":
        return FocalLoss()
    if loss == "ssim":
        return SSIMLoss(data_range=1.0, size_average=True, **kwargs)
    if loss == "ms_ssim":
        return MS_SSIMLoss(data_range=1.0, size_average=True, **kwargs)
    if loss == "ssim_dynamic":
        return SSIMLossDynamic(data_range=1.0, size_average=True, **kwargs)
    if loss == "l1":
        return lambda x, y: (x - y).abs().mean()
    if loss in ("tv", "total_variation"):
        return TotalVariationLoss(tv_weight=kwargs.get("tv_weight", 1))
    return GradientDifferenceLoss(alpha=kwargs.get("alpha", 2))
