"""The port's losses against the JAX package's, on the CPU.

Inputs are made from a seed with numpy in the port's layouts (NCHW images,
NTCHW videos, ``(S, B, T, C, H, W)`` ensembles) and handed to JAX in its
NHWC / NTHWC layouts. Forwards are held at the block tolerance (rtol 2e-4 /
atol 2e-5), gradients from ``jax.grad`` against autograd at 1e-3 of each
gradient's max-abs. The SSIM family runs in float32 only (its JAX window is
float32 whatever the input); the other losses also run in float64 under
``jax.enable_x64``, held at 1e-10 of max-abs. Each JAX reference is one
small jitted loss and its gradient; no model is compiled here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skillful_nowcasting_tpu import losses as jl
from skillful_nowcasting_tpu_torch import losses as pl
from torch_port_helpers import ATOL, RTOL

torch.set_num_threads(1)
GRAD_TOL = 1e-3  # of the gradient's max-abs
F64_TOL = 1e-10  # of max-abs, float64 on both sides


def to_jax(a: np.ndarray) -> np.ndarray:
    """Port layout (channels at -3) -> JAX layout (channels last)."""
    return np.moveaxis(a, -3, -1)


def from_jax(a) -> np.ndarray:
    return np.moveaxis(np.array(a), -1, -3)


def both(port_fn, jax_fn, arrays, wrt=(0,), layout=True, x64=False):
    """Each package's scalar loss of ``arrays`` and its gradients w.r.t. ``arrays[i]``, i in ``wrt``.

    Returns ``(port value, port grads, jax value, jax grads)`` as numpy, all in
    the port's layout. ``layout=False`` hands JAX the arrays as they are.
    """
    xs = [torch.tensor(a, requires_grad=i in wrt) for i, a in enumerate(arrays)]
    out = port_fn(*xs)
    grads = torch.autograd.grad(out, [xs[i] for i in wrt]) if wrt else ()
    conv_in = to_jax if layout else np.asarray
    conv_out = from_jax if layout else np.array
    with jax.enable_x64(x64):
        jxs = [jnp.asarray(conv_in(a)) for a in arrays]
        if wrt:
            jout, jgrads = jax.jit(jax.value_and_grad(jax_fn, argnums=wrt))(*jxs)
        else:
            jout, jgrads = jax_fn(*jxs), ()
        jout, jgrads = np.array(jout), [conv_out(g) for g in jgrads]
    return out.detach().numpy(), [np.array(g) for g in grads], jout, jgrads


def assert_parity(port_fn, jax_fn, arrays, wrt=(0,), layout=True, x64=False):
    got, grads, want, jgrads = both(port_fn, jax_fn, arrays, wrt, layout, x64)
    if x64:
        assert got.dtype == np.float64
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got - want).max() <= F64_TOL * scale, (got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for g, jg in zip(grads, jgrads):
        scale = np.abs(jg).max()
        assert scale > 0
        err = np.abs(g - jg).max()
        assert err <= (F64_TOL if x64 else GRAD_TOL) * scale, (err, scale)
    return got


def rand(seed, *shape, dtype=np.float32):
    return np.random.default_rng(seed).random(shape).astype(dtype)


def correlated(seed, *shape, noise=0.1):
    """``(x, y)`` with y a noisy copy of x, so every scale's cs is well above 0."""
    x = rand(seed, *shape)
    y = (x + noise * np.random.default_rng(seed + 1).standard_normal(shape)).astype(np.float32)
    return x, y


# ---------------------------------------------------------------------------
# SSIM family, float32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 3, 24, 28), (2, 3, 2, 17, 19)], ids=["image", "video"])
@pytest.mark.parametrize("size_average", [True, False])
def test_ssim_matches_jax(shape, size_average):
    x, y = correlated(0, *shape)
    kw = dict(size_average=size_average)
    if size_average:
        assert_parity(lambda a, b: pl.ssim(a, b, **kw), lambda a, b: jl.ssim(a, b, **kw),
                      [x, y], wrt=(0, 1))
    else:  # one value per image, or per (b, t) frame in B-major order
        got = pl.ssim(torch.tensor(x), torch.tensor(y), **kw)
        want = jl.ssim(jnp.asarray(to_jax(x)), jnp.asarray(to_jax(y)), **kw)
        n = shape[0] * (shape[1] if len(shape) == 5 else 1)
        assert got.shape == (n,)
        np.testing.assert_allclose(np.array(got), np.array(want), rtol=RTOL, atol=ATOL)
        # the gradient of a weighted sum holds the per-frame values' order too
        w = np.arange(1, n + 1, dtype=np.float32)
        assert_parity(lambda a, b: (pl.ssim(a, b, **kw) * torch.tensor(w)).sum(),
                      lambda a, b: (jl.ssim(a, b, **kw) * w).sum(), [x, y], wrt=(0, 1))


def test_ssim_options_match_jax():
    x, y = correlated(2, 2, 1, 30, 30)
    kw = dict(data_range=2.0, win_size=7, win_sigma=1.0, k1=0.02, k2=0.05)
    assert_parity(lambda a, b: pl.ssim(a, b, **kw), lambda a, b: jl.ssim(a, b, **kw), [x, y])


@pytest.mark.parametrize("hw", [(176, 176), (177, 181)], ids=["even", "odd"])
def test_ms_ssim_default_levels_match_jax(hw):
    """Five levels; on 177x181 the downsample's top / left pad is live at every level."""
    x, y = correlated(3, 2, 1, *hw)
    assert_parity(pl.ms_ssim, jl.ms_ssim, [x, y], wrt=(0, 1))


@pytest.mark.parametrize("size_average", [True, False])
def test_ms_ssim_three_levels_on_video_matches_jax(size_average):
    x, y = correlated(4, 2, 2, 2, 45, 47)
    kw = dict(weights=(0.2, 0.3, 0.5), size_average=size_average)
    fns = (lambda a, b: pl.ms_ssim(a, b, **kw).sum(), lambda a, b: jl.ms_ssim(a, b, **kw).sum())
    assert_parity(*fns, [x, y], wrt=(0, 1))
    if not size_average:
        got = pl.ms_ssim(torch.tensor(x), torch.tensor(y), **kw)
        want = jl.ms_ssim(jnp.asarray(to_jax(x)), jnp.asarray(to_jax(y)), **kw)
        assert got.shape == (4,)
        np.testing.assert_allclose(np.array(got), np.array(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hw", [(10, 10), (11, 14), (9, 12), (177, 181)])
def test_msssim_downsample_matches_jax(hw):
    x = rand(5, 2, 3, *hw)
    got = pl._msssim_downsample(torch.tensor(x))
    want = from_jax(jl._msssim_downsample(jnp.asarray(to_jax(x))))
    assert got.shape == want.shape == (2, 3, (hw[0] + 1) // 2, (hw[1] + 1) // 2)
    np.testing.assert_allclose(np.array(got), want, rtol=1e-6, atol=1e-7)


def test_ms_ssim_size_check_and_identity():
    """Sides <= (win - 1) * 2**(levels - 1) raise in both; loss(x, x) is 0 (forward only)."""
    small = rand(6, 1, 1, 160, 200)
    with pytest.raises(ValueError, match="too small"):
        pl.ms_ssim(torch.tensor(small), torch.tensor(small))
    with pytest.raises(ValueError, match="too small"):
        jl.ms_ssim(jnp.asarray(to_jax(small)), jnp.asarray(to_jax(small)))
    pl.ms_ssim(torch.tensor(small), torch.tensor(small), weights=(0.5, 0.5))  # 160 > 20
    x = torch.tensor(rand(7, 1, 1, 181, 181))
    assert abs(pl.MS_SSIMLoss()(x, x).item()) <= 1e-5
    assert abs(pl.SSIMLoss()(x, x).item()) <= 1e-6


@pytest.mark.parametrize("convert_range", [False, True])
def test_ssim_loss_classes_match_jax(convert_range):
    x, y = correlated(8, 2, 2, 1, 45, 45)
    x, y = 2 * x - 1, 2 * y - 1
    kw = dict(convert_range=convert_range, weights=(0.3, 0.3, 0.4))
    assert_parity(pl.MS_SSIMLoss(**kw), jl.MS_SSIMLoss(**kw), [x, y], wrt=(0, 1))
    assert_parity(pl.SSIMLoss(convert_range=convert_range, win_size=9),
                  jl.SSIMLoss(convert_range=convert_range, win_size=9), [x, y], wrt=(0, 1))
    curr = x[:, -1:] * 0.5  # (B, 1, C, H, W) broadcasts over T
    assert_parity(pl.SSIMLossDynamic(**kw), jl.SSIMLossDynamic(**kw), [curr, x, y],
                  wrt=(0, 1, 2))


# ---------------------------------------------------------------------------
# The other losses, float32 and float64
# ---------------------------------------------------------------------------

DTYPES = [pytest.param(False, id="f32"), pytest.param(True, id="f64")]


def dt(x64):
    return np.float64 if x64 else np.float32


@pytest.mark.parametrize("x64", DTYPES)
def test_nowcasting_loss_and_regularizer_match_jax(x64):
    s = np.random.default_rng(9).standard_normal((2, 3, 1)).astype(dt(x64))
    for flag in (True, False, 1):  # only the identity `real_flag is True` flips the sign
        assert_parity(lambda a: pl.NowcastingLoss()(a, flag),
                      lambda a: jl.NowcastingLoss()(a, flag), [s], layout=False, x64=x64)
    assert not np.isclose(pl.NowcastingLoss()(torch.tensor(s), True).item(),
                          pl.NowcastingLoss()(torch.tensor(s), 1).item())
    rng = np.random.default_rng(10)
    samples = (30 * rng.random((3, 2, 2, 1, 6, 7)) - 3).astype(dt(x64))
    target = (30 * rng.random((2, 2, 1, 6, 7)) - 3).astype(dt(x64))  # clip at 0 and 24 live
    assert_parity(pl.grid_cell_regularizer, jl.grid_cell_regularizer, [samples, target],
                  wrt=(0, 1), x64=x64)


@pytest.mark.parametrize("x64", DTYPES)
def test_tv_and_gdl_match_jax(x64):
    img = rand(11, 2, 3, 9, 11, dtype=dt(x64))
    assert_parity(lambda a: pl.tv_loss(a, 0.7), lambda a: jl.tv_loss(a, 0.7), [img], x64=x64)
    assert_parity(pl.TotalVariationLoss(), jl.TotalVariationLoss(), [img], x64=x64)
    x, y = rand(12, 2, 3, 2, 9, 11, dtype=dt(x64)), rand(13, 2, 3, 2, 9, 11, dtype=dt(x64))
    for alpha in (2, 1.5):
        assert_parity(pl.GradientDifferenceLoss(alpha), jl.GradientDifferenceLoss(alpha),
                      [x, y], wrt=(0, 1), x64=x64)


def focal_inputs(seed, x64, shape=(2, 3, 5, 4)):
    """Class probabilities ``(B, C, ...)`` (class axis 1) and integer targets."""
    rng = np.random.default_rng(seed)
    p = rng.random(shape) + 0.05
    p = (p / p.sum(axis=1, keepdims=True)).astype(dt(x64))
    target = rng.integers(0, shape[1], (shape[0],) + shape[2:])
    return p, target


FOCAL_CASES = {
    "default": dict(),
    "alpha_list": dict(alpha=[1.0, 2.0, 3.0]),
    "alpha_array": dict(alpha=np.array([0.5, 0.2, 0.3])),
    "alpha_float": dict(alpha=0.25, balance_index=1),
    "gamma_sum": dict(gamma=1.5, size_average=False),
    "no_smooth": dict(smooth=0.0),
    "smooth_big": dict(smooth=0.2),
}


@pytest.mark.parametrize("x64", DTYPES)
@pytest.mark.parametrize("case", list(FOCAL_CASES))
def test_focal_loss_matches_jax(case, x64):
    p, target = focal_inputs(14, x64)
    kw = FOCAL_CASES[case]
    assert_parity(pl.FocalLoss(**kw), jl.FocalLoss(**kw), [p, target], layout=False, x64=x64)


def test_focal_loss_nonlin_2d_and_errors():
    logits = np.random.default_rng(15).standard_normal((6, 4)).astype(np.float32)
    target = np.array([0, 3, 1, 2, 2, 0])
    assert_parity(pl.FocalLoss(apply_nonlin=lambda a: torch.softmax(a, dim=1)),
                  jl.FocalLoss(apply_nonlin=lambda a: jax.nn.softmax(a, axis=1)),
                  [logits, target], layout=False)
    for smooth in (-0.1, 1.5):
        for cls in (pl.FocalLoss, jl.FocalLoss):
            with pytest.raises(ValueError, match="smooth"):
                cls(smooth=smooth)
    p, target = focal_inputs(16, False)
    for alpha in (1, True):  # an int is not a float: both refuse it
        with pytest.raises(TypeError, match="alpha"):
            pl.FocalLoss(alpha=alpha)(torch.tensor(p), torch.tensor(target))
        with pytest.raises(TypeError, match="alpha"):
            jl.FocalLoss(alpha=alpha)(jnp.asarray(p), jnp.asarray(target))


# ---------------------------------------------------------------------------
# get_loss
# ---------------------------------------------------------------------------


def get_loss_inputs(name, x64):
    """``(kwargs, arrays, wrt, layout)`` for one name; the SSIM family only in float32."""
    d = dt(x64)
    video = [rand(17, 2, 2, 1, 45, 47, dtype=d), rand(18, 2, 2, 1, 45, 47, dtype=d)]
    if name in ("mse", "l1"):
        return {}, video, (0, 1), True
    if name in ("bce", "binary_crossentropy", "crossentropy"):
        logp = np.log(focal_inputs(19, x64, (7, 3))[0])
        return {}, [logp, np.array([0, 2, 1, 1, 0, 2, 2])], (0,), False
    if name == "focal":
        return {}, list(focal_inputs(20, x64)), (0,), False
    x, y = correlated(21, 2, 2, 1, 45, 47)
    if name in ("ssim", "ms_ssim"):
        return {"weights": (0.4, 0.6)} if name == "ms_ssim" else {}, [x, y], (0, 1), True
    if name == "ssim_dynamic":
        return {"weights": (0.4, 0.6), "k2": 0.05}, [x[:, :1], x, y], (0, 1, 2), True
    if name in ("tv", "total_variation"):
        return {"tv_weight": 0.3}, [video[0][:, 0]], (0,), True
    return {"alpha": 1.5}, video, (0, 1), True  # gdl


SSIM_NAMES = ("ssim", "ms_ssim", "ssim_dynamic")
GET_LOSS_CASES = [pytest.param(n, False, id=f"{n}-f32") for n in pl.LOSS_NAMES] + [
    pytest.param(n, True, id=f"{n}-f64") for n in pl.LOSS_NAMES if n not in SSIM_NAMES
]


@pytest.mark.parametrize("name,x64", GET_LOSS_CASES)
def test_get_loss_matches_jax(name, x64):
    kw, arrays, wrt, layout = get_loss_inputs(name, x64)
    assert_parity(pl.get_loss(name, **kw), jl.get_loss(name, **kw), arrays, wrt, layout, x64)


def test_get_loss_names_and_errors():
    assert pl.LOSS_NAMES == (
        "mse", "bce", "binary_crossentropy", "crossentropy", "focal", "ssim", "ms_ssim", "l1",
        "tv", "total_variation", "ssim_dynamic", "gdl", "gradient_difference_loss",
    )
    for factory in (pl.get_loss, jl.get_loss):
        with pytest.raises(AssertionError):
            factory("nope")
        for name in SSIM_NAMES:  # data_range is fixed at 1.0: a second one raises
            with pytest.raises(TypeError, match="data_range"):
                factory(name, data_range=2.0)
        criterion = lambda a, b: a  # noqa: E731
        assert factory(criterion) is criterion
    assert isinstance(pl.get_loss("focal"), pl.FocalLoss)
    assert pl.get_loss("tv").tv_weight == 1 and pl.get_loss("gdl").alpha == 2
    assert pl.get_loss("ms_ssim").kwargs == {"data_range": 1.0, "size_average": True}
