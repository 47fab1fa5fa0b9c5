"""The port's skill metrics and ``evaluate_nowcast`` vs the JAX package's, on the CPU.

Each metric runs on the same seeded arrays on both sides (the port's
ensembles ``(S, B, T, C, H, W)``, JAX's ``(S, B, T, H, W, C)``) and agrees
to 1e-6; the hand cases of ``tests/test_metrics.py`` are ported. The skill
loop runs a tiny DGMR on both sides with the JAX loop's own latent draws
(recovered from its keys and handed to the port through ``draw_latents``),
and the dataset CSI is checked to pool contingency counts.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from skillful_nowcasting_tpu import DGMR as JaxDGMR
from skillful_nowcasting_tpu import inference as jinference
from skillful_nowcasting_tpu import metrics as jmetrics
from skillful_nowcasting_tpu.hub.pretrained import abstract_variables
from skillful_nowcasting_tpu.utils import random_fill_variables
from skillful_nowcasting_tpu_torch import DGMR, inference, metrics
from skillful_nowcasting_tpu_torch.hub import load_variables
from torch_port_helpers import perturb, t

torch.set_num_threads(1)

TOL = 1e-6


def to_nhwc(a: np.ndarray) -> np.ndarray:
    return np.moveaxis(a, -3, -1)


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(0)
    samples = rng.gamma(0.6, 2.0, (6, 2, 3, 1, 16, 16)).astype(np.float32)
    obs = rng.gamma(0.6, 2.0, (2, 3, 1, 16, 16)).astype(np.float32)
    return samples, obs


CASES = {
    "crps_fair": (metrics.crps_ensemble, jmetrics.crps_ensemble, dict(fair=True)),
    "crps_plain": (metrics.crps_ensemble, jmetrics.crps_ensemble, dict(fair=False)),
    "pooled_crps_2": (metrics.pooled_crps, jmetrics.pooled_crps, dict(pool=2)),
    "pooled_crps_4": (metrics.pooled_crps, jmetrics.pooled_crps, dict(pool=4, fair=False)),
    "csi_scalar": (metrics.csi, jmetrics.csi, dict(threshold=1.0)),
    "csi_list": (metrics.csi, jmetrics.csi, dict(threshold=[0.5, 1.0, 4.0, 100.0])),
    "csi_counts": (metrics.csi_counts, jmetrics.csi_counts, dict(threshold=[0.5, 2.0])),
    "pooled_csi_1": (metrics.pooled_csi, jmetrics.pooled_csi, dict(threshold=[1.0, 4.0], pool=1)),
    "pooled_csi_4": (metrics.pooled_csi, jmetrics.pooled_csi, dict(threshold=2.0, pool=4)),
    "ensemble_mean_mse": (metrics.ensemble_mean_mse, jmetrics.ensemble_mean_mse, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_metric_matches_jax(fields, case):
    ours, theirs, kwargs = CASES[case]
    samples, obs = fields
    if case.startswith(("csi", "pooled_csi")):  # deterministic scores of one member
        samples = samples[0]
    got = ours(t(samples), t(obs), **kwargs).numpy()
    want = np.asarray(theirs(jnp.asarray(to_nhwc(samples)), jnp.asarray(to_nhwc(obs)), **kwargs))
    if got.ndim >= 3 and case.startswith(("crps", "pooled_crps")):
        got = to_nhwc(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_large_ensemble_crps_matches_jax():
    """More than 16 members: the order-statistics form on both sides."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((20, 2, 1, 8, 8)).astype(np.float32)
    y = rng.standard_normal((2, 1, 8, 8)).astype(np.float32)
    got = metrics.crps_ensemble(t(x), t(y)).numpy()
    want = np.asarray(jmetrics.crps_ensemble(jnp.asarray(to_nhwc(x)), jnp.asarray(to_nhwc(y))))
    np.testing.assert_allclose(to_nhwc(got), want, rtol=TOL, atol=TOL)


# --- hand cases (tests/test_metrics.py) ---------------------------------------------


def crps_brute(x, y, fair):
    s = x.shape[0]
    skill = np.mean([np.abs(xi - y) for xi in x], axis=0)
    spread = sum(np.abs(xi - xj) for xi in x for xj in x)
    return skill - 0.5 * spread / (s * (s - 1) if fair else s * s)


def test_crps_hand_cases():
    rng = np.random.default_rng(2)
    member, obs = rng.random((2, 1, 4, 4), np.float32), rng.random((2, 1, 4, 4), np.float32)
    same = metrics.crps_ensemble(t(np.repeat(member[None], 5, axis=0)), t(obs)).numpy()
    np.testing.assert_allclose(same, np.abs(member - obs), rtol=1e-6, atol=1e-6)  # spread 0: MAE
    x = rng.standard_normal((6, 3, 5)).astype(np.float32)
    y = rng.standard_normal((3, 5)).astype(np.float32)
    for fair in (True, False):
        np.testing.assert_allclose(metrics.crps_ensemble(t(x), t(y), fair=fair).numpy(),
                                   crps_brute(x, y, fair), rtol=1e-5, atol=1e-6)


def test_crps_fair_gaussian_analytic():
    """CRPS(N(0,1), y) = y(2 Phi(y) - 1) + 2 phi(y) - 1/sqrt(pi), from a large ensemble."""
    from math import erf, exp, pi, sqrt

    x = np.random.default_rng(2).standard_normal((4000, 1))
    y = 0.7
    analytic = y * (2 * 0.5 * (1 + erf(y / sqrt(2))) - 1) + 2 * exp(-y * y / 2) / sqrt(2 * pi) \
        - 1 / sqrt(pi)
    got = float(metrics.crps_ensemble(t(x), torch.tensor([y]))[0])
    np.testing.assert_allclose(got, analytic, atol=0.02)


def test_csi_hand_cases():
    pred = torch.tensor([5.0, 5.0, 0.0, 0.0])  # events 1, 1, 0, 0
    obs = torch.tensor([5.0, 0.0, 5.0, 0.0])  # events 1, 0, 1, 0: 1 hit, 1 false alarm, 1 miss
    np.testing.assert_allclose(float(metrics.csi(pred, obs, 1.0)), 1 / 3, rtol=1e-6)
    np.testing.assert_allclose(metrics.csi(pred, obs, [1.0, 6.0]).numpy(), [1 / 3, 0.0], rtol=1e-6)
    obs2, pred2 = torch.zeros((1, 1, 8, 8)), torch.zeros((1, 1, 8, 8))
    obs2[0, 0, 2, 2] = pred2[0, 0, 3, 3] = 10.0  # an event displaced by one pixel
    assert float(metrics.pooled_csi(pred2, obs2, 1.0, pool=1)) == 0.0
    assert float(metrics.pooled_csi(pred2, obs2, 1.0, pool=4)) == 1.0


def test_pooled_crps_and_mse_hand_cases():
    rng = np.random.default_rng(3)
    x, y = t(rng.random((4, 2, 1, 8, 8), np.float32)), t(rng.random((2, 1, 8, 8), np.float32))
    p1 = metrics.pooled_crps(x, y, pool=1)
    assert torch.equal(p1, metrics.crps_ensemble(x, y))
    p4 = metrics.pooled_crps(x, y, pool=4)
    assert p4.shape == (2, 1, 2, 2) and p4.mean() < p1.mean()  # pooling white noise shrinks it
    two = torch.stack([torch.zeros((2, 2)), torch.full((2, 2), 2.0)])
    np.testing.assert_allclose(float(metrics.ensemble_mean_mse(two, torch.zeros((2, 2)))), 1.0)


# --- the skill loop ---------------------------------------------------------------


TINY = dict(forecast_steps=2, output_shape=64, latent_channels=256, context_channels=32,
            num_spatial_layers=2, num_temporal_layers=2)  # 64^2 admits two halvings a tower
SAMPLES = 2


@pytest.fixture(scope="module")
def models():
    jmodel = JaxDGMR(**TINY)
    variables = perturb(
        jax.tree.map(np.array, random_fill_variables(abstract_variables(jmodel), 0)), 1)
    port = DGMR(**TINY, device="cpu")
    assert load_variables(port, variables) == 0
    return jmodel, variables, port.eval()


def jax_loop_latents(jmodel, variables, n_batches, key):
    """The latents JAX's ``evaluate_nowcast`` draws (``inference.py:382-386``, ``:273-276``)."""

    def latent(mdl):
        c, h, w = mdl.latent_stack.shape
        return jax.random.normal(mdl.latent_stack.make_rng("latent"), (1, h, w, c), jnp.float32)

    out = []
    for _ in range(n_batches):
        key, batch_key = jax.random.split(key)
        zs = [np.array(jmodel.apply(variables, method=latent, rngs={"latent": k}))
              for k in jax.random.split(batch_key, SAMPLES)]
        out.append(t(np.moveaxis(np.concatenate(zs), -1, 1)))
    return out


def test_evaluate_nowcast_matches_jax(models, monkeypatch):
    jmodel, variables, port = models
    rng = np.random.default_rng(9)
    batches = [(rng.random((2, 4, 1, 64, 64), np.float32),
                rng.random((2, 2, 1, 64, 64), np.float32)) for _ in range(2)]
    kwargs = dict(num_samples=SAMPLES, thresholds=(0.0, 0.05, 0.5), pools=(1, 2, 4))
    want = jinference.evaluate_nowcast(
        jmodel, variables, [(to_nhwc(a), to_nhwc(b)) for a, b in batches], **kwargs)
    latents = iter(jax_loop_latents(jmodel, variables, len(batches), jax.random.key(0)))
    monkeypatch.setattr(inference, "draw_latents", lambda shape, n, gen, like: next(latents))
    got = inference.evaluate_nowcast(port, batches, **kwargs)
    assert set(got) == set(want) and got["batches"] == 2
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, rtol=2e-4, atol=1e-6, err_msg=name)
    assert 0.0 < got["csi_0.05"] < 1.0  # the thresholds are not vacuous


class Persistence(nn.Module):
    """A deterministic stand-in for DGMR: every lead time is the last context frame.

    It lets the test fix the prediction field exactly (a random-weight DGMR
    may never cross a CSI threshold, which would make the check vacuous).
    """

    num_samples = 2

    def __init__(self):
        super().__init__()
        self.anchor = nn.Parameter(torch.zeros(()))  # gives make_generate a device
        self.latent_stack = SimpleNamespace(shape=(8, 1, 1))

    def forward(self, x, z=None):
        return x[:, -1:].repeat(1, 2, 1, 1, 1)


class JaxPersistence:
    num_samples = 2

    def apply(self, variables, x, train=False, rngs=None):
        return jnp.repeat(x[:, -1:], 2, axis=1)


def test_evaluate_nowcast_pools_csi_counts():
    """The dataset CSI is the ratio of pooled counts, not the mean of per-batch ratios."""
    rng = np.random.default_rng(11)
    b1 = (rng.random((1, 4, 1, 32, 32), np.float32), rng.random((1, 2, 1, 32, 32), np.float32))
    # No observed events in batch 2 while the predictions still cross 0.5.
    b2 = (rng.random((1, 4, 1, 32, 32), np.float32),
          (0.1 * rng.random((1, 2, 1, 32, 32))).astype(np.float32))
    model = Persistence().eval()
    out = inference.evaluate_nowcast(model, [b1, b2], thresholds=(0.5,), pools=(1,))
    bm = inference.make_skill_metrics(model, thresholds=(0.5,), pools=(1,), return_counts=True)
    counts, per_batch = torch.zeros((1, 3)), []
    for images, future in (b1, b2):
        m = bm(images, future)
        counts += m["csi_counts"]
        per_batch.append(float(m["csi_0.5"]))
    assert counts[0, 0] > 0
    np.testing.assert_allclose(out["csi_0.5"], float(counts[0, 0] / counts[0].sum()), rtol=1e-6)
    assert abs(out["csi_0.5"] - np.mean(per_batch)) > 1e-6
    want = jinference.evaluate_nowcast(
        JaxPersistence(), {}, [(to_nhwc(a), to_nhwc(b)) for a, b in (b1, b2)],
        thresholds=(0.5,), pools=(1,))
    for name, value in want.items():
        np.testing.assert_allclose(out[name], value, rtol=1e-6, err_msg=name)


def test_skill_metrics_refuse_train_mode(models):
    with pytest.raises(ValueError, match="eval"):
        inference.make_skill_metrics(DGMR(**TINY, device="cpu"))
