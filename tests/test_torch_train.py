"""The port's training path vs the JAX package's, on the CPU.

* losses, lr schedules and Adam against ``losses.py`` and optax, without a model;
* ``desaturate_discriminator`` on the same tree;
* ONE JAX train step (``logging_forward=False, return_grads=True``, SGD) against
  the port's, from the same weights and the JAX step's own random draws
  (recovered from its key, since threefry and Philox never agree): metrics at
  rtol 1e-4; gradients, post-step parameters and BN/SN state at max-abs
  <= 1e-3 of each tensor's max-abs;
* one eval step against JAX's, metrics at rtol 1e-4;
* the port's step with and without rollout recompute, equal at 1e-6.

The train step runs in float64 on both sides (``jax.enable_x64``), as the
JAX suite's own step-equivalence tests do: one D/D/G cycle amplifies f32
rounding of the train-mode BatchNorm statistics past 1e-3 of some tensors
(``chip_smoke.py`` phase 8 prints how far), which no independent f32
implementation can match; at f64 the comparison separates semantics from
rounding. A conv bias in front of a train-mode
BatchNorm has a true gradient of 0, so each tensor's max-abs is floored at
1e-6 of the largest in its group. The JAX train step is compiled once per
test run, whatever the number of xdist workers (``run_once``).
"""

import jax
import numpy as np
import optax
import pytest
import torch

from skillful_nowcasting_tpu import losses as jlosses
from skillful_nowcasting_tpu import training as jtraining
from skillful_nowcasting_tpu_torch import DGMR, losses, training
from skillful_nowcasting_tpu_torch.hub import load_variables, state_dict_from_variables
from torch_port_helpers import (
    TRAIN_KEY,
    TRAIN_LR,
    TRAIN_TINY,
    assert_trees_close,
    f64,
    jax_train_step_start,
    recovered_draws,
    run_once,
    step_draws,
    t,
    train_setup,
    tree_to_torch,
)

torch.set_num_threads(1)

TINY = TRAIN_TINY
LR = TRAIN_LR  # SGD for G, D
METRIC_RTOL = 1e-4


def port_model(variables, dtype=torch.float32):
    model = DGMR(**TINY, device="cpu")
    assert load_variables(model, variables) == 0
    return model.to(dtype)


def sgd_state(model):
    g, d = training.split_params(model)
    return training.init_train_state(
        model, (torch.optim.SGD(g.values(), lr=LR[0]), torch.optim.SGD(d.values(), lr=LR[1]))
    )


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX model, its perturbed tree before and after desaturation, and a batch."""
    return train_setup(tmp_path_factory)


@pytest.fixture(scope="module")
def steps(setup, tmp_path_factory):
    """One JAX train step and the port's (rollout recompute on and off), all float64.

    The JAX step is compiled once per test run (``run_once``; the parallel
    tests share it): the first xdist worker compiles and runs it, XLA
    compiling outside the interpreter lock while the port's steps run, and
    writes its outputs to a file that every other worker loads. The port's
    steps run on every worker.
    """
    jmodel, variables, x, y, _ = setup
    with jax.enable_x64(True):
        draws = training.StepDraws(**step_draws(
            jmodel, f64(variables), jax.random.key(TRAIN_KEY), TINY["generation_steps"]))

    def port_steps():
        got = {}
        for remat in (True, False):
            model = port_model(variables, torch.float64)
            state_t = sgd_state(model)
            step_t = training.make_train_step(
                model, logging_forward=False, return_grads=True, rollout_remat=remat)
            metrics_t = step_t(state_t, t(np.moveaxis(x, -1, 2)).double(),
                               t(np.moveaxis(y, -1, 2)).double(), draws=draws)
            got[remat] = (model, metrics_t)
        return got

    return run_once(tmp_path_factory, "test_torch_train_jax_step", jax_train_step_start(setup),
                    port_steps)


def test_train_step_metrics_match_jax(steps):
    (_, metrics), got = steps
    names = [k for k in metrics if k.startswith("train/")]
    assert len(names) == 6
    for name in names:
        np.testing.assert_allclose(
            got[True][1][name].item(), float(metrics[name]), rtol=METRIC_RTOL, err_msg=name)


def test_train_step_grads_match_jax(steps, setup):
    (_, metrics), got = steps
    spectral = setup[1]["spectral"]
    assert_trees_close(got[True][1]["g_grads"], tree_to_torch(metrics["g_grads"], spectral))
    for i in range(2):  # both D steps
        want = tree_to_torch(jax.tree.map(lambda a: a[i], metrics["d_grads"]), spectral)
        assert_trees_close({k: g[i] for k, g in got[True][1]["d_grads"].items()}, want)


def test_train_step_state_matches_jax(steps, setup):
    """Post-step parameters (G and D), BatchNorm running statistics and SN vectors."""
    (new_state, _), got = steps
    want = state_dict_from_variables(
        {"params": new_state.params, "batch_stats": new_state.batch_stats,
         "spectral": new_state.spectral})
    want = {k: v for k, v in want.items() if not k.endswith("num_batches_tracked")}
    state = got[True][0].state_dict()
    assert_trees_close({k: state[k] for k in want}, want)
    before = state_dict_from_variables(setup[1])
    for key in ("sampler.bn.running_mean", "sampler.g1.bn1.running_var",
                "discriminator.spatial_discriminator.fc.parametrizations.weight.0._v"):
        assert not torch.equal(state[key].float(), before[key]), key  # it advanced


def test_rollout_remat_matches_no_remat(steps):
    """The recompute replays the first pass's BN/SN state and writes nothing."""
    _, got = steps
    (remat_model, remat), (plain_model, plain) = got[True], got[False]
    for name in remat:
        if name.startswith("train/"):
            np.testing.assert_allclose(remat[name].item(), plain[name].item(), rtol=1e-6)
    assert_trees_close(remat["g_grads"], plain["g_grads"], tol=1e-6)
    assert_trees_close(remat_model.state_dict(), plain_model.state_dict(), tol=1e-6)


def test_eval_step_matches_jax(setup):
    jmodel, variables, x, y, _ = setup
    key = jax.random.key(11)
    n = TINY["generation_steps"]
    state = jtraining.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        spectral=variables["spectral"], g_opt_state=None, d_opt_state=None, step=0)
    want = jax.jit(jtraining.make_eval_step(jmodel))(state, x, y, key)
    # The eval step's key order (training.py:753-787): (lat, fr) x 2, n lats, n frs.
    keys = jax.random.split(key, 4 + 2 * n)
    zs, fr = recovered_draws(jmodel, variables, [keys[0], keys[2], *keys[4:4 + n]],
                             [keys[1], keys[3], *keys[4 + n:]], 6, torch.float32)
    draws = training.StepDraws(d_z=zs[:2], d_frames=fr[:2], g_z=zs[2:], g_frames=fr[2:])
    model = port_model(variables)
    state_t = training.init_train_state(model)
    got = training.make_eval_step(model)(
        state_t, t(np.moveaxis(x, -1, 2)), t(np.moveaxis(y, -1, 2)), draws=draws)
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].item(), float(value), rtol=METRIC_RTOL, err_msg=name)
    assert model.training  # the eval step restores the mode it found


def test_desaturate_discriminator_matches_jax(setup):
    _, variables, _, _, saturated = setup
    model = training.desaturate_discriminator(port_model(saturated))
    want = state_dict_from_variables(variables)
    for key, value in model.state_dict().items():
        torch.testing.assert_close(value, want[key], rtol=0, atol=0, msg=key)


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    gen, real = rng.standard_normal((4, 2, 1)), rng.standard_normal((4, 2, 1))
    pred = rng.random((2, 3, 8, 6, 1), np.float32) * 30
    target = rng.random((2, 3, 8, 6, 1), np.float32) * 30
    as_port = lambda a: t(np.moveaxis(a, -1, 2))  # noqa: E731  NTHWC -> NTCHW
    np.testing.assert_allclose(
        losses.loss_hinge_disc(t(gen), t(real)).item(),
        float(jlosses.loss_hinge_disc(gen, real)), rtol=1e-6)
    np.testing.assert_allclose(
        losses.loss_hinge_gen(t(gen)).item(), float(jlosses.loss_hinge_gen(gen)), rtol=1e-6)
    np.testing.assert_allclose(
        np.array(losses.weight_fn(t(target), 24.0)), np.array(jlosses.weight_fn(target, 24.0)))
    for weight in (None, losses.weight_fn):
        jweight = jlosses.weight_fn if weight else None
        got = losses.GridCellLoss(weight_fn=weight)(as_port(pred), as_port(target))
        want = jlosses.GridCellLoss(weight_fn=jweight)(pred, target)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


SPECS = [None, "cosine:10:0.1", "exp:4:0.5", "warmup_cosine:3:10:0.2", "linear:8:0.25"]


@pytest.mark.parametrize("spec", SPECS)
def test_lr_schedule_and_adam_match_optax(spec):
    """Each schedule spec against optax at update counts 0..12, and Adam driven by it."""
    schedule = jtraining.make_lr_schedule(2e-4, spec)
    ours = training.make_lr_schedule(2e-4, spec)
    counts = range(13)
    want = [float(schedule(c)) if callable(schedule) else schedule for c in counts]
    np.testing.assert_allclose([ours(c) for c in counts], want, rtol=1e-6, atol=1e-12)

    rng = np.random.default_rng(4)
    params = {"a": rng.standard_normal((3, 4)), "b": rng.standard_normal(5)}
    grads = [{k: rng.standard_normal(v.shape) for k, v in params.items()} for _ in range(5)]
    tx = optax.adam(schedule, b1=0.0, b2=0.999, eps=1e-8)
    jp, opt_state = dict(params), tx.init(params)
    tp = {k: torch.nn.Parameter(t(v)) for k, v in params.items()}
    opt = torch.optim.Adam(tp.values(), lr=2e-4, betas=(0.0, 0.999), eps=1e-8)
    sched = training.lr_scheduler(opt, spec)
    for g in grads:
        updates, opt_state = tx.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = t(g[k])
        opt.step()
        sched.step()
    for k in params:
        np.testing.assert_allclose(np.array(tp[k].detach()), np.array(jp[k]), rtol=1e-6, atol=1e-9)
