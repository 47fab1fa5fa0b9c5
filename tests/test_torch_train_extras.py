"""The rest of the port's train step vs the JAX package's, on the CPU: R1, gradient watch, bf16.

* ONE JAX train step in float64 with ``r1_gamma=10``, ``watch_gradients`` and
  ``watch_histograms`` (SGD, no logging forward, ``return_grads``), compiled
  once per test run (``run_once``), against the port's on the same weights
  (``test_torch_train``'s desaturated tree) and the JAX step's own draws:
  every loss and ``train/d_r1`` at rtol 1e-4; both D steps' gradients, the G
  gradients, the post-step parameters and BN/SN state at max-abs <= 1e-3 of
  each tensor; every ``train/grad_norm/*`` key equal and its value within
  1e-6; every histogram key equal, its counts equal but for the few elements
  that two correct implementations may bin apart
  (``torch_port_helpers.ambiguous_elements``),
  and its min / max / sum / sum of squares at rtol 1e-4.
* The R1 forward puts the discriminator's buffers back as it found them.
* ``compute_dtype=torch.bfloat16`` on the same weights and draws (Adam): the
  carried state stays f32, the metrics are f32 and finite, the parameters
  move, the grid loss is within rtol 0.1 of the JAX step's (the JAX suite's
  bar, ``tests/test_training.py:226-233``), and bf16 + R1 is finite with
  ``d_r1`` within rtol 0.25 of the port's f32 R1 (``test_training.py:463-465``).
* The bf16 eval step launches no kernel on the CPU and is within rtol 0.1 of
  the f32 eval step.

The JAX step's grid loss is that of the plain step too: R1 and the watch
flags touch only D and the metrics, and the G phase's forwards do not read D.
"""

import jax
import numpy as np
import pytest
import torch

from skillful_nowcasting_tpu_torch import training
from skillful_nowcasting_tpu_torch.hub import state_dict_from_variables
from skillful_nowcasting_tpu_torch.ops import convgru_rollout, gblock_fused
from test_torch_train import (  # noqa: F401  (setup is a fixture)
    METRIC_RTOL,
    TINY,
    assert_trees_close,
    port_model,
    recovered_draws,
    setup,
    sgd_state,
    tree_to_torch,
)
from torch_port_helpers import (
    R1_GAMMA,
    assert_histograms_match,
    f64,
    jax_r1_step_start,
    run_once,
    t,
)

torch.set_num_threads(1)

NORM_RTOL = 1e-6
BF16_GRID_RTOL = 0.1
BF16_R1_RTOL = 0.25


def batches(setup, dtype):
    _, _, x, y, _ = setup
    return t(np.moveaxis(x, -1, 2)).to(dtype), t(np.moveaxis(y, -1, 2)).to(dtype)


def step_draws(setup, dtype):
    """The draws of the JAX step under key 7 (``training.py:450-455``), as port tensors."""
    jmodel, variables, _, _, _ = setup
    n = TINY["generation_steps"]
    with jax.enable_x64(True):
        keys = jax.random.split(jax.random.key(7), 2 * 2 + 2 * n + 1)
        zs, fr = recovered_draws(jmodel, f64(variables), [*keys[:2], *keys[4:4 + n]],
                                 [*keys[2:4], *keys[4 + n:4 + 2 * n]], 6, dtype)
    return training.StepDraws(d_z=zs[:2], d_frames=fr[:2], g_z=zs[2:], g_frames=fr[2:])


@pytest.fixture(scope="module")
def r1_steps(setup, tmp_path_factory):
    """The JAX float64 R1 + watch step (once per run) and the port's, on the same draws."""
    _, variables, _, _, _ = setup
    draws = step_draws(setup, torch.float64)

    def port_step():
        model = port_model(variables, torch.float64)
        step = training.make_train_step(
            model, logging_forward=False, return_grads=True, r1_gamma=R1_GAMMA,
            watch_gradients=True, watch_histograms=True)
        return model, step(sgd_state(model), *batches(setup, torch.float64), draws=draws)

    return run_once(tmp_path_factory, "test_torch_train_extras_jax_r1_step",
                    jax_r1_step_start(setup), port_step)


def test_r1_step_metrics_match_jax(r1_steps):
    (_, want), (_, got) = r1_steps
    scalars = [k for k in want if k.startswith("train/") and k != "train/hist"]
    assert set(scalars) == {k for k in got if k.startswith("train/") and k != "train/hist"}
    norms = [k for k in scalars if k.startswith("train/grad_norm/")]
    assert len(norms) > 20 and "train/d_r1" in scalars
    assert float(want["train/d_r1"]) > 0
    for name in scalars:
        rtol = NORM_RTOL if name in norms else METRIC_RTOL
        np.testing.assert_allclose(got[name].item(), float(want[name]), rtol=rtol, err_msg=name)


def test_r1_step_grads_match_jax(r1_steps, setup):
    (_, want), (_, got) = r1_steps
    spectral = setup[1]["spectral"]
    assert_trees_close(got["g_grads"], tree_to_torch(want["g_grads"], spectral))
    for i in range(2):  # both D steps, each with its penalty
        want_i = tree_to_torch(jax.tree.map(lambda a: a[i], want["d_grads"]), spectral)
        assert_trees_close({k: g[i] for k, g in got["d_grads"].items()}, want_i)


def test_r1_step_state_matches_jax(r1_steps):
    """Post-step parameters, BN statistics and SN vectors: the penalty forward kept nothing."""
    (new_state, _), (model, _) = r1_steps
    want = state_dict_from_variables(
        {"params": new_state.params, "batch_stats": new_state.batch_stats,
         "spectral": new_state.spectral})
    want = {k: v for k, v in want.items() if not k.endswith("num_batches_tracked")}
    state = model.state_dict()
    assert_trees_close({k: state[k] for k in want}, want)


def test_histograms_match_jax(r1_steps, setup):
    """Counts equal but for the elements two correct implementations may bin apart
    (``torch_port_helpers.assert_histograms_match``)."""
    (new_state, want), (model, got) = r1_steps
    assert_histograms_match(got["train/hist"], want, new_state, setup[1]["spectral"], model)


def test_r1_penalty_puts_the_discriminator_state_back(setup):
    model = port_model(setup[1], torch.float64).train()
    x, y = batches(setup, torch.float64)
    real = torch.cat([x, y], dim=1)
    before = {k: b.clone() for k, b in model.discriminator.named_buffers()}
    frames = torch.arange(8) % real.shape[1]
    r1 = training._r1_penalty(model, real, torch.cat([x, y.flip(0)], dim=1), frames, 2)
    for k, b in model.discriminator.named_buffers():
        assert torch.equal(b, before[k]), k
    grads = torch.autograd.grad(r1, list(model.discriminator.parameters()), allow_unused=True)
    assert r1.item() > 0 and any(g is not None and g.abs().sum() > 0 for g in grads)


@pytest.fixture(scope="module")
def bf16_steps(setup):
    """bf16, bf16 + R1 and f32 + R1 steps of the port (Adam), from the same weights and draws."""
    draws = step_draws(setup, torch.float32)
    out = {}
    for name, kw in (("bf16", {"compute_dtype": torch.bfloat16}),
                     ("bf16_r1", {"compute_dtype": torch.bfloat16, "r1_gamma": R1_GAMMA}),
                     ("f32_r1", {"r1_gamma": R1_GAMMA})):
        model = port_model(setup[1])
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        state = training.init_train_state(model)
        metrics = training.make_train_step(model, logging_forward=False, **kw)(
            state, *batches(setup, torch.float32), draws=draws)
        out[name] = (model, state, before, metrics)
    return out


def test_bf16_step_keeps_f32_state(bf16_steps, r1_steps):
    (_, want), _ = r1_steps
    model, state, before, metrics = bf16_steps["bf16"]
    for k, v in metrics.items():
        assert v.dtype == torch.float32 and torch.isfinite(v), k
    for k, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad is None, k
    for k, b in model.named_buffers():
        assert b.dtype == (torch.int64 if k.endswith("num_batches_tracked") else torch.float32), k
    moments = [v for opt in (state.g_opt, state.d_opt) for s in opt.state.values()
               for v in s.values() if v.ndim]
    assert moments and all(v.dtype == torch.float32 for v in moments)
    assert any(not torch.equal(p, before[k]) for k, p in model.named_parameters())
    np.testing.assert_allclose(metrics["train/grid_loss"].item(), float(want["train/grid_loss"]),
                               rtol=BF16_GRID_RTOL)


def test_bf16_r1_step_is_finite(bf16_steps):
    model, _, _, metrics = bf16_steps["bf16_r1"]
    for k, v in metrics.items():
        assert torch.isfinite(v), k
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
    r1_bf16, r1_f32 = metrics["train/d_r1"].item(), bf16_steps["f32_r1"][3]["train/d_r1"].item()
    assert r1_bf16 > 0
    np.testing.assert_allclose(r1_bf16, r1_f32, rtol=BF16_R1_RTOL)


def test_bf16_eval_step_matches_f32(setup):
    model = port_model(setup[1])
    state = training.init_train_state(model)
    x, y = batches(setup, torch.float32)
    draws = step_draws(setup, torch.float32)
    counters = [(fn, attr) for fn in (convgru_rollout, gblock_fused)
                for attr in ("launches", "launches_bf16")]
    launches = [getattr(fn, attr) for fn, attr in counters]
    f32 = training.make_eval_step(model)(state, x, y, draws=draws)
    bf16 = training.make_eval_step(model, compute_dtype=torch.bfloat16)(state, x, y, draws=draws)
    assert [getattr(fn, attr) for fn, attr in counters] == launches  # the plain versions ran
    assert set(bf16) == set(f32)
    for name, value in f32.items():
        assert bf16[name].dtype == torch.float32, name
        np.testing.assert_allclose(bf16[name].item(), value.item(), rtol=BF16_GRID_RTOL,
                                   err_msg=name)


