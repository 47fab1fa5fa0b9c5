"""The port's checkpoints, Trainer, metrics logger, profiler and CLI, on the CPU (no JAX).

* A checkpoint round trip is bit-identical: model, both optimizers, both lr
  schedulers, step and the training generator's state.
* ``latest`` keeps the newest steps, ``best`` the lowest ``train/g_loss``;
  a failed write leaves no partial file and the older steps intact.
* A ``Trainer.fit`` stopped after 2 steps and resumed to 4 (a new model, the
  stream where it stopped) equals an uninterrupted 4-step run bit for bit,
  validation (eval step and skill metrics) included.
* A non-finite checkpoint is refused on resume; ``abort_on_nan`` keeps the
  last good checkpoint; SIGTERM saves the steps completed; a train step
  stopped partway (Ctrl-C, an error) writes no checkpoint.
* ``MetricsLogger`` writes JSONL; ``hist_bucket_edges`` are the JAX
  package's; ``profiling.trace`` writes a Chrome trace; the CLI runs one
  tiny ``--synthetic`` step.
"""

import itertools
import json
import os
import signal
import sys

import numpy as np
import pytest
import torch

import skillful_nowcasting_tpu_torch
from skillful_nowcasting_tpu_torch import DGMR, checkpoint, profiling, run, training
from skillful_nowcasting_tpu_torch.data import synthetic_radar_batches
from skillful_nowcasting_tpu_torch.logging_utils import JSONL_NAME, MetricsLogger, hist_bucket_edges
from skillful_nowcasting_tpu_torch.trainer import Trainer
from skillful_nowcasting_tpu_torch.utils import random_fill

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """``torch.utils.tensorboard`` imports TensorFlow where it is installed (seconds): log without it."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)

# The smallest field the paper's towers take with one intermediate D block each.
SMALL = dict(forecast_steps=2, output_shape=32, latent_channels=256, context_channels=32,
             generation_steps=1, num_samples=2, num_spatial_layers=1, num_temporal_layers=1)
SMALL_ARGS = ["--forecast-steps", "2", "--output-shape", "32", "--latent-channels", "256",
              "--context-channels", "32", "--generation-steps", "1"]


def small_model(seed=0):
    model = random_fill(DGMR(**SMALL, device="cpu"), torch.Generator().manual_seed(seed))
    return training.desaturate_discriminator(model)


def data(seed=3, skip=0):
    it = synthetic_radar_batches(batch_size=2, target_frames=2, size=32, seed=seed)
    return itertools.islice(it, skip, None)


def trainer(model, ckpt_dir, max_steps, **kw):
    kw = {"ckpt_every": 2, "log_every": 1, "logging_forward": False, "seed": 5, **kw}
    return Trainer(model, max_steps=max_steps, ckpt_dir=str(ckpt_dir), **kw)


def stepped_state(seed):
    """A state whose optimizers and schedulers have taken one step (no model forward)."""
    model = small_model(seed)
    state = training.init_train_state(model, g_lr_schedule="cosine:10", d_lr_schedule="exp:4:0.5")
    gen = torch.Generator().manual_seed(seed)
    for opt, sched in ((state.g_opt, state.g_sched), (state.d_opt, state.d_sched)):
        for group in opt.param_groups:
            for p in group["params"]:
                p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
        sched.step()
    state.step = 7
    return state


def assert_states_equal(a, b):
    for (k, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), k
    for oa, ob in ((a.g_opt, b.g_opt), (a.d_opt, b.d_opt)):
        sa, sb = oa.state_dict(), ob.state_dict()
        assert sa["param_groups"] == sb["param_groups"]
        for i, st in sa["state"].items():
            for k, v in st.items():
                assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert a.g_sched.state_dict() == b.g_sched.state_dict()
    assert a.d_sched.state_dict() == b.d_sched.state_dict()
    assert a.step == b.step


def test_checkpoint_round_trip_is_bit_identical(tmp_path):
    state = stepped_state(0)
    gen = torch.Generator().manual_seed(9)
    torch.rand(5, generator=gen)
    manager = checkpoint.make_manager(str(tmp_path / "ckpt"))
    checkpoint.save_state(manager, 7, state, gen, {"train/g_loss": 1.5})

    other, gen2 = stepped_state(1), torch.Generator().manual_seed(0)
    assert checkpoint.restore_state(manager, other, gen2) == 7
    assert_states_equal(state, other)
    assert torch.equal(torch.rand(8, generator=gen), torch.rand(8, generator=gen2))
    assert manager.metrics(7) == {"train/g_loss": 1.5}


def test_latest_and_best_tracking(tmp_path):
    latest = checkpoint.make_manager(str(tmp_path / "latest"), max_to_keep=2)
    best = checkpoint.make_manager(str(tmp_path / "best"), max_to_keep=2, monitor="train/g_loss")
    for step, loss in ((1, 5.0), (2, 2.0), (3, 7.0)):
        for m in (latest, best):
            m.save(step, {"step": step}, {"train/g_loss": loss})
    assert latest.all_steps() == [2, 3] and latest.latest_step() == 3
    assert best.all_steps() == [1, 2] and checkpoint.best_step(best) == 2
    assert latest.restore()["step"] == 3 and latest.restore(2)["step"] == 2


def test_failed_write_leaves_no_partial_file(tmp_path, monkeypatch):
    manager = checkpoint.make_manager(str(tmp_path / "ckpt"))
    manager.save(1, {"x": torch.arange(4)})

    def dying_save(obj, path):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.torch, "save", dying_save)
    with pytest.raises(OSError, match="disk full"):
        manager.save(2, {"x": torch.arange(4)})
    assert manager.all_steps() == [1]
    assert sorted(os.listdir(tmp_path / "ckpt" / "2")) == [checkpoint.METRICS_FILE]
    assert torch.equal(manager.restore()["x"], torch.arange(4))


def test_fit_resumed_equals_uninterrupted(tmp_path):
    """Interrupted at 2 steps, resumed to 4 on a fresh model: the same bits as 4 in one go."""
    kw = {"val_every": 2, "val_skill": True}
    whole = trainer(small_model(), tmp_path / "whole", 4, **kw)
    state = whole.fit(data(), data(seed=4))

    first = trainer(small_model(), tmp_path / "split", 2, log_dir=str(tmp_path / "log"), **kw)
    assert first.fit(data(), data(seed=4)).step == 2
    # Steps 1-2 used batches 1-2; the new run draws its own batch before the loop (batch 2
    # again), so step 3 gets batch 3 as in the whole run.
    second = trainer(small_model(seed=1), tmp_path / "split", 4, log_dir=str(tmp_path / "log"),
                     **kw)
    resumed = second.fit(data(skip=2), data(seed=4, skip=1))
    assert resumed.step == 4 and second.manager.latest_step() == 4
    assert_states_equal(state, resumed)
    with open(tmp_path / "log" / JSONL_NAME) as f:
        lines = [json.loads(line) for line in f]
    assert [line["step"] for line in lines if "train/g_loss" in line] == [1, 2, 3, 4]
    val = [line for line in lines if "val/crps" in line]
    assert [line["step"] for line in val] == [2, 4]
    assert all(np.isfinite(v) for line in val for v in line.values())


def test_non_finite_checkpoint_is_refused(tmp_path):
    state = stepped_state(0)
    with torch.no_grad():
        next(state.model.parameters()).fill_(float("nan"))
    manager = checkpoint.make_manager(str(tmp_path / "run" / "latest"))
    checkpoint.save_state(manager, 5, state, torch.Generator(), {"train/g_loss": 1.0})
    t = trainer(small_model(), tmp_path / "run", 6)
    with pytest.raises(RuntimeError, match="refusing to resume"):
        t.fit(data())


def test_abort_on_nan_keeps_the_last_good_checkpoint(tmp_path):
    def poisoned():
        for i, (x, y) in enumerate(data()):
            if i >= 2:  # the init batch and step 1 are clean
                x = x.copy()
                x[0, 0, 0, 0, 0] = np.nan
            yield x, y

    t = trainer(small_model(), tmp_path / "run", 4, ckpt_every=1)
    with pytest.raises(RuntimeError, match="non-finite training metrics at step 2"):
        t.fit(poisoned())
    assert t.manager.all_steps() == [1]
    restored = training.init_train_state(small_model(seed=1))
    checkpoint.restore_state(t.manager, restored, torch.Generator())
    assert all(bool(torch.isfinite(p).all()) for p in restored.model.parameters())


def test_sigterm_saves_the_steps_completed(tmp_path):
    t = trainer(small_model(), tmp_path / "run", 10, ckpt_every=100, prefetch=0)

    def terminated():
        for i, batch in enumerate(data()):
            if i == 3:  # asked for step 3's batch: 2 steps are done
                # An uncaught SIGTERM would end this process: send it only to the Trainer.
                assert signal.getsignal(signal.SIGTERM) == t._sigterm
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    state = t.fit(terminated())
    assert state.step == 2 and t.manager.all_steps() == [2] and t.best_manager.all_steps() == [2]
    assert signal.getsignal(signal.SIGTERM) is not t._sigterm  # restored


@pytest.mark.parametrize("error", [KeyboardInterrupt, RuntimeError])
def test_a_step_stopped_partway_writes_no_checkpoint(tmp_path, monkeypatch, error):
    """Ctrl-C or an error in step 2's G phase, after both D updates: nothing is saved."""
    calls = []
    loss_hinge_gen = training.loss_hinge_gen

    def stopped(scores):
        calls.append(1)
        if len(calls) == 2:  # D has taken step 2's updates, G has not
            raise error("stopped in the G phase")
        return loss_hinge_gen(scores)

    monkeypatch.setattr(training, "loss_hinge_gen", stopped)
    t = trainer(small_model(), tmp_path / "run", 4, ckpt_every=100, prefetch=0)
    with pytest.raises(error, match="stopped in the G phase"):
        t.fit(data())
    assert t.manager.all_steps() == [] and t.best_manager.all_steps() == []
    assert signal.getsignal(signal.SIGTERM) is not t._sigterm  # restored


def test_metrics_logger_and_bucket_edges(tmp_path):
    from skillful_nowcasting_tpu.logging_utils import hist_bucket_edges as jax_edges

    np.testing.assert_array_equal(hist_bucket_edges(), jax_edges())
    logger = MetricsLogger(str(tmp_path))
    logger.log_scalars({"train/g_loss": torch.tensor(2.5), "train/d_loss": 1.0}, 3)
    logger.log_histograms({"train/hist/params/x": {"counts": np.ones(64)}}, 3)
    logger.close()
    with open(tmp_path / JSONL_NAME) as f:
        assert [json.loads(line) for line in f] == [
            {"step": 3, "train/g_loss": 2.5, "train/d_loss": 1.0}]


def test_profiling_trace_writes_a_trace(tmp_path):
    with profiling.trace(str(tmp_path), cuda=False):
        with profiling.annotate("matmul"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    with open(tmp_path / profiling.TRACE_FILE) as f:
        assert "matmul" in f.read()
    with pytest.raises(NotImplementedError):
        profiling.start_server()


def test_cli_runs_one_synthetic_step(tmp_path, capsys, monkeypatch):
    # The CLI's flags build the paper's discriminators, too deep for a 32^2 field: shrink them.
    def small_dgmr(**kw):
        return DGMR(**{**kw, "num_samples": SMALL["num_samples"],
                       "num_spatial_layers": 1, "num_temporal_layers": 1})

    monkeypatch.setattr(skillful_nowcasting_tpu_torch, "DGMR", small_dgmr)
    state = run.main(["--synthetic", "--synthetic-kind", "radar", "--device", "cpu",
                      "--batch-size", "1", "--max-steps", "1", "--log-every", "1",
                      "--ckpt-dir", str(tmp_path / "ckpt"), "--log-dir", str(tmp_path / "log"),
                      "--no-logging-forward", *SMALL_ARGS])
    assert state.step == 1
    assert checkpoint.make_manager(str(tmp_path / "ckpt" / "latest")).all_steps() == [1]
    assert "train/g_loss=" in capsys.readouterr().out
    with pytest.raises(SystemExit):  # no data source: nothing is downloaded by default
        run.parse_args(["--max-steps", "1"])
