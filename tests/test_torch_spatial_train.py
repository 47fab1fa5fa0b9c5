"""The port's H-sharded train and eval steps on the CPU: ``gloo`` ranks against JAX and the port.

One launch per test run of four rank processes
(``tests/test_torch_spatial_train_worker.py``, torch and the port only, one
thread each): a ``(data=2, space=2)`` mesh with B=1 a rank, then two
``(data=1, space=2)`` meshes of two ranks with B=2 a rank. ``run_once``
shares their results with every xdist worker. The references are JAX's: GSPMD's spatial
step computes the single-device step on the global batch
(``tests/test_parallel.py:373-455``), so the port's
``make_dp_train_step(mode="pjit", spatial_axis="space")`` is held, in
float64 at ``TRAIN_TINY`` with the draws recovered from the JAX step's key,
against the JAX B=2 SGD step (``"test_torch_train_jax_step"``) and its R1 and
watch variant (``"test_torch_train_extras_jax_r1_step"``), both shared with
the other port tests, compiled on threads while the ranks run: metrics at
rtol 1e-4; gradients, post-step parameters and BN/SN buffers at 1e-3 of each
tensor, the worst printed (float64 lands near 1e-9; a wrong adjoint lands
near 1e-1); the per-layer norms and histograms as
``tests/test_torch_train_extras.py`` holds them. Every rank's state is
bit-identical after each step. At 64^2 on two space ranks both
discriminator towers reach a level of one row a stripe: the spatial one
sums its last level over the stripes, the temporal one gathers its last
pooled level whole.

The ``pjit`` + space eval step is held against JAX's eval step at JAX's own
rtol of 2e-4 (``tests/test_parallel.py:340-370``; one small float32 compile),
with no kernel launched on the CPU. The ranks' results are shared without the
train steps' trees, which stay in rank 0's file; one worker compares them with
JAX (``against_jax``) and shares the summary, so the tests that need the ranks
only never wait on the JAX train-step compiles. The layers are held against the dense
ones in float64 to 1e-12, a ``Trainer`` on the space mesh against one on a
mesh of one, and the draw-sharing rule with differently advanced global
RNGs. The refusals need no processes.

Under xdist the three JAX references (train, R1 + watch, eval) compile on
one worker that waits for the ranks, while they run (``_references_meanwhile``);
the worker that runs the ranks does nothing else, so the workers that wait
on the ranks alone are free as soon as the ranks are.
"""

import os
import socket
import subprocess
import sys
import threading
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from filelock import FileLock, Timeout

from skillful_nowcasting_tpu import training as jtraining
from skillful_nowcasting_tpu_torch import DGMR, parallel, training
from skillful_nowcasting_tpu_torch.hub import state_dict_from_variables
from skillful_nowcasting_tpu_torch.parallel.mesh import Mesh
from skillful_nowcasting_tpu_torch.trainer import Trainer
from torch_port_helpers import (
    TRAIN_TINY,
    TREE_TOL,
    _shared_dir,
    assert_histograms_match,
    f64,
    jax_r1_step_start,
    jax_train_step_start,
    recovered_draws,
    run_once,
    step_draws,
    t,
    train_setup,
    tree_to_torch,
    trees_worst,
)

torch.set_num_threads(1)

WORKER = Path(__file__).with_name("test_torch_spatial_train_worker.py")
RANKS = 4
MESHES = {"pair": (0, 1), "quad": (0, 1, 2, 3)}  # (data=1, space=2), (data=2, space=2): ranks
TIMEOUT = 600  # seconds for the ranks (about 35 s alone, 115 s in the full suite)
TRAIN_KEY = 7  # the JAX train steps' key (torch_port_helpers.jax_train_step_start)
EVAL_KEY = 11
METRIC_RTOL = 1e-4
NORM_RTOL = 1e-6
EVAL_RTOL = 2e-4
LAYER_TOL = 1e-12
DENSE_TOL = 1e-9  # float64 port against port: a seeded step's metrics
STATE_TOL = 1e-6  # and the state after it, of each tensor (the rounding noise of one D/D/G cycle)
TRAINER_RTOL = 1e-6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _eval_draws(jmodel, variables):
    """The JAX eval step's draws under ``EVAL_KEY`` (``training.py:753-787``: (lat, fr) x 2, lats, frs)."""
    n = TRAIN_TINY["generation_steps"]
    keys = jax.random.split(jax.random.key(EVAL_KEY), 4 + 2 * n)
    zs, fr = recovered_draws(jmodel, variables, [keys[0], keys[2], *keys[4:4 + n]],
                             [keys[1], keys[3], *keys[4 + n:]], 6, torch.float32)
    return dict(d_z=zs[:2], d_frames=fr[:2], g_z=zs[2:], g_frames=fr[2:])


def _inputs(setup) -> dict:
    jmodel, variables, x, y, _ = setup
    with jax.enable_x64(True):
        train = step_draws(jmodel, f64(variables), jax.random.key(TRAIN_KEY),
                           TRAIN_TINY["generation_steps"])
    model = DGMR(**TRAIN_TINY, device="cpu")
    model.load_state_dict(state_dict_from_variables(variables), strict=True)
    return dict(config=TRAIN_TINY, state_dict=model.state_dict(),
                x=t(np.moveaxis(x, -1, 2)), y=t(np.moveaxis(y, -1, 2)),
                draws={"train": train, "eval": _eval_draws(jmodel, variables)})


def _jax_eval_start(setup):
    """``start`` of JAX's float32 eval step on the B=2 batch under ``EVAL_KEY``, compiled on a thread.

    Without ``enable_x64``, as its draws were recovered (the frames' integer type follows it).
    """
    jmodel, variables, x, y, _ = setup

    def start():
        state = jtraining.TrainState(
            params=variables["params"], batch_stats=variables["batch_stats"],
            spectral=variables["spectral"], g_opt_state=None, d_opt_state=None, step=0)
        args = (state, x, y, jax.random.key(EVAL_KEY))
        lowered, compiled = jax.jit(jtraining.make_eval_step(jmodel)).lower(*args), []
        compiling = threading.Thread(target=lambda: compiled.append(lowered.compile()))
        compiling.start()

        def finish():
            compiling.join()
            return jax.tree.map(np.array, compiled[0](*args))

        return finish

    return start


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return train_setup(tmp_path_factory)


def _step_against_jax(got, reference, spectral) -> dict:
    """One sharded step's trees against the JAX step's: each scalar's relative error, the worst
    tensor of each group (``trees_worst``) and, with histograms, what their check raised."""
    new_state, want = reference
    scalars = {k for k in want if k.startswith("train/") and k != "train/hist"}
    out = {"names": sorted(got["metrics"]) == sorted(scalars), "n_scalars": len(scalars),
           "scalars": {k: abs(float(got["metrics"][k]) - float(want[k])) / abs(float(want[k]))
                       for k in scalars}}
    out["g_grads"] = trees_worst(got["g_grads"], tree_to_torch(want["g_grads"], spectral))
    for i in range(2):
        want_i = tree_to_torch(jax.tree.map(lambda a: a[i], want["d_grads"]), spectral)
        out[f"d_grads[{i}]"] = trees_worst({k: g[i] for k, g in got["d_grads"].items()}, want_i)
    want_state = state_dict_from_variables({"params": new_state.params,
                                            "batch_stats": new_state.batch_stats,
                                            "spectral": new_state.spectral})
    want_state = {k: v for k, v in want_state.items() if not k.endswith("num_batches_tracked")}
    out["state"] = trees_worst({k: got["state"][k] for k in want_state}, want_state)
    if got["hist"] is not None:
        try:
            out["hist"] = assert_histograms_match(got["hist"], want, new_state, spectral,
                                                  DGMR(**TRAIN_TINY, device="cpu"))
        except AssertionError as e:
            out["hist"] = f"failed: {e}"
    return out


TREES = ("metrics", "hist", "g_grads", "d_grads", "state")  # of a step, kept in rank0.pt


def _ranks_dir(tmp_path_factory) -> Path:
    return _shared_dir(tmp_path_factory) / "test_torch_spatial_train_ranks"


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """Each rank's results but the train steps' trees, which stay in rank 0's file (``against_jax``)."""

    def start():
        out = _ranks_dir(tmp_path_factory)
        out.mkdir(exist_ok=True)
        inputs = out / "inputs.pt"
        torch.save(_inputs(setup), inputs)
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        port, procs = _free_port(), []
        for r in range(RANKS):
            log = open(out / f"rank{r}.log", "w")
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), "--rank", str(r), "--port", str(port),
                 "--inputs", str(inputs), "--out", str(out)],
                stdout=log, stderr=subprocess.STDOUT, env=env))

        def finish():
            try:
                codes = [p.wait(timeout=TIMEOUT) for p in procs]
            finally:
                for p in procs:
                    p.kill()
            if any(codes):
                logs = "\n".join((out / f"rank{r}.log").read_text()[-3000:] for r in range(RANKS))
                raise RuntimeError(f"rank exit codes {codes}:\n{logs}")
            got = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]
            for mesh in MESHES:
                for step in ("train", "train_r1"):
                    for tree in TREES:
                        got[0][mesh][step].pop(tree, None)
            return jax.tree.map(lambda v: v.numpy() if isinstance(v, torch.Tensor) else v, got)

        return finish

    holder = []  # start() runs on the worker that runs the ranks; it does nothing else meanwhile

    def meanwhile():
        if not holder:
            _references_meanwhile(setup, tmp_path_factory)

    return run_once(tmp_path_factory, "test_torch_spatial_train_ranks",
                    lambda: holder.append(True) or start(), meanwhile)[0]


def _jax_references(setup, tmp_path_factory) -> dict:
    """The JAX train step, its R1 + watch variant (both shared with the other port tests) and the
    eval step, computed once per test run, all three compiling at once on threads."""
    refs = {}

    def eval_step():
        refs["eval"] = run_once(tmp_path_factory, "test_torch_spatial_train_jax_eval",
                                _jax_eval_start(setup))[0]

    def r1_step():
        refs["r1"] = run_once(tmp_path_factory, "test_torch_train_extras_jax_r1_step",
                              jax_r1_step_start(setup), eval_step)[0]

    refs["plain"] = run_once(tmp_path_factory, "test_torch_train_jax_step",
                             jax_train_step_start(setup), r1_step)[0]
    return refs


def _references_meanwhile(setup, tmp_path_factory) -> None:
    """While the ranks run: the JAX references, on the first worker to ask; the others go on."""
    lock = FileLock(str(_shared_dir(tmp_path_factory) / "test_torch_train_jax_step.npz") + ".lock")
    try:
        lock.acquire(timeout=0)
    except Timeout:
        return
    lock.release()
    _jax_references(setup, tmp_path_factory)


@pytest.fixture(scope="module")
def against_jax(ranks, setup, tmp_path_factory):
    """``{mesh: {step: _step_against_jax(...)}}``, computed once per test run from rank 0's trees and
    the two JAX train steps (``_jax_references``)."""

    def start():
        refs = _jax_references(setup, tmp_path_factory)
        trees = torch.load(_ranks_dir(tmp_path_factory) / "rank0.pt", weights_only=False)
        trees = jax.tree.map(lambda v: v.numpy() if isinstance(v, torch.Tensor) else v, trees)

        def finish():
            return {mesh: {step: _step_against_jax(trees[mesh][step], refs[ref],
                                                   setup[1]["spectral"])
                           for step, ref in (("train", "plain"), ("train_r1", "r1"))}
                    for mesh in MESHES}

        return finish

    return run_once(tmp_path_factory, "test_torch_spatial_train_against_jax", start)[0]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_train_steps_leave_every_rank_bit_identical(ranks, mesh):
    for r in MESHES[mesh]:
        got = ranks[r][mesh]
        assert bool(got["train"]["equal"]) and bool(got["train_r1"]["equal"])
        # Every SAME conv exchanged halos forward and backward.
        assert int(got["train"]["forward_exchanges"]) > 0
        assert int(got["train"]["backward_exchanges"]) > 0


def test_sharded_eval_step_matches_jax(ranks, setup, tmp_path_factory):
    want = run_once(tmp_path_factory, "test_torch_spatial_train_jax_eval",
                    _jax_eval_start(setup))[0]  # mostly computed while the ranks ran
    for r in ranks:
        got = r["quad"]["eval"]["metrics"]
        assert set(got) == set(want)
        for name, value in want.items():
            np.testing.assert_allclose(float(got[name]), float(value), rtol=EVAL_RTOL,
                                       err_msg=name)
        assert int(r["quad"]["eval"]["launches"]) == 0  # the plain versions run on the CPU


@pytest.mark.parametrize("check", ["conv2d", "conv3d", "gather", "train_forward"])
def test_sharded_layers_match_the_dense_layers_in_float64(ranks, check):
    for r in ranks[2:]:
        assert float(r["pair_b"]["layers"][check]) <= LAYER_TOL, r["pair_b"]["layers"][check]


def test_halo_and_gather_pass_gradcheck_and_gradgradcheck(ranks):
    for r in ranks[2:]:
        got = r["pair_b"]["layers"]
        assert bool(got["gradcheck"]) and bool(got["gradgradcheck"])
        assert tuple(int(c) for c in got["counts"]) == (1, 1)  # forward, backward


def test_every_rank_must_share_the_draws(ranks):
    """Differently advanced global RNGs: no draws raise; an equally seeded generator agrees."""
    for r in ranks[2:]:
        d = r["pair_b"]["draws"]
        for call in ("forward", "space_train_step", "space_eval_step", "data_train_step"):
            assert "same generator" in str(d[call]), (call, str(d[call]))
        assert float(d["forward_vs_dense"]) <= LAYER_TOL
        assert float(d["step_vs_dense"]) <= DENSE_TOL
        assert float(d["step_state_vs_dense"]) <= STATE_TOL


def test_sharded_trainer_logs_the_one_rank_trainer(ranks):
    """Two steps with validation and the skill metrics: every logged number, 1e-6 relative."""
    got = ranks[2]["pair_b"]["trainer"]["lines"]
    want = ranks[0]["one"]["trainer"]["lines"]
    assert [int(g["step"]) for g in got] == [int(w["step"]) for w in want] == [1, 2, 2]
    assert any(k.startswith("val/csi") for k in want[-1])
    for g, w in zip(got, want):
        keys = set(w) - {"step", "train/steps_per_sec"}
        assert set(g) - {"step", "train/steps_per_sec"} == keys
        for k in keys:
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=TRAINER_RTOL, err_msg=k)


STEPS = [(mesh, r1) for mesh in MESHES for r1 in (False, True)]


@pytest.mark.parametrize("mesh,r1", STEPS, ids=[f"{m}-{'r1' if r else 'plain'}" for m, r in STEPS])
def test_sharded_train_step_matches_jax(against_jax, mesh, r1):
    """Rank 0's metrics, both D steps' and the G gradients and the state after the step."""
    got = against_jax[mesh]["train_r1" if r1 else "train"]
    assert bool(got["names"]) and (int(got["n_scalars"]) > 20 if r1
                                   else int(got["n_scalars"]) == 6)
    for name, rel in got["scalars"].items():
        assert float(rel) <= (NORM_RTOL if name.startswith("train/grad_norm/") else METRIC_RTOL), \
            (name, float(rel))
    worst = {"metrics": max((float(v), k) for k, v in got["scalars"].items())}
    for group in ("g_grads", "d_grads[0]", "d_grads[1]", "state"):
        ratio, name = got[group]
        worst[group] = (float(ratio), str(name))
        assert float(ratio) <= TREE_TOL, (group, float(ratio), str(name))
    if r1:
        assert not str(got["hist"]).startswith("failed"), str(got["hist"])
        worst["hist moved"] = tuple(int(v) for v in got["hist"])
    print(f"{mesh} {'r1' if r1 else 'plain'}: worst of JAX {worst}")


def test_refusals_and_the_mesh_of_one():
    """Without processes: JAX's layout errors and warning, an H that cannot shard, no stale refusal."""
    model = DGMR(**TRAIN_TINY, device="cpu")
    two = Mesh({"data": 1, "space": 2}, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="needs the GSPMD partitioner"):
        parallel.make_dp_train_step(model, two, mode="shard_map", spatial_axis="space")
    with pytest.raises(ValueError, match="pjit"):
        Trainer(model, mesh=two, dp_mode="shard_map", spatial_axis="space")
    one = parallel.make_mesh(device="cpu")
    with pytest.warns(UserWarning, match="no effect on a 1-device"):
        step = parallel.make_dp_train_step(model, one, mode="pjit", spatial_axis="space")
    assert step.__qualname__ == "make_train_step.<locals>.train_step"
    with pytest.warns(UserWarning, match="no effect on a 1-device"):
        parallel.make_dp_eval_step(model, one, mode="pjit", spatial_axis="space")
    # This rank's stripe of a 96-row field: 48 rows, and 96 does not divide by 32 x 2.
    x = torch.rand((1, 4, 1, 48, 64))
    y = torch.rand((1, 2, 1, 48, 64))
    state = training.init_train_state(model)
    for make in (parallel.make_dp_train_step, parallel.make_dp_eval_step):
        with pytest.raises(ValueError, match="must divide by 32 x 2"):
            make(model, two, mode="pjit", spatial_axis="space")(
                state, x, y, torch.Generator().manual_seed(0))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        parallel.make_dp_train_step(model, two, mode="pjit", spatial_axis="space")
    package = Path(__file__).resolve().parents[1] / "skillful_nowcasting_tpu_torch"
    for path in package.rglob("*.py"):
        text = path.read_text()
        assert "SPATIAL_NOT_PORTED" not in text and "SPATIAL_TRAIN_NOT_PORTED" not in text, path
        assert "Queue 1 item 6" not in text, path
