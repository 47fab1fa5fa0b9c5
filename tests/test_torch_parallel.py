"""The port's data parallelism (``parallel/``) on the CPU: two ``gloo`` ranks against JAX and the port.

One launch of two rank processes per test run
(``tests/test_torch_parallel_worker.py``, torch and the port only, one
thread each) runs every scenario; ``run_once`` shares their results with
every xdist worker. Held against the JAX package, in float64 with SGD:

* ``mode="shard_map"`` on 2 ranks x B=1 against JAX's vmap-with-``axis_name``
  execution of ``make_train_step(axis_name="data")`` (as
  ``tests/test_parallel.py`` holds JAX's own shard_map step), each rank with
  the draws JAX derives from ``fold_in(key, r)``: metrics at rtol 1e-4;
  gradients, post-step parameters and the averaged BN/SN buffers at 1e-3 of
  each tensor (``torch_port_helpers.assert_trees_close``). This is the
  file's one JAX compile;
* ``mode="pjit"`` on 2 ranks x B=1 against the single-device B=2 step that
  ``tests/test_torch_train.py`` compiles (shared through ``run_once``);
* ``halo_conv2d`` on 2 ranks against JAX's dense SAME conv, to 1e-6.

Held against the port itself: both tilers on a mesh bit-identical to one
rank's run with the same forwards; ``make_dp_generate`` against
``make_generate``; the DP eval step's metrics the mean of the ranks' plain
eval steps; a 2-rank ``Trainer.fit`` (replicas equal after every step,
checkpoints and logs from rank 0 only, every rank's generator state in the
checkpoint, both ranks resuming it). The mesh and layout errors need no
processes.
"""

import copy
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skillful_nowcasting_tpu import training as jtraining
from skillful_nowcasting_tpu_torch import DGMR, parallel, training
from skillful_nowcasting_tpu_torch.hub import state_dict_from_variables
from skillful_nowcasting_tpu_torch.inference import smooth_test_field
from skillful_nowcasting_tpu_torch.parallel import dp
from skillful_nowcasting_tpu_torch.parallel.mesh import Mesh
from torch_port_helpers import (
    TRAIN_TINY,
    _load_tree,
    _save_tree,
    _shared_dir,
    assert_trees_close,
    compile_in_background,
    f64,
    jax_train_step_start,
    run_once,
    sgd_train_state,
    step_draws,
    t,
    train_setup,
    tree_to_torch,
)

torch.set_num_threads(1)

WORKER = Path(__file__).with_name("test_torch_parallel_worker.py")
RANKS = 2
TIMEOUT = 600  # seconds for the two ranks together (they take about 30 s)
SHARD_KEY = 11  # the shard_map step's key; rank r draws from fold_in(key, r)
METRIC_RTOL = 1e-4
HALO_TOL = 1e-6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs(setup) -> dict:
    """The ranks' inputs: the tiny model's weights, a B=2 batch, every scenario's draws and fields."""
    jmodel, variables, x, y, _ = setup
    n = TRAIN_TINY["generation_steps"]
    with jax.enable_x64(True):
        v64 = f64(variables)
        key = jax.random.key(SHARD_KEY)
        shard = [step_draws(jmodel, v64, jax.random.fold_in(key, r), n) for r in range(RANKS)]
        pjit = step_draws(jmodel, v64, jax.random.key(7), n)
    model = DGMR(**TRAIN_TINY, device="cpu")
    model.load_state_dict(state_dict_from_variables(variables), strict=True)
    gen = torch.Generator().manual_seed(3)
    evals = []
    for _ in range(RANKS):
        d = training.draw_step(model, 6, gen, logging_forward=False)
        evals.append(dict(d_z=d.d_z, d_frames=d.d_frames, g_z=d.g_z, g_frames=d.g_frames))
    halo = {k: (t(x_), t(w)) for k, (x_, w) in _halo_inputs().items()}
    return dict(
        config=TRAIN_TINY, state_dict=model.state_dict(),
        x=t(np.moveaxis(x, -1, 2)), y=t(np.moveaxis(y, -1, 2)),
        draws={"shard_map": shard, "pjit": pjit, "eval": evals},
        field=torch.from_numpy(smooth_test_field(4, 150, 150, 1, seed=6)),
        z=torch.randn((1, 8, 2, 2), generator=gen), halo=halo,
    )


def _shard_map_reference(setup):
    """``start`` of JAX's vmap-with-axis_name execution of the shard_map step (2 replicas x B=1)."""
    jmodel, variables, x, y, _ = setup
    with jax.enable_x64(True):
        state, sgd = sgd_train_state(jmodel, f64(variables))
        per_replica = jtraining.make_train_step(
            jmodel, logging_forward=False, axis_name="data", return_grads=True, optimizers=sgd,
            compute_dtype=jnp.float64)
        step = jax.jit(jax.vmap(per_replica, in_axes=(None, 0, 0, None), out_axes=0,
                                axis_name="data"))
    xs = x.astype(np.float64).reshape(RANKS, 1, *x.shape[1:])
    ys = y.astype(np.float64).reshape(RANKS, 1, *y.shape[1:])
    def replica_0(a):  # as float32: the comparison is at 1e-3 of each tensor
        a = np.asarray(a[0])
        return a.astype(np.float32) if np.issubdtype(a.dtype, np.floating) else a

    return compile_in_background(step, state, xs, ys, jax.random.key(SHARD_KEY),
                                 post=lambda out: jax.tree.map(replica_0, out))


def _as_numpy(tree):
    return jax.tree.map(lambda v: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v),
                        tree)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return train_setup(tmp_path_factory)


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """Every scenario's results but the train steps' trees, which go to their own file (``trees``)."""
    shared = _shared_dir(tmp_path_factory)

    def start():
        out = shared / "test_torch_parallel_ranks"
        out.mkdir(exist_ok=True)
        inputs = out / "inputs.pt"
        torch.save(_inputs(setup), inputs)
        port, procs = _free_port(), []
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        for r in range(RANKS):
            log = open(out / f"rank{r}.log", "w")
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), "--rank", str(r), "--world", str(RANKS),
                 "--port", str(port), "--inputs", str(inputs), "--out", str(out)],
                stdout=log, stderr=subprocess.STDOUT, env=env))
        jax_shard_map = _shard_map_reference(setup)

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
            trees = {mode: {k: got[0][mode].pop(k) for k in ("metrics", "g_grads", "d_grads",
                                                            "state")}
                     for mode in ("shard_map", "pjit")}
            trees["jax_shard_map"] = jax_shard_map()
            _save_tree(shared / "test_torch_parallel_trees.npz", _as_numpy(trees))
            return _as_numpy(got)

        return finish

    return run_once(tmp_path_factory, "test_torch_parallel_ranks", start)[0]


@pytest.fixture(scope="module")
def trees(ranks, tmp_path_factory):
    """Both modes' metrics, gradients and post-step state from rank 0, and JAX's shard_map step."""
    return _load_tree(_shared_dir(tmp_path_factory) / "test_torch_parallel_trees.npz")


def _assert_step_matches(port, metrics, new_state, spectral):
    """A port step's rank-0 trees against a JAX step's (metrics, grads of both D steps, state)."""
    for name, value in port["metrics"].items():
        np.testing.assert_allclose(float(value), float(metrics[name]), rtol=METRIC_RTOL,
                                   err_msg=name)
    assert len(port["metrics"]) == 6
    assert_trees_close(port["g_grads"], tree_to_torch(metrics["g_grads"], spectral))
    for i in range(2):
        want = tree_to_torch(jax.tree.map(lambda a: a[i], metrics["d_grads"]), spectral)
        assert_trees_close({k: g[i] for k, g in port["d_grads"].items()}, want)
    want = state_dict_from_variables({"params": new_state.params,
                                      "batch_stats": new_state.batch_stats,
                                      "spectral": new_state.spectral})
    want = {k: v for k, v in want.items() if not k.endswith("num_batches_tracked")}
    assert_trees_close({k: port["state"][k] for k in want}, want)


def test_shard_map_step_matches_jax_vmap_reference(trees, ranks, setup):
    """DDP semantics: per-rank draws and BN statistics, averaged gradients, buffers averaged at the end."""
    new_state, metrics = trees["jax_shard_map"]
    _assert_step_matches(trees["shard_map"], metrics, new_state, setup[1]["spectral"])
    assert all(bool(r["shard_map"]["equal"]) for r in ranks)  # replicas bit-identical


def test_pjit_step_matches_jax_global_batch_step(trees, ranks, setup, tmp_path_factory):
    """Global-batch semantics: 2 ranks x B=1 with shared draws and synchronised BN = the B=2 step."""
    (new_state, metrics), _ = run_once(tmp_path_factory, "test_torch_train_jax_step",
                                       jax_train_step_start(setup))
    _assert_step_matches(trees["pjit"], metrics, new_state, setup[1]["spectral"])
    assert all(bool(r["pjit"]["equal"]) for r in ranks)


def _halo_inputs() -> dict:
    """Float64 NCHW fields (B=2, C=3, H=16, W=12) and OIHW kernels, 3x3 and 5x5."""
    rng = np.random.default_rng(4)
    return {f"k{k}": (rng.standard_normal((2, 3, 16, 12)), rng.standard_normal((5, 3, k, k)))
            for k in (3, 5)}


@pytest.mark.parametrize("kernel", ["k3", "k5"])
def test_halo_conv2d_matches_dense_jax_conv(ranks, kernel):
    x, w = _halo_inputs()[kernel]
    with jax.enable_x64(True):
        want = jax.lax.conv_general_dilated(
            np.moveaxis(x, 1, -1), np.transpose(w, (2, 3, 1, 0)), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = np.moveaxis(ranks[0]["halo"][kernel], 1, -1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=HALO_TOL)
    np.testing.assert_array_equal(ranks[1]["halo"][kernel], ranks[0]["halo"][kernel])


def test_sharded_tilers_are_bit_identical_to_one_rank(ranks):
    """Each tiler on 2 ranks gives one rank's field (the same forwards); only rank 0 returns it."""
    got = ranks[0]["tilers"]
    assert got["device"].shape == (2, 1, 150, 150) and np.isfinite(got["device"]).all()
    np.testing.assert_array_equal(got["device"], got["device_one"])
    np.testing.assert_array_equal(got["host"], got["host_one"])
    assert list(got["returned"]) == [True, True]
    assert list(ranks[1]["tilers"]["returned"]) == [False, False]


def test_dp_generate_matches_make_generate(ranks):
    for r in ranks:
        assert bool(r["generate"]["own_rows"])  # each rank's share = make_generate of its rows
    got = ranks[0]["generate"]
    assert got["dp"].shape == got["whole"].shape == (2, 2, 2, 1, 64, 64)
    np.testing.assert_allclose(got["dp"], got["whole"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("draws", ["explicit", "seeded"])
def test_dp_eval_metrics_are_the_mean_of_the_ranks(ranks, draws):
    """Explicit per-rank draws, or each rank's from ``rank_generator`` of one shared generator."""
    for r in ranks:
        e = r["eval"]
        np.testing.assert_allclose(e[draws], e[f"{draws}_ranks"].mean(axis=0), rtol=1e-6)
        np.testing.assert_array_equal(e[draws], ranks[0]["eval"][draws])
    per_rank = ranks[0]["eval"][f"{draws}_ranks"]
    assert not np.array_equal(per_rank[0], per_rank[1])  # the ranks saw other data and draws


def test_pjit_eval_metrics_are_the_global_batch_step(ranks):
    """Shared draws on 2 ranks x B=1: the plain eval step's metrics on the B=2 batch."""
    for r in ranks:
        np.testing.assert_allclose(r["eval"]["pjit"], r["eval"]["whole"], rtol=1e-5)


def test_trainer_on_two_ranks(ranks):
    """Replicas equal after every step; rank 0 writes; both ranks restore their generator state."""
    r0, r1 = ranks[0]["trainer"], ranks[1]["trainer"]
    for r in (r0, r1):
        assert list(r["equal_after_each_step"]) == [True] * 3
        assert int(r["rank_generators"]) == 2 and bool(r["generator_restored"])
        assert list(r["resumed_from"]) == [2] and int(r["final_step"]) == 3
    assert list(r0["saves"]) == [1, 1, 2, 2, 3, 3]  # latest/ and best/ at each step
    assert len(r1["saves"]) == 0 and str(r1["quiet_logger"]) == "_Quiet"
    assert int(r0["log_lines"]) == 4  # steps 1, 2 and 3 and the validation at step 2
    assert "log/metrics.jsonl" in list(r0["files"])


def test_mesh_and_layout_errors(monkeypatch):
    """Without processes: the mesh's checks and the JAX package's layout errors."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert parallel.init_distributed() == 1 and not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        parallel.make_mesh(n_data=2, device="cpu")
    one = parallel.make_mesh(device="cpu")
    assert one.shape == {"data": 1, "space": 1} and one.size == 1 and one.group is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            parallel.make_mesh()
    with pytest.raises(ValueError, match="unknown DP mode"):
        dp._validate_layout(one, "nope", None)
    with pytest.raises(ValueError, match="needs the GSPMD partitioner"):
        dp._validate_layout(one, "shard_map", "space")
    with pytest.warns(UserWarning, match="no effect on a 1-device mesh"):  # JAX's warning
        dp._validate_layout(one, "pjit", "space")
    # The spatially sharded forward: a mesh of one is the dense forward; H must divide by
    # 32 x n_space and every rank must pass z or a generator (both checked before anything is
    # sent); a space axis left unused raises.
    model = DGMR(**TRAIN_TINY, device="cpu").eval()
    x = torch.rand((1, 4, 1, 64, 64), generator=torch.Generator().manual_seed(1))
    z = torch.randn((1, 8, 2, 2), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        torch.testing.assert_close(parallel.make_spatial_forward(model, one)(x, z=z),
                                   model(x, z=z), rtol=0, atol=0)
        two = Mesh({"data": 1, "space": 2}, 0, torch.device("cpu"))
        with pytest.raises(ValueError, match="must divide by 32 x 2"):
            parallel.make_spatial_forward(model, two)(x[..., :32, :], z=z)
        with pytest.raises(ValueError, match="same generator"):
            parallel.make_spatial_forward(model, two)(x)
    with pytest.raises(ValueError, match="spatial_axis=None"):
        parallel.make_spatial_forward(model, two, spatial_axis=None)
    with pytest.raises(ValueError, match="axes are 'data' and 'space'"):
        parallel.make_spatial_forward(model, two, batch_axis=None)
    # Train mode on a mesh of one: the dense train forward (BatchNorm on the batch, state advanced).
    dense = copy.deepcopy(model).train()
    torch.testing.assert_close(parallel.make_spatial_forward(model.train(), one)(x, z=z),
                               dense(x, z=z), rtol=0, atol=0)
    torch.testing.assert_close(model.state_dict(), dense.state_dict(), rtol=0, atol=0)
    # Rank 1 of a 2-rank data axis: its rows of a global batch; a CUDA mesh refuses a CPU model.
    second = Mesh({"data": 2, "space": 1}, 1, torch.device("cpu"))
    batch = torch.arange(8.0).reshape(4, 2)
    np.testing.assert_array_equal(parallel.shard_batch((batch,), second)[0], batch[2:])
    with pytest.raises(ValueError, match="does not divide"):
        parallel.shard_batch(batch[:3], second)
    with pytest.raises(ValueError, match="cannot run on a mesh"):
        Mesh({"data": 2, "space": 1}, 0, torch.device("cuda", 0)).check_device("cpu")


def test_mesh_of_one_is_the_plain_step():
    model = DGMR(**TRAIN_TINY, device="cpu")
    one = parallel.make_mesh(device="cpu")
    step = parallel.make_dp_train_step(model, one, mode="pjit")
    assert step.__qualname__ == "make_train_step.<locals>.train_step"
    with pytest.raises(TypeError, match="init_train_state"):
        parallel.make_dp_train_step(model, one, optimizers=(None, None))


def test_cli_splits_the_global_batch_over_ranks():
    """``--batch-size`` is the global batch: each rank takes its share, seeded apart."""
    from skillful_nowcasting_tpu_torch import run

    args = run.parse_args(["--synthetic", "--synthetic-kind", "radar", "--batch-size", "4",
                           "--forecast-steps", "2", "--output-shape", "32"])
    firsts = [next(run.data_iterators(args, "cpu", rank=r, ranks=2)[0]) for r in range(2)]
    assert [x.shape[0] for x, _ in firsts] == [2, 2]
    assert not np.array_equal(firsts[0][0], firsts[1][0])
    with pytest.raises(ValueError, match="does not divide over 3 ranks"):
        run.data_iterators(args, "cpu", rank=0, ranks=3)


def test_checkpoint_of_another_world_size_is_refused(tmp_path):
    from skillful_nowcasting_tpu_torch import checkpoint

    state = training.init_train_state(DGMR(**TRAIN_TINY, device="cpu"))
    state.step = 1
    manager = checkpoint.make_manager(str(tmp_path))
    gens = [torch.Generator().manual_seed(r) for r in range(2)]
    checkpoint.save_state(manager, 1, state, gens[0],
                          rank_generators=[g.get_state() for g in gens])
    restored = torch.Generator()
    assert checkpoint.restore_state(manager, state, restored, rank=1, world=2) == 1
    assert torch.equal(restored.get_state(), gens[1].get_state())
    with pytest.raises(ValueError, match="holds the generators of 2 ranks; this run has 1"):
        checkpoint.restore_state(manager, state, torch.Generator())
