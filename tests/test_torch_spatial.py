"""The port's spatially sharded generator forward on the CPU: four ``gloo`` ranks against JAX and the port.

One launch of four rank processes per test run
(``tests/test_torch_spatial_worker.py``, torch and the port only, one thread
each) runs every scenario; ``run_once`` shares their results with every
xdist worker. The reference is JAX's own ``make_spatial_forward`` (GSPMD
partitions the forward and inserts the halos) of the dry-run DGMR on a
``(data=2, space=2)`` mesh, on the input of ``tests/test_parallel.py``'s
spatial test, computed on a thread while the ranks run. The port's
``make_spatial_forward`` on meshes ``(data=2, space=2)`` and
``(data=1, space=4)``, its stripes gathered, is held:

* against JAX at rtol / atol 1e-4 (the tiny generator's bar), with the
  latent JAX draws from its key (``jax_latents``). At ``space=4`` the
  rollout's windows at the 16-row level, and the GBlock's at the 4-row
  level, take rows from more than one neighbour;
* against the port's dense forward of the same rows on each rank, to 1e-6
  of its largest value, with the fixed latent and with a seeded generator.

``halo_window`` on 4-row stripes equals the slice of the dense field it
stands for, clipped edges included; each rank's forward made the halo calls
its layout implies and returned a stripe of ``H / n_space`` rows. In
float64 a ConvGRU of 4 steps (its windows of 9 rows reach three ranks) and
a GBlock on the four ranks' stripes equal the dense layers to 1e-12: the
tiny forward's 2 steps and float32 bar would not see a rollout window a few
rows short, whose error fades as it spreads.
"""

import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import DRYRUN_CONFIG
from skillful_nowcasting_tpu import DGMR as JaxDGMR
from skillful_nowcasting_tpu.hub.pretrained import abstract_variables
from skillful_nowcasting_tpu.parallel import make_mesh as jax_make_mesh
from skillful_nowcasting_tpu.parallel import make_spatial_forward as jax_spatial_forward
from skillful_nowcasting_tpu.utils import random_fill_variables
from skillful_nowcasting_tpu_torch.hub import state_dict_from_variables
from torch_port_helpers import _shared_dir, jax_latents, perturb, run_once, t

torch.set_num_threads(1)

WORKER = Path(__file__).with_name("test_torch_spatial_worker.py")
RANKS = 4
TIMEOUT = 300  # seconds for the four ranks together (they take about 10 s)
MESHES = {"data2_space2": (2, 2), "data1_space4": (1, 4)}
JAX_TOL = 1e-4
DENSE_TOL = 1e-6  # of max|dense|
LAYER_TOL = 1e-12  # float64, of max|dense|
WINDOW_ROWS = (1, 2, 5, 9)
KEY = 7
H = 128
# Halo calls of one forward of a DGMR on any mesh with space > 1. halo_window: the 4 GBlocks'
# kernel windows, the 4 rollouts' h0 windows and the 3 rollouts' input windows (the first
# rollout's input, the latent, is whole on every rank). halo_exchange: every SAME 3x3 conv,
# 2 in each of the context stack's 4 DBlocks, its 4 mixing convs, 2 in each of the 4
# UpsampleGBlocks.
WINDOW_CALLS = 4 + 4 + 3
EXCHANGE_CALLS = 4 * 2 + 4 + 4 * 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def setup():
    """The JAX dry-run DGMR, its filled and perturbed tree, the NTHWC input and the latent key."""
    jmodel = JaxDGMR(**DRYRUN_CONFIG)
    filled = jax.tree.map(np.array, random_fill_variables(abstract_variables(jmodel), 0))
    x = np.random.default_rng(3).random((2, 4, H, H, 1), np.float32)
    return jmodel, perturb(filled, 1), x, jax.random.key(KEY)


def _jax_reference(setup):
    """``finish()`` of JAX's ``make_spatial_forward`` on a (data=2, space=2) mesh, run on a thread."""
    jmodel, variables, x, key = setup
    fwd = jax_spatial_forward(jmodel, jax_make_mesh(n_data=2, n_space=2))
    out = []
    running = threading.Thread(target=lambda: out.append(np.array(fwd(variables, x, key))))
    running.start()

    def finish():
        running.join()
        return out[0]

    return finish


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """Every rank's results, and JAX's nowcast (``"jax"``)."""
    jmodel, variables, x, key = setup

    def start():
        out = _shared_dir(tmp_path_factory) / "test_torch_spatial_ranks"
        out.mkdir(exist_ok=True)
        inputs = out / "inputs.pt"
        field = np.random.default_rng(5).standard_normal((2, 3, 4 * RANKS, 5))
        torch.save(dict(config=DRYRUN_CONFIG, state_dict=state_dict_from_variables(variables),
                        x=t(np.moveaxis(x, -1, 2)), z=t(jax_latents(jmodel, variables, [key])),
                        field=t(field)), inputs)
        port, procs = _free_port(), []
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        for r in range(RANKS):
            log = open(out / f"rank{r}.log", "w")
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), "--rank", str(r), "--world", str(RANKS),
                 "--port", str(port), "--inputs", str(inputs), "--out", str(out)],
                stdout=log, stderr=subprocess.STDOUT, env=env))
        jax_forward = _jax_reference(setup)

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
            got = jax.tree.map(lambda v: v.numpy() if isinstance(v, torch.Tensor) else v, got)
            return {"ranks": got, "jax": jax_forward()}

        return finish

    return run_once(tmp_path_factory, "test_torch_spatial_ranks", start)[0]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_spatial_forward_matches_jax(ranks, mesh):
    got = np.moveaxis(ranks["ranks"][0][mesh]["whole"], 2, -1)  # NTCHW -> NTHWC
    want = ranks["jax"]
    assert got.shape == want.shape == (2, DRYRUN_CONFIG["forecast_steps"], H, H, 1)
    np.testing.assert_allclose(got, want, rtol=JAX_TOL, atol=JAX_TOL)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_spatial_forward_matches_the_dense_forward(ranks, mesh):
    """Each rank's gathered rows against the port's dense forward of them: fixed latent and seeded."""
    for r in ranks["ranks"]:
        assert float(r[mesh]["vs_dense"]) <= DENSE_TOL
        assert float(r[mesh]["seeded_vs_dense"]) <= DENSE_TOL


@pytest.mark.parametrize("layer", ["gru_seq", "gru_static", "gblock"])
def test_windowed_layers_match_the_dense_layers_in_float64(ranks, layer):
    for r in ranks["ranks"]:
        assert float(r["layers"][layer]) <= LAYER_TOL


@pytest.mark.parametrize("rows", WINDOW_ROWS)
def test_halo_window_is_the_dense_slice(ranks, rows):
    """Rows within ``rows`` of each 4-row stripe, clipped to the 16-row field; 9 reaches 3 ranks."""
    for r in ranks["ranks"]:
        w = r["window"][rows]
        assert bool(w["equal"])
        assert (int(w["top"]), int(w["bottom"])) == tuple(int(v) for v in w["want"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_spatial_forward_is_sharded(ranks, mesh):
    n_data, n_space = MESHES[mesh]
    for r in ranks["ranks"]:
        got = r[mesh]
        assert tuple(got["shape"]) == (2 // n_data, DRYRUN_CONFIG["forecast_steps"], 1,
                                       H // n_space, H)
        assert int(got["window_calls"]) == WINDOW_CALLS
        assert int(got["exchange_calls"]) == EXCHANGE_CALLS
        assert int(got["window_bytes"]) > 0 and int(got["exchange_bytes"]) > 0
