"""Shared helpers of the PyTorch-port parity tests (``test_torch_*.py``).

Weights come from the JAX package: an abstract variable tree is filled with
``random_fill_variables`` (no init compile), then BN statistics, biases and
the attention ``gamma`` are perturbed so the BN fold, the bias paths and
quirk Q1 are exercised (``gamma`` starts at 0). The tree is carried into the
port by ``state_dict_from_variables`` and ``load_state_dict(strict=True)``.
Arrays cross between the frameworks as numpy copies.

An expensive JAX reference (a compiled train step, a model forward) is
computed once per test run and shared by every xdist worker through a file
(:func:`run_once`), so no worker compiles it again.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path

import jax
import numpy as np
import torch
from filelock import FileLock, Timeout

from skillful_nowcasting_tpu.utils import random_fill_variables
from skillful_nowcasting_tpu_torch.hub import state_dict_from_variables

# Per-block tolerances of the JAX parity suite (tests/test_blocks_parity.py).
RTOL = 2e-4
ATOL = 2e-5


def perturb(tree, seed: int):
    """Non-trivial BN stats, biases and attention gamma (numpy tree)."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, tuple):  # spectral (u, v): consistent with the kernels
            return tuple(np.array(a) for a in node)
        a = np.array(node)
        if name == "gamma":
            return np.full_like(a, 0.5)
        if name in ("bias", "scale", "mean"):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if name == "var":
            return (a * np.exp(0.2 * rng.standard_normal(a.shape))).astype(a.dtype)
        return a

    return walk(tree)


def jax_variables(module, *args, seed: int = 0, **kwargs):
    """Filled + perturbed numpy variable tree for a Flax module called on ``args``."""
    abstract = jax.eval_shape(lambda: module.init(jax.random.key(0), *args, **kwargs))
    filled = jax.tree.map(np.array, random_fill_variables(abstract, seed))
    return perturb(filled, seed + 1)


def f64(tree):
    """Every floating leaf of a numpy / JAX tree as float64 (for ``jax.enable_x64`` runs)."""
    return jax.tree.map(
        lambda a: np.asarray(a, np.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else np.asarray(a),
        tree,
    )


def load_port(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Strictly load a JAX variable tree into a port module and set eval mode."""
    module.load_state_dict(state_dict_from_variables(variables), strict=True)
    return module.eval()


def t(a) -> torch.Tensor:
    """numpy / JAX array -> torch tensor (copied, never aliased)."""
    return torch.from_numpy(np.array(a))


def nhwc_to_nchw(a) -> torch.Tensor:
    return t(np.moveaxis(np.array(a), -1, -3))


def nchw_to_nhwc(x: torch.Tensor) -> np.ndarray:
    return np.moveaxis(np.array(x.detach()), -3, -1)


def randn(rng, *shape, scale: float = 1.0) -> np.ndarray:
    return (rng.standard_normal(shape) * scale).astype(np.float32)



def _shared_dir(tmp_path_factory) -> Path:
    """The directory every xdist worker of this run shares (the base temp dir without xdist)."""
    base = tmp_path_factory.getbasetemp()
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


def _save_tree(path: Path, tree) -> None:
    leaves, treedef = jax.tree.flatten(tree)
    spec = np.frombuffer(pickle.dumps(treedef), np.uint8)
    tmp = path.with_name(path.name + ".tmp.npz")
    np.savez(tmp, *[np.asarray(leaf) for leaf in leaves], treedef=spec)
    os.replace(tmp, path)


def _load_tree(path: Path):
    with np.load(path) as f:
        treedef = pickle.loads(f["treedef"].tobytes())  # written by _save_tree in this run
        leaves = [f[f"arr_{i}"] for i in range(len(f.files) - 1)]
    return jax.tree.unflatten(treedef, leaves)


def run_once(tmp_path_factory, name: str, start, meanwhile=lambda: None):
    """A JAX reference computed once per test run: ``(reference, meanwhile())``.

    ``start()`` begins the reference (e.g. a compile on a thread) and returns
    ``finish()``, which returns it as a tree of arrays. The first worker to
    take the file lock starts it, runs ``meanwhile()`` (the port's own half,
    per worker) while it computes, finishes it and writes it as ``.npz`` in
    the directory all xdist workers share; any other worker runs
    ``meanwhile()`` first, then waits on the lock and loads the file. Every
    worker gets the loaded copy, so all compare against the same arrays.
    """
    path = _shared_dir(tmp_path_factory) / f"{name}.npz"
    lock = FileLock(str(path) + ".lock")
    try:
        lock.acquire(timeout=0)
    except Timeout:
        other = meanwhile()
        with lock:
            return _load_tree(path), other
    try:
        if path.exists():
            other = meanwhile()
        else:
            finish = start()
            other = meanwhile()
            _save_tree(path, finish())
        return _load_tree(path), other
    finally:
        lock.release()


def jax_latents(jmodel, variables, keys) -> np.ndarray:
    """The latent a JAX DGMR forward draws under ``rngs={"latent": k}``, per key: NCHW ``(n, 8C, h, w)``.

    The JAX latent stack's first ``make_rng("latent")`` (``models/common.py:298-300``).
    """

    def latent(mdl):
        c, h, w = mdl.latent_stack.shape
        return jax.random.normal(mdl.latent_stack.make_rng("latent"), (1, h, w, c), np.float32)

    zs = [np.array(jmodel.apply(variables, method=latent, rngs={"latent": k})) for k in keys]
    return np.moveaxis(np.concatenate(zs), -1, 1)


# The train-step parity config shared by test_torch_train.py and test_torch_parallel.py.
TRAIN_TINY = dict(forecast_steps=2, output_shape=64, latent_channels=256, context_channels=32,
                  generation_steps=2, num_spatial_layers=2, num_temporal_layers=2)
TRAIN_LR = (5e-5, 2e-4)  # SGD for G, D
TRAIN_KEY = 7  # the JAX train step's key


def train_setup(tmp_path_factory):
    """The JAX model, its perturbed tree after and before desaturation, and a B=2 batch (NTHWC).

    The arrays (an abstract init and a fill of every leaf, several seconds)
    are made once per test run (``run_once``); each worker builds the module.
    """
    from skillful_nowcasting_tpu import DGMR as JaxDGMR
    from skillful_nowcasting_tpu import training as jtraining
    from skillful_nowcasting_tpu.hub.pretrained import abstract_variables

    jmodel = JaxDGMR(**TRAIN_TINY)

    def start():
        filled = jax.tree.map(np.array, random_fill_variables(abstract_variables(jmodel), 0))
        saturated = perturb(filled, 1)
        variables = dict(saturated, params=jax.tree.map(
            np.array, jtraining.desaturate_discriminator(saturated["params"])))
        rng = np.random.default_rng(2)
        x = rng.random((2, 4, 64, 64, 1), np.float32)
        y = rng.random((2, 2, 64, 64, 1), np.float32)
        return lambda: (variables, x, y, saturated)

    (variables, x, y, saturated), _ = run_once(tmp_path_factory, "train_setup", start)
    return jmodel, variables, x, y, saturated


def recovered_draws(jmodel, variables, keys_z, keys_frames, seq_len, dtype):
    """The latents and frame indices the JAX step draws from these keys, as port tensors."""
    import jax.numpy as jnp

    def latent(mdl):
        c, h, w = mdl.latent_stack.shape
        return jax.random.normal(mdl.latent_stack.make_rng("latent"), (1, h, w, c), jnp.float32)

    def frames(mdl):
        key = mdl.discriminator.spatial_discriminator.make_rng("frames")
        return jax.random.randint(key, (8,), 0, seq_len)

    def apply(method, stream, key):
        return np.array(jmodel.apply(variables, method=method, rngs={stream: key}))

    zs = [t(np.moveaxis(apply(latent, "latent", k), -1, 1)).to(dtype) for k in keys_z]
    fr = [t(apply(frames, "frames", k)).long() for k in keys_frames]
    return zs, fr


def step_draws(jmodel, variables, key, n_gen: int, dtype=torch.float64) -> dict:
    """The draws of the JAX train step (``logging_forward=False``) under ``key``, as ``StepDraws`` fields.

    The step's key order (``training.py:450-455``): d_lat, d_fr, g_lat, g_fr, log.
    Call under the same ``jax.enable_x64`` setting as the step.
    """
    keys = jax.random.split(key, 2 * 2 + 2 * n_gen + 1)
    zs, fr = recovered_draws(jmodel, variables, [*keys[:2], *keys[4:4 + n_gen]],
                             [*keys[2:4], *keys[4 + n_gen:4 + 2 * n_gen]], 6, dtype)
    return dict(d_z=zs[:2], d_frames=fr[:2], g_z=zs[2:], g_frames=fr[2:])


def sgd_train_state(jmodel, v64):
    """A float64 JAX TrainState of ``v64`` with the SGD pair, and that pair."""
    import jax.numpy as jnp
    import optax

    from skillful_nowcasting_tpu import training as jtraining

    sgd = (optax.sgd(TRAIN_LR[0]), optax.sgd(TRAIN_LR[1]))
    g0, d0 = jtraining.split_params(v64["params"])
    state = jtraining.TrainState(
        params=v64["params"], batch_stats=v64["batch_stats"], spectral=v64["spectral"],
        g_opt_state=sgd[0].init(g0), d_opt_state=sgd[1].init(d0),
        step=jnp.zeros((), jnp.int32),
    )
    return state, sgd


def compile_in_background(fn, *args, post=lambda out: jax.tree.map(np.array, out)):
    """Lower ``fn`` (jitted) here under x64 and compile it on a thread; returns ``finish()``.

    ``finish()`` runs the program and returns ``post`` of its outputs (a numpy
    tree by default). XLA compiles outside the interpreter lock, so the
    caller's own work runs meanwhile.
    """
    import threading

    with jax.enable_x64(True):
        lowered, compiled = fn.lower(*args), []
    compiling = threading.Thread(target=lambda: compiled.append(lowered.compile()))
    compiling.start()

    def finish():
        compiling.join()
        with jax.enable_x64(True):
            return post(compiled[0](*args))

    return finish


# Train-step trees compare per tensor: max|got - want| <= TREE_TOL * max(max|want|, FLOOR *
# the group's largest |want|). A conv bias in front of a train-mode BatchNorm has a true
# gradient of 0, hence the floor.
TREE_TOL = 1e-3
FLOOR = 1e-6


def tree_to_torch(tree, spectral):
    """A params-shaped JAX tree (gradients or parameters) under the port's parameter names."""
    sd = state_dict_from_variables({"params": tree, "spectral": spectral})
    return {k: v for k, v in sd.items() if not k.endswith(("._u", "._v"))}


def trees_worst(got, want) -> tuple:
    """The worst ``(max|got - want| / max(max|want|, FLOOR * the group's largest |want|), name)``."""
    assert set(got) == set(want)
    group = max(float(np.abs(np.array(w)).max()) for w in want.values() if np.size(w))
    worst = (0.0, "")
    for k, w in want.items():
        w = np.array(w, np.float64)
        if not np.size(w) or not np.issubdtype(w.dtype, np.floating):
            continue
        got_k = got[k].detach() if isinstance(got[k], torch.Tensor) else got[k]
        err = np.abs(np.array(got_k, np.float64) - w).max()
        worst = max(worst, (err / max(np.abs(w).max(), FLOOR * group), k))
    return worst


def assert_trees_close(got, want, tol=TREE_TOL):
    """max|got - want| <= tol * max(max|want|, FLOOR * the group's largest |want|), per tensor."""
    worst = trees_worst(got, want)
    assert worst[0] <= tol, worst


def jax_train_step_start(setup, **extras):
    """``start`` of the JAX B=2 float64 SGD train step (``run_once(..., "test_torch_train_jax_step")``).

    Its result is ``(new_state, metrics)`` with ``return_grads``. ``extras``
    go to ``make_train_step`` (:func:`jax_r1_step_start`).
    """
    import jax.numpy as jnp

    from skillful_nowcasting_tpu import training as jtraining

    jmodel, variables, x, y, _ = setup

    def start():
        with jax.enable_x64(True):
            state, sgd = sgd_train_state(jmodel, f64(variables))
            step = jax.jit(jtraining.make_train_step(
                jmodel, logging_forward=False, return_grads=True, optimizers=sgd,
                compute_dtype=jnp.float64, **extras))
        return compile_in_background(step, state, x.astype(np.float64), y.astype(np.float64),
                                     jax.random.key(TRAIN_KEY))

    return start


R1_GAMMA = 10.0


def jax_r1_step_start(setup):
    """``start`` of that step with ``r1_gamma=10`` and both watch flags
    (``run_once(..., "test_torch_train_extras_jax_r1_step")``)."""
    return jax_train_step_start(setup, r1_gamma=R1_GAMMA, watch_gradients=True,
                                watch_histograms=True)


# Histogram parity (watch_histograms): the bins two correct implementations may disagree on.
HIST_RTOL = 1e-4
EDGE_Y = 2e-5  # symlog units: about 10 f32 ulps at |y| = 28
NOISE = 1e-12  # of a group's max-abs: float64 noise of an exactly-zero gradient


def ambiguous_elements(values) -> int:
    """Elements whose bin two correct implementations may disagree on, in one tensor group.

    * Within ``EDGE_Y`` of a bin edge in the symlog domain: XLA's and
      torch's f32 ``log`` / ``log1p`` differ in the last bit for up to a few
      percent of arguments (measured here), which moves such an element to
      the neighbouring bin.
    * Below ``NOISE`` of the group's largest magnitude: a gradient that is
      0 in exact arithmetic (a conv bias in front of a train-mode BatchNorm)
      is float64 rounding noise whose sign and size differ between the two
      implementations (an exact 0 stays 0), and the bins resolve magnitudes
      down to 1e-12.
    """
    v = np.concatenate([np.ravel(a).astype(np.float32).astype(np.float64) for a in values])
    y = np.arcsinh(v / 1e-12) / np.log(10.0)
    edge = np.abs((y + 28.0) / (56.0 / 64) - np.round((y + 28.0) / (56.0 / 64))) * (56.0 / 64)
    top = max(np.abs(a).max() for a in values)
    mag = np.concatenate([np.abs(np.ravel(a)) for a in values])
    noise = (mag > 0) & (mag < NOISE * top)
    return int(np.sum((edge < EDGE_Y) | noise))


def assert_histograms_match(got, want, new_state, spectral, model) -> tuple:
    """The port's ``train/hist`` against the JAX step's: counts equal but for ambiguous elements.

    ``got`` / ``want`` are the two steps' ``train/hist``, ``new_state`` the
    JAX step's state after it, ``model`` a port model of the same config
    (for the layer paths). Per histogram, the counts' L1 distance is at most
    twice the number of :func:`ambiguous_elements` of the JAX step's own
    tensors of that group (so a group without any has the same counts), and
    over all histograms at most 1e-4 of the elements; min / max / sum / sum
    of squares at rtol 1e-4. Returns ``(moved, elements)``.
    """
    from skillful_nowcasting_tpu_torch import training

    tensors = {
        "train/hist/params/": (tree_to_torch(new_state.params, spectral), 2, 0),
        "train/hist/grads/": (tree_to_torch(want["g_grads"], spectral), 2, 0),
        "train/hist/grads/discriminator/": (
            tree_to_torch(jax.tree.map(lambda a: a[-1], want["d_grads"]), spectral), 1, 1),
    }
    want = want["train/hist"]
    assert set(got) == set(want)
    total = sum(p.numel() for p in model.parameters())
    for group in ("train/hist/params/", "train/hist/grads/"):
        assert sum(int(np.asarray(h["counts"]).sum()) for k, h in got.items()
                   if k.startswith(group)) == total
    n_moved = n_all = 0
    for prefix, (values, depth, skip) in tensors.items():
        for key, names in training._layer_groups(model, values, depth, skip).items():
            w, g = want[prefix + key], got[prefix + key]
            assert np.asarray(g["counts"]).dtype == np.int32
            loose = ambiguous_elements([np.array(values[n]) for n in names])
            moved = int(np.abs(np.asarray(g["counts"]).astype(np.int64) - w["counts"]).sum())
            assert moved <= 2 * loose, (key, moved, loose)
            n_moved, n_all = n_moved + moved, n_all + int(w["counts"].sum())
            for stat in ("min", "max", "sum", "sumsq"):
                np.testing.assert_allclose(float(g[stat]), float(w[stat]), rtol=HIST_RTOL,
                                           atol=1e-30, err_msg=f"{key} {stat}")
    assert n_all == 2 * total and n_moved <= 1e-4 * n_all, (n_moved, n_all)
    return n_moved, n_all
