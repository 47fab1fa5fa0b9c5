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
