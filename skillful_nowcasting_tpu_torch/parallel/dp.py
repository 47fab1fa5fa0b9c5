"""The data-parallel GAN step over a mesh's ``data`` axis, in both of JAX's modes (port of ``parallel/dp.py``).

Every rank is a process that runs the step on its own rows of the batch
(:func:`~.mesh.shard_batch` cuts them from a global batch); the
collectives are explicit ``torch.distributed`` calls inside the step
(:func:`~..training.make_train_step`'s ``group``).

``mode="shard_map"`` (default): torch-DDP semantics. Each rank draws its own
latents and frames and normalizes with its own BatchNorm statistics; the
gradients are averaged after every backward pass and the floating BN/SN
buffers at the step's end, so the ranks stay equal.

``mode="pjit"``: global-batch semantics, the single-card step on the global
batch. Every rank uses the same draws, train-mode BatchNorm is synchronised
over the ranks, and with equal local batches the averaged gradient is the
global batch's.

``spatial_axis="space"`` (``pjit`` only, as in JAX) shards the batches' H
axis over the mesh's ``space`` axis too: each rank runs the global-batch
step on its stripe of its rows (:func:`~.mesh.shard_batch` with
``spatial_axis="space"`` cuts both), every conv exchanges its halos forward
and backward, the generator's BatchNorms synchronise over the whole mesh and
the gradients average over it (:mod:`.spatial`). JAX lets GSPMD partition
the same step.
"""

from __future__ import annotations

import functools
import warnings
from typing import Optional

import torch

from ..inference import make_generate
from ..training import make_eval_step, make_train_step
from .mesh import Mesh, shard_batch
from .spatial import check_field_rows, space_layout


def _validate_layout(mesh: Mesh, mode: str, spatial_axis: Optional[str]) -> None:
    """The mode and spatial checks, whatever the mesh's size (the JAX package's errors)."""
    if mode not in ("shard_map", "pjit"):
        raise ValueError(f"unknown DP mode: {mode}")
    if spatial_axis is not None and mode != "pjit":
        raise ValueError(
            "spatial_axis needs the GSPMD partitioner (mode='pjit'); the "
            "shard_map DP mode maps batch shards to per-device programs "
            "with no cross-shard conv halos"
        )
    if spatial_axis not in (None, "space"):
        raise ValueError(f"the mesh's spatial axis is 'space', got {spatial_axis!r}")
    if spatial_axis is not None and mesh.size == 1:
        warnings.warn(
            f"spatial_axis={spatial_axis!r} has no effect on a 1-device "
            "mesh: the plain step runs unsharded",
            stacklevel=3,
        )


def _layout(mesh: Mesh, spatial_axis: Optional[str]):
    """``(group, space, wrap)`` of a step on ``mesh``: the group it spans, its layout, and
    ``wrap``, which refuses a stripe that cannot shard."""
    if mesh.shape["space"] == 1 or spatial_axis is None:  # the space ranks compute alike
        return mesh.data_group, None, lambda step: step
    n_space = mesh.shape["space"]

    def wrap(step):
        @functools.wraps(step)
        def sharded(state, images, future_images, *args, **kwargs):
            check_field_rows(torch.as_tensor(images).shape[-2] * n_space, n_space)
            return step(state, images, future_images, *args, **kwargs)

        return sharded

    return mesh.group, space_layout(mesh), wrap


def make_dp_train_step(
    model,
    mesh: Mesh,
    *,
    logging_forward: bool = True,
    donate_state: bool = True,
    mode: str = "shard_map",
    watch_gradients: bool = False,
    watch_histograms: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    return_grads: bool = False,
    rollout_remat: bool = True,
    optimizers=None,
    spatial_axis: Optional[str] = None,
    r1_gamma: float = 0.0,
):
    """The GAN train step over ``mesh``: ``step(state, images, future_images, generator=None, draws=None)``.

    ``images`` / ``future_images`` are this rank's rows of the global batch
    (with ``spatial_axis="space"``, its stripe of them, whose field's H must
    divide by ``32 * n_space``: ``ValueError`` otherwise); ``generator`` is
    the same on every rank (the shard_map mode derives each rank's draws
    from it, :func:`~..training.rank_generator`; the pjit mode needs it or
    ``draws``). A mesh of one returns the plain step, with a warning where
    ``spatial_axis`` is set. The keyword arguments are the JAX package's:
    ``donate_state`` has nothing to do here (the step updates the state in
    place), and the optimizers belong to the state
    (:func:`~..training.init_train_state`), so ``optimizers`` raises.
    """
    del donate_state
    _validate_layout(mesh, mode, spatial_axis)
    if optimizers is not None:
        raise TypeError("the port's optimizers live in the TrainState: pass them to "
                        "training.init_train_state")
    mesh.check_device(next(model.parameters()).device)
    kw = dict(logging_forward=logging_forward, watch_gradients=watch_gradients,
              watch_histograms=watch_histograms, compute_dtype=compute_dtype,
              return_grads=return_grads, rollout_remat=rollout_remat, r1_gamma=r1_gamma)
    if mesh.size == 1:
        return make_train_step(model, **kw)
    group, space, wrap = _layout(mesh, spatial_axis)
    return wrap(make_train_step(model, group=group, global_batch=mode == "pjit", space=space,
                                batch_group=mesh.data_group, **kw))


def make_dp_eval_step(
    model,
    mesh: Mesh,
    *,
    mode: str = "shard_map",
    compute_dtype: Optional[torch.dtype] = None,
    spatial_axis: Optional[str] = None,
):
    """The validation step over ``mesh``: per-rank draws (``pjit``: shared), metrics averaged.

    The batches as in :func:`make_dp_train_step`; with ``spatial_axis`` the
    generator's kernels run on windows of each stripe.
    """
    _validate_layout(mesh, mode, spatial_axis)
    mesh.check_device(next(model.parameters()).device)
    if mesh.size == 1:
        return make_eval_step(model, compute_dtype=compute_dtype)
    group, space, wrap = _layout(mesh, spatial_axis)
    return wrap(make_eval_step(model, compute_dtype=compute_dtype, group=group,
                               global_batch=mode == "pjit", space=space))


def make_dp_generate(model, mesh: Mesh, *, num_samples: Optional[int] = None):
    """Ensemble nowcasts over ``mesh``: ``generate(x, generator) -> (S, B / n, T, C, H, W)``.

    ``x`` is the global batch and every rank passes the same ``generator``:
    each rank nowcasts its contiguous rows of the batch with the same
    per-sample latents (:func:`~..inference.make_generate`), so the ranks'
    outputs in rank order are the single-rank ensemble. Inference has no
    cross-rank math, so nothing is communicated. The ranks of a ``space``
    axis compute the same rows (the H-sharded forward is
    :func:`~.spatial.make_spatial_forward`).
    """
    mesh.check_device(next(model.parameters()).device)
    generate = make_generate(model, num_samples=num_samples)

    def dp_generate(x, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return generate(shard_batch(x, mesh), generator)

    return dp_generate
