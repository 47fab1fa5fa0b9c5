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

Not ported: ``spatial_axis`` in the steps (JAX shards the batches' H axis
too and lets GSPMD partition the whole step); it raises
``NotImplementedError``. The H-sharded generator forward is ported:
:func:`~.spatial.make_spatial_forward`.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..inference import make_generate
from ..training import make_eval_step, make_train_step
from .mesh import Mesh, shard_batch

SPATIAL_NOT_PORTED = (
    "spatial_axis in the train and eval steps (the batches' H axis sharded over the mesh, "
    "the whole step partitioned with its conv halos) is not ported to PyTorch; the H-sharded "
    "generator forward is (parallel.make_spatial_forward). See ROADMAP.md, Queue 1 item 6"
)


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
    if spatial_axis is not None:
        raise NotImplementedError(SPATIAL_NOT_PORTED)


def _on_mesh(model, mesh: Mesh) -> None:
    mesh.check_device(next(model.parameters()).device)
    if mesh.shape["space"] > 1:
        raise NotImplementedError(SPATIAL_NOT_PORTED)


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

    ``images`` / ``future_images`` are this rank's rows of the global batch;
    ``generator`` is the same on every rank (the shard_map mode derives each
    rank's draws from it, :func:`~..training.rank_generator`). A mesh of one
    returns the plain step. The keyword arguments are the JAX package's:
    ``donate_state`` has nothing to do here (the step updates the state in
    place), and the optimizers belong to the state
    (:func:`~..training.init_train_state`), so ``optimizers`` raises.
    """
    del donate_state
    _validate_layout(mesh, mode, spatial_axis)
    if optimizers is not None:
        raise TypeError("the port's optimizers live in the TrainState: pass them to "
                        "training.init_train_state")
    _on_mesh(model, mesh)
    kw = dict(logging_forward=logging_forward, watch_gradients=watch_gradients,
              watch_histograms=watch_histograms, compute_dtype=compute_dtype,
              return_grads=return_grads, rollout_remat=rollout_remat, r1_gamma=r1_gamma)
    if mesh.size == 1:
        return make_train_step(model, **kw)
    return make_train_step(model, group=mesh.data_group, global_batch=mode == "pjit", **kw)


def make_dp_eval_step(
    model,
    mesh: Mesh,
    *,
    mode: str = "shard_map",
    compute_dtype: Optional[torch.dtype] = None,
    spatial_axis: Optional[str] = None,
):
    """The validation step over ``mesh``: per-rank draws (``pjit``: shared), metrics averaged."""
    _validate_layout(mesh, mode, spatial_axis)
    _on_mesh(model, mesh)
    if mesh.size == 1:
        return make_eval_step(model, compute_dtype=compute_dtype)
    return make_eval_step(model, compute_dtype=compute_dtype, group=mesh.data_group,
                          global_batch=mode == "pjit")


def make_dp_generate(model, mesh: Mesh, *, num_samples: Optional[int] = None):
    """Ensemble nowcasts over ``mesh``: ``generate(x, generator) -> (S, B / n, T, C, H, W)``.

    ``x`` is the global batch and every rank passes the same ``generator``:
    each rank nowcasts its contiguous rows of the batch with the same
    per-sample latents (:func:`~..inference.make_generate`), so the ranks'
    outputs in rank order are the single-rank ensemble. Inference has no
    cross-rank math, so nothing is communicated.
    """
    _on_mesh(model, mesh)
    generate = make_generate(model, num_samples=num_samples)

    def dp_generate(x, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return generate(shard_batch(x, mesh), generator)

    return dp_generate
