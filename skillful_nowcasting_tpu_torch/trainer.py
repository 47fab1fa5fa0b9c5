"""Trainer: the fit loop of the port (counterpart of ``skillful_nowcasting_tpu/trainer.py``).

Replaces Lightning's fit loop for the DGMR GAN: the train step, periodic
validation (the eval step, and the paper's skill metrics with
``val_skill``), checkpoints to ``latest/`` and ``best/`` (best on
``train/g_loss``, as the reference's ``ModelCheckpoint``), a checkpoint on
SIGTERM or Ctrl-C, refusal of a non-finite resume, an abort on non-finite
metrics, and metrics to stdout, JSONL and, where they import, TensorBoard
and wandb.

Data parallelism (``mesh``, ``dp_mode``; :mod:`.parallel`): on a mesh of
more than one rank every rank runs ``fit`` with its own stream of batches
(its rows of the global batch), the step averages the gradients, and the
ranks start from rank 0's weights. Only rank 0 writes checkpoints and logs;
every rank restores. A SIGTERM on any rank stops every rank after the same
step: the flag is all-reduced at each step's end. ``spatial_axis="space"``
(with ``dp_mode="pjit"``, as in JAX) shards the fields' H over the mesh's
``space`` axis as well: the ranks of a space group read the same stream
(their data rank's rows) and each cuts its stripe of every train and
validation batch (:func:`~.parallel.space_stripe`); the steps and the skill
metrics run on the stripes and give the whole fields' numbers.

Randomness: the train steps draw their latents and frame indices from one
CPU ``torch.Generator`` seeded with ``seed`` (on a mesh, the shard_map step
derives each rank's draws from it). Every rank's generator state is part of
every checkpoint and each rank restores its own, so a resumed run draws what
an uninterrupted one would. Validation never touches it: its batch ``i`` at
step ``s`` draws from a generator seeded with ``(seed, s, i)``.
"""

from __future__ import annotations

import signal
import sys
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from .checkpoint import DEFAULT_MONITOR, make_manager, restore_state, save_state
from .logging_utils import MetricsLogger
from .parallel import (
    gather_rows,
    make_dp_eval_step,
    make_dp_train_step,
    make_mesh,
    replicate,
    space_layout,
    space_stripe,
)
from .training import TrainState, _average, _mode, init_train_state


def _host_scalars(metrics: dict) -> dict:
    """Every 0-d tensor metric as a float, in one device-to-host copy."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor) and v.ndim == 0]
    if not keys:
        return {}
    values = torch.stack([metrics[k].detach().double() for k in keys]).cpu().tolist()
    return dict(zip(keys, values))


def _seeded(*parts: int) -> torch.Generator:
    """A CPU generator seeded from a tuple of integers."""
    return torch.Generator().manual_seed(int(np.random.SeedSequence(list(parts)).generate_state(1)[0]))


def _all_finite(tensors) -> bool:
    """One reduction on the device, one fetch to the host."""
    return bool(torch.stack([torch.isfinite(t).all() for t in tensors]).all().item())


class _Quiet:
    """The logger of every rank but 0: it writes nothing."""

    def log_scalars(self, *_):
        pass

    log_histograms = log_video_frames = flush = log_scalars


class Trainer:
    """The DGMR GAN fit loop on the device the model lives on."""

    def __init__(
        self,
        model,
        *,
        max_steps: int = 1000,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 100,
        val_every: int = 0,
        val_batches: int = 1,
        log_every: int = 10,
        log_dir: Optional[str] = None,
        use_wandb: bool = False,
        seed: int = 0,
        logging_forward: bool = True,
        on_checkpoint=None,
        prefetch: int = 2,
        transfer_dtype: Optional[torch.dtype] = None,
        watch_gradients: bool = False,
        watch_histograms: bool = False,
        compute_dtype: Optional[torch.dtype] = None,
        val_skill: bool = False,
        rollout_remat: bool = True,
        g_lr_schedule: Optional[str] = None,
        d_lr_schedule: Optional[str] = None,
        r1_gamma: float = 0.0,
        abort_on_nan: bool = True,
        mesh=None,
        dp_mode: str = "shard_map",
        spatial_axis=None,
    ):
        self.model = model
        self.device = next(model.parameters()).device
        # The whole world of torch.distributed by default (this process alone without it).
        self.mesh = mesh if mesh is not None else make_mesh(device=self.device)
        self.rank = self.mesh.rank
        self.max_steps = max_steps
        self.val_every = val_every
        self.val_batches = val_batches
        self.log_every = log_every
        self.ckpt_every = ckpt_every
        self.seed = seed
        # Host batches are staged this many steps ahead by a background thread
        # (the reference DataLoader's workers and pin_memory); 0 stages in line.
        self.prefetch = prefetch
        # Train batches only: validation batches go over at full precision.
        self.transfer_dtype = transfer_dtype
        if on_checkpoint is None and use_wandb:
            from .logging_utils import make_wandb_checkpoint_uploader

            on_checkpoint = make_wandb_checkpoint_uploader()
        # on_checkpoint(step, latest_dir) after each periodic save.
        self.on_checkpoint = on_checkpoint
        # Abort, without writing the blown-up state, when a logged metric is not finite.
        self.abort_on_nan = abort_on_nan
        self.g_lr_schedule, self.d_lr_schedule = g_lr_schedule, d_lr_schedule
        self.train_step = make_dp_train_step(
            model, self.mesh, mode=dp_mode, spatial_axis=spatial_axis,
            logging_forward=logging_forward, watch_gradients=watch_gradients,
            watch_histograms=watch_histograms, compute_dtype=compute_dtype,
            rollout_remat=rollout_remat, r1_gamma=r1_gamma,
        )
        self.eval_step = make_dp_eval_step(model, self.mesh, mode=dp_mode,
                                           compute_dtype=compute_dtype, spatial_axis=spatial_axis)
        # This rank's stripe of each batch under a space layout, else the batch.
        self.space = space_layout(self.mesh) if spatial_axis is not None else None
        self.skill_metrics = None
        if val_skill:
            from .inference import make_skill_metrics

            with _mode(model, False):
                self.skill_metrics = make_skill_metrics(model, dtype=compute_dtype,
                                                        space=self.space)
        self.logger = MetricsLogger(log_dir, use_wandb=use_wandb) if self.rank == 0 else _Quiet()
        self.manager = make_manager(f"{ckpt_dir}/latest") if ckpt_dir else None
        self.best_manager = (
            make_manager(f"{ckpt_dir}/best", max_to_keep=1, monitor=DEFAULT_MONITOR)
            if ckpt_dir else None
        )
        self._sigterm_pending = False
        self._in_step = False
        self._saved_step = None  # the step of the newest checkpoint, the same on every rank

    def _to_device(self, batch):
        batch = tuple(torch.as_tensor(np.asarray(b) if not isinstance(b, torch.Tensor) else b)
                      .to(self.device) for b in batch)
        return batch if self.space is None else space_stripe(batch, self.mesh)

    def _sigterm(self, _sig, _frame):
        """SIGTERM (preemption) becomes KeyboardInterrupt, between steps.

        A step updates the state in place, so a signal that lands inside one
        (or inside its logging, validation or checkpoint) is held until it
        ends, and the emergency checkpoint holds whole steps, labelled with
        the number completed. Anything else that stops the train step itself
        partway (Ctrl-C, an out-of-memory error) leaves D a step ahead of G:
        then no emergency checkpoint is written. On a mesh the signal is always
        held to the step's end, where the ranks agree to stop.
        """
        if self._in_step or self.mesh.size > 1:
            self._sigterm_pending = True
            return
        raise KeyboardInterrupt("SIGTERM (preemption)")

    def fit(
        self,
        train_iter: Iterator,
        val_iter: Optional[Iterator] = None,
        *,
        resume: bool = True,
        init_state: Optional[TrainState] = None,
    ) -> TrainState:
        """Run the GAN loop from ``state.step`` to ``max_steps``; returns the state.

        ``train_iter`` / ``val_iter`` yield NTCHW ``(images, future_images)``
        numpy arrays or tensors (:mod:`.data`); on a mesh, this rank's rows of
        each global batch. One batch is drawn before the
        loop, as the JAX Trainer draws its init batch, so an iterator feeds
        the same batches to the same steps in both. ``init_state`` starts from
        a given state (e.g. :func:`~.hub.train_state_from_lightning`); a
        checkpoint in ``ckpt_dir/latest`` takes precedence when ``resume``.
        """
        generator = torch.Generator().manual_seed(self.seed)
        staged = None
        if self.prefetch:
            from .data.prefetch import prefetch_to_device

            train_iter = staged = prefetch_to_device(
                train_iter, size=self.prefetch, device=self.device,
                transfer_dtype=self.transfer_dtype)
        try:
            next(train_iter)
            if init_state is not None:
                state = init_state
            else:
                state = init_train_state(self.model, g_lr_schedule=self.g_lr_schedule,
                                         d_lr_schedule=self.d_lr_schedule)
            self._saved_step = self.manager.latest_step() if self.manager is not None else None
            if self.manager is not None and resume and self._saved_step is not None:
                restore_state(self.manager, state, generator, rank=self.rank,
                              world=self.mesh.size)
                # A checkpoint written after a blow-up would poison every later step.
                if not _all_finite(list(state.model.parameters())):
                    raise RuntimeError(
                        f"refusing to resume from step {state.step}: checkpoint params contain "
                        f"non-finite values; delete or repair {self.manager.directory}")
                print(f"resumed from step {state.step}", file=sys.stderr)
            replicate(state.model, self.mesh)  # every rank starts from rank 0's weights
            return self._loop(state, train_iter, val_iter, generator)
        finally:
            if staged is not None:
                staged.close()  # stops the staging thread

    def _loop(self, state: TrainState, train_iter, val_iter, generator) -> TrainState:
        metrics = {}
        torn = False  # the train step stopped partway: the state is half updated
        prev_handler = None
        if threading.current_thread() is threading.main_thread():
            prev_handler = signal.signal(signal.SIGTERM, self._sigterm)
        try:
            t_log = time.time()
            for step in range(state.step, self.max_steps):
                images, future = self._to_device(next(train_iter))
                self._in_step = True
                try:
                    torn = True
                    metrics = self.train_step(state, images, future, generator)
                    torn = False
                    hists = metrics.pop("train/hist", None)
                    if self.log_every and (step + 1) % self.log_every == 0:
                        host = _host_scalars(metrics)
                        host["train/steps_per_sec"] = self.log_every / max(time.time() - t_log, 1e-9)
                        self.logger.log_scalars(host, step + 1)
                        bad = sorted(k for k, v in host.items() if not np.isfinite(v))
                        if self.abort_on_nan and bad:
                            metrics = {}  # no emergency save: keep the last good checkpoint
                            raise RuntimeError(
                                f"non-finite training metrics at step {step + 1}: "
                                f"{', '.join(bad)} — aborting (disable with abort_on_nan=False)")
                        if hists is not None:
                            self.logger.log_histograms(
                                {k: {s: v.cpu().numpy() for s, v in h.items()}
                                 for k, h in hists.items()}, step + 1)
                        if "train/generated_images" in metrics:
                            for tag, video in (
                                ("train/Generated_Image", metrics["train/generated_images"]),
                                ("train/Input_Image_Stack", images),
                                ("train/Target_Image", future),
                            ):
                                self.logger.log_video_frames(tag, video.float().cpu().numpy(),
                                                             step + 1)
                        t_log = time.time()

                    if self.val_every and val_iter is not None and (step + 1) % self.val_every == 0:
                        self._validate(state, val_iter, step + 1)

                    if self.manager is not None and (step + 1) % self.ckpt_every == 0:
                        self._save(state, generator, metrics)
                        if self.on_checkpoint is not None and self.rank == 0:
                            self.on_checkpoint(step + 1, self.manager.directory)
                finally:
                    self._in_step = False
                if self._any_rank(self._sigterm_pending):
                    self._sigterm_pending = False
                    raise KeyboardInterrupt("SIGTERM (preemption)")
        except KeyboardInterrupt:
            print("interrupted", file=sys.stderr)
            if torn:
                raise
        finally:
            # The emergency save is labelled with the steps completed (state.step).
            if torn:
                print(f"the train step after step {state.step} stopped partway: no emergency "
                      "checkpoint", file=sys.stderr)
            elif self.manager is not None and metrics and self._saved_step != state.step:
                print(f"saving checkpoint at step {state.step}", file=sys.stderr)
                self._save(state, generator, metrics)
            self.logger.flush()
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
        return state

    def _any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank of the mesh (one all-reduce on a mesh of more than one)."""
        if self.mesh.size == 1:
            return flag
        import torch.distributed as dist

        t = torch.tensor([float(flag)], device=self.mesh.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.mesh.group)
        return bool(t.item())

    def _save(self, state: TrainState, generator: torch.Generator, metrics: dict) -> None:
        """Every rank's generator state is gathered (a collective); rank 0 writes the checkpoint."""
        ranks = None
        if self.mesh.size > 1:
            mine = generator.get_state().to(self.mesh.device)
            ranks = list(gather_rows(mine, self.mesh.group).cpu())
        if self.rank == 0:
            scalars = _host_scalars(metrics)
            save_state(self.manager, state.step, state, generator, scalars,
                       rank_generators=ranks)
            save_state(self.best_manager, state.step, state, generator, scalars,
                       rank_generators=ranks)
        self._saved_step = state.step

    def _validate(self, state: TrainState, val_iter: Iterator, step: int) -> None:
        """The eval step (and the skill metrics) over ``val_batches`` batches, averaged and logged."""
        accum = {}
        for i in range(self.val_batches):
            images, future = self._to_device(next(val_iter))
            m = dict(self.eval_step(state, images, future, _seeded(self.seed, step, i)))
            if self.skill_metrics is not None:
                with _mode(self.model, False):
                    sm = self.skill_metrics(images, future, _seeded(self.seed, step, 1000 + i))
                sm = {k: v.clone() for k, v in sm.items()}  # out of inference mode
                _average(sm.values(), self.mesh.data_group)
                m.update({f"val/{k}": v for k, v in sm.items()})
            for k, v in _host_scalars(m).items():
                accum[k] = accum.get(k, 0.0) + v / self.val_batches
        self.logger.log_scalars(accum, step)
