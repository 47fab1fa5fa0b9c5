"""Checkpoint and resume of the GAN train state (the port's counterpart of the Orbax module).

A checkpoint is ``<directory>/<step>/state.pt``: one ``torch.save`` of the
model's state dict (parameters and BN/SN buffers), both optimizers, both lr
schedulers, ``step``, the training ``torch.Generator``'s state and the
scalar metrics (and, from a data-parallel run, every rank's generator
state); ``metrics.json`` beside it holds the metrics for best tracking. A
file is written aside and renamed over its name, so a reader
never sees a partial file and a file still mapped by a reader is never
overwritten in place (overwriting a mapped file kills the process with
SIGBUS). Reading uses ``torch.load(weights_only=True)``: a checkpoint holds
tensors, numbers, strings and containers only.

:class:`CheckpointManager` keeps the latest ``max_to_keep`` steps, or, with
``monitor``, the ``max_to_keep`` best by that metric (lowest first), as
Lightning's last + best ``ModelCheckpoint`` pair of the reference does.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional, Sequence

import torch

from .training import TrainState

DEFAULT_MONITOR = "train/g_loss"
STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"


def _write_aside(path: str, write) -> None:
    """``write(tmp_path)``, then rename over ``path``; the partial file is removed on failure."""
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class CheckpointManager:
    """Step directories under ``directory``, pruned to ``max_to_keep`` (latest, or best by ``monitor``)."""

    def __init__(self, directory: str, *, max_to_keep: int = 3, monitor: Optional[str] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.monitor = monitor
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> List[int]:
        """Steps with a complete state file, in ascending order."""
        return sorted(
            int(name) for name in os.listdir(self.directory)
            if name.isdigit() and os.path.isfile(os.path.join(self.directory, name, STATE_FILE))
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def metrics(self, step: int) -> Dict[str, float]:
        path = os.path.join(self._step_dir(step), METRICS_FILE)
        if not os.path.isfile(path):
            return {}
        with open(path) as f:
            return json.load(f)

    def best_step(self) -> Optional[int]:
        """The step with the lowest ``monitor`` value (``None`` without a monitor or a step)."""
        scored = [(self.metrics(s).get(self.monitor, float("inf")), s) for s in self.all_steps()]
        return min(scored)[1] if self.monitor is not None and scored else None

    def save(self, step: int, payload: dict, metrics: Optional[Dict[str, float]] = None) -> None:
        """Write ``payload`` (and ``metrics``) as ``step``, then prune."""
        step_dir = self._step_dir(step)
        os.makedirs(step_dir, exist_ok=True)
        metrics = {k: float(v) for k, v in (metrics or {}).items()}

        def write_metrics(tmp):
            with open(tmp, "w") as f:
                json.dump(metrics, f)

        _write_aside(os.path.join(step_dir, METRICS_FILE), write_metrics)
        _write_aside(os.path.join(step_dir, STATE_FILE), lambda tmp: torch.save(payload, tmp))
        self._prune()

    def restore(self, step: Optional[int] = None) -> dict:
        """The payload of ``step`` (``None``: the latest), on the CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(os.path.join(self._step_dir(step), STATE_FILE),
                          map_location="cpu", weights_only=True)

    def _prune(self) -> None:
        steps = self.all_steps()
        if self.monitor is None:
            keep = set(steps[-self.max_to_keep:])
        else:
            ranked = sorted(steps, key=lambda s: (self.metrics(s).get(self.monitor, float("inf")), s))
            keep = set(ranked[: self.max_to_keep])
        for s in steps:
            if s not in keep:
                shutil.rmtree(self._step_dir(s))


def make_manager(
    directory: str, *, max_to_keep: int = 3, monitor: Optional[str] = None
) -> CheckpointManager:
    """A manager keeping the latest ``max_to_keep`` steps, or the best by ``monitor`` (mode min).

    The JAX package's spelling (``skillful_nowcasting_tpu.checkpoint.make_manager``),
    kept so that code written against it reads the same here.
    """
    return CheckpointManager(directory, max_to_keep=max_to_keep, monitor=monitor)


def save_state(
    manager: CheckpointManager,
    step: int,
    state: TrainState,
    generator: torch.Generator,
    metrics: Optional[Dict[str, float]] = None,
    rank_generators: Optional[Sequence[torch.Tensor]] = None,
) -> None:
    """Save the whole train state, the training generator's state and the scalar metrics.

    ``rank_generators``: every rank's generator state, in rank order, from a
    data-parallel run (:meth:`~.trainer.Trainer._save` gathers them).
    """
    metrics = {k: float(v) for k, v in (metrics or {}).items()}
    payload = {
        "model": state.model.state_dict(),
        "g_opt": state.g_opt.state_dict(),
        "d_opt": state.d_opt.state_dict(),
        "g_sched": state.g_sched.state_dict(),
        "d_sched": state.d_sched.state_dict(),
        "step": int(state.step),
        "generator": generator.get_state(),
        "metrics": metrics,
    }
    if rank_generators is not None:
        # Own storage each: set_state reads a view's storage from its start.
        payload["rank_generators"] = [g.cpu().clone() for g in rank_generators]
    manager.save(step, payload, metrics)


def restore_state(
    manager: CheckpointManager,
    state: TrainState,
    generator: torch.Generator,
    step: Optional[int] = None,
    *,
    rank: int = 0,
    world: int = 1,
) -> int:
    """Load ``step`` (``None``: the latest) into ``state`` and ``generator`` in place; returns the step.

    Tensors go to the model's device; the optimizers' moments follow their
    parameters. Rank ``rank`` of a data-parallel run of ``world`` ranks
    takes its own generator state; a checkpoint written by another number
    of ranks raises.
    """
    payload = manager.restore(step)
    state.model.load_state_dict(payload["model"], strict=True)
    state.g_opt.load_state_dict(payload["g_opt"])
    state.d_opt.load_state_dict(payload["d_opt"])
    state.g_sched.load_state_dict(payload["g_sched"])
    state.d_sched.load_state_dict(payload["d_sched"])
    state.step = int(payload["step"])
    ranks = payload.get("rank_generators")
    if (len(ranks) if ranks is not None else 1) != world:
        raise ValueError(f"the checkpoint of step {state.step} holds the generators of "
                         f"{len(ranks) if ranks is not None else 1} ranks; this run has {world}")
    generator.set_state(ranks[rank].clone() if ranks is not None else payload["generator"])
    return state.step


def best_step(manager: CheckpointManager) -> Optional[int]:
    """The best step by the manager's monitor; the JAX package's spelling of ``manager.best_step()``."""
    return manager.best_step()
