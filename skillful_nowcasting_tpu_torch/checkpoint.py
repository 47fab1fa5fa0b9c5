"""Checkpoint and resume of the GAN train state (the port's counterpart of the Orbax module).

A step directory ``<directory>/<step>/`` holds one of two kinds of
checkpoint: the port's own, or the JAX package's Orbax checkpoint.

The port's is ``<step>/state.pt``: one ``torch.save`` of the
model's state dict (parameters and BN/SN buffers), both optimizers, both lr
schedulers, ``step``, the training ``torch.Generator``'s state and the
scalar metrics (and, from a data-parallel run, every rank's generator
state); ``metrics.json`` beside it holds the metrics for best tracking. A
file is written aside and renamed over its name, so a reader
never sees a partial file and a file still mapped by a reader is never
overwritten in place (overwriting a mapped file kills the process with
SIGBUS). Reading uses ``torch.load(weights_only=True)``: a checkpoint holds
tensors, numbers, strings and containers only.

The JAX package's kind is what ``skillful_nowcasting_tpu.checkpoint.save_state``
writes: an Orbax ``StandardSave`` of ``{"state": TrainState, "rng":
key_data}`` (an OCDBT store of zarr v2 arrays with zstd chunks, read and
written by :mod:`.ckpt_format` without orbax, tensorstore or JAX).
:func:`restore_state` reads either kind; :func:`save_jax_state` writes an
Orbax step that the JAX ``restore_state(make_manager(dir), template, key)``
reads. The JAX ``TrainState`` (``params``, ``batch_stats``, ``spectral``,
``g_opt_state``, ``d_opt_state``, ``step``) maps onto the port's
:class:`~.training.TrainState` so:

* weights, BN statistics and spectral-norm ``u`` / ``v`` go through
  :mod:`.hub.convert` (HWIO <-> OIHW, ``(in, out)`` <-> ``(out, in)``).
  ``num_batches_tracked`` (JAX has no such counter, and it feeds nothing) is
  kept in the step's ``custom_metadata`` by the port, and is 0 from a step
  the JAX package wrote;
* each optax chain ``(ScaleByAdamState(count, mu, nu), EmptyState() or
  ScaleByScheduleState(count))``: ``mu`` / ``nu`` are each parameter's
  ``exp_avg`` / ``exp_avg_sq`` in its parameter's layout and ``count`` its
  Adam ``step``; the schedule's count (under a fixed lr, the Adam count) is
  the ``LambdaLR``'s ``last_epoch`` and sets the optimizer's lr. D's tree is
  ``{"discriminator": ...}`` (``split_params``);
* ``rng`` holds the JAX key's two ``uint32`` words ``(k0, k1)``. Threefry and
  Philox never agree, so a restored run seeds its ``torch.Generator`` with
  ``k0 << 32 | k1`` on every rank (:func:`seed_from_key`; the Trainer seeds
  every rank alike, and the steps derive each rank's draws from it), and the
  port writes a key drawn from a clone of its generator, so a save does not
  advance the run's draws (:func:`key_from_generator`).

:class:`CheckpointManager` keeps the latest ``max_to_keep`` steps, or, with
``monitor``, the ``max_to_keep`` best by that metric (lowest first), as
Lightning's last + best ``ModelCheckpoint`` pair of the reference does. It
lists, ranks and prunes both kinds alike (an Orbax step's metrics are those
Orbax stored with it); a step directory holding both kinds raises.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .ckpt_format import tree as orbax_tree
from .hub.convert import (
    _invert_weight,
    _to_jax_layout,
    convert_torch_state_dict,
    param_paths,
    state_dict_from_variables,
)
from .training import TrainState, split_params

DEFAULT_MONITOR = "train/g_loss"
STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"
TORCH_KIND, ORBAX_KIND = "torch", "orbax"


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

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def kind(self, step: int) -> Optional[str]:
        """``"torch"`` (``state.pt``), ``"orbax"`` (the JAX package's) or ``None``; both kinds raise."""
        step_dir = self.step_dir(step)
        torch_kind = os.path.isfile(os.path.join(step_dir, STATE_FILE))
        orbax_kind = orbax_tree.is_step(step_dir)
        if torch_kind and orbax_kind:
            raise ValueError(f"step directory {step_dir} holds both a {STATE_FILE} and an Orbax "
                             "checkpoint; remove one")
        return TORCH_KIND if torch_kind else ORBAX_KIND if orbax_kind else None

    def all_steps(self) -> List[int]:
        """Steps with a complete checkpoint of either kind, in ascending order."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and self.kind(int(name)) is not None)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def metrics(self, step: int) -> Dict[str, float]:
        if self.kind(step) == ORBAX_KIND:
            return orbax_tree.read_metrics(self.step_dir(step))
        path = os.path.join(self.step_dir(step), METRICS_FILE)
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
        step_dir = self.step_dir(step)
        if self.kind(step) == ORBAX_KIND:
            shutil.rmtree(step_dir)  # the step is written anew, in the port's kind
        os.makedirs(step_dir, exist_ok=True)
        metrics = {k: float(v) for k, v in (metrics or {}).items()}

        def write_metrics(tmp):
            with open(tmp, "w") as f:
                json.dump(metrics, f)

        _write_aside(os.path.join(step_dir, METRICS_FILE), write_metrics)
        _write_aside(os.path.join(step_dir, STATE_FILE), lambda tmp: torch.save(payload, tmp))
        self._prune()

    def restore(self, step: Optional[int] = None) -> dict:
        """The payload of the ``state.pt`` of ``step`` (``None``: the latest), on the CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        if self.kind(step) != TORCH_KIND:
            raise ValueError(f"step {step} in {self.directory} holds no {STATE_FILE}")
        return torch.load(os.path.join(self.step_dir(step), STATE_FILE),
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
                shutil.rmtree(self.step_dir(s))


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

    Either kind of step is read (an Orbax step by :func:`restore_jax_state`,
    which seeds every rank's generator alike). Tensors go to the model's
    device; the optimizers' moments follow their parameters. Rank ``rank``
    of a data-parallel run of ``world`` ranks takes its own generator state
    from a ``state.pt``; one written by another number of ranks raises.
    """
    step = manager.latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {manager.directory}")
    if manager.kind(step) == ORBAX_KIND:
        return restore_jax_state(manager, state, generator, step)
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


# ---------------------------------------------------------------- the JAX package's Orbax steps

def seed_from_key(key_data) -> int:
    """The generator seed of a run restored from JAX key data ``(k0, k1)``: ``k0 << 32 | k1``."""
    k = np.asarray(key_data).reshape(-1)
    if k.size != 2:
        raise ValueError(f"expected a JAX key's two uint32 words, got shape {np.shape(key_data)}")
    return int(k[0]) << 32 | int(k[1])


def key_from_generator(generator: torch.Generator) -> np.ndarray:
    """Two ``uint32`` words drawn from a clone of ``generator`` (which is not advanced)."""
    clone = torch.Generator(device=generator.device)
    clone.set_state(generator.get_state().clone())
    words = torch.randint(0, 1 << 32, (2,), generator=clone, dtype=torch.int64,
                          device=generator.device)
    return words.cpu().numpy().astype(np.uint32)


def _paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, ...]]:
    """Leaf paths of nested dicts; a list (a spectral ``uv`` pair) is one leaf."""
    if not isinstance(tree, Mapping):
        return [prefix]
    return [p for k, v in tree.items() for p in _paths(v, (*prefix, str(k)))]


def _strict(found, expected, where: str) -> None:
    """Raise ``KeyError``, naming the paths, unless ``found`` has exactly ``expected``'s leaves."""
    got, want = set(_paths(found)), set(_paths(expected))
    missing = sorted("/".join(p) for p in want - got)
    extra = sorted("/".join(p) for p in got - want)
    if missing or extra:
        raise KeyError(f"{where}: missing leaves {missing[:8]}{' ...' if len(missing) > 8 else ''}"
                       f", extra leaves {extra[:8]}{' ...' if len(extra) > 8 else ''}")


def _get(tree, path: Sequence[str]):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree: dict, path: Sequence[str], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _schedule_spec(sched) -> Optional[str]:
    """The scheduler's spec (:func:`~.training.lr_scheduler`), ``None`` for a fixed lr."""
    spec = getattr(sched, "spec", None)
    return None if spec in (None, "constant") else spec


def _load_opt(opt, sched, names: Sequence[str], paths, params, opt_state, where: str) -> None:
    """One optax chain state into ``opt`` (Adam moments and step) and ``sched`` (its count)."""
    if not isinstance(opt_state, list) or len(opt_state) != 2:
        raise KeyError(f"{where}: expected the chain (ScaleByAdamState, schedule state)")
    adam, schedule = opt_state
    if not isinstance(adam, Mapping) or set(adam) != {"count", "mu", "nu"}:
        raise KeyError(f"{where}/0: expected ScaleByAdamState(count, mu, nu)")
    expected = {}
    for name in names:
        _set(expected, paths[name], None)
    for moment in ("mu", "nu"):
        _strict(adam[moment], expected, f"{where}/0/{moment}")
    count = int(np.asarray(adam["count"]))
    if schedule is None:  # EmptyState: a fixed lr
        if _schedule_spec(sched) is not None:
            raise ValueError(f"{where}/1: the checkpoint's lr is fixed (EmptyState); this run's "
                             f"lr schedule is {sched.spec!r}")
        last_epoch = count
    else:
        if not isinstance(schedule, Mapping) or set(schedule) != {"count"}:
            raise KeyError(f"{where}/1: expected EmptyState or ScaleByScheduleState(count)")
        if _schedule_spec(sched) is None:
            raise ValueError(f"{where}/1: the checkpoint's lr follows a schedule "
                             "(ScaleByScheduleState); this run's lr is fixed")
        last_epoch = int(np.asarray(schedule["count"]))
    # Adam's step tensor: float32 (float64 under a float64 default dtype), on the CPU.
    step_dtype = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
    state = {}
    for i, name in enumerate(names):
        entry = {"step": torch.tensor(float(count), dtype=step_dtype)}
        for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            value = np.asarray(_get(adam[moment], paths[name]))
            if paths[name][-1] == "kernel":
                value = _invert_weight(value)
            if tuple(value.shape) != tuple(params[name].shape):
                raise ValueError(f"{where}/0/{moment}/{'/'.join(paths[name])}: shape "
                                 f"{tuple(value.shape)} != the parameter's "
                                 f"{tuple(params[name].shape)}")
            entry[key] = torch.from_numpy(np.array(value, order="C"))
        state[i] = entry
    sd = opt.state_dict()
    sd["state"] = state
    opt.load_state_dict(sd)  # the moments follow their parameters' device and dtype
    sched.last_epoch = last_epoch
    lrs = [base * fn(last_epoch) for base, fn in zip(sched.base_lrs, sched.lr_lambdas)]
    for group, lr in zip(opt.param_groups, lrs):
        group["lr"] = lr
    sched._last_lr = lrs


def restore_jax_state(
    manager: CheckpointManager,
    state: TrainState,
    generator: torch.Generator,
    step: Optional[int] = None,
    *,
    tree=None,
) -> int:
    """Load the Orbax step ``step`` (``None``: the latest) into ``state`` and ``generator``; returns the step.

    Strict: every leaf that the port's state needs must be there and no
    other, or ``KeyError`` names the paths. ``generator`` is seeded by
    :func:`seed_from_key`. ``tree``: the step's :func:`.ckpt_format.tree.read_tree`,
    when the caller has read it already.
    """
    step = manager.latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {manager.directory}")
    step_dir = manager.step_dir(step)
    if tree is None:
        tree = orbax_tree.read_tree(step_dir)
    fields = {"params", "batch_stats", "spectral", "g_opt_state", "d_opt_state", "step"}
    if (not isinstance(tree, Mapping) or set(tree) != {"state", "rng"}
            or not isinstance(tree["state"], Mapping) or set(tree["state"]) != fields):
        raise KeyError(f"{step_dir}: expected {{state: TrainState({', '.join(sorted(fields))}), "
                       "rng}")
    s = tree["state"]
    model = state.model
    variables = {k: s[k] for k in ("params", "batch_stats", "spectral")}
    _strict(variables, convert_torch_state_dict(model.state_dict()), f"{step_dir}: state")
    sd = state_dict_from_variables(variables)
    tracked = orbax_tree.read_custom_metadata(step_dir).get("num_batches_tracked", {})
    for name, count in tracked.items():
        if name in sd:
            sd[name] = torch.tensor(int(count), dtype=sd[name].dtype)
    model.load_state_dict(sd, strict=True)
    paths = param_paths(model)
    g, d = split_params(model)
    _load_opt(state.g_opt, state.g_sched, list(g), paths, g, s["g_opt_state"],
              f"{step_dir}: state/g_opt_state")
    _load_opt(state.d_opt, state.d_sched, list(d), paths, d, s["d_opt_state"],
              f"{step_dir}: state/d_opt_state")
    state.step = int(np.asarray(s["step"]))
    generator.manual_seed(seed_from_key(tree["rng"]))
    return state.step


def _opt_tree(opt, sched, names: Sequence[str], paths, params) -> list:
    """``opt`` and ``sched`` as the optax chain state of the JAX package's ``make_optimizers``."""
    mu, nu, counts = {}, {}, set()
    for name in names:
        p = params[name]
        entry = opt.state.get(p, {})
        if "step" in entry:
            counts.add(int(entry["step"]))
        for tree, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            value = entry.get(key)
            value = (torch.zeros_like(p) if value is None else value).detach()
            if paths[name][-1] == "kernel":
                value = _to_jax_layout(value)
            _set(tree, paths[name], value.cpu().contiguous().numpy())
    if len(counts) > 1:
        raise ValueError(f"Adam steps {sorted(counts)} differ between parameters; optax keeps one")
    adam = orbax_tree.Fields(count=np.int32(counts.pop() if counts else 0), mu=mu, nu=nu)
    schedule = (None if _schedule_spec(sched) is None
                else orbax_tree.Fields(count=np.int32(sched.last_epoch)))
    return [adam, schedule]


def _jax_state_tree(state: TrainState, generator: torch.Generator) -> dict:
    """``{"state": TrainState, "rng": key_data}`` of the JAX package, as a tree of numpy arrays."""
    model = state.model
    variables = convert_torch_state_dict(model.state_dict())
    paths = param_paths(model)
    g, d = split_params(model)
    jstate = orbax_tree.Fields(
        params=variables["params"], batch_stats=variables["batch_stats"],
        spectral=variables["spectral"],
        g_opt_state=_opt_tree(state.g_opt, state.g_sched, list(g), paths, g),
        d_opt_state=_opt_tree(state.d_opt, state.d_sched, list(d), paths, d),
        step=np.int32(state.step),
    )
    return {"state": jstate, "rng": key_from_generator(generator)}


def save_jax_state(
    manager: CheckpointManager,
    step: int,
    state: TrainState,
    generator: torch.Generator,
    metrics: Optional[Dict[str, float]] = None,
) -> int:
    """Write ``state`` as the JAX package's Orbax step ``step``, then prune; returns its bytes.

    The JAX ``restore_state(make_manager(manager.directory), template, key)``
    reads it; ``metrics`` are stored where Orbax keeps a step's metrics. An
    existing step directory of that number is replaced.
    """
    step_dir = manager.step_dir(step)
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    tracked = {k: int(v) for k, v in state.model.state_dict().items()
               if k.endswith("num_batches_tracked")}
    size = orbax_tree.write_tree(
        step_dir, _jax_state_tree(state, generator),
        metrics=None if metrics is None else {k: float(v) for k, v in metrics.items()},
        custom_metadata={"num_batches_tracked": tracked})
    manager._prune()
    return size
