"""Process groups and the data mesh (port of ``skillful_nowcasting_tpu/parallel/mesh.py``).

JAX lays a ``(data, space)`` mesh over the devices one program sees. A
PyTorch job runs one process per rank, started by a launcher (``torchrun``),
so the port's :class:`Mesh` is this rank's view: its rank, the mesh's shape,
the ``torch.distributed`` groups of its axes and its device. Collectives are
``torch.distributed`` calls on that group in place of XLA's ``psum`` /
``pmean``: NCCL between cards, ``gloo`` on the CPU (and, staged through the
host, for ranks that share one card).

The helpers below keep every collective explicit: :func:`all_reduce_mean_`
averages a list of tensors with one flat all-reduce per dtype, and
:func:`gather_rows` gathers equal-shaped tensors with an all-reduce of a
zeroed buffer (``gloo`` has no all-gather of CUDA tensors).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# A rank that died leaves the others waiting in their next collective; the
# group's timeout turns that wait into an error.
DEFAULT_TIMEOUT = timedelta(minutes=10)


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def init_distributed(backend: Optional[str] = None, *, timeout: timedelta = DEFAULT_TIMEOUT,
                     **kwargs) -> int:
    """Join the launcher's process group; returns the world size.

    The rank, world size and rendezvous come from the launcher's environment
    (``torchrun`` sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT``). Without ``WORLD_SIZE`` the world is
    one process and nothing is initialized, as JAX's single-host call does
    nothing; an initialized group is kept. Any other failure raises.

    ``backend`` defaults to ``"nccl"`` where CUDA is available, else
    ``"gloo"``. NCCL needs a card per rank: ranks that would share one raise
    here rather than in NCCL's first collective (use ``"gloo"`` to run
    several ranks on one card). ``kwargs`` go to
    ``torch.distributed.init_process_group``.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    if "WORLD_SIZE" not in os.environ:
        return 1
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kwargs.setdefault("rank", int(os.environ["RANK"]))
    kwargs.setdefault("world_size", int(os.environ["WORLD_SIZE"]))
    if backend == "nccl":
        torch.cuda.set_device(_local_rank())
    dist.init_process_group(backend, timeout=timeout, **kwargs)
    if backend == "nccl":
        _check_one_card_per_rank()
    return dist.get_world_size()


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))


def _check_one_card_per_rank() -> None:
    """Raise when two NCCL ranks use the same card (compared by UUID over a ``gloo`` side group)."""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    mine = f"{os.uname().nodename}/{props.uuid}"
    side = dist.new_group(backend="gloo")
    cards: List[Optional[str]] = [None] * dist.get_world_size()
    dist.all_gather_object(cards, mine, group=side)
    dist.destroy_process_group(side)
    if len(set(cards)) < len(cards):
        dist.destroy_process_group()
        raise RuntimeError(
            f"NCCL needs one card per rank, but ranks share cards ({cards}); run one rank per "
            "card, or pass backend='gloo' to run several ranks on one card")


@dataclass(frozen=True)
class Mesh:
    """This rank's view of a ``(data, space)`` mesh of processes.

    Rank ``r`` sits at ``(r // n_space, r % n_space)``. ``group`` holds every
    rank of the mesh; ``data_group`` the ranks that share this rank's space
    index (the batch axis), ``space_group`` those that share its data index.
    A mesh of one process has no groups (``None``): nothing is communicated.
    """

    shape: Dict[str, int]
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    data_group: Optional[dist.ProcessGroup] = None
    space_group: Optional[dist.ProcessGroup] = None

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["space"]

    @property
    def data_rank(self) -> int:
        return self.rank // self.shape["space"]

    @property
    def space_rank(self) -> int:
        return self.rank % self.shape["space"]

    def check_device(self, device: torch.device) -> None:
        """Raise unless tensors on ``device`` can run on this mesh (CUDA model, CPU mesh or back)."""
        device = torch.device(device)
        if self.size > 1 and device.type != self.device.type:
            raise ValueError(f"a model on {device} cannot run on a mesh whose device is "
                             f"{self.device}: the collectives would cross devices")


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: CUDA is not available; pass device='cpu' for a CPU mesh")
    return torch.device("cuda", _local_rank())


def make_mesh(n_data: Optional[int] = None, *, n_space: int = 1,
              device: Optional[torch.device | str] = None) -> Mesh:
    """The ``(data, space)`` mesh over the world (``torch.distributed``'s, or this process alone).

    ``n_data`` defaults to ``world // n_space``. More ranks than the world
    has raise, as in JAX. A mesh of one is local to each process (the
    single-device fast path of :mod:`.dp`); any larger mesh spans the whole
    world. Every rank must call this the same way: the axis groups are made
    collectively. ``device`` defaults to ``cuda:LOCAL_RANK`` (and raises
    without CUDA); pass ``"cpu"`` for a CPU mesh. An NCCL world needs a CUDA
    device.
    """
    world = _world()
    if n_data is None:
        n_data = world // n_space
    n = n_data * n_space
    if n_data < 1 or n_space < 1:
        raise ValueError(f"mesh axes must be at least 1, got data={n_data}, space={n_space}")
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    device = torch.device(device) if device is not None else _default_device()
    shape = {"data": n_data, "space": n_space}
    if n == 1:
        return Mesh(shape, 0, device)
    if n != world:
        raise NotImplementedError(f"a mesh of {n} ranks in a world of {world}: a mesh larger "
                                  "than one spans every rank")
    if dist.get_backend() == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL mesh needs a CUDA device, got {device}")
    rank = dist.get_rank()
    data_group = space_group = dist.group.WORLD
    if n_space > 1 and n_data > 1:
        data_group, _ = dist.new_subgroups_by_enumeration(
            [[d * n_space + s for d in range(n_data)] for s in range(n_space)])
        space_group, _ = dist.new_subgroups_by_enumeration(
            [[d * n_space + s for s in range(n_space)] for d in range(n_data)])
    elif n_space > 1:
        data_group = None
    else:
        space_group = None
    return Mesh(shape, rank, device, dist.group.WORLD, data_group, space_group)


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group) -> None:
    """Average ``tensors`` over ``group`` in place: one flat all-reduce per dtype, then a copy back."""
    n = _size(group)
    if n == 1 or not tensors:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        flat /= n
        with torch.no_grad():
            for t, part in zip(same, flat.split([t.numel() for t in same])):
                t.copy_(part.view_as(t))


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """``(n, *t.shape)``: every rank's ``t``, stacked in rank order, on every rank.

    An all-reduce (sum) of a zeroed buffer in which each rank filled its own
    row: adding zeros changes no value, and ``gloo`` all-reduces CUDA tensors
    where it has no all-gather of them.
    """
    n = _size(group)
    if n == 1:
        return t.unsqueeze(0)
    buf = torch.zeros((n, *t.shape), dtype=t.dtype, device=t.device)
    buf[dist.get_rank(group)] = t
    dist.all_reduce(buf, group=group)
    return buf


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0 of ``mesh``, so that ranks start equal.

    The counterpart of JAX's ``device_put(state, replicated)``: one
    broadcast per dtype of the flattened tensors.
    """
    if mesh.size == 1:
        return module
    tensors = [*module.parameters(), *module.buffers()]
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    src = dist.get_global_rank(mesh.group, 0)
    for same in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in same])
        dist.broadcast(flat, src=src, group=mesh.group)
        with torch.no_grad():
            for t, part in zip(same, flat.split([t.numel() for t in same])):
                t.copy_(part.view_as(t))
    return module


def _cut_rows(t: torch.Tensor, dim: int, n: int, index: int, axis: str) -> torch.Tensor:
    """Part ``index`` of ``n`` equal contiguous parts of ``t`` along ``dim`` (the ``axis`` ranks' share)."""
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"{'a batch' if axis == 'data' else 'an H'} of {size} does not divide "
                         f"over {n} {axis} ranks")
    per = size // n
    return t.narrow(dim, index * per, per)


def shard_batch(batch, mesh: Mesh, spatial_axis: Optional[str] = None):
    """This rank's contiguous rows (dim 0) of a global batch, on the mesh's device (JAX's ``P("data")``).

    ``batch`` is a tensor or array, or a tuple or list of them. The batch
    must divide evenly over the data axis. With ``spatial_axis="space"``
    each tensor's H (its second-to-last axis) is cut too, into the space
    axis' contiguous stripes (JAX's ``P("data", None, "space")``); H must
    divide evenly over it.
    """
    if spatial_axis not in (None, "space"):
        raise ValueError(f"spatial_axis must be 'space' or None, got {spatial_axis!r}")
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, mesh, spatial_axis) for b in batch)
    t = _cut_rows(torch.as_tensor(batch), 0, mesh.shape["data"], mesh.data_rank, "data")
    if spatial_axis is not None:
        t = _cut_rows(t, -2, mesh.shape["space"], mesh.space_rank, "space")
    return t.to(mesh.device)


def space_stripe(batch, mesh: Mesh):
    """This rank's stripe of H (the second-to-last axis) of tensors that hold its data rank's rows.

    What :func:`shard_batch` with ``spatial_axis="space"`` cuts from a global
    batch, for a rank that reads only its data rank's rows (the Trainer's
    streams); a tuple or list is cut element by element.
    """
    if isinstance(batch, (tuple, list)):
        return type(batch)(space_stripe(b, mesh) for b in batch)
    return _cut_rows(torch.as_tensor(batch), -2, mesh.shape["space"], mesh.space_rank, "space")


def gather_space(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The space group's stripes of ``y`` stacked back along H (the second-to-last axis), on every rank."""
    if mesh.space_group is None:
        return y
    return torch.cat(list(gather_rows(y.contiguous(), mesh.space_group)), dim=-2)
