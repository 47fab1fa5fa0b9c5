"""Convolutions and the generator forward over H-sharded activations (port of ``parallel/spatial.py``).

Each rank holds a horizontal stripe ``(..., H_local, W)`` of a field: the
rank at index ``i`` of the mesh's ``space`` axis holds rows
``[i H_local, (i + 1) H_local)``. Before a convolution every rank takes
``halo`` rows from each neighbour by point-to-point exchange
(:func:`halo_exchange`); the domain's edges get zero rows, so a convolution
that is VALID in H reproduces the dense SAME convolution of the whole field.
A fused kernel that runs several convolutions back to back takes a window of
rows instead (:func:`halo_window`), as many as its receptive field reaches,
clipped to the field: it runs unchanged on the window with its own SAME
padding, which at the field's edges is the field's, and the rows outside the
stripe are cropped.

``gloo`` exchanges host tensors only, so on a ``gloo`` group the rows of a
CUDA tensor are copied to the host, sent, and copied back; NCCL sends them
card to card. Both exchanges count their calls, the bytes they receive and
their host seconds (``halo_window.calls`` / ``.bytes`` / ``.seconds``, the
same on :func:`halo_exchange`), as the kernels count launches.

:func:`make_spatial_forward` is the generator forward with every activation
H-sharded: JAX leaves the halos to GSPMD, here each layer takes them
explicitly (:class:`SpaceLayout`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.conv import SPATIAL_TRAIN_NOT_PORTED
from .mesh import Mesh, shard_batch

# The generator's deepest activation (the last context state, the latent) has H / 32 rows,
# and every rank's rows must stay even down to it (space_to_depth and avg_pool run locally).
SPATIAL_MULTIPLE = 32


def _staged(x: torch.Tensor, group) -> bool:
    """Whether ``x`` crosses ``group`` through the host (``gloo`` takes no CUDA tensor point to point)."""
    return x.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _count(fn, received, t0: float) -> None:
    fn.calls += 1
    fn.bytes += sum(t.numel() * t.element_size() for t in received)
    fn.seconds += time.perf_counter() - t0


def _exchange(ops) -> None:
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def halo_exchange(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    """``(B, C, H_local + 2 halo, W)``: ``x`` with ``halo`` rows of each H-neighbour around it.

    Rank ``i`` of ``group`` holds rows after rank ``i - 1``'s. The first
    rank's top and the last rank's bottom halo are zeros, as SAME zero
    padding gives.
    """
    t0 = time.perf_counter()
    n, me = dist.get_world_size(group), dist.get_rank(group)
    staged = _staged(x, group)

    def wire(t):  # what goes over the group: a contiguous tensor where the backend takes it
        return t.to("cpu").contiguous() if staged else t.contiguous()

    top, bottom = torch.zeros_like(wire(x[:, :, :halo])), torch.zeros_like(wire(x[:, :, -halo:]))
    ops, received = [], []
    if me > 0:  # my top rows are the previous rank's bottom halo; its bottom rows my top halo
        prev = dist.get_global_rank(group, me - 1)
        ops += [dist.P2POp(dist.isend, wire(x[:, :, :halo]), prev, group),
                dist.P2POp(dist.irecv, top, prev, group)]
        received.append(top)
    if me < n - 1:
        nxt = dist.get_global_rank(group, me + 1)
        ops += [dist.P2POp(dist.isend, wire(x[:, :, -halo:]), nxt, group),
                dist.P2POp(dist.irecv, bottom, nxt, group)]
        received.append(bottom)
    _exchange(ops)
    out = torch.cat([top.to(x.device), x, bottom.to(x.device)], dim=2)
    _count(halo_exchange, received, t0)
    return out


def _window(rank: int, rows_each: int, n: int, rows: int) -> tuple:
    """``[lo, hi)``: rank ``rank``'s stripe and ``rows`` rows each side, clipped to the field."""
    return max(0, rank * rows_each - rows), min(n * rows_each, (rank + 1) * rows_each + rows)


def halo_window(x: torch.Tensor, rows: int, group) -> tuple:
    """``(xw, top, bottom)``: this rank's stripe of ``x`` with ``rows`` rows each side, clipped to the field.

    H is ``x``'s second-to-last axis; every rank of ``group`` holds as many
    rows. ``top`` and ``bottom`` are the rows added above and below: fewer
    than ``rows`` at the field's edges, none past them. Where ``rows``
    exceeds a stripe the rows come from as many ranks as hold them, all in
    one ``batch_isend_irecv``.
    """
    t0 = time.perf_counter()
    n, me = dist.get_world_size(group), dist.get_rank(group)
    each = x.shape[-2]
    lo, hi = _window(me, each, n, rows)
    staged = _staged(x, group)
    ops, above, below = [], [], []
    for j in range(n):
        if j == me:
            continue
        peer = dist.get_global_rank(group, j)
        a, b = max(lo, j * each), min(hi, (j + 1) * each)  # what I take from rank j
        if a < b:
            buf = x.new_empty((*x.shape[:-2], b - a, x.shape[-1]),
                              device="cpu" if staged else x.device)
            ops.append(dist.P2POp(dist.irecv, buf, peer, group))
            (above if j < me else below).append(buf)
        j_lo, j_hi = _window(j, each, n, rows)  # what rank j takes from me
        a, b = max(j_lo, me * each) - me * each, min(j_hi, (me + 1) * each) - me * each
        if a < b:
            mine = x[..., a:b, :]
            mine = mine.to("cpu").contiguous() if staged else mine.contiguous()
            ops.append(dist.P2POp(dist.isend, mine, peer, group))
    _exchange(ops)
    xw = torch.cat([*(t.to(x.device) for t in above), x, *(t.to(x.device) for t in below)],
                   dim=-2)
    _count(halo_window, above + below, t0)
    return xw, me * each - lo, hi - (me + 1) * each


for _fn in (halo_exchange, halo_window):  # communication since the last reset
    _fn.calls, _fn.bytes, _fn.seconds = 0, 0, 0.0


def halo_conv2d(x: torch.Tensor, weight: torch.Tensor, group, padding: int = 1,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """SAME stride-1 conv of H-sharded NCHW activations (``weight`` OIHW, odd kernel height).

    ``padding`` must be ``(kernel_h - 1) // 2``. The halos stand in for the
    padding in H; W is padded with zeros as usual.
    """
    kh = weight.shape[2]
    if padding != (kh - 1) // 2:
        raise ValueError("padding must match the kernel for SAME semantics")
    xh = halo_exchange(x, padding, group) if padding else x
    return F.conv2d(xh, weight, bias, padding=(0, padding))


def make_spatial_conv(mesh: Mesh, *, padding: int = 1):
    """``conv(x_local, weight) -> y_local`` over the mesh's ``space`` axis (a plain SAME conv on one rank)."""
    group = mesh.space_group

    def conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        if group is None:
            return F.conv2d(x, weight, padding=padding)
        return halo_conv2d(x, weight, group, padding=padding)

    return conv


@dataclass(frozen=True)
class SpaceLayout:
    """This rank's place on the ``space`` axis, handed to the layers of a sharded forward.

    The layers call :meth:`conv` for a SAME conv and :meth:`window` for a fused
    kernel's rows; ``rank`` places a rank's stripe in a tensor every rank
    holds whole (the latent).
    """

    group: dist.ProcessGroup
    rank: int

    def window(self, x: torch.Tensor, rows: int) -> tuple:
        return halo_window(x, rows, self.group)

    def conv(self, x: torch.Tensor, weight: torch.Tensor, bias=None, padding: int = 1):
        return halo_conv2d(x, weight, self.group, padding=padding, bias=bias)


def make_spatial_forward(model, mesh: Mesh, *, spatial_axis: Optional[str] = "space",
                         batch_axis: str = "data"):
    """The generator forward with its activations H-sharded over the mesh's ``space`` axis.

    Returns ``fwd(x, z=None, generator=None) -> y_local``. ``x`` is the
    global NTCHW batch, on every rank; each rank cuts its rows of the batch
    and of H (:func:`~.mesh.shard_batch`) and returns its stripe
    ``(B / n_data, T, C, H / n_space, W)`` of the nowcast
    (:func:`~.mesh.gather_space` stacks the stripes back). Every rank passes
    the same ``z`` or an equally seeded ``generator``, JAX's shared key: the
    latent stack runs whole on every rank, as it reads no input rows.

    Every SAME 3x3 conv exchanges one halo row a side (:func:`halo_conv2d`);
    each GBlock kernel takes a window of 2 rows a side and each ConvGRU
    rollout one of ``2 T + 1``, recomputing the rows it borrows (the
    rollout's window covers its whole level at the paper's small levels).
    ``space_to_depth`` and ``avg_pool`` run on each rank's own rows, so H
    must divide by ``32 * n_space`` (a ``ValueError`` otherwise): the deepest
    state has H / 32 rows, an even count on every rank above it. JAX's GSPMD
    pads an uneven split instead; the port refuses it.

    The model must be in eval mode (the sharded train step is not ported)
    and on the mesh's device. A mesh whose ``space`` axis is 1 gives the
    dense forward of this rank's batch rows. ``spatial_axis=None`` on a mesh
    with ``space > 1`` raises: every rank of the space axis would compute
    the same rows. The keywords are JAX's; the port's mesh has only the
    ``"data"`` and ``"space"`` axes, so ``batch_axis`` is ``"data"``.
    """
    if spatial_axis not in ("space", None) or batch_axis != "data":
        raise ValueError(f"the mesh's axes are 'data' and 'space', got spatial_axis="
                         f"{spatial_axis!r}, batch_axis={batch_axis!r}")
    n_space = mesh.shape["space"]
    if spatial_axis is None and n_space > 1:
        raise ValueError(f"spatial_axis=None on a mesh with {n_space} space ranks: each would "
                         "compute the whole field; build the mesh with n_space=1")
    mesh.check_device(next(model.parameters()).device)
    _refuse_train(model)
    space = SpaceLayout(mesh.space_group, mesh.space_rank) if n_space > 1 else None

    def fwd(x, z: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        _refuse_train(model)
        x = torch.as_tensor(x)
        if x.shape[-2] % (SPATIAL_MULTIPLE * n_space):
            raise ValueError(
                f"an H of {x.shape[-2]} does not shard over {n_space} space ranks: it must divide "
                f"by {SPATIAL_MULTIPLE} x {n_space} (the deepest state has H / "
                f"{SPATIAL_MULTIPLE} rows, an even count a rank above it)")
        x = shard_batch(x, mesh, spatial_axis="space" if space else None)
        return model(x, z=z, generator=generator, space=space)

    return fwd


def _refuse_train(model) -> None:
    if model.training:
        raise NotImplementedError(SPATIAL_TRAIN_NOT_PORTED)
