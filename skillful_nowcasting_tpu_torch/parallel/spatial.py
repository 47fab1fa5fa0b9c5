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
card to card. Both exchanges count their calls and the bytes they receive
(``halo_window.calls`` / ``.bytes``, the same on :func:`halo_exchange`,
whose backward exchanges count apart), as the kernels count launches, and
their host time is in the spans ``dgmr.halo.window``, ``dgmr.halo.exchange``
and ``dgmr.halo.backward`` (:func:`~..profiling.record`).

:func:`make_spatial_forward` is the generator forward with every activation
H-sharded: JAX leaves the halos to GSPMD, here each layer takes them
explicitly (:class:`SpaceLayout`). The H-sharded train and eval steps
(:mod:`.dp`, ``spatial_axis="space"``) run the whole D/D/G cycle on stripes.
Their collectives follow one convention, under which autograd needs no
special case: every collective is a sum (a halo is a sum of a neighbour's
rows into zeros) whose backward is its adjoint, so each rank's backward
yields its share of the gradient of the sum of every rank's loss, and the
mean of the ranks' gradients over the mesh is the dense step's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.common import DRAWS_NOT_SHARED
from ..ops.norm import sum_over_ranks, sync_batch_norm
from ..profiling import span
from .mesh import Mesh, shard_batch

# The generator's deepest activation (the last context state, the latent) has H / 32 rows,
# and every rank's rows must stay even down to it (space_to_depth and avg_pool run locally).
SPATIAL_MULTIPLE = 32


def _staged(x: torch.Tensor, group) -> bool:
    """Whether ``x`` crosses ``group`` through the host (``gloo`` takes no CUDA tensor point to point)."""
    return x.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _count(fn, received) -> None:
    fn.calls += 1
    fn.bytes += sum(t.numel() * t.element_size() for t in received)


def _exchange(ops) -> None:
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def _swap(up: torch.Tensor, down: torch.Tensor, group, device) -> tuple:
    """Send ``up`` to the rank above and ``down`` to the rank below; ``(from_above, from_below)``.

    ``from_above`` is what the rank above sent down, ``from_below`` what the
    rank below sent up; zeros where there is no such rank (the field's edges).
    """
    n, me = dist.get_world_size(group), dist.get_rank(group)
    staged = _staged(up, group)

    def wire(t):  # what goes over the group: a contiguous tensor where the backend takes it
        return t.to("cpu").contiguous() if staged else t.contiguous()

    up, down = wire(up), wire(down)
    from_above, from_below = torch.zeros_like(down), torch.zeros_like(up)
    ops, received = [], []
    if me > 0:
        prev = dist.get_global_rank(group, me - 1)
        ops += [dist.P2POp(dist.isend, up, prev, group),
                dist.P2POp(dist.irecv, from_above, prev, group)]
        received.append(from_above)
    if me < n - 1:
        nxt = dist.get_global_rank(group, me + 1)
        ops += [dist.P2POp(dist.isend, down, nxt, group),
                dist.P2POp(dist.irecv, from_below, nxt, group)]
        received.append(from_below)
    _exchange(ops)
    return from_above.to(device), from_below.to(device), received


class _HaloExchange(torch.autograd.Function):
    """The halo rows around each stripe; its backward is :class:`_HaloAdjoint`, and back again."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, halo: int, group) -> torch.Tensor:
        ctx.halo, ctx.group = halo, group
        with span("dgmr.halo.exchange"):
            top, bottom, received = _swap(x[..., :halo, :], x[..., -halo:, :], group, x.device)
            out = torch.cat([top, x, bottom], dim=-2)
        _count(halo_exchange, received)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _HaloAdjoint.apply(grad, ctx.halo, ctx.group), None, None


class _HaloAdjoint(torch.autograd.Function):
    """The adjoint of :class:`_HaloExchange`: each halo row's gradient goes back to its owner.

    A rank sends the gradients of its top halo to the rank above, whose
    bottom rows they are, and of its bottom halo to the rank below; each adds
    what it receives into its edge rows. The halo at the field's edges (the
    zero padding) has no owner and drops out.
    """

    @staticmethod
    def forward(ctx, grad: torch.Tensor, halo: int, group) -> torch.Tensor:
        ctx.halo, ctx.group = halo, group
        with span("dgmr.halo.backward"):
            top, bottom, received = _swap(grad[..., :halo, :], grad[..., -halo:, :], group,
                                          grad.device)
            inner = grad[..., halo:grad.shape[-2] - halo, :]
            rest = inner.shape[-2] - halo
            out = inner + F.pad(top, (0, 0, 0, rest)) + F.pad(bottom, (0, 0, rest, 0))
        halo_exchange.backward_calls += 1
        halo_exchange.backward_bytes += sum(t.numel() * t.element_size() for t in received)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _HaloExchange.apply(grad, ctx.halo, ctx.group), None, None


def halo_exchange(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    """``(..., H_local + 2 halo, W)``: ``x`` with ``halo`` rows of each H-neighbour around it.

    H is the second-to-last axis (NCHW and NCDHW alike). Rank ``i`` of
    ``group`` holds rows after rank ``i - 1``'s. The first rank's top and the
    last rank's bottom halo are zeros, as SAME zero padding gives. Autograd
    runs through it to any order: the backward sends each halo row's gradient
    back to the rank that owns the row (counted apart, as ``.backward_calls``
    / ``.backward_bytes``, its span ``dgmr.halo.backward``), and the backward
    of that is the exchange again.
    """
    if not 0 < halo <= x.shape[-2]:
        raise ValueError(f"a halo of {halo} rows around a stripe of {x.shape[-2]}")
    return _HaloExchange.apply(x, halo, group)


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
    n, me = dist.get_world_size(group), dist.get_rank(group)
    each = x.shape[-2]
    lo, hi = _window(me, each, n, rows)
    staged = _staged(x, group)
    ops, above, below = [], [], []
    with span("dgmr.halo.window"):
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
    _count(halo_window, above + below)
    return xw, me * each - lo, hi - (me + 1) * each


def reset_halo_counters() -> None:
    """Set every exchange counter, forward and backward, to 0 (they count since the last reset)."""
    for fn in (halo_exchange, halo_window):
        fn.calls, fn.bytes = 0, 0
    halo_exchange.backward_calls, halo_exchange.backward_bytes = 0, 0


reset_halo_counters()


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

    The layers call :meth:`conv` for a SAME conv (2-D, or 3-D on NCDHW with
    the halo in H only) and :meth:`window` for a fused kernel's rows; the
    discriminators call :meth:`sum` to add up a reduction over the stripes
    and :meth:`gather` for a level too thin to pool on its stripes. ``rank``
    places a rank's stripe in a tensor every rank holds whole (the latent).
    Every collective but :meth:`window` is differentiable to any order.
    """

    group: dist.ProcessGroup
    rank: int

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    def window(self, x: torch.Tensor, rows: int) -> tuple:
        return halo_window(x, rows, self.group)

    def conv(self, x: torch.Tensor, weight: torch.Tensor, bias=None, padding: int = 1):
        if x.ndim == 5:  # NCDHW: the halo in H, SAME zero padding in D and W
            xh = halo_exchange(x, padding, self.group) if padding else x
            return F.conv3d(xh, weight, bias, padding=(padding, 0, padding))
        return halo_conv2d(x, weight, self.group, padding=padding, bias=bias)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the space group (its backward all-reduces the gradients)."""
        return sum_over_ranks(x, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole field of H-stripes ``x`` (H the second-to-last axis), on every rank.

        Each rank places its stripe in zeros at its rows and the space group
        sums them, so the backward is the reduce-scatter: the gradients of
        every rank's copy summed, and this rank's rows kept.
        """
        rows, n = x.shape[-2], self.size
        return self.sum(F.pad(x, (0, 0, self.rank * rows, (n - 1 - self.rank) * rows)))


def check_field_rows(h: int, n_space: int) -> None:
    """Raise ``ValueError`` unless a field of ``h`` rows shards over ``n_space`` space ranks."""
    if h % (SPATIAL_MULTIPLE * n_space):
        raise ValueError(
            f"an H of {h} does not shard over {n_space} space ranks: it must divide by "
            f"{SPATIAL_MULTIPLE} x {n_space} (the deepest state has H / {SPATIAL_MULTIPLE} rows, "
            "an even count a rank above it)")


def space_layout(mesh: Mesh) -> Optional[SpaceLayout]:
    """This rank's :class:`SpaceLayout` on ``mesh``, or ``None`` where its space axis is 1."""
    return SpaceLayout(mesh.space_group, mesh.space_rank) if mesh.shape["space"] > 1 else None


def make_spatial_forward(model, mesh: Mesh, *, spatial_axis: Optional[str] = "space",
                         batch_axis: str = "data"):
    """The generator forward with its activations H-sharded over the mesh's ``space`` axis.

    Returns ``fwd(x, z=None, generator=None) -> y_local``. ``x`` is the
    global NTCHW batch, on every rank; each rank cuts its rows of the batch
    and of H (:func:`~.mesh.shard_batch`) and returns its stripe
    ``(B / n_data, T, C, H / n_space, W)`` of the nowcast
    (:func:`~.mesh.gather_space` stacks the stripes back). The latent stack
    runs whole on every rank, as it reads no input rows, so every rank must
    pass the same ``z`` or an equally seeded ``generator``, JAX's shared key:
    with ``space > 1`` a call with neither raises ``ValueError`` (each
    process's global RNG would give its stripe another latent).

    Every SAME 3x3 conv exchanges one halo row a side (:func:`halo_conv2d`);
    each GBlock kernel takes a window of 2 rows a side and each ConvGRU
    rollout one of ``2 T + 1``, recomputing the rows it borrows (the
    rollout's window covers its whole level at the paper's small levels).
    ``space_to_depth`` and ``avg_pool`` run on each rank's own rows, so H
    must divide by ``32 * n_space`` (a ``ValueError`` otherwise): the deepest
    state has H / 32 rows, an even count on every rank above it. JAX's GSPMD
    pads an uneven split instead; the port refuses it.

    The model must be on the mesh's device. In eval mode the kernels run on
    windows; in train mode the plain layers run with their halos, and the
    generator's BatchNorms take their statistics over every rank of the mesh,
    the global batch's. A mesh whose ``space`` axis is 1 gives the
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
    space = space_layout(mesh)

    def fwd(x, z: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if space is not None and z is None and generator is None:
            raise ValueError(DRAWS_NOT_SHARED)
        x = torch.as_tensor(x)
        check_field_rows(x.shape[-2], n_space)
        x = shard_batch(x, mesh, spatial_axis="space" if space else None)
        with sync_batch_norm(model, mesh.group if model.training else None):
            return model(x, z=z, generator=generator, space=space)

    return fwd

