"""Convolutions over H-sharded activations, with halo rows exchanged between ranks (port of ``parallel/spatial.py``).

Each rank holds a horizontal stripe ``(B, C, H_local, W)`` of a field. Before
a convolution every rank takes ``halo`` rows from each neighbour on the
mesh's ``space`` axis by point-to-point exchange; the domain's edges get zero
rows, so a convolution that is VALID in H reproduces the dense SAME
convolution of the whole field.

``gloo`` exchanges host tensors only, so on a ``gloo`` group the halo rows
of a CUDA tensor are copied to the host, sent, and copied back; NCCL sends
them card to card.

Not ported: ``make_spatial_forward`` (the whole generator with its
activations H-sharded by GSPMD) raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import Mesh


def halo_exchange(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    """``(B, C, H_local + 2 halo, W)``: ``x`` with ``halo`` rows of each H-neighbour around it.

    Rank ``i`` of ``group`` holds rows after rank ``i - 1``'s. The first
    rank's top and the last rank's bottom halo are zeros, as SAME zero
    padding gives.
    """
    n, me = dist.get_world_size(group), dist.get_rank(group)
    staged = x.device.type != "cpu" and dist.get_backend(group) == "gloo"

    def wire(t):  # what goes over the group: a contiguous tensor where the backend takes it
        return t.to("cpu").contiguous() if staged else t.contiguous()

    top, bottom = torch.zeros_like(wire(x[:, :, :halo])), torch.zeros_like(wire(x[:, :, -halo:]))
    ops = []
    if me > 0:  # my top rows are the previous rank's bottom halo; its bottom rows my top halo
        prev = dist.get_global_rank(group, me - 1)
        ops += [dist.P2POp(dist.isend, wire(x[:, :, :halo]), prev, group),
                dist.P2POp(dist.irecv, top, prev, group)]
    if me < n - 1:
        nxt = dist.get_global_rank(group, me + 1)
        ops += [dist.P2POp(dist.isend, wire(x[:, :, -halo:]), nxt, group),
                dist.P2POp(dist.irecv, bottom, nxt, group)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return torch.cat([top.to(x.device), x, bottom.to(x.device)], dim=2)


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


def make_spatial_forward(model, mesh: Mesh, *, spatial_axis: str = "space", batch_axis="data"):
    """Not ported: JAX partitions the whole forward by GSPMD, which PyTorch has no exact counterpart of."""
    raise NotImplementedError(
        "make_spatial_forward (the generator with its activations H-sharded by GSPMD) is not "
        "ported to PyTorch; see ROADMAP.md, Queue 1. For giant fields use "
        "inference.tiled_nowcast_device(mesh=...)"
    )
