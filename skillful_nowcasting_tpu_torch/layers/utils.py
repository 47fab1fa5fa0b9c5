"""Conv factory (port of ``skillful_nowcasting_tpu/layers/utils.py``)."""

from __future__ import annotations

from ..ops import conv2d, conv3d
from .coord_conv import coord_conv2d


def get_conv_layer(conv_type: str = "standard"):
    """Return the conv constructor for ``conv_type``.

    ``"standard"`` is :func:`~skillful_nowcasting_tpu_torch.ops.conv2d`,
    ``"3d"`` :func:`~skillful_nowcasting_tpu_torch.ops.conv3d` (NCDHW) and
    ``"coord"`` :func:`~.coord_conv.coord_conv2d`, a ``CoordConv`` with
    ``conv2d``'s signature (``with_r`` stays False, as in JAX).
    """
    if conv_type == "standard":
        return conv2d
    if conv_type == "3d":
        return conv3d
    if conv_type == "coord":
        return coord_conv2d
    raise ValueError(f"{conv_type} is not a recognized Conv method")


def refuse_coord(conv_type: str, owner: str) -> None:
    """Raise ``TypeError`` for ``conv_type="coord"`` in GBlock, UpsampleGBlock, DBlock or DGMR.

    The stacks and discriminators refuse it through their blocks; DGMR checks
    first, before it looks at its device.

    The JAX package's blocks cannot run it: its ``CoordConv.__call__`` takes
    no ``sequential`` argument, which every GBlock / UpsampleGBlock / DBlock
    passes to its convs, and its ``add_coords`` takes 4-D input, where the
    context stack hands its DBlocks stacked-time 5-D input. So
    ``DGMR(conv_type="coord")`` fails at its first call there, and the port,
    which has nothing to hold a working one against, refuses it when built.
    ``LBlock`` passes neither and takes the coord factory in both packages.
    """
    if conv_type == "coord":
        raise TypeError(
            f"{owner}(conv_type='coord') is not supported: the JAX package's CoordConv takes "
            "no `sequential` argument and no stacked-time (5-D) input, which this block's "
            "convs receive, so the configuration fails there; use CoordConv directly or "
            "get_conv_layer('coord') outside the blocks"
        )
