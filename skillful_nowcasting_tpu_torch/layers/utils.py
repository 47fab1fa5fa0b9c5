"""Conv factory (port of ``skillful_nowcasting_tpu/layers/utils.py``)."""

from __future__ import annotations

from ..ops import conv2d, conv3d


def get_conv_layer(conv_type: str = "standard"):
    """Return the conv constructor for ``conv_type``.

    ``"standard"`` is :func:`~skillful_nowcasting_tpu_torch.ops.conv2d` and
    ``"3d"`` :func:`~skillful_nowcasting_tpu_torch.ops.conv3d` (NCDHW);
    ``"coord"`` is not ported yet and raises ``NotImplementedError``.
    """
    if conv_type == "standard":
        return conv2d
    if conv_type == "3d":
        return conv3d
    if conv_type == "coord":
        raise NotImplementedError(f"conv_type={conv_type!r} is not ported yet")
    raise ValueError(f"{conv_type} is not a recognized Conv method")
