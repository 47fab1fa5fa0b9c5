"""Conv factory (port of ``skillful_nowcasting_tpu/layers/utils.py``)."""

from __future__ import annotations

from ..ops import conv2d


def get_conv_layer(conv_type: str = "standard"):
    """Return the conv constructor for ``conv_type``.

    Only ``"standard"`` (:func:`~skillful_nowcasting_tpu_torch.ops.conv2d`) is
    ported; ``"coord"`` and ``"3d"`` raise ``NotImplementedError``.
    """
    if conv_type == "standard":
        return conv2d
    if conv_type in ("coord", "3d"):
        raise NotImplementedError(f"conv_type={conv_type!r} is not ported yet")
    raise ValueError(f"{conv_type} is not a recognized Conv method")
