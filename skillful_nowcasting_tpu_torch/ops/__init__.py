"""Op library of the PyTorch port: convs, norms, pooling, pixel shuffles, attention, kernels."""

from .attention import attention_fixed, attention_torch_compat
from .conv import conv2d
from .gblock_fused import fold_gblock_variables, gblock_fused, gblock_fused_reference
from .gru_rollout import convgru_rollout, convgru_rollout_reference
from .norm import BatchNorm2d
from .pixel import depth_to_space, space_to_depth
from .pool import avg_pool
from .resize import upsample_nearest_2x

__all__ = [
    "BatchNorm2d",
    "attention_fixed",
    "attention_torch_compat",
    "avg_pool",
    "conv2d",
    "convgru_rollout",
    "convgru_rollout_reference",
    "depth_to_space",
    "fold_gblock_variables",
    "gblock_fused",
    "gblock_fused_reference",
    "space_to_depth",
    "upsample_nearest_2x",
]
