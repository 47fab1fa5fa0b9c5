"""Data parallelism over ``torch.distributed`` (port of ``skillful_nowcasting_tpu/parallel``).

The JAX package lays a ``jax.sharding.Mesh`` over its devices and lets XLA
insert the collectives. Here every rank is a process (``torchrun``), the
:class:`~.mesh.Mesh` is its view of a ``(data, space)`` layout, and the
collectives are explicit ``torch.distributed`` calls: the gradient and state
averages of the data-parallel step (:mod:`.dp`), the all-reduce that
stitches a mesh-sharded tiled nowcast (``inference.tiled_nowcast_device``),
and the halo rows of the spatially sharded convs, generator forward and
train and eval steps (:mod:`.spatial`).
"""

from .dp import make_dp_eval_step, make_dp_generate, make_dp_train_step
from .mesh import (
    Mesh,
    all_reduce_mean_,
    gather_rows,
    gather_space,
    init_distributed,
    make_mesh,
    replicate,
    shard_batch,
    space_stripe,
)
from .spatial import (
    SpaceLayout,
    halo_conv2d,
    halo_exchange,
    halo_window,
    make_spatial_conv,
    make_spatial_forward,
    reset_halo_counters,
    space_layout,
)

__all__ = [
    "Mesh",
    "SpaceLayout",
    "all_reduce_mean_",
    "gather_rows",
    "gather_space",
    "halo_conv2d",
    "halo_exchange",
    "halo_window",
    "init_distributed",
    "make_dp_eval_step",
    "make_dp_generate",
    "make_dp_train_step",
    "make_mesh",
    "make_spatial_conv",
    "make_spatial_forward",
    "replicate",
    "reset_halo_counters",
    "shard_batch",
    "space_layout",
    "space_stripe",
]
