"""This process's index and the process count: given, or from ``torch.distributed``, else 0 of 1."""

from __future__ import annotations

from typing import Optional, Tuple


def process_index_and_count(index: Optional[int], count: Optional[int]) -> Tuple[int, int]:
    if index is not None and count is not None:
        return index, count
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
