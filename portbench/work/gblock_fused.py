"""Work of the eval GBlocks of one model forward (``dgmr::gblock_fused``).

Each sampler level runs one GBlock on every frame of its sequence (T
frames per batch element) at ``2**i * output_shape / 32`` pixels a side,
``latent_channels / 2**i`` channels in and out: two 3x3 convs, and a 1x1
shortcut conv only where the widths differ (never in DGMR). BatchNorm and
the biases are affines on the way. Bytes count the input and output maps
and the kernels once at the configuration's element size, and the four
per-channel affines in float32.
"""

from __future__ import annotations

from typing import List, Mapping, Tuple


def gblock(n: int, side: int, cin: int, cout: int, elem: int) -> Tuple[float, float]:
    """FLOPs and bytes of one eval GBlock on ``n`` maps of ``side``² x ``cin``."""
    m = n * side * side
    sc = cin != cout
    flops = 2.0 * m * 9 * cin * (cin + cout) + (2.0 * m * cin * cout if sc else 0.0)
    values = m * (cin + cout) + 9 * cin * (cin + cout) + (cin * cout if sc else 0)
    return flops, float(elem * values + 4 * (4 * cin + cout))


def work(cfg: Mapping, batch: int, elem: int) -> List[Tuple[float, float]]:
    """``(FLOPs, bytes)`` of each of the four GBlocks of one forward at ``batch``."""
    n, g, lc = cfg["forecast_steps"] * batch, cfg["output_shape"] // 32, cfg["latent_channels"]
    return [gblock(n, g * 2**i, lc // 2**i, lc // 2**i, elem) for i in range(4)]
