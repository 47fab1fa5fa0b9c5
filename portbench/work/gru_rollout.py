"""Work of the eval ConvGRU rollouts of one model forward (``dgmr::convgru_rollout``).

Each of the sampler's four levels runs one rollout of T steps on its
hidden state, at level ``i`` of ``2**i * output_shape / 32`` pixels a side
with ``context_channels / 2**i`` channels. A step is two 3x3 convs on the
hidden state (read and update gates: 2C outputs; candidate: C outputs, on
``r * h``), so ``2 * M * 9 * C * 3C`` FLOPs a step for ``M`` pixels of the
batch. The gates' input part is a plain conv outside the kernel and is not
counted here. Bytes count each input read once and each output written once
at the configuration's element size: the hidden-part weights and the three
biases, the input part (once for the bottom level, whose input is the same
latent at every step, else once per step), the initial state and the T
output states.
"""

from __future__ import annotations

from typing import List, Mapping, Tuple


def rollout(t_in: int, batch: int, side: int, c: int, steps: int, elem: int) -> Tuple[float, float]:
    """FLOPs and bytes of one rollout: ``steps`` steps on ``batch`` maps of ``side``² x ``c``."""
    m = batch * side * side
    flops = steps * 2.0 * m * 9 * c * 3 * c
    values = 9 * c * 3 * c + 3 * c + t_in * m * 3 * c + m * c + steps * m * c
    return flops, float(elem * values)


def work(cfg: Mapping, batch: int, elem: int) -> List[Tuple[float, float]]:
    """``(FLOPs, bytes)`` of each of the four rollouts of one forward at ``batch``."""
    steps, g = cfg["forecast_steps"], cfg["output_shape"] // 32
    return [rollout(1 if i == 0 else steps, batch, g * 2**i, cfg["context_channels"] // 2**i,
                    steps, elem) for i in range(4)]
