"""The least work of the DGMR generator, by stack, from the configuration's shapes.

FLOPs of every conv (2 per multiply-add: ``2 * Hout * Wout * Cout * Cin *
k * k``) and of the attention's two products; elementwise ops, pooling,
normalisation and activations are not counted. Three units, each counted
once for what needs it (:mod:`portbench.harness.traffic` says how many of
each a request needs):

* :func:`context`: the conditioning stack on one crop of 4 context frames;
* :func:`latent`: the latent stack on one latent draw;
* :func:`sampler`: the sampler for one crop given its states and a latent:
  four ConvGRU levels of T steps (the bottom level's input part once, since
  its input is the same latent at every step), then per frame the 1x1 conv,
  the GBlock and the UpsampleGBlock, and the output head.

A forward of the port recomputes the context stack for each sample and the
latent stack for each tile batch; that repeated work is not counted, so
removing it raises the utilisation it is read against.
"""

from __future__ import annotations

from typing import Mapping

CONTEXT_STEPS = 4


def conv(side: int, cin: int, cout: int, k: int) -> float:
    """FLOPs of a stride-1 SAME conv on one ``side``² map."""
    return 2.0 * side * side * cout * cin * k * k


def context(cfg: Mapping) -> float:
    """The conditioning stack on one crop."""
    ic, oc, size = cfg["input_channels"], cfg["context_channels"], cfg["output_shape"]
    widths = [4 * ic] + [((oc * m // 4) * ic) // CONTEXT_STEPS for m in (1, 2, 4, 8)]
    flops, side = 0.0, size // 2
    for i in range(4):  # DBlocks, per context frame, at the side they read
        cin, cout = widths[i], widths[i + 1]
        per_frame = conv(side, cin, cout, 3) + conv(side, cout, cout, 3)
        if cin != cout:
            per_frame += conv(side, cin, cout, 1)
        flops += CONTEXT_STEPS * per_frame
        side //= 2
        mixed = cout * CONTEXT_STEPS
        flops += conv(side, mixed, mixed // 2, 3)
    return flops


def _lblock(side: int, cin: int, cout: int) -> float:
    f = conv(side, cin, cout, 3) + conv(side, cout, cout, 3)
    return f + (conv(side, cin, cout - cin, 1) if cin < cout else 0.0)


def latent(cfg: Mapping) -> float:
    """The latent stack on one draw."""
    zc, lc, g = 8 * cfg["input_channels"], cfg["latent_channels"], cfg["output_shape"] // 32
    c = lc // 4
    flops = conv(g, zc, zc, 3) + _lblock(g, zc, lc // 32) + _lblock(g, lc // 32, lc // 16)
    flops += _lblock(g, lc // 16, c)
    ck = c // 8
    tokens = ck * g  # (channel, row) pairs; features are the g columns
    flops += 3 * conv(g, c, ck, 1) + conv(g, ck, c, 1) + 2 * (2.0 * tokens * tokens * g)
    return flops + _lblock(g, c, lc)


def sampler(cfg: Mapping) -> float:
    """The sampler for one crop."""
    steps, g = cfg["forecast_steps"], cfg["output_shape"] // 32
    lc, oc = cfg["latent_channels"], cfg["context_channels"]
    flops = 0.0
    for i in range(4):
        side, cl, cc = g * 2**i, lc // 2**i, oc // 2**i
        t_in = 1 if i == 0 else steps
        flops += t_in * 3 * conv(side, cl, cc, 3) + steps * 3 * conv(side, cc, cc, 3)
        flops += steps * conv(side, cc, cl, 1)
        flops += steps * 2 * conv(side, cl, cl, 3)  # GBlock
        up = 2 * side
        flops += steps * (conv(up, cl, cl // 2, 1) + conv(up, cl, cl, 3) + conv(up, cl, cl // 2, 3))
    return flops + steps * conv(g * 16, lc // 16, 4, 1)
