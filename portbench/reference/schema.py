"""The DGMR generator's state-dict schema, as the published reference lays it out.

Keys and shapes of the three stacks of openclimatefix/skillful_nowcasting's
``DGMR`` (``dgmr/dgmr.py``, ``dgmr/common.py``, ``dgmr/generators.py``,
``dgmr/layers``): every spectrally normalised conv stores
``parametrizations.weight.original`` with its ``parametrizations.weight.0._u``
/ ``._v`` vectors, BatchNorms their running statistics. The shortcut 1x1
convs that the published blocks build but never apply (a GBlock or DBlock
with equal channel counts) are listed too, since a strict load needs them.

Each entry is ``key -> (shape, kind)``; ``kind`` says how the benchmark's
weight maker fills it (:mod:`portbench.harness.weights`).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

Schema = Dict[str, Tuple[Tuple[int, ...], str]]

CONTEXT_STEPS = 4


def _conv(out: Schema, prefix: str, cin: int, cout: int, k: int, sn: bool = True,
          bias: bool = True) -> None:
    if sn:
        out[f"{prefix}.parametrizations.weight.original"] = ((cout, cin, k, k), "weight")
        out[f"{prefix}.parametrizations.weight.0._u"] = ((cout,), "sn_u")
        out[f"{prefix}.parametrizations.weight.0._v"] = ((cin * k * k,), "sn_v")
    else:
        out[f"{prefix}.weight"] = ((cout, cin, k, k), "weight")
    if bias:
        out[f"{prefix}.bias"] = ((cout,), "bias")


def _bn(out: Schema, prefix: str, c: int) -> None:
    out[f"{prefix}.weight"] = ((c,), "bn_weight")
    out[f"{prefix}.bias"] = ((c,), "bn_bias")
    out[f"{prefix}.running_mean"] = ((c,), "bn_mean")
    out[f"{prefix}.running_var"] = ((c,), "bn_var")
    out[f"{prefix}.num_batches_tracked"] = ((), "count")


def _dblock(out: Schema, prefix: str, cin: int, cout: int) -> None:
    _conv(out, f"{prefix}.conv_1x1", cin, cout, 1)
    _conv(out, f"{prefix}.first_conv_3x3", cin, cout, 3)
    _conv(out, f"{prefix}.last_conv_3x3", cout, cout, 3)


def _lblock(out: Schema, prefix: str, cin: int, cout: int) -> None:
    if cin < cout:
        _conv(out, f"{prefix}.conv_1x1", cin, cout - cin, 1, sn=False)
    _conv(out, f"{prefix}.first_conv_3x3", cin, cout, 3, sn=False)
    _conv(out, f"{prefix}.last_conv_3x3", cout, cout, 3, sn=False)


def _gblock(out: Schema, prefix: str, cin: int, cout: int) -> None:
    _conv(out, f"{prefix}.conv_1x1", cin, cout, 1)
    _bn(out, f"{prefix}.bn1", cin)
    _conv(out, f"{prefix}.first_conv_3x3", cin, cin, 3)
    _bn(out, f"{prefix}.bn2", cin)
    _conv(out, f"{prefix}.last_conv_3x3", cin, cout, 3)


def generator_schema(cfg: Mapping) -> Schema:
    """Every tensor of the generator (context stack, latent stack, sampler) for a config dict."""
    ic, oc = cfg["input_channels"], cfg["context_channels"]
    lc = cfg["latent_channels"]
    out: Schema = {}
    ctx = "conditioning_stack"
    widths = [4 * ic] + [((oc * m // 4) * ic) // CONTEXT_STEPS for m in (1, 2, 4, 8)]
    for i in range(4):
        _dblock(out, f"{ctx}.d{i + 1}", widths[i], widths[i + 1])
    for i, m in enumerate((1, 2, 4, 8)):
        cin = (oc * m // 4) * ic
        _conv(out, f"{ctx}.conv{i + 1}", cin, cin // 2, 3)

    lat = "latent_stack"
    zc = 8 * ic
    _conv(out, f"{lat}.conv_3x3", zc, zc, 3)
    _lblock(out, f"{lat}.l_block1", zc, lc // 32)
    _lblock(out, f"{lat}.l_block2", lc // 32, lc // 16)
    _lblock(out, f"{lat}.l_block3", lc // 16, lc // 4)
    att, c = f"{lat}.att_block", lc // 4
    out[f"{att}.gamma"] = ((1,), "gamma")
    for name in ("query", "key", "value"):
        _conv(out, f"{att}.{name}", c, c // 8, 1, sn=False, bias=False)
    _conv(out, f"{att}.last_conv", c // 8, c, 1, sn=False, bias=False)
    _lblock(out, f"{lat}.l_block4", lc // 4, lc)

    suffixes = ("", "_2", "_3", "_4")
    for i in range(4):
        div = 2**i
        cl, cc = lc // div, oc // div
        for gate in ("read_gate_conv", "update_gate_conv", "output_conv"):
            _conv(out, f"sampler.convGRU{i + 1}.cell.{gate}", cl + cc, cc, 3)
        _conv(out, f"sampler.gru_conv_1x1{suffixes[i]}", cc, cl, 1)
        _gblock(out, f"sampler.g{i + 1}", cl, cl)
        _gblock(out, f"sampler.up_g{i + 1}", cl, cl // 2)
    _bn(out, "sampler.bn", lc // 16)
    _conv(out, "sampler.conv_1x1", lc // 16, 4, 1)
    return out
