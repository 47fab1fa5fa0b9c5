"""Plain PyTorch reference of the DGMR generator in eval mode, written from the published model.

Ravuri et al., Nature 597 (2021), as openclimatefix/skillful_nowcasting
implements it, with its quirks kept (the latent has batch 1 and is shared by
the batch; the attention treats (channel, row) pairs as tokens and the width
as features; the sampler's levels run smallest first). Weights come as a
reference-schema state dict (:mod:`.schema`); every derived weight
(spectral norm ``W / (u . W v)``, BatchNorm's affine) is worked out here from
the raw tensors. There is no kernel, fold, cache or batching trick: every
layer is ``F.conv2d`` and elementwise ops, the ConvGRU a step loop, each
block applied as the paper writes it.

Arithmetic is float32. :class:`Numerics` says how operands enter a conv or a
matmul: ``"f32"`` (TF32 off, the reference itself), ``"tf32"`` (operands
rounded to TF32's 10-bit mantissa and the TF32 flags on: the control of a
float32 configuration, the same on the CPU as on the card), ``"fp8"``
(operands rounded to float8 e4m3 with a per-tensor scale: the control of a
bfloat16 one).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
FP8_MAX = 448.0  # largest finite float8_e4m3fn


class Numerics:
    """The precision of conv and matmul operands; a context manager for the TF32 flags."""

    KINDS = ("f32", "tf32", "fp8")

    def __init__(self, kind: str = "f32"):
        if kind not in self.KINDS:
            raise ValueError(f"unknown numerics {kind!r}; one of {self.KINDS}")
        self.kind = kind

    def __enter__(self):
        self._saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        tf32 = self.kind == "tf32"
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        return self

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self._saved
        return False

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as it enters a conv or matmul."""
        if self.kind == "tf32":  # round to nearest even at 10 mantissa bits
            bits = t.contiguous().view(torch.int32)
            bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
            return bits.view(torch.float32)
        if self.kind == "fp8":
            scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
            return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
        return t


def _sn_weight(sd: Mapping[str, torch.Tensor], prefix: str) -> torch.Tensor:
    w = sd[f"{prefix}.parametrizations.weight.original"].float()
    u = sd[f"{prefix}.parametrizations.weight.0._u"].float()
    v = sd[f"{prefix}.parametrizations.weight.0._v"].float()
    wm = w.reshape(w.shape[0], -1)
    sigma = (u * (wm * v).sum(dim=1)).sum()  # u . (W v), as elementwise products: no TF32
    return w / sigma


class Reference:
    """The generator of one state dict: ``context``, ``latent`` and ``sampler``, each plain."""

    def __init__(self, sd: Mapping[str, torch.Tensor], forecast_steps: int,
                 numerics: Numerics | None = None):
        self.sd = sd
        self.steps = forecast_steps
        self.num = numerics or Numerics("f32")

    # -- layers ---------------------------------------------------------------------------
    def conv(self, x: torch.Tensor, prefix: str, sn: bool = True) -> torch.Tensor:
        w = _sn_weight(self.sd, prefix) if sn else self.sd[f"{prefix}.weight"].float()
        b = self.sd.get(f"{prefix}.bias")
        pad = (w.shape[-1] - 1) // 2
        op = self.num.operand
        return F.conv2d(op(x), op(w), None if b is None else b.float(), padding=pad)

    def bn(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        sd = self.sd
        mean, var = sd[f"{prefix}.running_mean"].float(), sd[f"{prefix}.running_var"].float()
        w, b = sd[f"{prefix}.weight"].float(), sd[f"{prefix}.bias"].float()
        col = lambda t: t.view(1, -1, 1, 1)  # noqa: E731
        return (x - col(mean)) / torch.sqrt(col(var) + BN_EPS) * col(w) + col(b)

    def dblock(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        """Downsampling residual block: 1x1 shortcut (when widths differ), both halves pooled."""
        cout = self.sd[f"{prefix}.last_conv_3x3.parametrizations.weight.original"].shape[0]
        sc = x
        if x.shape[1] != cout:
            sc = F.avg_pool2d(self.conv(x, f"{prefix}.conv_1x1"), 2)
        h = self.conv(torch.relu(x), f"{prefix}.first_conv_3x3")
        h = self.conv(torch.relu(h), f"{prefix}.last_conv_3x3")
        return sc + F.avg_pool2d(h, 2)

    def lblock(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        sc = x
        if f"{prefix}.conv_1x1.weight" in self.sd:
            sc = torch.cat([x, self.conv(x, f"{prefix}.conv_1x1", sn=False)], dim=1)
        h = self.conv(torch.relu(x), f"{prefix}.first_conv_3x3", sn=False)
        h = self.conv(torch.relu(h), f"{prefix}.last_conv_3x3", sn=False)
        return h + sc

    def gblock(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        """Same-resolution residual block; its shortcut is the identity at equal widths."""
        cout = self.sd[f"{prefix}.last_conv_3x3.parametrizations.weight.original"].shape[0]
        sc = x if x.shape[1] == cout else self.conv(x, f"{prefix}.conv_1x1")
        h = self.conv(torch.relu(self.bn(x, f"{prefix}.bn1")), f"{prefix}.first_conv_3x3")
        h = self.conv(torch.relu(self.bn(h, f"{prefix}.bn2")), f"{prefix}.last_conv_3x3")
        return h + sc

    def upsample_gblock(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        up = lambda t: t.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)  # noqa: E731
        sc = self.conv(up(x), f"{prefix}.conv_1x1")
        h = self.conv(up(torch.relu(self.bn(x, f"{prefix}.bn1"))), f"{prefix}.first_conv_3x3")
        h = self.conv(torch.relu(self.bn(h, f"{prefix}.bn2")), f"{prefix}.last_conv_3x3")
        return h + sc

    def attention(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        """The published attention: per batch element, tokens are (channel, row) pairs."""
        q, k, v = (self.conv(x, f"{prefix}.{n}", sn=False) for n in ("query", "key", "value"))
        op = self.num.operand
        outs = []
        for b in range(x.shape[0]):
            c, h, w = q[b].shape
            keys = k[b].reshape(c * h, w)  # (L, w), L = c' * H + h'
            vals = v[b].reshape(v.shape[1] * h, w)
            logits = op(q[b].reshape(c * h, w)) @ op(keys).T  # (c*h, L)
            beta = torch.softmax(logits, dim=-1)
            outs.append((op(beta) @ op(vals)).reshape(c, h, w))
        out = self.conv(torch.stack(outs), f"{prefix}.last_conv", sn=False)
        return self.sd[f"{prefix}.gamma"].float() * out + x

    def gru(self, x_seq: Sequence[torch.Tensor], h: torch.Tensor, prefix: str) -> torch.Tensor:
        """ConvGRU over ``self.steps`` steps, ``x_seq[t]`` step t's input: ``(T, B, C, H, W)``."""
        outs = []
        for t in range(self.steps):
            x = x_seq[t]
            xh = torch.cat([x, h], dim=1)
            read = torch.sigmoid(self.conv(xh, f"{prefix}.read_gate_conv"))
            update = torch.sigmoid(self.conv(xh, f"{prefix}.update_gate_conv"))
            cand = torch.relu(self.conv(torch.cat([x, read * h], dim=1), f"{prefix}.output_conv"))
            h = update * h + (1.0 - update) * cand
            outs.append(h)
        return torch.stack(outs)

    # -- stacks ---------------------------------------------------------------------------
    def context(self, x: torch.Tensor) -> list:
        """Context frames ``(B, 4, C, H, W)`` -> four states, largest first."""
        steps = x.shape[1]
        per_step = [[] for _ in range(4)]
        for t in range(steps):
            h = F.pixel_unshuffle(x[:, t].float(), 2)
            for i in range(4):
                h = self.dblock(h, f"conditioning_stack.d{i + 1}")
                per_step[i].append(h)
        states = []
        for i in range(4):
            s = torch.stack(per_step[i], dim=2)  # (B, c, T, h, w): channels ordered (c, t)
            s = s.flatten(1, 2)
            states.append(torch.relu(self.conv(s, f"conditioning_stack.conv{i + 1}")))
        return states

    def latent(self, z: torch.Tensor) -> torch.Tensor:
        """A latent draw ``(1, 8C, h, w)`` -> ``(1, latent_channels, h, w)``."""
        p = "latent_stack"
        h = self.conv(z.float(), f"{p}.conv_3x3")
        for i in (1, 2, 3):
            h = self.lblock(h, f"{p}.l_block{i}")
        return self.lblock(self.attention(h, f"{p}.att_block"), f"{p}.l_block4")

    def sampler(self, states: list, latent: torch.Tensor) -> torch.Tensor:
        """Four states and a batch-1 latent -> the nowcast ``(B, T, 4C/4, 2H', 2W')``."""
        b = states[0].shape[0]
        hidden = latent.expand(b, -1, -1, -1)
        seq = [hidden] * self.steps  # the bottom level sees the latent at every step
        suffixes = ("", "_2", "_3", "_4")
        for i in range(4):
            out = self.gru(seq, states[3 - i], f"sampler.convGRU{i + 1}.cell")
            t = out.shape[0]
            y = out.flatten(0, 1)  # every block below is per frame
            y = self.conv(y, f"sampler.gru_conv_1x1{suffixes[i]}")
            y = self.gblock(y, f"sampler.g{i + 1}")
            y = self.upsample_gblock(y, f"sampler.up_g{i + 1}")
            seq = y.unflatten(0, (t, b))
        y = torch.relu(self.bn(seq.flatten(0, 1), "sampler.bn"))
        y = F.pixel_shuffle(self.conv(y, "sampler.conv_1x1"), 2)
        return y.unflatten(0, (self.steps, b)).transpose(0, 1)

    @torch.no_grad()
    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """One sample for context ``(B, 4, C, H, W)`` and latent draw ``z`` ``(1, 8C, h, w)``."""
        with self.num:
            return self.sampler(self.context(x), self.latent(z))
