"""Convolutional GRU (port of ``skillful_nowcasting_tpu/layers/convgru.py``).

A cell of three spectrally normalized 3x3 convs (read gate, update gate,
candidate) over the channel concat ``[x; h]``:

    r = sigmoid(conv_r([x; h]));  u = sigmoid(conv_u([x; h]))
    c = relu(conv_c([x; r * h]));  h' = u * h + (1 - u) * c

:class:`ConvGRU` splits each gate conv into its input part and its hidden
part (the conv is linear over the concat). The input parts of all steps run
up front as one fused 3C-output ``F.conv2d`` (once only for a static input);
the hidden parts run inside :func:`~skillful_nowcasting_tpu_torch.ops.convgru_rollout`,
which launches the hand-written kernel for CUDA tensors. Train mode runs a
plain step loop instead, with per-step spectral norm: the kernel has no
backward, and the JAX package does not use its kernel in training either.

Under a space layout (``space=``) ``h0`` and ``x`` are this rank's stripes
of an H-sharded field. The train loop then runs every gate conv of every
step through the halo (``space.conv``). In eval the rollout kernel runs
once on a window of ``2 T + 1`` rows a side (clipped to the field). The rows a
window's inner edge spoils spread 2 rows a step (each step's two dependent
3x3 convs on ``h``; the input-part conv's 1 row lies inside them), so after
T steps 2 T rows are wrong and the stripe is exact with a row to spare. At
small levels the window is the whole level, recomputed on every rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv2d, convgru_rollout


class ConvGRUCell(nn.Module):
    """Single ConvGRU step on NCHW inputs.

    ``input_channels`` is the total concatenated channel count (x + h), as in
    the reference.
    """

    def __init__(
        self, input_channels: int, output_channels: int, kernel_size: int = 3, sn_eps: float = 1e-4
    ):
        super().__init__()
        self.input_channels = input_channels
        self.output_channels = output_channels
        pad = (kernel_size - 1) // 2
        for name in ("read_gate_conv", "update_gate_conv", "output_conv"):
            conv = conv2d(
                input_channels, output_channels, kernel_size, padding=pad,
                spectral_norm=True, sn_eps=sn_eps,
            )
            setattr(self, name, conv)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step; returns ``(out, new_state)`` like the reference (both the same tensor)."""
        xh = torch.cat([x, h], dim=1)
        read = torch.sigmoid(self.read_gate_conv(xh))
        update = torch.sigmoid(self.update_gate_conv(xh))
        c = torch.relu(self.output_conv(torch.cat([x, read * h], dim=1)))
        out = update * h + (1.0 - update) * c
        return out, out


class ConvGRU(nn.Module):
    """Unrolls a shared :class:`ConvGRUCell` over time.

    Input sequence ``(T, B, Cx, H, W)`` (or ``(B, Cx, H, W)`` with
    ``x_static=True``, every step receiving the same tensor), initial hidden
    state ``(B, Ch, H, W)``; returns the stacked states ``(T, B, Ch, H, W)``.
    With ``space=`` the state, the output and a sequence input are this
    rank's stripes; a static input is whole on every rank (the latent).
    """

    def __init__(
        self, input_channels: int, output_channels: int, kernel_size: int = 3, sn_eps: float = 1e-4
    ):
        super().__init__()
        if kernel_size != 3:
            raise ValueError("ConvGRU's rollout takes 3x3 gate convs only")
        self.input_channels = input_channels
        self.output_channels = output_channels
        self.cell = ConvGRUCell(input_channels, output_channels, kernel_size, sn_eps)

    def forward(
        self,
        x_seq: torch.Tensor,
        hidden_state: torch.Tensor,
        n_steps: Optional[int] = None,
        x_static: bool = False,
        space=None,
    ) -> torch.Tensor:
        if x_static and n_steps is None:
            raise ValueError("x_static requires n_steps")
        if self.training:
            return self._train_forward(x_seq, hidden_state, n_steps, x_static, space)
        if space is None:
            return self._rollout(x_seq, hidden_state, n_steps, x_static)
        rows = 2 * (n_steps if x_static else x_seq.shape[0]) + 1
        h0, top, bottom = space.window(hidden_state, rows)
        if x_static:  # whole on every rank: cut the window's rows, nothing is sent
            lo = space.rank * hidden_state.shape[-2] - top
            x_seq = x_seq[..., lo:lo + h0.shape[-2], :]
        else:
            x_seq, _, _ = space.window(x_seq, rows)
        out = self._rollout(x_seq, h0, n_steps, x_static)
        return out[..., top:out.shape[-2] - bottom, :]

    def _rollout(self, x_seq, hidden_state, n_steps, x_static):
        """Eval: the input-part conv, then one rollout kernel launch."""
        cell = self.cell
        xc = self.input_channels - self.output_channels
        # Spectral norm is applied by .weight (eval: constant across steps),
        # in the parameters' dtype; compute follows x's (as in JAX): the
        # kernels, biases and h0 are cast to it, so bf16 runs the bf16 kernel.
        dtype = x_seq.dtype
        convs = (cell.read_gate_conv, cell.update_gate_conv, cell.output_conv)
        kr, ku, kc = (conv.weight.to(dtype) for conv in convs)
        bias = torch.cat([conv.bias for conv in convs]).to(dtype)
        hidden_state = hidden_state.to(dtype)

        # Input parts of all three gates as one conv, batched over every step.
        gx = _input_part(x_seq, torch.cat([kr[:, :xc], ku[:, :xc], kc[:, :xc]]), x_static)
        if x_static:
            gx = gx[None]

        # The rollout takes the JAX layouts: NHWC activations, HWIO kernels.
        to_hwio = lambda w: w.permute(2, 3, 1, 0).contiguous()  # noqa: E731
        out = convgru_rollout(
            gx.permute(0, 1, 3, 4, 2).contiguous(),
            hidden_state.permute(0, 2, 3, 1).contiguous(),
            to_hwio(torch.cat([kr[:, xc:], ku[:, xc:]])),
            to_hwio(kc[:, xc:]),
            bias.contiguous(),
            n_steps=n_steps,
        )
        return out.permute(0, 1, 4, 2, 3)  # (T, B, C, H, W)

    def _train_forward(self, x_seq, hidden_state, n_steps, x_static, space=None):
        """Train mode (``layers/convgru.py:199-270`` in JAX): a plain step loop, never the kernel.

        Each step is one train forward of the cell: every gate conv runs one
        power iteration and step ``t`` divides by its own ``sigma_t``. The
        iterations do not depend on ``h``, so each conv's ``T`` sigmas are
        taken up front. The input parts run batched over all steps with the
        raw kernels; autograd runs through the whole loop. The convs and gates
        run in ``x_seq``'s dtype (the power iterations stay in the
        parameters'), as in JAX. Under ``space`` the convs exchange their
        halos; a static input, whole on every rank (the latent), has its input
        part computed whole and cut to this rank's rows, so the gradient of the
        cut reaches every rank's copy of it.
        """
        cell = self.cell
        xc, c = self.input_channels - self.output_channels, self.output_channels
        t = n_steps if x_static else x_seq.shape[0]
        dtype = x_seq.dtype
        convs = (cell.read_gate_conv, cell.update_gate_conv, cell.output_conv)
        raw = [conv.parametrizations.weight.original for conv in convs]
        sig_r, sig_u, sig_c = (
            conv.parametrizations.weight[0].advance(k, t).to(dtype) for conv, k in zip(convs, raw)
        )
        kr, ku, kc = (k.to(dtype) for k in raw)
        br, bu, bc = (conv.bias.to(dtype).view(-1, 1, 1) for conv in convs)
        k_x = torch.cat([kr[:, :xc], ku[:, :xc], kc[:, :xc]])
        if space is None:
            conv = lambda x, k: F.conv2d(x, k, padding=1)  # noqa: E731
        else:
            conv = space.conv
        if x_static:
            gx = _input_part(x_seq, k_x, True)
            if space is not None:  # whole on every rank: this rank's rows
                rows = hidden_state.shape[-2]
                gx = gx[..., space.rank * rows:(space.rank + 1) * rows, :]
        else:
            gx = conv(x_seq.flatten(0, 1), k_x).unflatten(0, x_seq.shape[:2])
        k_ru = torch.cat([kr[:, xc:], ku[:, xc:]])
        h, outs = hidden_state.to(dtype), []
        for step in range(t):
            g = gx if x_static else gx[step]
            gh = conv(h, k_ru)
            read = torch.sigmoid((g[:, :c] + gh[:, :c]) / sig_r[step] + br)
            update = torch.sigmoid((g[:, c : 2 * c] + gh[:, c:]) / sig_u[step] + bu)
            cand = conv(read * h, kc[:, xc:])
            cand = torch.relu((g[:, 2 * c :] + cand) / sig_c[step] + bc)
            h = update * h + (1.0 - update) * cand
            outs.append(h)
        return torch.stack(outs)


def _input_part(x_seq: torch.Tensor, k_x: torch.Tensor, x_static: bool) -> torch.Tensor:
    """The gates' input-part conv: once for a static ``(B, Cx, H, W)``, else over all T steps."""
    if x_static:
        return F.conv2d(x_seq, k_x, padding=1)
    return F.conv2d(x_seq.flatten(0, 1), k_x, padding=1).unflatten(0, x_seq.shape[:2])
