"""Seeded weights in the reference state-dict schema, made on the device in one draw.

Every float tensor of the schema is cut from one ``torch.randn`` call on a
``torch.Generator`` of the run's device, then scaled as the port's own
initialiser scales it (``utils/init.py``: convs He-scaled, ``N(0, 2 /
fan_in)``), with what that initialiser leaves at a constant made non-trivial,
so that the eval path's folds and the attention do real work: biases
``0.05 N``, BatchNorm scale ``1 + 0.1 N``, shift and running mean ``0.05 N``,
running variance ``exp(0.1 N)``, the attention's ``gamma`` 0.5. Each
spectral norm's ``(u, v)`` starts from its slice of the draw and takes 15
power iterations on its weight, so ``sigma`` is a genuine top singular
value, as the port's initialiser does.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..reference.schema import Schema

POWER_ITERATIONS = 15
SN_SUFFIX = ".parametrizations.weight.original"


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x), min=1e-12)


@torch.no_grad()
def make_state_dict(schema: Schema, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of ``schema`` drawn from ``seed`` on ``device`` (float32, counts int64)."""
    device = torch.device(device)
    floats = [(k, shape, kind) for k, (shape, kind) in schema.items() if kind != "count"]
    total = sum(math.prod(shape) for _, shape, _ in floats)
    gen = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    sd: Dict[str, torch.Tensor] = {}
    at = 0
    for key, shape, kind in floats:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if kind == "weight":
            t = t * math.sqrt(2.0 / math.prod(shape[1:]))
        elif kind in ("bias", "bn_bias", "bn_mean"):
            t = 0.05 * t
        elif kind == "bn_weight":
            t = 1.0 + 0.1 * t
        elif kind == "bn_var":
            t = torch.exp(0.1 * t)
        elif kind == "gamma":
            t = torch.full_like(t, 0.5)
        elif kind in ("sn_u", "sn_v"):
            t = _normalize(t)
        else:
            raise ValueError(f"{key}: unknown kind {kind!r}")
        sd[key] = t.contiguous()
    for key, (shape, kind) in schema.items():
        if kind == "count":
            sd[key] = torch.zeros(shape, dtype=torch.int64, device=device)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for key in [k for k in sd if k.endswith(SN_SUFFIX)]:
            prefix = key[: -len(".original")]
            wm = sd[key].reshape(sd[key].shape[0], -1)
            u, v = sd[f"{prefix}.0._u"], sd[f"{prefix}.0._v"]
            for _ in range(POWER_ITERATIONS):
                u = _normalize(wm @ v)
                v = _normalize(wm.T @ u)
            sd[f"{prefix}.0._u"], sd[f"{prefix}.0._v"] = u.contiguous(), v.contiguous()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return sd
