"""Ensemble generation (port of ``skillful_nowcasting_tpu/inference.py:make_generate``)."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .models.common import draw_latents


def make_generate(
    model,
    num_samples: Optional[int] = None,
    shared_context: bool = False,
    microbatch: Optional[int] = None,
) -> Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]:
    """Ensemble generation: ``generate(x, generator) -> (S, B, T, C, H, W)``.

    Each of the S samples draws one batch-1 latent from ``generator``, shared
    by every batch element (quirk Q2). ``shared_context=True`` runs the
    conditioning stack once and folds the S samples into the sampler's batch
    (``generate_ensemble``); otherwise each sample is its own forward. Both
    give the same result for the same latents.

    ``microbatch`` caps the conv batch of one forward (``S * chunk`` with
    ``shared_context``, ``chunk`` otherwise): the batch is split into chunks
    that all reuse each sample's latent, so the result equals the unchunked
    one. ``None`` runs the whole batch at once. The model must be in eval mode.
    """
    n = num_samples if num_samples is not None else model.num_samples
    if microbatch is None:
        cap = None
    else:
        cap = max(1, microbatch // n) if shared_context else microbatch

    def one_chunk(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        if shared_context:
            return model.generate_ensemble(x, n, z=z)
        return torch.stack([model(x, z=z[s : s + 1]) for s in range(n)])

    @torch.inference_mode()
    def generate(x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        z = draw_latents(model.latent_stack.shape, n, generator, x)
        chunks = [x] if cap is None else x.split(cap)
        return torch.cat([one_chunk(xc, z) for xc in chunks], dim=1)

    return generate
