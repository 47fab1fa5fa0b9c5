"""The check that a run loaded nothing of JAX or of the JAX package."""

from __future__ import annotations

from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "skillful_nowcasting_tpu")


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The module names whose top-level name (before the first dot) is forbidden, compared whole."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
