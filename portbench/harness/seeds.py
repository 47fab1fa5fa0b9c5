"""Seeds derived from the run's ``--seed``: one stream per purpose, so each draw stands alone."""

from __future__ import annotations

import zlib

import numpy as np


def derive(seed: int, *keys) -> int:
    """A 63-bit seed for ``keys`` (strings or ints) under ``seed``; ``seed`` may exceed 32 bits."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    for k in keys:
        words.append(zlib.crc32(k.encode()) if isinstance(k, str) else int(k) & 0xFFFFFFFF)
    state = np.random.SeedSequence(words).generate_state(2, dtype=np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def rng(seed: int, *keys) -> np.random.Generator:
    """A numpy generator for ``keys`` under ``seed``."""
    return np.random.default_rng(derive(seed, *keys))
