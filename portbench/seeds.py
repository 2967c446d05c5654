"""Seeds of the inputs a run makes, each derived from ``--seed`` and a tag.

The same ``--seed`` gives the same inputs on both sides of a comparison;
every input has a stream of its own, so adding one never moves another.
``--seed`` is any whole number (larger than 32 bits too).
"""

from __future__ import annotations

import zlib

import numpy as np

__all__ = ["derive", "rng"]


def _words(seed: int, tag: str) -> list:
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"--seed must be a whole number >= 0, got {seed}")
    words = []
    while True:
        words.append(seed & 0xFFFFFFFF)
        seed >>= 32
        if not seed:
            break
    return words + [zlib.crc32(tag.encode())]


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed``."""
    hi, lo = np.random.SeedSequence(_words(seed, tag)).generate_state(
        2, dtype=np.uint32)
    return ((int(hi) << 32) | int(lo)) & (2 ** 63 - 1)


def rng(seed: int, tag: str) -> np.random.Generator:
    """A numpy generator of its own for ``tag``."""
    return np.random.default_rng(np.random.SeedSequence(_words(seed, tag)))
