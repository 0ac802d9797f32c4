"""Everything a run draws comes from its ``--seed`` through these two
functions: a 31-bit render seed for one image or one preview run, and a
NumPy generator for the harness's own draws (pixels and images to
compare, camera commands), each keyed by what it is for."""

from __future__ import annotations

import hashlib

import numpy as np


def derive(seed: int, *keys) -> int:
    """A 31-bit number from ``seed`` and ``keys`` (any whole number for
    ``seed``, also past 2**32)."""
    text = ":".join(str(k) for k in (int(seed), *keys)).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=4).digest(), "little") & 0x7FFFFFFF


def rng(seed: int, *keys) -> np.random.Generator:
    return np.random.default_rng(derive(seed, "rng", *keys))
