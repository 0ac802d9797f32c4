"""Scan primitives (the JAX package's ops/scanops.py).

The JAX package computes the pool's fresh-lane cumsum as triangular
matmuls because a length-M scan costs ~log2(M) launches on its TPU
runtime; here it is a plain ``torch.cumsum``. The spawn kernel
(csrc/pool.cu) computes the same inclusive prefix in lane order with a
block scan.
"""

from __future__ import annotations

import torch


def cumsum_indicator(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum of a {0, 1} (or bool) vector [M] -> int64 [M]."""
    return torch.cumsum(x.to(torch.int64), dim=0)
