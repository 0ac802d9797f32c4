"""Display of a film: ACES with the reference's constants
2.51/0.03/2.43/0.59/0.14 (PathTrace.cu:674-682), gamma 2.2, and the *255
clamp to u8 (PathTrace.cu:1464-1473)."""

from __future__ import annotations

import numpy as np
import torch


def finalize(mean: np.ndarray) -> np.ndarray:
    """The offline image: mean radiance [..., 3] float32 -> u8 (NumPy)."""
    c = np.asarray(mean, np.float32)
    c = (c * (c * 2.51 + 0.03)) / (c * (c * 2.43 + 0.59) + 0.14)
    c = np.maximum(c, 0.0) ** (1.0 / 2.2)
    return np.clip(c * 255.0, 0.0, 255.0).astype(np.uint8)


def display(sums: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The preview's display of radiance sums [P, 3] over ``counts`` [P]
    samples: ``sum * (1 / max(count, 1))``, ACES, gamma, u8."""
    inv = torch.reciprocal(torch.clamp_min(counts.to(sums.dtype), 1.0))[:, None]
    c = sums * inv
    c = (c * (c * 2.51 + 0.03)) / (c * (c * 2.43 + 0.59) + 0.14)
    c = torch.clamp(torch.pow(torch.clamp_min(c, 0.0), 1.0 / 2.2) * 255.0, 0.0, 255.0)
    return c.to(torch.int32).to(torch.uint8)
