"""Film: progressive accumulation state (radiance sum + sample count).

Saved in the JAX package's format (``np.savez`` of ``accum`` [H, W, 3]
f32 and a 0-d int32 ``count``), so film checkpoints cross packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Film:
    """Running radiance sum over samples; mean = accum / count."""

    accum: torch.Tensor  # [H, W, 3] float32 radiance sum
    count: int           # samples accumulated per pixel

    @staticmethod
    def create(height: int, width: int, device="cpu") -> "Film":
        return Film(torch.zeros((height, width, 3), dtype=torch.float32,
                                device=device), 0)

    def mean(self) -> torch.Tensor:
        # a true division, as the JAX package's (a scalar divisor would
        # be turned into a reciprocal multiply on CUDA)
        n = torch.full((), float(max(self.count, 1)), dtype=torch.float32,
                       device=self.accum.device)
        return self.accum / n

    def save(self, path: str) -> None:
        np.savez(path, accum=self.accum.detach().cpu().numpy(),
                 count=np.asarray(self.count, np.int32))

    @staticmethod
    def load(path: str, device="cpu") -> "Film":
        data = np.load(path)
        return Film(torch.tensor(data["accum"], dtype=torch.float32,
                                 device=device), int(data["count"]))
