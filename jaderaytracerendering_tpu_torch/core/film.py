"""Film: progressive accumulation state (radiance sum + sample count).

Saved in the JAX package's format (``np.savez`` of ``accum`` [H, W, 3]
f32 and a 0-d int32 ``count``), so film checkpoints cross packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def window_pixels(pix0: int, slots, row_step: int, width: int):
    """The film pixel of each slot (an int, or an int64 tensor of slots)
    of the pixel window from pixel ``pix0``: ``pix0 + slot`` with
    ``row_step`` 1 (a contiguous window); with a larger step the window
    holds whole film rows row0, row0 + row_step, .. (``pix0 = row0 *
    width``), slot j in its row j // width at column j % width. The
    kernels' ``window_pixel`` (csrc/path.cuh)."""
    return pix0 + slots + (slots // width) * ((row_step - 1) * width)


def check_window(width: int, height: int, pix0: int, n_px: int, row_step: int = 1) -> None:
    """Raises ``ValueError`` unless the window of ``n_px`` slots from
    ``pix0`` at ``row_step`` (``window_pixels``) lies in the film, its
    rows whole where ``row_step`` is above 1."""
    npix = width * height
    end = pix0 if n_px <= 0 else window_pixels(pix0, n_px - 1, row_step, width) + 1
    if not (0 <= pix0 and 0 <= n_px and end <= npix and row_step >= 1
            and (row_step == 1 or (pix0 % width == 0 and n_px % width == 0))):
        raise ValueError(f"pixel window of {n_px} slots from {pix0} at row step {row_step} "
                         f"outside the film's {npix} pixels, or not of whole rows")


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
