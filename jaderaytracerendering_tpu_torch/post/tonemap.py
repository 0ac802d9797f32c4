"""Tone mapping and quantization (host NumPy, on the mean film).

The JAX package's post/tonemap.py as its CLI runs it (on NumPy), so equal
films give byte-equal images in both packages:

- ACES filmic with the reference's constants 2.51/0.03/2.43/0.59/0.14
  (PathTrace.cu:674-682);
- luminance Reinhard with limit 1.5 and weights (0.3, 0.6, 0.1)
  (pass3.fsh:8-11);
- gamma 2.2 and the *255 clamp-to-u8 quantize (PathTrace.cu:1464-1473).
"""

from __future__ import annotations

import numpy as np

from ..utils.logging import span


def aces(color: np.ndarray) -> np.ndarray:
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return (color * (color * a + b)) / (color * (color * c + d) + e)


def reinhard_luminance(color: np.ndarray, limit: float = 1.5) -> np.ndarray:
    lum = 0.3 * color[..., 0] + 0.6 * color[..., 1] + 0.1 * color[..., 2]
    return color * (1.0 / (1.0 + lum / limit))[..., None]


def gamma(color: np.ndarray, g: float = 2.2) -> np.ndarray:
    return np.maximum(color, 0.0) ** (1.0 / g)


def tonemap(color: np.ndarray, mode: str = "aces") -> np.ndarray:
    if mode == "aces":
        return aces(color)
    if mode == "reinhard":
        return reinhard_luminance(color)
    if mode == "none":
        return color
    raise ValueError(f"unknown tonemap {mode!r}")


def quantize_u8(color: np.ndarray) -> np.ndarray:
    return np.clip(color * 255.0, 0.0, 255.0).astype(np.uint8)


def finalize(radiance: np.ndarray, mode: str = "aces", g: float = 2.2) -> np.ndarray:
    """Mean radiance [H, W, 3] f32 -> display u8 RGB [H, W, 3]. Under a
    profiler the call is the span ``post.tonemap.finalize``
    (utils/logging.py), which ``tonemap_ms`` reads."""
    with span("post.tonemap.finalize"):
        return quantize_u8(gamma(tonemap(np.asarray(radiance, np.float32), mode), g))
