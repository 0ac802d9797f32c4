"""Tone mapping and quantization of the mean film: display u8.

The JAX package's post/tonemap.py as its CLI runs it (on NumPy); on the
NumPy path equal films give byte-equal images in both packages:

- ACES filmic with the reference's constants 2.51/0.03/2.43/0.59/0.14
  (PathTrace.cu:674-682);
- luminance Reinhard with limit 1.5 and weights (0.3, 0.6, 0.1)
  (pass3.fsh:8-11);
- gamma 2.2 and the *255 clamp-to-u8 quantize (PathTrace.cu:1464-1473).

Where ``finalize`` runs follows its input: a CUDA tensor, or a host array
in a process that has a CUDA device, is finished on the card by the postfx
kernel (``ops/postfx.py``, sample count 1, since the input is already the
mean); a CPU tensor, or a host array in a process without a CUDA device,
by the NumPy functions below. A CUDA tensor or host array whose shape is
not [H, W, 3] is refused by postfx, not sent to NumPy. Both paths make
the same float32 operations in the same order, but the card's ``powf``
and NumPy's ``pow`` may round a value's last bit apart, which moves its
u8 by one level where the value x255 lies that close to a whole number
(about one channel in a million of an HDR film). So byte equality with
the JAX package holds on the NumPy path only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import postfx
from ..utils import logging


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


# The card path's four buffers (host staging, device radiance, device u8,
# host u8), one of each kind, kept while the image's shape holds, so that
# no image after the first pays a pinned allocation.
_BUFFERS: dict = {}  # (dtype, device or None for pinned host memory) -> tensor


def _buffer(shape: tuple, dtype, device) -> torch.Tensor:
    """The kept buffer of ``dtype`` on ``device`` (pinned host memory
    where None), made anew where its shape is not ``shape``."""
    buf = _BUFFERS.get((dtype, device))
    if buf is None or tuple(buf.shape) != shape:
        buf = _BUFFERS[(dtype, device)] = (
            torch.empty(shape, dtype=dtype, pin_memory=True) if device is None
            else torch.empty(shape, dtype=dtype, device=device))
    return buf


def _finalize_card(radiance, mode: str, g: float, flip: bool) -> np.ndarray:
    """The card path of ``finalize``: a host array goes through a pinned
    staging copy to the card; one postfx launch; the u8 image comes back
    through pinned memory and is returned as a fresh array (the buffers
    serve the next image)."""
    if isinstance(radiance, torch.Tensor):
        rad = radiance.to(torch.float32).contiguous()
        device = rad.device
    else:
        device = torch.device("cuda", torch.cuda.current_device())
        staging = _buffer(radiance.shape, torch.float32, None)
        np.copyto(staging.numpy(), radiance, casting="unsafe")  # any strides
        rad = _buffer(radiance.shape, torch.float32, device)
        rad.copy_(staging, non_blocking=True)
    shape = tuple(rad.shape)
    out = postfx.postfx(rad, 1, mode, g, flip=flip, out=_buffer(shape, torch.uint8, device))
    host = _buffer(shape, torch.uint8, None)
    host.copy_(out, non_blocking=True)
    torch.cuda.current_stream(device).synchronize()
    logging.count("post.tonemap.card_images", 1)
    return host.numpy().copy()


def finalize(radiance, mode: str = "aces", g: float = 2.2, flip: bool = False) -> np.ndarray:
    """Mean radiance [H, W, 3] (a float array, or a tensor) -> display u8
    RGB [H, W, 3], a NumPy array of its own; ``flip`` writes row y to row
    H-1-y (a film's row 0 is the bottom of the scene). On the card or in
    NumPy as the module docstring says. Under a profiler the call is the
    span ``post.tonemap.finalize`` (utils/logging.py), which ``tonemap_ms``
    reads; each image finished on the card adds one to the counter
    ``post.tonemap.card_images``."""
    with logging.span("post.tonemap.finalize"):
        if isinstance(radiance, torch.Tensor):
            on_card = radiance.device.type == "cuda"
        else:
            radiance = np.asarray(radiance)
            on_card = torch.cuda.is_available()
        if on_card:  # postfx raises on a shape that is not [H, W, 3]
            return _finalize_card(radiance, mode, g, flip)
        if isinstance(radiance, torch.Tensor):
            radiance = radiance.numpy()
        color = np.asarray(radiance, np.float32)
        return quantize_u8(gamma(tonemap(color[::-1] if flip else color, mode), g))
