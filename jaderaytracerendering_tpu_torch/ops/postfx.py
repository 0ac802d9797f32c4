"""The display step: the CUDA kernel ``postfx`` (csrc/postfx.cu) and its
plain version.

Replaces the JAX package's ops/pallas/postfx.py ``postfx`` (->
``_postfx_kernel``): a film's radiance sums [H, W, 3] f32 and a sample
count -> display u8 [H, W, 3]: ``c = sum * (1 / max(count, 1))``, ACES or
luminance Reinhard (``limit``) or none, ``max(c, 0) ** (1 / g)``, x255,
clamped to [0, 255], truncated to u8. Three options serve the preview's
display: ``flip`` writes film row y to display row H-1-y (film row 0 is
the bottom of the scene, as ``render.py``'s display flips it); ``span`` =
(p0, p1) maps only the film's flat pixels p0 .. p1-1 into ``out``; and
``split`` with ``count_hi`` divides the pixels from ``split`` on by
``count_hi`` instead of ``count``, so that a banded frame, whose pixels
carry two sample counts, is one call.

CUDA tensors launch the kernel (one launch per call, counted in
``LAUNCHES["postfx"]``); CPU tensors run the plain version.
"""

from __future__ import annotations

import torch

from ..core.vecmath import div
from ..utils import logging
from . import kernels
from .kernels import LAUNCHES

MODES = {"aces": 0, "reinhard": 1, "none": 2}


def _prepare(accum, mode, span, out, split, count_hi):
    if mode not in MODES:
        raise ValueError(f"unknown tonemap {mode!r}")
    h, w, _ = accum.shape
    p0, p1 = span if span is not None else (0, h * w)
    if not 0 <= p0 <= p1 <= h * w:
        raise ValueError(f"span {span} outside the film's {h * w} pixels")
    if (split is None) != (count_hi is None):
        raise ValueError("split and count_hi go together")
    split = p1 if split is None else split
    if not p0 <= split <= p1:
        raise ValueError(f"split {split} outside the span ({p0}, {p1})")
    if out is None:  # pixels outside the span read 0
        alloc = torch.empty if (p0, p1) == (0, h * w) else torch.zeros
        out = alloc((h, w, 3), dtype=torch.uint8, device=accum.device)
    return h, w, p0, split, p1, out


def postfx_plain(accum: torch.Tensor, count, mode: str = "aces", g: float = 2.2,
                 limit: float = 1.5, flip: bool = False, span=None,
                 out: torch.Tensor | None = None, split: int | None = None,
                 count_hi=None) -> torch.Tensor:
    """The plain version (see the module docstring) -> ``out``."""
    h, w, p0, split, p1, out = _prepare(accum, mode, span, out, split, count_hi)
    n = torch.tensor([float(count), float(count if count_hi is None else count_hi)],
                     dtype=torch.float32, device=accum.device)
    inv = torch.reciprocal(torch.clamp_min(n, 1.0))
    a = accum.reshape(-1, 3)
    c = torch.cat([a[p0:split] * inv[0], a[split:p1] * inv[1]])
    if mode == "aces":  # PathTrace.cu:674-682
        c = (c * (c * 2.51 + 0.03)) / (c * (c * 2.43 + 0.59) + 0.14)
    elif mode == "reinhard":  # pass3.fsh:8-11
        lum = 0.3 * c[:, 0:1] + 0.6 * c[:, 1:2] + 0.1 * c[:, 2:3]
        c = c * torch.reciprocal(1.0 + div(lum, limit))
    c = torch.clamp(torch.pow(torch.clamp_min(c, 0.0), 1.0 / g) * 255.0, 0.0, 255.0)
    p = torch.arange(p0, p1, device=accum.device)
    if flip:
        y = torch.div(p, w, rounding_mode="floor")
        p = (h - 1 - y) * w + (p - y * w)
    out.view(-1, 3)[p] = c.to(torch.int32).to(torch.uint8)
    return out


def postfx(accum: torch.Tensor, count, mode: str = "aces", g: float = 2.2,
           limit: float = 1.5, flip: bool = False, span=None,
           out: torch.Tensor | None = None, split: int | None = None,
           count_hi=None) -> torch.Tensor:
    """Radiance sums [H, W, 3] f32 + sample count(s) -> display u8 [H, W,
    3] (see the module docstring). CUDA tensors launch the kernel; CPU
    tensors run the plain version. Under a profiler the call is the span
    ``ops.postfx.postfx`` (utils/logging.py), a child of a preview frame's
    span."""
    with logging.span("ops.postfx.postfx"):
        if accum.device.type == "cpu":
            return postfx_plain(accum, count, mode, g, limit, flip, span, out, split, count_hi)
        h, w, p0, split, p1, out = _prepare(accum, mode, span, out, split, count_hi)
        kernels.check_tensor("accum", accum, torch.float32, (h, w, 3), accum.device)
        kernels.check_tensor("out", out, torch.uint8, (h, w, 3), accum.device)
        rc = kernels.library().postfx(
            kernels.ptr(accum), kernels.ptr(out), w, h, p0, split, p1, float(count),
            float(count if count_hi is None else count_hi), MODES[mode], 1.0 / g,
            float(limit), int(flip), kernels.stream(accum.device))
        kernels.check_rc(rc, "postfx")
        LAUNCHES["postfx"] += 1
        return out
