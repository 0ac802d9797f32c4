"""Equirectangular environment-map sampling (plane form).

The JAX package's scene/envmap.py ``sample_env`` with bilinear filtering
and mirror addressing (the CUDA texture refs, PathTrace.cu:1652-1665),
clamped to ``hdr_clamp`` (PathTrace.cu:700). The uv mapping keeps the
reference's constant 3.1415926 and uses libm ``atan2``/``asin``, as the
CUDA kernel does.
"""

from __future__ import annotations

import torch

from ..core.vecmath import V3, div

_PI = 3.1415926


def spherical_uv(d: V3):
    """Unit direction planes -> equirect (u, v) in [0, 1] (v = 0 at top)."""
    u = div(torch.atan2(d.z, d.x), 2.0 * _PI) + 0.5
    v = 1.0 - (div(torch.asin(torch.clamp(d.y, -1.0, 1.0)), _PI) + 0.5)
    return u, v


def _mirror_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """Mirror addressing: ... 2 1 0 0 1 2 ... n-1 n-1 n-2 ..."""
    period = 2 * n
    i = torch.remainder(i, period)  # floored: -1 -> 2n-1 -> 0
    return torch.where(i >= n, period - 1 - i, i)


def sample_env(img: torch.Tensor, d: V3, clamp: float = 10.0) -> V3:
    """Sample env map [H, W, 3] at unit directions (V3 planes) -> V3."""
    u, v = spherical_uv(d)
    return sample_env_uv(img, u, v, clamp)


def sample_env_uv(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  clamp: float = 10.0) -> V3:
    """Bilinear, mirror-addressed, clamped lookup at equirect (u, v)."""
    h, w = int(img.shape[0]), int(img.shape[1])
    fx = u * float(w) - 0.5
    fy = v * float(h) - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x1i = _mirror_index(x0i + 1, w)
    y1i = _mirror_index(y0i + 1, h)
    x0i = _mirror_index(x0i, w)
    y0i = _mirror_index(y0i, h)
    flat = img.reshape(-1, 3)

    def texel(yi, xi) -> V3:
        row = flat[yi * w + xi]
        return V3(row[..., 0], row[..., 1], row[..., 2])

    c00, c01 = texel(y0i, x0i), texel(y0i, x1i)
    c10, c11 = texel(y1i, x0i), texel(y1i, x1i)
    color = (c00 * (1 - tx) * (1 - ty) + c01 * tx * (1 - ty)
             + c10 * (1 - tx) * ty + c11 * tx * ty)
    return V3(torch.clamp_max(color.x, clamp), torch.clamp_max(color.y, clamp),
              torch.clamp_max(color.z, clamp))
