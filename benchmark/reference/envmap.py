"""The sky lookup: equirect (u, v) of a unit direction with the
reference's constant 3.1415926, bilinear filtering with mirror addressing
(the CUDA texture, PathTrace.cu:1652-1665), clamped to ``hdr_clamp``
(PathTrace.cu:700)."""

from __future__ import annotations

import torch

from .vec import V3, div

_PI = 3.1415926


def _mirror(i: torch.Tensor, n: int) -> torch.Tensor:
    i = torch.remainder(i, 2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def sample(env: torch.Tensor, d: V3, clamp: float) -> V3:
    """``env`` [H, W, 3] at unit directions ``d`` -> radiance V3."""
    u = div(torch.atan2(d.z, d.x), 2.0 * _PI) + 0.5
    v = 1.0 - (div(torch.asin(torch.clamp(d.y, -1.0, 1.0)), _PI) + 0.5)
    h, w = int(env.shape[0]), int(env.shape[1])
    fx, fy = u * float(w) - 0.5, v * float(h) - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = fx - x0, fy - y0
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    x1i, y1i = _mirror(x0i + 1, w), _mirror(y0i + 1, h)
    x0i, y0i = _mirror(x0i, w), _mirror(y0i, h)
    flat = env.reshape(-1, 3)

    def texel(yi, xi) -> V3:
        row = flat[yi * w + xi]
        return V3(row[..., 0], row[..., 1], row[..., 2])

    c = (texel(y0i, x0i) * (1 - tx) * (1 - ty) + texel(y0i, x1i) * tx * (1 - ty)
         + texel(y1i, x0i) * (1 - tx) * ty + texel(y1i, x1i) * tx * ty)
    return V3(torch.clamp_max(c.x, clamp), torch.clamp_max(c.y, clamp),
              torch.clamp_max(c.z, clamp))
